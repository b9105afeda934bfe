"""The enumerated MCMC potential of the port against the JAX package's, and
NUTS over it, on the CPU.

A model's discrete latents with enumerate support are summed out of the
potential (``pyro_tpu_torch/infer/mcmc/util.py``, the counterpart of
``pyro_tpu/infer/mcmc/util.py:125-156``), and the gradient of all chains
comes from ``vmap(grad_and_value(potential))`` through the K1 Function.

Tolerances: potentials and gradients in float32, rtol 1e-5 with atol 1e-5
* max|expected| (model_1's log Z is a sum over 3 x 6 steps); the exact
log marginals of ``tests/test_mcmc_enum_potential.py`` to its own atol
1e-3 (and rtol 1e-5 against brute force); posterior means to the JAX
tests' atols (``tests/test_mcmc_conjugate.py``).
"""

import types

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.hmm as jhmm
import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu.infer.mcmc.util import get_potential_fn as jget_potential_fn
from pyro_tpu_torch.examples import hmm as thmm
from pyro_tpu_torch.infer import MCMC, NUTS
from pyro_tpu_torch.infer.mcmc.util import (_ravel_fns, batched_potential_and_grad, get_potential_fn,
                                            guess_max_plate_nesting, initialize_model)
from pyro_tpu_torch.ops import log_matmul as lm


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield


def _close(actual, expected, rtol, atol_scale=0.0):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol_scale * np.abs(expected).max())


# -- the three models of tests/test_mcmc_enum_potential.py, in both packages --------------


def _continuous_observed(pyro, dist, asarray):
    def model(data):
        p = pyro.sample("p", dist.Uniform(0.0, 1.0))
        y = pyro.sample("y", dist.Bernoulli(p))
        q = 0.5 + 0.25 * y
        with pyro.plate("data", len(data)):
            z = pyro.sample("z", dist.Bernoulli(q))
            pyro.sample("obs", dist.Normal(2 * z - 1, 1.0), obs=data)

    return model


def _all_discrete_anchor(pyro, dist, asarray):
    def model():
        pyro.sample("s", dist.Normal(0.0, 1.0))
        d = dist.Bernoulli(0.3)
        with pyro.plate("outer", 2, dim=-1):
            pyro.sample("x", d)
            with pyro.plate("inner1", 1, dim=-2):
                pyro.sample("y", d)
            with pyro.plate("inner2", 1, dim=-3):
                pyro.sample("z", d)

    return model


def _two_latent_chain(pyro, dist, asarray):
    def model(data):
        p = pyro.sample("p", dist.Beta(2.0, 2.0))
        y = pyro.sample("y", dist.Bernoulli(p))
        with pyro.plate("data", len(data)):
            z = pyro.sample("z", dist.Bernoulli(0.2 + 0.6 * y))
            pyro.sample("obs", dist.Normal(z, 0.5), obs=data)

    return model


# name -> (model factory, data, constrained values, nesting, the JAX test's log marginal or None)
ENUM_MODELS = {
    "continuous-observed-1": (_continuous_observed, [1.0], {"p": 0.4}, 1, -1.3434),
    "continuous-observed-0": (_continuous_observed, [0.0], {"p": 0.4}, 1, -1.4189),
    "continuous-observed-100": (_continuous_observed, [1.0, 0.0, 0.0], {"p": 0.4}, 1, -4.1813),
    "all-discrete-anchor": (_all_discrete_anchor, None, {"s": 0.7}, 3, None),
    "two-latent-chain": (_two_latent_chain, [0.3, -0.2], {"p": 0.35}, 1, None),
}


def _both(name):
    factory, data, values, nesting, expected = ENUM_MODELS[name]
    j_model = factory(jpyro, jdist, jnp.asarray)
    t_model = factory(pyro, tdist, torch.tensor)
    j_args = () if data is None else (jnp.asarray(data, jnp.float32),)
    t_args = () if data is None else (torch.tensor(data),)
    return j_model, t_model, j_args, t_args, values, nesting, expected


@pytest.mark.parametrize("name", sorted(ENUM_MODELS))
def test_enumerated_potential_matches_jax(name):
    j_model, t_model, j_args, t_args, values, nesting, expected = _both(name)
    j_pot, _, j_tr, _, _ = jget_potential_fn(j_model, j_args, max_plate_nesting=nesting)
    t_pot, _, t_tr, _, _ = get_potential_fn(t_model, t_args, generator=torch.Generator().manual_seed(0),
                                            max_plate_nesting=nesting)
    assert sorted(t_tr) == sorted(j_tr) == sorted(values)
    # three unconstrained points around the named values, as a batch
    shifts = jnp.asarray([-0.7, 0.0, 1.3], jnp.float32)
    j_z = {k: j_tr[k].inv(jnp.asarray(v, jnp.float32)) + shifts for k, v in values.items()}
    t_z = {k: torch.tensor(np.asarray(v)) for k, v in j_z.items()}
    j_val, j_grad = jax.jit(jax.vmap(jax.value_and_grad(j_pot)))(j_z)
    t_grad, t_val = torch.func.vmap(torch.func.grad_and_value(t_pot))(t_z)
    _close(t_val.numpy(), j_val, 1e-5)
    for k in values:
        _close(t_grad[k].numpy(), j_grad[k], 1e-5, 1e-5)
    if expected is not None:
        # the JAX test's exact log marginal: -potential less the Jacobian
        z = {k: t_tr[k].inv(torch.tensor(v)) for k, v in values.items()}
        ladj = sum(t_tr[k].log_abs_det_jacobian(z[k], torch.tensor(v)).sum() for k, v in values.items())
        np.testing.assert_allclose(float(-t_pot(z) - ladj), expected, atol=1e-3)


def test_enumerated_potential_matches_brute_force():
    """The two-latent chain summed by hand, as the JAX test does."""
    _, t_model, _, t_args, values, _, _ = _both("two-latent-chain")
    t_pot, _, t_tr, _, _ = get_potential_fn(t_model, t_args, max_plate_nesting=1)
    p0 = torch.tensor(0.35)
    z = t_tr["p"].inv(p0)
    actual = float(-t_pot({"p": z}) - t_tr["p"].log_abs_det_jacobian(z, p0))
    total = -np.inf
    for y in (0.0, 1.0):
        per_datum = 0.0
        for x in (0.3, -0.2):
            terms = [float(tdist.Bernoulli(torch.tensor(0.2 + 0.6 * y)).log_prob(torch.tensor(zv))
                           + tdist.Normal(zv, 0.5).log_prob(torch.tensor(x))) for zv in (0.0, 1.0)]
            per_datum += np.logaddexp(*terms)
        total = np.logaddexp(total, float(tdist.Bernoulli(p0).log_prob(torch.tensor(y))) + per_datum)
    expected = float(tdist.Beta(2.0, 2.0).log_prob(p0)) + total
    np.testing.assert_allclose(actual, expected, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(ENUM_MODELS))
def test_max_plate_nesting_guess_matches_jax(name):
    """Without ``max_plate_nesting`` both packages guess it from the
    prototype trace, and the potential is the one at the guess."""
    j_model, t_model, j_args, t_args, values, nesting, _ = _both(name)
    j_pot, _, j_tr, j_proto, _ = jget_potential_fn(j_model, j_args)
    t_pot, _, t_tr, t_proto, _ = get_potential_fn(t_model, t_args, generator=torch.Generator().manual_seed(0))
    guess = guess_max_plate_nesting(t_proto)
    assert guess == max(len(s["cond_indep_stack"]) for s in j_proto.nodes.values() if s["type"] == "sample")
    t_explicit, _, _, _, _ = get_potential_fn(t_model, t_args, max_plate_nesting=guess)
    z = {k: t_tr[k].inv(torch.tensor(v)) for k, v in values.items()}
    j_z = {k: jnp.asarray(v.numpy()) for k, v in z.items()}
    _close(float(t_pot(z)), float(jax.jit(j_pot)(j_z)), 1e-5)
    _close(float(t_pot(z)), float(t_explicit(z)), 0.0)


def test_all_discrete_and_unenumerable_sites_raise():
    def all_discrete():
        pyro.sample("b", tdist.Bernoulli(0.4))

    with pytest.raises(ValueError, match="discrete"):
        initialize_model(all_discrete, generator=torch.Generator().manual_seed(0))

    class NoSupport(tdist.Bernoulli):
        has_enumerate_support = False

    def unenumerable():
        pyro.sample("lam", tdist.Normal(0.0, 1.0))
        pyro.sample("n", NoSupport(0.3))

    with pytest.raises(NotImplementedError, match="enumerate"):
        initialize_model(unenumerable, generator=torch.Generator().manual_seed(0))


# -- model_1 of examples/hmm.py, small ----------------------------------------------------

HMM_ARGS = types.SimpleNamespace(hidden_dim=3)


@pytest.fixture(scope="module")
def small_model_1():
    """3 sequences, T=6, 5 tones, 3 states; both packages' potentials and
    8 unconstrained points from numpy."""
    pyro.set_default_device("cpu")
    seqs, lengths = thmm.synthetic_sequences(0, 3, 6, 5, hidden_dim=3)
    lengths = torch.tensor([6, 4, 5])  # two sequences padded past their lengths
    info = initialize_model(thmm.model_1, (seqs, lengths, HMM_ARGS), generator=torch.Generator().manual_seed(0))
    ravel, unravel = _ravel_fns(info.initial_params)
    j_pot, _, _, j_proto, j_unconstrain = jget_potential_fn(
        jhmm.model_1, (jnp.asarray(seqs.numpy()), jnp.asarray(lengths.numpy()), HMM_ARGS))
    j_init = j_unconstrain({name: j_proto.nodes[name]["value"] for name in ("probs_x", "probs_y")})
    _, j_unravel = jax.flatten_util.ravel_pytree(j_init)
    D = ravel(info.initial_params).shape[-1]
    z = np.random.default_rng(1).uniform(-1.5, 1.5, (8, D)).astype(np.float32)
    return info, unravel, j_pot, j_unravel, z, (seqs, lengths)


def test_model_1_vmapped_potential_and_gradient_match_jax(small_model_1, monkeypatch):
    info, unravel, j_pot, j_unravel, z, _ = small_model_1
    assert z.shape[1] == 3 * 2 + 3 * 5
    products = []
    raw = lm._logmatmulexp_raw
    monkeypatch.setattr(lm, "_logmatmulexp_raw", lambda x, y: products.append(x.shape) or raw(x, y))
    pe, grad = batched_potential_and_grad(lambda f: info.potential_fn(unravel(f)))(torch.tensor(z))
    assert products, "the contraction goes through K1's Function"
    assert all(s[0] == 8 for s in products), "the chains lead K1's batch"
    j_pe, j_grad = jax.jit(jax.vmap(jax.value_and_grad(lambda f: j_pot(j_unravel(f)))))(jnp.asarray(z))
    _close(pe.numpy(), j_pe, 1e-5)
    _close(grad.numpy(), j_grad, 1e-5, 1e-5)


def test_nuts_on_small_model_1(small_model_1):
    """A few NUTS iterations of 2 chains over the enumerated potential:
    finite draws of the constrained sites, on the simplex and in (0, 1)."""
    _, _, _, _, _, (seqs, lengths) = small_model_1
    kernel = NUTS(thmm.model_1, max_plate_nesting=2, max_tree_depth=4)
    mcmc = MCMC(kernel, num_samples=4, warmup_steps=4, num_chains=2)
    mcmc.run(seqs, lengths, HMM_ARGS, generator=torch.Generator().manual_seed(0))
    samples = mcmc.get_samples(group_by_chain=True)
    assert set(samples) == {"probs_x", "probs_y"}
    assert samples["probs_x"].shape == (2, 4, 3, 3) and samples["probs_y"].shape == (2, 4, 3, 5)
    for v in samples.values():
        assert torch.isfinite(v).all()
    torch.testing.assert_close(samples["probs_x"].sum(-1), torch.ones(2, 4, 3), rtol=0, atol=1e-5)
    assert ((samples["probs_y"] > 0) & (samples["probs_y"] < 1)).all()
    assert kernel.counts["leapfrogs"] > 8


# -- the enumerated models of tests/test_mcmc_conjugate.py -----------------------------


def _run(model, args, num_chains=2, num_samples=60, warmup=60, seed=0):
    """NUTS over the enumerated potential, trees cut at depth 5 (time on the
    CPU); the draws by chain."""
    mcmc = MCMC(NUTS(model, max_plate_nesting=1, max_tree_depth=5), num_samples=num_samples, warmup_steps=warmup,
                num_chains=num_chains)
    mcmc.run(*args, generator=torch.Generator().manual_seed(seed))
    return mcmc.get_samples(group_by_chain=True)


def test_bernoulli_latent_model():
    """The JAX test's data (its keys), truth and atol; 2 chains of 60 + 60."""
    N = 500
    y = (jax.random.uniform(jax.random.key(0), (N,)) < 0.3).astype(jnp.float32)
    z = (jax.random.uniform(jax.random.key(1), (N,)) < 0.65 * y + 0.1).astype(jnp.float32)
    data = torch.tensor(np.asarray(2.0 * z + jax.random.normal(jax.random.key(2), (N,))))

    def model(data):
        y_prob = pyro.sample("y_prob", tdist.Beta(1.0, 1.0))
        with pyro.plate("data", data.shape[0]):
            y = pyro.sample("y", tdist.Bernoulli(y_prob))
            z = pyro.sample("z", tdist.Bernoulli(0.65 * y + 0.1))
            pyro.sample("obs", tdist.Normal(2.0 * z, 1.0), obs=data)

    samples = _run(model, (data,))
    assert set(samples) == {"y_prob"}
    np.testing.assert_allclose(float(samples["y_prob"].mean()), 0.3, atol=0.06)


def test_gaussian_mixture_model():
    """The JAX test's data (its keys), truths and atols; 2 chains of 60 +
    60.  The chains settle in different labellings of the clusters, so
    each chain's means are sorted before they are averaged (the JAX test's
    one chain is sorted alone)."""
    K, N = 3, 500
    true_means, true_mix = np.array([1.0, 5.0, 10.0]), np.array([0.1, 0.3, 0.6])
    assign = jax.random.categorical(jax.random.key(0), jnp.log(jnp.asarray(true_mix)), shape=(N,))
    data = torch.tensor(np.asarray(jnp.asarray(true_means)[assign] + jax.random.normal(jax.random.key(1), (N,))),
                        dtype=torch.float32)

    def gmm(data):
        phi = pyro.sample("phi", tdist.Dirichlet(torch.ones(K)))
        with pyro.plate("num_clusters", K):
            cluster_means = pyro.sample("cluster_means", tdist.Normal(torch.arange(float(K)), 1.0))
        with pyro.plate("data", data.shape[0]):
            a = pyro.sample("assignments", tdist.Categorical(phi))
            pyro.sample("obs", tdist.Normal(cluster_means[a], 1.0), obs=data)

    samples = _run(gmm, (data,))
    assert set(samples) == {"phi", "cluster_means"}
    phi = np.sort(samples["phi"].mean(1).numpy(), -1).mean(0)
    means = np.sort(samples["cluster_means"].mean(1).numpy(), -1).mean(0)
    np.testing.assert_allclose(phi, np.sort(true_mix), atol=0.07)
    np.testing.assert_allclose(means, true_means, atol=0.35)


def test_vindex_takes_a_0dim_index_tensor_as_an_int():
    """model_1's first step indexes by a 0-dim tensor; ``Vindex`` selects
    with it on the device (no host read, which a CUDA graph's capture
    refuses), giving what the int index gives."""
    from pyro_tpu_torch.ops.indexing import Vindex

    x = torch.randn(2, 3, 4, 5)
    i0, i1 = torch.tensor(1), torch.tensor([[0], [2]])
    for args in ((Ellipsis, i0, slice(None)), (i0, slice(None)), (Ellipsis, i0, i1), (Ellipsis, i1, i0, slice(None)),
                 (i0, i0, i0, i0)):
        as_int = tuple(int(a) if isinstance(a, torch.Tensor) and a.ndim == 0 else a for a in args)
        torch.testing.assert_close(Vindex(x)[args], Vindex(x)[as_int], rtol=0, atol=0)


# -- model_1v (vectorized_markov) under the enumerated potential ---------------------

V_ARGV = ["--hidden-dim", "4", "--num-sequences", "3", "--max-length", "6", "--data-dim", "5"]
V_Z = np.random.default_rng(2).uniform(-1, 1, (3, 4 * 3 + 4 * 5)).astype(np.float32)


def _port_flat_potential(model, args, nesting):
    seqs, lengths = thmm.synthetic_sequences(0, 3, 6, 5)
    info = initialize_model(model, (seqs, lengths, args), generator=torch.Generator().manual_seed(0),
                            max_plate_nesting=nesting)
    _, unravel = _ravel_fns(info.initial_params)
    return batched_potential_and_grad(lambda f: info.potential_fn(unravel(f)))


def test_model_1v_potential_equals_model_1s():
    """model_1v (the chain under ``vectorized_markov``, eliminated by the
    scan, K2 on the card) and model_1 (unrolled under ``pyro.markov``) are
    one model: the same potential and gradient at the same points, float32
    rtol 1e-5."""
    from pyro_tpu_torch.ops import markov_product

    potential_v = _port_flat_potential(thmm.model_1v, thmm.parse_args(["--model", "1v"] + V_ARGV), 3)
    markov_product.reset_routes()
    pe_v, g_v = potential_v(torch.tensor(V_Z))
    assert markov_product.routes == {"scan": 1, "general": 0, "pairwise": 0}
    pe_1, g_1 = _port_flat_potential(thmm.model_1, thmm.parse_args(["--model", "1"] + V_ARGV), 2)(torch.tensor(V_Z))
    _close(pe_v.numpy(), pe_1.numpy(), 1e-5)
    _close(g_v.numpy(), g_1.numpy(), 1e-5, 1e-5)


@pytest.mark.xfail(strict=True, reason=(
    "fault of the reference: pyro_tpu/infer/mcmc/util.py:139 wraps the model in config_enumerate, whose "
    "infer_config replaces each site's infer dict (pyro_tpu/poutine/handlers.py:421), so vectorized_markov "
    "reads the auxiliary sites' stale dicts, finds no Markov variable and records an empty chain: the auxiliary "
    "dims are summed without their factors (model_1v's potential 137.88 where model_1's is 157.36)"
))
def test_jax_model_1v_potential_equals_model_1s():
    seqs, lengths = thmm.synthetic_sequences(0, 3, 6, 5)
    values = []
    for name, model, nesting in (("1v", jhmm.model_1v, 3), ("1", jhmm.model_1, 2)):
        args = thmm.parse_args(["--model", name] + V_ARGV)
        pot, _, _, proto, unconstrain = jget_potential_fn(
            model, (jnp.asarray(seqs.numpy()), jnp.asarray(lengths.numpy()), args), max_plate_nesting=nesting)
        _, unravel = jax.flatten_util.ravel_pytree(unconstrain({k: proto.nodes[k]["value"]
                                                                 for k in ("probs_x", "probs_y")}))
        values.append(np.asarray(jax.jit(jax.vmap(lambda f: pot(unravel(f))))(jnp.asarray(V_Z))))
    _close(values[0], values[1], 1e-5)
