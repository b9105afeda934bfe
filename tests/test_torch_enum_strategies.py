"""The port's sequential and sampled enumeration against the JAX package,
against parallel enumeration and against exact values, on the CPU
(``TraceEnum_ELBO._iter_trace_pairs``, ``infer/enum.py``,
``poutine/enum_messenger.py::_tmc_sample``, ``infer/util.py::Dice``).

Every site enumerated: loss and gradients rtol 1e-5 (atol 1e-6) against the
JAX package with the same strategies, against parallel enumeration and
against the closed-form KL (float64).  Sampled enumeration: the mean loss
over 200 generators within 4 standard errors of the exact value of the
estimator's mean (and of the JAX package's mean, for guide sites); for a
model site the mean of exp(-loss), an unbiased estimate of p(y), within 4
standard errors of p(y); the TMC strategies' ancestors exactly.

The JAX package weighs a model site's num_samples draws by their prior
probabilities and sums them, where the draws' weights are 1/num_samples
(``_compute_model_factors``; ROADMAP Queue 3): a strict xfail marks it.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
from pyro_tpu.infer import TraceEnum_ELBO as JTraceEnum_ELBO
from pyro_tpu.infer.svi import ParamsMessenger
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch import poutine
from pyro_tpu_torch.infer import TraceEnum_ELBO, config_enumerate

SEEDS = 200


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _port_loss_and_grads(model, guide, nesting, *args, generator=None):
    with poutine.trace(param_only=True) as capture:
        loss = TraceEnum_ELBO(max_plate_nesting=nesting).differentiable_loss(model, guide, *args, generator=generator)
    loss.backward()
    store = pyro.get_param_store()
    grads = {k: store.get_unconstrained(k).grad.numpy().copy() for k in capture.trace.param_nodes()}
    return float(loss.detach()), grads


def _jax_loss_and_grads(model, guide, nesting, params, *args, key=0):
    elbo = JTraceEnum_ELBO(max_plate_nesting=nesting)

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, guide, *args, rng_key=jax.random.key(key))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))({k: jnp.asarray(v) for k, v in params.items()})
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _close(port, expected, rtol=1e-5):
    loss, grads = port
    e_loss, e_grads = expected
    np.testing.assert_allclose(loss, e_loss, rtol=rtol, atol=1e-6)
    assert sorted(grads) == sorted(e_grads)
    for k in grads:
        np.testing.assert_allclose(grads[k], e_grads[k], rtol=rtol, atol=1e-6, err_msg=k)


# -- sequential enumeration ----------------------------------------------------------

P_BERN = (0.1, 0.2, 0.3)
Q0 = 0.75


def _berns(pyro_, dist_, array, strategies):
    def model():
        for i, p in enumerate(P_BERN):
            pyro_.sample(f"x{i}", dist_.Bernoulli(array(p)))

    def guide():
        q = pyro_.param("q")
        for i, strategy in enumerate(strategies):
            pyro_.sample(f"x{i}", dist_.Bernoulli(q), infer={"enumerate": strategy})

    return model, guide


def _berns_exact():
    """-ELBO = sum of KL(Bernoulli(q) || Bernoulli(p)) and its derivative in
    q's unconstrained value (q itself: an unconstrained param)."""
    kl = sum(Q0 * math.log(Q0 / p) + (1 - Q0) * math.log((1 - Q0) / (1 - p)) for p in P_BERN)
    dkl = sum(math.log(Q0 / p) - math.log((1 - Q0) / (1 - p)) for p in P_BERN)
    return kl, {"q": np.array(dkl)}


STRATEGIES = list(itertools.product(["sequential", "parallel"], repeat=3))


@pytest.mark.parametrize("strategies", STRATEGIES, ids=["-".join(s[:3] for s in c) for c in STRATEGIES])
def test_berns_every_strategy_is_exact(strategies):
    """Each mix of sequential and parallel guide sites gives the exact loss
    and gradient, and the same as all-parallel enumeration."""
    pyro.param("q", torch.tensor(Q0))
    port = _port_loss_and_grads(*_berns(pyro, dist, torch.tensor, strategies), 0)
    _close(port, _berns_exact())
    pyro.clear_param_store()
    pyro.param("q", torch.tensor(Q0))
    _close(port, _port_loss_and_grads(*_berns(pyro, dist, torch.tensor, ("parallel",) * 3), 0))


@pytest.mark.parametrize("strategies", [("sequential",) * 3, ("sequential", "parallel", "sequential")],
                         ids=["seq-seq-seq", "seq-par-seq"])
def test_berns_sequential_matches_jax(strategies):
    pyro.param("q", torch.tensor(Q0))
    port = _port_loss_and_grads(*_berns(pyro, dist, torch.tensor, strategies), 0)
    jpyro.clear_param_store()
    jpyro.param("q", jnp.asarray(Q0))
    model, guide = _berns(jpyro, jdist, jnp.asarray, strategies)
    _close(port, _jax_loss_and_grads(model, guide, 0, {"q": np.float32(Q0)}))
    jpyro.clear_param_store()


P_CAT = ([0.6, 0.4], [0.3, 0.3, 0.4], [0.1, 0.2, 0.3, 0.4])
Q_CAT = ([0.4, 0.6], [0.4, 0.3, 0.3], [0.4, 0.3, 0.2, 0.1])


def _categoricals(pyro_, dist_, array, strategies):
    def model():
        for i, p in enumerate(P_CAT):
            pyro_.sample(f"x{i}", dist_.Categorical(array(p)))

    def guide():
        for i, strategy in enumerate(strategies):
            pyro_.sample(f"x{i}", dist_.Categorical(pyro_.param(f"q{i}")), infer={"enumerate": strategy})

    return model, guide


@pytest.mark.parametrize("nesting", [0, 1])
@pytest.mark.parametrize("strategies", [("sequential",) * 3, ("parallel", "sequential", "parallel")],
                         ids=["seq-seq-seq", "par-seq-par"])
def test_categoricals_sequential(strategies, nesting):
    """Against all-parallel enumeration, the closed-form KL and the JAX package."""
    for i, q in enumerate(Q_CAT):
        pyro.param(f"q{i}", torch.tensor(q))
    port = _port_loss_and_grads(*_categoricals(pyro, dist, torch.tensor, strategies), nesting)
    pyro.clear_param_store()
    for i, q in enumerate(Q_CAT):
        pyro.param(f"q{i}", torch.tensor(q))
    _close(port, _port_loss_and_grads(*_categoricals(pyro, dist, torch.tensor, ("parallel",) * 3), nesting))
    kl = sum(float(np.sum(np.array(q) * np.log(np.array(q) / np.array(p)))) for p, q in zip(P_CAT, Q_CAT))
    np.testing.assert_allclose(port[0], kl, rtol=1e-5)
    jpyro.clear_param_store()
    for i, q in enumerate(Q_CAT):
        jpyro.param(f"q{i}", jnp.asarray(q))
    model, guide = _categoricals(jpyro, jdist, jnp.asarray, strategies)
    _close(port, _jax_loss_and_grads(model, guide, nesting, {f"q{i}": np.float32(q) for i, q in enumerate(Q_CAT)}))
    jpyro.clear_param_store()


MIX_DATA = np.array([0.3, -1.2, 2.1, 1.4], np.float32)


def _plated_mixture(pyro_, dist_, array, strategy, where):
    """A global cost outside the plate (its branches' log denominators),
    and a Bernoulli guide site in the plate, enumerated by ``strategy``."""

    def model():
        mu = pyro_.param("mu")
        pyro_.sample("prior", dist_.Normal(mu, array(1.0)), obs=array(0.5))
        with pyro_.plate("data", len(MIX_DATA), dim=-1):
            z = pyro_.sample("z", dist_.Bernoulli(array(0.4)))
            pyro_.sample("obs", dist_.Normal(where(z > 0, mu, -mu), array(1.0)), obs=array(MIX_DATA))

    def guide():
        q = pyro_.param("qz")
        with pyro_.plate("data", len(MIX_DATA), dim=-1):
            pyro_.sample("z", dist_.Bernoulli(q), infer={"enumerate": strategy})

    return model, guide


PARAMS = {"mu": np.float32(0.7), "qz": np.array([0.2, 0.5, 0.9, 0.6], np.float32)}


def test_plated_mixture_sequential_site():
    """A sequential guide site in a plate: loss and gradients against the
    parallel site and the JAX package (the global cost is counted once)."""
    results = {}
    for strategy in ("sequential", "parallel"):
        pyro.clear_param_store()
        for k, v in PARAMS.items():
            pyro.param(k, torch.tensor(v))
        results[strategy] = _port_loss_and_grads(*_plated_mixture(pyro, dist, torch.tensor, strategy, torch.where), 1)
    _close(results["sequential"], results["parallel"])
    jpyro.clear_param_store()
    for k, v in PARAMS.items():
        jpyro.param(k, jnp.asarray(v))
    model, guide = _plated_mixture(jpyro, jdist, jnp.asarray, "sequential", jnp.where)
    _close(results["sequential"], _jax_loss_and_grads(model, guide, 1, PARAMS))
    jpyro.clear_param_store()


def test_each_sequential_branch_runs_the_guide_once():
    """One trace pair a combination of the sequential sites' values."""
    pyro.param("q", torch.tensor(Q0))
    model, guide = _berns(pyro, dist, torch.tensor, ("sequential", "parallel", "sequential"))
    pairs = list(TraceEnum_ELBO(max_plate_nesting=0)._iter_trace_pairs(model, guide, (), {}, None))
    assert len(pairs) == 4
    values = sorted((float(g.nodes["x0"]["value"]), float(g.nodes["x2"]["value"])) for _, g in pairs)
    assert values == [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0)]
    assert all(g.nodes["x0"]["infer"]["_enum_total"] == 2 for _, g in pairs)


# -- sampled enumeration --------------------------------------------------------------

K_GUIDE = 20


def test_guide_sampled_enumeration_is_unbiased():
    """Guide sites with num_samples: the mean loss over 200 generators
    against the exact -ELBO and against the JAX package's mean over 200
    keys, within 4 standard errors."""
    strategies = ("parallel",) * 3

    def guide():
        q = pyro.param("q")
        for i in range(3):
            pyro.sample(f"x{i}", dist.Bernoulli(q), infer={"enumerate": "parallel", "num_samples": K_GUIDE})

    model, _ = _berns(pyro, dist, torch.tensor, strategies)
    pyro.param("q", torch.tensor(Q0))
    elbo = TraceEnum_ELBO(max_plate_nesting=0)
    port = np.array([float(elbo.loss(model, guide, generator=torch.Generator().manual_seed(s)))
                     for s in range(SEEDS)])

    jmodel, _ = _berns(jpyro, jdist, jnp.asarray, strategies)

    def jguide():
        q = jpyro.param("q")
        for i in range(3):
            jpyro.sample(f"x{i}", jdist.Bernoulli(q), infer={"enumerate": "parallel", "num_samples": K_GUIDE})

    jpyro.clear_param_store()
    jpyro.param("q", jnp.asarray(Q0))
    jelbo = JTraceEnum_ELBO(max_plate_nesting=0)
    jloss = jax.jit(lambda key: jelbo.loss(jmodel, jguide, rng_key=key))
    ref = np.array([float(jloss(jax.random.key(s))) for s in range(SEEDS)])
    jpyro.clear_param_store()
    exact, _ = _berns_exact()
    se = port.std() / math.sqrt(SEEDS)
    assert abs(port.mean() - exact) < 4 * se, (port.mean(), exact, se)
    assert abs(port.mean() - ref.mean()) < 4 * math.hypot(se, ref.std() / math.sqrt(SEEDS))


K_MODEL, P_MODEL, LOCS = 8, 0.3, (-1.0, 1.5)


def _model_sampled(pyro_, dist_, array, where):
    def model():
        with pyro_.plate("data", len(MIX_DATA)):
            z = pyro_.sample("z", dist_.Bernoulli(array(P_MODEL)), infer={"enumerate": "parallel", "num_samples": K_MODEL})
            pyro_.sample("y", dist_.Normal(where(z > 0, LOCS[1], LOCS[0]), array(1.0)), obs=array(MIX_DATA))

    return model


def _normal_pdf(y, loc):
    return math.exp(-0.5 * (y - loc) ** 2) / math.sqrt(2 * math.pi)


def _model_sampled_expectation():
    """The estimator's mean: per datum, -log of the mean likelihood of
    K_MODEL prior draws, of which m ~ Binomial(K_MODEL, P_MODEL) are 1."""
    total = 0.0
    for y in MIX_DATA.astype(np.float64):
        l0, l1 = _normal_pdf(y, LOCS[0]), _normal_pdf(y, LOCS[1])
        total -= sum(scipy.stats.binom.pmf(m, K_MODEL, P_MODEL) * math.log((m * l1 + (K_MODEL - m) * l0) / K_MODEL)
                     for m in range(K_MODEL + 1))
    return total


def _port_model_losses():
    model = _model_sampled(pyro, dist, torch.tensor, torch.where)
    elbo = TraceEnum_ELBO(max_plate_nesting=1)
    return np.array([float(elbo.loss(model, lambda: None, generator=torch.Generator().manual_seed(s)))
                     for s in range(SEEDS)])


def test_model_sampled_enumeration_mean():
    """A model site with num_samples=8: the mean loss over 200 generators
    within 4 standard errors of the estimator's exact mean, and the mean of
    exp(-loss) within 4 standard errors of p(y)."""
    losses = _port_model_losses()
    se = losses.std() / math.sqrt(SEEDS)
    expected = _model_sampled_expectation()
    assert abs(losses.mean() - expected) < 4 * se, (losses.mean(), expected, se)
    likelihood = np.exp(-losses)
    p_y = math.prod((1 - P_MODEL) * _normal_pdf(y, LOCS[0]) + P_MODEL * _normal_pdf(y, LOCS[1])
                    for y in MIX_DATA.astype(np.float64))
    assert abs(likelihood.mean() - p_y) < 4 * likelihood.std() / math.sqrt(SEEDS), (likelihood.mean(), p_y)


@pytest.mark.xfail(strict=True, reason=(
    "pyro_tpu/infer/traceenum_elbo.py:_compute_model_factors takes a sampled model site's log_prob as its "
    "factor, summing its draws weighted by their prior probabilities (ROADMAP.md Queue 3)"))
def test_jax_model_sampled_enumeration_mean():
    model = _model_sampled(jpyro, jdist, jnp.asarray, jnp.where)
    jloss = jax.jit(lambda key: JTraceEnum_ELBO(max_plate_nesting=1).loss(model, lambda: None, rng_key=key))
    losses = np.array([float(jloss(jax.random.key(s))) for s in range(SEEDS)])
    assert abs(losses.mean() - _model_sampled_expectation()) < 4 * losses.std() / math.sqrt(SEEDS)


def _chain_model(p1=0.5):
    """z2 copies z1: the draws show each z2 draw's ancestor."""
    z1 = pyro.sample("z1", dist.Bernoulli(torch.tensor(p1)))
    pyro.sample("z2", dist.Bernoulli(torch.where(z1 > 0, 1.0, 0.0)))


def _tmc_draws(tmc, seed):
    model = config_enumerate(_chain_model, num_samples=4, tmc=tmc)
    trace = poutine.trace(poutine.EnumMessenger(first_available_dim=-1)(poutine.seed(model, rng_seed=seed))).get_trace()
    infer = trace.nodes["z2"]["infer"]
    assert {k: infer[k] for k in ("enumerate", "num_samples", "expand", "tmc")} == {
        "enumerate": "parallel", "num_samples": 4, "expand": False, "tmc": tmc}
    return trace.nodes["z1"]["value"], trace.nodes["z2"]["value"]


def test_tmc_diagonal_pairs_draw_k_with_ancestor_k():
    """A draw of z2 has one ancestor: (4, 1) beside z1's (4,), and the
    diagonal strategy takes ancestor k for draw k."""
    for seed in range(5):
        z1, z2 = _tmc_draws("diagonal", seed)
        assert z1.shape == (4,) and z2.shape == (4, 1)
        assert torch.equal(z2[:, 0], z1)


def test_tmc_mixture_draws_ancestors_from_the_generator():
    """The mixture strategy picks each draw's ancestor uniformly: every z2
    draw copies some z1 draw, and over seeds some copy another's."""
    crossed = False
    for seed in range(20):
        z1, z2 = _tmc_draws("mixture", seed)
        assert z2.shape == (4, 1) and set(z2[:, 0].tolist()) <= set(z1.tolist())
        crossed |= not torch.equal(z2[:, 0], z1)
    assert crossed
    assert all(torch.equal(a, b) for a, b in zip(_tmc_draws("mixture", 3), _tmc_draws("mixture", 3)))
    with pytest.raises(ValueError, match="not a valid TMC strategy"):
        _tmc_draws("bogus", 0)


def test_config_enumerate_marks_discrete_sites():
    def model():
        pyro.sample("a", dist.Bernoulli(torch.tensor(0.5)))
        pyro.sample("b", dist.Normal(torch.tensor(0.0), torch.tensor(1.0)))
        pyro.sample("c", dist.Categorical(torch.tensor([0.5, 0.5])), infer={"enumerate": "sequential"})
        pyro.sample("d", dist.Bernoulli(torch.tensor(0.5)), obs=torch.tensor(1.0))

    trace = poutine.trace(poutine.seed(config_enumerate(model, expand=True), rng_seed=0)).get_trace()
    assert trace.nodes["a"]["infer"] == {"enumerate": "parallel", "expand": True}
    assert trace.nodes["b"]["infer"] == {}
    assert trace.nodes["c"]["infer"] == {"enumerate": "sequential", "expand": True}
    assert trace.nodes["d"]["infer"] == {}
    with pytest.raises(ValueError, match="invalid default"):
        config_enumerate(model, default="bogus")
