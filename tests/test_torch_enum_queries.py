"""The port's discrete posterior queries against the JAX package and
against brute-force enumeration, on the CPU: ``ubersum`` and
``naive_ubersum`` (``ops/contract.py``), the max-product and taping
``logsumexp_contract`` (``ops/rings.py``), ``TraceEnum_ELBO.compute_marginals``
(``ops/einsum_adjoint.py``) and ``infer_discrete`` (``ops/einsum_sample.py``).

Inputs are numpy arrays from seeds; model_1 of ``examples/hmm.py`` runs at
hidden 4, B=3 sequences, T=6, D=5 tones with the JAX AutoDelta's initial
values.  Tolerances: contractions rtol 1e-5 with atol 1e-5 (float32 sums in
another pairwise order), their gradients rtol 1e-4 with atol 1e-5;
marginals atol 1e-5 in probability; MAP indices exactly; 2000 posterior
draws by a chi-square statistic below its 0.999 quantile.

The JAX package's ``compute_marginals`` reads a site's marginal from the
gradient of its own compact factor, which sums the slices of every plate
the factor is constant over: one marginal for all sequences, the mean of
the sequences' own.  The port gives one per slice; the JAX package is held
to it one sequence at a time, and a strict xfail marks the batched output
(ROADMAP Queue 3).
"""

import contextlib
import functools
import itertools
import math
import types
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import examples.hmm as jhmm
import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu.infer import TraceEnum_ELBO as JTraceEnum_ELBO
from pyro_tpu.infer import infer_discrete as jinfer_discrete
from pyro_tpu.infer.autoguide import AutoDelta as JAutoDelta
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.ops import contract as jcontract
from pyro_tpu.ops import packed as jpacked
from pyro_tpu.ops import rings as jrings
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch import poutine
from pyro_tpu_torch.examples import hmm as thmm
from pyro_tpu_torch.infer import TraceEnum_ELBO, config_enumerate, infer_discrete
from pyro_tpu_torch.ops import contract, einsum_sample, log_matmul, packed, rings

SIZES = {"a": 2, "b": 3, "c": 4, "d": 5, "e": 6, "i": 2, "j": 3}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _operands(equation, seed=0):
    inputs = equation.split("->")[0].split(",")
    rng = np.random.default_rng(seed)
    return [rng.standard_normal([SIZES[d] for d in dims]).astype(np.float32) for dims in inputs]


# -- ubersum ------------------------------------------------------------------------

UBERSUM_CASES = [
    ("ab,bc,cd->a,b,c,d", "ad"),
    ("c,cda,ecb->", "ab"),
    ("c,cda,ecb->b", "ab"),
    ("ae,d,bd,bcde->be", "abc"),
    ("ab,dbc->dc", "d"),
    ("a,abi,bcij->cij", "ij"),
    ("ac,bd,abc,abd->", "ab"),
    ("cd,ac,bd,abc,abd->", "ab"),
    ("c,ac,bc,abc->", "ab"),
    ("a,abi,bcij,adj,deij->", "ij"),
]


@functools.cache
def _jax_ubersum(equation, plates):
    """The JAX ``ubersum``'s outputs and the gradient of their sum, at
    ``_operands(equation)`` (once for both of the port's functions)."""
    ops = [jnp.asarray(x) for x in _operands(equation)]

    def total(xs):
        outs = jcontract.ubersum(equation, *xs, plates=plates)
        return sum(jnp.sum(out) for out in outs), outs

    grads, outs = jax.jit(jax.grad(total, has_aux=True))(ops)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["ubersum", "naive_ubersum"])
@pytest.mark.parametrize("equation,plates", UBERSUM_CASES)
def test_ubersum_matches_jax(equation, plates, impl):
    """Values against the JAX function of the same name, and the gradient
    of the outputs' sum against the JAX ``ubersum``'s."""
    ops = _operands(equation)
    leaves = [torch.tensor(x, requires_grad=True) for x in ops]
    actual = getattr(contract, impl)(equation, *leaves, plates=plates)
    if impl == "ubersum":
        expected, expected_grads = _jax_ubersum(equation, plates)
    else:
        expected = jcontract.naive_ubersum(equation, *(jnp.asarray(x) for x in ops), plates=plates)
        expected_grads = _jax_ubersum(equation, plates)[1]
    assert len(actual) == len(expected)
    for a, e in zip(actual, expected):
        assert tuple(a.shape) == tuple(np.shape(e))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(e), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(sum(out.sum() for out in actual), leaves)
    for g, e in zip(grads, expected_grads):
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4, atol=1e-5)


def test_ubersum_refuses_colliding_plates_and_naive_evaluates_them():
    equation, plates = "ac,bd,abcd->", "ab"
    ops = _operands(equation)
    for ubersum in (contract.ubersum, jcontract.ubersum):
        with pytest.raises(NotImplementedError, match="tree-structured plate nesting"):
            ubersum(equation, *(torch.tensor(x) if ubersum is contract.ubersum else jnp.asarray(x) for x in ops),
                    plates=plates)
    (actual,) = contract.naive_ubersum(equation, *(torch.tensor(x) for x in ops), plates=plates)
    (expected,) = jcontract.naive_ubersum(equation, *(jnp.asarray(x) for x in ops), plates=plates)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)


ERROR_CASES = [
    ("ab,bc->", [(2, 3), (4, 5)], "", "mismatch"),
    ("ab,bc->", [(2, 3), (4, 5)], "b", "mismatch"),
] + [(eq, None, plates, "nonsensical to preserve a plated dim") for eq, plates in [
    ("ai->a", "i"), (",ai->a", "i"), ("bi,abi->b", "i"), (",bi,abi->b", "i"), ("aij->ai", "ij"), ("aij->aj", "ij"),
]]


@pytest.mark.parametrize("impl", ["ubersum", "naive_ubersum"])
@pytest.mark.parametrize("equation,shapes,plates,match", ERROR_CASES)
def test_ubersum_errors_match_jax(equation, shapes, plates, match, impl):
    """Size and plate mismatches raise ValueError in both packages."""
    inputs = equation.split("->")[0].split(",")
    shapes = shapes or [(2,) * len(dims) for dims in inputs]
    ops = [np.ones(s, np.float32) for s in shapes]
    for fn, array in ((getattr(contract, impl), torch.tensor), (getattr(jcontract, impl), jnp.asarray)):
        with pytest.raises(ValueError, match=match):
            fn(equation, *(array(x) for x in ops), plates=plates)


# -- the tropical and taping rings --------------------------------------------------

CONTRACT_CASES = [
    (["ab", "bc", "cd", "d"], "bcd"),
    (["ab", "bc", "ca"], "abc"),
    (["abe", "bc", "ce", "e"], "bc"),
    (["ab", "b", "bc", "cd", "de"], "bcd"),
]


def _factors(dims_list, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal([SIZES[d] for d in dims]).astype(np.float32) for dims in dims_list]


def _brute(dims_list, values, sum_dims, reduce):
    """The joint of all factors over every dim, reduced over ``sum_dims``."""
    dims = "".join(sorted(set("".join(dims_list))))
    total = 0.0
    for d, v in zip(dims_list, values):
        order = sorted(range(len(d)), key=lambda i: dims.index(d[i]))
        total = total + np.transpose(v, order).reshape([SIZES[x] if x in d else 1 for x in dims])
    axes = tuple(i for i, x in enumerate(dims) if x in sum_dims)
    return reduce(total, axes), "".join(x for x in dims if x not in sum_dims)


@pytest.mark.parametrize("use_max", [False, True], ids=["sum", "max"])
@pytest.mark.parametrize("dims_list,sum_dims", CONTRACT_CASES)
def test_logsumexp_contract_rings_match_jax(dims_list, sum_dims, use_max):
    """Both rings against the JAX ring and against the reduced joint (in
    float64), with a tape: every step's operands are packed tensors, and the
    steps eliminate each summed dim exactly once."""
    values = _factors(dims_list, seed=len(dims_list))
    tape = []
    actual = rings.logsumexp_contract([packed.PackedTensor(torch.tensor(v), d) for v, d in zip(values, dims_list)],
                                      set(sum_dims), tape=tape, use_max=use_max)
    expected = jrings.logsumexp_contract([jpacked.PackedTensor(jnp.asarray(v), d) for v, d in zip(values, dims_list)],
                                         set(sum_dims), use_max=use_max)
    assert actual.dims == expected.dims
    np.testing.assert_allclose(actual.value.numpy(), np.asarray(expected.value), rtol=1e-5, atol=1e-5)
    reduce = (lambda x, axes: x.max(axis=axes)) if use_max else scipy.special.logsumexp
    brute, out = _brute(dims_list, [v.astype(np.float64) for v in values], sum_dims, reduce)
    assert actual.dims == out
    np.testing.assert_allclose(actual.value.numpy(), brute, rtol=1e-5, atol=1e-5)
    eliminated = []
    for operands, keep in tape:
        union = set().union(*(t.dims for t in operands))
        assert set(keep) <= union and len(operands) in (1, 2)
        eliminated += sorted(union - set(keep))
    assert sorted(eliminated) == sorted(sum_dims)


def _direct_greedy_path(dims_list, sizes, out_dims):
    """The greedy order written directly: each pair's result keeps the dims
    of the output and of every operand outside the pair."""
    operands = [set(d) for d in dims_list]
    path = []
    while len(operands) > 1:
        best = None
        for i in range(len(operands)):
            for j in range(i + 1, len(operands)):
                rest = set(out_dims).union(*(o for k, o in enumerate(operands) if k not in (i, j)))
                result = (operands[i] | operands[j]) & rest
                cost = (math.prod(sizes[d] for d in result) - math.prod(sizes[d] for d in operands[i])
                        - math.prod(sizes[d] for d in operands[j]))
                key = (not (operands[i] & operands[j]), cost)
                if best is None or key < best[0]:
                    best = (key, i, j, result)
        _, i, j, result = best
        path.append((i, j))
        operands = [o for k, o in enumerate(operands) if k not in (i, j)] + [result]
    return path


def test_greedy_path_matches_its_direct_form():
    """The pairwise order, which counts the operands carrying each dim, is
    the direct form's on 3000 random factor sets."""
    rng = np.random.default_rng(11)
    letters = "abcdefghijkl"
    for _ in range(3000):
        dims_list = ["".join(rng.choice(list(letters), size=rng.integers(0, 5), replace=False))
                     for _ in range(rng.integers(2, 10))]
        sizes = {d: int(rng.integers(1, 6)) for d in letters}
        used = sorted(set("".join(dims_list)))
        out = "".join(sorted(rng.choice(used, size=min(len(used), rng.integers(0, 3)), replace=False))) if used else ""
        assert rings._greedy_path(dims_list, sizes, out) == _direct_greedy_path(dims_list, sizes, out)


def test_ring_tape_and_max_reach_the_ring():
    """``LogRing`` passes its tape and ring to every contraction."""
    tape = []
    ring = rings.LogRing(tape=tape, use_max=True)
    x = packed.PackedTensor(torch.tensor([[0.0, 2.0], [1.0, -1.0]]), "ab")
    y = packed.PackedTensor(torch.tensor([0.5, 0.0]), "b")
    out = ring.sumproduct([x, y], {"b"})
    assert out.dims == "a" and out.value.tolist() == [2.0, 1.5]
    assert [keep for _, keep in tape] == ["a"]


# -- compute_marginals --------------------------------------------------------------

H, B, T, D = 4, 3, 6, 5
LENGTHS = (6, 4, 6)


def _sequences():
    return (np.random.default_rng(3).random((B, T, D)) < 0.3).astype(np.float32), np.array(LENGTHS)


@functools.cache
def _jax_model_1():
    """JAX model_1 with its AutoDelta guide and initial params, and the
    guide's probs_x and probs_y (float64)."""
    model = functools.partial(jhmm.model_1, args=types.SimpleNamespace(hidden_dim=H))
    guide = JAutoDelta(jpoutine.block(model, expose=["probs_x", "probs_y"]))
    seq, lengths = (jnp.asarray(a) for a in _sequences())
    jpyro.clear_param_store()
    jpoutine.seed(guide, rng_seed=0)(seq, lengths)
    params0 = {k: np.asarray(v) for k, v in jpyro.get_param_store().get_all_unconstrained().items()}
    trace = jpoutine.trace(guide).get_trace(seq, lengths)
    probs = {k: np.asarray(trace.nodes[k]["value"], np.float64) for k in ("probs_x", "probs_y")}
    jpyro.clear_param_store()
    return model, guide, params0, probs


@functools.cache
def _jax_marginals_fn():
    """The JAX ``compute_marginals`` of model_1 at the initial params,
    compiled once (eager JAX runs each op on its own)."""
    model, guide, params0, _ = _jax_model_1()

    def probs(sequences, lengths):
        with ParamsMessenger({k: jnp.asarray(v) for k, v in params0.items()}):
            marginals = JTraceEnum_ELBO(max_plate_nesting=2).compute_marginals(
                model, guide, sequences, lengths, rng_key=jax.random.key(0))
        return {k: v.probs for k, v in marginals.items()}

    return jax.jit(probs)


def _jax_marginals(sequences, lengths):
    _, guide, _, _ = _jax_model_1()
    jpyro.clear_param_store()
    jpoutine.seed(guide, rng_seed=0)(jnp.asarray(sequences), jnp.asarray(lengths))  # registers the params
    marginals = _jax_marginals_fn()(jnp.asarray(sequences), jnp.asarray(lengths))
    jpyro.clear_param_store()
    return {k: np.asarray(v) for k, v in marginals.items()}


def _port_model_1():
    args = thmm.parse_args(["--model", "1", "--hidden-dim", str(H)])
    model, guide, svi = thmm.make_svi(args)
    seq, lengths = (torch.tensor(a) for a in _sequences())
    svi.evaluate_loss(seq, lengths)  # registers the params
    store = pyro.get_param_store()
    for name, value in thmm.params_from_jax(_jax_model_1()[2]).items():
        store.set_unconstrained(name, value)
    return model, guide, seq, lengths


def _brute_posterior(probs_x, probs_y, y, length, masked=False):
    """Every path of one sequence, its posterior probability and its log
    joint (float64): the emissions within the length, and every transition,
    or with ``masked`` those within the length."""
    paths = np.array(list(itertools.product(range(H), repeat=T)))
    prev = np.concatenate([np.zeros((len(paths), 1), int), paths[:, :-1]], axis=1)
    logp = np.log(probs_x[prev, paths])[:, :length if masked else T].sum(1)
    for t in range(length):
        p = probs_y[paths[:, t]]
        logp += (y[t] * np.log(p) + (1 - y[t]) * np.log1p(-p)).sum(-1)
    w = np.exp(logp - logp.max())
    return paths, w / w.sum(), logp


@functools.cache
def _brute_marginals():
    probs = _jax_model_1()[3]
    seq, lengths = _sequences()
    out = np.zeros((B, T, H))
    for b in range(B):
        paths, post, _ = _brute_posterior(probs["probs_x"], probs["probs_y"], seq[b], lengths[b])
        for t in range(T):
            out[b, t] = np.bincount(paths[:, t], weights=post, minlength=H)
    return out


@functools.cache
def _jax_one_at_a_time():
    seq, lengths = _sequences()
    return [_jax_marginals(seq[b:b + 1], lengths[b:b + 1]) for b in range(B)]


def _port_marginals():
    model, guide, seq, lengths = _port_model_1()
    return TraceEnum_ELBO(max_plate_nesting=2).compute_marginals(model, guide, seq, lengths)


def test_model_1_marginals_one_per_sequence():
    """One Categorical per sequence for every x_t, batch shape (B, 1) as the
    site's own, against brute force and the JAX package run one sequence
    at a time."""
    marginals = _port_marginals()
    assert list(marginals) == [f"x_{t}" for t in range(T)]
    brute, jax_each = _brute_marginals(), _jax_one_at_a_time()
    for t in range(T):
        m = marginals[f"x_{t}"]
        assert isinstance(m, dist.Categorical) and m.batch_shape == (B, 1)
        probs = m.probs.reshape(B, H).numpy()
        np.testing.assert_allclose(probs, brute[:, t], atol=1e-5)
        for b in range(B):
            np.testing.assert_allclose(probs[b], jax_each[b][f"x_{t}"].reshape(H), atol=1e-5)


@pytest.mark.xfail(strict=True, reason=(
    "pyro_tpu/infer/traceenum_elbo.py:412 reads each marginal from the gradient of the site's compact factor, "
    "summing the plate's slices into one marginal for all sequences (ROADMAP.md Queue 3)"))
def test_jax_batched_marginals_match_the_port():
    seq, lengths = _sequences()
    expected = _jax_marginals(seq, lengths)
    marginals = _port_marginals()
    for t in range(T):
        np.testing.assert_allclose(np.broadcast_to(expected[f"x_{t}"], (B, 1, H)),
                                   marginals[f"x_{t}"].probs.numpy(), atol=1e-5)


def test_marginals_run_one_contraction_through_logmatmulexp(monkeypatch):
    """compute_marginals is one forward and one backward pass whose
    matmul-shaped pairs go to logmatmulexp (K1 on the card)."""
    calls = []
    lme = log_matmul.logmatmulexp
    monkeypatch.setattr(log_matmul, "logmatmulexp", lambda x, y: calls.append(tuple(x.shape)) or lme(x, y))
    _port_marginals()
    assert calls and all(shape == (B, H) for shape in calls)


MIX_DATA = np.array([-2.1, -0.3, 2.0, 0.4, -1.9], np.float32)
MIX_LOCS, MIX_WEIGHTS, MIX_SCALE = np.array([-2.0, 0.0, 2.0]), np.array([0.5, 0.2, 0.3]), 0.8


def _mixture(pyro_, dist_, array, data, site_dist="Categorical"):
    def model():
        with pyro_.plate("data", len(data), dim=-1):
            if site_dist == "Categorical":
                z = pyro_.sample("z", dist_.Categorical(array(MIX_WEIGHTS)), infer={"enumerate": "parallel"})
                loc = array(MIX_LOCS)[z]
            else:
                z = pyro_.sample("z", dist_.Bernoulli(array(0.3)), infer={"enumerate": "parallel"})
                loc = array(MIX_LOCS[0]) + z * array(MIX_LOCS[2] - MIX_LOCS[0])
            pyro_.sample("obs", dist_.Normal(loc, array(MIX_SCALE)), obs=array(data))

    return model


def _mixture_brute(site_dist):
    if site_dist == "Categorical":
        locs, w = MIX_LOCS, MIX_WEIGHTS
    else:
        locs, w = MIX_LOCS[[0, 2]], np.array([0.7, 0.3])
    logp = np.log(w) - 0.5 * ((MIX_DATA[:, None] - locs) / MIX_SCALE) ** 2
    p = np.exp(logp - logp.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("site_dist", ["Categorical", "Bernoulli"])
def test_plated_mixture_marginals(site_dist):
    """One marginal per datum, against brute force and the JAX package run
    on one datum at a time; a Bernoulli site gives a Bernoulli."""
    m = TraceEnum_ELBO(max_plate_nesting=1).compute_marginals(
        _mixture(pyro, dist, _f32, MIX_DATA, site_dist), lambda: None)["z"]
    brute = _mixture_brute(site_dist)
    if site_dist == "Bernoulli":
        assert isinstance(m, dist.Bernoulli)
        probs = np.stack([1 - m.probs.numpy(), m.probs.numpy()], -1)
    else:
        probs = m.probs.numpy()
    np.testing.assert_allclose(probs, brute, atol=1e-5)
    for n in range(len(MIX_DATA)):
        j = JTraceEnum_ELBO(max_plate_nesting=1).compute_marginals(
            _mixture(jpyro, jdist, lambda x: jnp.asarray(x, jnp.float32), MIX_DATA[n:n + 1], site_dist),
            lambda: None, rng_key=jax.random.key(0))["z"]
        jp = np.asarray(j.probs).reshape(-1)
        np.testing.assert_allclose(probs[n, -1] if site_dist == "Bernoulli" else probs[n], jp, atol=1e-5)


def test_marginals_keep_a_plate_of_size_one():
    m = TraceEnum_ELBO(max_plate_nesting=1).compute_marginals(_mixture(pyro, dist, _f32, MIX_DATA[:1]), lambda: None)["z"]
    assert m.batch_shape == (1,)
    np.testing.assert_allclose(m.probs.numpy(), _mixture_brute("Categorical")[:1], atol=1e-5)


@pytest.mark.xfail(strict=True, reason=(
    "pyro_tpu/infer/traceenum_elbo.py:412 sums the plate's slices into one marginal (ROADMAP.md Queue 3)"))
def test_jax_batched_mixture_marginals_match_brute_force():
    j = JTraceEnum_ELBO(max_plate_nesting=1).compute_marginals(
        _mixture(jpyro, jdist, lambda x: jnp.asarray(x, jnp.float32), MIX_DATA), lambda: None,
        rng_key=jax.random.key(0))["z"]
    np.testing.assert_allclose(np.broadcast_to(np.asarray(j.probs), (len(MIX_DATA), 3)), _mixture_brute("Categorical"),
                               atol=1e-5)


# -- infer_discrete -----------------------------------------------------------------

TRANS = (np.array([0.6, 0.4]), np.array([[0.8, 0.2], [0.3, 0.7]]))
LOCS = np.array([-1.0, 1.0])


def _chain(pyro_, dist_, array, data, copies=None, length=None):
    """A two-state HMM with Normal emissions; ``copies`` runs that many
    independent copies of it side by side in a plate, and the steps from
    ``length`` on are masked off."""

    def model():
        with (pyro_.plate("copies", copies, dim=-1) if copies else contextlib.nullcontext()):
            x = None
            for t in pyro_.markov(range(len(data))):
                with pyro_.poutine.mask(mask=length is None or t < length):
                    probs = array(TRANS[0]) if x is None else array(TRANS[1])[x]
                    x = pyro_.sample(f"x_{t}", dist_.Categorical(probs), infer={"enumerate": "parallel"})
                    pyro_.sample(f"y_{t}", dist_.Normal(array(LOCS)[x], array(1.0)), obs=array(data[t]))

    return model


def _chain_joint(data):
    configs = np.array(list(itertools.product(range(2), repeat=len(data))))
    logp = np.log(TRANS[0][configs[:, 0]])
    for t in range(1, len(data)):
        logp += np.log(TRANS[1][configs[:, t - 1], configs[:, t]])
    logp += (-0.5 * (data - LOCS[configs]) ** 2).sum(1)
    p = np.exp(logp - logp.max())
    return configs, p / p.sum()


def _values(model, names):
    trace = poutine.trace(model).get_trace()
    return np.stack([trace.nodes[n]["value"].numpy() for n in names], -1)


CHAIN_DATA = np.array([-0.5, 1.2, 0.3, -0.8, 1.5])


def test_chain_map_is_the_joint_argmax():
    """Temperature 0: the joint MAP, against brute force and the JAX package."""
    configs, probs = _chain_joint(CHAIN_DATA)
    names = [f"x_{t}" for t in range(len(CHAIN_DATA))]
    f = infer_discrete(_chain(pyro, dist, _f32, CHAIN_DATA), first_available_dim=-1, temperature=0)
    got = _values(f, names)
    np.testing.assert_array_equal(got, configs[np.argmax(probs)])
    jf = jinfer_discrete(_chain(jpyro, jdist, lambda x: jnp.asarray(x, jnp.float32), CHAIN_DATA),
                         first_available_dim=-1, temperature=0, rng_key=jax.random.key(0))

    def jax_map():
        trace = jpoutine.trace(jf).get_trace()
        return jnp.stack([trace.nodes[n]["value"] for n in names])

    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_map)()))


def _map_probs():
    """model_1's probs_x and probs_y drawn from a seed (float64).  The
    guide's initial values have equal self-transitions, so the most likely
    run of steps past a length is as likely from every state; under these
    the second sequence's MAP within its length would move if the factors
    of the steps past it were kept."""
    rng = np.random.default_rng(12)
    return {"probs_x": rng.dirichlet(np.full(H, 0.5), size=H), "probs_y": rng.uniform(0.1, 0.9, (H, D))}


@pytest.mark.parametrize("lengths", [(T,) * B, LENGTHS], ids=["full", "masked"])
def test_model_1_map_per_sequence(lengths):
    """Temperature 0 on model_1 (probs fixed at ``_map_probs``): each
    sequence's MAP path against brute force over its masked joint (the
    transitions and emissions within its length), so that the steps within
    the length are the sequence's own Viterbi path whatever the padding, and
    against the JAX package.  A step past a length has a flat factor, and
    its state is the first of the tied ones in both packages."""
    model, probs = _jax_model_1()[0], _map_probs()
    seq, lengths = _sequences()[0], np.array(lengths)
    names = [f"x_{t}" for t in range(T)]
    tmodel = poutine.condition(functools.partial(thmm.model_1, args=types.SimpleNamespace(hidden_dim=H)),
                               data={k: _f32(v) for k, v in probs.items()})
    got = _values(lambda: infer_discrete(tmodel, first_available_dim=-3, temperature=0)(
        torch.tensor(seq), torch.tensor(lengths)), names).reshape(B, T)
    for b in range(B):
        paths, post, _ = _brute_posterior(probs["probs_x"], probs["probs_y"], seq[b], lengths[b], masked=True)
        np.testing.assert_array_equal(got[b], paths[np.argmax(post)])
    jmodel = jpoutine.condition(model, data={k: jnp.asarray(v, jnp.float32) for k, v in probs.items()})
    jf = jinfer_discrete(jmodel, first_available_dim=-3, temperature=0, rng_key=jax.random.key(0))

    def jax_map(seq, lengths):
        trace = jpoutine.trace(jf).get_trace(seq, lengths)
        return jnp.stack([trace.nodes[n]["value"].reshape(B) for n in names], -1)

    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_map)(jnp.asarray(seq), jnp.asarray(lengths))))


def test_model_1_map_has_the_largest_joint_density():
    """The MAP path's joint log density is the brute-force maximum (the
    transitions and emissions of the steps in each length)."""
    probs = _map_probs()
    seq, lengths = _sequences()
    tmodel = poutine.condition(functools.partial(thmm.model_1, args=types.SimpleNamespace(hidden_dim=H)),
                               data={k: _f32(v) for k, v in probs.items()})
    trace = poutine.trace(infer_discrete(tmodel, first_available_dim=-3, temperature=0)).get_trace(
        torch.tensor(seq), torch.tensor(lengths))
    trace.compute_log_prob()
    per_seq = sum(site["log_prob"].reshape(B, -1).sum(-1)
                  for name, site in trace.nodes.items() if name.startswith(("x_", "y_")))
    for b in range(B):
        _, _, logp = _brute_posterior(probs["probs_x"], probs["probs_y"], seq[b], lengths[b], masked=True)
        np.testing.assert_allclose(float(per_seq[b]), logp.max(), rtol=1e-5)


DRAWS = 2000


def test_posterior_draws_match_brute_force():
    """Temperature 1: 2000 independent joint draws (copies of the chain in a
    plate, from one generator) against the brute-force posterior over its
    16 paths: the chi-square statistic (cells expected under 5 pooled) below
    its 0.999 quantile."""
    data = CHAIN_DATA[:4]
    _, probs = _chain_joint(data)
    names = [f"x_{t}" for t in range(len(data))]
    f = infer_discrete(_chain(pyro, dist, _f32, data, copies=DRAWS), first_available_dim=-2, temperature=1,
                       generator=torch.Generator().manual_seed(0))
    draws = _values(f, names)
    assert draws.shape == (DRAWS, len(data))
    _chi2_below_its_quantile(draws, probs)


def _chi2_below_its_quantile(draws, probs):
    """The chi-square statistic of binary-coded joint draws against
    ``probs`` (cells expected under 5 pooled) below its 0.999 quantile."""
    index = (draws * 2 ** np.arange(draws.shape[-1])[::-1]).sum(-1)
    counts = np.bincount(index, minlength=len(probs))
    expected = len(draws) * probs
    big = expected >= 5
    observed = np.append(counts[big], counts[~big].sum())
    expected = np.append(expected[big], expected[~big].sum())
    if expected[-1] < 5:
        observed, expected = observed[:-1], expected[:-1]
    stat = ((observed - expected) ** 2 / expected).sum()
    assert stat < scipy.stats.chi2.ppf(0.999, len(expected) - 1), (stat, observed, expected)


MASK_LENGTH = 2


def _stays_past_the_length(draws, data):
    """How often the first step past the length keeps the state before it,
    the chain's own rate of that, and the standard error of the former."""
    configs, probs = _chain_joint(data[:MASK_LENGTH])
    last = np.bincount(configs[:, -1], weights=probs, minlength=2)
    p = float((last * np.diag(TRANS[1])).sum())
    return (draws[:, MASK_LENGTH] == draws[:, MASK_LENGTH - 1]).mean(), p, math.sqrt(p * (1 - p) / len(draws))


def test_masked_posterior_draws():
    """Temperature 1 on a chain whose last two steps are masked off: the
    draws within the length against the brute-force posterior of those
    steps (chi-square as above), and the first step past it keeps its state
    at the chain's own rate within 5 standard errors, since an enumerated
    site's factor is unmasked there (ROADMAP Queue 3)."""
    data = CHAIN_DATA[:4]
    names = [f"x_{t}" for t in range(len(data))]
    f = infer_discrete(_chain(pyro, dist, _f32, data, copies=DRAWS, length=MASK_LENGTH), first_available_dim=-2,
                       temperature=1, generator=torch.Generator().manual_seed(0))
    draws = _values(f, names)
    _chi2_below_its_quantile(draws[:, :MASK_LENGTH], _chain_joint(data[:MASK_LENGTH])[1])
    stays, p, se = _stays_past_the_length(draws, data)
    assert abs(stays - p) < 5 * se, (stays, p, se)


@pytest.mark.xfail(strict=True, reason=(
    "pyro_tpu/infer/discrete.py:56 masks an enumerated site's factor at temperature 1 too, so a step past the "
    "length is drawn uniformly where the port follows the chain (ROADMAP.md Queue 3)"))
def test_jax_masked_draws_follow_the_chain():
    data = CHAIN_DATA[:4]
    names = [f"x_{t}" for t in range(len(data))]
    jf = jinfer_discrete(_chain(jpyro, jdist, lambda x: jnp.asarray(x, jnp.float32), data, copies=DRAWS,
                                length=MASK_LENGTH), first_available_dim=-2, temperature=1, rng_key=jax.random.key(0))

    def jax_draws():
        trace = jpoutine.trace(jf).get_trace()
        return jnp.stack([trace.nodes[n]["value"] for n in names], -1)

    stays, p, se = _stays_past_the_length(np.asarray(jax.jit(jax_draws)()), data)
    assert abs(stays - p) < 5 * se, (stays, p, se)


def test_draws_follow_the_generator():
    f = functools.partial(infer_discrete, _chain(pyro, dist, _f32, CHAIN_DATA, copies=50), first_available_dim=-2)
    names = [f"x_{t}" for t in range(len(CHAIN_DATA))]
    a = _values(f(generator=torch.Generator().manual_seed(7)), names)
    b = _values(f(generator=torch.Generator().manual_seed(7)), names)
    c = _values(f(generator=torch.Generator().manual_seed(8)), names)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


@pytest.mark.parametrize("T_", [3, 8, 16])
@pytest.mark.parametrize("temperature", [0, 1])
def test_one_contraction_regardless_of_sites(T_, temperature, monkeypatch):
    calls = []
    contract_to_tensor = einsum_sample.contract_to_tensor
    monkeypatch.setattr(einsum_sample, "contract_to_tensor", lambda *a, **k: calls.append(1) or contract_to_tensor(*a, **k))
    infer_discrete(_chain(pyro, dist, _f32, np.zeros(T_)), first_available_dim=-1, temperature=temperature)()
    assert len(calls) == 1


def test_model_1_draws_run_logmatmulexp(monkeypatch):
    """At temperature 1 the taping forward's matmul-shaped pairs go to
    logmatmulexp (K1 on the card); at temperature 0 the max-product ring
    reaches none."""
    _, _, _, probs = _jax_model_1()
    seq, lengths = (torch.tensor(a) for a in _sequences())
    tmodel = poutine.condition(functools.partial(thmm.model_1, args=types.SimpleNamespace(hidden_dim=H)),
                               data={k: _f32(v) for k, v in probs.items()})
    calls = []
    lme = log_matmul.logmatmulexp
    monkeypatch.setattr(log_matmul, "logmatmulexp", lambda x, y: calls.append(1) or lme(x, y))
    infer_discrete(tmodel, first_available_dim=-3, temperature=1, generator=torch.Generator().manual_seed(0))(
        seq, lengths)
    assert calls
    calls.clear()
    infer_discrete(tmodel, first_available_dim=-3, temperature=0)(seq, lengths)
    assert not calls


# -- the reference's faults that raise in the port ----------------------------------


def test_marginals_refuse_a_sequential_guide_site():
    """The JAX package samples such a site once, weighted as if enumerated
    (ROADMAP Queue 3); the port raises."""

    def model():
        z = pyro.sample("z", dist.Bernoulli(torch.tensor(0.3)))
        x = pyro.sample("x", dist.Categorical(torch.tensor([0.5, 0.5])), infer={"enumerate": "parallel"})
        pyro.sample("obs", dist.Normal(x.float() + z, torch.tensor(1.0)), obs=torch.tensor(0.5))

    def guide():
        pyro.sample("z", dist.Bernoulli(torch.tensor(0.6)), infer={"enumerate": "sequential"})

    with pytest.raises(NotImplementedError, match="sequentially enumerated guide site 'z'"):
        TraceEnum_ELBO(max_plate_nesting=0).compute_marginals(model, guide)


def test_sequential_with_num_samples_raises():
    """A site both "sequential" and sampled would be expanded over its whole
    support and weighted 1/num_samples (the JAX package's
    ``iter_discrete_extend``, ROADMAP Queue 3); the port raises, naming both."""

    def model():
        pyro.sample("z", dist.Bernoulli(torch.tensor(0.3)))

    def guide():
        pyro.sample("z", dist.Bernoulli(torch.tensor(0.6)), infer={"enumerate": "sequential", "num_samples": 4})

    with pytest.raises(ValueError, match='sequential.*num_samples'):
        TraceEnum_ELBO(max_plate_nesting=0).loss(model, guide)
    with pytest.raises(ValueError, match='sequential.*num_samples'):
        config_enumerate(guide, default="sequential", num_samples=4)


def test_compute_marginals_without_enumerated_sites_is_empty():
    def model():
        pyro.sample("obs", dist.Normal(torch.tensor(0.0), torch.tensor(1.0)), obs=torch.tensor(0.3))

    assert TraceEnum_ELBO(max_plate_nesting=0).compute_marginals(model, lambda: None) == OrderedDict()
