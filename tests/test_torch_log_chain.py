"""K3f's plain version and its Functions, on the CPU.

``sequential_logmatmulexp_plain`` (the halving rounds of an exact pairwise
log-sum-exp, with its analytic VJP; what K3f computes on the card) against
the JAX package's ``_sequential_logmatmulexp`` (``jax.vjp`` for the VJP),
and, where the factors hold -inf entries, against float64 autograd of a
direct fold of the same rounds with ``torch.logsumexp`` (the JAX package
clips entries with no path at log(tiny) plus its shifts: ROADMAP Queue 3).
The Functions' vmap rules are held with CPU stand-ins for the launches, as
``tests/test_torch_func.py`` holds K1's.

Tolerances: values within 1e-5 * max|out| + 1e-5 of the reference,
gradients within 1e-4 * max|grad| (float32 against float32 JAX, sums in
another order); the float64 direct fold rtol 1e-9; the stand-in routes,
which run the plain arithmetic on folded tensors, rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor

import pyro_tpu_torch as pyro
from pyro_tpu.distributions.hmm import _sequential_logmatmulexp as jax_sequential
from pyro_tpu_torch.distributions.hmm import _sequential_logmatmulexp
from pyro_tpu_torch.ops import log_matmul as lm

NEG = -1e4  # a -inf entry in the float64 direct fold: exp(NEG + anything finite here) is 0 in float64


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _factors(seed, shape, neg_inf=0.0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    if neg_inf:
        x[rng.random(shape) < neg_inf] = -np.inf
    return x


def _values_close(actual, expected):
    """Within 1e-5 * max|expected| + 1e-5, -inf where expected is -inf."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape
    finite = np.isfinite(expected)
    scale = np.abs(expected[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-5 * scale + 1e-5)


def _grads_close(actual, expected):
    """Within 1e-4 * max|expected|."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


def _jax_value_and_vjp(x, g):
    """The JAX reduction with time at -3, (B, T, S, S)."""
    out, vjp = jax.vjp(jax.jit(jax_sequential), jnp.asarray(x))
    (d,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(d)


def _port_value_and_vjp(x, g, fn=lm.sequential_logmatmulexp_plain):
    """The port's reduction of (T, B, S, S) factors."""
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), xt.grad.numpy()


def _direct_fold(x):
    """The halving rounds with ``torch.logsumexp`` over each pair's middle
    index, in float64, -inf entries standing as NEG: (T, ..., S, S)."""
    cur = torch.where(torch.isinf(x), NEG, x)
    while cur.shape[0] > 1:
        time, even = cur.shape[0], cur.shape[0] // 2 * 2
        a, b = cur[0:even:2], cur[1:even:2]
        nxt = torch.logsumexp(a.unsqueeze(-1) + b.unsqueeze(-3), dim=-2)
        cur = torch.cat([nxt, cur[even:]], 0) if time > even else nxt
    return cur[0]


def _direct_value_and_vjp(x, g):
    """The direct fold's value (an entry below NEG / 10 is a path through a
    -inf entry: -inf) and its VJP, the adjoint of such an entry taken as 0,
    as nothing reaches it."""
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    out = _direct_fold(xt)
    none = out.detach() < NEG / 10
    out.backward(torch.where(none, 0.0, torch.tensor(g, dtype=torch.float64)))
    out = out.detach().numpy()
    return np.where(none.numpy(), -np.inf, out), xt.grad.numpy()


CASES = [(T, S) for T in (1, 2, 5, 20, 60) for S in (16, 64)]


@pytest.mark.parametrize("T,S", CASES)
def test_plain_matches_jax(T, S):
    B = 2 if S == 64 and T >= 20 else 3
    x = _factors(T * 100 + S, (T, B, S, S))
    g = _factors(T * 100 + S + 1, (B, S, S))
    out_j, d_j = _jax_value_and_vjp(np.moveaxis(x, 0, 1), g)
    out, d = _port_value_and_vjp(x, g)
    _values_close(out, out_j)
    _grads_close(d, np.moveaxis(d_j, 1, 0))


def _inf_case(name, T=9, B=2, S=16):
    x = _factors(7, (T, B, S, S), neg_inf=0.3)
    if name == "rows_and_columns":
        x[0, :, 3, :] = -np.inf  # an all -inf row
        x[4, :, :, 5] = -np.inf  # an all -inf column
        x[6, 1, 2, :] = -np.inf
    elif name == "infeasible":
        x[5, 0] = -np.inf  # every path of row 0 is infeasible
    return x, _factors(8, (B, S, S))


INF_CASES = ["entries", "rows_and_columns", "infeasible"]


@pytest.mark.parametrize("name", INF_CASES)
def test_plain_neg_inf_matches_direct_fold(name):
    """-inf exactly where no path exists, finite values and gradients
    elsewhere, and a gradient of exactly 0 through every -inf entry."""
    x, g = _inf_case(name)
    out, d = _port_value_and_vjp(x, g)
    out_r, d_r = _direct_value_and_vjp(x, g)
    assert np.array_equal(np.isneginf(out), np.isneginf(out_r)) and not np.isnan(out).any()
    _values_close(out, out_r)
    assert not np.isnan(d).any() and np.all(d[np.isneginf(x)] == 0)
    _grads_close(d, d_r)
    if name == "infeasible":
        assert np.isneginf(out[0]).all() and np.all(d[:, 0] == 0)


_JAX_CLIPS = pytest.mark.xfail(strict=True, reason="ROADMAP Queue 3: the JAX reduction clips an entry with no "
                               "path at log(tiny) plus its shifts, and its _bwd shifts over whole rows and columns")


@pytest.mark.parametrize("name", ["entries", pytest.param("rows_and_columns", marks=_JAX_CLIPS),
                                  pytest.param("infeasible", marks=_JAX_CLIPS)])
def test_jax_neg_inf_matches_direct_fold(name):
    """Scattered -inf entries leave every product entry a finite path, and
    the JAX package agrees; an all -inf row or column, or an infeasible
    chain, meets its clipping."""
    x, g = _inf_case(name)
    out_j, d_j = _jax_value_and_vjp(np.moveaxis(x, 0, 1), g)
    out_r, d_r = _direct_value_and_vjp(x, g)
    assert np.array_equal(np.isneginf(out_j), np.isneginf(out_r))
    _values_close(out_j, out_r)
    _grads_close(np.moveaxis(d_j, 1, 0), d_r)


def test_infeasible_chain_under_logsumexp_has_zero_gradients():
    """A logsumexp over an all -inf product gives -inf with a NaN adjoint;
    the backward never reads it, so no NaN reaches the factors."""
    x, _ = _inf_case("infeasible")
    xt = torch.tensor(x, requires_grad=True)
    lse = torch.logsumexp(lm.sequential_logmatmulexp_plain(xt), dim=(-2, -1))
    assert torch.isneginf(lse[0]) and torch.isfinite(lse[1])
    lse.sum().backward()
    assert not torch.isnan(xt.grad).any() and torch.all(xt.grad[:, 0] == 0)


def test_float64_plain_matches_direct_fold():
    x = _factors(3, (13, 2, 5, 5)).astype(np.float64)
    g = _factors(4, (2, 5, 5)).astype(np.float64)
    out, d = _port_value_and_vjp(x, g)
    out_r, d_r = _direct_value_and_vjp(x, g)
    np.testing.assert_allclose(out, out_r, rtol=1e-9)
    np.testing.assert_allclose(d, d_r, rtol=1e-9, atol=1e-12)


# -- routes ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,route", [(16, "chain"), (64, "chain"), (65, "rounds")])
def test_route_by_shape(S, route):
    lm.reset_chain_counts()
    x = torch.tensor(_factors(S, (3, 2, S, S)))
    out = lm.sequential_logmatmulexp_timemajor(x)
    assert lm.routes == {"chain": int(route == "chain"), "rounds": int(route == "rounds")}
    assert lm.chain_launches == {"forward": 0, "backward": 0}
    expected = lm.sequential_logmatmulexp_plain(x) if route == "chain" else lm._rounds(x, lm.logmatmulexp_plain)
    torch.testing.assert_close(out, expected, rtol=0, atol=0)


def test_hmm_reduction_takes_the_chain_route_and_matches_jax():
    x = _factors(11, (3, 7, 6, 6))
    g = _factors(12, (3, 6, 6))
    lm.reset_chain_counts()
    out, d = _port_value_and_vjp(x, g, _sequential_logmatmulexp)
    out_j, d_j = _jax_value_and_vjp(x, g)
    assert lm.routes["chain"] == 1
    _values_close(out, out_j)
    _grads_close(d, d_j)


def test_given_logmatmulexp_forces_the_rounds():
    lm.reset_chain_counts()
    x = torch.tensor(_factors(5, (6, 4, 4)))
    out = lm.sequential_logmatmulexp_timemajor(x, lm.logmatmulexp_plain)
    assert lm.routes == {"chain": 0, "rounds": 0}
    torch.testing.assert_close(out, lm.sequential_logmatmulexp_plain(x), rtol=1e-5, atol=1e-5)


def test_level_sizes_and_tape():
    assert lm._level_sizes(1) == [] and lm._level_sizes(2) == [1]
    assert lm._level_sizes(20) == [10, 5, 3, 2, 1] and lm._level_sizes(60) == [30, 15, 8, 4, 2, 1]
    out, tape = lm._chain_forward_plain(torch.tensor(_factors(1, (20, 3, 4, 4))))
    assert tape.shape == (3, 21, 4, 4) and out.shape == (3, 4, 4)
    torch.testing.assert_close(tape[:, -1], out, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["contiguous", "time_minor", "expanded", "five_dims"])
def test_chain_layout(layout):
    """The kernel's view of the factors: three batch sizes and six strides;
    more than three strided batch dims are copied, and counted."""
    lm.reset_chain_counts()
    if layout == "contiguous":
        x = torch.zeros(5, 2, 3, 4, 4)
        sizes, strides = [1, 1, 6], (96, 0, 0, 16, 4, 1)
    elif layout == "time_minor":
        x = torch.zeros(4, 4, 5, 3).permute(2, 3, 0, 1)  # (T=5, B=3, S, S), time stride 3
        sizes, strides = [1, 1, 3], (3, 0, 0, 1, 60, 15)
    elif layout == "expanded":
        x = torch.zeros(5, 1, 4, 4).expand(5, 7, 4, 4)
        sizes, strides = [1, 1, 7], (16, 0, 0, 0, 4, 1)
    else:
        x = torch.zeros(2, 2, 2, 2, 2, 4, 4).permute(0, 4, 3, 2, 1, 5, 6)
        sizes, strides = [1, 1, 16], (256, 0, 0, 16, 4, 1)
    moved, got_sizes, st = lm._chain_layout(x, "forward")
    assert got_sizes == sizes and tuple(st) == strides
    assert lm.chain_copies["forward"] == int(layout == "five_dims")
    assert torch.equal(moved, x)


# -- the Functions under torch.func, with CPU stand-ins for the launches ---------------


def _plain(*tensors):
    for t in tensors:
        assert not is_batchedtensor(t) and not is_gradtrackingtensor(t)
        t.data_ptr()


def _stand_in_route():
    """K3f's Function pair built by the factory the CUDA route uses, over
    stand-ins that refuse a batched or grad-tracking tensor (as a launch on
    its ``data_ptr`` would) and compute the plain values."""
    seen = {"forward": [], "backward": []}

    def forward(logits):
        _plain(logits)
        lm._chain_layout(logits, "forward")
        seen["forward"].append(tuple(logits.shape))
        return lm._chain_forward_plain(logits)

    def backward(logits, tape, g):
        _plain(logits, tape, g)
        assert tape.shape[:-3] == logits.shape[1:-2] and g.shape == logits.shape[1:]
        seen["backward"].append(tuple(logits.shape))
        return lm._chain_backward_plain(logits, tape, g)

    Forward, _ = lm._chain_functions(forward, backward, "stand-in")
    return Forward, seen


def _loss(fn):
    return lambda z, w: (torch.logsumexp(fn(z), dim=(-2, -1)) * w).sum()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_vmap_grad_is_one_call_each_way(lead):
    """vmap(grad) over 4 chains of a potential through the chain: one
    forward and one backward call, the chains right after time."""
    Forward, seen = _stand_in_route()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((4, 9) + lead + (5, 5)))
    w = torch.tensor(rng.standard_normal((4,) + lead))
    got = torch.func.vmap(torch.func.grad(_loss(lambda z: Forward.apply(z)[0])))(x, w)
    expected = torch.func.vmap(torch.func.grad(_loss(lm.sequential_logmatmulexp_plain)))(x, w)
    torch.testing.assert_close(got, expected, rtol=1e-12, atol=1e-14)
    for i in range(4):
        one = torch.func.grad(_loss(lm.sequential_logmatmulexp_plain))(x[i], w[i])
        torch.testing.assert_close(got[i], one, rtol=1e-12, atol=1e-14)
    assert seen == {"forward": [(9, 4) + lead + (5, 5)], "backward": [(9, 4) + lead + (5, 5)]}


def test_unbatched_factors_under_a_batched_gradient():
    """The factors shared by every example, the weights mapped: the
    backward sees the factors as a stride-0 view over the examples."""
    Forward, seen = _stand_in_route()
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((6, 2, 4, 4)))
    w = torch.tensor(rng.standard_normal((5, 2)))

    def f(z, wi):
        return _loss(lambda u: Forward.apply(u)[0])(z, wi)

    got = torch.func.vmap(torch.func.grad(f), in_dims=(None, 0))(x, w)
    for i in range(5):
        one = torch.func.grad(_loss(lm.sequential_logmatmulexp_plain))(x, w[i])
        torch.testing.assert_close(got[i], one, rtol=1e-12, atol=1e-14)
    assert seen["backward"] == [(6, 5, 2, 4, 4)]


def test_nested_vmap_recurses():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 3, 5, 4, 4)))
    w = torch.tensor(np.ones((2, 3)))
    f = _loss(lm.sequential_logmatmulexp_plain)
    got = torch.func.vmap(torch.func.vmap(torch.func.grad(f)))(x, w)
    for i in range(2):
        for j in range(3):
            torch.testing.assert_close(got[i, j], torch.func.grad(f)(x[i, j], w[i, j]), rtol=1e-12, atol=1e-14)
