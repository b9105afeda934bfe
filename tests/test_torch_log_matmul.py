"""The port's logmatmulexp against the JAX package's, on the CPU.

Every case of ``tests/test_log_matmul.py`` goes through both: values, and
the VJP (``jax.vjp`` against torch autograd through the analytic backward).
Tolerances: values rtol 1e-5 (atol 1e-5 for log values near 0); VJPs rtol
1e-4 with atol 1e-5 * max|g| (float32 matmuls sum in another order).
The kernel's own layout logic (batch strides) is checked here too; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro_tpu.distributions.hmm import _sequential_logmatmulexp as jax_sequential
from pyro_tpu.ops.log_matmul import logmatmulexp as jax_lme
import pyro_tpu_torch as pyro
from pyro_tpu_torch.distributions.hmm import _sequential_logmatmulexp
from pyro_tpu_torch.ops import log_matmul as lm


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _underflow():
    x = np.full((4, 8), -300.0, np.float32)
    x[:, 0] = 0.0
    y = np.full((8, 8), -200.0, np.float32)
    y[1:, :] = -1.0
    return x, y, _normal(7, (4, 8), 5.0)


def _neg_inf():
    x, _, _ = _underflow()
    x[0, :] = -np.inf
    y = np.full((8, 8), -200.0, np.float32)
    y[:, 3] = -np.inf
    return x, y, np.ones((4, 8), np.float32)


def _neg_inf_rows():
    x = _normal(5, (64, 64))
    x[0, :] = -np.inf
    return x, _normal(6, (64, 64)), _normal(7, (64, 64))


CASES = {
    "ground_truth": lambda: (_normal(0, (128, 64), 3), _normal(1, (64, 96), 3), _normal(2, (128, 96))),
    "batched": lambda: (_normal(3, (4, 32, 16), 2), _normal(4, (4, 16, 24), 2), _normal(5, (4, 32, 24))),
    "broadcast_x": lambda: (_normal(3, (32, 16), 2), _normal(4, (4, 16, 24), 2), _normal(5, (4, 32, 24))),
    "neg_inf_rows": _neg_inf_rows,
    "vjp_2d": lambda: (_normal(8, (8, 16)), _normal(9, (16, 8)), _normal(10, (8, 8))),
    "vjp_batched": lambda: (_normal(8, (3, 8, 16)), _normal(9, (3, 16, 8)), _normal(10, (3, 8, 8))),
    "underflow": _underflow,
    "neg_inf_operands": _neg_inf,
    "broadcast_batch": lambda: (_normal(11, (8, 16)), _normal(12, (5, 16, 8)), _normal(13, (5, 8, 8))),
    "shared_y": lambda: (_normal(14, (6, 8, 16)), _normal(15, (1, 16, 8)), _normal(16, (6, 8, 8))),
}


# Cases with an all -inf row of x or column of y: the JAX package's _bwd
# lets that row's E set the shift, which pushes the other terms below the
# float32 range (XLA flushes them to 0), so its VJP is wrong there.  The
# port's shifts skip such rows; its VJP is held against the direct form
# in float64 instead.
REFERENCE_FAULT = {"neg_inf_rows", "neg_inf_operands"}


@jax.jit
def _jax_value_and_vjp(x, y, g):
    out, vjp = jax.vjp(jax_lme, x, y)
    return (out,) + vjp(g)


def _direct_vjp(x, y, out, g):
    """dx[i,k] = sum_j g exp(x[i,k] + y[k,j] - out[i,j]), dy over i, in float64."""
    w = np.exp(x.astype(np.float64)[:, :, None] + y.astype(np.float64)[None] - out.astype(np.float64)[:, None, :])
    w = np.nan_to_num(w)
    return (g[:, None, :] * w).sum(-1), (g[:, None, :] * w).sum(0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    x, y, g = CASES[case]()
    out_j, dx_j, dy_j = _jax_value_and_vjp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    out = lm.logmatmulexp(xt, yt)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    if case in REFERENCE_FAULT:
        dx_j, dy_j = _direct_vjp(x, y, out.detach().numpy(), g)
    atol = 1e-5 * np.abs(g).max()
    assert np.isfinite(xt.grad.numpy()).all() and np.isfinite(yt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_j), rtol=1e-4, atol=atol)


def _clipped(batch=()):
    """Half the rows of x have their support in the first quarter of k, from
    which y reaches no column of the last quarter: those rows' z is 0 there,
    clipped at FLT_MIN, while every other entry of those columns is not."""
    M = K = N = 32
    x = _normal(20, batch + (M, K), 3)
    y = _normal(21, batch + (K, N), 3)
    x[..., : M // 2, K // 4:] = -np.inf
    y[..., : K // 4, 3 * N // 4:] = -np.inf
    return x, y, _normal(22, batch + (M, N))


CLIPPED = {"2d": lambda: _clipped(), "batched": lambda: _clipped((3,))}


def _direct_vjp_batched(x, y, out, g):
    if x.ndim == 2:
        return _direct_vjp(x, y, out, g)
    pairs = [_direct_vjp(*a) for a in zip(x, y, out, g)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("case", sorted(CLIPPED))
def test_clipped_entries_gradient_matches_float64(case):
    """Each class (clipped entries, the rest) has its own shift, so the
    clipped entries take nothing from the others' terms: dx and dy within
    1e-4 * max|grad| of the direct form in float64."""
    x, y, g = CLIPPED[case]()
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    out = lm.logmatmulexp(xt, yt)
    out.backward(torch.tensor(g))
    assert (out.detach().numpy() < -80).any()
    for got, want in zip((xt.grad, yt.grad), _direct_vjp_batched(x, y, out.detach().numpy(), g)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.xfail(strict=True, reason="pyro_tpu/ops/log_matmul.py::_bwd shift fault, ROADMAP.md Queue 3")
@pytest.mark.parametrize("case", sorted(CLIPPED))
def test_clipped_entries_gradient_matches_jax(case):
    """The JAX package's _bwd shares one shift between the classes."""
    x, y, g = CLIPPED[case]()
    _, dx_j, dy_j = _jax_value_and_vjp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    lm.logmatmulexp(xt, yt).backward(torch.tensor(g))
    for got, want in zip((xt.grad, yt.grad), (dx_j, dy_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_neg_inf_rows_clip_to_log_tiny():
    x, y, _ = _neg_inf_rows()
    out = lm.logmatmulexp(torch.tensor(x), torch.tensor(y))
    assert not torch.isnan(out).any()
    assert (out[0] < -80).all() and torch.isfinite(out).all()


@pytest.mark.parametrize("time", [7, 13, 16])
def test_sequential_reduction_matches_jax(time):
    logits = _normal(time, (3, time, 6, 6), 2)
    g = _normal(time + 1, (3, 6, 6))
    out_j, vjp = jax.vjp(jax.jit(jax_sequential), jnp.asarray(logits))
    (d_j,) = vjp(jnp.asarray(g))
    lt = torch.tensor(logits, requires_grad=True)
    out = _sequential_logmatmulexp(lt)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_cpu_tensors_take_the_plain_version():
    x, y = torch.randn(4, 8), torch.randn(8, 3)
    before = dict(lm.launches)
    torch.testing.assert_close(lm.logmatmulexp(x, y), lm.logmatmulexp_plain(x, y), rtol=0, atol=0)
    assert lm.launches == before


def _layout(xshape, yshape):
    x, y = torch.zeros(xshape), torch.zeros(yshape)
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    return lm._batch_layout(batch, [x, y])


def test_layout_merges_contiguous_batch():
    sizes, (xs, ys) = _layout((2, 3, 4, 5), (2, 3, 5, 6))
    assert sizes == [1, 1, 6]
    assert xs == (0, 0, 20, 5, 1) and ys == (0, 0, 30, 6, 1)


def test_layout_broadcast_gets_stride_zero():
    sizes, (xs, ys) = _layout((4, 5), (3, 5, 6))
    assert sizes == [1, 1, 3]
    assert xs == (0, 0, 0, 5, 1) and ys == (0, 0, 30, 6, 1)


@pytest.mark.parametrize("time,ndims", [(12, 1), (13, 2)])
def test_layout_of_time_paired_halves(time, ndims):
    logits = torch.zeros(3, time, 4, 4)
    even = time // 2 * 2
    half = logits[..., :even, :, :].reshape(3, even // 2, 2, 4, 4)[..., 0, :, :]
    sizes, (st, _) = lm._batch_layout(half.shape[:-2], [half, half])
    assert sum(n != 1 for n in sizes) == ndims
    assert st[-2:] == (4, 1)


def test_unit_columns_copy_only_strided_columns():
    halves = torch.zeros(3, 12, 8, 8).reshape(3, 6, 2, 8, 8)[..., 0, :, :]
    column = torch.zeros(1, 5).T  # one column: its stride is never used
    transposed = torch.zeros(8, 5).T
    before = dict(lm.copies)
    kept = lm._unit_columns([halves, column, transposed], "forward")
    assert kept[0] is halves and kept[1] is column
    assert kept[2].is_contiguous() and torch.equal(kept[2], transposed)
    assert lm.copies == {**before, "forward": before["forward"] + 1}


@pytest.mark.parametrize(
    "shape,cut,vec",
    [
        ((3, 12, 24, 24), None, True),  # the time-paired halves of the main path
        ((3, 12, 24, 24), (slice(None), slice(None), slice(0, 21), slice(0, 21)), False),  # K, N not multiples of 4
        ((3, 12, 24, 26), (slice(None), slice(None), slice(None), slice(0, 24)), False),  # row stride 26
    ],
)
def test_vectorizable(shape, cut, vec):
    logits = torch.zeros(shape)
    logits = logits if cut is None else logits[cut]
    pairs = logits.reshape(3, 6, 2, *logits.shape[2:])
    x, y = pairs[..., 0, :, :], pairs[..., 1, :, :]
    if x.shape[-1] != y.shape[-2]:
        y = y[..., : x.shape[-1], :]
    sizes, strides = lm._batch_layout(x.shape[:-2], [x, y])
    assert lm._vectorizable([x, y], strides, x.shape[-1], y.shape[-1]) == vec


def test_layout_rejects_more_than_three_strided_dims():
    x = torch.zeros(2, 2, 2, 2, 4, 4).permute(3, 2, 1, 0, 4, 5)  # no two batch dims merge
    y = torch.zeros(2, 2, 2, 2, 4, 4)
    with pytest.raises(ValueError, match="three"):
        lm._batch_layout(x.shape[:-2], [x, y])
