"""Numerically stable log-space matmul, the enumeration engine's hot op:
``logmatmulexp(x, y)[..., a, c] = logsumexp_b(x[..., a, b] + y[..., b, c])``.

Counterpart of ``pyro_tpu/ops/log_matmul.py``.  On CUDA tensors the
forward and the analytic backward are the hand-written kernels of
``csrc/log_matmul.cu`` behind a ``torch.autograd.Function``; on CPU tensors
the plain version below runs instead, which mirrors the JAX package's
``_logmatmulexp_raw`` and ``_bwd`` line by line, except that the backward's
shifts skip all -inf rows of x and columns of y (see ``_logmatmulexp_bwd``).
A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

# Launches of the CUDA kernels, counted by the wrapper; a backward launch runs
# two kernels (per-item maxima, then both gradient products).
launches = {"forward": 0, "backward": 0}


# -- plain version ----------------------------------------------------------------


def _logmatmulexp_raw(x, y):
    xs = x.detach().amax(-1, keepdim=True)
    ys = y.detach().amax(-2, keepdim=True)
    xs = torch.where(torch.isfinite(xs), xs, 0.0)
    ys = torch.where(torch.isfinite(ys), ys, 0.0)
    z = torch.matmul(torch.exp(x - xs), torch.exp(y - ys))
    return torch.log(z.clamp(min=torch.finfo(z.dtype).tiny)) + xs + ys


def _unbroadcast(d, shape):
    """Sum broadcast batch dims of ``d`` back down to ``shape``."""
    extra = d.ndim - len(shape)
    if extra:
        d = d.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(d.shape, shape)) if a != b)
    return d.sum(dim=axes, keepdim=True) if axes else d


def _logmatmulexp_bwd(x, y, out, g):
    # dx[i,k] = sum_j g[i,j] exp(x[i,k] + y[k,j] - out[i,j]), dy likewise
    # summed over i, with g/Z re-shifted by its row (dx) or column (dy) max
    # so the products stay bounded when Z underflows.
    xs_raw = x.amax(-1, keepdim=True)
    xs = torch.where(torch.isfinite(xs_raw), xs_raw, 0.0)
    ys_raw = y.amax(-2, keepdim=True)
    ys = torch.where(torch.isfinite(ys_raw), ys_raw, 0.0)
    P = torch.exp(x - xs)
    Q = torch.exp(y - ys)
    E = -(out - xs - ys)  # -log Z
    tiny = torch.finfo(out.dtype).tiny
    # An all -inf row of x (column of y) carries no weight, but its clipped
    # out makes its E the largest; left in a shift's max, it would push every
    # other term below the float32 range.  The JAX package's _bwd keeps it
    # in; here the shifts skip it.
    E_live_rows = torch.where(xs_raw > -torch.inf, E, -torch.inf)
    E_live_cols = torch.where(ys_raw > -torch.inf, E, -torch.inf)

    cr = E_live_cols.amax(-1, keepdim=True)  # per-row shift for dx
    cr = torch.where(torch.isfinite(cr), cr, 0.0)
    rx = torch.matmul(g * torch.exp(E - cr), Q.transpose(-1, -2))
    dx = torch.sign(rx) * torch.exp((x - xs + cr) + torch.log(rx.abs() + tiny))

    y_lead = y.shape[:-2]
    x_lead_n = math.prod(x.shape[:-2])
    if all(d == 1 for d in y_lead) and x_lead_n * x.shape[-2] > 1:
        # y shared across x's batch: fold batch and rows into one product
        # with a single per-column shift
        cc = E_live_rows.amax(dim=tuple(range(E.ndim - 1)), keepdim=True)
        cc = torch.where(torch.isfinite(cc), cc, 0.0)
        Gf = (g * torch.exp(E - cc)).reshape(-1, g.shape[-1])
        Pf = P.broadcast_to(g.shape[:-1] + P.shape[-1:]).reshape(-1, P.shape[-1])
        ry = Pf.T @ Gf
        dy = (
            torch.sign(ry)
            * torch.exp(
                (y.reshape(y.shape[-2:]) - ys.reshape(ys.shape[-2:]) + cc.reshape(1, -1))
                + torch.log(ry.abs() + tiny)
            )
        ).reshape(y.shape)
        return _unbroadcast(dx, x.shape), dy
    cc = E_live_rows.amax(-2, keepdim=True)  # per-column shift for dy
    cc = torch.where(torch.isfinite(cc), cc, 0.0)
    ry = torch.matmul(P.transpose(-1, -2), g * torch.exp(E - cc))
    dy = torch.sign(ry) * torch.exp((y - ys + cc) + torch.log(ry.abs() + tiny))
    return _unbroadcast(dx, x.shape), _unbroadcast(dy, y.shape)


class _LogMatMulExpPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        out = _logmatmulexp_raw(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _logmatmulexp_bwd(*ctx.saved_tensors, g)


def logmatmulexp_plain(x, y):
    """The plain PyTorch version, on any device, with the analytic VJP."""
    return _LogMatMulExpPlain.apply(x, y)


# -- CUDA kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.POINTER(ctypes.c_longlong)
_I = ctypes.POINTER(ctypes.c_int)
_c = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("log_matmul")
    lib.lme_forward.argtypes = [_P, _LL, _P, _LL, _P, _I, _c, _c, _c, _P]
    lib.lme_forward.restype = ctypes.c_int
    lib.lme_backward.argtypes = [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _I, _c, _c, _c, _P]
    lib.lme_backward.restype = ctypes.c_int
    return lib


def _check_cuda(*tensors):
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(
                f"logmatmulexp: operands must lie on one CUDA device, got {[str(u.device) for u in tensors]}"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"logmatmulexp: the CUDA kernel takes float32, got {t.dtype}")
        if t.ndim < 2:
            raise ValueError(f"logmatmulexp: operands need 2 or more dims, got shape {tuple(t.shape)}")


def _batch_layout(batch, tensors):
    """Collapse the broadcast batch dims of ``tensors`` into at most three
    dims with one element stride per tensor each.  Returns the three sizes
    and, per tensor, five strides (three batch, row, column).  Raises if the
    layout needs more than three batch dims."""
    views = [t.expand(*batch, *t.shape[-2:]) for t in tensors]
    keep = [i for i, n in enumerate(batch) if n != 1]
    sizes, strides = [], [[] for _ in views]
    for i in keep:
        n = batch[i]
        if sizes and all(st[-1] == v.stride(i) * n for st, v in zip(strides, views)):
            sizes[-1] *= n
            for st, v in zip(strides, views):
                st[-1] = v.stride(i)
        else:
            sizes.append(n)
            for st, v in zip(strides, views):
                st.append(v.stride(i))
    if len(sizes) > 3:
        raise ValueError(
            "logmatmulexp: the operands' batch layout needs more than three strided dims: "
            f"{[tuple(t.stride()) for t in tensors]}"
        )
    pad = 3 - len(sizes)
    sizes = [1] * pad + sizes
    out = [tuple([0] * pad + st) + tuple(v.stride()[-2:]) for st, v in zip(strides, views)]
    return sizes, out


def _ll(strides):
    return (ctypes.c_longlong * 5)(*strides)


def _ints(sizes):
    return (ctypes.c_int * 3)(*sizes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(x, y):
    _check_cuda(x, y)
    M, K = x.shape[-2:]
    if y.shape[-2] != K:
        raise ValueError(f"logmatmulexp: inner dims differ: {tuple(x.shape)} @ {tuple(y.shape)}")
    N = y.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    out = torch.empty(batch + (M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or K == 0:
        raise ValueError(f"logmatmulexp: empty operands {tuple(x.shape)} @ {tuple(y.shape)}")
    sizes, (xst, yst) = _batch_layout(batch, [x, y])
    err = _lib().lme_forward(
        x.data_ptr(), _ll(xst), y.data_ptr(), _ll(yst), out.data_ptr(), _ints(sizes), M, K, N, _stream(x)
    )
    if err:
        raise RuntimeError(f"logmatmulexp forward kernel failed to launch: CUDA error {err}")
    launches["forward"] += 1
    return out


def _backward_cuda(x, y, out, g):
    _check_cuda(x, y, out, g)
    if g.shape != out.shape:
        raise ValueError(f"logmatmulexp: gradient shape {tuple(g.shape)} != output {tuple(out.shape)}")
    M, K = x.shape[-2:]
    N = y.shape[-1]
    batch = out.shape[:-2]
    nb = math.prod(batch)
    dx = torch.empty(batch + (M, K), dtype=x.dtype, device=x.device)
    dy = torch.empty(batch + (K, N), dtype=x.dtype, device=x.device)
    scratch = torch.empty(nb * (2 * M + 2 * N), dtype=x.dtype, device=x.device)
    sizes, (xst, yst, ost, gst) = _batch_layout(batch, [x, y, out, g])
    err = _lib().lme_backward(
        x.data_ptr(), _ll(xst), y.data_ptr(), _ll(yst), out.data_ptr(), _ll(ost),
        g.data_ptr(), _ll(gst), scratch.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        _ints(sizes), M, K, N, _stream(x),
    )
    if err:
        raise RuntimeError(f"logmatmulexp backward kernels failed to launch: CUDA error {err}")
    launches["backward"] += 1
    return _unbroadcast(dx, x.shape), _unbroadcast(dy, y.shape)


class _LogMatMulExpCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        out = _forward_cuda(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward_cuda(*ctx.saved_tensors, g)


def logmatmulexp(x, y):
    """log(exp(x) @ exp(y)) with max-shift stabilisation and an analytic
    backward; batch dims broadcast like ``torch.matmul``.  CUDA tensors go
    through the hand-written kernels, CPU tensors through the plain version."""
    if x.is_cuda or y.is_cuda:
        return _LogMatMulExpCUDA.apply(x, y)
    return logmatmulexp_plain(x, y)
