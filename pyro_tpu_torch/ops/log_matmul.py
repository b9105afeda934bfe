"""Numerically stable log-space matmul, the enumeration engine's hot op:
``logmatmulexp(x, y)[..., a, c] = logsumexp_b(x[..., a, b] + y[..., b, c])``.

Counterpart of ``pyro_tpu/ops/log_matmul.py``.  On CUDA tensors the
forward and the analytic backward are the hand-written kernels of
``csrc/log_matmul.cu`` behind a ``torch.autograd.Function``; on CPU tensors
the plain version below runs instead, which mirrors the JAX package's
``_logmatmulexp_raw`` and ``_bwd`` line by line, except that the backward
keeps the entries whose Z was clipped as a class with shifts of their own
(see ``_logmatmulexp_bwd``).  A CUDA tensor never falls back to the plain
version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build, func_rules
from .func_rules import logical_ndim, per_example

# Launches of the CUDA kernels, counted by the wrapper: a forward launch runs
# two kernels (the maxima, then the product), a backward launch three (the
# per-class shifts, then the dx and the dy products).  A launch captured in a
# CUDA graph counts once, at its capture: the graph's replays are not counted.
launches = {"forward": 0, "backward": 0}
# Operands the wrapper made contiguous because their column stride was not 1.
copies = {"forward": 0, "backward": 0}


# -- plain version ----------------------------------------------------------------


def _finite(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def _logmatmulexp_raw(x, y):
    xs = _finite(x.detach().amax(-1, keepdim=True))
    ys = _finite(y.detach().amax(-2, keepdim=True))
    z = torch.matmul(torch.exp(x - xs), torch.exp(y - ys))
    return torch.log(z.clamp(min=torch.finfo(z.dtype).tiny)) + xs + ys


def _unbroadcast(d, shape):
    """Sum broadcast batch dims of ``d`` back down to ``shape``."""
    extra = d.ndim - len(shape)
    if extra:
        d = d.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(d.shape, shape)) if a != b)
    return d.sum(dim=axes, keepdim=True) if axes else d


def _clip_threshold(dtype):
    """E = -log Z at or above which an entry counts as clipped: Z was at most
    about e times the type's smallest normal (the forward clips Z there)."""
    return -math.log(torch.finfo(dtype).tiny) - 1.0


def _logmatmulexp_bwd(x, y, out, g):
    # dx[i,k] = sum_j g[i,j] exp(x[i,k] + y[k,j] - out[i,j]), dy likewise
    # summed over i, with g/Z re-shifted by its row (dx) or column (dy) max
    # so the products stay bounded when Z underflows.
    #
    # An entry whose Z was clipped (a state unreachable from the row's
    # support, or an all -inf row of x or column of y) has the largest E
    # there is, -log(tiny).  In a shift shared with the other entries it
    # would push their terms below the float32 range, and log(|r| + tiny)
    # would then add about exp(x - xs) to dx (the JAX package's _bwd does
    # so).  So the clipped entries are a class of their own, with their own
    # shift and product; dx and dy sum the classes' terms.
    xs = _finite(x.amax(-1, keepdim=True))
    ys = _finite(y.amax(-2, keepdim=True))
    P = torch.exp(x - xs)
    Q = torch.exp(y - ys)
    E = -(out - xs - ys)  # -log Z
    tiny = torch.finfo(out.dtype).tiny
    clipped = E >= _clip_threshold(out.dtype)
    classes = [torch.where(clipped, -torch.inf, E)]
    if bool(clipped.any()):
        classes.append(torch.where(clipped, E, -torch.inf))

    def term(shifted, shift, r):
        return torch.sign(r) * torch.exp((shifted + shift) + torch.log(r.abs() + tiny))

    dx = 0.0
    for Ec in classes:
        cr = _finite(Ec.amax(-1, keepdim=True))  # per-row shift
        rx = torch.matmul(g * torch.exp(Ec - cr), Q.transpose(-1, -2))
        dx = dx + term(x - xs, cr, rx)

    y_lead = y.shape[:-2]
    x_lead_n = math.prod(x.shape[:-2])
    if all(d == 1 for d in y_lead) and x_lead_n * x.shape[-2] > 1:
        # y shared across x's batch: fold batch and rows into one product
        # per class with a single per-column shift
        Pf = P.broadcast_to(g.shape[:-1] + P.shape[-1:]).reshape(-1, P.shape[-1])
        dy = 0.0
        for Ec in classes:
            cc = _finite(Ec.amax(dim=tuple(range(E.ndim - 1)), keepdim=True))
            ry = Pf.T @ (g * torch.exp(Ec - cc)).reshape(-1, g.shape[-1])
            dy = dy + term(y.reshape(y.shape[-2:]) - ys.reshape(ys.shape[-2:]), cc.reshape(1, -1), ry)
        return _unbroadcast(dx, x.shape), dy.reshape(y.shape)
    dy = 0.0
    for Ec in classes:
        cc = _finite(Ec.amax(-2, keepdim=True))  # per-column shift
        ry = torch.matmul(P.transpose(-1, -2), g * torch.exp(Ec - cc))
        dy = dy + term(y - ys, cc, ry)
    return _unbroadcast(dx, x.shape), _unbroadcast(dy, y.shape)


def _functions(forward_impl, backward_impl, route):
    """The pair of ``torch.autograd.Function``s of one route of K1: the
    forward, ``forward_impl(x, y) -> (out, *aux)``, and its backward,
    ``backward_impl(x, y, out, *aux, g) -> (dx, dy)``, each with a vmap rule
    that folds the mapped dim into the leading batch dims (an operand
    without one broadcasts in the forward and is read through a stride-0
    view in the backward) and calls the Function again on the folded
    tensors, so that the implementation only ever sees plain tensors."""

    class Backward(torch.autograd.Function):
        @staticmethod
        def forward(*args):
            return backward_impl(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, *grads):
            raise NotImplementedError(f"logmatmulexp ({route}): no second derivative")

        @staticmethod
        def vmap(info, in_dims, *args):
            # x, y, out, g have two inner dims, the maxima (aux) one
            r = logical_ndim(args[2], in_dims[2]) - 2
            inner = [2, 2, 2] + [1] * (len(args) - 4) + [2]
            moved = [func_rules.front(a, d, info.batch_size, r + k, expand=True)
                     for a, d, k in zip(args, in_dims, inner)]
            dx, dy = Backward.apply(*moved)
            return (per_example(dx, args[0], in_dims[0]), per_example(dy, args[1], in_dims[1])), (0, 0)

    class Forward(torch.autograd.Function):
        @staticmethod
        def forward(x, y):
            return forward_impl(x, y)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(*output[1:])
            ctx.save_for_backward(*inputs, *output)

        @staticmethod
        def backward(ctx, g, *aux_grads):
            return Backward.apply(*ctx.saved_tensors, g)

        @staticmethod
        def vmap(info, in_dims, x, y):
            r = max(logical_ndim(x, in_dims[0]), logical_ndim(y, in_dims[1]))
            out = Forward.apply(*(func_rules.front(a, d, info.batch_size, r) for a, d in ((x, in_dims[0]),
                                                                                        (y, in_dims[1]))))
            return out, (0,) * len(out)

    return Forward, Backward


def _forward_plain(x, y):
    return (_logmatmulexp_raw(x, y),)


_LogMatMulExpPlain, _LogMatMulExpPlainBackward = _functions(_forward_plain, _logmatmulexp_bwd, "plain")


def logmatmulexp_plain(x, y):
    """The plain PyTorch version, on any device, with the analytic VJP."""
    return _LogMatMulExpPlain.apply(x, y)[0]


# -- CUDA kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.POINTER(ctypes.c_longlong)
_I = ctypes.POINTER(ctypes.c_int)
_c = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("log_matmul")
    lib.lme_forward.argtypes = [_P, _LL, _P, _LL, _P, _P, _P, _I, _c, _c, _c, _c, _P]
    lib.lme_forward.restype = ctypes.c_int
    lib.lme_backward.argtypes = [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _I, _c, _c, _c, _c, _P]
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


def _kernel_layout(batch, tensors, direction):
    """The operands and their ``_batch_layout``; where that needs more than
    three batch dims (as a vmapped operand's stride-0 dims can), each
    operand is copied to a contiguous tensor over the whole batch, whose
    batch dims collapse to one, and the copies counted in ``copies``."""
    try:
        return tensors, _batch_layout(batch, tensors)
    except ValueError:
        tensors = [t.expand(*batch, *t.shape[-2:]).contiguous() for t in tensors]
        copies[direction] += len(tensors)
        return tensors, _batch_layout(batch, tensors)


def _ll(strides):
    return (ctypes.c_longlong * 5)(*strides)


def _ints(sizes):
    return (ctypes.c_int * 3)(*sizes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _unit_columns(tensors, direction):
    """The kernels read rows with a column stride of 1: an operand with
    another is made contiguous, and the copy counted in ``copies``."""
    out = []
    for t in tensors:
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            t = t.contiguous()
            copies[direction] += 1
        out.append(t)
    return out


def _vectorizable(tensors, strides, K, N):
    """Whether every operand row can be copied 16 bytes at a time: 16-byte
    aligned data, batch and row strides multiples of 4 floats, and K and N
    multiples of 4 (the contiguous extents of x, and of y, out and g)."""
    return (
        K % 4 == 0
        and N % 4 == 0
        and all(t.data_ptr() % 16 == 0 for t in tensors)
        and all(s % 4 == 0 for st in strides for s in st[:4])
    )


def _forward_cuda(x, y):
    """out, and the finite row maxima of x (batch + (M,)) and column maxima
    of y (batch + (N,)) that the backward takes."""
    _check_cuda(x, y)
    M, K = x.shape[-2:]
    if y.shape[-2] != K:
        raise ValueError(f"logmatmulexp: inner dims differ: {tuple(x.shape)} @ {tuple(y.shape)}")
    N = y.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    out = torch.empty(batch + (M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or K == 0:
        raise ValueError(f"logmatmulexp: empty operands {tuple(x.shape)} @ {tuple(y.shape)}")
    x, y = _unit_columns([x, y], "forward")
    xs = torch.empty(batch + (M,), dtype=x.dtype, device=x.device)
    ys = torch.empty(batch + (N,), dtype=x.dtype, device=x.device)
    (x, y), (sizes, (xst, yst)) = _kernel_layout(batch, [x, y], "forward")
    err = _lib().lme_forward(
        x.data_ptr(), _ll(xst), y.data_ptr(), _ll(yst), out.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        _ints(sizes), M, K, N, int(_vectorizable([x, y], [xst, yst], K, N)), _stream(x),
    )
    if err:
        raise RuntimeError(f"logmatmulexp forward kernels failed to launch: CUDA error {err}")
    launches["forward"] += 1
    return out, xs, ys


def _backward_cuda(x, y, out, xs, ys, g):
    """dx and dy (summed over broadcast dims) from the forward's out and
    maxima."""
    _check_cuda(x, y, out, g)
    if g.shape != out.shape:
        raise ValueError(f"logmatmulexp: gradient shape {tuple(g.shape)} != output {tuple(out.shape)}")
    M, K = x.shape[-2:]
    N = y.shape[-1]
    batch = out.shape[:-2]
    nb = math.prod(batch)
    xu, yu, out, g = _unit_columns([x, y, out, g], "backward")
    xs, ys = xs.contiguous(), ys.contiguous()
    dx = torch.empty(batch + (M, K), dtype=x.dtype, device=x.device)
    dy = torch.empty(batch + (K, N), dtype=x.dtype, device=x.device)
    # per-row shifts of both classes, then per 32-row strip the column shifts
    scratch = torch.empty(nb * 2 * (M + -(-M // 32) * N), dtype=x.dtype, device=x.device)
    (xu, yu, out, g), (sizes, strides) = _kernel_layout(batch, [xu, yu, out, g], "backward")
    xst, yst, ost, gst = strides
    err = _lib().lme_backward(
        xu.data_ptr(), _ll(xst), yu.data_ptr(), _ll(yst), out.data_ptr(), _ll(ost),
        g.data_ptr(), _ll(gst), xs.data_ptr(), ys.data_ptr(), scratch.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        _ints(sizes), M, K, N, int(_vectorizable([xu, yu, out, g], strides, K, N)), _stream(x),
    )
    if err:
        raise RuntimeError(f"logmatmulexp backward kernels failed to launch: CUDA error {err}")
    launches["backward"] += 1
    return _unbroadcast(dx, x.shape), _unbroadcast(dy, y.shape)


# the launches looked up when called, so that a recording wrapper can stand in
_LogMatMulExpCUDA, _LogMatMulExpCUDABackward = _functions(
    lambda x, y: _forward_cuda(x, y), lambda *args: _backward_cuda(*args), "cuda")


def logmatmulexp(x, y):
    """log(exp(x) @ exp(y)) with max-shift stabilisation and an analytic
    backward; batch dims broadcast like ``torch.matmul``.  CUDA tensors go
    through the hand-written kernels, CPU tensors through the plain version."""
    if x.is_cuda or y.is_cuda:
        return _LogMatMulExpCUDA.apply(x, y)[0]
    return logmatmulexp_plain(x, y)


def sequential_logmatmulexp_timemajor(logits, logmatmulexp=logmatmulexp):
    """Reduce a (T, ..., S, S) chain of log transition factors to one
    (..., S, S) factor in ceil(log2 T) halving rounds, each one batched
    ``logmatmulexp`` over the time-paired halves (K1 on the card: one
    launch a round each way).  Counterpart of
    ``pyro_tpu/ops/log_matmul.py::sequential_logmatmulexp_timemajor``
    (K3), whose body is ``logmatmulexp`` in rounds.  The halves are strided
    views along the leading time axis, which the kernel reads in place; an
    odd round's last factor passes through to the next."""
    while logits.shape[0] > 1:
        time = logits.shape[0]
        even = time // 2 * 2
        pairs = logits[:even].reshape((time // 2, 2) + logits.shape[1:])
        contracted = logmatmulexp(pairs[:, 0], pairs[:, 1])
        if time > even:
            contracted = torch.cat([contracted, logits[even:]], dim=0)
        logits = contracted
    return logits[0]
