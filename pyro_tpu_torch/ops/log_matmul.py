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

The chain reduction of K3 (``sequential_logmatmulexp_timemajor``) takes
K1 a round above 64 states and, at or below, K3f (``log_chain``,
``csrc/log_chain.cu``): the whole chain in one launch each way, with the
exact log-sum-exp of each entry, so an entry with no finite path is -inf
(K1 clips it at log(FLT_MIN) plus its shifts).
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


def _rounds(logits, pair):
    """ceil(log2 T) halving rounds of ``pair`` over the time-paired
    halves (strided views along the leading time axis, which K1 reads in
    place); an odd round's last factor passes through to the next."""
    while logits.shape[0] > 1:
        time = logits.shape[0]
        even = time // 2 * 2
        pairs = logits[:even].reshape((time // 2, 2) + logits.shape[1:])
        contracted = pair(pairs[:, 0], pairs[:, 1])
        if time > even:
            contracted = torch.cat([contracted, logits[even:]], dim=0)
        logits = contracted
    return logits[0]


def sequential_logmatmulexp_timemajor(logits, pair=None):
    """Reduce a (T, ..., S, S) chain of log transition factors to one
    (..., S, S) factor in ceil(log2 T) halving rounds.  Counterpart of
    ``pyro_tpu/ops/log_matmul.py::sequential_logmatmulexp_timemajor`` (K3).

    The route is chosen by shape and counted in ``routes``: at S <= 64
    (``CHAIN_MAX_STATES``) the whole chain is ``log_chain``, K3f on the card
    (one launch each way) and ``sequential_logmatmulexp_plain`` on the CPU;
    above it, each round is one batched ``logmatmulexp``, K1 on the card.
    A given ``pair`` function (``logmatmulexp_plain``, say) forces the
    rounds through it."""
    if pair is None:
        if logits.shape[-1] <= CHAIN_MAX_STATES:
            routes["chain"] += 1
            return log_chain(logits)
        routes["rounds"] += 1
        pair = logmatmulexp
    return _rounds(logits, pair)


# -- K3f: a chain of small log-space matrices in one launch each way ---------------

# S up to which a chain takes K3f: a CTA stages a pair of S x S factors at
# once (four with the backward's out and adjoint) in shared memory.
CHAIN_MAX_STATES = 64
# Routes ``sequential_logmatmulexp_timemajor`` took, by shape.
routes = {"chain": 0, "rounds": 0}
# Launches of K3f, counted by its wrapper (a CUDA graph's capture counts
# once, its replays not at all), and inputs it copied to a contiguous tensor
# because their batch layout needs more than three strided dims.
chain_launches = {"forward": 0, "backward": 0}
chain_copies = {"forward": 0, "backward": 0}


def reset_chain_counts():
    for d in (routes, chain_launches, chain_copies):
        for k in d:
            d[k] = 0


def _level_sizes(time):
    """The factor counts of the rounds' outputs, n_1 .. n_R (n_R = 1)."""
    sizes = []
    while time > 1:
        time = (time + 1) // 2
        sizes.append(time)
    return sizes


def _pair_plain(x, y):
    """log sum_k exp(x[..., i, k] + y[..., k, j]): the max over k, then the
    shifted sum, so an entry with no finite path is exactly -inf."""
    s = x.unsqueeze(-1) + y.unsqueeze(-3)  # (..., i, k, j)
    m = s.amax(-2, keepdim=True)
    m = torch.where(m == -torch.inf, 0.0, m)
    return (m + torch.log(torch.exp(s - m).sum(-2, keepdim=True))).squeeze(-2)


def _pair_vjp_plain(x, y, out, g):
    """dx[i, k] = sum_j g exp(x + y - out) and dy[k, j] = sum_i likewise,
    skipping every (i, j) where out is -inf (its g is never read)."""
    live = out != -torch.inf
    g = torch.where(live, g, 0.0)
    w = torch.exp(x.unsqueeze(-1) + y.unsqueeze(-3) - torch.where(live, out, 0.0).unsqueeze(-2))
    w = w * g.unsqueeze(-2)
    return w.sum(-1), w.sum(-3)


def _chain_forward_plain(logits):
    """(out, tape): the chain's product and every round's outputs,
    (..., L, S, S) with L = sum of ``_level_sizes(T)``."""
    levels, cur = [], logits
    while cur.shape[0] > 1:
        time = cur.shape[0]
        even = time // 2 * 2
        nxt = _pair_plain(cur[0:even:2], cur[1:even:2])
        if time > even:
            nxt = torch.cat([nxt, cur[even:]], dim=0)
        levels.append(nxt)
        cur = nxt
    return cur[0], torch.cat(levels, dim=0).movedim(0, -3)


def _chain_backward_plain(logits, tape, g):
    """The VJP of ``_chain_forward_plain`` from its tape: the rounds'
    adjoints in reverse."""
    sizes = _level_sizes(logits.shape[0])
    levels = [logits] + list(torch.split(tape.movedim(-3, 0), sizes, dim=0))
    adj = g.unsqueeze(0)
    for r in reversed(range(len(sizes))):
        cur = levels[r]
        time, half = cur.shape[0], cur.shape[0] // 2
        dx, dy = _pair_vjp_plain(cur[0:2 * half:2], cur[1:2 * half:2], levels[r + 1][:half], adj[:half])
        new = torch.stack([dx, dy], dim=1).reshape((2 * half,) + cur.shape[1:])
        if time > 2 * half:
            new = torch.cat([new, adj[half:]], dim=0)
        adj = new
    return adj


def _chain_functions(forward_impl, backward_impl, route):
    """The pair of ``torch.autograd.Function``s of one route of K3f: the
    forward, ``forward_impl(logits) -> (out, tape)``, and its backward,
    ``backward_impl(logits, tape, g) -> dlogits``.  Their vmap rules put
    the mapped dim right after time, where it joins the batch rows (an
    operand without it gets it as a stride-0 view in the backward), and
    call the Function again, so a vmapped chain of C chains is one call
    each way."""

    class Backward(torch.autograd.Function):
        @staticmethod
        def forward(logits, tape, g):
            return backward_impl(logits, tape, g)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, grad):
            raise NotImplementedError(f"log_chain ({route}): no second derivative")

        @staticmethod
        def vmap(info, in_dims, logits, tape, g):
            n = info.batch_size
            dl, dt, dg = in_dims
            logits = logits.movedim(dl, 1) if dl is not None else logits.unsqueeze(1).expand(
                logits.shape[:1] + (n,) + logits.shape[1:])
            tape = tape.movedim(dt, 0) if dt is not None else tape.expand((n,) + tape.shape)
            g = g.movedim(dg, 0) if dg is not None else g.expand((n,) + g.shape)
            return Backward.apply(logits, tape, g), 1

    class Forward(torch.autograd.Function):
        @staticmethod
        def forward(logits):
            return forward_impl(logits)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(output[1])
            ctx.save_for_backward(inputs[0], output[1])

        @staticmethod
        def backward(ctx, g, g_tape):
            return Backward.apply(*ctx.saved_tensors, g)

        @staticmethod
        def vmap(info, in_dims, logits):
            (d,) = in_dims
            return Forward.apply(logits.movedim(d, 1)), (0, 0)

    return Forward, Backward


_LogChainPlain, _LogChainPlainBackward = _chain_functions(_chain_forward_plain, _chain_backward_plain, "plain")


def sequential_logmatmulexp_plain(logits):
    """The plain PyTorch version of K3f, on any device: the halving rounds of
    an exact pairwise log-sum-exp (``_pair_plain``) with the analytic VJP.
    An entry with no finite path is -inf and passes a gradient of exactly
    0."""
    if logits.shape[0] == 1:
        return logits[0]
    return _LogChainPlain.apply(logits)[0]


_LLP = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _chain_lib():
    lib = cuda_build.load("log_chain")
    lib.lc_tape_factors.argtypes = [_c]
    lib.lc_tape_factors.restype = ctypes.c_longlong
    lib.lc_forward.argtypes = [_P, _LLP, _I, _c, _c, _P, _P, _P]
    lib.lc_forward.restype = ctypes.c_int
    lib.lc_backward.argtypes = [_P, _LLP, _I, _c, _c, _P, _P, _P, _P, _P]
    lib.lc_backward.restype = ctypes.c_int
    return lib


def _check_chain(logits):
    if not logits.is_cuda:
        raise ValueError(f"log_chain: the factors must lie on a CUDA device, got {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"log_chain: the CUDA kernel takes float32, got {logits.dtype}")
    if logits.ndim < 3 or logits.shape[-1] != logits.shape[-2]:
        raise ValueError(f"log_chain: factors must be (T, ..., S, S), got shape {tuple(logits.shape)}")
    if not 1 <= logits.shape[-1] <= CHAIN_MAX_STATES or logits.shape[0] < 2:
        raise ValueError(f"log_chain: the kernel takes 2 <= T and 1 <= S <= {CHAIN_MAX_STATES}, got shape "
                         f"{tuple(logits.shape)}")


def _chain_layout(logits, direction):
    """``logits`` (copied to a contiguous tensor, and counted, where its
    batch dims need more than three strided dims), the three batch sizes
    and the six strides (time, three batch, row, column)."""
    batch = logits.shape[1:-2]
    try:
        sizes, (st,) = _batch_layout(batch, [logits[0]])
    except ValueError:
        logits = logits.contiguous()
        chain_copies[direction] += 1
        sizes, (st,) = _batch_layout(batch, [logits[0]])
    return logits, sizes, (ctypes.c_longlong * 6)(logits.stride(0), *st)


def _chain_forward_cuda(logits):
    _check_chain(logits)
    T, S = logits.shape[0], logits.shape[-1]
    batch = logits.shape[1:-2]
    logits, sizes, st = _chain_layout(logits, "forward")
    lib = _chain_lib()
    tape = torch.empty(batch + (lib.lc_tape_factors(T), S, S), dtype=logits.dtype, device=logits.device)
    out = torch.empty(batch + (S, S), dtype=logits.dtype, device=logits.device)
    err = lib.lc_forward(logits.data_ptr(), st, _ints(sizes), T, S, tape.data_ptr(), out.data_ptr(),
                         _stream(logits))
    if err:
        raise RuntimeError(f"log_chain forward kernel failed to launch: CUDA error {err}")
    chain_launches["forward"] += 1
    return out, tape


def _chain_backward_cuda(logits, tape, g):
    _check_chain(logits)
    T, S = logits.shape[0], logits.shape[-1]
    batch = logits.shape[1:-2]
    if tuple(g.shape) != tuple(batch) + (S, S) or tape.shape[:-3] != batch:
        raise ValueError(f"log_chain: gradient {tuple(g.shape)} or tape {tuple(tape.shape)} does not match "
                         f"factors {tuple(logits.shape)}")
    logits, sizes, st = _chain_layout(logits, "backward")
    tape, g = tape.contiguous(), g.contiguous()
    adj = torch.empty_like(tape)
    dx = torch.empty((T,) + tuple(batch) + (S, S), dtype=logits.dtype, device=logits.device)
    err = _chain_lib().lc_backward(logits.data_ptr(), st, _ints(sizes), T, S, tape.data_ptr(), g.data_ptr(),
                                   adj.data_ptr(), dx.data_ptr(), _stream(logits))
    if err:
        raise RuntimeError(f"log_chain backward kernel failed to launch: CUDA error {err}")
    chain_launches["backward"] += 1
    return dx


# the launches looked up when called, so that a recording wrapper can stand in
_LogChainCUDA, _LogChainCUDABackward = _chain_functions(
    lambda logits: _chain_forward_cuda(logits), lambda *args: _chain_backward_cuda(*args), "cuda")


def log_chain(logits):
    """The ordered log-space product of a (T, ..., S, S) chain of factors,
    (..., S, S), in the halving association of K3: K3f on a CUDA tensor
    (float32, S <= 64; anything else raises), its plain version
    ``sequential_logmatmulexp_plain`` on a CPU tensor."""
    if logits.shape[0] == 1:
        return logits[0]
    if logits.is_cuda:
        return _LogChainCUDA.apply(logits)[0]
    return sequential_logmatmulexp_plain(logits)
