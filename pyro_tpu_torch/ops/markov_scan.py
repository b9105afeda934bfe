"""The Markov-chain scan that eliminates a vectorized Markov chain:

    h_t = alpha_t + L_t,   alpha_{t+1} = R_t + logmatmulexp(h_t, A),   t < T

over rows ``alpha_t`` (B, S), with ``A`` (S, S) shared by every row or
(B, S, S) one per row, and ``R``, ``L`` (T, B, S).  ``markov_scan`` returns
``alpha_T``.

Counterpart of the ``lax.scan(jax.checkpoint(step))`` of
``pyro_tpu/ops/markov_product.py::_try_scan_elimination``.  On CUDA tensors
the whole scan is one launch of the hand-written kernel of
``csrc/markov_scan.cu`` (its backward one more), behind a
``torch.autograd.Function``; on CPU tensors ``markov_scan_plain`` runs,
which loops ``logmatmulexp_plain`` steps.  A CUDA tensor never falls back
to the plain version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .log_matmul import logmatmulexp_plain

# Launches of the CUDA scan, counted by the wrapper; a forward launch runs
# two kernels (the exp'd transition, then the scan), a backward launch four
# (the reverse scan, the column maxima, the dA fold, its epilogue).
launches = {"forward": 0, "backward": 0}

# the backward kernel keeps 6 rows of S floats in a block's shared memory
MAX_STATES = 2048


def _check_shapes(alpha0, A, R, L):
    if alpha0.ndim != 2:
        raise ValueError(f"markov_scan: alpha0 must be (B, S), got {tuple(alpha0.shape)}")
    B, S = alpha0.shape
    if A.shape not in ((S, S), (B, S, S)):
        raise ValueError(f"markov_scan: A must be ({S}, {S}) or ({B}, {S}, {S}), got {tuple(A.shape)}")
    for name, x in (("R", R), ("L", L)):
        if x is not None and (x.ndim != 3 or x.shape[1:] != (B, S)):
            raise ValueError(f"markov_scan: {name} must be (T, {B}, {S}), got {tuple(x.shape)}")
    if L is not None and L.shape[0] != R.shape[0]:
        raise ValueError(f"markov_scan: R and L differ in length: {R.shape[0]} vs {L.shape[0]}")


def markov_scan_plain(alpha0, A, R, L=None):
    """The plain PyTorch version, on any device: one ``logmatmulexp_plain``
    per step, with its analytic VJP."""
    _check_shapes(alpha0, A, R, L)
    alpha = alpha0
    for t in range(R.shape[0]):
        h = alpha if L is None else alpha + L[t]
        if A.ndim == 2:
            z = logmatmulexp_plain(h, A)
        else:
            z = logmatmulexp_plain(h.unsqueeze(-2), A).squeeze(-2)
        alpha = z + R[t]
    return alpha


# -- CUDA kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_c = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("markov_scan")
    lib.ms_forward.argtypes = [_P, _P, _P, _P, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P, _P]
    lib.ms_forward.restype = ctypes.c_int
    lib.ms_backward.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _c, _c, _c, _c, _c] + [_P] * 10
    lib.ms_backward.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(*tensors):
    device = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise ValueError(f"markov_scan: operands must lie on one CUDA device, got {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"markov_scan: the CUDA kernel takes float32, got {t.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(alpha0, A, R, L=None):
    """alpha_T, and what the backward needs: the carry stack alpha_0 ..
    alpha_{T-1} (T, B, S), each step's z = exp(h - m) @ Q (T, B, S),
    Q = exp(A - c), its transpose, and the raw column maxima of A."""
    _check_shapes(alpha0, A, R, L)
    _check_cuda(alpha0, A, R, L)
    T = R.shape[0]
    B, S = alpha0.shape
    if T == 0 or B == 0 or S == 0 or S > MAX_STATES:
        raise ValueError(f"markov_scan: the kernel takes 1 <= T, 1 <= B and 1 <= S <= {MAX_STATES}, got {T, B, S}")
    nA = 1 if A.ndim == 2 else B
    alpha0, A, R = alpha0.contiguous(), A.contiguous(), R.contiguous()
    L = None if L is None else L.contiguous()
    alphas = torch.empty((T, B, S), dtype=alpha0.dtype, device=alpha0.device)
    zs = torch.empty_like(alphas)
    out = torch.empty((B, S), dtype=alpha0.dtype, device=alpha0.device)
    Q = torch.empty((nA, S, S), dtype=alpha0.dtype, device=alpha0.device)
    QT = torch.empty_like(Q)
    craw = torch.empty((nA, S), dtype=alpha0.dtype, device=alpha0.device)
    err = _lib().ms_forward(
        alpha0.data_ptr(), A.data_ptr(), R.data_ptr(), _ptr(L), B, T, S, nA,
        alphas.data_ptr(), zs.data_ptr(), out.data_ptr(), Q.data_ptr(), QT.data_ptr(), craw.data_ptr(),
        _stream(alpha0),
    )
    if err:
        raise RuntimeError(f"markov_scan forward kernels failed to launch: CUDA error {err}")
    launches["forward"] += 1
    return out, (alphas, zs, Q, QT, craw)


def _fold_splits(rows, tiles, nA, device):
    """Blocks of the dA fold per output tile: about two waves over the
    card's SMs, at least 64 rows each."""
    blocks = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-blocks // (tiles * nA)), -(-rows // 64)))


def _backward_cuda(A, L, saved, g):
    """dalpha0, dA, dR and dL (None without L) from dloss/dalpha_T."""
    alphas, zs, Q, QT, craw = saved
    _check_cuda(g, A, L, alphas, zs)
    T, B, S = alphas.shape
    if g.shape != (B, S):
        raise ValueError(f"markov_scan: gradient shape {tuple(g.shape)} != ({B}, {S})")
    nA = Q.shape[0]
    g = g.contiguous()
    A = A.contiguous()
    L = None if L is None else L.contiguous()
    tiles = (-(-S // 64)) ** 2
    rows = T if nA > 1 else T * B
    splits = _fold_splits(rows, tiles, nA, g.device)
    new = functools.partial(torch.empty, dtype=g.dtype, device=g.device)
    dalpha0, dR, dA = new((B, S)), new((T, B, S)), new((nA, S, S))
    dL = None if L is None else new((T, B, S))
    # the fold's two classes: entries whose z was clipped at FLT_MIN, and the rest
    P, W, Wc = new((T, B, S)), new((T, B, S)), new((T, B, S))
    cc, partial = new((2, nA, S)), new((2, splits, nA, S, S))
    err = _lib().ms_backward(
        A.data_ptr(), alphas.data_ptr(), zs.data_ptr(), _ptr(L), Q.data_ptr(), QT.data_ptr(), craw.data_ptr(),
        g.data_ptr(),
        B, T, S, nA, splits, dalpha0.data_ptr(), dR.data_ptr(), _ptr(dL), dA.data_ptr(),
        P.data_ptr(), W.data_ptr(), Wc.data_ptr(), cc.data_ptr(), partial.data_ptr(), _stream(g),
    )
    if err:
        raise RuntimeError(f"markov_scan backward kernels failed to launch: CUDA error {err}")
    launches["backward"] += 1
    return dalpha0, dA.reshape(A.shape), dR, dL


class _MarkovScanCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha0, A, R, L):
        out, saved = _forward_cuda(alpha0, A, R, L)
        ctx.save_for_backward(A, L, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        A, L, *saved = ctx.saved_tensors
        return _backward_cuda(A, L, saved, g)


def markov_scan(alpha0, A, R, L=None):
    """``alpha_T`` of the scan above, with its analytic backward.  CUDA
    tensors go through the hand-written kernels, CPU tensors through the
    plain version."""
    if any(t is not None and t.is_cuda for t in (alpha0, A, R, L)):
        return _MarkovScanCUDA.apply(alpha0, A, R, L)
    return markov_scan_plain(alpha0, A, R, L)
