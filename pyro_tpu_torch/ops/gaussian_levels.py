"""The halving levels of the information-form Gaussian algebra: K4a, K4b
and K4c, with the backward of K4a and K4b; and those of the gamma-Gaussian
algebra, K5a and K5b.

Each function has a plain PyTorch version beside it, the arithmetic of the
JAX package's level code (``pyro_tpu/ops/gaussian.py``), and a wrapper.  On
CUDA tensors the wrapper launches the hand-written kernels of
``csrc/gaussian_levels.cu`` (float32, state dim n <= 32); on CPU tensors
it runs the plain versions.  A CUDA tensor never reaches a plain version:
the kernel launches or the call raises.

- ``halving_level`` (K4a): one level of a time-homogeneous chain, every
  factor sharing one precision P (2n, 2n); info (R, 2m, 2n) and logZ
  (R, 2m) become (R, m, 2n) and (R, m), P becomes P', and the level's
  Cholesky factor L (n, n) and ``ib`` (R, m, n) are kept for the sampler.
  The kernel's CTAs walk tiles of pairs of one row; ``halving_plan`` sizes
  the grid from the tile and the CTAs an SM that the kernel reports.
- ``contract_pairs`` (K4b): adjacent pairs (2p, 2p + 1) of a chain whose
  precision varies, P (..., t, 2n, 2n), info (..., t, 2n), logZ (..., t)
  (any leading batch dims, R rows in all), to (..., ceil(t / 2), ...), an
  odd level's last factor carried through; with ``tape``, each pair's L
  (n, n), P_mk (n, 2n) and i_m (n) for the descent.  The kernel reads its
  operands where they lie, by their strides (``row_layout``): a precision
  expanded over rows or time (stride 0) is never copied.
- ``level_mids`` (K4c): a level's midpoint draws, the points (D, R, m, n)
  to (D, R, m + Np, n) with the mids in their interleaved places.  The
  kernel's CTAs walk tiles of pairs of one row, all draws at once;
  ``mids_plan`` sizes the grid from the tile and the CTAs an SM that the
  kernel reports.
- ``gamma_halving_level`` (K5a) and ``gamma_contract_pairs`` (K5b): K4a's
  and K4b's levels of the gamma-Gaussian algebra (``ops/gamma_gaussian.py``,
  the counterpart of ``pyro_tpu/ops/gamma_gaussian.py``), which carry per
  factor a shape ``alpha`` and a rate ``beta`` (R, t) beside logZ:
  alpha' = alpha_1 + alpha_2 - n/2, beta' = beta_1 + beta_2 - |s|^2 / 2 with
  s the level's L^-1 ib (K5a) or L^-1 i_m (K5b), and logZ' without the
  |s|^2 / 2 that K4 adds.  They keep no tape.

Training: ``halving_level`` and ``contract_pairs`` each run through one
``torch.autograd.Function`` on every device, whose backward is the plain
adjoint (``halving_level_bwd_plain``, ``contract_pairs_bwd_plain``, written
out, not autograd) on the CPU and the backward kernels on the card, one
launch a level each.  K4a's backward CTAs walk tiles of pairs and write partial
sums of the adjoints of the shared Kt and L; the last CTA to finish adds
them in a fixed order and carries the shared factorisation back to P
(``halving_bwd_plan`` sizes the grid, the order of the sums and their
buffer).  K4b's backward runs a warp a pair (``contract_bwd_plan`` sizes
its grid).  The forward keeps the tape (K4a's L and ib, K4b's L, P_mk and
i_m) when a gradient is wanted and the backward recomputes the rest from
it.  The taped outputs are not differentiated: a gradient that reaches one
of them raises (their adjoint runs through K4c's backward, ROADMAP.md
Queue 2).
K4c's backward raises on the card, as does K5a's and K5b's (no path of the
JAX package trains a gamma-Gaussian model yet: ROADMAP.md Queue 2); on the
CPU the K5 plain versions differentiate through autograd.

The gradient of a precision P is returned symmetrised: the forward reads
one triangle of each symmetric block (``P[:n, n:]``, never ``P[n:, :n]``),
and both the plain backward and the kernels return (g + g^T) / 2 of that
read's gradient, which gives every symmetric perturbation of P the same
derivative.  Compare P gradients in symmetrised form, or end to end on the
parameters P is built from.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build, func_rules, linalg_small
from .func_rules import logical_ndim

# Launches of the K4 and K5 kernels, counted by the wrappers.
launches = {"halving": 0, "contract": 0, "mids": 0, "halving_bwd": 0, "contract_bwd": 0, "gamma_halving": 0,
            "gamma_contract": 0}
MAX_DIM = 32  # the largest state dim n the kernels take (NMAX of the source)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def reset_counts():
    """Set every launch count to 0."""
    launches.update(dict.fromkeys(launches, 0))


# -- plain versions -----------------------------------------------------------------


def _halving_core(P, info):
    """A homogeneous level's shared and per-pair work: ``(P', info', L, ib, s)``."""
    n = P.shape[-1] // 2
    A, B, D = P[:n, :n], P[:n, n:], P[n:, n:]
    L = linalg_small.cholesky(D + A)
    C = torch.cat([B, B.T], dim=0)  # the coupling (a, c) <- b, (2n, n)
    Kt = linalg_small.solve_lower(L, C.T)  # (n, 2n)
    P_new = torch.block_diag(A, D) - Kt.T @ Kt
    i1, i2 = info[..., 0::2, :], info[..., 1::2, :]
    ib = i1[..., n:] + i2[..., :n]
    s = linalg_small.solve_lower(L, ib.reshape(-1, n).T).T.reshape(ib.shape)
    outer = torch.cat([i1[..., :n], i2[..., n:]], dim=-1)
    return P_new, outer - s @ Kt, L, ib, s


def _pair_sum(x):
    """Each pair (2p, 2p + 1) of the last axis summed; an odd last is left out."""
    e = x.shape[-1] // 2 * 2
    return x[..., 0:e:2] + x[..., 1:e:2]


def halving_level_plain(P, info, logZ, tape=False):
    """K4a's plain version: ``(P', info', logZ', L, ib or None)``."""
    n = P.shape[-1] // 2
    P_new, info_new, L, ib, s = _halving_core(P, info)
    logZ_new = _pair_sum(logZ) + n * _HALF_LOG_2PI - torch.log(torch.diagonal(L)).sum() + 0.5 * (s * s).sum(-1)
    return P_new, info_new, logZ_new, L, ib if tape else None


def gamma_halving_level_plain(P, info, logZ, alpha, beta):
    """K5a's plain version: ``(P', info', logZ', alpha', beta')``."""
    n = P.shape[-1] // 2
    P_new, info_new, L, _, s = _halving_core(P, info)
    logZ_new = _pair_sum(logZ) + n * _HALF_LOG_2PI - torch.log(torch.diagonal(L)).sum()
    return P_new, info_new, logZ_new, _pair_sum(alpha) - 0.5 * n, _pair_sum(beta) - 0.5 * (s * s).sum(-1)


def _pair_blocks(P, info, n):
    """The pairs' blocks: P_mm, P_mk = [Px[l, m]^T | Py[m, r]], i_m, i_k and
    the blocks of P_kk."""
    e = P.shape[-3] // 2 * 2
    Px, Py = P[..., 0:e:2, :, :], P[..., 1:e:2, :, :]
    ix, iy = info[..., 0:e:2, :], info[..., 1:e:2, :]
    P_mm = Px[..., n:, n:] + Py[..., :n, :n]
    P_mk = torch.cat([Px[..., :n, n:].transpose(-1, -2), Py[..., :n, n:]], dim=-1)
    i_m = ix[..., n:] + iy[..., :n]
    i_k = torch.cat([ix[..., :n], iy[..., n:]], dim=-1)
    return P_mm, P_mk, i_m, i_k, Px[..., :n, :n], Py[..., n:, n:]


def _contract_core(P, info):
    """The pairs' contraction: ``(P', info', L, P_mk, i_m, L^-1 i_m)`` over the
    t // 2 pairs."""
    n = P.shape[-1] // 2
    P_mm, P_mk, i_m, i_k, P_ll, P_rr = _pair_blocks(P, info, n)
    L = linalg_small.cholesky(P_mm)
    X = linalg_small.solve_lower(L, torch.cat([P_mk, i_m.unsqueeze(-1)], dim=-1))
    LinvPmk, Linvim = X[..., :-1], X[..., -1]
    P_kk = torch.cat([
        torch.cat([P_ll, torch.zeros_like(P_ll)], dim=-1),
        torch.cat([torch.zeros_like(P_rr), P_rr], dim=-1),
    ], dim=-2)
    P_new = P_kk - LinvPmk.transpose(-1, -2) @ LinvPmk
    info_new = i_k - (LinvPmk.transpose(-1, -2) @ Linvim.unsqueeze(-1)).squeeze(-1)
    return P_new, info_new, L, P_mk, i_m, Linvim


def _carry_odd(t, new, old):
    """An odd level's last factor of each of ``old`` (batch (..., t))
    appended to ``new``; ``new`` and ``old`` are lists of (P, info, then
    (..., t) rows)."""
    if t % 2 == 0:
        return new
    k = old[-1].ndim - 1  # the time dim: after the leading batch dims
    return [torch.cat([a, b.narrow(k, t - 1, 1)], dim=k) for a, b in zip(new, old)]


def _log_diag_sum(L):
    """sum log diag L over the last two dims: half the log determinant of L L^T."""
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def contract_pairs_plain(P, info, logZ, tape=False):
    """K4b's plain version: ``(P', info', logZ', (L, P_mk, i_m) or None)``."""
    n = P.shape[-1] // 2
    P_new, info_new, L, P_mk, i_m, Linvim = _contract_core(P, info)
    logZ_new = _pair_sum(logZ) + n * _HALF_LOG_2PI - _log_diag_sum(L) + 0.5 * (Linvim**2).sum(-1)
    P_new, info_new, logZ_new = _carry_odd(P.shape[-3], [P_new, info_new, logZ_new], [P, info, logZ])
    return P_new, info_new, logZ_new, (L, P_mk, i_m) if tape else None


def gamma_contract_pairs_plain(P, info, logZ, alpha, beta):
    """K5b's plain version: ``(P', info', logZ', alpha', beta')``."""
    n = P.shape[-1] // 2
    P_new, info_new, L, _, _, Linvim = _contract_core(P, info)
    logZ_new = _pair_sum(logZ) + n * _HALF_LOG_2PI - _log_diag_sum(L)
    new = [P_new, info_new, logZ_new, _pair_sum(alpha) - 0.5 * n, _pair_sum(beta) - 0.5 * (Linvim**2).sum(-1)]
    return tuple(_carry_odd(P.shape[-3], new, [P, info, logZ, alpha, beta]))


def level_mids_plain(cur, L, P_mk, i_m, eps):
    """K4c's plain version: the next level's points (D, R, m + Np, n)."""
    Np = i_m.shape[-2]
    left, right = cur[..., :Np, :], cur[..., 1:Np + 1, :]
    cond = torch.cat([left, right], dim=-1)
    info_c = i_m - (P_mk @ cond.unsqueeze(-1)).squeeze(-1)
    y = linalg_small.solve_lower(L, info_c.unsqueeze(-1)) + eps.unsqueeze(-1)
    mids = linalg_small.solve_lower_t(L, y).squeeze(-1)
    pairs = torch.stack([left, mids], dim=-2).reshape(mids.shape[:-2] + (2 * Np, mids.shape[-1]))
    return torch.cat([pairs, cur[..., Np:, :]], dim=-2)


def _sym(g):
    return 0.5 * (g + g.transpose(-1, -2))


def _cholesky_adjoint(L, gL):
    """The symmetric gradient of A given that of its factor L = chol(A):
    L^-T S L^-1, S the symmetric matrix of the lower triangle of L^T gL
    with every entry halved."""
    M = torch.tril(L.transpose(-1, -2) @ gL)
    S = 0.5 * (M + torch.tril(M, -1).transpose(-1, -2))
    Y = linalg_small.solve_lower_t(L, S)
    return _sym(linalg_small.solve_lower_t(L, Y.transpose(-1, -2)))


def _or_zeros(g, shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device) if g is None else g


def halving_level_bwd_plain(P, L, ib, g_P, g_info, g_logZ):
    """K4a's backward, plain: the gradients of P (symmetrised), info and
    logZ from those of P', info' and logZ' (any of them None for zero),
    recomputing Kt and s from P and the tape (L, ib)."""
    n = P.shape[-1] // 2
    R, m, _ = ib.shape
    g_P = _or_zeros(g_P, P.shape, P)
    gi = _or_zeros(g_info, (R, m, 2 * n), P).reshape(-1, 2 * n).T  # (2n, R m)
    gz = _or_zeros(g_logZ, (R, m), P).reshape(-1)
    B = P[:n, n:]
    Kt = linalg_small.solve_lower(L, torch.cat([B.T, B], dim=1))  # (n, 2n)
    s = linalg_small.solve_lower(L, ib.reshape(-1, n).T)  # (n, R m)
    g_ib = linalg_small.solve_lower_t(L, gz * s - Kt @ gi)  # (n, R m)
    gi_r, g_ib_r = gi.T.reshape(R, m, 2 * n), g_ib.T.reshape(R, m, n)
    g1 = torch.cat([gi_r[..., :n], g_ib_r], dim=-1)
    g2 = torch.cat([g_ib_r, gi_r[..., n:]], dim=-1)
    g_info_in = torch.stack([g1, g2], dim=-2).reshape(R, 2 * m, 2 * n)
    g_logZ_in = gz.reshape(R, m, 1).expand(R, m, 2).reshape(R, 2 * m)
    # the shared part: P' = diag(A, D) - Kt^T Kt, Kt = L^-1 [B^T | B], L = chol(D + A)
    G = g_P + g_P.T
    gKt = -s @ gi.T - Kt @ G
    gCt = linalg_small.solve_lower_t(L, gKt)
    gL = -torch.tril(g_ib @ s.T + gCt @ Kt.T) - torch.diag(gz.sum() / torch.diagonal(L))
    gJ = _cholesky_adjoint(L, gL)
    gB = 0.5 * (gCt[:, :n].T + gCt[:, n:])
    g_P_in = torch.cat([
        torch.cat([0.5 * G[:n, :n] + gJ, gB], dim=1),
        torch.cat([gB.T, 0.5 * G[n:, n:] + gJ], dim=1),
    ], dim=0)
    return g_P_in, g_info_in, g_logZ_in


def contract_pairs_bwd_plain(t, L, P_mk, i_m, g_P, g_info, g_logZ):
    """K4b's backward, plain: the gradients of P (R, t, 2n, 2n)
    (symmetrised), info and logZ from those of P', info' and logZ' (any of
    them None for zero), recomputing X = L^-1 [P_mk | i_m] from the tape."""
    R, np_, n, _ = L.shape
    t_out, e = t - np_, 2 * np_
    g_P = _or_zeros(g_P, (R, t_out, 2 * n, 2 * n), L)
    g_info = _or_zeros(g_info, (R, t_out, 2 * n), L)
    g_logZ = _or_zeros(g_logZ, (R, t_out), L)
    X = linalg_small.solve_lower(L, torch.cat([P_mk, i_m.unsqueeze(-1)], dim=-1))
    X1, x2 = X[..., :-1], X[..., -1]
    G = g_P[:, :np_] + g_P[:, :np_].transpose(-1, -2)
    gi, gz = g_info[:, :np_], g_logZ[:, :np_]
    gX1 = -X1 @ G - x2.unsqueeze(-1) * gi.unsqueeze(-2)
    gx2 = -(X1 @ gi.unsqueeze(-1)).squeeze(-1) + gz.unsqueeze(-1) * x2
    gB = linalg_small.solve_lower_t(L, torch.cat([gX1, gx2.unsqueeze(-1)], dim=-1))
    gL = -torch.tril(gB @ X.transpose(-1, -2)) - torch.diag_embed(gz.unsqueeze(-1) / torch.diagonal(L, dim1=-2, dim2=-1))
    gPmm = _cholesky_adjoint(L, gL)
    gl, gr, gim = 0.5 * gB[..., :n], 0.5 * gB[..., n:-1], gB[..., -1]
    gPx = torch.cat([
        torch.cat([0.5 * G[..., :n, :n], gl.transpose(-1, -2)], dim=-1),
        torch.cat([gl, gPmm], dim=-1),
    ], dim=-2)
    gPy = torch.cat([
        torch.cat([gPmm, gr], dim=-1),
        torch.cat([gr.transpose(-1, -2), 0.5 * G[..., n:, n:]], dim=-1),
    ], dim=-2)
    g_P_in = torch.stack([gPx, gPy], dim=2).reshape(R, e, 2 * n, 2 * n)
    g_info_in = torch.stack([
        torch.cat([gi[..., :n], gim], dim=-1), torch.cat([gim, gi[..., n:]], dim=-1),
    ], dim=2).reshape(R, e, 2 * n)
    g_logZ_in = gz.unsqueeze(-1).expand(R, np_, 2).reshape(R, e)
    if t > e:  # the odd level's last factor passes its gradient through
        g_P_in = torch.cat([g_P_in, _sym(g_P[:, -1:])], dim=1)
        g_info_in = torch.cat([g_info_in, g_info[:, -1:]], dim=1)
        g_logZ_in = torch.cat([g_logZ_in, g_logZ[:, -1:]], dim=1)
    return g_P_in, g_info_in, g_logZ_in


# -- CUDA kernels ---------------------------------------------------------------------

_P = ctypes.c_void_p
_c = ctypes.c_int
_ll = ctypes.c_longlong
_LAYOUT = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _lib():
    lib = cuda_build.load("gaussian_levels")
    lib.gl_halving.argtypes = [_P, _P, _ll, _P, _ll, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P]
    lib.gl_contract.argtypes = [_P, _P, _P, _LAYOUT, _c, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P, _P]
    lib.gl_mids.argtypes = [_P, _c, _P, _ll, _P, _ll, _P, _P, _c, _c, _c, _c, _c, _P, _P]
    lib.gl_mids_shape.argtypes = [_c, _c, ctypes.POINTER(_c), ctypes.POINTER(_c)]
    lib.gl_halving_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _c, _c, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P, _P]
    lib.gl_halving_bwd_shape.argtypes = [ctypes.POINTER(_c)] * 3
    lib.gl_contract_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _c, _c, _c, _c, _c, _P, _P, _P, _P]
    lib.gl_contract_bwd_shape.argtypes = [_c, ctypes.POINTER(_c), ctypes.POINTER(_c)]
    lib.gl_gamma_halving.argtypes = [_P, _P, _ll, _P, _ll, _P, _ll, _P, _ll, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P,
                                     _P]
    lib.gl_gamma_contract.argtypes = [_P, _P, _P, _P, _P, _LAYOUT, _c, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P]
    lib.gl_contract_ctas_per_sm.argtypes = [_c, _c, ctypes.POINTER(_c)]
    lib.gl_halving_shape.argtypes = [_c, ctypes.POINTER(_c), ctypes.POINTER(_c)]
    for fn in (lib.gl_halving, lib.gl_contract, lib.gl_mids, lib.gl_halving_bwd, lib.gl_contract_bwd,
               lib.gl_gamma_halving, lib.gl_gamma_contract, lib.gl_contract_ctas_per_sm,
               lib.gl_halving_bwd_shape, lib.gl_halving_shape, lib.gl_mids_shape,
               lib.gl_contract_bwd_shape):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _contract_ctas_per_sm(n, gamma):
    """The CTAs of K4b (K5b with ``gamma``) at state dim n that one SM runs
    at once: the persistent grid's width an SM."""
    ctas = ctypes.c_int(0)
    _raise_on(_lib().gl_contract_ctas_per_sm(n, int(gamma), ctypes.byref(ctas)), "contract_pairs occupancy")
    if ctas.value < 1:
        raise RuntimeError(f"contract_pairs: no CTA at n={n} fits an SM")
    return ctas.value


def _check_cuda(name, n, *tensors):
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: operands must lie on one CUDA device, got {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if not 1 <= n <= MAX_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes a state dim 1 <= n <= {MAX_DIM}, got {n}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def _rows(t, inner):
    """``t`` (R, ...) as rows the kernel indexes with one stride: the row
    stride, with the inner dims contiguous (copied if not)."""
    if t.stride(0) == 0 or not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0) if t.shape[0] > 1 else inner


class HalvingShape(NamedTuple):
    """What a tiled kernel fixes (K4a's and K5a's, K4c's, K4b backward's):
    the pairs of a ``tile`` (one row's; K4b backward's, those a CTA holds),
    and the CTAs an SM runs at once at its shared memory and registers
    (``ctas_per_sm``)."""

    tile: int
    ctas_per_sm: int


@functools.cache
def _tile_shape(entry, *args):
    """A kernel's ``HalvingShape`` as its C entry ``entry`` reports it, called
    with ``args`` (the instantiation's: gamma, n, shared)."""
    tile, ctas = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(getattr(_lib(), entry)(*args, ctypes.byref(tile), ctypes.byref(ctas)), entry)
    if ctas.value < 1:
        raise RuntimeError(f"{entry}{args}: no CTA fits an SM")
    return HalvingShape(tile.value, ctas.value)


class HalvingPlan(NamedTuple):
    """How K4a or K5a launches at one level: ``tiles`` of pairs (each of one
    row) walked by ``blocks`` CTAs."""

    tiles: int
    blocks: int


def halving_plan(R, m, sms, shape):
    """K4a's or K5a's launch at a level of R rows of m pairs on a card of
    ``sms`` SMs, for a kernel of ``shape`` (a ``HalvingShape``): at most one
    CTA a tile and ``shape.ctas_per_sm`` an SM."""
    tiles = R * -(-m // shape.tile)
    return HalvingPlan(tiles, max(1, min(tiles, shape.ctas_per_sm * sms)))


def _halving_cuda(P, info, logZ, tape):
    R, two_m, n2 = info.shape
    n, m = n2 // 2, two_m // 2
    _check_cuda("halving_level", n, P, info, logZ)
    P = P.contiguous()
    info, info_rs = _rows(info, two_m * n2)
    logZ, logZ_rs = _rows(logZ, two_m)
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    P_out, L_out, info_out, logZ_out = new((n2, n2)), new((n, n)), new((R, m, n2)), new((R, m))
    ib = new((R, m, n)) if tape else None
    blocks = halving_plan(R, m, _sms(P.device), _tile_shape("gl_halving_shape", 0)).blocks
    err = _lib().gl_halving(
        P.data_ptr(), info.data_ptr(), info_rs, logZ.data_ptr(), logZ_rs, R, m, n, blocks,
        P_out.data_ptr(), L_out.data_ptr(), info_out.data_ptr(), logZ_out.data_ptr(),
        None if ib is None else ib.data_ptr(), _stream(P),
    )
    _raise_on(err, "halving_level")
    launches["halving"] += 1
    return P_out, info_out, logZ_out, L_out, ib


def _group_stride(sizes, strides):
    """The one stride that walks dims ``sizes`` (with ``strides``) in
    row-major order, 0 if they hold one element, None if there is none."""
    stride = expected = None
    for size, st in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if expected is not None and st != expected:
            return None
        if stride is None:
            stride = st
        expected = st * size
    return 0 if stride is None else stride


def row_layout(lead, specs):
    """How K4b and K5b read their operands in place.

    ``lead`` is the shape of the batch dims before time, shared by the
    operands; ``specs`` has one ``(strides, in_place, align)`` an operand:
    its strides over ``lead`` and time (elements), whether its inner dims
    are contiguous (and its base aligned as the kernel needs), and the
    multiple of elements its strides must be.  The kernel finds element
    (r, p), r the row-major index over ``lead``, at
    ``(r // R_lo) * hi + (r % R_lo) * lo + p * ts``; the lead dims split
    into an outer and an inner group, each walked with one stride (a
    broadcast dim has stride 0).  Returns ``R_lo`` and one ``(hi, lo, ts)``
    an operand, None for one that must be copied contiguous first; the
    split taken is the first that copies fewest operands."""
    k = len(lead)
    best = None
    for j in range(k + 1):
        plan = []
        for strides, in_place, align in specs:
            hi, lo = _group_stride(lead[:j], strides[:j]), _group_stride(lead[j:], strides[j:k])
            ts = strides[k]
            ok = in_place and hi is not None and lo is not None and all(x % align == 0 for x in (hi, lo, ts))
            plan.append((hi, lo, ts) if ok else None)
        copies = sum(x is None for x in plan)
        if best is None or copies < best[0]:
            best = (copies, math.prod(lead[j:]), plan)
    return best[1], best[2]


_P_ALIGN = 4  # P's blocks come by bulk copy: 16-byte aligned (4 floats)


def _kernel_operands(lead, operands):
    """The operands of a K4b or K5b launch, each ``(x, inner dims)`` with
    ``x`` (*lead, t, *inner): P first, read by bulk copy.  Returns the
    tensors (copied contiguous where ``row_layout`` asks) and the layout
    array the kernel takes: R_lo, then hi, lo, ts an operand."""
    specs = []
    for i, (x, inner) in enumerate(operands):
        dense = all(x.stride(d) == math.prod(x.shape[d + 1:]) for d in range(x.ndim - inner, x.ndim))
        align = _P_ALIGN if i == 0 else 1
        specs.append((x.stride()[:len(lead) + 1], dense and x.data_ptr() % (4 * align) == 0, align))
    R_lo, plan = row_layout(tuple(lead), specs)
    tensors, layout = [], [R_lo]
    for (x, inner), strides in zip(operands, plan):
        if strides is None:
            x = x.clone(memory_format=torch.contiguous_format)  # a copy even of a dense misaligned one
            m, t = math.prod(x.shape[x.ndim - inner:]), x.shape[len(lead)]
            strides = (R_lo * t * m, t * m, m)
        tensors.append(x)
        layout += strides
    return tensors, (ctypes.c_longlong * len(layout))(*layout)


def _contract_blocks(R, np_, n, gamma, device):
    """The persistent grid: as many CTAs as the card runs at once, at most
    one a pair."""
    return max(1, min(R * np_, _contract_ctas_per_sm(n, gamma) * _sms(device)))


def _contract_cuda(P, info, logZ, tape):
    *lead, t, n2, _ = P.shape
    n, np_ = n2 // 2, t // 2
    _check_cuda("contract_pairs", n, P, info, logZ)
    R, t_out = math.prod(lead), t - np_
    (Pk, infok, logZk), layout = _kernel_operands(lead, [(P, 2), (info, 1), (logZ, 0)])
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    P_out, info_out, logZ_out = new((*lead, t_out, n2, n2)), new((*lead, t_out, n2)), new((*lead, t_out))
    L = Pmk = im = None
    if tape:
        L, Pmk, im = new((*lead, np_, n, n)), new((*lead, np_, n, n2)), new((*lead, np_, n))
    err = _lib().gl_contract(
        Pk.data_ptr(), infok.data_ptr(), logZk.data_ptr(), layout, R, t, n, t_out,
        _contract_blocks(R, np_, n, False, P.device), P_out.data_ptr(), info_out.data_ptr(), logZ_out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (L, Pmk, im)), _stream(P),
    )
    _raise_on(err, "contract_pairs")
    launches["contract"] += 1
    if t > 2 * np_:  # the odd level's last factor, carried through
        for out, x in zip((P_out, info_out, logZ_out), (P, info, logZ)):
            out.select(len(lead), -1).copy_(x.select(len(lead), -1))
    return P_out, info_out, logZ_out, (L, Pmk, im) if tape else None


def _gamma_halving_cuda(P, info, logZ, alpha, beta):
    R, two_m, n2 = info.shape
    n, m = n2 // 2, two_m // 2
    _check_cuda("gamma_halving_level", n, P, info, logZ, alpha, beta)
    P = P.contiguous()
    info, info_rs = _rows(info, two_m * n2)
    (logZ, logZ_rs), (alpha, alpha_rs), (beta, beta_rs) = (_rows(x, two_m) for x in (logZ, alpha, beta))
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    P_out, L_out, info_out = new((n2, n2)), new((n, n)), new((R, m, n2))
    logZ_out, alpha_out, beta_out = new((R, m)), new((R, m)), new((R, m))
    blocks = halving_plan(R, m, _sms(P.device), _tile_shape("gl_halving_shape", 1)).blocks
    err = _lib().gl_gamma_halving(
        P.data_ptr(), info.data_ptr(), info_rs, logZ.data_ptr(), logZ_rs, alpha.data_ptr(), alpha_rs,
        beta.data_ptr(), beta_rs, R, m, n, blocks, P_out.data_ptr(), L_out.data_ptr(), info_out.data_ptr(),
        logZ_out.data_ptr(), alpha_out.data_ptr(), beta_out.data_ptr(), _stream(P),
    )
    _raise_on(err, "gamma_halving_level")
    launches["gamma_halving"] += 1
    return P_out, info_out, logZ_out, alpha_out, beta_out


def _gamma_contract_cuda(P, info, logZ, alpha, beta):
    *lead, t, n2, _ = P.shape
    n, np_ = n2 // 2, t // 2
    _check_cuda("gamma_contract_pairs", n, P, info, logZ, alpha, beta)
    R, t_out = math.prod(lead), t - np_
    ins = (P, info, logZ, alpha, beta)
    kin, layout = _kernel_operands(lead, list(zip(ins, (2, 1, 0, 0, 0))))
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    P_out, info_out = new((*lead, t_out, n2, n2)), new((*lead, t_out, n2))
    logZ_out, alpha_out, beta_out = new((*lead, t_out)), new((*lead, t_out)), new((*lead, t_out))
    outs = (P_out, info_out, logZ_out, alpha_out, beta_out)
    err = _lib().gl_gamma_contract(
        *(x.data_ptr() for x in kin), layout, R, t, n, t_out, _contract_blocks(R, np_, n, True, P.device),
        *(x.data_ptr() for x in outs), _stream(P),
    )
    _raise_on(err, "gamma_contract_pairs")
    launches["gamma_contract"] += 1
    if t > 2 * np_:  # the odd level's last factor, carried through
        for out, x in zip(outs, ins):
            out.select(len(lead), -1).copy_(x.select(len(lead), -1))
    return outs


def mids_plan(R, Np, sms, shape):
    """K4c's launch at a level of R rows of Np pairs on a card of ``sms``
    SMs, for a kernel of ``shape`` (its tile of pairs, shared or per pair,
    and its CTAs an SM, as ``gl_mids_shape`` reports them): at most one CTA
    a tile and ``shape.ctas_per_sm`` an SM, as ``halving_plan``."""
    return halving_plan(R, Np, sms, shape)


def _mids_cuda(cur, L, P_mk, i_m, eps):
    D, R, m, n = cur.shape
    Np = i_m.shape[-2]
    _check_cuda("level_mids", n, cur, L, P_mk, i_m, eps)
    if not 1 <= Np < m:
        raise ValueError(f"level_mids: {Np} pairs of {m} points")
    shared = L.ndim == 2
    if shared != (P_mk.ndim == 2):
        raise ValueError("level_mids: L and P_mk are shared or per pair together")
    cur, eps, i_m = cur.contiguous(), eps.contiguous(), i_m.expand(R, Np, n).contiguous()
    L = L.contiguous() if shared else L.expand(R, Np, n, n).contiguous()
    P_mk = P_mk.contiguous() if shared else P_mk.expand(R, Np, n, 2 * n).contiguous()
    out = torch.empty((D, R, m + Np, n), dtype=cur.dtype, device=cur.device)
    blocks = mids_plan(R, Np, _sms(cur.device), _tile_shape("gl_mids_shape", n, int(shared))).blocks
    err = _lib().gl_mids(
        cur.data_ptr(), m, L.data_ptr(), 0 if shared else n * n, P_mk.data_ptr(), 0 if shared else 2 * n * n,
        i_m.data_ptr(), eps.data_ptr(), D, R, Np, n, blocks, out.data_ptr(), _stream(cur),
    )
    _raise_on(err, "level_mids")
    launches["mids"] += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _grads(*grads):
    """The upstream gradients, contiguous; None (zero) stays None."""
    return [None if g is None else g.contiguous() for g in grads]


class HalvingBwdShape(NamedTuple):
    """What K4a's backward kernel fixes when it is compiled: the pairs of a
    ``tile``, the floats of a CTA's ``partial`` sum, and the ``ctas_per_sm``
    of its launch bound."""

    tile: int
    partial: int
    ctas_per_sm: int


@functools.cache
def _halving_bwd_shape():
    tile, partial, ctas = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(_lib().gl_halving_bwd_shape(ctypes.byref(tile), ctypes.byref(partial), ctypes.byref(ctas)),
              "halving_level backward shape")
    return HalvingBwdShape(tile.value, partial.value, ctas.value)


class HalvingBwdPlan(NamedTuple):
    """How K4a's backward launches at one level: ``tiles`` of pairs walked
    by ``blocks`` CTAs; the CTAs' partial sums added by groups of ``group``
    CTAs in block order (``groups`` of them), then the groups' in order.
    One buffer of ``scratch`` floats holds the partials from 0, the groups'
    sums (where there is more than one group) from ``sums_at`` and the
    ``groups + 1`` int counters of the tickets from ``counters_at``; one
    CTA needs none of them (all three 0)."""

    tiles: int
    blocks: int
    group: int
    groups: int
    sums_at: int
    counters_at: int
    scratch: int


def halving_bwd_plan(pairs, sms, shape):
    """K4a backward's launch at a level of ``pairs`` pairs on a card of
    ``sms`` SMs, for a kernel of ``shape`` (a ``HalvingBwdShape``): at most
    one CTA a tile and ``shape.ctas_per_sm`` an SM; groups of about
    sqrt(blocks) CTAs, at least 16, so that the CTA that sums a group's
    partials and the one that sums the groups' each read few."""
    tiles = -(-pairs // shape.tile)
    blocks = max(1, min(tiles, shape.ctas_per_sm * sms))
    group = max(16, math.isqrt(blocks - 1) + 1)
    groups = -(-blocks // group)
    if blocks == 1:
        return HalvingBwdPlan(tiles, blocks, group, groups, 0, 0, 0)
    sums_at = blocks * shape.partial
    counters_at = sums_at + (groups * shape.partial if groups > 1 else 0)
    return HalvingBwdPlan(tiles, blocks, group, groups, sums_at, counters_at, counters_at + groups + 1)


def _halving_bwd_cuda(P, L, ib, g_P, g_info, g_logZ):
    R, m, n = ib.shape
    n2 = 2 * n
    g_P, g_info, g_logZ = _grads(g_P, g_info, g_logZ)
    _check_cuda("halving_level backward", n, P, L, ib, *(g for g in (g_P, g_info, g_logZ) if g is not None))
    P, L, ib = P.contiguous(), L.contiguous(), ib.contiguous()
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    plan = halving_bwd_plan(R * m, _sms(P.device), _halving_bwd_shape())
    parts = sums = counters = None
    if plan.scratch:  # this call's own buffer: no two launches share partials or counters
        scratch = new((plan.scratch,))
        parts, counters = scratch.data_ptr(), scratch[plan.counters_at:].data_ptr()
        if plan.groups > 1:
            sums = scratch[plan.sums_at:].data_ptr()
    gP, g_info_in, g_logZ_in = new((n2, n2)), new((R, 2 * m, n2)), new((R, 2 * m))
    err = _lib().gl_halving_bwd(
        P.data_ptr(), L.data_ptr(), ib.data_ptr(), _ptr(g_P), _ptr(g_info), _ptr(g_logZ), R, m, n, plan.blocks,
        plan.group, plan.groups, parts, sums, counters, gP.data_ptr(), g_info_in.data_ptr(), g_logZ_in.data_ptr(),
        _stream(P),
    )
    _raise_on(err, "halving_level backward")
    launches["halving_bwd"] += 1
    return gP, g_info_in, g_logZ_in


def contract_bwd_plan(items, sms, shape):
    """K4b backward's launch at a level of ``items`` outputs (pairs, and an
    odd level's last factors) on a card of ``sms`` SMs, for a kernel of
    ``shape`` (its ``tile``: the pairs a CTA holds, a warp each; its CTAs an
    SM, as ``gl_contract_bwd_shape`` reports them): as ``halving_plan`` over
    one row of ``items``."""
    return halving_plan(1, items, sms, shape)


def _contract_bwd_cuda(t, L, P_mk, i_m, g_P, g_info, g_logZ):
    R, np_, n, _ = L.shape
    n2, t_out = 2 * n, t - np_
    g_P, g_info, g_logZ = _grads(g_P, g_info, g_logZ)
    _check_cuda("contract_pairs backward", n, L, P_mk, i_m, *(g for g in (g_P, g_info, g_logZ) if g is not None))
    L, P_mk, i_m = L.contiguous(), P_mk.contiguous(), i_m.contiguous()
    new = functools.partial(torch.empty, dtype=L.dtype, device=L.device)
    gP, g_info_in, g_logZ_in = new((R, t, n2, n2)), new((R, t, n2)), new((R, t))
    blocks = contract_bwd_plan(R * t_out, _sms(L.device), _tile_shape("gl_contract_bwd_shape", n)).blocks
    err = _lib().gl_contract_bwd(
        L.data_ptr(), P_mk.data_ptr(), i_m.data_ptr(), _ptr(g_P), _ptr(g_info), _ptr(g_logZ), R, t, n, t_out,
        blocks, gP.data_ptr(), g_info_in.data_ptr(), g_logZ_in.data_ptr(), _stream(L),
    )
    _raise_on(err, "contract_pairs backward")
    launches["contract_bwd"] += 1
    return gP, g_info_in, g_logZ_in


def _taped_not_differentiated(name, *grads):
    if any(g is not None for g in grads):
        raise NotImplementedError(
            f"{name}: a gradient reached the level's tape (its Cholesky factor and the pair "
            "blocks kept for the sampler); differentiating through it is K4c's backward, "
            "ROADMAP.md Queue 2"
        )


def _no_second_derivative(name):
    raise NotImplementedError(f"{name}: no second derivative")


class _HalvingBackward(torch.autograd.Function):
    """K4a's backward, as a Function whose vmap rule runs it once an
    example: the shared P's gradient is a sum over every row of a level, so
    the examples' rows cannot share one launch."""

    @staticmethod
    def forward(P, L, ib, g_P, g_info, g_logZ, cuda):
        return (_halving_bwd_cuda if cuda else halving_level_bwd_plain)(P, L, ib, g_P, g_info, g_logZ)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        _no_second_derivative("halving_level")

    @staticmethod
    def vmap(info, in_dims, *args):
        return func_rules.loop(_HalvingBackward.apply, info, in_dims, args)


class _Halving(torch.autograd.Function):
    """K4a: one launch a level (with ``keep``, the tape for the backward);
    under vmap once an example, as each example has its own shared P."""

    @staticmethod
    def forward(P, info, logZ, keep, cuda):
        return (_halving_cuda if cuda else halving_level_plain)(P, info, logZ, keep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        P, _, _, keep, cuda = inputs
        ctx.set_materialize_grads(False)
        ctx.cuda = cuda
        if keep:
            ctx.save_for_backward(P, output[3], output[4])

    @staticmethod
    def backward(ctx, g_P, g_info, g_logZ, g_L, g_ib):
        _taped_not_differentiated("halving_level", g_L, g_ib)
        P, L, ib = ctx.saved_tensors
        return *_HalvingBackward.apply(P, L, ib, g_P, g_info, g_logZ, ctx.cuda), None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        return func_rules.loop(_Halving.apply, info, in_dims, args)


def _contract_backward(t, L, P_mk, i_m, g_P, g_info, g_logZ, cuda):
    """K4b's backward over any leading dims (those of the tape), as rows."""
    lead = L.shape[:-3]
    k, R = len(lead), math.prod(lead)

    def rows(x):  # the leading batch dims as one
        return None if x is None else x.reshape(R, *x.shape[k:])

    bwd = _contract_bwd_cuda if cuda else contract_pairs_bwd_plain
    grads = bwd(t, *map(rows, (L, P_mk, i_m)), *map(rows, (g_P, g_info, g_logZ)))
    return tuple(g.reshape(*lead, *g.shape[1:]) for g in grads)


def _fold_lead(info, in_dims, args, inner):
    """Operands of a level (``inner`` trailing dims each, the rest leading
    batch dims) with the mapped dim first and every operand expanded (as a
    stride-0 view, no copy) to the mapped size and the broadcast lead: the
    examples become leading rows of one launch."""
    C = info.batch_size
    lead = torch.broadcast_shapes(*(func_rules.logical_shape(a, d)[: logical_ndim(a, d) - k]
                                    for a, d, k in zip(args, in_dims, inner) if a is not None))
    out = []
    for a, d, k in zip(args, in_dims, inner):
        if a is not None:
            a = func_rules.front(a, d, C, len(lead) + k, expand=True)
            a = a.expand(C, *lead, *a.shape[a.ndim - k:])
        out.append(a)
    return out


class _ContractBackward(torch.autograd.Function):
    """K4b's backward, as a Function whose vmap rule folds the examples
    into the tape's leading rows: one launch."""

    @staticmethod
    def forward(t, L, P_mk, i_m, g_P, g_info, g_logZ, cuda):
        return _contract_backward(t, L, P_mk, i_m, g_P, g_info, g_logZ, cuda)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        _no_second_derivative("contract_pairs")

    @staticmethod
    def vmap(info, in_dims, t, L, P_mk, i_m, g_P, g_info, g_logZ, cuda):
        folded = _fold_lead(info, in_dims[1:7], (L, P_mk, i_m, g_P, g_info, g_logZ), (3, 3, 2, 3, 2, 1))
        return _ContractBackward.apply(t, *folded, cuda), (0, 0, 0)


class _Contract(torch.autograd.Function):
    """K4b: one launch a level (with ``keep``, the tape: L, P_mk, i_m);
    under vmap the examples are folded into the leading rows."""

    @staticmethod
    def forward(P, info, logZ, keep, cuda):
        P_out, info_out, logZ_out, saved = (_contract_cuda if cuda else contract_pairs_plain)(P, info, logZ, keep)
        return P_out, info_out, logZ_out, *(saved or (None, None, None))

    @staticmethod
    def setup_context(ctx, inputs, output):
        P, _, _, keep, cuda = inputs
        ctx.set_materialize_grads(False)
        ctx.cuda, ctx.t = cuda, P.shape[-3]
        if keep:
            ctx.save_for_backward(*output[3:])

    @staticmethod
    def backward(ctx, g_P, g_info, g_logZ, g_L, g_Pmk, g_im):
        _taped_not_differentiated("contract_pairs", g_L, g_Pmk, g_im)
        return *_ContractBackward.apply(ctx.t, *ctx.saved_tensors, g_P, g_info, g_logZ, ctx.cuda), None, None

    @staticmethod
    def vmap(info, in_dims, P, info_, logZ, keep, cuda):
        outs = _Contract.apply(*_fold_lead(info, in_dims[:3], (P, info_, logZ), (3, 2, 1)), keep, cuda)
        return outs, tuple(None if o is None else 0 for o in outs)


class _MidsCUDA(torch.autograd.Function):
    """K4c's launch; its backward raises (Queue 2).  Under vmap once an
    example."""

    @staticmethod
    def forward(cur, L, P_mk, i_m, eps):
        return _mids_cuda(cur, L, P_mk, i_m, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "level_mids: the CUDA kernel has no backward yet; differentiating posterior draws "
            "on the card is K4c's backward, ROADMAP.md Queue 2"
        )

    @staticmethod
    def vmap(info, in_dims, *args):
        return func_rules.loop(_MidsCUDA.apply, info, in_dims, args)


class _GammaLevelCUDA(torch.autograd.Function):
    """A K5 launch, whose backward raises: no path of the JAX package trains
    a gamma-Gaussian model yet.  Under vmap once an example."""

    @staticmethod
    def forward(name, kernel, *args):
        return kernel(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name}: the CUDA kernel has no backward yet; training a gamma-Gaussian model "
            "on the card is K5's backward, ROADMAP.md Queue 2"
        )

    @staticmethod
    def vmap(info, in_dims, *args):
        return func_rules.loop(_GammaLevelCUDA.apply, info, in_dims, args)


def _on_cuda(*tensors):
    return any(t.is_cuda for t in tensors)


def _keep_tape(tape, *tensors):
    """Whether the forward keeps its tape: asked for, or a gradient wanted."""
    return tape or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def halving_level(P, info, logZ, tape=False):
    """K4a: one halving level of a homogeneous chain (see the module doc)."""
    P_out, info_out, logZ_out, L, ib = _Halving.apply(
        P, info, logZ, _keep_tape(tape, P, info, logZ), _on_cuda(P, info, logZ))
    return P_out, info_out, logZ_out, L, ib if tape else None


def contract_pairs(P, info, logZ, tape=False):
    """K4b: the contraction of adjacent pairs (see the module doc)."""
    P_out, info_out, logZ_out, *saved = _Contract.apply(
        P, info, logZ, _keep_tape(tape, P, info, logZ), _on_cuda(P, info, logZ))
    return P_out, info_out, logZ_out, tuple(saved) if tape else None


def level_mids(cur, L, P_mk, i_m, eps):
    """K4c: a level's midpoint draws (see the module doc)."""
    if _on_cuda(cur, L, P_mk, i_m, eps):
        return _MidsCUDA.apply(cur, L, P_mk, i_m, eps)
    return level_mids_plain(cur, L, P_mk, i_m, eps)


def gamma_halving_level(P, info, logZ, alpha, beta):
    """K5a: one halving level of a homogeneous gamma-Gaussian chain (see the
    module doc): ``(P', info', logZ', alpha', beta')``."""
    if _on_cuda(P, info, logZ, alpha, beta):
        return _GammaLevelCUDA.apply("gamma_halving_level", _gamma_halving_cuda, P, info, logZ, alpha, beta)
    return gamma_halving_level_plain(P, info, logZ, alpha, beta)


def gamma_contract_pairs(P, info, logZ, alpha, beta):
    """K5b: the gamma-Gaussian contraction of adjacent pairs (see the module
    doc): ``(P', info', logZ', alpha', beta')``."""
    if _on_cuda(P, info, logZ, alpha, beta):
        return _GammaLevelCUDA.apply("gamma_contract_pairs", _gamma_contract_cuda, P, info, logZ, alpha, beta)
    return gamma_contract_pairs_plain(P, info, logZ, alpha, beta)
