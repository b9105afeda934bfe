"""The halving levels of the information-form Gaussian algebra: K4a, K4b
and K4c, forward only.

Each function has a plain PyTorch version beside it, the arithmetic of the
JAX package's level code (``pyro_tpu/ops/gaussian.py``), and a wrapper.  On
CUDA tensors the wrapper launches the hand-written kernel of
``csrc/gaussian_levels.cu`` (float32, state dim n <= 32) behind a
``torch.autograd.Function`` whose backward raises: training through these
levels on the card is ROADMAP.md Queue 2's open K4 item.  On CPU tensors
the wrapper runs the plain version, which autograd differentiates.  A CUDA
tensor never reaches a plain version: the kernel launches or the call
raises.

- ``halving_level`` (K4a): one level of a time-homogeneous chain, every
  factor sharing one precision P (2n, 2n); info (R, 2m, 2n) and logZ
  (R, 2m) become (R, m, 2n) and (R, m), P becomes P', and the level's
  Cholesky factor L (n, n) and ``ib`` (R, m, n) are kept for the sampler.
- ``contract_pairs`` (K4b): adjacent pairs (2p, 2p + 1) of a chain whose
  precision varies, P (R, t, 2n, 2n), info (R, t, 2n), logZ (R, t), to
  (R, ceil(t / 2), ...), an odd level's last factor carried through; with
  ``tape``, each pair's L (n, n), P_mk (n, 2n) and i_m (n) for the descent.
- ``level_mids`` (K4c): a level's midpoint draws, the points (D, R, m, n)
  to (D, R, m + Np, n) with the mids in their interleaved places.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build, linalg_small

# Launches of the K4 kernels, counted by the wrappers.
launches = {"halving": 0, "contract": 0, "mids": 0}
MAX_DIM = 32  # the largest state dim n the kernels take (NMAX of the source)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def reset_counts():
    """Set every launch count to 0."""
    launches.update(halving=0, contract=0, mids=0)


# -- plain versions -----------------------------------------------------------------


def halving_level_plain(P, info, logZ, tape=False):
    """K4a's plain version: ``(P', info', logZ', L, ib or None)``."""
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
    info_new = outer - s @ Kt
    logZ_new = (
        logZ[..., 0::2] + logZ[..., 1::2] + n * _HALF_LOG_2PI
        - torch.log(torch.diagonal(L)).sum() + 0.5 * (s * s).sum(-1)
    )
    return P_new, info_new, logZ_new, L, ib if tape else None


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


def contract_pairs_plain(P, info, logZ, tape=False):
    """K4b's plain version: ``(P', info', logZ', (L, P_mk, i_m) or None)``."""
    n = P.shape[-1] // 2
    t = P.shape[-3]
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
    e = t // 2 * 2
    logZ_new = (
        logZ[..., 0:e:2] + logZ[..., 1:e:2] + n * _HALF_LOG_2PI
        - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1) + 0.5 * (Linvim**2).sum(-1)
    )
    if t > e:
        P_new = torch.cat([P_new, P[..., e:, :, :]], dim=-3)
        info_new = torch.cat([info_new, info[..., e:, :]], dim=-2)
        logZ_new = torch.cat([logZ_new, logZ[..., e:]], dim=-1)
    return P_new, info_new, logZ_new, (L, P_mk, i_m) if tape else None


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


# -- CUDA kernels ---------------------------------------------------------------------

_P = ctypes.c_void_p
_c = ctypes.c_int
_ll = ctypes.c_longlong


@functools.cache
def _lib():
    lib = cuda_build.load("gaussian_levels")
    lib.gl_halving.argtypes = [_P, _P, _ll, _P, _ll, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P]
    lib.gl_contract.argtypes = [_P, _P, _P, _c, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P, _P]
    lib.gl_mids.argtypes = [_P, _c, _P, _ll, _P, _ll, _P, _P, _c, _c, _c, _c, _c, _P, _P]
    for fn in (lib.gl_halving, lib.gl_contract, lib.gl_mids):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    blocks = max(1, min(-(-R * m // 8), 8 * _sms(P.device)))
    err = _lib().gl_halving(
        P.data_ptr(), info.data_ptr(), info_rs, logZ.data_ptr(), logZ_rs, R, m, n, blocks,
        P_out.data_ptr(), L_out.data_ptr(), info_out.data_ptr(), logZ_out.data_ptr(),
        None if ib is None else ib.data_ptr(), _stream(P),
    )
    _raise_on(err, "halving_level")
    launches["halving"] += 1
    return P_out, info_out, logZ_out, L_out, ib


def _contract_cuda(P, info, logZ, tape):
    R, t, n2, _ = P.shape
    n, np_ = n2 // 2, t // 2
    _check_cuda("contract_pairs", n, P, info, logZ)
    P, info, logZ = P.contiguous(), info.contiguous(), logZ.contiguous()
    t_out = t - np_
    new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
    P_out, info_out, logZ_out = new((R, t_out, n2, n2)), new((R, t_out, n2)), new((R, t_out))
    L = Pmk = im = None
    if tape:
        L, Pmk, im = new((R, np_, n, n)), new((R, np_, n, n2)), new((R, np_, n))
    blocks = max(1, min(R * np_, 16 * _sms(P.device)))
    err = _lib().gl_contract(
        P.data_ptr(), info.data_ptr(), logZ.data_ptr(), R, t, n, t_out, blocks,
        P_out.data_ptr(), info_out.data_ptr(), logZ_out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (L, Pmk, im)), _stream(P),
    )
    _raise_on(err, "contract_pairs")
    launches["contract"] += 1
    if t > 2 * np_:  # the odd level's last factor, carried through
        P_out[:, -1], info_out[:, -1], logZ_out[:, -1] = P[:, -1], info[:, -1], logZ[:, -1]
    return P_out, info_out, logZ_out, (L, Pmk, im) if tape else None


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
    blocks = max(1, min(-(-D * R * Np // 8), 16 * _sms(cur.device)))
    err = _lib().gl_mids(
        cur.data_ptr(), m, L.data_ptr(), 0 if shared else n * n, P_mk.data_ptr(), 0 if shared else 2 * n * n,
        i_m.data_ptr(), eps.data_ptr(), D, R, Np, n, blocks, out.data_ptr(), _stream(cur),
    )
    _raise_on(err, "level_mids")
    launches["mids"] += 1
    return out


def _no_backward(name):
    raise NotImplementedError(
        f"{name}: the CUDA kernel has no backward yet; training through the Gaussian "
        "halving levels on the card is ROADMAP.md Queue 2's K4 item"
    )


class _HalvingCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P, info, logZ, tape):
        return _halving_cuda(P, info, logZ, tape)

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("halving_level")


class _ContractCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P, info, logZ, tape):
        P_out, info_out, logZ_out, saved = _contract_cuda(P, info, logZ, tape)
        saved = saved or (None, None, None)
        return P_out, info_out, logZ_out, *saved

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("contract_pairs")


class _MidsCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cur, L, P_mk, i_m, eps):
        return _mids_cuda(cur, L, P_mk, i_m, eps)

    @staticmethod
    def backward(ctx, g):
        _no_backward("level_mids")


def _on_cuda(*tensors):
    return any(t.is_cuda for t in tensors)


def halving_level(P, info, logZ, tape=False):
    """K4a: one halving level of a homogeneous chain (see the module doc)."""
    if _on_cuda(P, info, logZ):
        return _HalvingCUDA.apply(P, info, logZ, tape)
    return halving_level_plain(P, info, logZ, tape)


def contract_pairs(P, info, logZ, tape=False):
    """K4b: the contraction of adjacent pairs (see the module doc)."""
    if _on_cuda(P, info, logZ):
        P_out, info_out, logZ_out, *saved = _ContractCUDA.apply(P, info, logZ, tape)
        return P_out, info_out, logZ_out, tuple(saved) if tape else None
    return contract_pairs_plain(P, info, logZ, tape)


def level_mids(cur, L, P_mk, i_m, eps):
    """K4c: a level's midpoint draws (see the module doc)."""
    if _on_cuda(cur, L, P_mk, i_m, eps):
        return _MidsCUDA.apply(cur, L, P_mk, i_m, eps)
    return level_mids_plain(cur, L, P_mk, i_m, eps)
