"""Tensor utilities (counterpart of ``pyro_tpu/ops/tensor_utils.py``):
block-diagonal embedding, FFT convolution, repeated products, the
orthonormal DCT and Haar transforms, and periodic repeats, sums and
features."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..settings import get_default_device


def block_diag_embed(mat):
    """(..., B, M, N) -> (..., B*M, B*N), the B blocks on the diagonal.
    One product with the identity, so gradients reach every block."""
    B, M, N = mat.shape[-3:]
    eye = torch.eye(B, dtype=mat.dtype, device=mat.device)
    out = mat.unsqueeze(-2) * eye.reshape(B, 1, B, 1)  # (..., B, M, B, N)
    return out.reshape(mat.shape[:-3] + (B * M, B * N))


def next_fast_len(size: int) -> int:
    """The least n >= size of the form 2^a 3^b."""
    n = size
    while True:
        m = n
        while m % 2 == 0:
            m //= 2
        while m % 3 == 0:
            m //= 3
        if m == 1:
            return n
        n += 1


def convolve(signal, kernel, mode: str = "full"):
    """Batched 1-D convolution along the last dim by FFT; ``mode`` "full",
    "valid" or "same"."""
    m, n = signal.shape[-1], kernel.shape[-1]
    if mode == "full":
        truncate = m + n - 1
    elif mode == "valid":
        truncate = max(m, n) - min(m, n) + 1
    elif mode == "same":
        truncate = max(m, n)
    else:
        raise ValueError(f"unknown mode: {mode}")
    padded = next_fast_len(m + n - 1)
    result = torch.fft.irfft(torch.fft.rfft(signal, n=padded) * torch.fft.rfft(kernel, n=padded), n=padded)
    start = (m + n - 1 - truncate) // 2 if mode == "same" else 0
    return result[..., start:start + truncate]


def repeated_matmul(M, n: int):
    """[M, M^2, ..., M^n] stacked in a new leading dim, in O(log n) rounds."""
    assert n >= 1
    result = M[None]
    while result.shape[0] < n:
        extra = torch.einsum("...ij,k...jl->k...il", result[-1], result)
        result = torch.cat([result, extra], dim=0)
    return result[:n]


@functools.lru_cache(maxsize=32)
def _dct_matrix(N: int, dtype, device):
    """The orthonormal DCT-II matrix C, dct(x) = x @ C.T:
    C[k, n] = s_k cos(pi (2n + 1) k / (2N))."""
    k, n = np.arange(N)[:, None], np.arange(N)[None, :]
    C = np.cos(math.pi * (2 * n + 1) * k / (2 * N)) * math.sqrt(2.0 / N)
    C[0] *= math.sqrt(0.5)
    return torch.tensor(C, dtype=dtype, device=device)


def dct(x, dim: int = -1):
    """The orthonormal DCT-II along ``dim``: one product with its (N, N)
    matrix, as the JAX package computes it."""
    x = x.movedim(dim, -1)
    return (x @ _dct_matrix(x.shape[-1], x.dtype, x.device).T).movedim(-1, dim)


def idct(x, dim: int = -1):
    """The orthonormal DCT-III along ``dim``, the inverse of :func:`dct`."""
    x = x.movedim(dim, -1)
    return (x @ _dct_matrix(x.shape[-1], x.dtype, x.device)).movedim(-1, dim)


def haar_transform(x):
    """The orthonormal discrete Haar transform along the last dim."""
    n = x.shape[-1] // 2
    even, odd = x[..., 0:2 * n:2], x[..., 1:2 * n:2]
    a = (even + odd) * 0.5**0.5
    b = (even - odd) * 0.5**0.5
    if 2 * n < x.shape[-1]:
        a = torch.cat([a, x[..., -1:]], dim=-1)
    if n >= 2:
        a = haar_transform(a)
    return torch.cat([a, b], dim=-1)


def inverse_haar_transform(x):
    """The inverse of :func:`haar_transform`."""
    n = x.shape[-1] // 2
    rest = x.shape[-1] - n
    a, b = x[..., :rest], x[..., rest:]
    if n >= 2:
        a = inverse_haar_transform(a)
    tail = a[..., n:] if rest > n else None
    a = a[..., :n]
    even, odd = (a + b) * 0.5**0.5, (a - b) * 0.5**0.5
    out = torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (2 * n,))
    return out if tail is None else torch.cat([out, tail], dim=-1)


def periodic_repeat(x, size: int, dim: int):
    """``x`` repeated along ``dim`` (negative) and cut to ``size``."""
    assert dim < 0
    reps = [1] * x.ndim
    reps[dim] = -(-size // x.shape[dim])
    return x.repeat(*reps).narrow(dim, 0, size)


def periodic_cumsum(x, period: int, dim: int):
    """A cumulative sum along ``dim`` (negative) of each residue class
    modulo ``period``: out[t] = x[t] + x[t - period] + ..."""
    assert dim < 0
    axis = x.ndim + dim
    size = x.shape[axis]
    repeats = -(-size // period)
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, repeats * period - size]
    padded = torch.nn.functional.pad(x, pad)
    shape = x.shape[:axis] + (repeats, period) + x.shape[axis + 1:]
    summed = padded.reshape(shape).cumsum(axis)
    return summed.reshape(x.shape[:axis] + (repeats * period,) + x.shape[axis + 1:]).narrow(axis, 0, size)


def periodic_features(duration: int, max_period=None, min_period=None, **kwargs):
    """Fourier features (duration, 2 * periods): cos and sin at the periods
    max_period, max_period / 2, ... down to min_period."""
    max_period = duration if max_period is None else max_period
    min_period = 2 if min_period is None else min_period
    t = torch.arange(duration, dtype=torch.get_default_dtype(), device=get_default_device())[:, None]
    cols, p = [], max_period
    while p >= min_period:
        cols += [torch.cos(2 * math.pi * t / p), torch.sin(2 * math.pi * t / p)]
        p = p / 2
    return torch.cat(cols, dim=-1)
