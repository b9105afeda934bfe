"""Welford's streaming variance and covariance (counterpart of
``pyro_tpu/ops/welford.py``).

The state's leading dims are a batch (the chains): ``mean`` is (..., size),
``m2`` (..., size) for the diagonal or (..., size, size) for the full
covariance, and ``n`` is (...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor  # sum of squared deviations (diagonal) or of outer products (full)
    n: torch.Tensor


def welford_init(size: int, diagonal: bool = True, batch_shape=(), device=None) -> WelfordState:
    batch_shape = tuple(batch_shape)
    mean = torch.zeros(batch_shape + (size,), device=device)
    m2 = mean if diagonal else torch.zeros(batch_shape + (size, size), device=device)
    return WelfordState(mean, m2, torch.zeros(batch_shape, device=device))


def welford_update(state: WelfordState, x) -> WelfordState:
    n = state.n + 1
    delta = x - state.mean
    mean = state.mean + delta / n[..., None]
    delta2 = x - mean
    if state.m2.ndim == state.mean.ndim:
        m2 = state.m2 + delta * delta2
    else:
        m2 = state.m2 + delta2[..., :, None] * delta[..., None, :]
    return WelfordState(mean, m2, n)


def welford_covariance(state: WelfordState, regularize: bool = True):
    """Sample (co)variance with Stan's shrinkage toward a small unit
    diagonal."""
    full = state.m2.ndim > state.mean.ndim
    n = state.n[..., None, None] if full else state.n[..., None]
    cov = state.m2 / torch.clamp(n - 1, min=1)
    if regularize:
        shrink = 1e-3 * (5.0 / (n + 5.0))
        if full:
            shrink = shrink * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        cov = n / (n + 5.0) * cov + shrink
    return cov
