"""Welford's streaming variance (counterpart of ``pyro_tpu/ops/welford.py``),
diagonal only.

The state's leading dims are a batch (the chains): ``mean`` and ``m2`` are
(..., size) and ``n`` is (...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor  # sum of squared deviations
    n: torch.Tensor


def welford_init(size: int, diagonal: bool = True, batch_shape=(), device=None) -> WelfordState:
    if not diagonal:
        raise NotImplementedError("a full Welford covariance is not ported yet; see ROADMAP.md Queue 1 item 5")
    zeros = torch.zeros(tuple(batch_shape) + (size,), device=device)
    return WelfordState(zeros, zeros, torch.zeros(tuple(batch_shape), device=device))


def welford_update(state: WelfordState, x) -> WelfordState:
    n = state.n + 1
    delta = x - state.mean
    mean = state.mean + delta / n[..., None]
    return WelfordState(mean, state.m2 + delta * (x - mean), n)


def welford_covariance(state: WelfordState, regularize: bool = True):
    """Sample variance with Stan's shrinkage toward a small unit diagonal."""
    n = state.n[..., None]
    cov = state.m2 / torch.clamp(n - 1, min=1)
    if regularize:
        cov = n / (n + 5.0) * cov + 1e-3 * (5.0 / (n + 5.0))
    return cov
