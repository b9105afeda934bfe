"""Nesterov dual averaging of the step size (counterpart of
``pyro_tpu/ops/dual_averaging.py``).

The state is a NamedTuple of tensors updated elementwise, so one state
holds every chain's averages: each field has the chains' shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DAState(NamedTuple):
    prox_center: torch.Tensor  # mu
    g_avg: torch.Tensor  # running average of the error terms
    t: torch.Tensor  # step count
    x_t: torch.Tensor  # primal iterate (log step size)
    x_avg: torch.Tensor  # averaged iterate


def da_init(prox_center) -> DAState:
    """A fresh state centred at ``prox_center`` (a tensor of any shape)."""
    prox_center = torch.as_tensor(prox_center, dtype=torch.get_default_dtype())
    zero = torch.zeros_like(prox_center)
    return DAState(prox_center, zero, zero, zero, zero)


def da_step(state: DAState, g, gamma=0.05, t0=10.0, kappa=0.75) -> DAState:
    """One update with error term ``g``."""
    t = state.t + 1
    g_avg = (1 - 1 / (t + t0)) * state.g_avg + g / (t + t0)
    x_t = state.prox_center - (t**0.5) / gamma * g_avg
    weight_t = t ** (-kappa)
    x_avg = (1 - weight_t) * state.x_avg + weight_t * x_t
    return DAState(state.prox_center, g_avg, t, x_t, x_avg)
