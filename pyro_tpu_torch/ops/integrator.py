"""Leapfrog integrator (counterpart of ``pyro_tpu/ops/integrator.py``).

``z`` and ``r`` are dicts of tensors.  Divergence shows as a non-finite
energy, which the samplers test by value.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def potential_grad(potential_fn: Callable, z: Dict):
    """(potential energy, its gradient) at ``z``, by ``torch.func``."""
    grad, pe = torch.func.grad_and_value(potential_fn)(z)
    return pe, grad


def velocity_verlet(z: Dict, r: Dict, potential_fn: Callable, kinetic_grad: Callable, step_size, num_steps: int = 1,
                    z_grads=None):
    """Second-order symplectic integrator: ``num_steps`` steps of half a
    momentum step, a full position step along ``kinetic_grad(r)`` (for
    example M^-1 r) and half a momentum step.  Returns (z, r, z_grads,
    potential energy)."""
    if z_grads is None:
        _, z_grads = potential_grad(potential_fn, z)
    pe = 0.0
    for _ in range(num_steps):
        r_half = {k: r[k] - 0.5 * step_size * z_grads[k] for k in r}
        dkdr = kinetic_grad(r_half)
        z = {k: z[k] + step_size * dkdr[k] for k in z}
        pe, z_grads = potential_grad(potential_fn, z)
        r = {k: r_half[k] - 0.5 * step_size * z_grads[k] for k in r_half}
    return z, r, z_grads, pe
