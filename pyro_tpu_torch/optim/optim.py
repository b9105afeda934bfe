"""Optimisers over parameters that appear as the model runs (counterpart
of ``pyro_tpu/optim/optim.py``; Adam only).

State is kept per parameter name, created the first time a name is seen,
with hyperparameters from a dict or a callable ``optim_args(module_name,
param_name)``.  Parameters are updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from ..params.param_store import module_from_param_with_module_name, user_param_name


class _AdamState:
    """optax.adam's update: bias-corrected first and second moments."""

    def __init__(self, param: torch.Tensor, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.count = 0

    @torch.no_grad()
    def step(self, param: torch.Tensor, grad: torch.Tensor) -> None:
        self.count += 1
        self.mu.mul_(self.b1).add_(grad, alpha=1 - self.b1)
        self.nu.mul_(self.b2).addcmul_(grad, grad, value=1 - self.b2)
        mu_hat = self.mu / (1 - self.b1**self.count)
        nu_hat = self.nu / (1 - self.b2**self.count)
        param.sub_(self.lr * mu_hat / (nu_hat.sqrt() + self.eps))


class PyroOptim:
    """Per-parameter optimiser state with per-parameter hyperparameters."""

    def __init__(self, state_cls, optim_args: Union[Dict, Callable]):
        self._state_cls = state_cls
        if not callable(optim_args):
            static_args = dict(optim_args)
            optim_args = lambda module_name, param_name: static_args  # noqa: E731
        self.optim_args = optim_args
        self._states: Dict[str, object] = {}

    def __call__(self, params: Dict[str, torch.Tensor]) -> None:
        """Step every parameter that has a gradient, then clear its gradient."""
        for name, p in params.items():
            if p.grad is None:
                continue
            if name not in self._states:
                args = self.optim_args(module_from_param_with_module_name(name), user_param_name(name))
                self._states[name] = self._state_cls(p, **args)
            self._states[name].step(p, p.grad)
            p.grad = None


def Adam(optim_args=None, **kwargs) -> PyroOptim:
    """Adam with optax's formula (``lr``, ``betas``, ``eps``)."""
    return PyroOptim(_AdamState, kwargs if optim_args is None else optim_args)
