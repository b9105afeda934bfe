"""Stochastic variational inference (counterpart of
``pyro_tpu/infer/svi.py``).

A step runs model and guide under the handlers to get the loss, calls
``backward()``, and applies the optimiser to every parameter the step
touched.  PyTorch runs eagerly, so there is no compiled step; ``run_steps``
is a plain loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import poutine
from ..params.param_store import get_param_store
from ..settings import get_default_device


class SVI:
    def __init__(self, model: Callable, guide: Callable, optim, loss, seed: int = 0):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.loss_obj = loss
        self.generator = torch.Generator(device=get_default_device())
        self.generator.manual_seed(seed)

    def _loss_and_params(self, args, kwargs, generator):
        with poutine.trace(param_only=True) as param_capture:
            loss = self.loss_obj.differentiable_loss(
                self.model, self.guide, *args, generator=generator or self.generator, **kwargs
            )
        store = get_param_store()
        params = {name: store.get_unconstrained(name) for name in param_capture.trace.param_nodes()}
        return loss, params

    def _step(self, args, kwargs, generator):
        loss, params = self._loss_and_params(args, kwargs, generator)
        loss.backward()
        self.optim(params)
        return loss.detach()

    def step(self, *args, generator: Optional[torch.Generator] = None, **kwargs) -> float:
        """One optimisation step; returns the loss as a float."""
        return float(self._step(args, kwargs, generator))

    def run_steps(self, num_steps: int, *args, generator: Optional[torch.Generator] = None, **kwargs):
        """``num_steps`` steps; returns the tensor of their losses (read from
        the device only when the caller reads it)."""
        return torch.stack([self._step(args, kwargs, generator) for _ in range(num_steps)])

    def evaluate_loss(self, *args, generator: Optional[torch.Generator] = None, **kwargs) -> float:
        with torch.no_grad():
            loss, _ = self._loss_and_params(args, kwargs, generator)
        return float(loss)
