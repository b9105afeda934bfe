"""Autoregressive Gaussian chains with neural conditionals, as one site
(counterpart of ``pyro_tpu/distributions/neural_markov.py``).

``NormalMarkovChain`` is the per-step ``pyro.sample`` loop of models like
the deep Markov model (ref ``examples/dmm.py:287-310``) collapsed into one
site with event shape ``(T, dim)``:

- ``log_prob`` teacher-forces: given the whole path, every step's
  conditional parameters come from one batched call of the conditioner over
  ``(..., T, dim)``, since ``p(z) = prod_t N(z_t | cond(z_{t-1}))`` only
  needs the known ``z_{t-1}``.
- ``rsample`` is the sequential part: the noise of all T steps is drawn in
  one ``torch.randn`` call, then the conditioner runs step by step.

Optional ``transforms`` (the DMM guide's IAFs) are applied to each step's
draw, and the conditioner sees the transformed previous value in both.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from . import constraints
from .distribution import Distribution
from .util import broadcast_shape


class NormalMarkovChain(Distribution):
    """z_{1:T} with ``z_t ~ Normal(cond_fn(z_{t-1}, x_t))``, one site.

    Args:
        cond_fn: ``(z_prev, x_t) -> (loc, scale)``, broadcasting over any
            leading dims; ``x_t`` is ``None`` when ``xs`` is not given.
        z_init: ``(..., dim)`` conditioner input of the first step.
        length: T, required when ``xs`` is None.
        xs: optional per-step side input ``(batch..., T, k)``.
        transforms: bijectors applied to each step's Normal draw, in order
            (the density inverts them, vectorised over T).
    """

    has_rsample = True
    arg_constraints = {}
    support = constraints.independent(constraints.real, 2)

    def __init__(
        self,
        cond_fn: Callable,
        z_init: torch.Tensor,
        length: Optional[int] = None,
        xs: Optional[torch.Tensor] = None,
        transforms: Sequence = (),
    ):
        self.cond_fn = cond_fn
        self.z_init = z_init
        self.xs = xs
        self.transforms = tuple(transforms)
        if xs is not None:
            length = xs.shape[-2]
        if length is None:
            raise ValueError("length is required when xs is None")
        self.length = int(length)
        batch_shape = broadcast_shape(z_init.shape[:-1], () if xs is None else xs.shape[:-2])
        super().__init__(batch_shape, (self.length, z_init.shape[-1]))

    def rsample(self, generator=None, sample_shape=()):
        dim = self.event_shape[-1]
        shape = self.shape(sample_shape)
        eps = torch.randn(shape, generator=generator, dtype=self.z_init.dtype, device=self.z_init.device)
        xs = None if self.xs is None else self.xs.expand(shape[:-2] + self.xs.shape[-2:])
        z = self.z_init.expand(shape[:-2] + (dim,))
        zs = []
        for t in range(self.length):
            loc, scale = self.cond_fn(z, None if xs is None else xs[..., t, :])
            z = loc + scale * eps[..., t, :]
            for tr in self.transforms:
                z = tr(z)
            zs.append(z)
        return torch.stack(zs, dim=-2)

    def _teacher_inputs(self, value):
        """(z_prev over all steps, the base value, each step's log-determinant)."""
        z0 = self.z_init[..., None, :].expand(value.shape[:-2] + (1, value.shape[-1]))
        z_prev = torch.cat([z0, value[..., :-1, :]], dim=-2)
        base = value
        logdet = value.new_zeros(value.shape[:-1])
        for tr in reversed(self.transforms):
            x = tr.inv(base)
            ladj = tr.log_abs_det_jacobian(x, base)
            ed = getattr(tr, "event_dim", 0)
            if ed == 0:  # elementwise: reduce over the step's dim
                ladj = ladj.sum(-1)
            elif ed != 1:
                raise ValueError("chain-step transforms must have event_dim <= 1")
            logdet = logdet + ladj
            base = x
        return z_prev, base, logdet

    def log_prob(self, value):
        z_prev, base, logdet = self._teacher_inputs(value)
        loc, scale = self.cond_fn(z_prev, self.xs)
        lp = -0.5 * ((base - loc) / scale) ** 2 - torch.log(scale) - 0.5 * math.log(2 * math.pi)
        return lp.sum((-2, -1)) - logdet.sum(-1)


__all__ = ["NormalMarkovChain"]
