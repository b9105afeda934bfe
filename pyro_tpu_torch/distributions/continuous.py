"""Beta (counterpart of the part of ``pyro_tpu/distributions/continuous.py``
this package uses)."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .multivariate import _standard_gamma
from .util import broadcast_shape, clamp_probs


class Beta(Distribution):
    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive}
    support = constraints.unit_interval
    has_rsample = True

    def __init__(self, concentration1, concentration0):
        c1 = torch.as_tensor(concentration1, dtype=torch.get_default_dtype())
        c0 = torch.as_tensor(concentration0, dtype=torch.get_default_dtype(), device=c1.device)
        shape = broadcast_shape(c1.shape, c0.shape)
        self.concentration1, self.concentration0 = c1.expand(shape), c0.expand(shape)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        g1 = _standard_gamma(self.concentration1.expand(shape), generator)
        g0 = _standard_gamma(self.concentration0.expand(shape), generator)
        return clamp_probs(g1 / (g1 + g0))

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return (
            (a - 1) * torch.log(value)
            + (b - 1) * torch.log1p(-value)
            - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))
        )

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Beta(self.concentration1.expand(batch_shape), self.concentration0.expand(batch_shape))
