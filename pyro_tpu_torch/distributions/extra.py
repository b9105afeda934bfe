"""The part of ``pyro_tpu/distributions/extra.py`` the port uses:
``FoldedDistribution``."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import TransformedDistribution
from .transforms import AbsTransform


class FoldedDistribution(TransformedDistribution):
    """|X| for a univariate real X: the density at y >= 0 is p(y) + p(-y)."""

    support = constraints.positive

    def __init__(self, base_dist):
        if base_dist.event_shape:
            raise ValueError("FoldedDistribution requires a univariate base")
        super().__init__(base_dist, AbsTransform())

    def log_prob(self, value):
        dim = max(len(self.batch_shape), value.ndim)
        plus_minus = torch.tensor([1.0, -1.0], dtype=value.dtype, device=value.device).reshape((2,) + (1,) * dim)
        return torch.logsumexp(self.base_dist.log_prob(plus_minus * value), dim=0)

    def expand(self, batch_shape, _instance=None):
        return FoldedDistribution(self.base_dist.expand(tuple(batch_shape)))
