"""Beta, Normal, HalfCauchy, Gamma and Uniform (counterpart of the part of
``pyro_tpu/distributions/continuous.py`` this package uses)."""

from __future__ import annotations

import math

import torch

from ..settings import get_default_device
from . import constraints
from .distribution import Distribution
from .multivariate import _standard_gamma
from .util import as_float, broadcast_shape, clamp_probs


def _param(value, like=None):
    """A float tensor parameter.  A Python number becomes a fill on the
    device of ``like`` (else the package's device): ``torch.full`` launches a
    kernel, where ``torch.as_tensor`` of a number would copy it from the
    host and wait for the device."""
    if isinstance(value, torch.Tensor):
        return value if value.is_floating_point() else value.to(torch.get_default_dtype())
    device = like.device if isinstance(like, torch.Tensor) else get_default_device()
    return torch.full((), float(value), dtype=torch.get_default_dtype(), device=device)


class Beta(Distribution):
    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive}
    support = constraints.unit_interval
    has_rsample = True

    def __init__(self, concentration1, concentration0):
        c1 = as_float(concentration1)
        c0 = as_float(concentration0, device=c1.device)
        dtype = torch.promote_types(c1.dtype, c0.dtype)
        c1, c0 = c1.to(dtype), c0.to(dtype)
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


class Normal(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        like = loc if isinstance(loc, torch.Tensor) else scale
        loc, scale = _param(loc, like), _param(scale, like)
        shape = broadcast_shape(loc.shape, scale.shape)
        self.loc, self.scale = loc.expand(shape), scale.expand(shape)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        var = self.scale**2
        log_scale = torch.log(self.scale)
        return -((value - self.loc) ** 2) / (2 * var) - log_scale - 0.5 * math.log(2 * math.pi)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale**2

    def cdf(self, value):
        # erfc keeps the lower tail's relative accuracy, which float32
        # ``torch.special.ndtr`` loses (all of it by -6 standard deviations)
        return 0.5 * torch.special.erfc((self.loc - value) / (self.scale * math.sqrt(2.0)))

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Normal(self.loc.expand(batch_shape), self.scale.expand(batch_shape))


class HalfCauchy(Distribution):
    arg_constraints = {"scale": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, scale=1.0):
        self.scale = _param(scale)
        super().__init__(self.scale.shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        u = torch.rand(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        return self.scale * torch.tan(math.pi * u / 2)

    def log_prob(self, value):
        return math.log(2 / math.pi) - torch.log(self.scale) - torch.log1p((value / self.scale) ** 2)

    def expand(self, batch_shape, _instance=None):
        return HalfCauchy(self.scale.expand(tuple(batch_shape)))


class Gamma(Distribution):
    """Gamma(concentration, rate); draws take a ``torch.Generator``."""

    arg_constraints = {"concentration": constraints.positive, "rate": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, concentration, rate=1.0):
        like = concentration if isinstance(concentration, torch.Tensor) else rate
        concentration, rate = _param(concentration, like), _param(rate, like)
        shape = broadcast_shape(concentration.shape, rate.shape)
        self.concentration, self.rate = concentration.expand(shape), rate.expand(shape)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        return _standard_gamma(self.concentration.expand(self.shape(sample_shape)), generator) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * torch.log(b) + (a - 1) * torch.log(value) - b * value - torch.lgamma(a)

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.concentration / self.rate**2

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Gamma(self.concentration.expand(batch_shape), self.rate.expand(batch_shape))


class Uniform(Distribution):
    has_rsample = True

    def __init__(self, low=0.0, high=1.0):
        low = as_float(low)
        high = as_float(high, device=low.device)
        dtype = torch.promote_types(low.dtype, high.dtype)
        shape = broadcast_shape(low.shape, high.shape)
        self.low, self.high = low.to(dtype).expand(shape), high.to(dtype).expand(shape)
        super().__init__(shape)

    @property
    def support(self):
        return constraints.interval(self.low, self.high)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, -torch.log(self.high - self.low), -torch.inf)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Uniform(self.low.expand(batch_shape), self.high.expand(batch_shape))

    @property
    def mean(self):
        return (self.low + self.high) / 2
