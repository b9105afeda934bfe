"""Compound distributions of a conjugate pair (counterpart of
``pyro_tpu/distributions/conjugate.py``): BetaBinomial,
DirichletMultinomial and GammaPoisson."""

from __future__ import annotations

import torch

from ..ops.special import log_beta, log_binomial
from . import constraints
from .continuous import Beta, Gamma, _params
from .discrete import Multinomial
from .distribution import Distribution
from .multivariate import Dirichlet
from .util import as_float, broadcast_shape


class BetaBinomial(Distribution):
    """A Binomial whose success probability is Beta distributed."""

    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive,
                       "total_count": constraints.nonnegative_integer}
    is_discrete = True
    has_enumerate_support = True
    approx_log_prob_tol = 0.0

    def __init__(self, concentration1, concentration0, total_count=1):
        shape, (self.concentration1, self.concentration0, self.total_count) = _params(
            concentration1, concentration0, total_count)
        super().__init__(shape)

    @property
    def support(self):  # type: ignore[override]
        return constraints.integer_interval(0, self.total_count)

    def sample(self, generator=None, sample_shape=()):
        with torch.no_grad():
            probs = Beta(self.concentration1, self.concentration0).sample(generator, sample_shape)
            return torch.binomial(self.total_count.expand(probs.shape), probs, generator=generator)

    def log_prob(self, value):
        a, b, n = self.concentration1, self.concentration0, self.total_count
        tol = self.approx_log_prob_tol
        return log_binomial(n, value, tol) + log_beta(value + a, n - value + b, tol) - log_beta(a, b, tol)

    @property
    def mean(self):
        return self.total_count * self.concentration1 / (self.concentration1 + self.concentration0)

    @property
    def variance(self):
        a, b, n = self.concentration1, self.concentration0, self.total_count
        total = a + b
        return n * a * b * (total + n) / (total**2 * (total + 1))

    def enumerate_support(self, expand=True):
        """0 .. max(total_count) in a new leftmost dim (reads the count
        from the device)."""
        n = self.total_count
        values = torch.arange(1 + int(n.max()), dtype=n.dtype, device=n.device)
        values = values.reshape((-1,) + (1,) * len(self.batch_shape))
        return values.expand(values.shape[:1] + self.batch_shape) if expand else values

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return BetaBinomial(*(p.expand(batch_shape) for p in (self.concentration1, self.concentration0,
                                                              self.total_count)))


class DirichletMultinomial(Distribution):
    """A Multinomial whose probabilities are Dirichlet distributed."""

    arg_constraints = {"concentration": constraints.independent(constraints.positive, 1),
                       "total_count": constraints.nonnegative_integer}
    is_discrete = True

    def __init__(self, concentration, total_count=1, is_sparse=False):
        self.concentration = as_float(concentration)
        self.total_count = total_count
        self.is_sparse = is_sparse
        batch_shape = broadcast_shape(self.concentration.shape[:-1], getattr(total_count, "shape", ()))
        super().__init__(batch_shape, self.concentration.shape[-1:])

    @property
    def support(self):  # type: ignore[override]
        return constraints.multinomial(self.total_count)

    def sample(self, generator=None, sample_shape=()):
        with torch.no_grad():
            probs = Dirichlet(self.concentration).sample(generator, sample_shape)
            return Multinomial(int(self.total_count), probs=probs).sample(generator)

    def log_prob(self, value):
        a = self.concentration
        n, a0 = value.sum(-1), a.sum(-1)
        return (
            torch.lgamma(a0) + torch.lgamma(n + 1) - torch.lgamma(n + a0)
            + (torch.lgamma(value + a) - torch.lgamma(a) - torch.lgamma(value + 1)).sum(-1)
        )

    def _total_count(self):
        return torch.as_tensor(self.total_count, dtype=self.concentration.dtype,
                               device=self.concentration.device)[..., None]

    @property
    def mean(self):
        a = self.concentration
        return self._total_count() * a / a.sum(-1, keepdim=True)

    @property
    def variance(self):
        a = self.concentration
        a0 = a.sum(-1, keepdim=True)
        n, p = self._total_count(), a / a0
        return n * p * (1 - p) * (n + a0) / (1 + a0)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return DirichletMultinomial(self.concentration.expand(batch_shape + self.event_shape), self.total_count,
                                    self.is_sparse)


class GammaPoisson(Distribution):
    """A Poisson whose rate is Gamma(concentration, rate) distributed: the
    NegativeBinomial with total_count ``concentration`` and success
    probability ``1 / (1 + rate)``."""

    arg_constraints = {"concentration": constraints.positive, "rate": constraints.positive}
    support = constraints.nonnegative_integer
    is_discrete = True

    def __init__(self, concentration, rate):
        shape, (self.concentration, self.rate) = _params(concentration, rate)
        super().__init__(shape)

    def sample(self, generator=None, sample_shape=()):
        with torch.no_grad():
            rate = Gamma(self.concentration, self.rate).sample(generator, sample_shape)
            return torch.poisson(rate, generator=generator)

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        post_value = a + value
        return -log_beta(a, value + 1) - torch.log(post_value) + a * torch.log(b) - post_value * torch.log1p(b)

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.concentration / self.rate**2 * (1 + self.rate)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return GammaPoisson(self.concentration.expand(batch_shape), self.rate.expand(batch_shape))
