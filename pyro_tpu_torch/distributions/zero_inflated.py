"""Zero-inflated distributions (counterpart of
``pyro_tpu/distributions/zero_inflated.py``)."""

from __future__ import annotations

import torch

from . import constraints
from .discrete import NegativeBinomial, Poisson
from .distribution import Distribution
from .util import as_float, broadcast_shape, clamp_probs, lazy_property, logits_to_probs, probs_to_logits


class ZeroInflatedDistribution(Distribution):
    """A univariate ``base_dist`` with extra zeros: exactly one of ``gate``
    (the probability of an extra zero) or ``gate_logits``."""

    arg_constraints = {"gate": constraints.unit_interval, "gate_logits": constraints.real}
    is_discrete = True

    def __init__(self, base_dist: Distribution, *, gate=None, gate_logits=None):
        if (gate is None) == (gate_logits is None):
            raise ValueError("pass exactly one of gate or gate_logits")
        if base_dist.event_shape != ():
            raise ValueError("ZeroInflatedDistribution expects a univariate base")
        self._gate = None if gate is None else as_float(gate)
        self._gate_logits = None if gate_logits is None else as_float(gate_logits)
        batch_shape = broadcast_shape((self._gate if gate is not None else self._gate_logits).shape,
                                      base_dist.batch_shape)
        self.base_dist = base_dist.expand(batch_shape)
        super().__init__(batch_shape)

    @lazy_property
    def gate(self):
        return self._gate if self._gate is not None else logits_to_probs(self._gate_logits, is_binary=True)

    @lazy_property
    def gate_logits(self):
        return self._gate_logits if self._gate_logits is not None else probs_to_logits(self._gate, is_binary=True)

    @property
    def support(self):  # type: ignore[override]
        return self.base_dist.support

    def sample(self, generator=None, sample_shape=()):
        with torch.no_grad():
            gate = self.gate
            u = torch.rand(self.shape(sample_shape), generator=generator, dtype=gate.dtype, device=gate.device)
            samples = self.base_dist.sample(generator, sample_shape)
            return torch.where(u < gate, torch.zeros_like(samples), samples)

    def log_prob(self, value):
        gate = clamp_probs(self.gate)
        log_prob = torch.log1p(-gate) + self.base_dist.log_prob(value)
        zero_lp = torch.logaddexp(torch.log(gate), log_prob)
        return torch.where(value == 0, zero_lp, log_prob)

    @property
    def mean(self):
        return (1 - self.gate) * self.base_dist.mean

    @property
    def variance(self):
        m = self.base_dist.mean
        return (1 - self.gate) * (self.base_dist.variance + m**2) - self.mean**2

    def _gate_kwargs(self, batch_shape):
        if self._gate is not None:
            return {"gate": self.gate.expand(batch_shape)}
        return {"gate_logits": self._gate_logits.expand(batch_shape)}

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return ZeroInflatedDistribution(self.base_dist.expand(batch_shape), **self._gate_kwargs(batch_shape))


class ZeroInflatedPoisson(ZeroInflatedDistribution):
    arg_constraints = {"gate": constraints.unit_interval, "rate": constraints.positive}

    def __init__(self, rate, *, gate=None, gate_logits=None):
        super().__init__(Poisson(rate), gate=gate, gate_logits=gate_logits)
        self.rate = self.base_dist.rate

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return ZeroInflatedPoisson(self.rate.expand(batch_shape), **self._gate_kwargs(batch_shape))


class ZeroInflatedNegativeBinomial(ZeroInflatedDistribution):
    def __init__(self, total_count, *, probs=None, logits=None, gate=None, gate_logits=None):
        super().__init__(NegativeBinomial(total_count, probs=probs, logits=logits), gate=gate,
                         gate_logits=gate_logits)
        self.total_count = self.base_dist.total_count
