"""Bernoulli and Categorical (counterpart of
``pyro_tpu/distributions/discrete.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints
from .distribution import Distribution
from .util import as_float, broadcast_shape, lazy_property, logits_to_probs, probs_to_logits


def _one_of(probs, logits):
    if (probs is None) == (logits is None):
        raise ValueError("pass exactly one of probs or logits")


def _uniform(shape, like, generator):
    device = like.device if generator is None else generator.device
    return torch.rand(shape, generator=generator, device=device, dtype=like.dtype)


class Bernoulli(Distribution):
    arg_constraints = {"probs": constraints.unit_interval, "logits": constraints.real}
    support = constraints.boolean
    has_enumerate_support = True
    is_discrete = True

    def __init__(self, probs=None, logits=None):
        _one_of(probs, logits)
        self._probs = None if probs is None else as_float(probs)
        self._logits = None if logits is None else as_float(logits)
        super().__init__((self._probs if probs is not None else self._logits).shape)

    @lazy_property
    def probs(self):
        return self._probs if self._probs is not None else logits_to_probs(self._logits, is_binary=True)

    @lazy_property
    def logits(self):
        return self._logits if self._logits is not None else probs_to_logits(self._probs, is_binary=True)

    def sample(self, generator=None, sample_shape=()):
        probs = self.probs.detach()
        return (_uniform(self.shape(sample_shape), probs, generator) < probs).to(probs.dtype)

    def log_prob(self, value):
        logits = self.logits
        return value * logits - F.softplus(logits)

    def enumerate_support(self, expand=True):
        """The values 0 and 1 in a new leftmost dim, broadcast to the batch
        shape only when ``expand``."""
        param = self._probs if self._probs is not None else self._logits
        values = torch.arange(2.0, dtype=param.dtype, device=param.device)
        values = values.reshape((2,) + (1,) * len(self.batch_shape))
        return values.expand((2,) + self.batch_shape) if expand else values

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        if self._probs is not None:
            return Bernoulli(probs=self._probs.expand(batch_shape))
        return Bernoulli(logits=self._logits.expand(batch_shape))


class Categorical(Distribution):
    arg_constraints = {"probs": constraints.simplex, "logits": constraints.real_vector}
    has_enumerate_support = True
    is_discrete = True

    def __init__(self, probs=None, logits=None):
        _one_of(probs, logits)
        if probs is not None:
            probs = as_float(probs)
            self._probs = probs / probs.sum(-1, keepdim=True)
            self._logits = None
            param = self._probs
        else:
            self._logits = as_float(logits)
            self._probs = None
            param = self._logits
        self._num_events = param.shape[-1]
        super().__init__(param.shape[:-1])

    @property
    def support(self):  # type: ignore[override]
        return constraints.integer_interval(0, self._num_events - 1)

    @lazy_property
    def probs(self):
        return self._probs if self._probs is not None else logits_to_probs(self._logits)

    @lazy_property
    def logits(self):
        if self._logits is not None:
            return self._logits - torch.logsumexp(self._logits, dim=-1, keepdim=True)
        return probs_to_logits(self._probs)

    def sample(self, generator=None, sample_shape=()):
        # Gumbel-max over the (detached) normalised logits
        logits = self.logits.detach().expand(self.shape(sample_shape) + (self._num_events,))
        u = _uniform(logits.shape, logits, generator).clamp(min=torch.finfo(logits.dtype).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(-1)

    def log_prob(self, value):
        value = torch.as_tensor(value)
        logits = self.logits
        shape = broadcast_shape(value.shape, logits.shape[:-1])
        value = value.expand(shape).long()
        logits = logits.expand(shape + logits.shape[-1:])
        return torch.gather(logits, -1, value.unsqueeze(-1)).squeeze(-1)

    def enumerate_support(self, expand=True):
        """The categories in a new leftmost dim, broadcast to the batch
        shape only when ``expand``."""
        param = self._probs if self._probs is not None else self._logits
        values = torch.arange(self._num_events, device=param.device)
        values = values.reshape((self._num_events,) + (1,) * len(self.batch_shape))
        return values.expand((self._num_events,) + self.batch_shape) if expand else values
