"""Discrete distributions (counterpart of
``pyro_tpu/distributions/discrete.py``): Bernoulli, Categorical,
OneHotCategorical, Binomial, Multinomial, Poisson, Geometric and
NegativeBinomial.  Draws take a ``torch.Generator``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.special import log_beta, log_binomial
from . import constraints
from .distribution import Distribution
from .util import as_float, broadcast_shape, clamp_probs, lazy_property, logits_to_probs, probs_to_logits


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


class OneHotCategorical(Distribution):
    """A Categorical whose values are one-hot vectors."""

    arg_constraints = {"probs": constraints.simplex, "logits": constraints.real_vector}
    support = constraints.simplex
    has_enumerate_support = True
    is_discrete = True

    def __init__(self, probs=None, logits=None):
        self._categorical = Categorical(probs=probs, logits=logits)
        super().__init__(self._categorical.batch_shape, (self._categorical._num_events,))

    @property
    def probs(self):
        return self._categorical.probs

    @property
    def logits(self):
        return self._categorical.logits

    def sample(self, generator=None, sample_shape=()):
        idx = self._categorical.sample(generator, sample_shape)
        return F.one_hot(idx, self._categorical._num_events).to(self.probs.dtype)

    def log_prob(self, value):
        return (self.logits * value).sum(-1)

    @property
    def mean(self):
        return self.probs

    @property
    def variance(self):
        return self.probs * (1 - self.probs)

    def enumerate_support(self, expand=True):
        n = self._categorical._num_events
        probs = self.probs
        values = torch.eye(n, dtype=probs.dtype, device=probs.device).reshape((n,) + (1,) * len(self.batch_shape) + (n,))
        return values.expand((n,) + self.batch_shape + (n,)) if expand else values

    def expand(self, batch_shape, _instance=None):
        batch_shape, n = tuple(batch_shape), self._categorical._num_events
        if self._categorical._probs is not None:
            return OneHotCategorical(probs=self._categorical._probs.expand(batch_shape + (n,)))
        return OneHotCategorical(logits=self._categorical._logits.expand(batch_shape + (n,)))


def _count_device(total_count, probs, logits):
    """Where a number ``probs`` or ``logits`` goes: the device of a tensor
    ``total_count`` (else it would land on the CPU and pull the count
    there), or None."""
    param = probs if probs is not None else logits
    if isinstance(total_count, torch.Tensor) and not isinstance(param, torch.Tensor):
        return total_count.device
    return None


class _ProbsOrLogits(Distribution):
    """Holds exactly one of ``probs`` and ``logits`` (binary) and derives
    the other."""

    def _set_probs_or_logits(self, probs, logits, device=None):
        _one_of(probs, logits)
        self._probs = None if probs is None else as_float(probs, device)
        self._logits = None if logits is None else as_float(logits, device)
        return self._probs if probs is not None else self._logits

    @lazy_property
    def probs(self):
        return self._probs if self._probs is not None else logits_to_probs(self._logits, is_binary=True)

    @lazy_property
    def logits(self):
        return self._logits if self._logits is not None else probs_to_logits(self._probs, is_binary=True)

    def _expanded(self, batch_shape):
        """``{"probs": ...}`` or ``{"logits": ...}`` broadcast to ``batch_shape``."""
        if self._probs is not None:
            return {"probs": self._probs.expand(batch_shape)}
        return {"logits": self._logits.expand(batch_shape)}


class Binomial(_ProbsOrLogits):
    """Successes in ``total_count`` trials; ``total_count`` is kept as a
    float tensor of the probabilities' dtype."""

    arg_constraints = {"total_count": constraints.nonnegative_integer, "probs": constraints.unit_interval,
                       "logits": constraints.real}
    is_discrete = True
    has_enumerate_support = True

    def __init__(self, total_count=1, probs=None, logits=None):
        param = self._set_probs_or_logits(probs, logits, _count_device(total_count, probs, logits))
        self.total_count = torch.as_tensor(total_count, dtype=param.dtype, device=param.device)
        super().__init__(broadcast_shape(self.total_count.shape, param.shape))

    @property
    def support(self):  # type: ignore[override]
        return constraints.integer_interval(0, self.total_count)

    def sample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        probs = self.probs.detach()
        return torch.binomial(self.total_count.expand(shape), probs.expand(shape), generator=generator)

    def log_prob(self, value):
        n, p = self.total_count, clamp_probs(self.probs)
        return log_binomial(n, value) + value * torch.log(p) + (n - value) * torch.log1p(-p)

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def enumerate_support(self, expand=True):
        """0 .. max(total_count) in a new leftmost dim (reads the count
        from the device)."""
        total_count = int(self.total_count.max())
        values = torch.arange(1 + total_count, dtype=self.total_count.dtype, device=self.total_count.device)
        values = values.reshape((-1,) + (1,) * len(self.batch_shape))
        return values.expand(values.shape[:1] + self.batch_shape) if expand else values

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Binomial(self.total_count.expand(batch_shape), **self._expanded(batch_shape))


class Multinomial(Distribution):
    """Counts of ``total_count`` (a Python int) Categorical draws."""

    arg_constraints = {"probs": constraints.simplex, "logits": constraints.real_vector}
    is_discrete = True

    def __init__(self, total_count=1, probs=None, logits=None):
        self._categorical = Categorical(probs=probs, logits=logits)
        self.total_count = total_count
        super().__init__(self._categorical.batch_shape, (self._categorical._num_events,))

    @property
    def support(self):  # type: ignore[override]
        return constraints.multinomial(self.total_count)

    @property
    def probs(self):
        return self._categorical.probs

    @property
    def logits(self):
        return self._categorical.logits

    def sample(self, generator=None, sample_shape=()):
        if not isinstance(self.total_count, int):
            raise ValueError("Multinomial.sample needs a Python int total_count")
        idx = self._categorical.sample(generator, (self.total_count,) + tuple(sample_shape))
        return F.one_hot(idx, self._categorical._num_events).to(self.probs.dtype).sum(0)

    def log_prob(self, value):
        return (
            torch.lgamma(value.sum(-1) + 1) - torch.lgamma(value + 1).sum(-1) + (value * self.logits).sum(-1)
        )

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def expand(self, batch_shape, _instance=None):
        batch_shape, n = tuple(batch_shape), self._categorical._num_events
        if self._categorical._probs is not None:
            return Multinomial(self.total_count, probs=self._categorical._probs.expand(batch_shape + (n,)))
        return Multinomial(self.total_count, logits=self._categorical._logits.expand(batch_shape + (n,)))


class Poisson(Distribution):
    arg_constraints = {"rate": constraints.positive}
    support = constraints.nonnegative_integer
    is_discrete = True

    def __init__(self, rate, *, is_sparse=False):
        self.rate = as_float(rate)
        self.is_sparse = is_sparse
        super().__init__(self.rate.shape)

    def sample(self, generator=None, sample_shape=()):
        return torch.poisson(self.rate.detach().expand(self.shape(sample_shape)), generator=generator)

    def log_prob(self, value):
        return value * torch.log(self.rate) - self.rate - torch.lgamma(value + 1)

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate

    def expand(self, batch_shape, _instance=None):
        return Poisson(self.rate.expand(tuple(batch_shape)))


class Geometric(_ProbsOrLogits):
    """Failures before the first success."""

    arg_constraints = {"probs": constraints.unit_interval, "logits": constraints.real}
    support = constraints.nonnegative_integer
    is_discrete = True

    def __init__(self, probs=None, logits=None):
        super().__init__(self._set_probs_or_logits(probs, logits).shape)

    def sample(self, generator=None, sample_shape=()):
        probs = self.probs.detach()
        u = _uniform(self.shape(sample_shape), probs, generator).clamp(min=torch.finfo(probs.dtype).tiny)
        return torch.floor(torch.log(u) / torch.log1p(-clamp_probs(probs)))

    def log_prob(self, value):
        p = clamp_probs(self.probs)
        return value * torch.log1p(-p) + torch.log(p)

    @property
    def mean(self):
        return (1 - self.probs) / self.probs

    @property
    def variance(self):
        return (1 - self.probs) / self.probs**2

    def expand(self, batch_shape, _instance=None):
        return Geometric(**self._expanded(tuple(batch_shape)))


class NegativeBinomial(_ProbsOrLogits):
    """Successes (each with probability ``probs``) before ``total_count``
    failures."""

    arg_constraints = {"total_count": constraints.positive, "probs": constraints.unit_interval,
                       "logits": constraints.real}
    support = constraints.nonnegative_integer
    is_discrete = True

    def __init__(self, total_count, probs=None, logits=None):
        param = self._set_probs_or_logits(probs, logits, _count_device(total_count, probs, logits))
        self.total_count = as_float(total_count, param.device)
        super().__init__(broadcast_shape(self.total_count.shape, param.shape))

    def sample(self, generator=None, sample_shape=()):
        from .multivariate import _standard_gamma

        shape = self.shape(sample_shape)
        with torch.no_grad():
            p = clamp_probs(self.probs.expand(shape))
            rate = _standard_gamma(self.total_count.to(p.dtype).expand(shape), generator) * (p / (1 - p))
            return torch.poisson(rate, generator=generator)

    def log_prob(self, value):
        n, p = self.total_count, clamp_probs(self.probs)
        return -log_beta(n, value + 1.0) - torch.log(n + value) + n * torch.log1p(-p) + value * torch.log(p)

    @property
    def mean(self):
        p = self.probs
        return self.total_count * p / (1 - p)

    @property
    def variance(self):
        p = self.probs
        return self.total_count * p / (1 - p) ** 2

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return NegativeBinomial(self.total_count.expand(batch_shape), **self._expanded(batch_shape))
