"""Distribution base classes (counterpart of
``pyro_tpu/distributions/distribution.py``).

Shapes follow the torch.distributions contract: ``batch_shape`` +
``event_shape``, with ``expand``/``to_event``/``mask`` wrappers and
``TransformedDistribution``.  Sampling
takes an optional ``torch.Generator``: ``d.sample(generator, sample_shape)``,
also reachable as ``d(rng_key=generator, sample_shape=...)`` from the effect
runtime.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import constraints
from .score_parts import ScoreParts
from .util import broadcast_shape, sum_rightmost


class Distribution:
    arg_constraints: Dict[str, constraints.Constraint] = {}
    support: constraints.Constraint = constraints.real
    has_rsample = False
    has_enumerate_support = False
    is_discrete = False

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return self._batch_shape

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return self._event_shape

    @property
    def event_dim(self) -> int:
        return len(self.event_shape)

    def shape(self, sample_shape=()) -> Tuple[int, ...]:
        return tuple(sample_shape) + self.batch_shape + self.event_shape

    def __call__(self, *args, rng_key=None, sample_shape=(), **kwargs):
        return self.sample(rng_key, sample_shape)

    def sample(self, generator=None, sample_shape=()):
        if self.has_rsample:
            return self.rsample(generator, sample_shape)
        with torch.no_grad():
            return self.rsample(generator, sample_shape)

    def rsample(self, generator=None, sample_shape=()):
        raise NotImplementedError(f"{type(self).__name__} is not reparameterizable")

    def log_prob(self, value):
        raise NotImplementedError

    def score_parts(self, value, *args, **kwargs) -> ScoreParts:
        log_prob = self.log_prob(value, *args, **kwargs)
        if self.has_rsample:
            return ScoreParts(log_prob, 0, log_prob)
        return ScoreParts(log_prob, log_prob, 0)

    def expand(self, batch_shape, _instance=None) -> "Distribution":
        batch_shape = tuple(batch_shape)
        if batch_shape == self.batch_shape:
            return self
        return ExpandedDistribution(self, batch_shape)

    def to_event(self, reinterpreted_batch_ndims: Optional[int] = None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self.batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self, reinterpreted_batch_ndims)

    def mask(self, mask) -> "Distribution":
        if mask is True:
            return self
        return MaskedDistribution(self, mask)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(batch_shape={self.batch_shape}, event_shape={self.event_shape})"


class Independent(Distribution):
    """Reinterpret rightmost batch dims as event dims."""

    def __init__(self, base_dist: Distribution, reinterpreted_batch_ndims: int):
        if reinterpreted_batch_ndims > len(base_dist.batch_shape):
            raise ValueError(
                f"cannot reinterpret {reinterpreted_batch_ndims} dims of batch_shape {base_dist.batch_shape}"
            )
        self.base_dist = base_dist
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        shape = base_dist.batch_shape + base_dist.event_shape
        event_ndim = len(base_dist.event_shape) + reinterpreted_batch_ndims
        super().__init__(shape[: len(shape) - event_ndim], shape[len(shape) - event_ndim:])

    @property
    def has_rsample(self):  # type: ignore[override]
        return self.base_dist.has_rsample

    @property
    def support(self):  # type: ignore[override]
        return constraints.independent(self.base_dist.support, self.reinterpreted_batch_ndims)

    def sample(self, generator=None, sample_shape=()):
        return self.base_dist.sample(generator, sample_shape)

    def rsample(self, generator=None, sample_shape=()):
        return self.base_dist.rsample(generator, sample_shape)

    def log_prob(self, value):
        return sum_rightmost(self.base_dist.log_prob(value), self.reinterpreted_batch_ndims)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        n = len(self.base_dist.batch_shape) - self.reinterpreted_batch_ndims
        base = self.base_dist.expand(batch_shape + self.base_dist.batch_shape[n:])
        return Independent(base, self.reinterpreted_batch_ndims)

    def to_event(self, reinterpreted_batch_ndims=None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self.batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self.base_dist, self.reinterpreted_batch_ndims + reinterpreted_batch_ndims)


class MaskedDistribution(Distribution):
    """Zero the log_prob of masked-out elements; ``mask`` broadcasts to
    ``batch_shape``."""

    def __init__(self, base_dist: Distribution, mask):
        self.base_dist = base_dist
        if isinstance(mask, bool):
            self._mask = mask
            batch_shape = base_dist.batch_shape
        else:
            mask = torch.as_tensor(mask)
            batch_shape = broadcast_shape(mask.shape, base_dist.batch_shape)
            self._mask = mask.bool().expand(batch_shape)
        super().__init__(batch_shape, base_dist.event_shape)

    @property
    def has_rsample(self):  # type: ignore[override]
        return self.base_dist.has_rsample

    @property
    def has_enumerate_support(self):  # type: ignore[override]
        return self.base_dist.has_enumerate_support

    @property
    def support(self):  # type: ignore[override]
        return self.base_dist.support

    def sample(self, generator=None, sample_shape=()):
        return self.base_dist.expand(self.batch_shape).sample(generator, sample_shape)

    def enumerate_support(self, expand=True):
        return self.base_dist.enumerate_support(expand=expand)

    def rsample(self, generator=None, sample_shape=()):
        return self.base_dist.expand(self.batch_shape).rsample(generator, sample_shape)

    def log_prob(self, value):
        if self._mask is False:
            shape = broadcast_shape(self.batch_shape, value.shape[: max(0, value.ndim - self.event_dim)])
            return torch.zeros(shape, device=value.device)
        if self._mask is True:
            return self.base_dist.log_prob(value)
        lp = self.base_dist.expand(self.batch_shape).log_prob(value)
        return torch.where(self._mask, lp, 0.0)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        mask = self._mask if isinstance(self._mask, bool) else self._mask.expand(batch_shape)
        return MaskedDistribution(self.base_dist.expand(batch_shape), mask)


class ExpandedDistribution(Distribution):
    """Broadcast a distribution to a larger batch_shape."""

    def __init__(self, base_dist: Distribution, batch_shape=()):
        batch_shape = tuple(batch_shape)
        broadcast_shape(batch_shape, base_dist.batch_shape)
        if len(batch_shape) < len(base_dist.batch_shape):
            raise ValueError(f"cannot expand {base_dist.batch_shape} to smaller {batch_shape}")
        self.base_dist = base_dist
        super().__init__(batch_shape, base_dist.event_shape)

    @property
    def has_rsample(self):  # type: ignore[override]
        return self.base_dist.has_rsample

    @property
    def has_enumerate_support(self):  # type: ignore[override]
        return self.base_dist.has_enumerate_support

    @property
    def support(self):  # type: ignore[override]
        return self.base_dist.support

    @property
    def is_discrete(self):  # type: ignore[override]
        return self.base_dist.is_discrete

    def _draw(self, draw, sample_shape):
        # draw the extra leading batch dims so samples are i.i.d. across the
        # expanded batch, then broadcast base dims of size 1
        n = len(self.batch_shape) - len(self.base_dist.batch_shape)
        extra = self.batch_shape[:n] if self.base_dist.batch_shape else self.batch_shape
        samp = draw(tuple(sample_shape) + tuple(extra))
        target = tuple(sample_shape) + self.batch_shape + self.event_shape
        return samp.expand(broadcast_shape(samp.shape, target))

    def sample(self, generator=None, sample_shape=()):
        return self._draw(lambda s: self.base_dist.sample(generator, s), sample_shape)

    def enumerate_support(self, expand=True):
        support = self.base_dist.enumerate_support(expand=False)
        n = support.shape[0]
        support = support.reshape((n,) + (1,) * len(self.batch_shape) + self.event_shape)
        if expand:
            support = support.expand((n,) + self.batch_shape + self.event_shape)
        return support

    def rsample(self, generator=None, sample_shape=()):
        return self._draw(lambda s: self.base_dist.rsample(generator, s), sample_shape)

    def _batch_of(self, value):
        return broadcast_shape(self.batch_shape, value.shape[: max(0, value.ndim - self.event_dim)])

    def log_prob(self, value):
        return self.base_dist.log_prob(value).expand(self._batch_of(value))

    def score_parts(self, value, *args, **kwargs):
        parts = self.base_dist.score_parts(value, *args, **kwargs)
        shape = self._batch_of(value)
        return ScoreParts(*(p if isinstance(p, int) else p.expand(shape) for p in parts))

    def expand(self, batch_shape, _instance=None):
        return ExpandedDistribution(self.base_dist, tuple(batch_shape))


class TransformedDistribution(Distribution):
    """A base distribution pushed through ``transforms`` in order (one
    ``Transform`` or a list); ``log_prob`` inverts them and adds each
    ``-log|det J|`` summed over the event dims it covers."""

    arg_constraints: Dict[str, constraints.Constraint] = {}

    def __init__(self, base_distribution: Distribution, transforms):
        from .transforms import Transform

        self.transforms = [transforms] if isinstance(transforms, Transform) else list(transforms)
        shape = base_distribution.shape()
        event_dim = base_distribution.event_dim
        for t in self.transforms:
            shape = t.forward_shape(shape)
            event_dim = max(event_dim, t.domain.event_dim) + t.codomain.event_dim - t.domain.event_dim
        cut = len(shape) - event_dim
        self.base_dist = base_distribution
        super().__init__(shape[:cut], shape[cut:])

    @property
    def has_rsample(self):  # type: ignore[override]
        return self.base_dist.has_rsample

    @property
    def support(self):  # type: ignore[override]
        if not self.transforms:
            return self.base_dist.support
        support = self.transforms[-1].codomain
        if self.event_dim > support.event_dim:
            support = constraints.independent(support, self.event_dim - support.event_dim)
        return support

    def _push(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def sample(self, generator=None, sample_shape=()):
        return self._push(self.base_dist.sample(generator, sample_shape))

    def rsample(self, generator=None, sample_shape=()):
        return self._push(self.base_dist.rsample(generator, sample_shape))

    def log_prob(self, value):
        event_dim = self.event_dim
        lp = 0.0
        y = value
        for t in reversed(self.transforms):
            x = t._inverse(y)
            event_dim += t.domain.event_dim - t.codomain.event_dim
            lp = lp - sum_rightmost(t.log_abs_det_jacobian(x, y), event_dim - t.domain.event_dim)
            y = x
        return lp + sum_rightmost(self.base_dist.log_prob(y), event_dim - self.base_dist.event_dim)

    def expand(self, batch_shape, _instance=None):
        # the transforms act on event dims: leading batch dims expand, the
        # base's batch dims absorbed into the event stay
        batch_shape = tuple(batch_shape)
        base = self.base_dist.expand(batch_shape + self.base_dist.batch_shape[len(self.batch_shape):])
        return TransformedDistribution(base, self.transforms)
