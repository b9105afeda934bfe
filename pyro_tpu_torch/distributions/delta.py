"""Delta, a point mass used by AutoDelta guides and ``deterministic``
sites, Unit, the site of ``factor``, and ImproperUniform, a flat density
over a support (counterpart of ``pyro_tpu/distributions/delta.py``)."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .util import sum_rightmost


class Delta(Distribution):
    """Point mass at ``v`` with optional importance weight ``log_density``."""

    arg_constraints = {"v": constraints.dependent, "log_density": constraints.real}
    has_rsample = True

    def __init__(self, v, log_density=0.0, event_dim=0):
        v = torch.as_tensor(v)
        if event_dim > v.ndim:
            raise ValueError(f"expected event_dim <= v.ndim, got {event_dim} > {v.ndim}")
        batch_dim = v.ndim - event_dim
        batch_shape = v.shape[:batch_dim]
        self.v = v
        dtype = v.dtype if v.is_floating_point() else torch.get_default_dtype()
        if isinstance(log_density, torch.Tensor):
            log_density = log_density.to(dtype)
        else:
            # a fill, not a copy from the host, which would wait for the device
            log_density = torch.full((), float(log_density), dtype=dtype, device=v.device)
        self.log_density = log_density.expand(batch_shape)
        self._event_dim_arg = event_dim
        super().__init__(batch_shape, v.shape[batch_dim:])

    @property
    def support(self):  # type: ignore[override]
        if self.event_dim:
            return constraints.independent(constraints.real, self.event_dim)
        return constraints.real

    def rsample(self, generator=None, sample_shape=()):
        return self.v.expand(self.shape(sample_shape))

    def log_prob(self, value):
        shape = torch.broadcast_shapes(self.v.shape, value.shape)
        v = self.v.expand(shape)
        value = value.expand(shape)
        lp = torch.where(value == v, 0.0, -torch.inf).to(self.log_density.dtype)
        return sum_rightmost(lp, self._event_dim_arg) + self.log_density


class Unit(Distribution):
    """The trivial distribution over the empty tensor, carrying
    ``log_factor`` as its log density: the site of ``pyro.factor``."""

    arg_constraints = {"log_factor": constraints.real}
    support = constraints.real

    def __init__(self, log_factor, *, has_rsample=None):
        log_factor = torch.as_tensor(log_factor)
        self.log_factor = log_factor if log_factor.is_floating_point() else log_factor.to(torch.get_default_dtype())
        if has_rsample is not None:
            self.has_rsample = has_rsample
        super().__init__(self.log_factor.shape, (0,))

    def sample(self, generator=None, sample_shape=()):
        return self.log_factor.new_zeros(self.shape(sample_shape))

    def rsample(self, generator=None, sample_shape=()):
        return self.log_factor.new_zeros(self.shape(sample_shape))

    def log_prob(self, value):
        shape = torch.broadcast_shapes(self.batch_shape, value.shape[:-1])
        return self.log_factor.expand(shape)

    def expand(self, batch_shape, _instance=None):
        return Unit(self.log_factor.expand(tuple(batch_shape)))


class ImproperUniform(Distribution):
    """A log density of 0 over ``support`` that cannot be sampled: a prior
    where only the support matters, as in MAP or MCMC models whose site is
    scored by other factors."""

    arg_constraints = {}

    def __init__(self, support, batch_shape, event_shape):
        self._support = support
        super().__init__(tuple(batch_shape), tuple(event_shape))

    @property
    def support(self):  # type: ignore[override]
        return self._support

    def sample(self, generator=None, sample_shape=()):
        raise NotImplementedError(
            "ImproperUniform.sample is undefined; use a proper prior or condition this site"
        )

    def log_prob(self, value):
        return value.new_zeros(value.shape[: value.ndim - self.event_dim])

    def expand(self, batch_shape, _instance=None):
        return ImproperUniform(self._support, tuple(batch_shape), self.event_shape)
