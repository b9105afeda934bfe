"""Dirichlet and MultivariateNormal (counterpart of the part of
``pyro_tpu/distributions/multivariate.py`` this package uses)."""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution
from .util import as_float, broadcast_shape, clamp_probs, lazy_property


def _standard_gamma(concentration, generator):
    """Gamma(concentration, 1) draws.  PyTorch's gamma sampler takes no
    generator, so a seed drawn from ``generator`` seeds it inside a forked
    global RNG state."""
    if generator is None:
        return torch._standard_gamma(concentration)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
    devices = [concentration.device] if concentration.is_cuda else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        return torch._standard_gamma(concentration)


class Dirichlet(Distribution):
    arg_constraints = {"concentration": constraints.independent(constraints.positive, 1)}
    support = constraints.simplex
    has_rsample = True

    def __init__(self, concentration):
        self.concentration = as_float(concentration)
        super().__init__(self.concentration.shape[:-1], self.concentration.shape[-1:])

    def rsample(self, generator=None, sample_shape=()):
        g = _standard_gamma(self.concentration.expand(self.shape(sample_shape)), generator)
        return clamp_probs(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        a = self.concentration
        return ((a - 1) * torch.log(value)).sum(-1) + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1)


def _tril_inverse(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


class MultivariateNormal(Distribution):
    """Given exactly one of ``covariance_matrix``, ``precision_matrix`` and
    ``scale_tril``.  Draws take a ``torch.Generator``."""

    arg_constraints = {"loc": constraints.real_vector}
    support = constraints.real_vector
    has_rsample = True

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None, scale_tril=None):
        given = [x for x in (covariance_matrix, precision_matrix, scale_tril) if x is not None]
        if len(given) != 1:
            raise ValueError("specify exactly one of covariance_matrix, precision_matrix, scale_tril")
        loc = torch.as_tensor(loc, dtype=given[0].dtype, device=given[0].device)
        if loc.ndim < 1:
            loc = loc[None]
        batch_shape = broadcast_shape(loc.shape[:-1], given[0].shape[:-2])
        event_shape = loc.shape[-1:]
        self.loc = loc.expand(batch_shape + event_shape)
        if scale_tril is not None:
            self._unbroadcast_scale_tril = scale_tril
        elif covariance_matrix is not None:
            self._unbroadcast_scale_tril = torch.linalg.cholesky_ex(covariance_matrix).L
        else:
            # Sigma = P^-1 = Linv^T Linv with P = Lp Lp^T, Linv = Lp^-1
            Linv = _tril_inverse(torch.linalg.cholesky_ex(precision_matrix).L)
            self._unbroadcast_scale_tril = torch.linalg.cholesky_ex(Linv.transpose(-1, -2) @ Linv).L
        super().__init__(batch_shape, event_shape)

    @lazy_property
    def scale_tril(self):
        n = self.event_shape[0]
        return self._unbroadcast_scale_tril.expand(self.batch_shape + (n, n))

    @lazy_property
    def covariance_matrix(self):
        L = self.scale_tril
        return L @ L.transpose(-1, -2)

    @lazy_property
    def precision_matrix(self):
        Linv = _tril_inverse(self.scale_tril)
        return Linv.transpose(-1, -2) @ Linv

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return (self.scale_tril**2).sum(-1)

    def rsample(self, generator=None, sample_shape=()):
        eps = torch.randn(self.shape(sample_shape), generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + (self.scale_tril @ eps.unsqueeze(-1)).squeeze(-1)

    def log_prob(self, value):
        diff = value - self.loc
        batch = torch.broadcast_shapes(self.scale_tril.shape[:-2], diff.shape[:-1])
        n = self.event_shape[0]
        L = self.scale_tril.expand(batch + (n, n))
        y = torch.linalg.solve_triangular(L, diff.expand(batch + (n,)).unsqueeze(-1), upper=False).squeeze(-1)
        half_log_det = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (n * math.log(2 * math.pi) + (y**2).sum(-1)) - half_log_det

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        n = self.event_shape[0]
        return MultivariateNormal(
            self.loc.expand(batch_shape + (n,)),
            scale_tril=self._unbroadcast_scale_tril.expand(batch_shape + (n, n)),
        )
