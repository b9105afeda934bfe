"""Dirichlet, MultivariateNormal and LowRankMultivariateNormal
(counterpart of the part of ``pyro_tpu/distributions/multivariate.py`` this
package uses)."""

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


class LowRankMultivariateNormal(Distribution):
    """An MVN with covariance ``cov_factor @ cov_factor.T + diag(cov_diag)``,
    scored by the Woodbury identity and the matrix determinant lemma through
    the Cholesky factor of the capacitance ``I + W^T D^-1 W`` (rank x rank).
    Draws take a ``torch.Generator``."""

    arg_constraints = {
        "loc": constraints.real_vector,
        "cov_factor": constraints.independent(constraints.real, 2),
        "cov_diag": constraints.independent(constraints.positive, 1),
    }
    support = constraints.real_vector
    has_rsample = True

    def __init__(self, loc, cov_factor, cov_diag):
        loc = as_float(loc, device=cov_factor.device)
        event_shape = loc.shape[-1:]
        batch_shape = broadcast_shape(loc.shape[:-1], cov_factor.shape[:-2], cov_diag.shape[:-1])
        self.loc = loc.expand(batch_shape + event_shape)
        self.cov_factor = cov_factor.expand(batch_shape + cov_factor.shape[-2:])
        self.cov_diag = cov_diag.expand(batch_shape + event_shape)
        super().__init__(batch_shape, event_shape)

    @lazy_property
    def _capacitance_tril(self):
        W = self.cov_factor
        K = W.transpose(-1, -2) @ (W / self.cov_diag.unsqueeze(-1))
        return torch.linalg.cholesky(K + torch.eye(K.shape[-1], dtype=K.dtype, device=K.device))

    def rsample(self, generator=None, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        like = dict(generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        eps_W = torch.randn(shape + self.cov_factor.shape[-1:], **like)
        eps_D = torch.randn(shape + self.event_shape, **like)
        return self.loc + (self.cov_factor @ eps_W.unsqueeze(-1)).squeeze(-1) + self.cov_diag.sqrt() * eps_D

    def log_prob(self, value):
        diff = value - self.loc
        Dinv_diff = diff / self.cov_diag
        Wt_Dinv_diff = (self.cov_factor * Dinv_diff.unsqueeze(-1)).sum(-2)
        Ct = self._capacitance_tril
        batch = torch.broadcast_shapes(Ct.shape[:-2], Wt_Dinv_diff.shape[:-1])
        r = Ct.shape[-1]
        y = torch.linalg.solve_triangular(
            Ct.expand(batch + (r, r)), Wt_Dinv_diff.expand(batch + (r,)).unsqueeze(-1), upper=False
        ).squeeze(-1)
        mahalanobis = (diff * Dinv_diff).sum(-1) - (y**2).sum(-1)
        log_det = self.cov_diag.log().sum(-1) + 2 * Ct.diagonal(dim1=-2, dim2=-1).log().sum(-1)
        return -0.5 * (self.event_shape[0] * math.log(2 * math.pi) + log_det + mahalanobis)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return (self.cov_factor**2).sum(-1) + self.cov_diag

    @lazy_property
    def covariance_matrix(self):
        W = self.cov_factor
        return W @ W.transpose(-1, -2) + torch.diag_embed(self.cov_diag)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        n, r = self.cov_factor.shape[-2:]
        return LowRankMultivariateNormal(
            self.loc.expand(batch_shape + (n,)), self.cov_factor.expand(batch_shape + (n, r)),
            self.cov_diag.expand(batch_shape + (n,)),
        )
