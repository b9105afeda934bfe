"""Analytic KL divergences (counterpart of ``pyro_tpu/distributions/kl.py``):
``register_kl(type_p, type_q)`` records a rule, ``kl_divergence(p, q)``
applies the most specific one (the least summed MRO distance of the two
types), whatever the order of registration."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

import torch
import torch.nn.functional as F

from .continuous import Beta, Exponential, Gamma, LogNormal, Normal, Uniform
from .delta import Delta
from .discrete import Bernoulli, Categorical, Geometric, Poisson
from .distribution import Distribution, Independent, MaskedDistribution
from .multivariate import Dirichlet, MultivariateNormal
from .util import scale_and_mask, sum_rightmost

_KL_REGISTRY: Dict[Tuple[Type, Type], Callable] = {}


def register_kl(type_p, type_q):
    def decorator(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn

    return decorator


def kl_divergence(p: Distribution, q: Distribution):
    best, best_score = None, None
    for (tp, tq), fn in _KL_REGISTRY.items():
        if isinstance(p, tp) and isinstance(q, tq):
            score = type(p).__mro__.index(tp) + type(q).__mro__.index(tq)
            if best is None or score < best_score:
                best, best_score = fn, score
    if best is None:
        raise NotImplementedError(f"no KL({type(p).__name__} || {type(q).__name__}) registered")
    return best(p, q)


@register_kl(MaskedDistribution, MaskedDistribution)
def _kl_masked_masked(p, q):
    """KL under the AND of both masks; pairs masked out give exactly 0."""
    if p._mask is False or q._mask is False:
        return 0.0
    if p._mask is True:
        mask = q._mask
    elif q._mask is True or p._mask is q._mask:
        mask = p._mask
    else:
        mask = p._mask & q._mask
    kl = kl_divergence(p.base_dist, q.base_dist)
    return kl if mask is True else scale_and_mask(kl, mask=mask)


@register_kl(Independent, Independent)
def _kl_independent(p, q):
    if p.reinterpreted_batch_ndims != q.reinterpreted_batch_ndims:
        raise NotImplementedError
    return sum_rightmost(kl_divergence(p.base_dist, q.base_dist), p.reinterpreted_batch_ndims)


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    t1 = p.probs * (F.softplus(-q.logits) - F.softplus(-p.logits))
    t2 = (1 - p.probs) * (F.softplus(q.logits) - F.softplus(p.logits))
    return t1 + t2


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    t = p.probs * (p.logits - q.logits)
    return torch.where(p.probs == 0, 0.0, t).sum(-1)


@register_kl(Gamma, Gamma)
def _kl_gamma(p, q):
    t1 = q.concentration * (torch.log(p.rate) - torch.log(q.rate))
    t2 = torch.lgamma(q.concentration) - torch.lgamma(p.concentration)
    t3 = (p.concentration - q.concentration) * torch.digamma(p.concentration)
    t4 = (q.rate - p.rate) * (p.concentration / p.rate)
    return t1 + t2 + t3 + t4


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    sum_p = p.concentration1 + p.concentration0
    sum_q = q.concentration1 + q.concentration0
    t1 = torch.lgamma(sum_p) - torch.lgamma(p.concentration1) - torch.lgamma(p.concentration0)
    t2 = -torch.lgamma(sum_q) + torch.lgamma(q.concentration1) + torch.lgamma(q.concentration0)
    t3 = (p.concentration1 - q.concentration1) * torch.digamma(p.concentration1)
    t4 = (p.concentration0 - q.concentration0) * torch.digamma(p.concentration0)
    t5 = -(sum_p - sum_q) * torch.digamma(sum_p)
    return t1 + t2 + t3 + t4 + t5


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    sum_p = p.concentration.sum(-1)
    t1 = torch.lgamma(sum_p) - torch.lgamma(q.concentration.sum(-1))
    t2 = (torch.lgamma(q.concentration) - torch.lgamma(p.concentration)).sum(-1)
    t3 = ((p.concentration - q.concentration) * (torch.digamma(p.concentration) - torch.digamma(sum_p)[..., None])).sum(-1)
    return t1 + t2 + t3


@register_kl(MultivariateNormal, MultivariateNormal)
def _kl_mvn(p, q):
    n = p.event_shape[0]
    p_L, q_L = p.scale_tril, q.scale_tril
    half_logdet = (torch.log(q_L.diagonal(dim1=-2, dim2=-1)).sum(-1)
                   - torch.log(p_L.diagonal(dim1=-2, dim2=-1)).sum(-1))
    # tr(Sigma_q^-1 Sigma_p) = || q_L^-1 p_L ||_F^2
    shape = torch.broadcast_shapes(p_L.shape, q_L.shape)
    M = torch.linalg.solve_triangular(q_L.expand(shape), p_L.expand(shape), upper=False)
    diff = q.loc - p.loc
    y = torch.linalg.solve_triangular(q_L.expand(diff.shape + (n,)), diff[..., None], upper=False)[..., 0]
    return half_logdet + 0.5 * ((M**2).sum((-2, -1)) + (y**2).sum(-1) - n)


@register_kl(Exponential, Exponential)
def _kl_exponential(p, q):
    return torch.log(p.rate) - torch.log(q.rate) + q.rate / p.rate - 1.0


@register_kl(Poisson, Poisson)
def _kl_poisson(p, q):
    return p.rate * (torch.log(p.rate) - torch.log(q.rate)) - p.rate + q.rate


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    # infinite where p's support is not within q's
    result = torch.log(q.high - q.low) - torch.log(p.high - p.low)
    return torch.where((q.low <= p.low) & (p.high <= q.high), result, torch.inf)


@register_kl(LogNormal, LogNormal)
def _kl_lognormal(p, q):
    # the shared exp leaves the KL of the base Normals
    return _kl_normal_normal(p, q)


@register_kl(Geometric, Geometric)
def _kl_geometric(p, q):
    mean = (1.0 - p.probs) / p.probs
    return mean * (torch.log1p(-p.probs) - torch.log1p(-q.probs)) + torch.log(p.probs) - torch.log(q.probs)


@register_kl(Delta, Distribution)
def _kl_delta(p, q):
    return -q.log_prob(p.v) + p.log_density


@register_kl(Distribution, Distribution)
def _kl_fallback(p, q):
    raise NotImplementedError(f"no KL({type(p).__name__} || {type(q).__name__}) registered")
