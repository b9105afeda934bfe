"""Epidemiology distribution helpers (counterpart of
``pyro_tpu/contrib/epidemiology/distributions.py``).

Inside :func:`set_relaxed_distributions` the count distributions that
:func:`binomial_dist`, :func:`beta_binomial_dist`, :func:`poisson_dist`,
:func:`negative_binomial_dist` and :func:`infection_dist` return become
moment-matched Normals with a variance floor: real-valued, reparametrised
and smooth, which makes the relaxed ``fit_svi`` and ``fit_mcmc``
tractable over continuous flows.  Outside it they are the exact count
distributions, the Binomials extended with -inf outside their support.

Python numbers become 0-dim fills on the device of the tensors they meet
(``_tensors``): ``torch.as_tensor`` of a number would copy it from the
host, which a captured NUTS leaf refuses.
"""

from __future__ import annotations

import numbers
from contextlib import contextmanager

import torch

from ... import distributions as dist
from ...settings import get_default_device

_RELAX = False
_RELAX_MIN_VARIANCE = 0.1


def _tensors(*values):
    """``values`` as float tensors: a tensor keeps its device (and a
    floating dtype), a number becomes a fill on the device and dtype of
    the first tensor among them (the package's device and default dtype if
    there is none)."""
    like = next((v for v in values if isinstance(v, torch.Tensor)), None)
    device = like.device if like is not None else get_default_device()
    dtype = like.dtype if like is not None and like.is_floating_point() else torch.get_default_dtype()
    return [
        (v if v.is_floating_point() else v.to(dtype)) if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=dtype, device=device)
        for v in values
    ]


@contextmanager
def set_approx_sample_thresh(thresh):
    """Set ``Binomial.approx_sample_thresh`` for the block (API parity: the
    port's Binomial draws exactly with ``torch.binomial`` at any count)."""
    assert thresh > 0
    old = getattr(dist.Binomial, "approx_sample_thresh", float("inf"))
    try:
        dist.Binomial.approx_sample_thresh = thresh
        yield
    finally:
        dist.Binomial.approx_sample_thresh = old


@contextmanager
def set_approx_log_prob_tol(tol):
    """Set ``Binomial.approx_log_prob_tol`` for the block (API parity: the
    Binomial's log density is exact, through lgamma)."""
    assert tol >= 0
    old = getattr(dist.Binomial, "approx_log_prob_tol", 0.0)
    try:
        dist.Binomial.approx_log_prob_tol = tol
        yield
    finally:
        dist.Binomial.approx_log_prob_tol = old


@contextmanager
def set_relaxed_distributions(relaxed: bool = True):
    """Make the helpers return their relaxed Normals inside the block."""
    global _RELAX
    old = _RELAX
    try:
        _RELAX = relaxed
        yield
    finally:
        _RELAX = old


def _validate_overdispersion(overdispersion):
    """A literal overdispersion must lie in [0, 2).  A tensor is not read:
    that would wait for the device, inside the potential's hot loop."""
    if isinstance(overdispersion, numbers.Number) and not 0 <= overdispersion < 2:
        raise ValueError(f"Expected 0 <= overdispersion < 2, got {overdispersion}")


def _nonzero(x) -> bool:
    """True unless ``x`` is a literal zero: a tensor overdispersion always
    takes the overdispersed path, which is smooth as it goes to 0."""
    return not isinstance(x, numbers.Number) or x != 0


def _relaxed_binomial(total_count, probs):
    """The moment-matched Normal, which allows a real total_count."""
    total_count, probs = torch.broadcast_tensors(*_tensors(total_count, probs))
    mean = probs * total_count
    variance = total_count * probs * (1 - probs)
    return dist.Normal(mean, torch.sqrt(variance.clamp(min=_RELAX_MIN_VARIANCE)))


def _relaxed_beta_binomial(concentration1, concentration0, total_count):
    """The moment-matched Normal of a BetaBinomial."""
    concentration1, concentration0, total_count = torch.broadcast_tensors(
        *_tensors(concentration1, concentration0, total_count))
    c = concentration1 + concentration0
    beta_mean = concentration1 / c
    beta_variance = concentration1 * concentration0 / (c * c * (c + 1))
    mean = beta_mean * total_count
    variance = beta_variance * total_count * (c + total_count)
    return dist.Normal(mean, torch.sqrt(variance.clamp(min=_RELAX_MIN_VARIANCE)))


def binomial_dist(total_count, probs, *, overdispersion=0.0):
    """Binomial, or BetaBinomial if overdispersed, each extended with -inf
    outside its support; their moment-matched Normal in relaxed mode."""
    _validate_overdispersion(overdispersion)
    if not _nonzero(overdispersion):
        if _RELAX:
            return _relaxed_binomial(total_count, probs)
        total_count, probs = _tensors(total_count, probs)
        return dist.ExtendedBinomial(total_count, probs=probs)
    total_count, probs, od = _tensors(total_count, probs, overdispersion)
    p = probs.clamp(1e-6, 1 - 1e-6)
    c = 1.0 / od.clamp(min=1e-4) ** 2
    concentration1 = p * c
    concentration0 = (1 - p) * c
    if _RELAX:
        return _relaxed_beta_binomial(concentration1, concentration0, total_count)
    return dist.ExtendedBetaBinomial(concentration1, concentration0, total_count)


def beta_binomial_dist(concentration1, concentration0, total_count, *, overdispersion=0.0):
    """BetaBinomial, or its moment-matched Normal in relaxed mode."""
    _validate_overdispersion(overdispersion)
    if _RELAX:
        return _relaxed_beta_binomial(concentration1, concentration0, total_count)
    return dist.BetaBinomial(*_tensors(concentration1, concentration0, total_count))


def poisson_dist(rate, *, overdispersion=0.0):
    """Poisson, or GammaPoisson if overdispersed; the moment-matched
    Normal in relaxed mode."""
    _validate_overdispersion(overdispersion)
    rate, od = _tensors(rate, overdispersion)
    if _RELAX:
        var = rate * (1 + od**2 * rate)
        return dist.Normal(rate, torch.sqrt(var.clamp(min=_RELAX_MIN_VARIANCE)))
    if not _nonzero(overdispersion):
        return dist.Poisson(rate)
    c = 1.0 / od.clamp(min=1e-4) ** 2
    return dist.GammaPoisson(c, c / rate)


def negative_binomial_dist(concentration, probs=None, *, logits=None, overdispersion=0.0):
    """NegativeBinomial, or its moment-matched Normal in relaxed mode."""
    if _RELAX:
        if logits is None:
            concentration, probs = _tensors(concentration, probs)
            logits = torch.log(probs) - torch.log1p(-probs)
        concentration, logits = _tensors(concentration, logits)
        mean = concentration * torch.exp(logits)
        var = mean / (1 - torch.sigmoid(logits)).clamp(min=1e-6)
        return dist.Normal(mean, torch.sqrt(var.clamp(min=_RELAX_MIN_VARIANCE)))
    if logits is None:
        concentration, probs = _tensors(concentration, probs)
    else:
        concentration, logits = _tensors(concentration, logits)
    return dist.NegativeBinomial(concentration, probs=probs, logits=logits)


def infection_dist(
    *,
    individual_rate,
    num_infectious,
    num_susceptible,
    population,
    concentration=float("inf"),
    overdispersion=0.0,
):
    """The distribution of new infections in one step:

    - ``concentration=inf`` (a literal): the Poisson-contact limit,
      Binomial(S, 1 - exp(-R I / N)) (or its overdispersed or relaxed
      variants);
    - a finite ``concentration`` k: superspreading, each infectious
      individual infecting NegativeBinomial-many others, which over a
      finite susceptible pool is BetaBinomial(k I, k I (N / (R I) - 1), S).
    """
    R, I, S, N = _tensors(individual_rate, num_infectious, num_susceptible, population)
    N = N.clamp(min=1.0)
    combined_p = (R * I / N).clamp(0.0, 0.999999)
    if isinstance(concentration, numbers.Number) and concentration == float("inf"):
        prob = 1.0 - torch.exp(-combined_p)
        return binomial_dist(S, prob, overdispersion=overdispersion)
    k = _tensors(concentration, R)[0]
    I_safe = I.clamp(min=1e-3)
    c1 = (k * I_safe).clamp(min=1e-3)
    c0 = (k * I_safe * (N / (R * I_safe).clamp(min=1e-6) - 1.0)).clamp(min=1e-3)
    return beta_binomial_dist(c1, c0, S, overdispersion=overdispersion)
