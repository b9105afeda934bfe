"""Special functions (counterpart of ``pyro_tpu/ops/special.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..settings import get_default_device


def safe_log(x):
    """log with its input clamped to the dtype's smallest normal number, so
    0 gives a finite value."""
    return torch.log(x.clamp(min=torch.finfo(x.dtype).tiny))


def log_beta(x, y, tol: float = 0.0):
    """log Beta(x, y); with ``tol >= 0.02`` the cheaper Stirling form with
    ``shift`` recurrence steps, as the JAX package computes it."""
    if tol < 0.02:
        return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)
    shift = max(1, int(-0.5 - math.log(tol) / 2))
    xy = x + y
    log_factor = 0.0
    for _ in range(shift):
        log_factor = log_factor + torch.log(xy / (x * y))
        x, y, xy = x + 1, y + 1, xy + 1
    return (
        log_factor
        + (x - 0.5) * torch.log(x)
        + (y - 0.5) * torch.log(y)
        - (xy - 0.5) * torch.log(xy)
        + math.log(2 * math.pi) / 2
        + (1 / 12) * (1 / x + 1 / y - 1 / xy)
    )


def log_binomial(n, k, tol: float = 0.0):
    """log C(n, k)."""
    return -log_beta(1.0 + n - k, 1.0 + k, tol=tol) - torch.log1p(n)


def log_i0(x):
    """log of the modified Bessel function I0 (VonMises' normaliser)."""
    return torch.log(torch.special.i0e(x)) + x.abs()


def log_i1(x):
    """log I1 (VonMises' variance)."""
    return torch.log(torch.special.i1e(x)) + x.abs()


def get_quad_rule(num_quad, dtype=None, device=None):
    """Gauss-Hermite quadrature for a standard normal: (points, log-weights)."""
    points, weights = np.polynomial.hermite_e.hermegauss(num_quad)
    opts = {"dtype": dtype or torch.get_default_dtype(), "device": device or get_default_device()}
    return (torch.tensor(points, **opts),
            torch.tensor(np.log(weights) - 0.5 * math.log(2 * math.pi), **opts))


def logsumexp(x, dim=None, keepdim=False):
    """log sum exp over ``dim`` (all dims when None)."""
    if dim is None:
        dim = tuple(range(x.ndim))
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)


def sparse_multinomial_likelihood(total_count, nonzero_logits, nonzero_counts):
    """The multinomial log-likelihood over the nonzero counts only."""
    return (
        torch.lgamma(total_count + 1)
        - torch.lgamma(nonzero_counts + 1).sum(-1)
        + (nonzero_logits * nonzero_counts).sum(-1)
    )


def log_I1(orders: int, value, terms: int = 250):
    """log I_0 .. log I_orders of ``value`` (modified Bessel functions of the
    first kind) by their series of ``terms`` terms: shape ``(orders + 1,) +
    value.shape`` (a scalar ``value`` counts as shape (1,))."""
    value = torch.as_tensor(value)
    if not value.is_floating_point():
        value = value.to(torch.get_default_dtype())
    vshape = value.shape if value.ndim else (1,)
    value = value.reshape(-1, 1)
    orders = orders + 1
    k = torch.arange(terms, device=value.device, dtype=value.dtype)
    lgammas_all = torch.lgamma(torch.arange(1.0, terms + orders + 1, device=value.device, dtype=value.dtype))
    lvalues = torch.log(value / 2) * k[None, :]
    lfactorials = lgammas_all[:terms]
    indices = torch.arange(orders, device=value.device)[:, None] + torch.arange(terms, device=value.device)[None, :]
    seqs = torch.logsumexp(
        2 * lvalues[None, :, :] - lfactorials[None, None, :] - lgammas_all[indices][:, None, :], dim=-1
    )
    i1s = lvalues[..., :orders].T + seqs
    return i1s.reshape(-1, *vshape)
