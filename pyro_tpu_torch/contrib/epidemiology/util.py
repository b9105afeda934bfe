"""Quantization helpers for enumerated compartmental inference
(counterpart of ``pyro_tpu/contrib/epidemiology/util.py``): the
spline-based randomized quantization of the asymptotically exact
``fit_mcmc(num_quant_bins > 1)`` mode."""

from __future__ import annotations

import numbers

import torch

from ... import distributions as dist
from ... import primitives as pyro


def compute_bin_probs(s, num_quant_bins: int):
    """The categorical probabilities of the quantization scheme: ``s`` in
    [0, 1], shape ``s.shape + (num_quant_bins,)``."""
    t = 1 - s
    if num_quant_bins == 2:
        return torch.stack([t, s], -1)
    ss = s * s
    tt = t * t
    if num_quant_bins == 4:
        # a cubic spline over the nearest four integers: piecewise quadratic gradients
        return torch.stack([t * tt, 4 + ss * (3 * s - 6), 4 + tt * (3 * t - 6), s * ss], -1) / 6.0
    if num_quant_bins == 8:
        # a quintic spline over the nearest eight integers: piecewise quartic gradients
        s3 = ss * s
        s4 = ss * ss
        s5 = s3 * ss
        t3 = tt * t
        t4 = tt * tt
        t5 = t3 * tt
        return torch.stack(
            [
                2 * t5,
                2 + 10 * t + 20 * tt + 20 * t3 + 10 * t4 - 7 * t5,
                55 + 115 * t + 70 * tt - 9 * t3 - 25 * t4 + 7 * t5,
                302 - 100 * ss + 10 * s4,
                302 - 100 * tt + 10 * t4,
                55 + 115 * s + 70 * ss - 9 * s3 - 25 * s4 + 7 * s5,
                2 + 10 * s + 20 * ss + 20 * s3 + 10 * s4 - 7 * s5,
                2 * s5,
            ],
            -1,
        ) * (1.0 / 840.0)
    raise NotImplementedError(f"num_quant_bins must be one of 1, 2, 4, 8; got {num_quant_bins}")


def _last(bound):
    """A bound that broadcasts against values with a trailing bin dim."""
    return bound if isinstance(bound, numbers.Number) else bound[..., None]


def quantize(name, x_real, min, max, num_quant_bins: int = 4):
    """Randomly quantize ``x_real`` to a nearby integer, preserving
    probability mass: a parallel-enumerated ``Categorical`` site ``Q_<name>``
    over the nearest integers, reflected into [min, max]."""
    if num_quant_bins == 1:
        return pyro.deterministic(name, torch.round(x_real.detach()))
    lb = torch.floor(x_real.detach())
    probs = compute_bin_probs(x_real - lb, num_quant_bins)
    q = pyro.sample("Q_" + name, dist.Categorical(probs), infer={"enumerate": "parallel"})
    q = q.to(x_real.dtype) - (num_quant_bins // 2 - 1)
    x = lb + q
    x = torch.maximum(x, 2 * min - 1 - x)
    x = torch.minimum(x, 2 * max + 1 - x)
    return pyro.deterministic(name, x)


def quantize_enumerate(x_real, min, max, num_quant_bins: int = 4):
    """Quantize, then enumerate by hand over the nearest integers: returns
    (values, logits), each with a trailing dim of ``num_quant_bins``.  The
    floor is taken of the detached value, so the gradient reaches
    ``x_real`` through the spline logits alone."""
    lb = torch.floor(x_real.detach())
    probs = compute_bin_probs(x_real - lb, num_quant_bins)
    logits = torch.log(probs.clamp(min=torch.finfo(probs.dtype).tiny))
    q = torch.arange(1 - num_quant_bins // 2, 1 + num_quant_bins // 2, dtype=x_real.dtype, device=x_real.device)
    x = lb[..., None] + q
    x = torch.maximum(x, 2 * _last(min) - 1 - x)
    x = torch.minimum(x, 2 * _last(max) + 1 - x)
    return x, logits
