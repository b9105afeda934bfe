"""Learning-rate schedules and DCTAdam (counterpart of the schedulers and
``DCTAdam`` of ``pyro_tpu/optim/extras.py``).

Each is a ``PyroOptim`` over a chain of transforms, as in ``optim.py``,
with optax's formulas.  Their step counts are tensors on the parameter's
device: a step reads nothing back, and a replayed CUDA graph of a step
would advance them.
"""

from __future__ import annotations

import math

import torch

from ..ops.tensor_utils import dct, idct
from .optim import PyroOptim, _ScaleByAdam, _ScaleByLearningRate, _Transform


def _count(param):
    """A step count: a 0-d float64 tensor on the parameter's device (1 - b2^t
    for b2 = 0.999 cancels to a third of float32's digits)."""
    return torch.zeros((), dtype=torch.float64, device=param.device)


class _ScaleByAdamCountOnDevice(_ScaleByAdam):
    """optax.scale_by_adam with the count a tensor on the parameter's
    device, so the bias corrections are formed there."""

    def init(self, param):
        state = super().init(param)
        state["count"] = _count(param)
        return state

    def update(self, g, state, param):
        mu = state["mu"].mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu = state["nu"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        count = state["count"].add_(1)
        mu_hat, nu_hat = mu / (1 - self.b1**count).to(g.dtype), nu / (1 - self.b2**count).to(g.dtype)
        return mu_hat / (nu_hat.sqrt() + self.eps)


class _InFrequency(_Transform):
    """``inner`` applied in the DCT domain of the rightmost dim: the update
    DCT'd, ``inner``'s state kept over frequencies, its output inverse
    DCT'd (a rightmost dim of size 1 is left as it is)."""

    def __init__(self, inner):
        self.inner = inner

    @staticmethod
    def _spectral(x):
        return x.ndim >= 1 and x.shape[-1] > 1

    def init(self, param):
        return self.inner.init(param)

    def update(self, g, state, param):
        if not self._spectral(g):
            return self.inner.update(g, state, param)
        return idct(self.inner.update(dct(g), state, param))


class _ScaleBySchedule(_Transform):
    """-schedule(count) times the update, the count of updates made before
    this one a tensor on the device (the first update uses schedule(0))."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, param):
        return {"count": _count(param)}

    def update(self, g, state, param):
        lr = self.schedule(state["count"]).to(g.dtype)
        state["count"].add_(1)
        return -lr * g


def _dct_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, subsample_aware=False):
    return [_InFrequency(_ScaleByAdamCountOnDevice(*betas, eps)), _ScaleByLearningRate(lr)]


def DCTAdam(optim_args=None, clip_args=None, **kwargs):
    """Adam in the DCT domain of each parameter's rightmost dim: moments
    kept over frequencies, each update transformed back (the forecasters'
    default optimiser).  ``subsample_aware`` is taken and ignored, as in
    the JAX package."""
    return PyroOptim(_dct_adam, kwargs if optim_args is None else optim_args, clip_args)


class PyroLRScheduler(PyroOptim):
    """A ``PyroOptim`` whose chain schedules its own learning rate:
    ``step()`` is a no-op, the schedule advancing with each update."""

    def step(self, *args, **kwargs):
        pass


def _scheduled_adam(schedule):
    return lambda **unused: [_ScaleByAdamCountOnDevice(), _ScaleBySchedule(schedule)]


def ExponentialLR(optim_args=None, **kwargs):
    """Adam (default betas and eps) at lr * gamma^t, t updates before this one."""
    args = dict(optim_args or kwargs)
    gamma, base_lr = args.pop("gamma", 0.99), args.pop("lr", 1e-3)
    return PyroLRScheduler(_scheduled_adam(lambda t: base_lr * gamma**t), args)


def StepLR(optim_args=None, **kwargs):
    """Adam at lr * gamma^floor(t / step_size)."""
    args = dict(optim_args or kwargs)
    step_size, gamma, base_lr = args.pop("step_size", 100), args.pop("gamma", 0.1), args.pop("lr", 1e-3)
    return PyroLRScheduler(_scheduled_adam(lambda t: base_lr * gamma ** torch.floor(t / step_size)), args)


def MultiStepLR(optim_args=None, **kwargs):
    """Adam whose lr drops by ``gamma`` at each step count in ``milestones``
    (counts of optimiser steps); the reference's {"optimizer": Adam,
    "optim_args": {...}} layout is flattened."""
    args = dict(optim_args or kwargs)
    args.pop("optimizer", None)
    args.update(args.pop("optim_args", None) or {})
    milestones = sorted(int(m) for m in args.pop("milestones", []))
    gamma, base_lr = args.pop("gamma", 0.1), args.pop("lr", 1e-3)

    def schedule(t):
        passed = sum((t >= m).to(t.dtype) for m in milestones) if milestones else torch.zeros_like(t)
        return base_lr * gamma**passed

    return PyroLRScheduler(_scheduled_adam(schedule), args)


def CosineAnnealingLR(optim_args=None, **kwargs):
    """Adam at lr * (1 + cos(pi min(t, T_max) / T_max)) / 2."""
    args = dict(optim_args or kwargs)
    T_max, base_lr = args.pop("T_max", 1000), args.pop("lr", 1e-3)
    return PyroLRScheduler(
        _scheduled_adam(lambda t: base_lr * 0.5 * (1 + torch.cos(math.pi * t.clamp(max=T_max) / T_max))), args)
