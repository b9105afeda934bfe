"""Normalizing flows: the affine autoregressive and affine coupling
transforms (the part of ``pyro_tpu/distributions/flows.py`` this package
ports; ref ``pyro/distributions/transforms/affine_autoregressive.py``,
``affine_coupling.py``).

The helpers ``affine_autoregressive`` and ``affine_coupling`` build the
transform's network and register its parameters in the param store through
``pyro_tpu_torch.module``, so flows train under SVI like any guide.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..settings import get_default_device
from . import constraints
from .transforms import Transform


class AffineAutoregressive(Transform):
    """IAF: ``y = mean(x) + exp(log_scale(x)) * x`` in one pass of the
    autoregressive network; the inverse runs it once a dim, in index order."""

    domain = constraints.real_vector
    codomain = constraints.real_vector
    autoregressive = True

    def __init__(
        self,
        autoregressive_nn: Callable,
        log_scale_min_clip: float = -5.0,
        log_scale_max_clip: float = 3.0,
    ):
        self.arn = autoregressive_nn
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip

    def _params(self, x):
        mean, log_scale = self.arn(x)
        return mean, log_scale.clamp(self.log_scale_min_clip, self.log_scale_max_clip)

    def __call__(self, x):
        mean, log_scale = self._params(x)
        return mean + torch.exp(log_scale) * x

    def _inverse(self, y):
        x = torch.zeros_like(y)
        for i in range(y.shape[-1]):
            mean, log_scale = self._params(x)
            x = x.clone()  # the previous x stays as the network's saved input
            x[..., i] = (y[..., i] - mean[..., i]) * torch.exp(-log_scale[..., i])
        return x

    def log_abs_det_jacobian(self, x, y):
        return self._params(x)[1].sum(-1)


class AffineCoupling(Transform):
    """RealNVP coupling: the dims after ``split_dim`` scaled and shifted by a
    network of the dims before it."""

    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(
        self, split_dim: int, hypernet: Callable, log_scale_min_clip: float = -5.0, log_scale_max_clip: float = 3.0
    ):
        self.split_dim = split_dim
        self.hypernet = hypernet
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip

    def _params(self, x1):
        mean, log_scale = self.hypernet(x1)
        return mean, log_scale.clamp(self.log_scale_min_clip, self.log_scale_max_clip)

    def __call__(self, x):
        x1, x2 = x[..., : self.split_dim], x[..., self.split_dim :]
        mean, log_scale = self._params(x1)
        return torch.cat([x1, mean + torch.exp(log_scale) * x2], dim=-1)

    def _inverse(self, y):
        y1, y2 = y[..., : self.split_dim], y[..., self.split_dim :]
        mean, log_scale = self._params(y1)
        return torch.cat([y1, (y2 - mean) * torch.exp(-log_scale)], dim=-1)

    def log_abs_det_jacobian(self, x, y):
        return self._params(x[..., : self.split_dim])[1].sum(-1)


def affine_autoregressive(
    name: str, input_dim: int, hidden_dims: Optional[Sequence[int]] = None, **kwargs
) -> AffineAutoregressive:
    """An IAF whose MADE (hidden widths default ``[3 D + 1]``) is registered
    in the param store under ``name``."""
    from ..nn.auto_reg_nn import AutoRegressiveNN
    from ..primitives import module

    if hidden_dims is None:
        hidden_dims = [3 * input_dim + 1]
    arn = AutoRegressiveNN(input_dim, tuple(hidden_dims)).to(get_default_device())
    return AffineAutoregressive(module(name, arn), **kwargs)


def affine_coupling(
    name: str,
    input_dim: int,
    hidden_dims: Optional[Sequence[int]] = None,
    split_dim: Optional[int] = None,
    **kwargs,
) -> AffineCoupling:
    """A coupling layer (split at ``input_dim // 2``, hidden widths
    ``[10 D]`` by default) whose DenseNN is registered under ``name``."""
    from ..nn.dense_nn import DenseNN
    from ..primitives import module

    if split_dim is None:
        split_dim = input_dim // 2
    if hidden_dims is None:
        hidden_dims = [10 * input_dim]
    out_dim = input_dim - split_dim
    net = DenseNN(split_dim, tuple(hidden_dims), (out_dim, out_dim)).to(get_default_device())
    return AffineCoupling(split_dim, module(name, net), **kwargs)
