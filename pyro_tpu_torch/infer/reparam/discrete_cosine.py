"""Frequency-domain reparametrisation (counterpart of
``pyro_tpu/infer/reparam/discrete_cosine.py``)."""

from __future__ import annotations

import math

import torch

from ...distributions import constraints
from ...distributions.transforms import Transform
from ...ops.tensor_utils import dct, idct
from .unit_jacobian import UnitJacobianReparam


class DiscreteCosineTransform(Transform):
    """The orthonormal DCT along ``dim`` (negative; the event covers the
    dims from there rightward), each frequency k scaled by
    (1 + k)^-smooth."""

    def __init__(self, dim: int = -1, smooth: float = 0.0):
        if dim >= 0:
            raise ValueError("DiscreteCosineTransform needs a negative dim")
        self.dim, self.smooth = dim, smooth
        self.domain = self.codomain = constraints.independent(constraints.real, -dim)

    def _weights(self, size, like):
        return (1.0 + torch.arange(size, dtype=like.dtype, device=like.device)) ** (-self.smooth)

    def __call__(self, x):
        y = dct(x, self.dim)
        return y * self._weights(x.shape[self.dim], x).reshape((-1,) + (1,) * (-1 - self.dim)) if self.smooth else y

    def _inverse(self, y):
        if self.smooth:
            y = y / self._weights(y.shape[self.dim], y).reshape((-1,) + (1,) * (-1 - self.dim))
        return idct(y, self.dim)

    def log_abs_det_jacobian(self, x, y):
        event_dim = -self.dim
        ladj = x.new_zeros(x.shape[:x.ndim - event_dim])
        if self.smooth:
            size = x.shape[self.dim]
            # sum(log w) once for each line of the event along dim
            ladj = ladj + self._weights(size, x).log().sum() * (math.prod(x.shape[x.ndim - event_dim:]) // size)
        return ladj


class DiscreteCosineReparam(UnitJacobianReparam):
    def __init__(self, dim: int = -1, smooth: float = 0.0, *, experimental_allow_batch: bool = False):
        super().__init__(DiscreteCosineTransform(dim=dim, smooth=smooth), suffix="dct")
