"""Haar wavelet reparametrisation (counterpart of
``pyro_tpu/infer/reparam/haar.py``)."""

from __future__ import annotations

import torch

from ...distributions import constraints
from ...distributions.transforms import Transform
from ...ops.tensor_utils import haar_transform, inverse_haar_transform
from .unit_jacobian import UnitJacobianReparam


class HaarTransform(Transform):
    """The orthonormal Haar transform along the last dim (``flip``: of the
    reversed vector)."""

    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(self, dim: int = -1, flip: bool = False):
        if dim != -1:
            raise NotImplementedError("HaarTransform supports dim=-1 only")
        self.dim, self.flip = dim, flip

    def __call__(self, x):
        return haar_transform(x.flip(-1) if self.flip else x)

    def _inverse(self, y):
        x = inverse_haar_transform(y)
        return x.flip(-1) if self.flip else x

    def log_abs_det_jacobian(self, x, y):
        return x.new_zeros(x.shape[:-1])


class HaarReparam(UnitJacobianReparam):
    def __init__(self, dim: int = -1, flip: bool = False, *, experimental_allow_batch: bool = False):
        super().__init__(HaarTransform(dim=dim, flip=flip), suffix="haar")
