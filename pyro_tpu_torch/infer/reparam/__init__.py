"""Reparametrisers (counterpart of ``pyro_tpu/infer/reparam``; so far the
unit-Jacobian ones the forecasters use)."""

from .discrete_cosine import DiscreteCosineReparam
from .haar import HaarReparam
from .reparam import Reparam
from .unit_jacobian import UnitJacobianReparam

__all__ = ["DiscreteCosineReparam", "HaarReparam", "Reparam", "UnitJacobianReparam"]
