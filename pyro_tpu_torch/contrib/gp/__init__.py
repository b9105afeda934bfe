"""Gaussian processes (counterpart of ``pyro_tpu/contrib/gp``): so far
only the ``Parameterized`` base that the time-series models build on."""

from .parameterized import Parameterized

__all__ = ["Parameterized"]
