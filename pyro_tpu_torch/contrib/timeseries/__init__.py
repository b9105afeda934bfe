"""Time-series models (counterpart of ``pyro_tpu/contrib/timeseries``):
so far ``GenericLGSSM``."""

from .base import TimeSeriesModel
from .lgssm import GenericLGSSM

__all__ = ["GenericLGSSM", "TimeSeriesModel"]
