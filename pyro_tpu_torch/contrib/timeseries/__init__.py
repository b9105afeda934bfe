"""Time-series models (counterpart of ``pyro_tpu/contrib/timeseries``)."""

from .base import TimeSeriesModel
from .gp import DependentMaternGP, IndependentMaternGP, LinearlyCoupledMaternGP
from .lgssm import GenericLGSSM, GenericLGSSMWithGPNoiseModel

__all__ = [
    "GenericLGSSMWithGPNoiseModel",
    "DependentMaternGP",
    "GenericLGSSM",
    "IndependentMaternGP",
    "LinearlyCoupledMaternGP",
    "TimeSeriesModel",
]
