"""Forecasting (counterpart of ``pyro_tpu/contrib/forecast``)."""

from .evaluate import backtest, eval_crps, eval_mae, eval_rmse
from .forecaster import Forecaster, ForecastingModel, HMCForecaster

__all__ = [
    "HMCForecaster",
    "Forecaster",
    "ForecastingModel",
    "backtest",
    "eval_crps",
    "eval_mae",
    "eval_rmse",
]
