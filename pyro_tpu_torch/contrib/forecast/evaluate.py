"""Forecast metrics and backtesting (counterpart of
``pyro_tpu/contrib/forecast/evaluate.py``)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ...ops.stats import crps_empirical


def eval_mae(pred, truth) -> float:
    """Mean absolute error of the draws' median: pred (S, T, D), truth (T, D)."""
    return float((torch.quantile(pred, 0.5, dim=0) - truth).abs().mean())


def eval_rmse(pred, truth) -> float:
    """Root mean squared error of the draws' mean."""
    return float(((pred.mean(0) - truth) ** 2).mean().sqrt())


def eval_crps(pred, truth) -> float:
    """The empirical continuous ranked probability score, averaged."""
    return float(crps_empirical(pred, truth).mean())


DEFAULT_METRICS = {"mae": eval_mae, "rmse": eval_rmse, "crps": eval_crps}


def backtest(data, covariates, model_fn: Callable, *, forecaster_fn=None, metrics: Optional[Dict[str, Callable]] = None,
             train_window: Optional[int] = None, min_train_window: int = 1, test_window: Optional[int] = None,
             min_test_window: int = 1, stride: int = 1, num_samples: int = 100, forecaster_options=None,
             generator=None) -> List[Dict]:
    """Rolling-origin evaluation: for each window, a ``Forecaster`` of
    ``model_fn()`` fitted on the data before it and scored on it by each
    metric.  Without ``train_window`` there is one window, the last
    ``test_window`` steps."""
    from .forecaster import Forecaster

    metrics = metrics or DEFAULT_METRICS
    forecaster_options = dict(forecaster_options or {})
    duration = data.shape[-2]
    if test_window is None:
        test_window = max(min_test_window, duration // 4)
    t = train_window if train_window is not None else max(min_train_window, duration - test_window)
    windows = []
    while t + min_test_window <= duration:
        windows.append((t, min(t + test_window, duration)))
        t += stride
        if train_window is None:
            break
    results = []
    for t_train_end, t_test_end in windows:
        train_data = data[..., :t_train_end, :]
        forecaster = Forecaster(model_fn(), train_data, covariates[:t_train_end], **forecaster_options)
        pred = forecaster(train_data, covariates[:t_test_end], num_samples=num_samples, generator=generator)
        truth = data[..., t_train_end:t_test_end, :]
        result = {"t0": 0, "t1": t_train_end, "t2": t_test_end, "train_walltime": None, "test_walltime": None}
        for name, fn in metrics.items():
            result[name] = fn(pred, truth)
        results.append(result)
    return results
