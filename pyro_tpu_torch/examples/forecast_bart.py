"""Forecasting BART ridership, the counterpart of ``examples/forecast_bart.py``:
a ``ForecastingModel`` of hourly ridership with a weekly seasonality (one
coefficient per hour of the week) and ``GaussianHMM`` noise (a local level),
fitted by ``Forecaster`` (SVI with ``AutoNormal`` and ``DCTAdam``), then
forecast over the held-out hours.  The noise's ``log_prob`` (training) and
its ``filter`` and ``rsample`` (forecasting) run through the K4 kernels on
the card.

Configurations:

- ``fake`` (the JAX example's): ``load_fake_od()``, 744 hours of the first
  origin-destination pair's ``log1p`` counts, trained on the first 80%;
- ``long``: the length of upstream Pyro's BART counts (78,888 hours), the
  total ridership that its forecasting tutorial forms by
  ``counts.sum([-1, -2]).unsqueeze(-1).log1p()``, trained up to two weeks
  before the end.  The real counts are not in the repository: the series
  is synthetic (``synthetic_total_ridership``).

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.forecast_bart
    python -m pyro_tpu_torch.examples.forecast_bart --config long --num-steps 20
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch.contrib.examples.bart import load_fake_od
from pyro_tpu_torch.contrib.forecast import Forecaster, ForecastingModel
from pyro_tpu_torch.ops.tensor_utils import periodic_repeat

LONG_T = 78888  # hours in upstream's BART counts
LONG_TEST = 24 * 7 * 2  # the tutorial's held-out two weeks


class Model(ForecastingModel):
    """Weekly seasonality and a GaussianHMM local level over the residuals."""

    def model(self, zero_data, covariates):
        duration, dim = zero_data.shape[-2:]
        opts = {"dtype": zero_data.dtype, "device": zero_data.device}
        weekly = pyro.sample("weekly", dist.Normal(torch.zeros((), **opts), 5.0).expand((168, dim)).to_event(2))
        prediction = periodic_repeat(weekly, duration, dim=-2)

        init_dist = dist.Normal(torch.zeros(1, **opts), 10.0).to_event(1)
        trans_scale = pyro.sample("trans_scale", dist.LogNormal(torch.full((), -2.0, **opts), 1.0))
        obs_scale = pyro.sample("obs_scale", dist.LogNormal(torch.full((), -2.0, **opts), 1.0))
        noise_dist = dist.GaussianHMM(
            init_dist,
            torch.ones((1, 1, 1), **opts),
            dist.Normal(torch.zeros((1, 1), **opts), trans_scale).to_event(1),
            torch.ones((1, 1, dim), **opts),
            dist.Normal(torch.zeros((1, dim), **opts), obs_scale).to_event(1),
            duration=duration,
        )
        self.predict(noise_dist, prediction)


def fake_data():
    """The JAX example's series: (744, 1) log1p counts of the first OD pair,
    and the number of training hours."""
    counts = load_fake_od()["counts"]
    data = torch.log1p(counts.reshape(counts.shape[0], -1)[:, :1])
    return data, int(0.8 * data.shape[0])


def synthetic_total_ridership(seed, T=LONG_T):
    """(T, 1) log1p of an hourly total ridership and the number of training
    hours (all but the last two weeks): a weekly profile (a commute peak
    twice a weekday, lower weekends) times a slow trend, plus Poisson noise,
    made with numpy from ``seed`` directly as the summed series."""
    rng = np.random.default_rng(seed)
    hour = np.arange(T)
    day, hod = (hour // 24) % 7, hour % 24
    peaks = np.exp(-0.5 * ((hod - 8) / 1.5) ** 2) + np.exp(-0.5 * ((hod - 17.5) / 1.5) ** 2)
    night = (hod < 5).astype(float)
    weekday = day < 5
    profile = np.where(weekday, 0.3 + 2.5 * peaks, 0.5 + 0.3 * peaks) * (1 - 0.9 * night)
    trend = 1 + 0.3 * hour / T + 0.05 * np.sin(2 * np.pi * hour / (24 * 365.25))
    counts = rng.poisson(8000 * profile * trend)
    data = torch.tensor(np.log1p(counts)[:, None], dtype=torch.get_default_dtype(), device=pyro.get_default_device())
    return data, T - LONG_TEST


def main(args):
    if args.cpu:
        pyro.set_default_device("cpu")
    pyro.clear_param_store()
    data, t_train = fake_data() if args.config == "fake" else synthetic_total_ridership(args.seed)
    T = data.shape[0]
    covariates = data.new_zeros((T, 0))
    device = pyro.get_default_device()
    forecaster = Forecaster(Model(), data[:t_train], covariates[:t_train], num_steps=args.num_steps,
                            learning_rate=args.learning_rate,
                            generator=torch.Generator(device=device).manual_seed(args.seed))
    print(f"loss: first={forecaster.losses[0]:.2f} last={forecaster.losses[-1]:.2f}")
    samples = forecaster(data[:t_train], covariates, num_samples=args.num_samples,
                         generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    mae = float((samples.mean(0)[:, 0] - data[t_train:, 0]).abs().mean())
    print(f"forecast MAE over {T - t_train} held-out steps: {mae:.3f}")
    return mae


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Forecast BART ridership with a GaussianHMM noise model")
    p.add_argument("--num-steps", type=int, default=500)
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", choices=("fake", "long"), default="fake")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
