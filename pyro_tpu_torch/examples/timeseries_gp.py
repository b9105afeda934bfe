"""State-space Gaussian-process time series, the counterpart of
``examples/timeseries_gp.py``: fit an ``IndependentMaternGP`` or a
``LinearlyCoupledMaternGP`` to a multivariate series by maximum marginal
likelihood (the exact Kalman log density, one time contraction through the
K4 kernels on the card), then report the one-step-ahead forecast error.

The series is synthetic, drawn with numpy from ``--seed``: channel i is
sin(0.2 (i + 1) t) plus Normal(0, 0.1) noise (the JAX example draws the same
form with ``jax.random``).  Configurations:

- ``default``: the JAX example's widths, obs_dim 2, a train window of
  ``--train-window`` (80) steps, nu 1.5, ``num_gps`` 2 for ``lcmgp``;
- ``eeg``: the shape of the UCI EEG Eye State series that upstream Pyro's
  ``examples/contrib/timeseries/gp_models.py`` fits, 14 channels and 14,980
  steps (the data set is not in the repository; the series is the same
  synthetic form at that shape), ``num_gps`` 4 for ``lcmgp``.

``make_gp`` also builds ``dmgp`` (``DependentMaternGP``, K4a) and
``lgssmgp`` (``GenericLGSSMWithGPNoiseModel`` with a z-state of 4, K4a).
The one-step forecast is ``IndependentMaternGP.forecast``;
``LinearlyCoupledMaternGP`` has none (its ``forecast`` raises, as the JAX
package's does, and the JAX example stops there), so for ``lcmgp`` the
filtered final state is taken one step through the transition, the rollout
that the raise's message names.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.timeseries_gp --model imgp --num-steps 300
    python -m pyro_tpu_torch.examples.timeseries_gp --model lcmgp --config eeg --num-steps 20
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.contrib.timeseries import (
    DependentMaternGP,
    GenericLGSSMWithGPNoiseModel,
    IndependentMaternGP,
    LinearlyCoupledMaternGP,
)
from pyro_tpu_torch.infer import SVI, Trace_ELBO
from pyro_tpu_torch.optim import Adam

CONFIGS = {
    "default": {"obs_dim": 2, "num_gps": 2, "state_dim": 4},
    "eeg": {"obs_dim": 14, "num_gps": 4, "state_dim": 4, "train_window": 14_980},
}
MODELS = ("imgp", "lcmgp", "dmgp", "lgssmgp")


def synthetic_series(seed, T, obs_dim=2):
    """A (T, obs_dim) float32 numpy series: sin(0.2 (i + 1) t) plus
    Normal(0, 0.1) noise in channel i."""
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32)
    cols = [np.sin(0.2 * (i + 1) * t) + 0.1 * rng.standard_normal(T) for i in range(obs_dim)]
    return np.stack(cols, -1).astype(np.float32)


def make_gp(model, config="default", name=None):
    """The GP time-series model ``model`` (one of ``MODELS``) at the widths
    of ``config``, nu 1.5."""
    c = CONFIGS[config]
    if model == "imgp":
        return IndependentMaternGP(nu=1.5, obs_dim=c["obs_dim"], name=name)
    if model == "lcmgp":
        return LinearlyCoupledMaternGP(nu=1.5, obs_dim=c["obs_dim"], num_gps=c["num_gps"], name=name)
    if model == "dmgp":
        return DependentMaternGP(nu=1.5, obs_dim=c["obs_dim"], name=name)
    if model == "lgssmgp":
        return GenericLGSSMWithGPNoiseModel(obs_dim=c["obs_dim"], state_dim=c["state_dim"], nu=1.5, name=name)
    raise ValueError(f"unknown model {model!r}; one of {MODELS}")


def make_model(gp):
    """The maximum-likelihood model of ``gp`` over a series ``targets``."""

    def model(targets):
        pyro.factor("log_prob", gp.log_prob(targets))

    return model


def make_svi(model, learning_rate=0.01):
    """SVI with the empty guide, Trace_ELBO and Adam, as the JAX example."""
    return SVI(model, lambda *args: None, Adam({"lr": learning_rate}), Trace_ELBO())


def one_step_forecast(gp, targets):
    """The predictive mean (obs_dim,) of the step after ``targets``, for an
    ``IndependentMaternGP`` or a ``LinearlyCoupledMaternGP``."""
    if isinstance(gp, IndependentMaternGP):
        return gp.forecast(targets, [1.0]).mean[0]
    from pyro_tpu_torch.ops.tensor_utils import block_diag_embed

    filtered = gp.get_dist(duration=targets.shape[0]).filter(targets)
    A = gp.kernel.transition_matrix(gp.length_scale, gp.dt)
    z = filtered.loc @ block_diag_embed(A.transpose(-1, -2))
    return z[:: gp.kernel.state_dim] @ gp.A_mix  # each GP's position, mixed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="imgp", choices=["imgp", "lcmgp"])
    parser.add_argument("--config", default="default", choices=sorted(CONFIGS))
    parser.add_argument("--train-window", type=int, default=80)
    parser.add_argument("--num-steps", type=int, default=300)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        pyro.set_default_device("cpu")
    pyro.clear_param_store()
    c = CONFIGS[args.config]
    window = c.get("train_window", args.train_window)
    data = torch.tensor(synthetic_series(args.seed, window + 1, c["obs_dim"]), device=pyro.get_default_device())
    targets = data[:window]
    gp = make_gp(args.model, args.config)
    svi = make_svi(make_model(gp), args.learning_rate)
    t0 = time.perf_counter()
    losses = svi.run_steps(args.num_steps, targets).tolist()
    seconds = time.perf_counter() - t0
    print(f"{args.model} ({args.config}, T={window}, obs_dim {c['obs_dim']}) on {pyro.get_default_device()}: "
          f"{args.num_steps} steps in {seconds:.2f} s; negative log-likelihood: first={losses[0]:.2f} "
          f"last={losses[-1]:.2f}")
    with torch.no_grad():
        err = (one_step_forecast(gp, targets) - data[window]).abs().cpu().numpy()
    print("one-step forecast error per dim:", np.array2string(err, precision=3))
    return float(err.mean())


if __name__ == "__main__":
    main()
