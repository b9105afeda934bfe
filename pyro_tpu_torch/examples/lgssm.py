"""Fit ``GenericLGSSM`` to one series by maximum likelihood with SVI, as
``examples/timeseries_gp.py`` fits its GP: the model adds
``GenericLGSSM.log_prob(targets)`` with ``pyro.factor``, the guide is
empty, and ``Trace_ELBO`` with ``Adam({"lr": 0.01})`` takes the steps.

The series is ``make_arrays("heterogeneous")["data"]`` of
``examples/gaussian_hmm.py`` (numpy, seed 0): T=4000 observations of dim
4, fitted with a hidden state of dim 16.  ``GenericLGSSM`` takes the
heterogeneous route, 12 K4b levels forward and backward a step (the
hand-written kernels on the card).

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.lgssm --num-steps 5
"""

from __future__ import annotations

import argparse

import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.contrib.timeseries import GenericLGSSM
from pyro_tpu_torch.examples.gaussian_hmm import make_arrays, make_train_svi, params_from_jax, timed_steps

OBS_DIM, STATE_DIM = 4, 16


def make_model(lgssm):
    """The maximum-likelihood model of ``lgssm`` over a series ``targets``."""

    def model(targets):
        pyro.factor("log_prob", lgssm.log_prob(targets))

    return model


def make_targets(seed=0, dtype=torch.float32):
    """The series (T, obs) on the package's device, float32 unless
    ``dtype`` is given."""
    return params_from_jax({"data": make_arrays("heterogeneous", seed)["data"]}, dtype)["data"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        pyro.set_default_device("cpu")
    pyro.clear_param_store()
    targets = make_targets(args.seed)
    svi = make_train_svi(make_model(GenericLGSSM(obs_dim=OBS_DIM, state_dim=STATE_DIM)))
    losses, setup_ms, step_ms = timed_steps(svi, args.num_steps, targets)
    print(f"lgssm on {pyro.get_default_device()} (T={targets.shape[0]}, obs {OBS_DIM}, state {STATE_DIM}): "
          f"set-up (first step) {setup_ms:.3f} ms, {step_ms:.3f} ms a steady step; losses {losses}")


if __name__ == "__main__":
    main()
