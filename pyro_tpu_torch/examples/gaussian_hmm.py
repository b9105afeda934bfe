"""Gaussian state-space HMMs at the JAX package's bench shapes: scoring
sequences with ``GaussianHMM.log_prob``, drawing the posterior of their
hidden states with ``rsample_posterior``, and fitting the homogeneous
model by maximum likelihood with SVI (``--train``).

Two configurations, built from numpy (seed 0) as ``bench.py`` builds them
with ``jax.random``:

- ``homogeneous`` (``bench.py:55,973-993``, signature ``8.10000.32.4``): 8
  sequences of T=10,000 observations of dim 4, hidden dim 32, one shared
  transition ``0.9 I + 0.01 N(0, 1)``; the halving levels run K4a;
- ``heterogeneous`` (``bench.py:63,808-828``, signature ``64.4000.16.4``):
  one sequence of T=4000, hidden dim 16, a time-varying transition
  ``0.9 I + 0.02 N(0, 1)`` of shape (T, 16, 16), 64 posterior draws; the
  levels run K4b and the draws K4c.

``--train`` fits the homogeneous configuration: ``trans_mat``, ``obs_mat``
and the three scales become ``pyro.param``s (the scales positive), the
model adds ``GaussianHMM.log_prob(data).sum()`` with ``pyro.factor``, the
guide is empty, and ``Trace_ELBO`` with Adam takes the steps; every step's
backward runs through the K4a backward kernels on the card.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.gaussian_hmm --config homogeneous
    python -m pyro_tpu_torch.examples.gaussian_hmm --config heterogeneous
    python -m pyro_tpu_torch.examples.gaussian_hmm --train --num-steps 5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch import distributions as dist
from pyro_tpu_torch.distributions import constraints
from pyro_tpu_torch.infer import SVI, Trace_ELBO
from pyro_tpu_torch.optim import Adam

CONFIGS = {
    # sequences (or draws), T, hidden, obs, the transition's noise around 0.9 I
    "homogeneous": {"batch": 8, "T": 10_000, "hidden": 32, "obs": 4, "trans_noise": 0.01, "varying": False},
    "heterogeneous": {"batch": 64, "T": 4000, "hidden": 16, "obs": 4, "trans_noise": 0.02, "varying": True},
}
INIT_SCALE, TRANS_SCALE, OBS_SCALE = 1.0, 0.3, 0.5
# the parameters ``--train`` fits, with their constraints; the locations stay fixed
TRAIN_PARAMS = {
    "trans_mat": constraints.real, "obs_mat": constraints.real, "init_scale": constraints.positive,
    "trans_scale": constraints.positive, "obs_scale": constraints.positive,
}


def make_arrays(config, seed=0, **overrides):
    """The model's parameter arrays and the data, numpy float32, by name:
    ``init_loc``, ``init_scale``, ``trans_mat``, ``trans_loc``,
    ``trans_scale``, ``obs_mat``, ``obs_loc``, ``obs_scale`` and ``data``
    ((batch, T, obs) homogeneous, (T, obs) heterogeneous).  ``overrides``
    replace entries of the configuration (the tests' small sizes)."""
    c = {**CONFIGS[config], **overrides}
    h, o, T = c["hidden"], c["obs"], c["T"]
    rng = np.random.default_rng(seed)
    mat_shape = (T, h, h) if c["varying"] else (h, h)
    data_shape = (T, o) if c["varying"] else (c["batch"], T, o)
    out = {
        "init_loc": np.zeros(h), "init_scale": np.full(h, INIT_SCALE),
        "trans_mat": 0.9 * np.eye(h) + c["trans_noise"] * rng.standard_normal(mat_shape),
        "trans_loc": np.zeros(h), "trans_scale": np.full(h, TRANS_SCALE),
        "obs_mat": rng.standard_normal((h, o)) / h**0.5,
        "obs_loc": np.zeros(o), "obs_scale": np.full(o, OBS_SCALE),
        "data": rng.standard_normal(data_shape),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def params_from_jax(named, dtype=torch.float32):
    """The JAX model's parameter arrays (name -> numpy, the names of
    ``make_arrays`` or of the JAX param store of the ``--train`` model) as
    this package's tensors on its device, float32 unless ``dtype`` is given."""
    device = pyro.get_default_device()
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device) for k, v in named.items()}


def make_hmm(params, duration):
    """The GaussianHMM of ``params`` (tensors by the names of ``make_arrays``)."""
    return dist.GaussianHMM(
        dist.Normal(params["init_loc"], params["init_scale"]).to_event(1),
        params["trans_mat"],
        dist.Normal(params["trans_loc"], params["trans_scale"]).to_event(1),
        params["obs_mat"],
        dist.Normal(params["obs_loc"], params["obs_scale"]).to_event(1),
        duration=duration,
    )


def make_train_model(params):
    """The ``--train`` model over ``params`` (tensors by the names of
    ``make_arrays``, without ``data``): the entries of ``TRAIN_PARAMS``
    become ``pyro.param``s initialised from them; ``model(data)`` adds the
    log-likelihood of ``data`` (batch, T, obs) with ``pyro.factor``."""

    def model(data):
        p = {k: v for k, v in params.items() if k not in TRAIN_PARAMS}
        p.update({k: pyro.param(k, params[k], constraint=c) for k, c in TRAIN_PARAMS.items()})
        pyro.factor("log_prob", make_hmm(p, data.shape[-2]).log_prob(data).sum())

    return model


def make_train_svi(model):
    """SVI over ``model`` with the empty guide, Trace_ELBO and Adam (lr
    0.01): maximum likelihood."""
    return SVI(model, lambda *args: None, Adam({"lr": 0.01}), Trace_ELBO())


def timed_steps(svi, num_steps, *args):
    """``num_steps`` SVI steps: their losses, the first step's milliseconds
    (set-up: it builds the param store) and the mean milliseconds of the
    others, each step ending when its loss is read."""
    losses, ms = [], []
    for _ in range(num_steps):
        t0 = time.perf_counter()
        losses.append(svi.step(*args))
        ms.append(1e3 * (time.perf_counter() - t0))
    steady = sum(ms[1:]) / len(ms[1:]) if len(ms) > 1 else float("nan")
    return losses, ms[0], steady


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="homogeneous")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--train", action="store_true", help="fit the homogeneous model with SVI")
    parser.add_argument("--num-steps", type=int, default=5)
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        pyro.set_default_device("cpu")
    device = pyro.get_default_device()
    if args.train:
        params = params_from_jax(make_arrays("homogeneous", args.seed))
        data = params.pop("data")
        pyro.clear_param_store()
        svi = make_train_svi(make_train_model(params))
        losses, setup_ms, step_ms = timed_steps(svi, args.num_steps, data)
        print(f"homogeneous --train on {device}: set-up (first step) {setup_ms:.3f} ms, "
              f"{step_ms:.3f} ms a steady step; losses {losses}")
        return
    c = CONFIGS[args.config]
    params = params_from_jax(make_arrays(args.config, args.seed))
    data = params.pop("data")
    hmm = make_hmm(params, c["T"])
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        for label, fn, count in (
            ("log_prob", lambda: hmm.log_prob(data), data.shape[0] if data.ndim == 3 else 1),
            ("rsample_posterior", lambda: hmm.rsample_posterior(data, generator, (c["batch"],)), c["batch"]),
        ):
            if label == "rsample_posterior" and not c["varying"]:
                continue
            out = fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                out = fn()
            sync()
            dt = (time.perf_counter() - t0) / args.calls
            print(f"{args.config} {label}: {1e3 * dt:.3f} ms a call, {count / dt:.1f} a second, "
                  f"output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")


if __name__ == "__main__":
    main()
