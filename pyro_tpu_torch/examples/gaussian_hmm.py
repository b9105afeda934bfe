"""Gaussian state-space HMMs at the JAX package's bench shapes: scoring
sequences with ``GaussianHMM.log_prob`` and drawing the posterior of their
hidden states with ``rsample_posterior``.

Two configurations, built from numpy (seed 0) as ``bench.py`` builds them
with ``jax.random``:

- ``homogeneous`` (``bench.py:55,973-993``, signature ``8.10000.32.4``): 8
  sequences of T=10,000 observations of dim 4, hidden dim 32, one shared
  transition ``0.9 I + 0.01 N(0, 1)``; the halving levels run K4a;
- ``heterogeneous`` (``bench.py:63,808-828``, signature ``64.4000.16.4``):
  one sequence of T=4000, hidden dim 16, a time-varying transition
  ``0.9 I + 0.02 N(0, 1)`` of shape (T, 16, 16), 64 posterior draws; the
  levels run K4b and the draws K4c.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.gaussian_hmm --config homogeneous
    python -m pyro_tpu_torch.examples.gaussian_hmm --config heterogeneous
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch import distributions as dist

CONFIGS = {
    # sequences (or draws), T, hidden, obs, the transition's noise around 0.9 I
    "homogeneous": {"batch": 8, "T": 10_000, "hidden": 32, "obs": 4, "trans_noise": 0.01, "varying": False},
    "heterogeneous": {"batch": 64, "T": 4000, "hidden": 16, "obs": 4, "trans_noise": 0.02, "varying": True},
}
INIT_SCALE, TRANS_SCALE, OBS_SCALE = 1.0, 0.3, 0.5


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


def params_from_jax(named):
    """The JAX model's parameter arrays (name -> numpy, the names of
    ``make_arrays``) as this package's float32 tensors on its device."""
    device = pyro.get_default_device()
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device) for k, v in named.items()}


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


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="homogeneous")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        pyro.set_default_device("cpu")
    device = pyro.get_default_device()
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
