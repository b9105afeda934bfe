"""Student-t state-space models: scoring sequences with
``GammaGaussianHMM.log_prob`` and filtering them (the posterior over the
noise scale and the last hidden state) with ``GammaGaussianHMM.filter``.

A shared scale ``s ~ Gamma(2, 2)`` multiplies the precision of every noise
term, so each is Student-t with 4 degrees of freedom once ``s`` is
integrated out.  Two configurations, built from numpy (seed 0) as
``bench.py`` builds the Gaussian ones with ``jax.random``:

- ``homogeneous`` (the widths of ``bench.py:55``'s
  ``gaussianhmm_logprob_per_sec``, signature ``8.10000.32.4``): 8 sequences
  of T=10,000 observations of dim 4, hidden dim 32, one shared transition
  ``0.9 I + 0.01 N(0, 1)`` (``bench.py:981-989``); ``log_prob`` runs K5a,
  ``filter`` K5b over the expanded chain;
- ``heterogeneous`` (``8.4000.16.4``): 8 sequences of T=4000, hidden dim
  16, a transition per step ``0.9 I + 0.02 N(0, 1)`` of shape (T, 16, 16)
  (``bench.py:820-822``); ``log_prob`` runs K5b.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.gamma_gaussian_hmm --config homogeneous
    python -m pyro_tpu_torch.examples.gamma_gaussian_hmm --config heterogeneous
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch import distributions as dist
from pyro_tpu_torch.examples.gaussian_hmm import INIT_SCALE, OBS_SCALE, TRANS_SCALE, params_from_jax

CONFIGS = {
    # sequences, T, hidden, obs, the transition's noise around 0.9 I
    "homogeneous": {"batch": 8, "T": 10_000, "hidden": 32, "obs": 4, "trans_noise": 0.01, "varying": False},
    "heterogeneous": {"batch": 8, "T": 4000, "hidden": 16, "obs": 4, "trans_noise": 0.02, "varying": True},
}
SCALE_CONCENTRATION = SCALE_RATE = 2.0  # Gamma(df / 2, df / 2) with df = 4

__all__ = ["CONFIGS", "make_arrays", "make_hmm", "params_from_jax"]


def make_arrays(config, seed=0, **overrides):
    """The model's parameter arrays and the data (batch, T, obs), numpy
    float32, by name: ``scale_concentration``, ``scale_rate``, ``init_loc``,
    ``init_scale``, ``trans_mat``, ``trans_loc``, ``trans_scale``,
    ``obs_mat``, ``obs_loc``, ``obs_scale`` and ``data``.  ``overrides``
    replace entries of the configuration (the tests' small sizes)."""
    c = {**CONFIGS[config], **overrides}
    h, o, T = c["hidden"], c["obs"], c["T"]
    rng = np.random.default_rng(seed)
    out = {
        "scale_concentration": np.array(SCALE_CONCENTRATION), "scale_rate": np.array(SCALE_RATE),
        "init_loc": np.zeros(h), "init_scale": np.full(h, INIT_SCALE),
        "trans_mat": 0.9 * np.eye(h) + c["trans_noise"] * rng.standard_normal((T, h, h) if c["varying"] else (h, h)),
        "trans_loc": np.zeros(h), "trans_scale": np.full(h, TRANS_SCALE),
        "obs_mat": rng.standard_normal((h, o)) / h**0.5,
        "obs_loc": np.zeros(o), "obs_scale": np.full(o, OBS_SCALE),
        "data": rng.standard_normal((c["batch"], T, o)),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def make_hmm(params, duration):
    """The GammaGaussianHMM of ``params`` (tensors by the names of ``make_arrays``)."""
    return dist.GammaGaussianHMM(
        dist.Gamma(params["scale_concentration"], params["scale_rate"]),
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
    params = params_from_jax(make_arrays(args.config, args.seed))
    data = params.pop("data")
    hmm = make_hmm(params, CONFIGS[args.config]["T"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        for label, fn in (("log_prob", lambda: hmm.log_prob(data)),
                          ("filter", lambda: hmm.filter(data)[1].loc)):
            out = fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                out = fn()
            sync()
            dt = (time.perf_counter() - t0) / args.calls
            print(f"{args.config} {label} on {device}: {1e3 * dt:.3f} ms a call, {data.shape[0] / dt:.1f} "
                  f"sequences a second, output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")


if __name__ == "__main__":
    main()
