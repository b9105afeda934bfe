"""SIR epidemiology with NUTS (counterpart of ``examples/sir_hmc.py``).

An outbreak is simulated with numpy from ``--seed``, then
``SimpleSIRModel.fit_mcmc`` infers R0 and the response rate.  By default
NUTS runs over the relaxed (real-valued) flows, as the JAX example does;
``--num-quant-bins 4`` runs the asymptotically exact quantized mode, whose
time elimination is K3f on the card.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.sir_hmc --population 1000 -n 200
    python -m pyro_tpu_torch.examples.sir_hmc --num-quant-bins 4 --num-chains 4 --max-tree-depth 6
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.contrib.epidemiology import SimpleSIRModel


def generate_data(args):
    """New infections observed each step of a simulated outbreak (numpy,
    ``args.seed``), on the package's device."""
    rng = np.random.RandomState(args.seed)
    S, I = args.population - args.initial_infected, float(args.initial_infected)
    data = []
    for _ in range(args.duration):
        p = 1 - np.exp(-args.R0 / args.recovery_time * I / args.population)
        s2i = rng.binomial(int(S), p)
        i2r = rng.binomial(int(I), 1 / args.recovery_time)
        S -= s2i
        I += s2i - i2r
        data.append(rng.binomial(max(s2i, 1), args.response_rate))
    return torch.tensor(data, dtype=torch.get_default_dtype(), device=pyro.get_default_device())


def main(args):
    if args.cpu:
        pyro.set_default_device("cpu")
    data = generate_data(args)
    print(f"observed new infections: {data.long().tolist()}")

    model = SimpleSIRModel(args.population, args.recovery_time, data)
    mcmc = model.fit_mcmc(
        num_samples=args.num_samples,
        warmup_steps=args.warmup_steps,
        num_chains=args.num_chains,
        max_tree_depth=args.max_tree_depth,
        num_quant_bins=args.num_quant_bins,
        generator=torch.Generator(device=pyro.get_default_device()).manual_seed(args.seed),
    )
    mcmc.summary()
    R0 = model.samples["R0"].cpu().numpy()
    rho = model.samples["rho"].cpu().numpy()
    print(
        f"R0: median {np.median(R0):.2f} (true {args.R0}); "
        f"rho: median {np.median(rho):.2f} (true {args.response_rate})"
    )
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SIR with NUTS")
    p.add_argument("--population", default=1000, type=int)
    p.add_argument("--initial-infected", default=5, type=int)
    p.add_argument("--duration", default=20, type=int)
    p.add_argument("--R0", default=2.0, type=float)
    p.add_argument("--recovery-time", default=4.0, type=float)
    p.add_argument("--response-rate", default=0.5, type=float)
    p.add_argument("-n", "--num-samples", default=200, type=int)
    p.add_argument("-w", "--warmup-steps", default=200, type=int)
    p.add_argument("--num-chains", default=1, type=int)
    p.add_argument("--max-tree-depth", default=8, type=int)
    p.add_argument("--num-quant-bins", default=1, type=int, choices=(1, 2, 4, 8))
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
