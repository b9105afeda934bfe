"""Eight schools by NUTS over a batch of chains (counterpart of
``examples/eight_schools.py``).

Run on the card:  python -m pyro_tpu_torch.examples.eight_schools --num-chains 1024
(``--cpu`` for the CPU)
"""

from __future__ import annotations

import argparse

import torch

import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch.infer import MCMC, NUTS

Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def data():
    """The schools' estimated effects and their standard errors, on the
    package's device."""
    device = pyro.get_default_device()
    return torch.tensor(Y, device=device), torch.tensor(SIGMA, device=device)


def model(y, sigma):
    mu = pyro.sample("mu", dist.Normal(0.0, 5.0))
    tau = pyro.sample("tau", dist.HalfCauchy(5.0))
    with pyro.plate("J", y.shape[0]):
        eta = pyro.sample("eta", dist.Normal(0.0, 1.0))
        theta = pyro.deterministic("theta", mu + tau * eta)
        pyro.sample("obs", dist.Normal(theta, sigma), obs=y)


def main(args):
    generator = torch.Generator(device=pyro.get_default_device()).manual_seed(args.seed)
    mcmc = MCMC(NUTS(model), num_samples=args.num_samples, warmup_steps=args.warmup_steps, num_chains=args.num_chains)
    mcmc.run(*data(), generator=generator)
    mcmc.summary()
    return mcmc


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-samples", type=int, default=1000)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--num-chains", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    if args.cpu:
        pyro.set_default_device("cpu")
    main(args)
