"""Regional SIR epidemiology: coupled regions (counterpart of
``examples/epidemiology_regional.py``).

An epidemic over ``--num-regions`` coupled regions is drawn from a
``RegionalSIRModel`` prior (seeds ``--seed``, ``--seed`` + 1, ... until
enough infections are observed); R0 and the response rates are inferred by
relaxed SVI (or ``--mcmc``; ``--num-quant-bins 4`` for the quantized
mode, whose chains of regions run through K3f on the card), then the
model forecasts.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.epidemiology_regional --duration 16 --forecast 4
"""

from __future__ import annotations

import argparse

import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.contrib.epidemiology import RegionalSIRModel


def make_model(args, data):
    assert 0 <= args.coupling <= 1, args.coupling
    population = torch.full((args.num_regions,), float(args.population))
    coupling = torch.eye(args.num_regions).clamp(min=args.coupling)
    return RegionalSIRModel(population, coupling, args.recovery_time, data)


def generate_data(args):
    """A prior draw with at least ``min_observations`` observed infections
    within the inference window: (T, regions) observations."""
    device = pyro.get_default_device()
    extended = make_model(args, torch.zeros((args.duration + args.forecast, args.num_regions)))
    for attempt in range(100):
        sample = extended.generate(
            {"R0": args.basic_reproduction_number, "rho": torch.full((args.num_regions,), args.response_rate)},
            generator=torch.Generator(device=device).manual_seed(args.seed + attempt),
        )
        obs = torch.stack([sample[f"obs_{t}"] for t in range(args.duration + args.forecast)])
        n_obs = float(obs[: args.duration].sum())
        if n_obs >= args.min_observations:
            print("observed %d infections over %d regions during the inference window" % (int(n_obs), args.num_regions))
            return obs
    raise RuntimeError("failed to generate a plausible epidemic")


def main(args):
    if args.cpu:
        pyro.set_default_device("cpu")
    pyro.clear_param_store()
    obs = generate_data(args)
    model = make_model(args, obs[: args.duration])
    generator = torch.Generator(device=pyro.get_default_device()).manual_seed(args.seed)

    if args.mcmc:
        model.fit_mcmc(num_samples=args.num_samples, warmup_steps=args.warmup, num_chains=args.num_chains,
                       num_quant_bins=args.num_quant_bins, generator=generator)
    else:
        losses = model.fit_svi(num_steps=args.num_steps, learning_rate=args.learning_rate,
                               num_particles=args.num_particles, generator=generator)
        print("svi loss: first=%.1f last=%.1f" % (losses[0], losses[-1]))

    samples = model.predict(forecast=args.forecast, generator=generator)
    r0 = samples["R0"].cpu().numpy()
    print("inferred R0: %.2f +- %.2f (true %.2f)" % (r0.mean(), r0.std(), args.basic_reproduction_number))
    return float(r0.mean())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Regional SIR epidemiology modeling")
    p.add_argument("--num-regions", type=int, default=3)
    p.add_argument("--coupling", type=float, default=0.1)
    p.add_argument("--population", type=int, default=1000)
    p.add_argument("--recovery-time", type=float, default=7.0)
    p.add_argument("--basic-reproduction-number", type=float, default=1.5)
    p.add_argument("--response-rate", type=float, default=0.5)
    p.add_argument("--duration", type=int, default=16)
    p.add_argument("--forecast", type=int, default=4)
    p.add_argument("--min-observations", type=int, default=3)
    p.add_argument("--mcmc", action="store_true")
    p.add_argument("--num-quant-bins", type=int, default=1, choices=(1, 2, 4, 8))
    p.add_argument("--num-steps", type=int, default=500)
    p.add_argument("--num-particles", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--num-chains", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
