"""SIR epidemiology: generate, infer, forecast (counterpart of
``examples/epidemiology_sir.py``).

An epidemic is drawn from a ``SimpleSIRModel`` prior (seeds ``--seed``,
``--seed`` + 1, ... until it is large enough); R0 and the response rate
are inferred by relaxed SVI (or ``--mcmc``), and the model forecasts
``--forecast`` steps past the data.

Run on the card (``--cpu`` for the CPU)::

    python -m pyro_tpu_torch.examples.epidemiology_sir --duration 20 --forecast 10
"""

from __future__ import annotations

import argparse

import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.contrib.epidemiology import SimpleSIRModel


def generate_data(args):
    """A prior draw with at least ``min_observations`` observed infections
    within the inference window: (observations, the other sites)."""
    device = pyro.get_default_device()
    extended = SimpleSIRModel(args.population, args.recovery_time, torch.zeros(args.duration + args.forecast))
    for attempt in range(100):
        sample = extended.generate(
            {"R0": args.basic_reproduction_number, "rho": args.response_rate},
            generator=torch.Generator(device=device).manual_seed(args.seed + attempt),
        )
        obs = torch.stack([sample[f"obs_{t}"] for t in range(args.duration + args.forecast)])
        if float(obs[: args.duration].sum()) >= args.min_observations:
            truth = {k: v for k, v in sample.items() if not k.startswith("obs")}
            print(
                "generated data: %d observed infections during inference window, %d during forecast"
                % (int(obs[: args.duration].sum()), int(obs[args.duration:].sum()))
            )
            return obs, truth
    raise RuntimeError("failed to generate a plausible epidemic")


def main(args):
    if args.cpu:
        pyro.set_default_device("cpu")
    pyro.clear_param_store()
    obs, truth = generate_data(args)
    model = SimpleSIRModel(args.population, args.recovery_time, obs[: args.duration])
    generator = torch.Generator(device=pyro.get_default_device()).manual_seed(args.seed)

    if args.mcmc:
        model.fit_mcmc(num_samples=args.num_samples, warmup_steps=args.warmup, num_chains=args.num_chains,
                       generator=generator)
    else:
        losses = model.fit_svi(num_steps=args.num_steps, learning_rate=args.learning_rate,
                               num_particles=args.num_particles, generator=generator)
        print(f"svi loss: first={losses[0]:.1f} last={losses[-1]:.1f}")

    samples = model.predict(forecast=args.forecast, generator=generator)
    r0 = samples["R0"].cpu().numpy()
    print("inferred R0: %.2f ± %.2f (true %.2f)" % (r0.mean(), r0.std(), args.basic_reproduction_number))
    return float(r0.mean())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SIR epidemiology modeling")
    p.add_argument("--population", type=int, default=1000)
    p.add_argument("--recovery-time", type=float, default=7.0)
    p.add_argument("--basic-reproduction-number", type=float, default=1.5)
    p.add_argument("--response-rate", type=float, default=0.5)
    p.add_argument("--duration", type=int, default=20)
    p.add_argument("--forecast", type=int, default=10)
    p.add_argument("--min-observations", type=int, default=3)
    p.add_argument("--mcmc", action="store_true")
    p.add_argument("--num-steps", type=int, default=1000)
    p.add_argument("--num-particles", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--num-samples", type=int, default=200)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--num-chains", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
