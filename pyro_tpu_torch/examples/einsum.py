"""The plate-aware log-space einsum (``ubersum``) timed as the plates grow
(counterpart of ``examples/einsum.py``): the log-probability query (the
contraction) and the gradient query (its backward too), at each plate size
from 8 to ``--max-plate-size`` in steps of 8, on the card unless ``--cpu``.

    python -m pyro_tpu_torch.examples.einsum --method all

Operands are uniform in [0.5, 1.5), a plate dim of the plate size and every
other dim of ``--dim-size``, from a generator seeded with the operand's
position.  A time is the mean over ``--iters`` calls after a warm-up call,
with the device synchronised before the clock stops.
"""

from __future__ import annotations

import argparse
import time

import torch

import pyro_tpu_torch as pyro
from pyro_tpu_torch.ops.contract import ubersum


def logprob(equation, *operands, plates=""):
    """The first output of ``ubersum``."""
    return ubersum(equation, *operands, plates=plates)[0]


def gradient(equation, *operands, plates=""):
    """The gradient of the first output's sum by every operand."""
    leaves = [x.detach().requires_grad_() for x in operands]
    return torch.autograd.grad(ubersum(equation, *leaves, plates=plates)[0].sum(), leaves)


def make_operands(equation, plates, plate_size, dim_size, device):
    inputs = equation.split("->")[0].split(",")
    operands = []
    for i, dims in enumerate(inputs):
        shape = tuple(plate_size if d in plates else dim_size for d in dims)
        generator = torch.Generator(device=device).manual_seed(i)
        operands.append(0.5 + torch.rand(shape, generator=generator, device=device))
    return operands


def time_fn(fn, equation, *operands, iters=10, plates=""):
    """Mean seconds a call over ``iters`` calls, after a warm-up call."""
    sync = torch.cuda.synchronize if operands[0].is_cuda else (lambda: None)
    fn(equation, *operands, plates=plates)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(equation, *operands, plates=plates)
    sync()
    return (time.perf_counter() - t0) / iters


def main(args):
    if args.cpu:
        pyro.set_default_device("cpu")
    device = pyro.get_default_device()
    methods = ["logprob", "gradient"] if args.method == "all" else [args.method]
    results = {}
    for method in methods:
        fn = {"logprob": logprob, "gradient": gradient}[method]
        print(f"Plate size  Time per iteration of {method} (ms)")
        for plate_size in range(8, 1 + args.max_plate_size, 8):
            operands = make_operands(args.equation, args.plates, plate_size, args.dim_size, device)
            dt = time_fn(fn, args.equation, *operands, iters=args.iters, plates=args.plates)
            results[(method, plate_size)] = dt * 1e3
            print(f"{plate_size: <11d} {dt * 1e3:0.4g}")
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="plate-aware einsum timing")
    parser.add_argument("-e", "--equation", default="a,abi,bcij,adj,deij->")
    parser.add_argument("-p", "--plates", default="ij")
    parser.add_argument("-d", "--dim-size", default=32, type=int)
    parser.add_argument("-s", "--max-plate-size", default=32, type=int)
    parser.add_argument("-n", "--iters", default=10, type=int)
    parser.add_argument("-m", "--method", default="all", choices=["all", "logprob", "gradient"])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
