"""Discrete HMMs of ``examples/hmm.py`` trained with SVI.

* model 7 (``--model 7``, the default) fuses a neural-emission HMM into one
  ``DiscreteHMM`` sample statement, so training runs the exact O(log T)
  marginalisation, whose log-matmul-exp is the CUDA kernel on the card.
  With no enumerated site, ``Trace_ELBO`` gives the loss that
  ``TraceEnum_ELBO`` gives in the JAX example.
* model 1v (``--model 1v``) is the HMM with Bernoulli tones, its time
  dimension vectorized by ``vectorized_markov`` and its hidden states
  enumerated; ``TraceEnum_ELBO`` eliminates the chain with the Markov-chain
  scan, the CUDA kernel of ``ops/markov_scan.py`` on the card.
* model 1vt (``--model 1vt``) is model 1v with a transition matrix per
  step (``probs_x`` of shape (T, H, H)); its chain goes through the
  time-varying scan, ``markov_scan_tv`` (K2g on the card).
* model 1 (``--model 1``) is the HMM of model 1v unrolled over time under
  ``pyro.markov``, the enumeration engine's own path (no scan).

Run on the card:  python -m pyro_tpu_torch.examples.hmm --model 1v --num-steps 20
(``--cpu`` for the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch import poutine
from pyro_tpu_torch.infer import SVI, Trace_ELBO, TraceEnum_ELBO
from pyro_tpu_torch.infer.autoguide import AutoDelta
from pyro_tpu_torch.ops.indexing import Vindex
from pyro_tpu_torch.optim import Adam


class TonesGenerator(nn.Module):
    """Neural emitter: logits of every tone from the hidden state and the
    previous step's tones.  Inputs keep the JAX layout: ``x`` is an int
    (..., 1) state index, ``y`` the (..., data_dim) tones; the convolution
    runs over the tones with one input channel (flax NWC ``y[..., None]``)."""

    def __init__(self, hidden_dim: int, nn_dim: int, nn_channels: int, data_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv = nn.Conv1d(1, nn_channels, 3, padding=1)  # flax Conv_0, SAME padding
        self.dense_x = nn.Linear(hidden_dim, nn_dim)  # Dense_0
        self.dense_y = nn.Linear(nn_channels * data_dim, nn_dim)  # Dense_1
        self.dense_out = nn.Linear(nn_dim, data_dim)  # Dense_2

    def forward(self, x, y):
        x_onehot = F.one_hot(x[..., 0], self.hidden_dim).to(y.dtype)
        y_conv = F.relu(self.conv(y.reshape(-1, 1, y.shape[-1])))  # (n, C, D)
        # flatten as flax does: tones major, channels minor
        y_conv = y_conv.transpose(1, 2).reshape(y.shape[:-1] + (-1,))
        h = F.relu(self.dense_x(x_onehot) + self.dense_y(y_conv))
        return self.dense_out(h)


# flax param path -> (module attribute, how the flax array maps onto it)
_FLAX_LAYERS = {"Conv_0": "conv", "Dense_0": "dense_x", "Dense_1": "dense_y", "Dense_2": "dense_out"}


def params_from_jax(named):
    """Map the JAX store's unconstrained model_7, 1v, 1vt or 1 params (name ->
    numpy array) onto this package's names: flax Dense kernels (in, out)
    become ``nn.Linear`` weights (out, in), the flax Conv kernel (width, in,
    out) becomes the ``Conv1d`` weight (out, in, width); biases,
    ``AutoDelta.probs_x`` (stick-breaking coordinates) and
    ``AutoDelta.probs_y`` (logits) are copied as is."""
    device = pyro.get_default_device()
    out = {}
    for name, value in named.items():
        value = torch.tensor(np.array(value), dtype=torch.float32, device=device)
        if name.startswith("tones_generator$$$"):
            path = [p.strip("'") for p in name.split("$$$")[1].strip("[]").split("][")]
            layer, kind = _FLAX_LAYERS[path[1]], path[2]
            if kind == "kernel":
                value = value.permute(2, 1, 0) if layer == "conv" else value.T
                kind = "weight"
            name = f"tones_generator$$${layer}.{kind}"
        out[name] = value.contiguous()
    return out


def model_7(sequences, lengths, args, include_prior=True):
    """model_5 fused into a single DiscreteHMM sample statement."""
    num_sequences, max_length, data_dim = sequences.shape
    device = sequences.device
    tones_generator = pyro.module("tones_generator", args.tones_generator)
    with poutine.mask(mask=include_prior):
        probs_x = pyro.sample(
            "probs_x",
            dist.Dirichlet(0.9 * torch.eye(args.hidden_dim, device=device) + 0.1).to_event(1),
        )
    with pyro.plate("sequences", num_sequences, dim=-1):
        y = sequences  # (seq, T, D)
        x = torch.arange(args.hidden_dim, device=device)[:, None]  # (H, 1)
        init_logits = torch.full((args.hidden_dim,), -torch.inf, device=device)
        init_logits[0] = 0.0
        trans_logits = torch.log(probs_x)
        # logits (seq, T, H, D): the generator at every state and step at once
        logits = tones_generator(x, y[..., None, :])
        obs_dist = dist.Bernoulli(logits=logits).to_event(1)
        t_arr = torch.arange(max_length, device=device)
        obs_dist = obs_dist.mask((t_arr < lengths[:, None])[..., None])
        hmm_dist = dist.DiscreteHMM(init_logits, trans_logits, obs_dist)
        pyro.sample("y", hmm_dist, obs=y)


def model_1v(sequences, lengths, args, include_prior=True):
    """The HMM with Bernoulli tones, vectorized over sequences (dim -3) and,
    by ``vectorized_markov``, over time (dim -2); tones at dim -1."""
    num_sequences, max_length, data_dim = sequences.shape
    device = sequences.device
    with poutine.mask(mask=include_prior):
        probs_x = pyro.sample(
            "probs_x",
            dist.Dirichlet(0.9 * torch.eye(args.hidden_dim, device=device) + 0.1).to_event(1),
        )
        probs_y = pyro.sample(
            "probs_y",
            dist.Beta(torch.full((), 0.1, device=device), torch.full((), 0.9, device=device))
            .expand((args.hidden_dim, data_dim))
            .to_event(2),
        )
    tones_plate = pyro.plate("tones", data_dim, dim=-1)
    with pyro.plate("sequences", num_sequences, dim=-3) as batch:
        lengths_b = lengths[batch]
        batch = batch[:, None]
        x_prev = 0
        for t in pyro.vectorized_markov(name="time", size=max_length, dim=-2):
            with poutine.mask(mask=(t < lengths_b[:, None])[..., None]):
                x_curr = pyro.sample(
                    f"x_{t}",
                    dist.Categorical(Vindex(probs_x)[..., x_prev, :]),
                    infer={"enumerate": "parallel"},
                )
                with tones_plate:
                    pyro.sample(
                        f"y_{t}",
                        dist.Bernoulli(Vindex(probs_y)[..., x_curr.squeeze(-1), :]),
                        obs=Vindex(sequences)[batch, t],
                    )
                x_prev = x_curr


def model_1vt(sequences, lengths, args, include_prior=True):
    """model_1v with a transition matrix per step: x_t ~ Categorical(
    probs_x[t, x_{t-1}]), x_{-1} = 0; ``probs_x`` (T, H, H) has the prior
    Dirichlet(0.9 I + 0.1) at every step.  Constants take the data's dtype."""
    num_sequences, max_length, data_dim = sequences.shape
    device, dtype = sequences.device, sequences.dtype
    with poutine.mask(mask=include_prior):
        probs_x = pyro.sample(
            "probs_x",
            dist.Dirichlet(0.9 * torch.eye(args.hidden_dim, device=device, dtype=dtype) + 0.1)
            .expand((max_length, args.hidden_dim))
            .to_event(2),
        )
        probs_y = pyro.sample(
            "probs_y",
            dist.Beta(torch.full((), 0.1, device=device, dtype=dtype), torch.full((), 0.9, device=device, dtype=dtype))
            .expand((args.hidden_dim, data_dim))
            .to_event(2),
        )
    tones_plate = pyro.plate("tones", data_dim, dim=-1)
    with pyro.plate("sequences", num_sequences, dim=-3) as batch:
        lengths_b = lengths[batch]
        batch = batch[:, None]
        x_prev = 0
        for t in pyro.vectorized_markov(name="time", size=max_length, dim=-2):
            with poutine.mask(mask=(t < lengths_b[:, None])[..., None]):
                step = t if isinstance(t, int) else t[:, None]
                x_curr = pyro.sample(
                    f"x_{t}",
                    dist.Categorical(Vindex(probs_x)[..., step, x_prev, :]),
                    infer={"enumerate": "parallel"},
                )
                with tones_plate:
                    pyro.sample(
                        f"y_{t}",
                        dist.Bernoulli(Vindex(probs_y)[..., x_curr.squeeze(-1), :]),
                        obs=Vindex(sequences)[batch, t],
                    )
                x_prev = x_curr


def model_1(sequences, lengths, args, include_prior=True):
    """The HMM with Bernoulli tones, vectorized over sequences (dim -2) and
    unrolled over time under ``pyro.markov``; tones at dim -1."""
    num_sequences, max_length, data_dim = sequences.shape
    device = sequences.device
    with poutine.mask(mask=include_prior):
        probs_x = pyro.sample(
            "probs_x",
            dist.Dirichlet(0.9 * torch.eye(args.hidden_dim, device=device) + 0.1).to_event(1),
        )
        probs_y = pyro.sample(
            "probs_y",
            dist.Beta(torch.full((), 0.1, device=device), torch.full((), 0.9, device=device))
            .expand((args.hidden_dim, data_dim))
            .to_event(2),
        )
    tones_plate = pyro.plate("tones", data_dim, dim=-1)
    with pyro.plate("sequences", num_sequences, dim=-2):
        x = torch.zeros((), dtype=torch.long, device=device)
        for t in pyro.markov(range(max_length)):
            with poutine.mask(mask=(t < lengths)[:, None]):
                x = pyro.sample(
                    f"x_{t}",
                    dist.Categorical(Vindex(probs_x)[..., x, :]),
                    infer={"enumerate": "parallel"},
                )
                with tones_plate:
                    pyro.sample(
                        f"y_{t}",
                        dist.Bernoulli(Vindex(probs_y)[..., x.squeeze(-1), :]),
                        obs=sequences[:, t],
                    )


# the enumerated models: --model name -> (model, max_plate_nesting)
ENUM_MODELS = {"1v": (model_1v, 3), "1vt": (model_1vt, 3), "1": (model_1, 2)}


def synthetic_sequences(seed, num_sequences, max_length, data_dim, hidden_dim=4):
    """Sequences sampled with numpy from a random ground-truth HMM."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(0.5 * np.ones(hidden_dim), size=hidden_dim)
    emit = rng.beta(0.3, 1.5, size=(hidden_dim, data_dim))
    z = rng.integers(hidden_dim, size=num_sequences)
    ys = np.empty((num_sequences, max_length, data_dim), np.float32)
    for t in range(max_length):
        u = rng.random(num_sequences)[:, None]
        z = (u > np.cumsum(trans[z], axis=-1)).sum(-1).clip(max=hidden_dim - 1)
        ys[:, t] = rng.random((num_sequences, data_dim)) < emit[z]
    device = pyro.get_default_device()
    return torch.tensor(ys, device=device), torch.full((num_sequences,), max_length, device=device)


def _is_global(msg):
    return msg["name"].startswith("probs_")


def make_svi(args, lr=0.05):
    """The model chosen by ``args.model`` (7 when unset), its AutoDelta guide
    and SVI with Adam, as ``examples/hmm.py::main`` builds them: model_7
    with Trace_ELBO (sets ``args.tones_generator``), the enumerated models
    (1v, 1vt, 1) with ``TraceEnum_ELBO`` at their ``ENUM_MODELS`` plate
    nesting (3, 3, 2)."""
    name = str(getattr(args, "model", "7"))
    if name in ENUM_MODELS:
        enum_model, nesting = ENUM_MODELS[name]

        def model_v(sequences, lengths):
            return enum_model(sequences, lengths, args)

        guide = AutoDelta(poutine.block(model_v, expose_fn=_is_global))
        elbo = TraceEnum_ELBO(max_plate_nesting=nesting)
        return model_v, guide, SVI(model_v, guide, Adam({"lr": lr}), elbo, seed=args.seed)
    if getattr(args, "tones_generator", None) is None:
        torch.manual_seed(args.seed)
        args.tones_generator = TonesGenerator(args.hidden_dim, args.nn_dim, args.nn_channels, args.data_dim).to(
            pyro.get_default_device()
        )

    def model(sequences, lengths):
        return model_7(sequences, lengths, args)

    guide = AutoDelta(poutine.block(model, expose_fn=_is_global))
    return model, guide, SVI(model, guide, Adam({"lr": lr}), Trace_ELBO(), seed=args.seed)


def run(args):
    """Train the chosen model on synthetic sequences; returns the per-step losses."""
    sequences, lengths = synthetic_sequences(args.seed, args.num_sequences, args.max_length, args.data_dim)
    pyro.clear_param_store()
    _, _, svi = make_svi(args, args.learning_rate)
    t0 = time.time()
    losses = []
    for step in range(args.num_steps):
        losses.append(svi.step(sequences, lengths))
        if step % 5 == 0:
            print(f"step {step: 4d}  loss = {losses[-1] / sequences.numel():.4f}")
    dt = time.time() - t0
    print(f"{args.num_steps} steps in {dt:.1f}s ({args.num_steps / dt:.2f} steps/s)")
    return losses


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["7", *ENUM_MODELS], default="7")
    p.add_argument("--hidden-dim", type=int, default=8)
    p.add_argument("--num-sequences", type=int, default=20)
    p.add_argument("--max-length", type=int, default=32)
    p.add_argument("--data-dim", type=int, default=16)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--nn-dim", type=int, default=32)
    p.add_argument("--nn-channels", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)
    args.tones_generator = None
    return args


if __name__ == "__main__":
    args = parse_args()
    if args.cpu:
        pyro.set_default_device("cpu")
    run(args)

