"""Deep Markov model of ``examples/dmm.py`` trained with SVI (Krishnan et
al. 2017; ref ``examples/dmm.py`` of Pyro).

Gated transitions p(z_t | z_{t-1}), a three-layer Bernoulli emitter
p(x_t | z_t), and an amortised guide q(z_t | z_{t-1}, x_{t:T}) whose
summary of the future is a backward relu RNN over the observations.  Each
z chain is one ``NormalMarkovChain`` site: scoring teacher-forces all T
steps in one batched call, and only the guide's ancestral draw and the RNN
run step by step.  Trainable ``z_0``, ``z_q_0`` and ``h_0``; optional IAFs
in the guide (``--num-iafs``).  The defaults are the bench's widths (z 100,
x 88 tones, transition 200, emission 100, rnn 600); the data are synthetic
polyphonic-music-like sequences made from a seed.

Run on the card:  python -m pyro_tpu_torch.examples.dmm
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
from pyro_tpu_torch.distributions.flows import AffineAutoregressive
from pyro_tpu_torch.infer import SVI, Trace_ELBO
from pyro_tpu_torch.nn import RNN, AutoRegressiveNN
from pyro_tpu_torch.optim import ClippedAdam

Z_DIM = 100
X_DIM = 88
TRANS_DIM = 200
EMISSION_DIM = 100
RNN_DIM = 600
IAF_DIM = 50  # the IAFs' hidden width


class GatedTransition(nn.Module):
    """Location and scale of p(z_t | z_{t-1}): a gated mix of the identity
    map (where it starts) and a proposed mean."""

    def __init__(self, z_dim: int = Z_DIM, transition_dim: int = TRANS_DIM):
        super().__init__()
        self.gate_out = nn.Linear(transition_dim, z_dim)  # flax Dense_0
        self.gate_hidden = nn.Linear(z_dim, transition_dim)  # Dense_1
        self.prop_out = nn.Linear(transition_dim, z_dim)  # Dense_2
        self.prop_hidden = nn.Linear(z_dim, transition_dim)  # Dense_3
        self.z_to_loc = nn.Linear(z_dim, z_dim)  # Dense_4
        self.z_to_scale = nn.Linear(z_dim, z_dim)  # Dense_5
        with torch.no_grad():
            self.z_to_loc.weight.copy_(torch.eye(z_dim))
            self.z_to_loc.bias.zero_()

    def forward(self, z):
        gate = torch.sigmoid(self.gate_out(torch.relu(self.gate_hidden(z))))
        prop_mean = self.prop_out(torch.relu(self.prop_hidden(z)))
        loc = (1 - gate) * self.z_to_loc(z) + gate * prop_mean
        scale = F.softplus(self.z_to_scale(torch.relu(prop_mean))) + 1e-3
        return loc, scale


class Emitter(nn.Module):
    """Bernoulli logits of x_t from z_t: three linear layers, two relus."""

    def __init__(self, x_dim: int = X_DIM, z_dim: int = Z_DIM, emission_dim: int = EMISSION_DIM):
        super().__init__()
        self.hidden1 = nn.Linear(z_dim, emission_dim)  # Dense_0
        self.hidden2 = nn.Linear(emission_dim, emission_dim)  # Dense_1
        self.out = nn.Linear(emission_dim, x_dim)  # Dense_2

    def forward(self, z):
        return self.out(torch.relu(self.hidden2(torch.relu(self.hidden1(z)))))


class Combiner(nn.Module):
    """Location and scale of q(z_t | z_{t-1}, x_{t:T}): z_{t-1} projected to
    the RNN's width, averaged with the RNN's state."""

    def __init__(self, z_dim: int = Z_DIM, rnn_dim: int = RNN_DIM):
        super().__init__()
        self.z_to_hidden = nn.Linear(z_dim, rnn_dim)  # Dense_0
        self.hidden_to_loc = nn.Linear(rnn_dim, z_dim)  # Dense_1
        self.hidden_to_scale = nn.Linear(rnn_dim, z_dim)  # Dense_2

    def forward(self, z_prev, h_rnn):
        h = 0.5 * (torch.tanh(self.z_to_hidden(z_prev)) + h_rnn)
        return self.hidden_to_loc(h), F.softplus(self.hidden_to_scale(h)) + 1e-3


class DMM(nn.Module):
    """The networks of the model and the guide, with ``model`` and ``guide``
    that register them in the param store under the JAX package's names."""

    def __init__(
        self,
        x_dim: int = X_DIM,
        z_dim: int = Z_DIM,
        transition_dim: int = TRANS_DIM,
        emission_dim: int = EMISSION_DIM,
        rnn_dim: int = RNN_DIM,
        num_iafs: int = 0,
    ):
        super().__init__()
        self.z_dim, self.rnn_dim = z_dim, rnn_dim
        self.transition = GatedTransition(z_dim, transition_dim)
        self.emitter = Emitter(x_dim, z_dim, emission_dim)
        self.combiner = Combiner(z_dim, rnn_dim)
        # the reference's torch.nn.RNN(nonlinearity='relu') over the reversed
        # sequence: its output at t summarises x_{t:T}
        self.rnn = RNN(x_dim, rnn_dim, cell="relu", reverse=True)
        self.iafs = nn.ModuleList(AutoRegressiveNN(z_dim, [IAF_DIM]) for _ in range(num_iafs))

    def model(self, sequences, annealing_factor=1.0):
        """p(x, z): the z chain is one site, x_t ~ Bernoulli(emitter(z_t))."""
        B, T, _ = sequences.shape
        trans = pyro.module("transition", self.transition)
        emitter = pyro.module("emitter", self.emitter)
        z_0 = pyro.param("z_0", lambda: sequences.new_zeros(self.z_dim))
        with pyro.plate("sequences", B, dim=-1):
            with poutine.scale(scale=annealing_factor):
                z = pyro.sample(
                    "z",
                    dist.NormalMarkovChain(lambda z_prev, _: trans(z_prev), z_0.expand(B, self.z_dim), length=T),
                )
            pyro.sample("x", dist.Bernoulli(logits=emitter(z)).to_event(2), obs=sequences)

    def guide(self, sequences, annealing_factor=1.0):
        """q(z | x): the backward RNN's summaries drive a combiner chain, one
        site, its draws passed through the IAFs."""
        B = sequences.shape[0]
        combiner = pyro.module("combiner", self.combiner)
        rnn = pyro.module("rnn", self.rnn)
        h_0 = pyro.param("h_0", lambda: sequences.new_zeros(self.rnn_dim))
        z_q_0 = pyro.param("z_q_0", lambda: sequences.new_zeros(self.z_dim))
        h, _ = rnn(sequences, h_0.expand(1, B, self.rnn_dim))
        iafs = [AffineAutoregressive(pyro.module(f"iaf_{i}", arn)) for i, arn in enumerate(self.iafs)]
        with pyro.plate("sequences", B, dim=-1):
            with poutine.scale(scale=annealing_factor):
                pyro.sample(
                    "z",
                    dist.NormalMarkovChain(combiner, z_q_0.expand(B, self.z_dim), xs=h, transforms=iafs),
                )


# flax layer name -> this package's attribute, per module
_FLAX_LAYERS = {
    "transition": {
        "Dense_0": "gate_out",
        "Dense_1": "gate_hidden",
        "Dense_2": "prop_out",
        "Dense_3": "prop_hidden",
        "Dense_4": "z_to_loc",
        "Dense_5": "z_to_scale",
    },
    "emitter": {"Dense_0": "hidden1", "Dense_1": "hidden2", "Dense_2": "out"},
    "combiner": {"Dense_0": "z_to_hidden", "Dense_1": "hidden_to_loc", "Dense_2": "hidden_to_scale"},
}


def _port_name(module, path):
    """This package's name of the JAX store's ``module$$$['params'][...]``."""
    if module == "rnn":
        return path[1]  # w_ih_l0, ...: the same names
    layer, kind = path[1], path[-1]
    if module.startswith("iaf_"):  # hidden_layers_0 -> hidden_layers.0
        head, _, index = layer.rpartition("_")
        layer = f"{head}.{index}" if index.isdigit() else layer
    else:
        layer = _FLAX_LAYERS[module][layer]
    return f"{layer}.{'weight' if kind == 'kernel' else kind}"


def params_from_jax(named, dtype=torch.float32):
    """Map the JAX store's DMM params (name -> numpy array) onto this
    package's names, as tensors on its device, float32 unless ``dtype`` is
    given.  flax numbers a compact method's ``Dense`` layers in the
    order their constructors run, and Python builds the callee before its
    argument, so ``Dense(Z)(relu(Dense(H)(z)))`` makes the outer layer
    ``Dense_0``; ``_FLAX_LAYERS`` follows that order.  A flax kernel (in,
    out) becomes a weight (out, in); RNN weights, biases and the plain
    params ``z_0``, ``z_q_0``, ``h_0`` are copied as they are."""
    device = pyro.get_default_device()
    out = {}
    for name, value in named.items():
        value = torch.tensor(np.array(value), dtype=dtype, device=device)
        if "$$$" not in name:
            out[name] = value
            continue
        module, path = name.split("$$$")
        path = [p.strip("'") for p in path.strip("[]").split("][")]
        port = _port_name(module, path)
        out[f"{module}$$${port}"] = (value.T if path[-1] == "kernel" else value).contiguous()
    return out


def synthetic_data(generator: torch.Generator, batch: int, T: int, z_dim: int = Z_DIM, x_dim: int = X_DIM):
    """Binary (batch, T, x_dim) sequences on the generator's device: a
    random walk in z space read out through a random basis, as the JAX
    example draws them."""
    device = generator.device
    basis = torch.randn((z_dim, x_dim), generator=generator, device=device)
    z = torch.cumsum(0.3 * torch.randn((batch, T, z_dim), generator=generator, device=device), dim=1)
    probs = torch.sigmoid(z @ basis)
    return (torch.rand(probs.shape, generator=generator, device=device) < probs).float()


def make_svi(dmm: DMM, lr: float = 3e-3, seed: int = 0) -> SVI:
    """SVI over the DMM's model and guide with Trace_ELBO and ClippedAdam
    (``clip_norm`` 10, as the bench row)."""
    return SVI(dmm.model, dmm.guide, ClippedAdam({"lr": lr, "clip_norm": 10.0}), Trace_ELBO(), seed=seed)


def main(args):
    pyro.clear_param_store()
    torch.manual_seed(args.seed)
    device = pyro.get_default_device()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    data = synthetic_data(generator, args.batch_size, args.length, Z_DIM, X_DIM)
    dmm = DMM(X_DIM, Z_DIM, TRANS_DIM, EMISSION_DIM, RNN_DIM, num_iafs=args.num_iafs).to(device)
    svi = make_svi(dmm, args.learning_rate, args.seed)
    t0 = time.time()
    for step in range(args.num_steps):
        # KL annealing over the first half of training (ref :406-418)
        af = min(1.0, args.min_af + (1.0 - args.min_af) * (step + 1) / max(1, args.num_steps // 2))
        loss = svi.step(data, af)
        if step % 5 == 0:
            print(f"step {step: 4d} loss = {loss / data.numel():.4f}")
    dt = time.time() - t0
    print(f"{args.num_steps} steps in {dt:.1f}s ({args.num_steps / dt:.2f} steps/s)")
    return svi


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--length", type=int, default=20)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--num-iafs", type=int, default=0)
    p.add_argument("--min-af", type=float, default=0.2)
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    if args.cpu:
        pyro.set_default_device("cpu")
    main(args)
