"""Variational autoencoder of ``examples/vae.py`` trained with SVI.

Amortized SVI: a decoder defines p(x|z), an encoder defines q(z|x), and
one step of ``Trace_ELBO`` with Adam trains both.  The guide's latent site
is a reparameterized Normal, so the ELBO's gradient flows pathwise through
the encoder.  The data are synthetic binarized pseudo-digits made with
numpy from a seed.

Run on the card:  python -m pyro_tpu_torch.examples.vae --num-epochs 3
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
from pyro_tpu_torch.infer import SVI, Trace_ELBO
from pyro_tpu_torch.optim import Adam

X_DIM = 784
HIDDEN = 400
Z_DIM = 50


class Decoder(nn.Module):
    """Bernoulli logits of x from z."""

    def __init__(self, x_dim: int = X_DIM, hidden: int = HIDDEN, z_dim: int = Z_DIM):
        super().__init__()
        self.fc = nn.Linear(z_dim, hidden)  # flax Dense_0
        self.out = nn.Linear(hidden, x_dim)  # Dense_1

    def forward(self, z):
        return self.out(F.softplus(self.fc(z)))


class Encoder(nn.Module):
    """Location and scale of q(z|x); the scale is exp of the clamped log scale."""

    def __init__(self, x_dim: int = X_DIM, hidden: int = HIDDEN, z_dim: int = Z_DIM):
        super().__init__()
        self.fc = nn.Linear(x_dim, hidden)  # Dense_0
        self.loc = nn.Linear(hidden, z_dim)  # Dense_1
        self.log_scale = nn.Linear(hidden, z_dim)  # Dense_2

    def forward(self, x):
        h = F.softplus(self.fc(x))
        return self.loc(h), torch.exp(torch.clamp(self.log_scale(h), -5.0, 5.0))


class VAE(nn.Module):
    """Encoder and decoder with the model and guide that use them."""

    def __init__(self, x_dim: int = X_DIM, hidden: int = HIDDEN, z_dim: int = Z_DIM):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = Encoder(x_dim, hidden, z_dim)
        self.decoder = Decoder(x_dim, hidden, z_dim)

    def model(self, x):
        decoder = pyro.module("decoder", self.decoder)
        with pyro.plate("data", x.shape[0]):
            z = pyro.sample("z", dist.Normal(x.new_zeros(self.z_dim), 1.0).to_event(1))
            pyro.sample("obs", dist.Bernoulli(logits=decoder(z)).to_event(1), obs=x)

    def guide(self, x):
        encoder = pyro.module("encoder", self.encoder)
        with pyro.plate("data", x.shape[0]):
            loc, scale = encoder(x)
            pyro.sample("z", dist.Normal(loc, scale).to_event(1))


# flax layer name -> this package's attribute, per module
_FLAX_LAYERS = {
    "encoder": {"Dense_0": "fc", "Dense_1": "loc", "Dense_2": "log_scale"},
    "decoder": {"Dense_0": "fc", "Dense_1": "out"},
}


def params_from_jax(named):
    """Map the JAX store's VAE params (``encoder$$$['params']['Dense_0']
    ['kernel']`` and so on; name -> numpy array) onto this package's names:
    a flax Dense kernel (in, out) becomes an ``nn.Linear`` weight (out, in),
    a bias is copied as is."""
    device = pyro.get_default_device()
    out = {}
    for name, value in named.items():
        module, path = name.split("$$$")
        path = [p.strip("'") for p in path.strip("[]").split("][")]
        layer, kind = _FLAX_LAYERS[module][path[1]], path[2]
        value = torch.tensor(np.array(value), dtype=torch.float32, device=device)
        if kind == "kernel":
            value, kind = value.T, "weight"
        out[f"{module}$$${layer}.{kind}"] = value.contiguous()
    return out


def synthetic_batches(seed: int, num_batches: int, batch_size: int, x_dim: int = X_DIM):
    """Binarized pseudo-digits from random low-rank logits, made with numpy:
    a (num_batches, batch_size, x_dim) float tensor of zeros and ones."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((16, x_dim))
    codes = rng.standard_normal((num_batches, batch_size, 16))
    probs = 1.0 / (1.0 + np.exp(-2.0 * codes @ basis))
    data = (rng.random(probs.shape) < probs).astype(np.float32)
    return torch.tensor(data, device=pyro.get_default_device())


def make_svi(vae: VAE, lr: float = 1e-3, seed: int = 0) -> SVI:
    """SVI over the VAE's model and guide with Trace_ELBO and Adam."""
    return SVI(vae.model, vae.guide, Adam({"lr": lr}), Trace_ELBO(), seed=seed)


def main(args):
    pyro.clear_param_store()
    torch.manual_seed(args.seed)
    vae = VAE().to(pyro.get_default_device())
    data = synthetic_batches(args.seed, args.num_batches, args.batch_size)
    svi = make_svi(vae, args.learning_rate, args.seed)
    generator = torch.Generator(device=pyro.get_default_device()).manual_seed(args.seed)
    for epoch in range(args.num_epochs):
        t0 = time.time()
        total = 0.0
        for i in range(args.num_batches):
            total += svi.step(data[i], generator=generator)
        dt = time.time() - t0
        print(f"epoch {epoch}: elbo = {-total / args.num_batches:.1f} ({args.num_batches / dt:.1f} steps/s)")
    return svi


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--num-batches", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    if args.cpu:
        pyro.set_default_device("cpu")
    main(args)
