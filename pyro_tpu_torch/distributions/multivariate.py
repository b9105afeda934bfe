"""Dirichlet (counterpart of the part of
``pyro_tpu/distributions/multivariate.py`` this package uses)."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .util import clamp_probs


def _standard_gamma(concentration, generator):
    """Gamma(concentration, 1) draws.  PyTorch's gamma sampler takes no
    generator, so a seed drawn from ``generator`` seeds it inside a forked
    global RNG state."""
    if generator is None:
        return torch._standard_gamma(concentration)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
    devices = [concentration.device] if concentration.is_cuda else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        return torch._standard_gamma(concentration)


class Dirichlet(Distribution):
    arg_constraints = {"concentration": constraints.independent(constraints.positive, 1)}
    support = constraints.simplex
    has_rsample = True

    def __init__(self, concentration):
        self.concentration = torch.as_tensor(concentration, dtype=torch.get_default_dtype())
        super().__init__(self.concentration.shape[:-1], self.concentration.shape[-1:])

    def rsample(self, generator=None, sample_shape=()):
        g = _standard_gamma(self.concentration.expand(self.shape(sample_shape)), generator)
        return clamp_probs(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        a = self.concentration
        return ((a - 1) * torch.log(value)).sum(-1) + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1)
