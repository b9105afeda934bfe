"""Autoguide initialisation strategies (counterpart of
``pyro_tpu/infer/autoguide/initialization.py``)."""

from __future__ import annotations

import functools

import torch

from ...distributions.transforms import biject_to
from ...settings import get_default_device


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device=get_default_device())
    g.manual_seed(seed)
    return g


def init_to_feasible(site=None):
    """The image of zero in the unconstrained space."""
    if site is None:
        return init_to_feasible
    t = biject_to(site["fn"].support)
    value = site["fn"].sample(_generator(0))
    return t(torch.zeros_like(t.inv(value)))


def init_to_median(site=None, num_samples: int = 15):
    """Elementwise median of a few prior draws."""
    if site is None:
        return functools.partial(init_to_median, num_samples=num_samples)
    try:
        with torch.no_grad():
            samples = site["fn"].sample(_generator(23), (num_samples,))
        return samples.median(dim=0).values
    except (NotImplementedError, ValueError):
        return init_to_feasible(site)
