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


def init_to_uniform(site=None, radius: float = 2.0):
    """A uniform draw in [-radius, radius) of the unconstrained space."""
    if site is None:
        return functools.partial(init_to_uniform, radius=radius)
    t = biject_to(site["fn"].support)
    u = t.inv(site["fn"].sample(_generator(0)))
    noise = torch.rand(u.shape, generator=_generator(16), dtype=u.dtype, device=u.device)
    return t(-radius + 2 * radius * noise)


def init_to_value(site=None, values=None, fallback=init_to_uniform):
    """The value given for the site by name, else ``fallback``'s."""
    if site is None:
        return functools.partial(init_to_value, values=values, fallback=fallback)
    values = values or {}
    if site["name"] in values:
        return torch.as_tensor(values[site["name"]])
    return fallback(site)
