"""Modeling primitives (counterpart of ``pyro_tpu/primitives.py``):
sample, param, factor, deterministic, plate, markov, vectorized_markov and
module."""

from __future__ import annotations

from typing import Optional

import torch

from .distributions import constraints as _constraints
from .distributions.delta import Delta, Unit
from .params.param_store import get_param_store, param_with_module_name
from .poutine.enum_messenger import markov
from .poutine.plate_messenger import PlateMessenger
from .poutine.runtime import am_i_wrapped, apply_stack, new_message
from .poutine.vectorized_markov import vectorized_markov


def sample(name: str, fn, *args, obs=None, rng_key=None, infer: Optional[dict] = None, sample_shape=(), **kwargs):
    """Draw (or observe) a value at a named site.  ``rng_key`` is an optional
    ``torch.Generator``; without handlers this is a plain draw from ``fn``."""
    if not am_i_wrapped():
        if obs is not None:
            return obs
        return fn(*args, rng_key=rng_key, sample_shape=sample_shape, **kwargs)
    kwargs["sample_shape"] = sample_shape
    msg = new_message("sample", name, fn, args, kwargs, value=obs, infer=infer or {})
    msg["is_observed"] = obs is not None
    msg["rng_key"] = rng_key
    return apply_stack(msg)["value"]


def param(name: str, init_value=None, constraint=_constraints.real, event_dim: Optional[int] = None):
    """Register or fetch a learnable parameter; ``init_value`` may be a
    callable, evaluated only when the parameter is created."""
    store = get_param_store()
    if not am_i_wrapped():
        return store.get_param(name, init_value, constraint, event_dim)
    msg = new_message(
        "param", name, _param_fn, (name, init_value), {"constraint": constraint, "event_dim": event_dim}
    )
    return apply_stack(msg)["value"]


def _param_fn(name, init_value, constraint=_constraints.real, event_dim=None):
    return get_param_store().get_param(name, init_value, constraint, event_dim)


def factor(name: str, log_factor, *, has_rsample: Optional[bool] = None):
    """Add ``log_factor`` to the model's log density: an observed ``Unit``
    site, marked auxiliary."""
    unit_dist = Unit(log_factor, has_rsample=has_rsample)
    unit_value = unit_dist.log_factor.new_zeros(unit_dist.shape())
    sample(name, unit_dist, obs=unit_value, infer={"is_auxiliary": True})


def deterministic(name: str, value, event_dim: Optional[int] = None):
    """Record a deterministic function of other sites: a ``Delta`` site
    observed at ``value``, marked ``_deterministic`` so that inference
    scores nothing there."""
    event_dim = value.ndim if event_dim is None else event_dim
    return sample(name, Delta(value, event_dim=event_dim), obs=value, infer={"_deterministic": True})


def plate(name: str, size: int, dim: Optional[int] = None) -> PlateMessenger:
    """Vectorised conditional-independence context (no subsampling yet)."""
    return PlateMessenger(name, size, dim=dim)


def module(name: str, nn_module: torch.nn.Module) -> torch.nn.Module:
    """Register a ``torch.nn.Module``'s parameters in the param store under
    ``{name}$$${param}`` and return the module.

    A parameter the store already holds under that name (set there before,
    for example loaded weights) is copied into the module, and the module's
    own parameter becomes the store's leaf, so the optimizer and the module
    see one tensor.
    """
    store = get_param_store()
    for param_name, p in nn_module.named_parameters():
        full_name = param_with_module_name(name, param_name)
        if full_name in store and store.get_unconstrained(full_name) is not p:
            with torch.no_grad():
                p.copy_(store.get_unconstrained(full_name))
            store.set_unconstrained(full_name, p)
        param(full_name, p)
    return nn_module
