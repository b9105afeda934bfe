"""The ``Parameterized`` base of the GP and time-series modules
(counterpart of ``pyro_tpu/contrib/gp/parameterized.py``).

Attributes registered as parameters become ``pyro.param`` sites (with
their constraints) or, given a prior, ``pyro.sample`` sites with a
per-site guide: a Delta, or with ``autoguide(name, "Normal")`` a Normal in
the unconstrained space pushed through the prior's bijection.  Definitions
are kept per instance and materialised through the effect runtime on every
access, so a model that reads them trains under ``SVI``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from ...distributions import constraints
from ...distributions.continuous import Normal
from ...distributions.delta import Delta
from ...distributions.distribution import TransformedDistribution
from ...distributions.transforms import biject_to
from ...primitives import param as pyro_param
from ...primitives import sample as pyro_sample
from ...settings import get_default_device

_COUNTERS: Dict[str, "itertools.count"] = {}


def _autoname(cls_name: str) -> str:
    c = _COUNTERS.setdefault(cls_name, itertools.count())
    i = next(c)
    return cls_name if i == 0 else f"{cls_name}_{i}"


class Parameterized:
    """A module whose registered parameters are read as Pyro sites named
    ``{name}.{param}``; ``name`` defaults to the class name, numbered from
    the second instance on."""

    def __init__(self, name: Optional[str] = None):
        self._pyro_name = name or _autoname(type(self).__name__)
        self._param_defs: Dict[str, tuple] = {}
        self._priors: Dict[str, object] = {}
        self._guides: Dict[str, str] = {}
        self._mode = "model"

    def _register_param(self, name, init, constraint=constraints.real):
        self._param_defs[name] = (torch.as_tensor(init), constraint)

    def set_prior(self, name, prior) -> None:
        if name not in self._param_defs:
            raise KeyError(f"no parameter '{name}' registered")
        self._priors[name] = prior
        self._guides.setdefault(name, "Delta")

    def autoguide(self, name, guide_type: str = "Delta") -> None:
        """Choose the per-site guide family ('Delta' or 'Normal')."""
        self._guides[name] = guide_type

    @property
    def mode(self) -> str:
        return self._mode

    def set_mode(self, mode: str) -> None:
        assert mode in ("model", "guide")
        self._mode = mode
        for child in self.__dict__.values():
            if isinstance(child, Parameterized):
                child.set_mode(mode)

    def __getattr__(self, name):
        defs = self.__dict__.get("_param_defs")
        if defs is not None and name in defs:
            return self._materialize(name)
        raise AttributeError(f"{type(self).__name__} has no attribute '{name}'")

    def _materialize(self, name):
        init, constraint = self._param_defs[name]
        init = init.to(get_default_device())
        full = f"{self._pyro_name}.{name}"
        prior = self._priors.get(name)
        if prior is None:
            return pyro_param(full, init, constraint=constraint)
        if self._mode == "model":
            return pyro_sample(full, prior)
        guide_type = self._guides.get(name, "Delta")
        t = biject_to(prior.support)
        loc = pyro_param(f"{full}_map", t.inv(init))
        if guide_type == "Delta":
            return pyro_sample(full, Delta(t(loc), event_dim=prior.event_dim))
        scale = pyro_param(f"{full}_scale", torch.full_like(loc, 0.1), constraint=constraints.softplus_positive)
        base = Normal(loc, scale).to_event(loc.ndim)
        return pyro_sample(full, TransformedDistribution(base, t))
