"""Automatic guides (counterpart of ``AutoGuide`` and ``AutoDelta`` in
``pyro_tpu/infer/autoguide/guides.py``).

A guide runs the model once to record a prototype trace, then at each call
creates a ``param`` and a ``sample`` statement per latent site of the model,
inside the same plates.
"""

from __future__ import annotations

import functools
from contextlib import ExitStack
from typing import Dict

from ... import poutine
from ...distributions import Delta
from ...poutine.plate_messenger import PlateMessenger
from ...poutine.util import prune_subsample_sites, site_is_subsample
from ...primitives import param as pyro_param
from ...primitives import sample as pyro_sample
from .initialization import init_to_median


def _is_latent(site) -> bool:
    return (
        site["type"] == "sample"
        and not site["is_observed"]
        and not site_is_subsample(site)
        and not site["infer"].get("_deterministic")
        and not site["infer"].get("is_auxiliary")
    )


class AutoGuide:
    def __init__(self, model):
        self.model = model
        self.prototype_trace = None
        self._prototype_frames: Dict[str, tuple] = {}
        self._name = type(self).__name__

    def _setup_prototype(self, *args, **kwargs) -> None:
        with poutine.block():
            trace = poutine.trace(poutine.seed(self.model, rng_seed=0)).get_trace(*args, **kwargs)
        self.prototype_trace = prune_subsample_sites(trace)
        self._prototype_frames = {
            name: tuple(f for f in site["cond_indep_stack"] if f.dim is not None)
            for name, site in self.prototype_trace.nodes.items()
            if _is_latent(site)
        }

    def _create_plates(self):
        return {
            f.name: PlateMessenger(f.name, f.size, dim=f.dim)
            for frames in self._prototype_frames.values()
            for f in frames
        }

    def __call__(self, *args, **kwargs):
        raise NotImplementedError


class AutoDelta(AutoGuide):
    """MAP estimation: a Delta at a learned point per latent site."""

    def __init__(self, model, init_loc_fn=init_to_median):
        super().__init__(model)
        self.init_loc_fn = init_loc_fn

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)
        plates = self._create_plates()
        result = {}
        for name, site in self.prototype_trace.nodes.items():
            if not _is_latent(site):
                continue
            with ExitStack() as stack:
                for f in self._prototype_frames[name]:
                    stack.enter_context(plates[f.name])
                # the initial value is drawn only when the param is created
                value = pyro_param(
                    f"{self._name}.{name}",
                    functools.partial(self.init_loc_fn, site),
                    constraint=site["fn"].support,
                    event_dim=site["fn"].event_dim,
                )
                result[name] = pyro_sample(name, Delta(value, event_dim=site["fn"].event_dim))
        return result
