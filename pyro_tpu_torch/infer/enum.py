"""Importance-trace construction, the SVI hot path, and enumeration's
configuration and queue steps (counterpart of ``pyro_tpu/infer/enum.py``)."""

from __future__ import annotations

import functools
from typing import Optional

from .. import poutine
from ..poutine.plate_messenger import _Subsample
from ..poutine.util import prune_subsample_sites
from ..util import check_model_guide_match, check_site_shape, is_validation_enabled


def get_importance_trace(max_plate_nesting: Optional[float], model, guide, args, kwargs, generator=None):
    """Run the guide, replay the model against it, and return both traces
    with log-probs (model) and score parts (guide) computed.  The guide's
    sample sites draw from ``generator``."""
    guide_fn = poutine.seed(guide, rng_seed=generator) if generator is not None else guide
    guide_trace = poutine.trace(guide_fn).get_trace(*args, **kwargs)
    model_fn = poutine.replay(model, trace=guide_trace)
    if generator is not None:
        model_fn = poutine.seed(model_fn, rng_seed=generator)
    model_trace = poutine.trace(model_fn).get_trace(*args, **kwargs)

    if is_validation_enabled():
        check_model_guide_match(model_trace, guide_trace)

    guide_trace = prune_subsample_sites(guide_trace)
    model_trace = prune_subsample_sites(model_trace)
    model_trace.compute_log_prob()
    guide_trace.compute_score_parts()
    if is_validation_enabled() and max_plate_nesting is not None and max_plate_nesting != float("inf"):
        for tr in (model_trace, guide_trace):
            for site in tr.nodes.values():
                if site["type"] == "sample":
                    check_site_shape(site, int(max_plate_nesting))
    return model_trace, guide_trace


def _check_sequential_num_samples(infer):
    if infer.get("enumerate") == "sequential" and infer.get("num_samples") is not None:
        raise ValueError(
            'enumerate="sequential" with num_samples is not supported: the queue expands the whole support, '
            "which a num_samples weight of 1/num_samples would mis-count; use one of the two"
        )


def config_enumerate(guide=None, default: str = "parallel", expand: bool = False, num_samples=None,
                     tmc: str = "diagonal"):
    """Mark every discrete sample site of ``guide`` (a model too) for
    enumeration by ``default`` ("parallel", "sequential" or "flat"), unless
    the site says otherwise.  With ``num_samples`` every unobserved site,
    continuous ones included, takes that many draws in place of its support
    (sampled enumeration, with the ``tmc`` strategy "diagonal" or
    "mixture")."""
    if guide is None:
        return functools.partial(config_enumerate, default=default, expand=expand, num_samples=num_samples, tmc=tmc)
    if default not in (None, "sequential", "parallel", "flat"):
        raise ValueError(f"invalid default value: {default}")
    _check_sequential_num_samples({"enumerate": default, "num_samples": num_samples})

    def config_fn(msg):
        if msg["type"] != "sample" or msg["is_observed"] or isinstance(msg["fn"], _Subsample):
            return {}
        if num_samples is not None:
            return {
                "enumerate": msg["infer"].get("enumerate", default),
                "num_samples": msg["infer"].get("num_samples", num_samples),
                "expand": msg["infer"].get("expand", expand),
                "tmc": msg["infer"].get("tmc", tmc),
            }
        if not getattr(msg["fn"], "has_enumerate_support", False):
            return {}
        config = {"enumerate": msg["infer"].get("enumerate", default)}
        if expand:
            config["expand"] = True
        return config

    return poutine.infer_config(guide, config_fn=config_fn)


def iter_discrete_escape(trace, msg) -> bool:
    """Whether ``msg`` is a sequentially enumerated sample site that the
    partial ``trace`` has not fixed yet: the queue stops the guide there."""
    return (
        msg["type"] == "sample"
        and not msg["is_observed"]
        and msg["infer"].get("enumerate") == "sequential"
        and msg["name"] not in trace
    )


def iter_discrete_extend(trace, site):
    """The partial ``trace`` extended by each value of the escaped ``site``'s
    support, one trace a value, each site recording the support's size as
    ``_enum_total`` for the DiCE weights."""
    _check_sequential_num_samples(site["infer"])
    values = site["fn"].enumerate_support(expand=site["infer"].get("expand", False))
    enum_total = int(values.shape[0])
    extended = []
    for value in values:
        ext_site = dict(site, infer=dict(site["infer"], _enum_total=enum_total), value=value)
        ext_site.pop("continuation", None)
        tr = trace.copy()
        tr.add_node(site["name"], **ext_site)
        extended.append(tr)
    return extended
