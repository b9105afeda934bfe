"""Importance-trace construction, the SVI hot path (counterpart of
``get_importance_trace`` in ``pyro_tpu/infer/enum.py``)."""

from __future__ import annotations

from typing import Optional

from .. import poutine
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
