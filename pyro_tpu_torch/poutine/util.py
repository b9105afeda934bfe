"""Poutine utilities (counterpart of ``pyro_tpu/poutine/util.py``)."""

from __future__ import annotations


def site_is_subsample(site) -> bool:
    from .plate_messenger import _Subsample

    return site["type"] == "sample" and isinstance(site["fn"], _Subsample)


def prune_subsample_sites(trace):
    """Drop plate index sites from a trace."""
    trace = trace.copy()
    for name, site in list(trace.nodes.items()):
        if site_is_subsample(site):
            del trace.nodes[name]
    return trace
