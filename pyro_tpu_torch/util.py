"""Model/guide checks run when validation is on (counterpart of the part of
``pyro_tpu/util.py`` the ELBO uses)."""

from __future__ import annotations

import warnings
from itertools import zip_longest

from .distributions.util import broadcast_shape
from .poutine.util import site_is_subsample

# validation is on unless python runs with -O, as in the JAX package
_VALIDATION_ENABLED = __debug__


def is_validation_enabled() -> bool:
    return _VALIDATION_ENABLED


def check_model_guide_match(model_trace, guide_trace) -> None:
    """Warn on guide sites missing from the model or observed there; raise
    when shared sites have shapes that do not broadcast."""
    model_sites = {
        name for name, site in model_trace.nodes.items() if site["type"] == "sample" and not site_is_subsample(site)
    }
    guide_sites = {
        name
        for name, site in guide_trace.nodes.items()
        if site["type"] == "sample"
        and not site_is_subsample(site)
        and not site["infer"].get("is_auxiliary")
        and not site["infer"].get("_deterministic")
    }
    extra = guide_sites - model_sites
    if extra:
        warnings.warn(f"Found non-auxiliary vars in guide but not model: {extra}")
    observed = {name for name, site in model_trace.nodes.items() if site["type"] == "sample" and site["is_observed"]}
    if observed & guide_sites:
        warnings.warn(f"Found observed sites in guide: {observed & guide_sites}")
    for name in model_sites & guide_sites:
        model_shape = model_trace.nodes[name]["fn"].shape()
        guide_shape = guide_trace.nodes[name]["fn"].shape()
        try:
            broadcast_shape(model_shape, guide_shape)
        except ValueError:
            raise ValueError(f"Model and guide shapes disagree at site '{name}': {model_shape} vs {guide_shape}")


def check_site_shape(site, max_plate_nesting: int) -> None:
    """A site's log_prob must fit its plates: every dim right of
    ``-max_plate_nesting`` is size 1 or declared by a plate."""
    if "log_prob" not in site:
        return
    actual_shape = list(site["log_prob"].shape)
    expected_shape: list = []
    for f in site["cond_indep_stack"]:
        if f.dim is not None:
            if len(expected_shape) < -f.dim:
                expected_shape = [None] * (-f.dim - len(expected_shape)) + expected_shape
            if expected_shape[f.dim] is not None:
                raise ValueError(
                    f'at site "{site["name"]}" within plate("{f.name}", dim={f.dim}), dim collision\n'
                    "Try setting dim arg in other plates."
                )
            expected_shape[f.dim] = f.subsample_size
    expected_shape = [-1 if e is None else e for e in expected_shape]
    if len(expected_shape) > max_plate_nesting:
        raise ValueError(
            f'at site "{site["name"]}", plate stack overflow\n'
            f"Try increasing max_plate_nesting to at least {len(expected_shape)}"
        )
    if max_plate_nesting < len(actual_shape):
        actual_shape = actual_shape[len(actual_shape) - max_plate_nesting:]
    # a model-enumerated site keeps a compact log_prob: size 1 stands for
    # a plate its factor is constant over
    compact_ok = site["infer"].get("_enumerate_dim") is not None
    for actual_size, expected_size in zip_longest(reversed(actual_shape), reversed(expected_shape), fillvalue=1):
        if compact_ok and actual_size == 1:
            continue
        if expected_size != -1 and expected_size != actual_size:
            raise ValueError(
                f'at site "{site["name"]}", invalid log_prob shape\n'
                f"Expected {expected_shape}, actual {actual_shape}\n"
                "Try one of the following fixes:\n"
                "- enclose the batched tensor in a with pyro.plate(...) context\n"
                "- .to_event(...) the distribution being sampled\n"
                "- .permute() data dimensions"
            )
