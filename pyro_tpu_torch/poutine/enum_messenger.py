"""Parallel enumeration of discrete sites (counterpart of
``pyro_tpu/poutine/enum_messenger.py``).

An enumerated site's value is its whole support, laid along a fresh dim to
the left of every plate dim; the dim allocation depends only on the order
of the sites, never on values.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..distributions.distribution import Distribution
from .messenger import Messenger
from .runtime import _ENUM_ALLOCATOR


def enumerate_site(msg):
    """The site's support with its cardinality in a fresh leftmost dim."""
    dist = msg["fn"]
    if msg["infer"].get("num_samples") is not None:
        raise NotImplementedError(
            "sampled enumeration (num_samples, TMC) is not ported yet; see ROADMAP.md Queue 1 item 4"
        )
    value = dist.enumerate_support(expand=msg["infer"].get("expand", False))
    assert value.ndim == 1 + len(dist.batch_shape) + len(dist.event_shape)
    return value


class EnumMessenger(Messenger):
    """Enumerate every sample site marked ``infer={"enumerate": "parallel"}``
    in parallel.  With ``first_available_dim`` it (re)starts the dim
    allocation there; without, it continues an allocation begun outside."""

    def __init__(self, first_available_dim: Optional[int] = None):
        assert first_available_dim is None or first_available_dim < 0
        self.first_available_dim = first_available_dim
        super().__init__()

    def __enter__(self):
        if self.first_available_dim is not None:
            _ENUM_ALLOCATOR.set_first_available_dim(self.first_available_dim)
        self._param_dims: Dict[str, Dict[int, int]] = {}
        return super().__enter__()

    def _pyro_sample(self, msg) -> None:
        if msg["done"] or not isinstance(msg["fn"], Distribution):
            return
        if msg["infer"].get("_markov_scope") is not None:
            raise NotImplementedError(
                "pyro.markov (MarkovMessenger) dim recycling is not ported yet; see ROADMAP.md Queue 1 item 4"
            )
        param_dims = dict(_ENUM_ALLOCATOR.dim_to_id)
        self._param_dims[msg["name"]] = param_dims
        if msg["is_observed"] or msg["infer"].get("enumerate") != "parallel":
            if msg["infer"].get("enumerate") == "sequential":
                raise NotImplementedError(
                    "sequential enumeration is not ported yet; see ROADMAP.md Queue 1 item 4"
                )
            return

        value = enumerate_site(msg)
        actual_dim = -1 - len(msg["fn"].batch_shape)
        target_dim, id_ = _ENUM_ALLOCATOR.allocate()
        event_dim = msg["fn"].event_dim
        if actual_dim < target_dim:
            # move the enumeration axis rightward to target_dim
            assert value.shape[target_dim - event_dim] == 1, f"enumeration dim conflict at dim {actual_dim}"
            value = value.transpose(target_dim - event_dim, actual_dim - event_dim)
            while value.ndim and value.shape[0] == 1:
                value = value[0]
        elif target_dim < actual_dim:
            diff = actual_dim - target_dim
            value = value.reshape(value.shape[:1] + (1,) * diff + value.shape[1:])

        value_dims = {
            dim: param_dims[dim]
            for dim in range(event_dim - value.ndim, 0)
            if value.shape[dim - event_dim] > 1 and dim in param_dims
        }
        value_dims[target_dim] = id_
        msg["infer"]["_enumerate_dim"] = target_dim
        msg["infer"]["_dim_to_id"] = value_dims
        msg["value"] = value
        msg["done"] = True

    def _pyro_post_sample(self, msg) -> None:
        # every site records the enumeration dims allocated before it, so
        # that its log-prob can be packed with their symbols
        if isinstance(msg["fn"], Distribution) and msg["value"] is not None:
            msg["infer"].setdefault("_dim_to_id", {}).update(self._param_dims.get(msg["name"], {}))
