"""Plate: vectorised conditional independence and broadcasting
(counterpart of ``pyro_tpu/poutine/plate_messenger.py``).

Full-size plates only: subsampling is not ported yet.  Entering a plate
registers its index site, and every enclosed sample site gets a
``CondIndepStackFrame`` and has its distribution broadcast to the plate dim.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributions.distribution import Distribution, ExpandedDistribution
from ..settings import get_default_device
from .messenger import Messenger
from .runtime import _DIM_ALLOCATOR, CondIndepStackFrame, am_i_wrapped, apply_stack, new_message


class _Subsample(Distribution):
    """The plate's index site (a full-size plate's indices are fixed)."""

    def __init__(self, size: int):
        self.size = size
        super().__init__()

    def sample(self, generator=None, sample_shape=()):
        return torch.arange(self.size, device=get_default_device())

    def log_prob(self, value):
        return torch.zeros((), device=value.device)


class PlateMessenger(Messenger):
    """``pyro.plate`` as a context manager."""

    def __init__(self, name: str, size: int, dim: Optional[int] = None):
        super().__init__()
        self.name = name
        self.size = size
        self.subsample_size = size
        self.dim = dim
        self._allocated_dim: Optional[int] = None
        self._indices = None

    def _subsample_site(self):
        indices = torch.arange(self.size, device=get_default_device())
        if not am_i_wrapped():
            return indices
        msg = new_message(
            "sample", self.name, _Subsample(self.size), (), {"sample_shape": ()}, value=indices,
            infer={"_do_not_trace": True, "_do_not_score": True, "is_auxiliary": True},
        )
        return apply_stack(msg)["value"]

    @property
    def indices(self):
        if self._indices is None:
            self._indices = self._subsample_site()
        return self._indices

    def __enter__(self):
        self._allocated_dim = _DIM_ALLOCATOR.allocate(self.name, self.dim)
        try:
            super().__enter__()
            return self.indices
        except Exception:
            self.__exit__(None, None, None)
            raise

    def __exit__(self, *args):
        _DIM_ALLOCATOR.free(self.name, self._allocated_dim)
        self._allocated_dim = None
        return super().__exit__(*args)

    def _frame(self) -> CondIndepStackFrame:
        return CondIndepStackFrame(self.name, self._allocated_dim, self.size, self.subsample_size)

    def _pyro_sample(self, msg):
        if msg["infer"].get("_do_not_trace"):
            return
        msg["cond_indep_stack"] = (self._frame(),) + msg["cond_indep_stack"]
        self._broadcast(msg)

    def _pyro_param(self, msg):
        msg["cond_indep_stack"] = (self._frame(),) + msg["cond_indep_stack"]

    def _broadcast(self, msg):
        """Expand the site's batch_shape over the enclosing plate dims."""
        fn = msg["fn"]
        if not isinstance(fn, Distribution):
            return
        actual = fn.batch_shape
        target = [None if size == 1 else size for size in actual]
        for f in msg["cond_indep_stack"]:
            if f.dim is None:
                continue
            if len(target) < -f.dim:
                target = [None] * (-f.dim - len(target)) + target
            if target[f.dim] is not None and target[f.dim] != f.subsample_size:
                raise ValueError(
                    f"Shape mismatch inside plate('{f.name}') at site '{msg['name']}' dim {f.dim}: "
                    f"{target[f.dim]} vs {f.subsample_size}"
                )
            target[f.dim] = f.subsample_size
        for i in range(-len(target), 0):
            if target[i] is None:
                target[i] = actual[i] if len(actual) >= -i else 1
        target = tuple(target)
        if target != actual:
            if msg["infer"].get("enumerate") == "parallel":
                # an enumerated site never draws plate-many samples: a lazy
                # broadcast lets compute_log_prob keep its factor compact
                # (size-1 plate axes, squeezed when packed)
                msg["fn"] = ExpandedDistribution(fn, target)
            else:
                msg["fn"] = fn.expand(target)
