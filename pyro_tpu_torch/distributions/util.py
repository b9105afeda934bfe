"""Distribution utilities (counterpart of ``pyro_tpu/distributions/util.py``)."""

from __future__ import annotations

import numbers
from typing import Sequence

import torch


def as_float(value, device=None):
    """A distribution parameter as a float tensor on ``device`` (where
    given): a floating tensor keeps its own dtype (float64 stays float64
    under a float32 default), anything else takes the default dtype."""
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value if device is None else value.to(device)
    return torch.as_tensor(value, dtype=torch.get_default_dtype(), device=device)


def is_identically_zero(x) -> bool:
    """True if ``x`` is the literal number zero."""
    return isinstance(x, (int, float)) and x == 0


def is_identically_one(x) -> bool:
    return isinstance(x, (int, float)) and x == 1


def broadcast_shape(*shapes: Sequence[int], strict: bool = False) -> tuple:
    """Broadcast shapes; in strict mode a size-1 dim only matches size 1."""
    reversed_shape: list = []
    for shape in shapes:
        for i, size in enumerate(reversed(shape)):
            if i >= len(reversed_shape):
                reversed_shape.append(size)
            elif reversed_shape[i] == 1 and not strict:
                reversed_shape[i] = size
            elif reversed_shape[i] != size and (size != 1 or strict):
                raise ValueError(
                    "shape mismatch: objects cannot be broadcast to a single shape: "
                    f"{list(map(tuple, shapes))}"
                )
    return tuple(reversed(reversed_shape))


def sum_rightmost(value, dim):
    """Sum out the rightmost ``dim`` dimensions (``float('inf')``: all)."""
    if isinstance(value, numbers.Number):
        return value
    ndim = value.ndim
    if dim == float("inf"):
        return value.sum()
    if dim < 0:
        dim += ndim
    if dim == 0:
        return value
    if dim >= ndim:
        return value.sum()
    return value.sum(dim=tuple(range(-int(dim), 0)))


def scale_and_mask(tensor, scale=1.0, mask=None):
    """Scale a log-prob tensor and zero its masked-out elements."""
    if is_identically_one(scale) and mask is None:
        return tensor
    if mask is None:
        return tensor * scale
    if isinstance(mask, bool):
        return tensor * scale if mask else torch.zeros_like(tensor)
    return torch.where(mask, tensor * scale, 0.0)


def clamp_probs(probs):
    eps = torch.finfo(probs.dtype).eps
    return probs.clamp(min=eps, max=1.0 - eps)


def logits_to_probs(logits, is_binary=False):
    if is_binary:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def probs_to_logits(probs, is_binary=False):
    ps = clamp_probs(probs)
    if is_binary:
        return torch.log(ps) - torch.log1p(-ps)
    return torch.log(ps)


def lazy_property(fn):
    """Property computed once per (immutable) distribution."""
    attr = "_lazy_" + fn.__name__

    @property
    def _lazy(self):
        if not hasattr(self, attr):
            object.__setattr__(self, attr, fn(self))
        return getattr(self, attr)

    return _lazy
