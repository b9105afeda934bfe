"""Broadcasting advanced indexing that works under enumeration
(counterpart of ``pyro_tpu/ops/indexing.py``).

``Vindex(x)[..., i, :, j]`` treats the leading ``...`` as batch dims that
broadcast against the index tensors, which may carry enumeration dims on
their left.
"""

from __future__ import annotations

import torch


def _is_batched(arg) -> bool:
    return isinstance(arg, torch.Tensor) and arg.ndim > 0


def vindex(tensor, args):
    """Advanced indexing with broadcasting semantics: index tensors broadcast
    against each other and against the batch dims left of the indexed ones;
    full slices ``:`` keep their dim on the right of the result."""
    if not isinstance(args, tuple):
        return tensor[args]
    if not args:
        return tensor
    if args[0] is Ellipsis:
        args = args[1:]
        if not args:
            return tensor
        old_event_dim = len(args)
        args = (slice(None),) * (tensor.ndim - len(args)) + args
    else:
        args = args + (slice(None),) * (tensor.ndim - len(args))
        old_event_dim = len(args)
    assert len(args) == tensor.ndim
    if any(a is Ellipsis for a in args):
        raise NotImplementedError("Non-leading Ellipsis is not supported")
    # a 0-dim index tensor selects its dim here: plain indexing would read it
    # on the host as an int, a device-to-host sync a CUDA graph cannot hold
    for i in reversed(range(len(args))):
        if isinstance(args[i], torch.Tensor) and args[i].ndim == 0:
            if i >= len(args) - old_event_dim:
                old_event_dim -= 1
            tensor = tensor.index_select(i, args[i].reshape(1)).squeeze(i)
            args = args[:i] + args[i + 1:]
    if not args:
        return tensor

    # in simple cases standard advanced indexing broadcasts correctly
    is_standard = True
    if tensor.ndim > old_event_dim and _is_batched(args[0]):
        is_standard = False
    elif any(_is_batched(a) for a in args[1:]):
        is_standard = False
    if is_standard:
        return tensor[args]

    # full slices become aranges on the right; index tensors get trailing
    # unit dims for them
    new_event_dim = sum(isinstance(a, slice) for a in args[-old_event_dim:])
    new_dim = 0
    args = list(args)
    for i, arg in reversed(list(enumerate(args))):
        if isinstance(arg, slice):
            if arg != slice(None):
                raise NotImplementedError("Nontrivial slices are not supported")
            arg = torch.arange(tensor.shape[i], device=tensor.device)
            arg = arg.reshape((-1,) + (1,) * new_dim)
            new_dim += 1
        elif _is_batched(arg):
            arg = arg.reshape(arg.shape + (1,) * new_event_dim)
        args[i] = arg
    return tensor[tuple(args)]


class Vindex:
    """``Vindex(x)[args]`` is ``vindex(x, args)``."""

    def __init__(self, tensor):
        self._tensor = tensor

    def __getitem__(self, args):
        return vindex(self._tensor, args)
