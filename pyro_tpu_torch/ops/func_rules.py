"""What the kernels' ``torch.autograd.Function``s share to run under
``torch.func`` transforms (``vmap``, ``grad`` and their compositions, as
HMC and NUTS take the potential's gradient over a batch of chains).

Each Function is written in the ``forward(*inputs)`` + ``setup_context``
form, and everything its backward reads is an output of its forward.  Its
``vmap`` staticmethod moves the mapped dim of each operand to the front and
either folds it into the leading batch dims or rows that the kernel already
takes (``front``), or, where the kernel shares one operand across all its
rows, runs it once an example (``loop``).  Either way the rule calls the
Function's ``apply`` again on the moved tensors, so at the level below the
transform the kernel's wrapper sees plain tensors it can launch on, and a
nested ``vmap`` recurses.  A backward is a second Function with a rule of
its own: under ``vmap(grad(f))`` it is called with batched tensors, on which
no kernel can launch.
"""

from __future__ import annotations

import torch


def logical_ndim(t, dim) -> int:
    """The number of dims of ``t`` that the transformed function sees."""
    return t.ndim - (dim is not None)


def logical_shape(t, dim) -> tuple:
    """The shape of ``t`` that the transformed function sees."""
    return tuple(t.shape) if dim is None else tuple(t.movedim(dim, 0).shape[1:])


def front(t, dim, size: int, ndim: int, expand: bool = False):
    """``t`` with its mapped dim ``dim`` first and its other dims
    left-padded with 1s to ``ndim``: shape (size, 1, ..., logical shape).
    An operand with no mapped dim (``dim`` None) is left-padded and stays
    unbatched, so that it broadcasts, or with ``expand`` gets the mapped dim
    as a stride-0 view (no copy).  None stays None."""
    if t is None:
        return None
    if dim is None:
        t = t.reshape((1,) * (ndim - t.ndim) + tuple(t.shape))
        return t.expand((size,) + tuple(t.shape)) if expand else t
    t = t.movedim(dim, 0)
    return t.reshape((size,) + (1,) * (ndim - t.ndim + 1) + tuple(t.shape[1:]))


def per_example(g, t, dim):
    """A gradient ``g`` of shape (size, ...) that broadcasts over the
    logical shape of ``t`` (the input it belongs to, mapped at ``dim``),
    summed down to (size,) + that logical shape."""
    if g is None:
        return None
    logical = logical_shape(t, dim)
    padded = (g.shape[0],) + (1,) * (g.ndim - 1 - len(logical)) + logical
    return g.sum_to_size(padded).reshape((g.shape[0],) + logical)


def loop(apply, info, in_dims, args):
    """The vmap rule that runs ``apply`` once an example, on each mapped
    operand's slice (the others as they are), and stacks each output along
    a new dim 0 (None outputs stay None).  Returns (outputs, out_dims)."""
    runs = [
        apply(*(a if d is None else a.select(d, b) for a, d in zip(args, in_dims)))
        for b in range(info.batch_size)
    ]
    single = not isinstance(runs[0], tuple)
    if single:
        runs = [(r,) for r in runs]
    outs = tuple(None if r[0] is None else torch.stack(r) for r in zip(*runs))
    dims = tuple(None if o is None else 0 for o in outs)
    return (outs[0], dims[0]) if single else (outs, dims)
