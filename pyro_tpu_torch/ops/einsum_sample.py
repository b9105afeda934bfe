"""Exact joint posterior draws, or the joint MAP, of every enumerated dim
in one forward contraction and one backward sweep (counterpart of
``pyro_tpu/ops/einsum_sample.py``).

The forward is the ordinary tensor-variable-elimination contraction
(``contract_to_tensor``) through a taping ``LogRing``, so its matmul-shaped
pairs run ``logmatmulexp`` (K1 on the card).  The backward replays the tape
in reverse: a step's eliminated dims are exactly those whose factors are all
absorbed at that step, so their conditional given every dim eliminated
later (and so drawn already) is the sum of the step's operands, gathered at
the drawn values.  The eliminated dims of a step are drawn jointly, per
plate slice, from one flattened categorical by Gumbel-max.

``temperature=0`` runs the forward in the max-product ring, and the sweep
takes the argmax: the exact joint MAP (Viterbi).
"""

from __future__ import annotations

import math

import torch

from . import packed
from .contract import contract_to_tensor
from .packed import PackedTensor
from .rings import LogRing


def _gumbel_argmax(logits, generator):
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    u = u.clamp(min=torch.finfo(logits.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(-1)


def sample_tensor_tree(tensor_tree, sum_dims, generator=None, temperature=1, dim_to_size=None):
    """One exact joint draw (or, at ``temperature=0``, the MAP) of every
    dim in ``sum_dims``, as ``{symbol: PackedTensor of int64 indices}``
    whose dims are the plates of the symbol's context.  Draws come from
    ``generator`` (torch's global generator when None)."""
    tape = []
    ring = LogRing(dim_to_size=dict(dim_to_size or {}), tape=tape, use_max=temperature == 0)
    with torch.no_grad():
        contract_to_tensor(tensor_tree, set(sum_dims), ring=ring)
        sampled = {}
        for operands, out_dims in reversed(tape):
            union = "".join(sorted(set().union(*(t.dims for t in operands))))
            elim = "".join(d for d in union if d not in out_dims)
            if not elim:
                continue
            cur = PackedTensor(sum(packed.align(t, union).value for t in operands), union)
            # condition on the dims drawn at later steps
            for d in union:
                if d in sampled and d not in elim:
                    cur = packed.gather(cur, sampled[d], d)
            rest = "".join(d for d in cur.dims if d not in elim)
            sizes = [cur.size(d) if d in cur.dims else 1 for d in elim]
            flat = packed.align(cur, rest + elim).value
            flat = flat.reshape(flat.shape[: len(rest)] + (math.prod(sizes),))
            if temperature == 0:
                z = flat.argmax(-1)
            else:
                z = _gumbel_argmax(flat / temperature if temperature != 1 else flat, generator)
            # unravel the flat index into one index a dim (row-major)
            stride = math.prod(sizes)
            for d, n in zip(elim, sizes):
                stride //= n
                sampled[d] = PackedTensor((z // stride) % n, rest)
    return sampled
