"""Log-space sum-product and max-product over packed tensors (counterpart
of ``pyro_tpu/ops/rings.py``).

Contractions fold pairwise.  Each pairwise step shifts both operands by
their (detached, finite) maxima over the summed axes, contracts the
shifted exponentials with a real einsum, and returns to log space.  A
matmul-shaped pair (``ab,bc->ac``) goes to ``logmatmulexp``, the
log-matmul-exp kernel on the card.  The tropical ring (``use_max``) takes
the max in place of the sum, for MAP decoding; a tape records every step of
a contraction for the backward sweep of ``ops/einsum_sample.py``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Set

import torch

from .packed import PackedTensor, align

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _finite(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _shift(p: PackedTensor, out_dims: str):
    """``p`` minus its detached, finite max over the axes not in
    ``out_dims``, and that max as a packed tensor.  With no axis summed the
    shift is the operand itself, so a running chain factor can grow without
    bound in log space and its exp stays 1."""
    axes = tuple(i for i, d in enumerate(p.dims) if d not in out_dims)
    if not axes:
        m = _finite(p.value.detach())
        return p.value - m, PackedTensor(m, p.dims)
    m = _finite(p.value.detach().amax(dim=axes, keepdim=True))
    kept = "".join(d for d in p.dims if d in out_dims)
    return p.value - m, PackedTensor(m.reshape([n for d, n in zip(p.dims, p.shape) if d in out_dims]), kept)


def logsumexp_pair(x: PackedTensor, y: PackedTensor, out_dims: str) -> PackedTensor:
    """The log-space contraction of two packed tensors to ``out_dims``."""
    if (
        len(x.dims) == 2
        and len(y.dims) == 2
        and len(out_dims) == 2
        and x.dims[1] == y.dims[0]
        and out_dims == x.dims[0] + y.dims[1]
        and x.dims[0] != x.dims[1]
        and y.dims[0] != y.dims[1]
    ):
        from .log_matmul import logmatmulexp

        return PackedTensor(logmatmulexp(x.value, y.value), out_dims)
    xv, xshift = _shift(x, out_dims)
    yv, yshift = _shift(y, out_dims)
    # torch.einsum takes letters only: rename this step's symbols
    table: Dict[str, str] = {}
    for d in x.dims + y.dims + out_dims:
        table.setdefault(d, _LETTERS[len(table)])
    eq = "{},{}->{}".format(*("".join(table[d] for d in dims) for dims in (x.dims, y.dims, out_dims)))
    z = torch.einsum(eq, torch.exp(xv), torch.exp(yv))
    value = torch.log(z.clamp(min=torch.finfo(z.dtype).tiny))
    for shift in (xshift, yshift):
        value = value + align(shift, out_dims).value
    return PackedTensor(value, out_dims)


def logsumexp_single(x: PackedTensor, out_dims: str) -> PackedTensor:
    axes = tuple(i for i, d in enumerate(x.dims) if d not in out_dims)
    if not axes:
        return align(x, out_dims) if x.dims != out_dims else x
    value = torch.logsumexp(x.value, dim=axes)
    return align(PackedTensor(value, "".join(d for d in x.dims if d in out_dims)), out_dims)


def max_pair(x: PackedTensor, y: PackedTensor, out_dims: str) -> PackedTensor:
    """The max-product (tropical) contraction of two packed log factors to
    ``out_dims``: the Viterbi step of MAP decoding."""
    target = "".join(sorted(set(x.dims) | set(y.dims)))
    value = align(x, target).value + align(y, target).value
    axes = tuple(i for i, d in enumerate(target) if d not in out_dims)
    if axes:
        value = value.amax(dim=axes)
    return align(PackedTensor(value, "".join(d for d in target if d in out_dims)), out_dims)


def max_single(x: PackedTensor, out_dims: str) -> PackedTensor:
    axes = tuple(i for i, d in enumerate(x.dims) if d not in out_dims)
    if not axes:
        return align(x, out_dims) if x.dims != out_dims else x
    value = x.value.amax(dim=axes)
    return align(PackedTensor(value, "".join(d for d in x.dims if d in out_dims)), out_dims)


def _greedy_path(dims_list: List[str], sizes: Dict[str, int], out_dims: str):
    """A pairwise contraction order: at each step the pair that shares a dim
    and whose result is smallest against its inputs (opt_einsum's "greedy"
    cost).  The order may differ from the one opt_einsum's optimiser picks;
    any order gives the same value up to rounding."""

    def size(dims):
        return math.prod(sizes[d] for d in dims)

    operands = [set(d) for d in dims_list]
    # how many operands carry each dim: a pair's result keeps the dims that
    # the output or an operand outside the pair carries
    count = Counter(d for o in operands for d in o)
    count.update({d: 1 for d in out_dims})
    path = []
    while len(operands) > 1:
        best = None
        for i in range(len(operands)):
            for j in range(i + 1, len(operands)):
                x, y = operands[i], operands[j]
                shared = x & y
                result = {d for d in x | y if count[d] > 1 + (d in shared)}
                cost = size(result) - size(x) - size(y)
                key = (not shared, cost)
                if best is None or key < best[0]:
                    best = (key, i, j, result)
        _, i, j, result = best
        path.append((i, j))
        count.subtract(operands[i] | operands[j])
        count.subtract(operands[i] & operands[j])
        count.update(result)
        operands = [o for k, o in enumerate(operands) if k not in (i, j)] + [result]
    return path


def logsumexp_contract(
    terms: List[PackedTensor], sum_dims: Set[str], tape: Optional[List] = None, use_max: bool = False
) -> PackedTensor:
    """Contract a list of log factors, eliminating ``sum_dims``, pairwise in
    the order of ``_greedy_path``; a dim is summed at the first step after
    which no other operand carries it.  ``use_max`` takes the tropical ring
    (max in place of sum).  With ``tape`` given, each step is appended to it
    as ``(operands, kept dims)``, in forward order."""
    pair = max_pair if use_max else logsumexp_pair
    single = max_single if use_max else logsumexp_single

    def step(operands, keep):
        if tape is not None:
            tape.append((operands, keep))
        return single(operands[0], keep) if len(operands) == 1 else pair(*operands, keep)

    if len(terms) == 1 and not sum_dims:
        return terms[0]
    if len(terms) == 1:
        return step([terms[0]], "".join(d for d in terms[0].dims if d not in sum_dims))
    sizes: Dict[str, int] = {}
    for t in terms:
        sizes.update(zip(t.dims, t.shape))
    out_dims = "".join(sorted(set(sizes) - set(sum_dims)))
    operands = list(terms)
    for i, j in _greedy_path([t.dims for t in terms], sizes, out_dims):
        x, y = (operands.pop(k) for k in sorted((i, j), reverse=True))
        remaining: Set[str] = set(out_dims)
        for t in operands:
            remaining |= set(t.dims)
        keep = "".join(sorted((set(x.dims) | set(y.dims)) & remaining))
        operands.append(step([x, y], keep))
    (result,) = operands
    return align(result, out_dims)


class LogRing:
    """Sum-product in log space; the product over a plate is a plain sum
    over the plate's axis.  ``use_max`` makes it the max-product ring; a
    ``tape`` list records every contraction step (``logsumexp_contract``)."""

    def __init__(self, dim_to_size: Dict[str, int] = None, tape: Optional[List] = None, use_max: bool = False):
        self._dim_to_size: Dict[str, int] = dict(dim_to_size or {})
        self._tape = tape
        self._use_max = use_max

    def _observe(self, term: PackedTensor):
        self._dim_to_size.update(zip(term.dims, term.shape))

    def sumproduct(self, terms: List[PackedTensor], dims) -> PackedTensor:
        dims = set(dims)
        for t in terms:
            self._observe(t)
        if len(terms) == 1 and not dims:
            return terms[0]
        if not terms:
            raise ValueError("LogRing.sumproduct needs at least one term")
        return logsumexp_contract(list(terms), dims, tape=self._tape, use_max=self._use_max)

    def product(self, term: PackedTensor, ordinal) -> PackedTensor:
        """Product over plate instances: a sum of logs over the plate axes."""
        self._observe(term)
        axes = tuple(i for i, d in enumerate(term.dims) if d in ordinal)
        if not axes:
            return term
        return PackedTensor(term.value.sum(dim=axes), "".join(d for d in term.dims if d not in ordinal))

    def inv(self, term: PackedTensor) -> PackedTensor:
        self._observe(term)
        value = -term.value
        return PackedTensor(torch.where(torch.isnan(value), -torch.inf, value), term.dims)

    def broadcast(self, term: PackedTensor, ordinal) -> PackedTensor:
        self._observe(term)
        missing = "".join(sorted(set(ordinal) - set(term.dims)))
        if not missing:
            return term
        # dims no factor carried were squeezed as size 1
        missing_shape = tuple(self._dim_to_size.get(d, 1) for d in missing)
        return PackedTensor(term.value.expand(missing_shape + term.shape), missing + term.dims)

    def global_local(self, term: PackedTensor, dims, ordinal):
        """Inclusion-exclusion split: global = product(sum(term, dims),
        ordinal); local = term / sum(term, dims)."""
        assert dims
        term_sum = self.sumproduct([term], dims)
        global_part = self.product(term_sum, ordinal)
        local_part = self.sumproduct([term, self.inv(term_sum)], set())
        return global_part, local_part
