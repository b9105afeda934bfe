"""Tensor variable elimination over plated factor trees (counterpart of
``pyro_tpu/ops/contract.py``; the paper is arXiv:1902.03210):
``contract_tensor_tree``, ``contract_to_tensor``, the plate-aware log-space
einsum ``ubersum`` and its plate-unrolling reference ``naive_ubersum``.

Ordinals are frozensets of plate symbols; sum dims are enumeration
symbols; terms are ``PackedTensor``s.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, defaultdict
from typing import Dict, List, Set

import torch

from ..settings import get_default_device
from .packed import PackedTensor, align
from .rings import LogRing


def _check_plates_are_sensible(output_dims, nonoutput_ordinal):
    if output_dims and nonoutput_ordinal:
        raise ValueError(
            "It is nonsensical to preserve a plated dim without preserving all of that dim's plates, "
            f"but found '{output_dims}' without '{','.join(nonoutput_ordinal)}'"
        )


def _check_tree_structure(parent, leaf):
    if parent == leaf:
        raise NotImplementedError(
            "Expected tree-structured plate nesting, but found dependencies on independent plates. "
            "Try converting one of the vectorized plates to a sequential plate (but beware exponential "
            "cost in the size of the sequence)"
        )


def _partition_terms(terms: List[PackedTensor], dims: Set[str]):
    """Split (terms, dims) into the connected components that share sum dims."""
    neighbors: "OrderedDict" = OrderedDict([(t, []) for t in terms] + [(d, []) for d in sorted(dims)])
    for term in terms:
        for dim in term.dims:
            if dim in dims:
                neighbors[term].append(dim)
                neighbors[dim].append(term)

    components = []
    while neighbors:
        v, pending = neighbors.popitem()
        component = OrderedDict([(v, None)])
        for p in pending:
            component[p] = None
        pending = list(pending)
        while pending:
            v = pending.pop()
            for u in neighbors.pop(v, []):
                if u not in component:
                    component[u] = None
                    pending.append(u)
        component_terms = [v for v in component if isinstance(v, PackedTensor)]
        if component_terms:
            component_dims = {v for v in component if not isinstance(v, PackedTensor)}
            components.append((component_terms, component_dims))
    return components


def _contract_component(ring, tensor_tree, sum_dims, target_dims):
    """Contract ``sum_dims - target_dims`` in a tree of packed tensors by
    message passing, down to one tensor in the smallest plate context."""
    # group sum dims by the smallest ordinal in which they appear
    dim_to_ordinal: Dict[str, frozenset] = {}
    for t, terms in tensor_tree.items():
        for term in terms:
            for dim in sum_dims.intersection(term.dims):
                dim_to_ordinal[dim] = dim_to_ordinal.get(dim, t) & t
    dims_tree = defaultdict(set)
    for dim, t in dim_to_ordinal.items():
        dims_tree[t].add(dim)

    local_terms: List[PackedTensor] = []
    local_dims = set(target_dims)
    local_ordinal: frozenset = frozenset()
    min_ordinal = frozenset.intersection(*tensor_tree)
    while any(dims_tree.values()):
        leaf = max(tensor_tree, key=len)
        leaf_terms = tensor_tree.pop(leaf)
        leaf_dims = dims_tree.pop(leaf, set())

        for terms, dims in _partition_terms(leaf_terms, leaf_dims):
            term = ring.sumproduct(terms, dims - local_dims)
            if leaf == min_ordinal:
                parent = leaf
            else:
                pending_dims = sum_dims.intersection(term.dims)
                parents = [t for t, d in dims_tree.items() if d & pending_dims]
                parent = frozenset.union(*parents) if parents else min_ordinal
                _check_tree_structure(parent, leaf)
                contract_frames = leaf - parent
                contract_dims = dims & local_dims
                if contract_dims:
                    term, local_term = ring.global_local(term, contract_dims, contract_frames)
                    local_terms.append(local_term)
                    local_dims |= sum_dims.intersection(local_term.dims)
                    local_ordinal |= leaf
                else:
                    term = ring.product(term, contract_frames)
            tensor_tree.setdefault(parent, []).append(term)

    # combine what remains at its ordinals down to min_ordinal
    while len(tensor_tree) > 1 or (tensor_tree and next(iter(tensor_tree)) != min_ordinal):
        leaf = max(tensor_tree, key=len)
        leaf_terms = tensor_tree.pop(leaf)
        term = ring.sumproduct(leaf_terms, set())
        if leaf != min_ordinal:
            term = ring.product(term, leaf - min_ordinal)
        tensor_tree.setdefault(min_ordinal, []).append(term)
    ordinal, terms = tensor_tree.popitem()
    term = ring.sumproduct(terms, set())
    assert ordinal == min_ordinal

    if local_terms:
        assert target_dims
        local_terms.append(term)
        term = ring.sumproduct(local_terms, local_dims - target_dims)
        ordinal = ordinal | local_ordinal
    return ordinal, term


def contract_tensor_tree(tensor_tree, sum_dims, ring=None):
    """Sum out ``sum_dims`` of a tree (ordinal -> terms), leaving one term
    per connected component at the component's smallest ordinal."""
    assert isinstance(tensor_tree, OrderedDict)
    sum_dims = set(sum_dims)
    if ring is None:
        ring = LogRing()
    ordinals = {term: t for t, terms in tensor_tree.items() for term in terms}
    all_terms = [term for terms in tensor_tree.values() for term in terms]
    contracted_tree: "OrderedDict" = OrderedDict()
    for terms, dims in _partition_terms(all_terms, sum_dims):
        component: "OrderedDict" = OrderedDict()
        for term in terms:
            component.setdefault(ordinals[term], []).append(term)
        ordinal, term = _contract_component(ring, component, dims, set())
        contracted_tree.setdefault(ordinal, []).append(term)
    return contracted_tree


def contract_to_tensor(tensor_tree, sum_dims, target_ordinal=None, target_dims=None, ring=None):
    """Contract everything down to one tensor in the plate context
    ``target_ordinal``, keeping ``target_dims``."""
    target_ordinal = frozenset() if target_ordinal is None else target_ordinal
    target_dims = set() if target_dims is None else target_dims
    sum_dims = set(sum_dims)
    assert target_dims <= sum_dims
    if ring is None:
        ring = LogRing()
    ordinals = {term: t for t, terms in tensor_tree.items() for term in terms}
    all_terms = [term for terms in tensor_tree.values() for term in terms]
    contracted_terms: List[PackedTensor] = []
    modulo_total = bool(target_dims)
    for terms, dims in _partition_terms(all_terms, sum_dims):
        if modulo_total and dims.isdisjoint(target_dims):
            continue
        component: "OrderedDict" = OrderedDict()
        for term in terms:
            component.setdefault(ordinals[term], []).append(term)
        ordinal, term = _contract_component(ring, component, dims, target_dims & dims)
        _check_plates_are_sensible(target_dims.intersection(term.dims), ordinal - target_ordinal)
        contract_frames = ordinal - target_ordinal
        if contract_frames:
            assert not (set(term.dims) & sum_dims) - target_dims
            term = ring.product(term, contract_frames)
        contracted_terms.append(term)
    if not contracted_terms:
        contracted_terms = [PackedTensor(torch.zeros((), device=get_default_device()), "")]
    term = ring.sumproduct(contracted_terms, set())
    return ring.broadcast(term, target_ordinal)


def _validate_sizes(inputs, operands):
    """Each symbol's size, the same in every operand that carries it."""
    sizes: Dict[str, int] = {}
    for inp, op in zip(inputs, operands):
        for d, n in zip(inp, op.shape):
            old = sizes.setdefault(d, n)
            if old != n:
                raise ValueError(f"Dimension size mismatch at dim '{d}': {n} vs {old}")
    return sizes


def ubersum(equation: str, *operands, plates: str = ""):
    """The plate-aware log-space einsum: ``equation`` names each operand's
    dims and one or more comma-separated outputs; a dim in ``plates`` is a
    plate (its slices multiply, so it is summed in log space where an output
    drops it), every other dim is summed out by logsumexp.  Returns one
    tensor per output."""
    inputs, outputs = equation.split("->")
    inputs, outputs = inputs.split(","), outputs.split(",")
    _validate_sizes(inputs, operands)
    terms = [PackedTensor(x, dims) for x, dims in zip(operands, inputs)]
    plate_set = set(plates)
    results = []
    for output in outputs:
        tensor_tree: "OrderedDict" = OrderedDict()
        sum_dims = set()
        for term in terms:
            tensor_tree.setdefault(frozenset(d for d in term.dims if d in plate_set), []).append(term)
            sum_dims |= set(term.dims) - plate_set
        term = contract_to_tensor(
            tensor_tree,
            sum_dims,
            target_ordinal=frozenset(d for d in output if d in plate_set),
            target_dims=set(output) - plate_set,
        )
        results.append(align(term, output).value)
    return tuple(results)


def _naive_log_einsum(equation: str, *operands):
    """A flat (plate-free) log-space einsum by greedy variable elimination,
    each step a broadcast sum and a logsumexp."""
    inputs, output = equation.split("->")
    terms = [(inp, op) for inp, op in zip(inputs.split(","), operands)]

    def broadcast_sum(group):
        dims = "".join(dict.fromkeys("".join(gdims for gdims, _ in group)))
        total = sum(align(PackedTensor(v, gdims), dims).value for gdims, v in group)
        sizes = {d: n for gdims, v in group for d, n in zip(gdims, v.shape)}
        return dims, total.expand([sizes[d] for d in dims])

    elim = {d for dims, _ in terms for d in dims} - set(output)
    while elim:
        best = min(sorted(elim), key=lambda d: len({x for dims, _ in terms if d in dims for x in dims}))
        dims, merged = broadcast_sum([t for t in terms if best in t[0]])
        terms = [t for t in terms if best not in t[0]] + [(dims.replace(best, ""), merged.logsumexp(dims.index(best)))]
        elim.remove(best)
    if not terms:
        return torch.zeros(())
    dims, total = broadcast_sum(terms)
    return total.permute([dims.index(d) for d in output])


def naive_ubersum(equation: str, *operands, plates: str = ""):
    """The reference for ``ubersum``, by unrolling the plates: every slice
    of every operand becomes an operand of its own, with fresh symbols for
    its plate-local dims, and a flat log-space einsum runs for each index of
    the output's plates."""
    inputs_str, outputs_str = equation.split("->")
    outputs = outputs_str.split(",")
    if len(outputs) > 1:
        return tuple(naive_ubersum(inputs_str + "->" + out, *operands, plates=plates)[0] for out in outputs)
    (output,) = outputs
    inputs = inputs_str.split(",")
    plate_set = set(plates)
    sizes = _validate_sizes(inputs, operands)
    if not plate_set:
        return (_naive_log_einsum(equation, *operands),)

    # a sum dim's plate context: the plates that every operand carrying it has
    dim_to_ordinal: dict = {}
    for dims in map(set, inputs):
        for d in dims - plate_set:
            dim_to_ordinal[d] = dim_to_ordinal.get(d, dims & plate_set) & dims
    output_plates = set(output) & plate_set
    for d in output:
        if d not in plate_set:
            if d not in dim_to_ordinal:
                raise ValueError(f"output dim {d!r} is neither a plate nor present in any input")
            _check_plates_are_sensible({d}, dim_to_ordinal[d] - output_plates)

    symbols: dict = {}

    def unroll(d, index):
        key = (d, tuple(index[p] for p in sorted(dim_to_ordinal.get(d, ()))))
        return symbols.setdefault(key, chr(0x4E00 + len(symbols)))

    flat_inputs, flat_operands = [], []
    for inp, op in zip(inputs, operands):
        local = [d for d in inp if d in plate_set]
        for index in itertools.product(*(range(sizes[d]) for d in local)):
            at = dict(zip(local, index))
            flat_inputs.append("".join(unroll(d, at) for d in inp if d not in plate_set))
            flat_operands.append(op[tuple(at.get(d, slice(None)) for d in inp)])

    out_plates = [d for d in output if d in plate_set]
    result = operands[0].new_zeros([sizes[d] for d in output])
    for index in itertools.product(*(range(sizes[d]) for d in out_plates)):
        at = dict(zip(out_plates, index))
        flat_output = "".join(unroll(d, at) for d in output if d not in plate_set)
        value = _naive_log_einsum(",".join(flat_inputs) + "->" + flat_output, *flat_operands)
        result[tuple(at.get(d, slice(None)) for d in output)] = value
    return (result,)
