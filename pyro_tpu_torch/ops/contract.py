"""Tensor variable elimination over plated factor trees (counterpart of
``contract_tensor_tree`` and ``contract_to_tensor`` in
``pyro_tpu/ops/contract.py``; the paper is arXiv:1902.03210).

Ordinals are frozensets of plate symbols; sum dims are enumeration
symbols; terms are ``PackedTensor``s.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Set

import torch

from ..settings import get_default_device
from .packed import PackedTensor
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
