"""Posterior marginals of the enumeration engine by the adjoint
(counterpart of ``pyro_tpu/ops/einsum_adjoint.py``).

For packed log factors ``f_i``,

    log Z = log sum_x exp(sum_i f_i(x_i)),   d log Z / d f_i(v) = p(x_i = v),

so one forward contraction of log Z and one backward pass by autograd give
the marginals of every factor at once, in place of a contraction per query.
The matmul-shaped pairs of the forward go to ``logmatmulexp`` (K1 on the
card), and so its backward runs K1's backward kernels.

A factor that is constant over a plate carries no axis for it, so its
gradient sums the plate's slices.  ``TraceEnum_ELBO.compute_marginals``
reads each site from a zero "probe" factor over the site's plates and its
own dim instead, which gives one marginal per plate slice.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from .contract import contract_tensor_tree
from .packed import PackedTensor
from .rings import LogRing


def log_partition(log_factors, sum_dims):
    """The total log normaliser: every enumeration dim eliminated by tensor
    variable elimination, then the plate dims left summed (plates factorise,
    so the joint log Z is the sum of the slices')."""
    dim_to_size: Dict[str, int] = {}
    for terms in log_factors.values():
        for term in terms:
            dim_to_size.update(zip(term.dims, term.shape))
    reduced = contract_tensor_tree(
        OrderedDict((t, list(terms)) for t, terms in log_factors.items()), sum_dims, ring=LogRing(dim_to_size)
    )
    return sum(term.value.sum() for terms in reduced.values() for term in terms)


def adjoint_marginals(log_factors, sum_dims):
    """``(log Z, marginals)``: ``marginals`` mirrors ``log_factors``
    (ordinal -> terms), each entry the posterior joint marginal over its
    factor's dims (enumeration dims normalised per plate slice), from one
    forward and one backward pass.  The factors are taken as they are
    (detached): the marginals carry no gradient to the model's parameters."""
    spec = [(t, term.dims) for t, terms in log_factors.items() for term in terms]
    leaves = [term.value.detach().requires_grad_() for terms in log_factors.values() for term in terms]
    tree: "OrderedDict" = OrderedDict()
    for (t, dims), leaf in zip(spec, leaves):
        tree.setdefault(t, []).append(PackedTensor(leaf, dims))
    with torch.enable_grad():
        log_z = log_partition(tree, sum_dims)
        grads = torch.autograd.grad(log_z, leaves)
    marginals: "OrderedDict" = OrderedDict()
    for (t, dims), grad in zip(spec, grads):
        marginals.setdefault(t, []).append(PackedTensor(grad, dims))
    return log_z.detach(), marginals


def marginal_of_dims(marginal: PackedTensor, keep_dims, sum_dims) -> PackedTensor:
    """A factor's joint marginal reduced to ``keep_dims``: the other
    enumeration dims summed out, the plate dims kept (each slice is
    normalised on its own)."""
    drop = [i for i, d in enumerate(marginal.dims) if d in sum_dims and d not in keep_dims]
    if not drop:
        return marginal
    return PackedTensor(marginal.value.sum(dim=drop), "".join(d for i, d in enumerate(marginal.dims) if i not in drop))
