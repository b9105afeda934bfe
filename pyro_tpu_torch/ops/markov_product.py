"""Elimination of vectorized Markov time dims (counterpart of
``pyro_tpu/ops/markov_product.py``).

Works on the packed factors of ``TraceEnum_ELBO``.  For each
``markov_chain`` record (written by ``vectorized_markov``), the factors of
the chain's time plate are collected and eliminated by a forward scan whose
left endpoint factors (the first step's transition and emissions) are
absorbed into the initial potential ``alpha0``; what remains are ordinary
factors for ``contract_tensor_tree`` to finish.  The scan's per-step
factors stay compact: a homogeneous transition stays (S, S) and is never
built at (B, T, S, S).

Routes, by the chain and the shape of its transition (counted in
``routes`` per chain eliminated):

* ``"scan"``, a transition with no time axis, shared by every plate row
  (the homogeneous HMM) or one per row:
  ``alpha' = R_t + logmatmulexp(alpha + L_t, A)``, the plate rows
  flattened into the product's rows; ``ops/markov_scan.py::markov_scan``
  (K2), one kernel launch each way on the card for all steps;
* ``"general"``, a transition that varies with time:
  ``alpha' = R_t + logsumexp_l(alpha + L_t + A_t)`` with A_t (T, S, S) or
  one per row; ``ops/markov_scan.py::markov_scan_tv`` (K2g), one launch
  each way on the card;
* ``"pairwise"``, the O(log T) matrix-product fallback for chains the scan
  does not take (``history >= 2``, several chain variables, per-step local
  enumeration dims, or endpoints that cannot be absorbed): the (T, ...,
  S, S) window transitions, time-major, reduced by
  ``ops/log_matmul.py::sequential_logmatmulexp_timemajor`` in ceil(log2 T)
  rounds of ``logmatmulexp`` (K1 on the card).
"""

from __future__ import annotations

import math

import torch

from . import packed
from .log_matmul import sequential_logmatmulexp_timemajor
from .markov_scan import markov_scan, markov_scan_tv, masked_logsumexp

# chains eliminated by each route since the last reset_routes()
routes = {"scan": 0, "general": 0, "pairwise": 0}


def reset_routes():
    routes.update(scan=0, general=0, pairwise=0)


def _packed_sum(terms):
    """Sum log factors, aligned to the union of their dims."""
    parts = packed.broadcast_all(*terms)
    val = parts[0].value
    for p in parts[1:]:
        val = val + p.value
    return val, parts[0].dims


def _reduce_to_ordinal(term, ordinal, target_ordinal, sym_size):
    """Plate-product a factor down from ``ordinal`` to ``target_ordinal``:
    sum the plate dims the factor has, multiply by the size of the plates it
    is constant over."""
    val, dims = term.value, term.dims
    mult = 1.0
    for sym in ordinal - target_ordinal:
        if sym in dims:
            ax = dims.index(sym)
            val = val.sum(dim=ax)
            dims = dims[:ax] + dims[ax + 1:]
        else:
            mult = mult * sym_size[sym]
    if mult != 1.0:
        val = val * mult
    return packed.PackedTensor(val, dims)


def eliminate_markov_chains(model_trace, log_factors, sum_dims):
    """Eliminate every vectorized-Markov time dim in ``log_factors`` (an
    OrderedDict ordinal -> [PackedTensor], changed in place); returns the
    updated ``sum_dims``."""
    chain_nodes = [node for node in model_trace.nodes.values() if node["type"] == "markov_chain" and node["value"]]
    if not chain_nodes:
        return sum_dims
    sum_dims = set(sum_dims)

    # plate symbol -> size (for factors constant over a plate)
    sym_size = {}
    for site in model_trace.nodes.values():
        if site["type"] != "sample":
            continue
        for frame in site["cond_indep_stack"]:
            if frame.dim is not None:
                sym_size[model_trace.plate_to_symbol[frame.name]] = frame.subsample_size or frame.size

    for node in chain_nodes:
        history = node["infer"]["history"]
        time_sym = model_trace.plate_to_symbol.get(node["infer"]["plate_name"])
        if time_sym is None:
            continue
        chain_set = sorted(node["value"])

        # enumeration symbols per Markov variable: the history int sites and
        # the history + 1 slice-pass sites
        int_syms, slice_syms, sizes = [], [], []
        for tup in chain_set:
            ints, slices = tup[:history], tup[history:]
            try:
                i_syms = [model_trace.nodes[n]["infer"]["_enumerate_symbol"] for n in ints]
                s_syms = [model_trace.nodes[n]["infer"]["_enumerate_symbol"] for n in slices]
            except KeyError as e:
                raise NotImplementedError(
                    "vectorized_markov requires every Markov variable to be enumerated in the model "
                    f"(infer={{'enumerate': 'parallel'}}); missing for a site in chain {tup}"
                ) from e
            int_syms.append(i_syms)
            slice_syms.append(s_syms)
            final = model_trace.nodes[slices[-1]]
            sizes.append(final["packed"]["unscaled_log_prob"].size(s_syms[-1]))

        # take every factor of the time plate out of log_factors: those with
        # the time symbol, and those inside the time ordinal that touch the
        # chain's enumeration symbols (a factor constant over time, or whose
        # time axis was squeezed on packing)
        chain_syms = {s for var in slice_syms for s in var}

        def _is_time_factor(ordinal, x):
            return time_sym in x.dims or (time_sym in ordinal and bool(chain_syms & set(x.dims)))

        consumed = []
        for t in list(log_factors):
            kept = [x for x in log_factors[t] if not _is_time_factor(t, x)]
            consumed.extend((t, x) for x in log_factors[t] if _is_time_factor(t, x))
            if kept:
                log_factors[t] = kept
            else:
                del log_factors[t]
        if not consumed:
            continue
        base_ordinal = frozenset.intersection(*[t for t, _ in consumed])
        assert time_sym in base_ordinal
        target_ordinal = base_ordinal - {time_sym}
        # product over the plates strictly inside the chain's ordinal
        reduced = [_reduce_to_ordinal(term, t, base_ordinal, sym_size) for t, term in consumed]

        union_dims = set().union(*[set(x.dims) for x in reduced])
        local = [d for d in union_dims if d not in chain_syms and d != time_sym and d not in sym_size]
        if len(chain_set) == 1 and history == 1 and not local and _try_scan_elimination(
            log_factors, sum_dims, reduced, int_syms[0][0], slice_syms[0][0], slice_syms[0][1], sizes[0],
            time_sym, target_ordinal, sym_size,
        ):
            continue
        _pairwise_elimination(log_factors, sum_dims, reduced, local, chain_syms, int_syms, slice_syms, sizes,
                              history, time_sym, target_ordinal)
    return sum_dims


def _pairwise_elimination(log_factors, sum_dims, reduced, local, chain_syms, int_syms, slice_syms, sizes, history,
                          time_sym, target_ordinal):
    """The O(log T) fallback (``pyro_tpu/ops/markov_product.py:213-291``):
    sum out the local dims, lay the joint transition out time-major as
    (time, plates..., slots of each variable), constrain the overlap of
    consecutive windows (history >= 2) by -inf-masked duplicates of the
    middle slots, reshape to window matrices (T, plates..., S, S) with
    S = prod(sizes ** history), and reduce them pairwise.  Leaves one
    factor over the first window's int sites and the last window's slice
    sites."""
    V, h = len(slice_syms), history
    A, A_dims = _packed_sum(reduced)
    if local:
        A = masked_logsumexp(A, tuple(A_dims.index(d) for d in local))
        A_dims = "".join(d for d in A_dims if d not in local)

    other = "".join(d for d in A_dims if d not in chain_syms and d != time_sym)
    slot_order = [slice_syms[v][i] for v in range(V) for i in range(h + 1)]
    A = packed.align(packed.PackedTensor(A, A_dims), time_sym + other + "".join(slot_order)).value
    nb = 1 + len(other)
    A = A.expand(A.shape[:nb] + tuple(sizes[v] for v in range(V) for _ in range(h + 1)))

    # right-hand duplicates of the middle slots: log-deltas tie each window's
    # last h slots to the next window's first h
    mid_axes = {}
    for v in range(V):
        for i in range(1, h):
            K = sizes[v]
            src = nb + v * (h + 1) + i
            A = A.unsqueeze(-1).expand(A.shape + (K,))
            eye = torch.eye(K, dtype=torch.bool, device=A.device)
            A = torch.where(eye.reshape([K if ax in (src, A.ndim - 1) else 1 for ax in range(A.ndim)]), A, -torch.inf)
            mid_axes[(v, i)] = A.ndim - 1

    left_axes = [nb + v * (h + 1) + i for v in range(V) for i in range(h)]
    right_axes = [mid_axes[(v, i)] if i < h else nb + v * (h + 1) + h for v in range(V) for i in range(1, h + 1)]
    M = A.permute(list(range(nb)) + left_axes + right_axes)
    S = math.prod(sizes[v] ** h for v in range(V))
    M = M.reshape(M.shape[:nb] + (S, S))

    R = sequential_logmatmulexp_timemajor(M)  # (plates..., S, S)
    per_slot = tuple(sizes[v] for v in range(V) for _ in range(h))
    R = R.reshape(R.shape[:-2] + per_slot + per_slot)
    left_syms = [int_syms[v][i] for v in range(V) for i in range(h)]
    right_syms = [slice_syms[v][i] for v in range(V) for i in range(1, h + 1)]
    new_dims = other + "".join(left_syms) + "".join(right_syms)
    assert len(set(new_dims)) == len(new_dims), new_dims
    log_factors.setdefault(target_ordinal, []).append(packed.PackedTensor(R, new_dims))
    sum_dims.update(left_syms)
    sum_dims.update(right_syms)
    routes["pairwise"] += 1


def _try_scan_elimination(log_factors, sum_dims, reduced, i_sym, l_sym, r_sym, size, time_sym, target_ordinal,
                          sym_size):
    """Eliminate one chain by the boundary-absorbed forward scan.  Returns
    False, with nothing outside the consumed time factors touched, when the
    chain's left endpoint factors cannot be absorbed."""
    # every remaining factor on the left endpoint must be absorbable: its
    # dims plates and the endpoint only, at an ordinal at or inside the
    # chain's
    absorbed = []
    for t in log_factors:
        for x in log_factors[t]:
            if i_sym not in x.dims:
                continue
            if set(x.dims) <= (set(sym_size) | {i_sym}) and t >= target_ordinal:
                absorbed.append((t, x))
            else:
                return False
    if not absorbed:
        return False
    absorbed_reduced = [_reduce_to_ordinal(x, t, target_ordinal, sym_size) for t, x in absorbed]

    plate_syms = sorted(
        d for d in set().union(*[set(x.dims) for x in reduced + absorbed_reduced])
        if d in sym_size and d != time_sym
    )
    other = "".join(plate_syms)
    other_shape = tuple(sym_size[d] for d in plate_syms)
    rows = math.prod(other_shape)
    steps = sym_size[time_sym]

    # initial potential over the left endpoint
    alpha0 = 0.0
    for x in absorbed_reduced:
        alpha0 = alpha0 + packed.align(x, other + i_sym).value
    alpha0 = alpha0.expand(other_shape + (size,))

    # per-step factors by the endpoints they touch: emissions only the
    # current state r, a homogeneous transition only (l, r) with no time axis
    tv_lr, tv_l, tv_r, c_lr, c_l, c_r = [], [], [], [], [], []
    for x in reduced:
        assert set(x.dims) <= set(other) | {time_sym, l_sym, r_sym}, x.dims
        has_l, has_r = l_sym in x.dims, r_sym in x.dims
        if time_sym in x.dims:
            if has_l and has_r:
                tv_lr.append(packed.align(x, time_sym + other + l_sym + r_sym).value)
            elif has_l:
                tv_l.append(packed.align(x, time_sym + other + l_sym).value)
            else:  # r only, or neither endpoint: broadcasts over r
                tv_r.append(packed.align(x, time_sym + other + r_sym).value)
        elif has_l and has_r:
            c_lr.append(packed.align(x, other + l_sym + r_sym).value)
        elif has_l:
            c_l.append(packed.align(x, other + l_sym).value)
        else:
            c_r.append(packed.align(x, other + r_sym).value)

    def per_step(tv, c):
        """The (steps, rows, size) sum of the time-varying and constant
        factors over one endpoint, or None where there is none."""
        terms = tv + [v.unsqueeze(0) for v in c]
        if not terms:
            return None
        total = sum(terms[1:], terms[0])
        return total.expand((steps,) + other_shape + (size,)).reshape(steps, rows, size)

    R = per_step(tv_r, c_r)
    if R is None:
        R = alpha0.new_zeros((steps, rows, size))
    L = per_step(tv_l, c_l)
    alpha0 = alpha0.reshape(rows, size)
    if c_lr and not tv_lr:
        # alpha' = R_t + logmatmulexp(alpha + L_t, A), the plate rows
        # flattened into the product's rows
        A = sum(c_lr[1:], c_lr[0])  # (plates-or-1..., l, r)
        if all(d == 1 for d in A.shape[:-2]):
            A = A.reshape(A.shape[-2:])
        else:
            A = A.expand(other_shape + A.shape[-2:]).reshape((rows,) + A.shape[-2:])
        alpha = markov_scan(alpha0, A, R, L)
        routes["scan"] += 1
    else:
        # a transition that varies with time: A_t = the (l, r) factors, with
        # the constant ones broadcast over time, shared by the plate rows
        # where no factor has a plate dim, else one per row
        lr_terms = tv_lr + [v.unsqueeze(0) for v in c_lr]
        if lr_terms:
            A = sum(lr_terms[1:], lr_terms[0])  # (steps or 1, plates-or-1..., l, r)
        else:
            A = alpha0.new_zeros((1,) * (1 + len(other_shape)) + (size, size))
        if all(d == 1 for d in A.shape[1:-2]):
            A = A.reshape(A.shape[:1] + A.shape[-2:]).expand(steps, size, size)
        else:
            A = A.expand((steps,) + other_shape + (size, size)).reshape(steps, rows, size, size)
        alpha = markov_scan_tv(alpha0, A, R, L)
        routes["general"] += 1
    alpha = alpha.reshape(other_shape + (size,))

    # drop the absorbed factors
    absorbed_ids = {id(x) for _, x in absorbed}
    for t in list(log_factors):
        kept = [x for x in log_factors[t] if id(x) not in absorbed_ids]
        if kept:
            log_factors[t] = kept
        else:
            del log_factors[t]
    log_factors.setdefault(target_ordinal, []).append(packed.PackedTensor(alpha, other + r_sym))
    sum_dims.discard(i_sym)
    sum_dims.discard(l_sym)
    sum_dims.add(r_sym)
    return True
