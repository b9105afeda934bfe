"""TraceEnum_ELBO: exact marginalisation of enumerated discrete variables
(counterpart of ``pyro_tpu/infer/traceenum_elbo.py``; the algorithm is
tensor variable elimination, arXiv:1902.03210).

Model-side enumerated variables are summed out exactly by
``contract_tensor_tree`` (vectorized Markov chains first, by the scan of
``ops/markov_product.py``); every other cost is weighed by DiCE factors, so
one surrogate gives both the ELBO and its gradient.

Parallel enumeration only: a sequential site raises
``NotImplementedError`` (the queue of ``_iter_trace_pairs`` waits), and
``compute_marginals`` is not ported yet (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .. import poutine
from ..ops import packed
from ..ops.contract import contract_tensor_tree
from ..ops.markov_product import eliminate_markov_chains
from ..ops.rings import LogRing
from ..poutine.enum_messenger import EnumMessenger
from ..poutine.util import prune_subsample_sites
from ..util import check_model_guide_match, check_site_shape, is_validation_enabled
from .elbo import ELBO
from .util import Dice


def _find_ordinal(trace, site):
    return frozenset(trace.plate_to_symbol[f.name] for f in site["cond_indep_stack"] if f.dim is not None)


def _get_common_scale(scales):
    scales_set = set()
    for scale in scales:
        if not isinstance(scale, (int, float)):
            raise ValueError("enumeration only supports scalar subsampling scales")
        scales_set.add(float(scale))
    if len(scales_set) != 1:
        raise ValueError(f"enumeration expects a single common scale, got {scales_set}")
    return scales_set.pop()


def _check_model_guide_enumeration_constraint(enum_ordinals, guide_trace):
    """Model-side enumeration must be no more global than guide-side
    enumeration: a model-enumerated variable outside a plate cannot be
    summed out exactly when a guide-enumerated variable inside that plate
    feeds the same costs."""
    min_ordinal = frozenset.intersection(*enum_ordinals)
    for name, site in guide_trace.nodes.items():
        if site["type"] == "sample" and site["infer"].get("_enumerate_dim") is not None:
            for f in site["cond_indep_stack"]:
                if f.dim is not None and guide_trace.plate_to_symbol[f.name] not in min_ordinal:
                    raise ValueError(
                        "Expected model enumeration to be no more global than guide enumeration, but found "
                        f"model enumeration sites upstream of guide site '{name}' in plate('{f.name}'). Try "
                        "converting some model enumeration sites to guide enumeration sites."
                    )


def _compute_model_factors(model_trace, guide_trace):
    """Split the model's costs into those free of model-enumerated dims
    (``marginal_costs``) and the log factors to sum over them."""
    ordering = {
        name: _find_ordinal(trace, site)
        for trace in (model_trace, guide_trace)
        for name, site in trace.nodes.items()
        if site["type"] == "sample"
    }
    cost_sites = OrderedDict()
    enum_sites = OrderedDict()
    enum_dims = set()
    non_enum_dims = set().union(*ordering.values()) if ordering else set()
    for name, site in model_trace.nodes.items():
        if site["type"] != "sample" or site["infer"].get("_do_not_score"):
            continue
        if name in guide_trace.nodes:
            cost_sites.setdefault(ordering[name], []).append(site)
            non_enum_dims.update(guide_trace.nodes[name]["packed"]["log_prob"].dims)
        elif site["infer"].get("_enumerate_dim") is None:
            cost_sites.setdefault(ordering[name], []).append(site)
        else:
            enum_sites.setdefault(ordering[name], []).append(site)
            enum_dims.update(site["packed"]["log_prob"].dims)
    enum_dims -= non_enum_dims
    log_factors = OrderedDict()
    scale = 1.0
    if not enum_sites:
        marginal_costs = OrderedDict(
            (t, [site["packed"]["log_prob"] for site in sites_t]) for t, sites_t in cost_sites.items()
        )
        return marginal_costs, log_factors, ordering, enum_dims, scale

    _check_model_guide_enumeration_constraint(set(enum_sites.keys()), guide_trace)

    # costs on enumerated dims become log factors: masked inside, scaled
    # outside the log expectation
    marginal_costs = OrderedDict()
    scales = []
    for t, sites_t in cost_sites.items():
        for site in sites_t:
            if enum_dims.isdisjoint(site["packed"]["log_prob"].dims):
                marginal_costs.setdefault(t, []).append(site["packed"]["log_prob"])
            else:
                mask = site["packed"]["mask"]
                cost = packed.scale_and_mask(
                    site["packed"]["unscaled_log_prob"], mask=None if isinstance(mask, bool) else mask
                )
                log_factors.setdefault(t, []).append(cost)
                scales.append(site["scale"])
    for t, sites_t in enum_sites.items():
        for site in sites_t:
            log_factors.setdefault(t, []).append(site["packed"]["unscaled_log_prob"])
            scales.append(site["scale"])
    scale = _get_common_scale(scales)
    return marginal_costs, log_factors, ordering, enum_dims, scale


def _compute_dice_elbo(model_trace, guide_trace):
    marginal_costs, log_factors, ordering, sum_dims, scale = _compute_model_factors(model_trace, guide_trace)
    if log_factors:
        sum_dims = eliminate_markov_chains(model_trace, log_factors, sum_dims)
        dim_to_size = {}
        for terms in log_factors.values():
            for term in terms:
                dim_to_size.update(zip(term.dims, term.shape))
        log_factors = contract_tensor_tree(log_factors, sum_dims, ring=LogRing(dim_to_size=dim_to_size))
        for t, log_factors_t in log_factors.items():
            marginal_costs_t = marginal_costs.setdefault(t, [])
            for term in log_factors_t:
                marginal_costs_t.append(packed.scale_and_mask(term, scale=scale))
    costs = marginal_costs

    # the guide's costs, negated
    for name, site in guide_trace.nodes.items():
        if site["type"] == "sample" and not site["infer"].get("_do_not_score"):
            costs.setdefault(ordering[name], []).append(packed.neg(site["packed"]["log_prob"]))
    return Dice(guide_trace, ordering).compute_expectation(costs)


class TraceEnum_ELBO(ELBO):
    """The ELBO with every model site marked ``infer={"enumerate":
    "parallel"}`` summed out exactly.  ``max_plate_nesting`` must cover the
    model's plates: enumeration dims are allocated left of it."""

    def _get_trace_pair(self, model, guide, args, kwargs, generator):
        first_dim = -1 - int(self.max_plate_nesting)
        # the EnumMessenger is innermost, so that it sees each site before
        # replay marks it done
        guide_fn = EnumMessenger(first_available_dim=first_dim)(guide)
        if generator is not None:
            guide_fn = poutine.seed(guide_fn, rng_seed=generator)
        guide_trace = poutine.trace(guide_fn).get_trace(*args, **kwargs)
        model_fn = poutine.replay(EnumMessenger()(model), trace=guide_trace)  # continues the dim allocation
        if generator is not None:
            model_fn = poutine.seed(model_fn, rng_seed=generator)
        model_trace = poutine.trace(model_fn).get_trace(*args, **kwargs)

        guide_trace = prune_subsample_sites(guide_trace)
        model_trace = prune_subsample_sites(model_trace)
        # the auxiliary vectorized_markov sites are never scored
        model_trace.compute_log_prob(site_filter=lambda name, site: not site["infer"].get("_do_not_score"))
        guide_trace.compute_score_parts()
        if is_validation_enabled():
            check_model_guide_match(model_trace, guide_trace)
            for tr in (model_trace, guide_trace):
                for site in tr.nodes.values():
                    if site["type"] == "sample":
                        check_site_shape(site, int(self.max_plate_nesting))
        # pack with one plate-symbol namespace for both traces
        model_trace.pack_tensors()
        guide_trace.pack_tensors(model_trace.plate_to_symbol)
        return model_trace, guide_trace

    def differentiable_loss(self, model, guide, *args, generator=None, **kwargs):
        """-ELBO, as a tensor whose gradient is the surrogate's."""
        self._setup(model, guide, args, kwargs)
        elbo = 0.0
        for _ in range(self.num_particles):
            model_trace, guide_trace = self._get_trace_pair(model, guide, args, kwargs, generator)
            elbo = elbo + _compute_dice_elbo(model_trace, guide_trace) / self.num_particles
        return -elbo

    def loss(self, model, guide, *args, generator=None, **kwargs):
        """-ELBO, without a graph."""
        with torch.no_grad():
            return self.differentiable_loss(model, guide, *args, generator=generator, **kwargs)
