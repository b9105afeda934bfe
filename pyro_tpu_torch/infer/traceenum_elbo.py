"""TraceEnum_ELBO: exact marginalisation of enumerated discrete variables
(counterpart of ``pyro_tpu/infer/traceenum_elbo.py``; the algorithm is
tensor variable elimination, arXiv:1902.03210).

Model-side enumerated variables are summed out exactly by
``contract_tensor_tree`` (vectorized Markov chains first, by the scan of
``ops/markov_product.py``); every other cost is weighed by DiCE factors, so
one surrogate gives both the ELBO and its gradient.  A guide site marked
``"sequential"`` is enumerated by a queue of trace pairs, one a value
(``_iter_trace_pairs``); a site with ``num_samples`` takes that many draws
in place of its support.  ``compute_marginals`` gives the posterior
marginal of each model-enumerated site, one per plate slice, by the adjoint
of one contraction (``ops/einsum_adjoint.py``).
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from queue import LifoQueue

import torch

from .. import poutine
from ..distributions.discrete import Bernoulli, Categorical
from ..ops import packed
from ..ops.contract import contract_tensor_tree
from ..ops.einsum_adjoint import adjoint_marginals, marginal_of_dims
from ..ops.markov_product import eliminate_markov_chains
from ..ops.rings import LogRing
from ..poutine.enum_messenger import EnumMessenger
from ..poutine.handlers import EscapeMessenger
from ..poutine.runtime import NonlocalExit
from ..poutine.trace_struct import Trace
from ..poutine.util import prune_subsample_sites
from ..util import check_model_guide_match, check_site_shape, is_validation_enabled
from .elbo import ELBO
from .enum import iter_discrete_escape, iter_discrete_extend
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
            log_prob = site["packed"]["unscaled_log_prob"]
            num_samples = site["infer"].get("num_samples")
            if num_samples is not None:
                # drawn from its own distribution: a draw's weight p/q is 1
                # in value and a score term in gradient, and the draws are
                # averaged
                value = log_prob.value - log_prob.value.detach() - math.log(num_samples)
                log_prob = packed.PackedTensor(value, log_prob.dims)
            log_factors.setdefault(t, []).append(log_prob)
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


class _SequentialEscape(Exception):
    """A sequentially enumerated guide site stopped the guide: carries the
    partial trace (the sites run so far) and the site's message."""

    def __init__(self, partial_trace, site):
        super().__init__(site.get("name"))
        self.partial_trace = partial_trace
        self.site = site


class TraceEnum_ELBO(ELBO):
    """The ELBO with every model site marked ``infer={"enumerate":
    "parallel"}`` summed out exactly, and every guide site so marked (or
    ``"sequential"``) enumerated.  ``max_plate_nesting`` must cover the
    model's plates: enumeration dims are allocated left of it."""

    def _get_trace_pair(self, model, guide, args, kwargs, generator, queue_trace=None):
        """Run the guide, then the model replayed against it, both under
        enumeration.  With ``queue_trace`` (a partial trace that fixes some
        sequential sites) the guide replays it, and a sequential site it
        does not fix raises ``_SequentialEscape``."""
        # the seed handler is innermost, so that sampled enumeration draws
        # from the generator; the EnumMessenger sees each site before replay
        # marks it done, so every branch of the queue walks the same dims
        first_dim = -1 - int(self.max_plate_nesting)
        guide_fn = guide if generator is None else poutine.seed(guide, rng_seed=generator)
        guide_fn = EnumMessenger(first_available_dim=first_dim)(guide_fn)
        if queue_trace is not None:
            guide_fn = EscapeMessenger(functools.partial(iter_discrete_escape, queue_trace))(
                poutine.replay(guide_fn, trace=queue_trace)
            )
        tracer = poutine.trace(guide_fn)
        try:
            guide_trace = tracer.get_trace(*args, **kwargs)
        except NonlocalExit as escape:
            escape.reset_stack()
            raise _SequentialEscape(tracer.msngr.get_trace(), escape.site) from None
        model_fn = model if generator is None else poutine.seed(model, rng_seed=generator)
        model_fn = poutine.replay(EnumMessenger()(model_fn), trace=guide_trace)  # continues the dim allocation
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

    def _iter_trace_pairs(self, model, guide, args, kwargs, generator):
        """One (model, guide) trace pair for each combination of the values
        of the guide's sequential sites, from a LIFO queue of partial
        traces; exactly one pair when there is no sequential site."""
        queue = LifoQueue()
        queue.put(Trace())
        while not queue.empty():
            partial = queue.get()
            try:
                yield self._get_trace_pair(model, guide, args, kwargs, generator, queue_trace=partial)
            except _SequentialEscape as escape:
                for extended in iter_discrete_extend(escape.partial_trace, escape.site):
                    queue.put(extended)

    def differentiable_loss(self, model, guide, *args, generator=None, **kwargs):
        """-ELBO, as a tensor whose gradient is the surrogate's."""
        self._setup(model, guide, args, kwargs)
        elbo = 0.0
        for _ in range(self.num_particles):
            for model_trace, guide_trace in self._iter_trace_pairs(model, guide, args, kwargs, generator):
                elbo = elbo + _compute_dice_elbo(model_trace, guide_trace) / self.num_particles
        return -elbo

    def loss(self, model, guide, *args, generator=None, **kwargs):
        """-ELBO, without a graph."""
        with torch.no_grad():
            return self.differentiable_loss(model, guide, *args, generator=generator, **kwargs)

    def compute_marginals(self, model, guide, *args, generator=None, **kwargs):
        """The posterior marginal of each model-enumerated site given the
        guide's draw, by site name: a ``Categorical`` (a ``Bernoulli`` for a
        Bernoulli site) over the rightmost dim, whose batch shape is the
        site's plates, each slice normalised on its own."""
        self._setup(model, guide, args, kwargs)
        model_trace, guide_trace = self._get_trace_pair(model, guide, args, kwargs, generator)
        return _compute_marginals(model_trace, guide_trace)


def _site_plates(trace, site):
    """A site's plate symbols and sizes, leftmost dim first."""
    frames = sorted((f for f in site["cond_indep_stack"] if f.dim is not None), key=lambda f: f.dim)
    return "".join(trace.plate_to_symbol[f.name] for f in frames), [f.subsample_size for f in frames]


def _compute_marginals(model_trace, guide_trace):
    """Each model-enumerated site's marginal from the gradient of log Z by a
    zero probe factor over the site's plates and its own dim, placed at the
    site's ordinal: every site's marginals, one per plate slice, from one
    forward contraction and one backward pass."""
    if any(site["type"] == "markov_chain" and site["value"] for site in model_trace.nodes.values()):
        raise NotImplementedError(
            "compute_marginals does not support vectorized_markov; use pyro.markov (unrolled) for marginals"
        )
    for name, site in guide_trace.nodes.items():
        if site["type"] == "sample" and site["infer"].get("enumerate") == "sequential":
            raise NotImplementedError(
                f"compute_marginals does not support the sequentially enumerated guide site '{name}': "
                'mark it enumerate="parallel"'
            )
    _, log_factors, ordering, sum_dims, _ = _compute_model_factors(model_trace, guide_trace)
    probes = OrderedDict()
    for name, site in model_trace.nodes.items():
        if site["type"] != "sample" or name in guide_trace.nodes or site["infer"].get("_enumerate_dim") is None:
            continue
        symbol = site["infer"]["_enumerate_symbol"]
        plates, sizes = _site_plates(model_trace, site)
        value = site["value"]
        size = value.shape[value.ndim - site["fn"].event_dim + site["infer"]["_enumerate_dim"]]
        log_prob = site["packed"]["unscaled_log_prob"].value
        probe = packed.PackedTensor(log_prob.new_zeros(sizes + [size]), plates + symbol)
        log_factors.setdefault(ordering[name], []).append(probe)
        probes[name] = (site, probe)
    if not probes:
        return OrderedDict()
    _, marginal_tree = adjoint_marginals(log_factors, sum_dims)
    marginal_of = {
        id(term): marginal
        for terms, marginals in zip(log_factors.values(), marginal_tree.values())
        for term, marginal in zip(terms, marginals)
    }

    marginals = OrderedDict()
    for name, (site, probe) in probes.items():
        probs = marginal_of_dims(marginal_of[id(probe)], {site["infer"]["_enumerate_symbol"]}, sum_dims)
        logits = torch.log(probs.value.clamp(min=torch.finfo(probs.value.dtype).tiny))
        logits = packed.unpack(packed.PackedTensor(logits, probs.dims), model_trace.symbol_to_dim)
        # the batch shape of the site's plates: a plate of size 1 keeps its dim
        batch = [1] * -min((f.dim for f in site["cond_indep_stack"] if f.dim is not None), default=0)
        for f in site["cond_indep_stack"]:
            if f.dim is not None:
                batch[f.dim] = f.subsample_size
        logits = logits.movedim(site["infer"]["_enumerate_dim"], -1).reshape(batch + [-1])
        logits = logits - logits.logsumexp(-1, keepdim=True)
        fn = site["fn"]
        while hasattr(fn, "base_dist"):
            fn = fn.base_dist
        if isinstance(fn, Bernoulli):
            marginals[name] = Bernoulli(logits=logits[..., 1] - logits[..., 0])
        else:
            marginals[name] = Categorical(logits=logits)
    return marginals
