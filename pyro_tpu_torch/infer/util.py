"""Inference utilities (counterpart of ``pyro_tpu/infer/util.py``):
``MultiFrameTensor`` for Trace_ELBO and the DiCE operator for
TraceEnum_ELBO."""

from __future__ import annotations

import math
from collections import defaultdict

import torch

from ..distributions.util import is_identically_zero
from ..ops.packed import PackedTensor, broadcast_all
from ..ops.rings import logsumexp_contract, logsumexp_single


class MultiFrameTensor(dict):
    """Log-prob tensors on different plate-frame sets, summed down to a
    target frame set: a downstream cost on frames F is summed over the dims
    it does not share with the target before it multiplies a score term."""

    def __init__(self, *items):
        super().__init__()
        self.add(*items)

    def add(self, *items) -> None:
        for cond_indep_stack, value in items:
            frames = frozenset(f for f in cond_indep_stack if f.dim is not None)
            self[frames] = self[frames] + value if frames in self else value

    def sum_to(self, target_frames):
        target_frames = frozenset(f for f in target_frames if f.dim is not None)
        total = None
        for frames, value in self.items():
            for f in frames - target_frames:
                if value.ndim >= -f.dim and value.shape[f.dim] != 1:
                    value = value.sum(dim=f.dim, keepdim=True)
            while value.ndim and value.shape[0] == 1:
                value = value.squeeze(0)
            total = value if total is None else total + value
        return total


def compute_site_dice_factor(site):
    """A guide site's DiCE log factor and log denominator.

    Only a non-reparameterised site carries a score-function factor: a
    reparameterised one's gradient already flows pathwise through the
    costs.  An enumerated site's factor is its (undetached) log_prob; a
    sampled one's is ``score - score.detach()``, zero in value.  A site
    enumerated with ``num_samples`` folds ``-log(num_samples)`` into its
    factor, so that the contraction averages the draws.  A sequential site
    has the log of its support's size (``_enum_total``) as its denominator:
    each of the queue's branches repeats the costs outside its plates."""
    score_function = site["packed"]["score_parts"].score_function
    log_prob = site["packed"]["log_prob"]
    if site["infer"].get("enumerate"):
        num_samples = site["infer"].get("num_samples")
        if num_samples is not None:
            if site["infer"]["enumerate"] == "sequential":
                raise ValueError(
                    f"site '{site['name']}': enumerate=\"sequential\" with num_samples is not supported"
                )
            if is_identically_zero(score_function):
                return PackedTensor(torch.full_like(log_prob.value, -math.log(num_samples)), log_prob.dims), 0.0
            value = score_function.value - score_function.value.detach() - math.log(num_samples)
            return PackedTensor(value, score_function.dims), 0.0
        log_denom = math.log(site["infer"].get("_enum_total", 1)) if site["infer"]["enumerate"] == "sequential" else 0.0
        return (log_prob if is_identically_zero(score_function) else score_function), log_denom
    if is_identically_zero(score_function):
        return PackedTensor(torch.zeros((), device=log_prob.value.device), ""), 0.0
    return PackedTensor(score_function.value - score_function.value.detach(), score_function.dims), 0.0


class Dice:
    """The DiCE operator for plate-aware differentiable expectations:
    ``compute_expectation`` weighs each cost tensor by the marginal
    probability of its dims under the product of the guide's dice factors,
    each marginal one log-space contraction."""

    def __init__(self, guide_trace, ordering):
        self.log_denom = defaultdict(float)
        self.log_probs = defaultdict(list)
        for name, site in guide_trace.nodes.items():
            if site["type"] == "sample" and not site["infer"].get("_do_not_score"):
                log_prob, log_denom = compute_site_dice_factor(site)
                self.log_probs[ordering[name]].append(log_prob)
                if log_denom:
                    self.log_denom[ordering[name]] += log_denom

    def compute_expectation(self, costs):
        """The sum over ordinals and cost terms of each cost times the
        marginal probability of its dims, divided by the branch counts of
        the sequential sites whose plates the cost's ordinal lacks."""
        expected_cost = 0.0
        for ordinal, cost_terms in costs.items():
            log_factors = [term for t, terms in self.log_probs.items() if t <= ordinal for term in terms]
            scale = math.exp(-sum(d for t, d in self.log_denom.items() if not t <= ordinal))
            factor_dims = set()
            for f in log_factors:
                factor_dims |= set(f.dims)

            # one contraction per set of cost dims
            prob_cache = {}
            for cost in cost_terms:
                key = frozenset(cost.dims)
                if key not in prob_cache:
                    if log_factors:
                        out_dims = set(key & factor_dims)
                        log_marginal = logsumexp_contract(list(log_factors), factor_dims - out_dims)
                        # keep only the cost's dims (the others left are
                        # plate dims of the ordinal)
                        if set(log_marginal.dims) - key:
                            keep = "".join(d for d in log_marginal.dims if d in key)
                            log_marginal = logsumexp_single(log_marginal, keep)
                        prob = PackedTensor(torch.exp(log_marginal.value), log_marginal.dims)
                    else:
                        prob = PackedTensor(torch.ones((), device=cost.value.device), "")
                    prob_cache[key] = prob
                c, p = broadcast_all(cost, prob_cache[key])
                term = (c.value * p.value).sum()
                expected_cost = expected_cost + scale * term
        return expected_cost
