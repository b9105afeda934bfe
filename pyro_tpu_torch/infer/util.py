"""Inference utilities (counterpart of ``pyro_tpu/infer/util.py``):
``MultiFrameTensor`` for Trace_ELBO and the DiCE operator for
TraceEnum_ELBO."""

from __future__ import annotations

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
    """A guide site's DiCE log factor.  Only a non-reparameterised site
    carries a score-function factor: a reparameterised one's gradient
    already flows pathwise through the costs.  An enumerated site's factor
    is its (undetached) log_prob; a sampled one's is ``score -
    score.detach()``, zero in value.  (Sampled enumeration, whose factor
    has a log normaliser, is not ported.)"""
    score_function = site["packed"]["score_parts"].score_function
    if site["infer"].get("enumerate"):
        if site["infer"].get("num_samples") is not None or site["infer"]["enumerate"] == "sequential":
            raise NotImplementedError(
                "sampled and sequential enumeration are not ported yet; see ROADMAP.md Queue 1 item 4"
            )
        return site["packed"]["log_prob"] if is_identically_zero(score_function) else score_function
    if is_identically_zero(score_function):
        return PackedTensor(torch.zeros((), device=site["packed"]["log_prob"].value.device), "")
    return PackedTensor(score_function.value - score_function.value.detach(), score_function.dims)


class Dice:
    """The DiCE operator for plate-aware differentiable expectations:
    ``compute_expectation`` weighs each cost tensor by the marginal
    probability of its dims under the product of the guide's dice factors,
    each marginal one log-space contraction."""

    def __init__(self, guide_trace, ordering):
        self.log_probs = defaultdict(list)
        for name, site in guide_trace.nodes.items():
            if site["type"] == "sample" and not site["infer"].get("_do_not_score"):
                self.log_probs[ordering[name]].append(compute_site_dice_factor(site))

    def compute_expectation(self, costs):
        """The sum over ordinals and cost terms of each cost times the
        marginal probability of its dims."""
        expected_cost = 0.0
        for ordinal, cost_terms in costs.items():
            log_factors = [term for t, terms in self.log_probs.items() if t <= ordinal for term in terms]
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
                expected_cost = expected_cost + (c.value * p.value).sum()
        return expected_cost
