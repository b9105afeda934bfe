"""ELBO base class and Trace_ELBO (counterpart of
``pyro_tpu/infer/elbo.py``).

``differentiable_loss`` returns a tensor whose value is -ELBO and whose
gradient is the gradient of the surrogate objective; ``SVI`` calls
``backward()`` on it.
"""

from __future__ import annotations

import torch

from .. import poutine
from ..distributions.util import is_identically_zero
from .enum import get_importance_trace
from .util import MultiFrameTensor


class ELBO:
    """Particles are drawn one after another (no vectorised particle plate)."""

    def __init__(self, num_particles: int = 1, max_plate_nesting: float = float("inf")):
        self.num_particles = num_particles
        self.max_plate_nesting = max_plate_nesting

    def _guess_max_plate_nesting(self, model, guide, args, kwargs):
        """Run guide and model once and read the deepest plate dim."""
        with poutine.block():
            guide_trace = poutine.trace(poutine.seed(guide, rng_seed=0)).get_trace(*args, **kwargs)
            model_trace = poutine.trace(
                poutine.seed(poutine.replay(model, trace=guide_trace), rng_seed=0)
            ).get_trace(*args, **kwargs)
        dims = [
            f.dim
            for tr in (model_trace, guide_trace)
            for site in tr.nodes.values()
            if site["type"] == "sample"
            for f in site["cond_indep_stack"]
            if f.dim is not None
        ]
        self.max_plate_nesting = -min(dims) if dims else 0

    def _setup(self, model, guide, args, kwargs):
        if self.max_plate_nesting == float("inf"):
            self._guess_max_plate_nesting(model, guide, args, kwargs)

    def _get_traces(self, model, guide, args, kwargs, generator):
        """Yield (model_trace, guide_trace) per particle."""
        for _ in range(self.num_particles):
            yield get_importance_trace(self.max_plate_nesting, model, guide, args, kwargs, generator=generator)


def _compute_log_r(model_trace, guide_trace) -> MultiFrameTensor:
    log_r = MultiFrameTensor()
    for name, model_site in model_trace.nodes.items():
        if model_site["type"] == "sample":
            log_r_term = model_site["log_prob"]
            if not model_site["is_observed"]:
                log_r_term = log_r_term - guide_trace.nodes[name]["log_prob"]
            log_r.add((model_site["cond_indep_stack"], log_r_term.detach()))
    return log_r


class Trace_ELBO(ELBO):
    """Monte Carlo ELBO with partial Rao-Blackwellisation: surrogate =
    sum model log p - sum guide entropy terms + sum detached log_r times the
    score function of each non-reparameterised guide site."""

    def _differentiable_loss_particle(self, model_trace, guide_trace):
        elbo_particle = 0.0
        surrogate_elbo_particle = 0.0
        log_r = None

        for name, model_site in model_trace.nodes.items():
            if model_site["type"] == "sample" and not model_site["infer"].get("_do_not_score"):
                elbo_particle = elbo_particle + model_site["log_prob_sum"]
                surrogate_elbo_particle = surrogate_elbo_particle + model_site["log_prob_sum"]

        for name, guide_site in guide_trace.nodes.items():
            if guide_site["type"] != "sample" or guide_site["infer"].get("_do_not_score"):
                continue
            log_prob, score_function_term, entropy_term = guide_site["score_parts"]
            elbo_particle = elbo_particle - guide_site["log_prob_sum"]
            if not is_identically_zero(entropy_term):
                surrogate_elbo_particle = surrogate_elbo_particle - entropy_term.sum()
            if not is_identically_zero(score_function_term):
                if log_r is None:
                    log_r = _compute_log_r(model_trace, guide_trace)
                site_r = log_r.sum_to(guide_site["cond_indep_stack"])
                surrogate_elbo_particle = surrogate_elbo_particle + (site_r * score_function_term).sum()

        return -elbo_particle, -surrogate_elbo_particle

    def differentiable_loss(self, model, guide, *args, generator=None, **kwargs):
        """A tensor with the value of -ELBO and the gradient of the surrogate."""
        self._setup(model, guide, args, kwargs)
        loss = 0.0
        surrogate = 0.0
        for model_trace, guide_trace in self._get_traces(model, guide, args, kwargs, generator):
            lp, sp = self._differentiable_loss_particle(model_trace, guide_trace)
            loss = loss + lp / self.num_particles
            surrogate = surrogate + sp / self.num_particles
        return surrogate + (loss - surrogate).detach()

    def loss(self, model, guide, *args, generator=None, **kwargs):
        """Estimate of -ELBO, without a graph."""
        with torch.no_grad():
            return self.differentiable_loss(model, guide, *args, generator=generator, **kwargs)
