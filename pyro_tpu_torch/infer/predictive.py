"""Posterior-predictive sampling (counterpart of
``pyro_tpu/infer/predictive.py``): ``Predictive``, ``WeighedPredictive``
and ``MHResampler``.

The JAX package maps one draw over a vector of keys with ``vmap``; here
each draw runs the model (and guide) under the handlers in turn, all of
them from one ``torch.Generator`` and without autograd, and the sites are
stacked along a new leading dim.  A draw sees the same handlers and sites
either way.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .. import poutine
from ..poutine.util import prune_subsample_sites, site_is_subsample
from ..settings import get_default_device


def _generator(generator, seed):
    """``generator``, or a fresh one on the package's device seeded with
    ``seed`` (the JAX package's default key)."""
    if generator is not None:
        return generator
    return torch.Generator(device=get_default_device()).manual_seed(seed)


def _stack(draws):
    return {name: torch.stack([d[name] for d in draws]) for name in draws[0]} if draws else {}


class Predictive:
    """Draws of a model's sites given posterior samples (one draw a
    sample, each conditioned on its slice) or a guide (``num_samples``
    draws, the model replayed on the guide's trace).  ``parallel`` keeps
    the JAX package's signature: the draws run one after another either
    way."""

    def __init__(
        self,
        model,
        posterior_samples: Optional[Dict] = None,
        guide=None,
        num_samples: Optional[int] = None,
        return_sites: Sequence[str] = (),
        parallel: bool = True,
    ):
        if posterior_samples is None and num_samples is None:
            raise ValueError("either posterior_samples or num_samples must be given")
        if posterior_samples is not None:
            batch_size = next(iter(posterior_samples.values())).shape[0]
            if num_samples is None:
                num_samples = batch_size
            elif num_samples != batch_size:
                raise ValueError(
                    f"num_samples={num_samples} disagrees with leading dim {batch_size} of posterior_samples"
                )
        self.model = model
        self.posterior_samples = posterior_samples or {}
        self.guide = guide
        self.num_samples = num_samples
        self.return_sites = tuple(return_sites)
        self.parallel = parallel

    def _model_trace(self, sample_slice, generator, args, kwargs):
        model = self.model
        if self.guide is not None:
            guide_trace = poutine.trace(poutine.seed(self.guide, rng_seed=generator)).get_trace(*args, **kwargs)
            model = poutine.replay(model, trace=guide_trace)
        model = poutine.condition(model, data=sample_slice)
        return poutine.trace(poutine.seed(model, rng_seed=generator)).get_trace(*args, **kwargs)

    def _single_draw(self, sample_slice, generator, args, kwargs):
        tr = self._model_trace(sample_slice, generator, args, kwargs)
        out = {}
        for name, site in tr.nodes.items():
            if site["type"] != "sample" or site_is_subsample(site):
                continue
            if self.return_sites:
                if name in self.return_sites:
                    out[name] = site["value"]
            elif name not in self.posterior_samples:
                # every sample site not supplied in posterior_samples
                out[name] = site["value"]
        return out

    def __call__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        return self.get_samples(*args, generator=generator, **kwargs)

    def get_samples(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        generator = _generator(generator, 11)
        with torch.no_grad():
            draws = [
                self._single_draw({k: v[i] for k, v in self.posterior_samples.items()}, generator, args, kwargs)
                for i in range(self.num_samples)
            ]
        return _stack(draws)


class WeighedPredictiveResults(NamedTuple):
    samples: Dict
    log_weights: torch.Tensor
    guide_log_prob: torch.Tensor
    model_log_prob: torch.Tensor


class WeighedPredictive(Predictive):
    """``Predictive`` from a guide, with each draw's importance log weight
    log p(x, z) - log q(z) and its two terms."""

    def _single_weighed_draw(self, generator, args, kwargs):
        guide_trace = poutine.trace(poutine.seed(self.guide, rng_seed=generator)).get_trace(*args, **kwargs)
        guide_trace_p = prune_subsample_sites(guide_trace)
        guide_trace_p.compute_log_prob()
        guide_lp = guide_trace_p.log_prob_sum()
        model = poutine.replay(self.model, trace=guide_trace)
        tr = poutine.trace(poutine.seed(model, rng_seed=generator)).get_trace(*args, **kwargs)
        tr_p = prune_subsample_sites(tr)
        tr_p.compute_log_prob()
        model_lp = tr_p.log_prob_sum(site_filter=lambda name, site: not site["infer"].get("_deterministic"))
        out = {}
        for name, site in tr.nodes.items():
            if site["type"] != "sample" or site_is_subsample(site):
                continue
            if self.return_sites:
                if name in self.return_sites:
                    out[name] = site["value"]
            elif not site["is_observed"]:
                out[name] = site["value"]
        return out, model_lp - guide_lp, guide_lp, model_lp

    def get_samples(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        if self.guide is None:
            raise ValueError("WeighedPredictive requires a guide")
        generator = _generator(generator, 11)
        with torch.no_grad():
            draws = [self._single_weighed_draw(generator, args, kwargs) for _ in range(self.num_samples)]
        samples, log_w, guide_lp, model_lp = zip(*draws)
        return WeighedPredictiveResults(_stack(list(samples)), torch.stack(log_w), torch.stack(guide_lp),
                                        torch.stack(model_lp))


class MHResampler:
    """Metropolis-Hastings resampling of weighed draws toward the model's
    posterior: each call draws a fresh batch from ``sampler`` and keeps,
    draw by draw, the new one with probability min(1, w_new / w_kept).
    The two slice arguments keep the JAX package's signature and are not
    read there either."""

    def __init__(self, sampler: WeighedPredictive, source_samples_slice=slice(0), stored_samples_slice=slice(0),
                 generator: Optional[torch.Generator] = None):
        self.sampler = sampler
        self._current: Optional[WeighedPredictiveResults] = None
        # the resampler's own stream (the JAX package's key 17): the
        # sampler draws from it too unless the caller passes a generator,
        # so every round proposes fresh draws
        self._generator = _generator(generator, 17)

    def __call__(self, *args, **kwargs) -> WeighedPredictiveResults:
        if kwargs.get("generator") is None:
            kwargs["generator"] = self._generator
        new = self.sampler.get_samples(*args, **kwargs)
        if self._current is None:
            self._current = new
            return new
        cur = self._current
        u = torch.rand(new.log_weights.shape, generator=self._generator, device=new.log_weights.device,
                       dtype=new.log_weights.dtype)
        accept = torch.log(u) < (new.log_weights - cur.log_weights)

        def pick(n, c):
            return torch.where(accept.reshape(accept.shape + (1,) * (n.ndim - 1)), n, c)

        merged = WeighedPredictiveResults(
            {k: pick(new.samples[k], cur.samples[k]) for k in new.samples},
            torch.where(accept, new.log_weights, cur.log_weights),
            torch.where(accept, new.guide_log_prob, cur.guide_log_prob),
            torch.where(accept, new.model_log_prob, cur.model_log_prob),
        )
        self._current = merged
        return merged
