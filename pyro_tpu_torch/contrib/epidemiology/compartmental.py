"""Compartmental epidemiological models (counterpart of
``pyro_tpu/contrib/epidemiology/compartmental.py``).

A subclass writes ``global_model``, ``initialize`` and ``transition`` for
one time step.  Two modes of inference:

- relaxed (``fit_svi``, and ``fit_mcmc`` with ``num_quant_bins=1``): the
  compartment flows are real-valued latent sites under moment-matched
  Normals, unrolled over time under ``pyro.markov``;
- quantized (``fit_mcmc(num_quant_bins > 1)``), asymptotically exact:
  NUTS over a continuous ``auxiliary`` series of the compartments, each
  value enumerated over the nearest ``num_quant_bins`` integers with
  spline weights, so that a step's joint transition factor is a
  (Q^C, Q^C) matrix; time is eliminated by the O(log T) chain reduction,
  K3f on the card at Q^C <= 64 (``ops/log_matmul.py::log_chain``).

Tensors live on the package's device (``set_default_device``); the
model's constants are made there when it is built, so that the quantized
potential, captured as a CUDA graph inside NUTS, reads nothing from the
host.
"""

from __future__ import annotations

import functools
import math
import operator
import re
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import distributions as dist
from ... import poutine
from ... import primitives as pyro
from ...infer import MCMC, NUTS, SVI, Predictive, Trace_ELBO
from ...infer.autoguide import AutoNormal
from ...ops.log_matmul import sequential_logmatmulexp_timemajor
from ...optim import ClippedAdam
from ...poutine.util import site_is_subsample
from ...settings import get_default_device
from .distributions import set_relaxed_distributions
from .util import quantize_enumerate

# the particle filter that repairs an infeasible start of quantized NUTS
_PARTICLES, _PARTICLE_SEED = 1024, 17


class CompartmentalModel:
    """Subclass and implement ``global_model``, ``initialize`` and
    ``transition``; ``population`` is a number or, for a regional model, a
    vector of the regions' populations."""

    def __init__(self, compartments: List[str], duration: int, population, *, approximate=()):
        self.compartments = list(compartments)
        self.duration = duration
        self.population = population
        self.approximate = tuple(approximate)
        self.device = get_default_device()
        # the population as a float tensor on the model's device
        self._pop = (population.to(device=self.device, dtype=torch.get_default_dtype())
                     if isinstance(population, torch.Tensor)
                     else torch.as_tensor(population, dtype=torch.get_default_dtype(), device=self.device))
        self.is_regional = self._pop.ndim > 0
        self.samples: Dict[str, torch.Tensor] = {}
        # relaxed mode: count distributions become moment-matched Normals
        # over real flows during inference
        self.relaxed = True
        self.num_quant_bins = 1

    def _tensor(self, value):
        """A state value as a float tensor: a number becomes a fill on the
        model's device."""
        if isinstance(value, torch.Tensor):
            return value if value.is_floating_point() else value.to(torch.get_default_dtype())
        return torch.full((), float(value), dtype=torch.get_default_dtype(), device=self.device)

    @property
    def region_plate(self):
        """The plate over regions of a vector-population model, one object
        an execution of the model: every step reuses it, else the steps'
        plates would collide in the trace."""
        assert self.is_regional
        if getattr(self, "_region_plate", None) is None:
            self._region_plate = pyro.plate("region", self._pop.shape[0], dim=-1)
        return self._region_plate

    def _clear_plates(self):
        self._region_plate = None

    @property
    def _non_compartmental(self):
        """name -> (a step's distribution, whether it is regional) of the
        latent sites of ``transition`` that are not compartmental flows
        (the Brownian drift series of the Heterogeneous models), found by
        tracing one step."""
        if getattr(self, "_non_compartmental_cache", None) is None:
            self._clear_plates()

            def one_step():
                params = self.global_model()
                prev = {k: self._tensor(v) for k, v in self.initialize(params).items()}
                for name in self.approximate:
                    prev[name + "_approx"] = prev[name]
                curr = dict(prev)
                self.transition(params, curr, 0)
                return prev, curr, params

            with poutine.block():
                with poutine.trace() as capture:
                    prev, curr, params = poutine.seed(one_step, rng_seed=0)()
                tr = capture.trace
                flows = self.compute_flows(prev, curr, 0)
            result = OrderedDict()
            for name, site in tr.nodes.items():
                if site["type"] != "sample" or site["is_observed"]:
                    continue
                if name in flows or site_is_subsample(site) or site["infer"].get("_deterministic"):
                    continue
                if not name.endswith("_0"):
                    continue
                is_regional = any(f.name == "region" for f in site["cond_indep_stack"])
                result[name[:-2]] = (site["fn"], is_regional)
            self._non_compartmental_cache = result
            self._clear_plates()
        return self._non_compartmental_cache

    # -- to implement -----------------------------------------------------------
    def global_model(self):
        return None

    def initialize(self, params) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def transition(self, params, state: Dict, t) -> Dict:
        raise NotImplementedError

    def finalize(self, params, prev: Dict, curr: Dict) -> None:
        """An optional likelihood over the whole (approximate) time series,
        called once after all transitions.  It must not hold latent
        ``pyro.sample`` statements."""

    def compute_flows(self, prev: Dict, curr: Dict, t) -> Dict:
        """The flows between compartments given the populations before and
        after step ``t``: by default sequential flows ending in an implicit
        ``R`` compartment."""
        flows = {}
        flow = 0.0
        names = self.compartments + ["R"]
        for source, destin in zip(names[:-1], names[1:]):
            flow = prev[source] - curr[source] + flow
            flows[f"{source}2{destin}_{t}"] = flow
        return flows

    # -- inference ----------------------------------------------------------------
    def _model(self, forecast: int = 0):
        """The time-unrolled model (relaxed while ``self.relaxed``), with
        ``forecast`` steps past the data."""
        self._clear_plates()
        with set_relaxed_distributions(self.relaxed):
            params = self.global_model()
            state = {k: self._tensor(v) for k, v in self.initialize(params).items()}
            prev_series = {n: [] for n in self.approximate}
            curr_series = {n: [] for n in self.approximate}
            for t in pyro.markov(range(self.duration + forecast)):
                state = dict(state)
                # in sequential execution the exact values stand in for the
                # approximate proxies
                for name in self.approximate:
                    state[name + "_approx"] = state[name]
                    prev_series[name].append(state[name])
                self._t = t
                state = self.transition(params, state, t) or state
                for name in self.approximate:
                    curr_series[name].append(state[name])
                for name in self.compartments:
                    pyro.deterministic(f"{name}_{t}", state[name])
            if self.approximate:
                time_axis = -1 - self._pop.ndim
                self.finalize(
                    params,
                    {n: torch.stack(v, dim=time_axis) for n, v in prev_series.items()},
                    {n: torch.stack(v, dim=time_axis) for n, v in curr_series.items()},
                )
        return params

    def generate(self, fixed=None, generator=None) -> Dict:
        """A draw from the prior conditioned on the ``fixed`` top-level
        parameters, through the exact count distributions: observed sites
        are unconditioned, so the model draws fresh data.  ``generator`` is
        a ``torch.Generator`` or a seed; without it the draws take torch's
        global generator."""
        fixed = {k: self._tensor(v) if not isinstance(v, torch.Tensor) else v.to(self.device)
                 for k, v in (fixed or {}).items()}
        model = poutine.condition(poutine.uncondition(lambda: self._model(forecast=0)), data=fixed)
        if generator is not None:
            model = poutine.seed(model, rng_seed=generator)
        old_relaxed, self.relaxed = self.relaxed, False
        try:
            trace = poutine.trace(model).get_trace()
        finally:
            self.relaxed = old_relaxed
        return {name: site["value"] for name, site in trace.nodes.items() if site["type"] == "sample"}

    def fit_svi(self, *, num_steps: int = 1001, learning_rate: float = 0.05, guide=None, generator=None,
                log_every: int = 0, **options):
        """Relaxed-flow SVI with an ``AutoNormal`` guide and ClippedAdam;
        returns the losses.  Other options are accepted and unused, as in
        the JAX package."""
        guide = guide or AutoNormal(self._model, init_scale=0.05)
        svi = SVI(self._model, guide, ClippedAdam({"lr": learning_rate, "clip_norm": 10.0}), Trace_ELBO())
        losses = [float(x) for x in svi.run_steps(num_steps, generator=generator)]
        if log_every:
            for step in range(0, num_steps, log_every):
                print(f"step {step} loss = {losses[step]:.2f}")
        self.guide = guide
        return losses

    # -- quantized enumeration ------------------------------------------------------
    def _quantized_model(self):
        """The asymptotically exact model of ``fit_mcmc(num_quant_bins > 1)``:
        the integer compartment series is reparametrised by a continuous
        ``auxiliary`` series, each value enumerated over the Q nearest
        integers with spline weights; a step's joint transition factor is a
        (Q^C, Q^C) matrix, and time is eliminated exactly by the O(log T)
        chain reduction.

        Regional models enumerate each region's compartments locally and
        couple regions through the non-enumerated ``*_approx`` proxies (the
        auxiliary values); the chain reduction is batched over regions."""
        self._clear_plates()
        C = len(self.compartments)
        T = self.duration
        Q = self.num_quant_bins
        pop = self._pop
        R_shape = tuple(pop.shape) if self.is_regional else ()
        n_plates = 1 + len(R_shape)  # time (and region)

        params = self.global_model()
        auxiliary = pyro.sample(
            "auxiliary",
            dist.Uniform(pop.new_full((), -0.5), pop + 0.5).mask(False).expand((C, T) + R_shape)
            .to_event(2 + len(R_shape)),
        )
        # (C, T[, R], Q) enumerated integer values and their spline logits
        curr_q, logp_q = quantize_enumerate(auxiliary, 0.0, pop, num_quant_bins=Q)

        def enum_reshape(x, position):
            # (T[, R], Q) -> Q at dim -(n_plates + 1 + position), the plate
            # dims (time[, region]) rightmost
            return x.movedim(-1, 0).reshape((Q,) + (1,) * position + (T,) + R_shape)

        init = self.initialize(params)
        curr, prev, logp = {}, {}, {}
        for e, name in enumerate(self.compartments):
            vals = curr_q[e]  # (T[, R], Q)
            init_v = self._tensor(init[name]).to(vals.dtype)[..., None].broadcast_to((1,) + R_shape + (Q,))
            prev_vals = torch.cat([init_v, vals[:-1]], 0)
            curr[name] = enum_reshape(vals, e)
            logp[name] = enum_reshape(logp_q[e], e)
            prev[name] = enum_reshape(prev_vals, C + e)
        # non-compartmental time series (drift factors): flat improper
        # series, scored only through the conditioned transition factors
        for name, (fn, is_regional) in self._non_compartmental.items():
            shape = (T,)
            if self.is_regional:
                shape = shape + (R_shape if is_regional else (1,))
            series = pyro.sample(
                name,
                dist.ImproperUniform(fn.support, fn.batch_shape, fn.event_shape).expand(shape).to_event(len(shape)),
            )
            init_nc = self._tensor(init[name]).to(series.dtype).broadcast_to(shape[1:]).reshape((1,) + shape[1:])
            curr[name] = series
            prev[name] = torch.cat([init_nc, series[:-1]], 0)

        # non-enumerated proxies of the approximate compartments
        for name in self.approximate:
            aux_c = auxiliary[self.compartments.index(name)]
            init_a = self._tensor(init[name]).to(aux_c.dtype).broadcast_to(R_shape).reshape((1,) + R_shape)
            curr[name + "_approx"] = aux_c
            prev[name + "_approx"] = torch.cat([init_a, aux_c[:-1]], 0)

        # the transition factors, vectorised over time
        t = slice(0, T, 1)
        cond_data = {f"{k}_{t}": v for k, v in curr.items()}
        cond_data.update(self.compute_flows(prev, curr, t))
        with poutine.block():
            with poutine.trace() as tr:
                with pyro.plate("time", T, dim=-n_plates):
                    with poutine.condition(data=cond_data):
                        state = dict(prev)
                        self.transition(params, state, t)
        trace = tr.trace
        trace.compute_log_prob()
        for name, site in trace.nodes.items():
            if site["type"] != "sample" or site_is_subsample(site):
                continue
            if not site["is_observed"] and name not in cond_data:
                raise NotImplementedError(
                    f"latent site {name!r} inside transition() is not supported by quantized enumeration; use "
                    "the relaxed mode (num_quant_bins=1) for models with non-compartmental time-varying latents"
                )
            lp = site["log_prob"]
            if lp.ndim <= n_plates:  # not enumerated
                pyro.factor("transition_" + name, lp.sum())
                continue
            if self.is_regional and tuple(lp.shape[-1:]) != R_shape:
                # poor man's tensor variable elimination: spread a region-less
                # factor uniformly over regions
                lp = lp.broadcast_to(lp.shape[:-1] + R_shape) / R_shape[0]
            logp[name] = lp

        # variable elimination over time: (T[, R], p, c) -> ([R,] p, c)
        total = functools.reduce(operator.add, logp.values())
        total = total.broadcast_to((Q,) * (2 * C) + (T,) + R_shape).reshape((Q**C, Q**C, T) + R_shape)
        total = total.permute(2, 3, 0, 1) if self.is_regional else total.permute(2, 0, 1)
        total = sequential_logmatmulexp_timemajor(total)
        pyro.factor("transition", torch.logsumexp(total, dim=(-2, -1)).sum())

        # the final likelihood over the approximate proxies
        prev_f = {name: prev[name + "_approx"] for name in self.approximate}
        curr_f = {name: curr[name + "_approx"] for name in self.approximate}
        self.finalize(params, prev_f, curr_f)
        return params

    def _heuristic_init(self, num_steps: int, learning_rate: float):
        """Starting values for quantized NUTS from a short relaxed SVI fit:
        the posterior-median flows run through the model give a feasible
        compartment series."""
        old_relaxed = self.relaxed
        self.relaxed = True
        try:
            self.fit_svi(num_steps=num_steps, learning_rate=learning_rate)
            median = {k: v.detach() for k, v in self.guide.median().items()}
            cond = poutine.condition(lambda: self._model(), data=dict(median))
            tr = poutine.trace(poutine.seed(cond, rng_seed=17)).get_trace()
            series = []
            for name in self.compartments:
                vals = torch.stack([tr.nodes[f"{name}_{t}"]["value"] for t in range(self.duration)])
                series.append(torch.minimum(vals.clamp(min=0.0), self._pop))
            init_values = {"auxiliary": torch.stack(series).detach()}
            # the drift series, stacked into the shapes _quantized_model declares
            for base, (fn, is_regional) in self._non_compartmental.items():
                vals = torch.stack([tr.nodes[f"{base}_{t}"]["value"] for t in range(self.duration)]).detach()
                if self.is_regional and not is_regional:
                    vals = vals.reshape(self.duration, 1)
                init_values[base] = vals
            for name, value in median.items():
                if not re.search(r"_\d+$", name):
                    init_values[name] = value
            return init_values
        finally:
            self.relaxed = old_relaxed
            self.guide = None

    def _quantized_log_density(self, values) -> float:
        """The quantized model's log joint at ``values`` (a read from the
        device)."""
        with torch.no_grad(), poutine.block():
            tr = poutine.trace(poutine.condition(self._quantized_model, data=values)).get_trace()
            return float(tr.log_prob_sum(site_filter=lambda name, site: not site["infer"].get("_deterministic")))

    def _particle_init(self, init_values):
        """A feasible start for quantized NUTS when the relaxed fit's series
        is not one (its log joint is -inf: a flow below its observed count,
        say, which the relaxed Normals allow): a bootstrap particle filter
        through the exact transitions at the fit's global parameters, each
        step's particles drawn from the transition and resampled by the
        observations' likelihood; the best particle's integer series
        replaces the relaxed one.  Raises ``ValueError`` if every particle
        fails: the data then admit no start near the fit."""
        T, P = self.duration, _PARTICLES
        R_shape = tuple(self._pop.shape) if self.is_regional else ()
        names = self.compartments + list(self._non_compartmental)
        generator = torch.Generator(device=self.device).manual_seed(_PARTICLE_SEED)

        def particles(x):
            # (P,) + the value's shape, its dims aligned right of the region's
            x = x.reshape((1,) * (1 + len(R_shape) - x.ndim) + tuple(x.shape))
            return x.expand((P,) + tuple(x.shape[1:]))

        def per_particle(lp):
            lp = lp.reshape((1,) * (1 + len(R_shape) - lp.ndim) + tuple(lp.shape))
            return lp.reshape(lp.shape[0], -1).sum(-1).expand(P)

        with torch.no_grad(), poutine.block(), set_relaxed_distributions(False):
            self._clear_plates()
            globals_ = {k: v for k, v in init_values.items() if k not in names and k != "auxiliary"}
            params = poutine.condition(self.global_model, data=globals_)()
            state = {k: particles(self._tensor(v)) for k, v in self.initialize(params).items()}
            history = {k: [] for k in names}
            log_w = torch.zeros(P, device=self.device)
            for t in range(T):
                state = dict(state)
                for name in self.approximate:
                    state[name + "_approx"] = state[name]
                with poutine.trace() as tr:
                    state = poutine.seed(self.transition, rng_seed=generator)(params, state, t) or state
                for site in tr.trace.nodes.values():
                    if site["type"] == "sample" and site["is_observed"] and not site["infer"].get("_deterministic"):
                        log_w = log_w + per_particle(site["fn"].log_prob(site["value"]))
                if not bool(torch.isfinite(log_w).any()):
                    raise ValueError(
                        f"fit_mcmc: the relaxed fit's start is infeasible for the quantized model (log joint -inf), "
                        f"and none of {P} particles through the exact transitions survives step {t}")
                for k in names:
                    history[k].append(particles(state[k]))
                idx = torch.multinomial(torch.softmax(log_w, 0), P, replacement=True, generator=generator)
                state = {k: v[idx] for k, v in state.items() if not k.endswith("_approx")}
                history = {k: [h[idx] for h in v] for k, v in history.items()}
                log_w = torch.zeros_like(log_w)
        best = 0  # after the last resampling every particle carries its ancestry's path
        init_values = dict(init_values)
        init_values["auxiliary"] = torch.stack([torch.stack([h[best] for h in history[k]]) for k in self.compartments])
        for base in self._non_compartmental:
            init_values[base] = torch.stack([h[best] for h in history[base]])
        return init_values

    def fit_mcmc(self, *, num_samples: int = 500, warmup_steps: Optional[int] = None, num_chains: int = 1,
                 max_tree_depth: int = 8, num_quant_bins: int = 1, heuristic_num_steps: int = 500,
                 heuristic_learning_rate: float = 0.05, generator: Optional[torch.Generator] = None, **options):
        """NUTS over the relaxed flows (``num_quant_bins == 1``) or, with
        ``num_quant_bins`` in (2, 4, 8), over the continuous ``auxiliary``
        series of the quantized model, started from a relaxed SVI fit.  Its
        cost grows as ``num_quant_bins`` to the number of compartments.
        Returns the ``MCMC``; the draws are in ``self.samples``."""
        if num_quant_bins not in (1, 2, 4, 8):
            raise ValueError(f"num_quant_bins must be one of 1, 2, 4, 8; got {num_quant_bins}")
        self.num_quant_bins = num_quant_bins
        self.relaxed = num_quant_bins == 1
        if num_quant_bins > 1:
            init_values = self._heuristic_init(heuristic_num_steps, heuristic_learning_rate)
            if not math.isfinite(self._quantized_log_density(init_values)):
                init_values = self._particle_init(init_values)
            kernel = NUTS(self._quantized_model, max_tree_depth=max_tree_depth, init_values=init_values, **options)
        else:
            kernel = NUTS(self._model, max_tree_depth=max_tree_depth, **options)
        mcmc = MCMC(
            kernel,
            num_samples=num_samples,
            warmup_steps=num_samples if warmup_steps is None else warmup_steps,
            num_chains=num_chains,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        mcmc.run(generator=generator)
        self.samples = mcmc.get_samples()
        self.guide = None
        return mcmc

    def predict(self, num_samples: int = 100, forecast: int = 0, generator=None) -> Dict:
        """Posterior draws of every site: from the guide after ``fit_svi``,
        or from the MCMC draws after ``fit_mcmc`` (at most ``num_samples``
        of them, picked by numpy seed 0).  With ``forecast=N`` the model
        runs N steps past the data, their flows drawn from the transition
        prior given the posterior's parameters."""
        model = self._model if forecast == 0 else (lambda: self._model(forecast))
        if getattr(self, "guide", None) is not None:
            self.samples = Predictive(model, guide=self.guide, num_samples=num_samples)(generator=generator)
        else:
            n = len(next(iter(self.samples.values())))
            idx = np.random.default_rng(0).choice(n, size=min(num_samples, n), replace=False)
            sub = {k: v[torch.as_tensor(idx, device=v.device)] for k, v in self.samples.items()}
            out = Predictive(model, posterior_samples=sub)(generator=generator)
            out.update(sub)
            self.samples = out
        return self.samples
