"""Model -> potential function for MCMC (counterpart of
``pyro_tpu/infer/mcmc/util.py``).

The potential is a function of a dict of unconstrained latents: minus the
log joint of the model conditioned on their constrained values, minus the
log |det J| of each site's ``biject_to(support)``.  It runs the model under
the handlers, so ``torch.func`` can take its gradient and ``vmap`` it over
chains.  A model with discrete latents that have enumerate support has them
summed out: the conditioned model is traced under parallel enumeration and
contracted by ``TraceEnum_ELBO``'s machinery with an empty guide, which
gives log sum_discrete p(continuous, discrete, obs).  Nothing inside the
potential draws, so ``vmap``'s default ``randomness="error"`` holds.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ... import poutine
from ...distributions.transforms import biject_to
from ...poutine.enum_messenger import EnumMessenger
from ...poutine.messenger import Messenger
from ...poutine.util import prune_subsample_sites, site_is_subsample
from ...settings import get_default_device


class ModelInfo(NamedTuple):
    initial_params: Dict[str, torch.Tensor]  # unconstrained
    potential_fn: Callable
    postprocess_fn: Callable  # unconstrained dict -> constrained dict (and deterministic sites)
    prototype_trace: object
    transforms: Dict[str, object]  # site -> biject_to(support)
    draw_initial: Callable = None  # (generator, num_chains) -> (C, D) flat unconstrained starting points


def _latent_sites(trace):
    return {
        name: site
        for name, site in trace.nodes.items()
        if site["type"] == "sample"
        and not site["is_observed"]
        and not site_is_subsample(site)
        and not site["infer"].get("_deterministic")
    }


def _ravel_fns(prototype: Dict[str, torch.Tensor]):
    """``ravel`` (dict -> flat vector) and ``unravel`` (flat -> dict) in the
    order of ``jax.flatten_util.ravel_pytree``: names sorted, each value
    raveled in C order.  Both keep leading batch dims beyond the
    prototype's shapes."""
    names = sorted(prototype)
    shapes = {name: tuple(prototype[name].shape) for name in names}
    sizes = [math.prod(shapes[name]) for name in names]

    def ravel(values):
        parts = []
        for name in names:
            v = values[name]
            parts.append(v.reshape(v.shape[: v.ndim - len(shapes[name])] + (-1,)))
        return torch.cat(parts, dim=-1)

    def unravel(flat):
        out, start = {}, 0
        for name, size in zip(names, sizes):
            out[name] = flat[..., start: start + size].reshape(flat.shape[:-1] + shapes[name])
            start += size
        return out

    return ravel, unravel


def guess_max_plate_nesting(trace) -> int:
    """The deepest plate stack of any sample site of ``trace``."""
    return max((len(site["cond_indep_stack"]) for site in trace.nodes.values() if site["type"] == "sample"),
               default=0)


def get_potential_fn(model, model_args=(), model_kwargs=None, generator=None, max_plate_nesting=None,
                     prototype_trace=None):
    """(potential_fn, postprocess_fn, transforms, prototype_trace,
    unconstrain) for ``model``; the prototype trace draws from the priors
    with ``generator``.  Discrete latents with enumerate support are summed
    out of the potential, their dims allocated left of
    ``max_plate_nesting`` plates (guessed from the prototype trace when not
    given); the draws and the constrained values hold the continuous sites
    only (recover the discrete ones with ``infer_discrete``)."""
    model_kwargs = model_kwargs or {}
    if prototype_trace is None:
        seeded = poutine.seed(model, rng_seed=0 if generator is None else generator)
        prototype_trace = prune_subsample_sites(poutine.trace(seeded).get_trace(*model_args, **model_kwargs))
    all_latents = _latent_sites(prototype_trace)
    if not all_latents:
        raise ValueError("model has no latent sample sites")
    enum_sites, latents = [], {}
    for name, site in all_latents.items():
        if not getattr(site["fn"], "is_discrete", False):
            latents[name] = site
        elif getattr(site["fn"], "has_enumerate_support", False):
            enum_sites.append(name)
        else:
            raise NotImplementedError(
                f"site '{name}' is discrete with no enumerate support; HMC/NUTS requires continuous "
                "or enumerable latents"
            )
    if enum_sites and not latents:
        raise ValueError("all latent sites are discrete; use infer_discrete or discrete inference instead of "
                         "HMC/NUTS")
    if enum_sites and max_plate_nesting is None:
        max_plate_nesting = guess_max_plate_nesting(prototype_trace)
    transforms = {name: biject_to(site["fn"].support) for name, site in latents.items()}

    def unconstrain(constrained: Dict) -> Dict:
        return {name: transforms[name].inv(value) for name, value in constrained.items()}

    def constrain(unconstrained: Dict) -> Dict:
        return {name: transforms[name](value) for name, value in unconstrained.items()}

    def not_deterministic(name, site):
        return not site["infer"].get("_deterministic")

    def log_joint_plain(constrained):
        trace = poutine.trace(poutine.condition(model, data=constrained)).get_trace(*model_args, **model_kwargs)
        return prune_subsample_sites(trace).log_prob_sum(site_filter=not_deterministic)

    def log_joint_enum(constrained):
        """log sum_discrete p(continuous, discrete, obs): the conditioned
        model under parallel enumeration, contracted with an empty guide
        (the DiCE expectation reduces to the marginal log density)."""
        from ..enum import config_enumerate
        from ..traceenum_elbo import _compute_dice_elbo

        enum_model = EnumMessenger(first_available_dim=-1 - int(max_plate_nesting))(
            config_enumerate(poutine.condition(model, data=constrained)))
        model_trace = prune_subsample_sites(poutine.trace(enum_model).get_trace(*model_args, **model_kwargs))
        model_trace.compute_log_prob(
            site_filter=lambda name, site: not site["infer"].get("_do_not_score") and not_deterministic(name, site))
        model_trace.pack_tensors()
        guide_trace = poutine.trace(lambda *a, **k: None).get_trace(*model_args, **model_kwargs)
        guide_trace.pack_tensors(model_trace.plate_to_symbol)
        return _compute_dice_elbo(model_trace, guide_trace)

    log_joint = log_joint_enum if enum_sites else log_joint_plain

    def potential_fn(z: Dict):
        """-log p(constrained(z), obs) - log|det J(z)|."""
        constrained = constrain(z)
        total = log_joint(constrained)
        for name, t in transforms.items():
            total = total + t.log_abs_det_jacobian(z[name], constrained[name]).sum()
        return -total

    det_sites = [
        name
        for name, site in prototype_trace.nodes.items()
        if site["type"] == "sample" and site["infer"].get("_deterministic")
    ]

    def postprocess_fn(z: Dict, return_deterministic: bool = True) -> Dict:
        constrained = constrain(z)
        if return_deterministic and det_sites:
            trace = poutine.trace(poutine.condition(model, data=constrained)).get_trace(*model_args, **model_kwargs)
            for name in det_sites:
                constrained[name] = trace.nodes[name]["value"]
        return constrained

    return potential_fn, postprocess_fn, transforms, prototype_trace, unconstrain


def batched_potential_and_grad(potential_fn: Callable) -> Callable:
    """Map a potential of one flat vector (D,) to one of many: (C, D) ->
    (potential energies (C,), gradients (C, D)), by ``torch.func.vmap`` of
    ``torch.func.grad_and_value`` over the handler stack."""
    grad_and_value = torch.func.vmap(torch.func.grad_and_value(potential_fn))

    def potential_and_grad(z):
        grad, pe = grad_and_value(z)
        return pe, grad

    return potential_and_grad


def _find_valid_initial_params(potential_and_grad: Callable, num_dims: int, generator, num_chains: int = 1,
                               radius: float = 2.0, max_tries: int = 100, draw: Optional[Callable] = None):
    """Starting points, one (D,) vector per chain, drawn again for each
    chain whose potential or gradient is not finite, up to ``max_tries``
    times: ``draw(generator, num_chains)`` (C, D), by default uniform draws
    in [-radius, radius) of the unconstrained space.  Returns the draws
    (C, D) and whether each is valid (C,)."""
    device = generator.device if generator is not None else get_default_device()

    def uniform(generator, num_chains):
        u = torch.rand((num_chains, num_dims), generator=generator, device=device)
        return -radius + 2 * radius * u

    draw = draw or uniform

    def is_valid(flat):
        pe, grad = potential_and_grad(flat)
        return torch.isfinite(pe) & torch.isfinite(grad).all(-1)

    flat = draw(generator, num_chains)
    ok = is_valid(flat)
    for _ in range(max_tries):
        if bool(ok.all()):
            break
        new = draw(generator, num_chains)
        flat = torch.where(ok[:, None], flat, new)
        ok = ok | is_valid(new)
    return flat, ok


class _InitValuesMessenger(Messenger):
    """Set the values of unobserved sample sites without observing them."""

    def __init__(self, data):
        super().__init__()
        self.data = data

    def _pyro_sample(self, msg):
        if msg["name"] in self.data and not msg["is_observed"]:
            msg["value"] = torch.as_tensor(self.data[msg["name"]], dtype=torch.get_default_dtype(),
                                           device=get_default_device())
            msg["done"] = True


def initialize_model(model, model_args=(), model_kwargs=None, init_strategy="uniform",
                     init_params: Optional[Dict] = None, init_values: Optional[Dict] = None, generator=None,
                     max_plate_nesting=None) -> ModelInfo:
    """The potential of ``model`` and a starting point, as
    ``pyro_tpu/infer/mcmc/util.py::initialize_model``: ``init_params``
    (unconstrained site values) if given, else a valid draw of the
    ``init_strategy``: ``"uniform"`` (uniform in [-2, 2) unconstrained),
    ``"sample"`` (a draw from the priors), or a callable of a site (the
    autoguides' ``init_to_*``, applied to each latent site).
    ``init_values`` are constrained site values, injected into the
    prototype trace (the sites stay latent) and taken as the starting value
    of the sites they name; the other sites follow ``init_strategy``.

    ``ModelInfo.draw_initial(generator, num_chains)`` gives one valid
    starting point a chain, (C, D) in the flat order of ``_ravel_fns``,
    by the same rules."""
    model_kwargs = model_kwargs or {}
    if not (init_strategy in ("uniform", "sample") or callable(init_strategy)):
        raise ValueError(f"unknown init_strategy={init_strategy!r}; expected 'uniform', 'sample' or a callable")
    prototype_trace = None
    if init_values:
        seeded = poutine.seed(_InitValuesMessenger(dict(init_values))(model),
                              rng_seed=0 if generator is None else generator)
        prototype_trace = prune_subsample_sites(poutine.trace(seeded).get_trace(*model_args, **model_kwargs))
    potential_fn, postprocess_fn, transforms, prototype_trace, unconstrain = get_potential_fn(
        model, model_args, model_kwargs, generator=generator, max_plate_nesting=max_plate_nesting,
        prototype_trace=prototype_trace,
    )
    latents = {name: prototype_trace.nodes[name] for name in transforms}
    proto = unconstrain({name: site["value"] for name, site in latents.items()})
    ravel, unravel = _ravel_fns(proto)
    num_dims = ravel(proto).shape[-1]
    potential_and_grad = batched_potential_and_grad(lambda flat: potential_fn(unravel(flat)))
    fixed = {}
    if init_values:
        fixed = unconstrain({name: torch.as_tensor(v, dtype=torch.get_default_dtype(), device=get_default_device())
                             for name, v in init_values.items() if name in transforms})

    def strategy_draw(generator, num_chains):
        if callable(init_strategy):
            values = {name: torch.as_tensor(init_strategy(site), dtype=torch.get_default_dtype())
                      for name, site in latents.items()}
            flat = ravel(unconstrain(values))
            return flat.to(get_default_device()).expand(num_chains, num_dims)
        if init_strategy == "sample":
            draws = []
            for _ in range(num_chains):
                trace = poutine.trace(poutine.seed(model, rng_seed=generator)).get_trace(*model_args, **model_kwargs)
                draws.append(ravel(unconstrain({name: trace.nodes[name]["value"] for name in latents})))
            return torch.stack(draws)
        u = torch.rand((num_chains, num_dims), generator=generator, device=get_default_device())
        return -2.0 + 4.0 * u

    def draw(generator, num_chains):
        flat = strategy_draw(generator, num_chains)
        if fixed:
            parts = unravel(flat)
            parts.update({name: v.expand(parts[name].shape) for name, v in fixed.items()})
            flat = ravel(parts)
        return flat

    def draw_initial(generator, num_chains):
        return _find_valid_initial_params(potential_and_grad, num_dims, generator, num_chains, draw=draw)[0]

    if init_params is None:
        init_params = unravel(draw_initial(generator, 1)[0])
    return ModelInfo(init_params, potential_fn, postprocess_fn, prototype_trace, transforms, draw_initial)
