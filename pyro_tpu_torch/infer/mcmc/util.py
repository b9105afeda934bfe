"""Model -> potential function for MCMC (counterpart of
``pyro_tpu/infer/mcmc/util.py``).

The potential is a function of a dict of unconstrained latents: minus the
log joint of the model conditioned on their constrained values, minus the
log |det J| of each site's ``biject_to(support)``.  It runs the model under
the handlers, so ``torch.func`` can take its gradient and ``vmap`` it over
chains.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ... import poutine
from ...distributions.transforms import biject_to
from ...poutine.util import prune_subsample_sites, site_is_subsample
from ...settings import get_default_device


class ModelInfo(NamedTuple):
    initial_params: Dict[str, torch.Tensor]  # unconstrained
    potential_fn: Callable
    postprocess_fn: Callable  # unconstrained dict -> constrained dict (and deterministic sites)
    prototype_trace: object
    transforms: Dict[str, object]  # site -> biject_to(support)


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


def get_potential_fn(model, model_args=(), model_kwargs=None, generator=None):
    """(potential_fn, postprocess_fn, transforms, prototype_trace,
    unconstrain) for ``model``; the prototype trace draws from the priors
    with ``generator``."""
    model_kwargs = model_kwargs or {}
    seeded = poutine.seed(model, rng_seed=0 if generator is None else generator)
    prototype_trace = prune_subsample_sites(poutine.trace(seeded).get_trace(*model_args, **model_kwargs))
    latents = _latent_sites(prototype_trace)
    if not latents:
        raise ValueError("model has no latent sample sites")
    for name, site in latents.items():
        if getattr(site["fn"], "is_discrete", False):
            if getattr(site["fn"], "has_enumerate_support", False):
                raise NotImplementedError(
                    f"site '{name}' is discrete: the enumerated potential is not ported yet; "
                    "see ROADMAP.md Queue 1 item 5"
                )
            raise NotImplementedError(
                f"site '{name}' is discrete with no enumerate support; HMC/NUTS requires continuous "
                "or enumerable latents"
            )
    transforms = {name: biject_to(site["fn"].support) for name, site in latents.items()}

    def unconstrain(constrained: Dict) -> Dict:
        return {name: transforms[name].inv(value) for name, value in constrained.items()}

    def constrain(unconstrained: Dict) -> Dict:
        return {name: transforms[name](value) for name, value in unconstrained.items()}

    def potential_fn(z: Dict):
        """-log p(constrained(z), obs) - log|det J(z)|."""
        constrained = constrain(z)
        trace = poutine.trace(poutine.condition(model, data=constrained)).get_trace(*model_args, **model_kwargs)
        trace = prune_subsample_sites(trace)
        log_joint = trace.log_prob_sum(site_filter=lambda name, site: not site["infer"].get("_deterministic"))
        for name, t in transforms.items():
            log_joint = log_joint + t.log_abs_det_jacobian(z[name], constrained[name]).sum()
        return -log_joint

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
                               radius: float = 2.0, max_tries: int = 100):
    """Uniform draws in [-radius, radius) of the unconstrained space, one
    (D,) vector per chain, drawn again for each chain whose potential or
    gradient is not finite, up to ``max_tries`` times.  Returns the draws
    (C, D) and whether each is valid (C,)."""
    device = generator.device if generator is not None else get_default_device()

    def draw():
        u = torch.rand((num_chains, num_dims), generator=generator, device=device)
        return -radius + 2 * radius * u

    def is_valid(flat):
        pe, grad = potential_and_grad(flat)
        return torch.isfinite(pe) & torch.isfinite(grad).all(-1)

    flat = draw()
    ok = is_valid(flat)
    for _ in range(max_tries):
        if bool(ok.all()):
            break
        new = draw()
        flat = torch.where(ok[:, None], flat, new)
        ok = ok | is_valid(new)
    return flat, ok


def initialize_model(model, model_args=(), model_kwargs=None, init_params: Optional[Dict] = None,
                     generator=None) -> ModelInfo:
    """The potential of ``model`` and a starting point: ``init_params``
    (unconstrained site values) if given, else a valid uniform draw in
    [-2, 2) (the only init strategy ported)."""
    potential_fn, postprocess_fn, transforms, prototype_trace, unconstrain = get_potential_fn(
        model, model_args, model_kwargs, generator=generator
    )
    if init_params is None:
        proto = unconstrain({name: prototype_trace.nodes[name]["value"] for name in transforms})
        ravel, unravel = _ravel_fns(proto)
        flat_potential = lambda flat: potential_fn(unravel(flat))  # noqa: E731
        flat, _ = _find_valid_initial_params(
            batched_potential_and_grad(flat_potential), ravel(proto).shape[-1], generator
        )
        init_params = unravel(flat[0])
    return ModelInfo(init_params, potential_fn, postprocess_fn, prototype_trace, transforms)
