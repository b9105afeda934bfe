"""Automatic guides (counterpart of ``pyro_tpu/infer/autoguide/guides.py``:
``AutoGuide``, ``AutoGuideList``, ``AutoCallable``, ``AutoDelta``,
``AutoNormal``, ``AutoContinuous`` with ``AutoDiagonalNormal``,
``AutoMultivariateNormal``, ``AutoLowRankMultivariateNormal``,
``AutoNormalizingFlow`` and ``AutoIAFNormal``).

A guide runs the model once to record a prototype trace, then at each call
creates a ``param`` and a ``sample`` statement per latent site of the model,
inside the same plates (full size: the port's plates do not subsample).
``AutoContinuous`` packs every latent site's unconstrained value into one
flat vector, the sites in sorted order of their names (the JAX package's
``ravel_pytree`` order), draws it at an auxiliary site and hands each model
site a ``Delta`` carrying ``-log|det J|`` of its bijection.
"""

from __future__ import annotations

import functools
from contextlib import ExitStack
from typing import Callable, Dict, Optional

import torch

from ... import poutine
from ...distributions import Delta, LowRankMultivariateNormal, MultivariateNormal, Normal, constraints
from ...distributions.distribution import Distribution, TransformedDistribution
from ...distributions.transforms import IdentityTransform, biject_to
from ...params.param_store import get_param_store
from ...poutine.plate_messenger import PlateMessenger
from ...poutine.util import prune_subsample_sites, site_is_subsample
from ...primitives import module as pyro_module
from ...primitives import param as pyro_param
from ...primitives import sample as pyro_sample
from ...settings import get_default_device
from .initialization import init_to_median


def _is_latent(site) -> bool:
    return (
        site["type"] == "sample"
        and not site["is_observed"]
        and not site_is_subsample(site)
        and not site["infer"].get("_deterministic")
        and not site["infer"].get("is_auxiliary")
    )


def _quantile_tensor(quantiles, like):
    return torch.as_tensor(quantiles, dtype=like.dtype, device=like.device)


class AutoGuide:
    """The base: the prototype trace and the plates a guide re-enters.
    ``create_plates(*args, **kwargs)``, where given, returns the plates (one
    or a list) in place of those recorded from the model."""

    def __init__(self, model, *, create_plates: Optional[Callable] = None):
        self.model = model
        self.create_plates = create_plates
        self.prototype_trace = None
        self._prototype_frames: Dict[str, tuple] = {}
        self._name = type(self).__name__

    def _setup_prototype(self, *args, **kwargs) -> None:
        with poutine.block():
            trace = poutine.trace(poutine.seed(self.model, rng_seed=0)).get_trace(*args, **kwargs)
        self.prototype_trace = prune_subsample_sites(trace)
        self._prototype_frames = {
            name: tuple(f for f in site["cond_indep_stack"] if f.dim is not None)
            for name, site in self.prototype_trace.nodes.items()
            if _is_latent(site)
        }

    def _create_plates(self, *args, **kwargs):
        if self.create_plates is None:
            return {
                f.name: PlateMessenger(f.name, f.size, dim=f.dim)
                for frames in self._prototype_frames.values()
                for f in frames
            }
        created = self.create_plates(*args, **kwargs)
        if isinstance(created, PlateMessenger):
            created = [created]
        return {p.name: p for p in created}

    def _latent_sites(self):
        return [(name, site) for name, site in self.prototype_trace.nodes.items() if _is_latent(site)]

    def _ensure_prototype(self, args, kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

    def __call__(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def median(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def quantiles(self, quantiles, *args, **kwargs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class AutoGuideList(AutoGuide):
    """Partial guides over disjoint sets of sites, run in turn."""

    def __init__(self, model):
        super().__init__(model)
        self._guides = []

    def append(self, part) -> None:
        """Add a guide; a plain callable is wrapped in ``AutoCallable``."""
        if not isinstance(part, AutoGuide):
            part = AutoCallable(self.model, part)
        self._guides.append(part)

    def add(self, part) -> None:
        self.append(part)

    def __call__(self, *args, **kwargs):
        result = {}
        for part in self._guides:
            result.update(part(*args, **kwargs))
        return result

    def median(self, *args, **kwargs):
        result = {}
        for part in self._guides:
            result.update(part.median(*args, **kwargs))
        return result


class AutoCallable(AutoGuide):
    """A plain callable guide with the ``AutoGuide`` interface; ``median``
    is the callable given (by default, no sites)."""

    def __init__(self, model, guide, median=lambda *args, **kwargs: {}):
        super().__init__(model)
        self._guide = guide
        self.median = median

    def __call__(self, *args, **kwargs):
        result = self._guide(*args, **kwargs)
        return {} if result is None else result


class AutoDelta(AutoGuide):
    """MAP estimation: a Delta at a learned point per latent site."""

    def __init__(self, model, init_loc_fn=init_to_median, *, create_plates=None):
        super().__init__(model, create_plates=create_plates)
        self.init_loc_fn = init_loc_fn

    def __call__(self, *args, **kwargs):
        self._ensure_prototype(args, kwargs)
        plates = self._create_plates(*args, **kwargs)
        result = {}
        for name, site in self._latent_sites():
            with ExitStack() as stack:
                for f in self._prototype_frames[name]:
                    stack.enter_context(plates[f.name])
                # the initial value is drawn only when the param is created
                value = pyro_param(
                    f"{self._name}.{name}",
                    functools.partial(self.init_loc_fn, site),
                    constraint=site["fn"].support,
                    event_dim=site["fn"].event_dim,
                )
                result[name] = pyro_sample(name, Delta(value, event_dim=site["fn"].event_dim))
        return result


class AutoNormal(AutoGuide):
    """A mean-field Normal per latent site in the unconstrained space,
    pushed through the bijection of the site's support."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, *, init_loc_fn=init_to_median, init_scale: float = 0.1, create_plates=None):
        super().__init__(model, create_plates=create_plates)
        self.init_loc_fn = init_loc_fn
        self._init_scale = init_scale

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        self._transforms, self._event_dims = {}, {}
        for name, site in self._latent_sites():
            t = biject_to(site["fn"].support)
            self._transforms[name] = t
            batch_ndim = site["value"].ndim - site["fn"].event_dim
            self._event_dims[name] = t.inv(site["value"]).ndim - batch_ndim

    def _init_loc(self, site, t):
        return t.inv(self.init_loc_fn(site)).detach()

    def __call__(self, *args, **kwargs):
        self._ensure_prototype(args, kwargs)
        plates = self._create_plates(*args, **kwargs)
        result = {}
        for name, site in self._latent_sites():
            with ExitStack() as stack:
                for f in self._prototype_frames[name]:
                    stack.enter_context(plates[f.name])
                t, event_dim = self._transforms[name], self._event_dims[name]
                loc = pyro_param(f"{self._name}.locs.{name}", functools.partial(self._init_loc, site, t),
                                 event_dim=event_dim)
                scale = pyro_param(f"{self._name}.scales.{name}",
                                   lambda: torch.full_like(loc.detach(), self._init_scale),
                                   constraint=self.scale_constraint, event_dim=event_dim)
                fn = Normal(loc, scale).to_event(event_dim)
                if not isinstance(t, IdentityTransform):
                    fn = TransformedDistribution(fn, t)
                result[name] = pyro_sample(name, fn)
        return result

    def _get_posterior_params(self, name):
        store = get_param_store()
        return store[f"{self._name}.locs.{name}"], store[f"{self._name}.scales.{name}"]

    def median(self, *args, **kwargs):
        self._ensure_prototype(args, kwargs)
        return {name: self._transforms[name](self._get_posterior_params(name)[0]) for name in self._prototype_frames}

    def quantiles(self, quantiles, *args, **kwargs):
        """Each site's marginal quantiles, stacked on a new leading dim."""
        self._ensure_prototype(args, kwargs)
        out = {}
        for name in self._prototype_frames:
            loc, scale = self._get_posterior_params(name)
            q = _quantile_tensor(quantiles, loc).reshape((-1,) + (1,) * loc.ndim)
            out[name] = self._transforms[name](Normal(loc, scale).icdf(q))
        return out


class AutoContinuous(AutoGuide):
    """All latent sites packed into one unconstrained vector; subclasses
    give ``get_posterior()``, a distribution over it."""

    def __init__(self, model, init_loc_fn=init_to_median):
        super().__init__(model)
        self.init_loc_fn = init_loc_fn

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        self._transforms, self._slices = {}, {}
        inits, offset = [], 0
        for name, site in sorted(self._latent_sites(), key=lambda item: item[0]):
            t = biject_to(site["fn"].support)
            u = t.inv(self.init_loc_fn(site)).detach()
            self._transforms[name] = t
            self._slices[name] = (offset, u.shape)
            offset += u.numel()
            inits.append(u.reshape(-1))
        self._init_latent = torch.cat(inits)
        self.latent_dim = offset

    def _unpack(self, latent):
        """{site: its unconstrained value} from a (..., latent_dim) vector."""
        batch = latent.shape[:-1]
        return {
            name: latent[..., offset:offset + shape.numel()].reshape(batch + shape)
            for name, (offset, shape) in self._slices.items()
        }

    def get_posterior(self, *args, **kwargs) -> Distribution:
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        self._ensure_prototype(args, kwargs)
        posterior = self.get_posterior(*args, **kwargs)
        latent = pyro_sample(f"_{self._name}_latent", posterior, infer={"is_auxiliary": True})
        unconstrained = self._unpack(latent)
        plates = self._create_plates(*args, **kwargs)
        result = {}
        for name, site in self._latent_sites():
            t, u = self._transforms[name], unconstrained[name]
            value = t(u)
            event_dim = site["fn"].event_dim
            # the Delta's density carries the bijection's Jacobian, so the
            # guide's density is the constrained one
            log_density = t.log_abs_det_jacobian(u, value)
            extra = log_density.ndim - (value.ndim - event_dim)
            if extra > 0:
                log_density = log_density.sum(tuple(range(-extra, 0)))
            with ExitStack() as stack:
                for f in self._prototype_frames[name]:
                    if f.name in plates:
                        stack.enter_context(plates[f.name])
                result[name] = pyro_sample(name, Delta(value, log_density=-log_density, event_dim=event_dim))
        return result

    def _loc_scale_params(self):
        raise NotImplementedError

    def _constrain(self, unconstrained):
        return {name: self._transforms[name](u) for name, u in unconstrained.items()}

    def median(self, *args, **kwargs):
        self._ensure_prototype(args, kwargs)
        return self._constrain(self._unpack(self._loc_scale_params()[0]))

    def quantiles(self, quantiles, *args, **kwargs):
        """Each site's quantiles of the posterior's marginals, stacked on a
        new leading dim."""
        self._ensure_prototype(args, kwargs)
        loc, scale = self._loc_scale_params()
        latent_q = Normal(loc, scale).icdf(_quantile_tensor(quantiles, loc)[:, None])  # (Q, latent_dim)
        return self._constrain(self._unpack(latent_q))


class AutoDiagonalNormal(AutoContinuous):
    """A Normal with a diagonal covariance over the packed latent."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, init_loc_fn=init_to_median, init_scale=0.1):
        super().__init__(model, init_loc_fn)
        self._init_scale = init_scale

    def get_posterior(self, *args, **kwargs):
        loc = pyro_param(f"{self._name}.loc", lambda: self._init_latent)
        scale = pyro_param(f"{self._name}.scale", lambda: torch.full_like(self._init_latent, self._init_scale),
                           constraint=self.scale_constraint)
        return Normal(loc, scale).to_event(1)

    def _loc_scale_params(self):
        store = get_param_store()
        return store[f"{self._name}.loc"], store[f"{self._name}.scale"]


class AutoMultivariateNormal(AutoContinuous):
    """An MVN over the packed latent, its Cholesky factor learned with a
    softplus diagonal."""

    scale_tril_constraint = constraints.softplus_lower_cholesky

    def __init__(self, model, init_loc_fn=init_to_median, init_scale=0.1):
        super().__init__(model, init_loc_fn)
        self._init_scale = init_scale

    def get_posterior(self, *args, **kwargs):
        loc = pyro_param(f"{self._name}.loc", lambda: self._init_latent)
        scale_tril = pyro_param(
            f"{self._name}.scale_tril",
            lambda: self._init_scale * torch.eye(self.latent_dim, device=self._init_latent.device),
            constraint=self.scale_tril_constraint,
        )
        return MultivariateNormal(loc, scale_tril=scale_tril)

    def _loc_scale_params(self):
        store = get_param_store()
        L = store[f"{self._name}.scale_tril"]
        return store[f"{self._name}.loc"], (L**2).sum(-1).sqrt()


class AutoLowRankMultivariateNormal(AutoContinuous):
    """An MVN over the packed latent with covariance W W^T + diag(scale^2),
    W of ``rank`` columns (by default the rounded square root of the latent
    dim)."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, init_loc_fn=init_to_median, init_scale=0.1, rank=None):
        super().__init__(model, init_loc_fn)
        self._init_scale = init_scale
        self.rank = rank

    def get_posterior(self, *args, **kwargs):
        rank = self.rank or max(1, round(self.latent_dim**0.5))
        loc = pyro_param(f"{self._name}.loc", lambda: self._init_latent)
        cov_factor = pyro_param(f"{self._name}.cov_factor", lambda: self._init_latent.new_zeros(self.latent_dim, rank))
        scale = pyro_param(f"{self._name}.scale", lambda: torch.full_like(self._init_latent, self._init_scale),
                           constraint=self.scale_constraint)
        return LowRankMultivariateNormal(loc, cov_factor, scale**2)

    def _loc_scale_params(self):
        store = get_param_store()
        W, scale = store[f"{self._name}.cov_factor"], store[f"{self._name}.scale"]
        return store[f"{self._name}.loc"], ((W**2).sum(-1) + scale**2).sqrt()


class AutoNormalizingFlow(AutoContinuous):
    """A standard Normal over the packed latent pushed through the flows
    that ``init_transform_fn(latent_dim)`` returns (one or a list).  Each is
    used through ``with_cache``, so a draw is scored without inverting it."""

    def __init__(self, model, init_transform_fn, init_loc_fn=init_to_median):
        super().__init__(model, init_loc_fn)
        self._init_transform_fn = init_transform_fn

    def get_posterior(self, *args, **kwargs):
        transforms = self._init_transform_fn(self.latent_dim)
        if not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        base = Normal(torch.zeros(self.latent_dim, device=get_default_device()), 1.0).to_event(1)
        return TransformedDistribution(base, [t.with_cache() for t in transforms])

    def _loc_scale_params(self):
        raise NotImplementedError("median/quantiles are undefined for flow posteriors; use Predictive samples")


class AutoIAFNormal(AutoNormalizingFlow):
    """``num_transforms`` affine autoregressive flows (hidden width
    ``3 * latent_dim + 1`` unless ``hidden_dim`` is given), their MADEs
    registered as ``AutoIAFNormal.flow{i}``.  The networks are built at the
    first call and registered again at every call."""

    def __init__(self, model, hidden_dim=None, num_transforms: int = 1, init_loc_fn=init_to_median, **kwargs):
        self._hidden_dim = hidden_dim
        self._num_transforms = num_transforms
        self._flow_kwargs = kwargs
        self._flows = None
        super().__init__(model, self._iafs, init_loc_fn)

    def _iafs(self, latent_dim):
        from ...distributions.flows import affine_autoregressive

        if latent_dim == 1:
            raise ValueError("latent dim = 1: AutoIAFNormal needs >= 2 latent dimensions; use AutoNormal instead")
        names = [f"{self._name}.flow{i}" for i in range(self._num_transforms)]
        if self._flows is None:
            hidden = [3 * latent_dim + 1] if self._hidden_dim is None else [self._hidden_dim]
            self._flows = [affine_autoregressive(name, latent_dim, hidden, **self._flow_kwargs) for name in names]
        else:
            for name, flow in zip(names, self._flows):
                pyro_module(name, flow.arn)
        return self._flows
