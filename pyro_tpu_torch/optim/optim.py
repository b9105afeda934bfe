"""Optimisers over parameters that appear as the model runs (counterpart
of ``pyro_tpu/optim/optim.py``).

State is kept per parameter name, created the first time a name is seen,
with hyperparameters from a dict or a callable ``optim_args(module_name,
param_name)`` and optional ``clip_args`` of the same form.  Parameters are
updated in place.

Each optimiser computes optax's formula, as the JAX package does, not
``torch.optim``'s: an optimiser is a chain of transforms, each of which
maps the update on its way (the gradient first) and keeps its own state.
State tensors live on the parameter's device; step counts are Python ints,
so a step reads nothing back from the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..params.param_store import module_from_param_with_module_name, user_param_name
from ..settings import get_default_device


class _Transform:
    """One link of a chain: ``init(param)`` makes its state (a dict of
    tensors and ints), ``update(g, state, param)`` returns the new update
    and writes the new state into ``state``."""

    def init(self, param: torch.Tensor) -> dict:
        return {}

    def update(self, g: torch.Tensor, state: dict, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _moment(g, t, decay, order):
    """optax's moving average of the ``order``-th moment, in place in ``t``."""
    return t.mul_(decay).add_(g if order == 1 else g * g, alpha=1 - decay)


class _Clip(_Transform):
    """optax.clip: each entry clamped to [-max_delta, max_delta]."""

    def __init__(self, max_delta):
        self.max_delta = max_delta

    def update(self, g, state, param):
        return g.clamp(-self.max_delta, self.max_delta)


class _ClipByNorm(_Transform):
    """optax.clip_by_global_norm over the one parameter: g scaled to norm
    ``max_norm`` where its norm is larger (decided on the device)."""

    def __init__(self, max_norm):
        self.max_norm = max_norm

    def update(self, g, state, param):
        norm = torch.linalg.vector_norm(g)
        return torch.where(norm < self.max_norm, g, g / norm * self.max_norm)


class _AddDecayedWeights(_Transform):
    def __init__(self, weight_decay):
        self.weight_decay = weight_decay

    def update(self, g, state, param):
        return g + self.weight_decay * param


class _ScaleByLearningRate(_Transform):
    """-lr times the update; a callable lr is a schedule of the count of
    updates made before this one (the first update uses ``lr(0)``)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, param):
        return {"count": 0} if callable(self.lr) else {}

    def update(self, g, state, param):
        if not callable(self.lr):
            return -self.lr * g
        lr = self.lr(state["count"])
        state["count"] += 1
        return -lr * g


class _ScaleByAdam(_Transform):
    """optax.scale_by_adam (``nesterov``: NAdam's first moment)."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, nesterov=False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def init(self, param):
        return {"count": 0, "mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def _mu_hat(self, g, state):
        b1, count = self.b1, state["count"]
        if self.nesterov:
            return b1 * state["mu"] / (1 - b1 ** (count + 1)) + (1 - b1) * g / (1 - b1**count)
        return state["mu"] / (1 - b1**count)

    def update(self, g, state, param):
        _moment(g, state["mu"], self.b1, 1)
        _moment(g, state["nu"], self.b2, 2)
        state["count"] += 1
        nu_hat = state["nu"] / (1 - self.b2 ** state["count"])
        return self._mu_hat(g, state) / (nu_hat.sqrt() + self.eps)


class _ScaleByRAdam(_ScaleByAdam):
    """optax.scale_by_radam: Adam's step where the variance's length ``ro``
    reaches ``threshold``, rescaled by r; the bias-corrected first moment
    before."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
        super().__init__(b1, b2, eps)
        self.threshold = threshold

    def update(self, g, state, param):
        _moment(g, state["mu"], self.b1, 1)
        _moment(g, state["nu"], self.b2, 2)
        state["count"] += 1
        # ro and r in float32, in optax's order: ro is a difference of two
        # numbers near 2 / (1 - b2), so its rounding shows in r
        f32 = np.float32
        b2t = f32(self.b2) ** f32(state["count"])
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = f32(ro_inf) - f32(2 * state["count"]) * b2t / (f32(1.0) - b2t)
        mu_hat = self._mu_hat(g, state)
        if ro < self.threshold:
            return mu_hat
        r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf) / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        nu_hat = state["nu"] / (1 - self.b2 ** state["count"])
        return float(r) * mu_hat / (nu_hat.sqrt() + self.eps)


class _ScaleByAdamax(_Transform):
    """optax.scale_by_adamax: the first moment over a decayed max of |g| + eps."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, param):
        return {"count": 0, "mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def update(self, g, state, param):
        state["count"] += 1
        _moment(g, state["mu"], self.b1, 1)
        state["nu"] = torch.maximum(g.abs() + self.eps, self.b2 * state["nu"])
        return state["mu"] / (1 - self.b1 ** state["count"]) / state["nu"]


class _ScaleByRms(_Transform):
    """optax.scale_by_rms (eps inside the square root); ``centered``:
    optax.scale_by_stddev."""

    def __init__(self, decay=0.9, eps=1e-8, centered=False):
        self.decay, self.eps, self.centered = decay, eps, centered

    def init(self, param):
        state = {"nu": torch.zeros_like(param)}
        if self.centered:
            state["mu"] = torch.zeros_like(param)
        return state

    def update(self, g, state, param):
        nu = _moment(g, state["nu"], self.decay, 2)
        if self.centered:
            mu = _moment(g, state["mu"], self.decay, 1)
            nu = nu - mu * mu
        return torch.rsqrt(nu + self.eps) * g


class _ScaleByRss(_Transform):
    """optax.scale_by_rss: g over the root of the running sum of squares
    (started at ``initial``); entries whose sum is 0 give 0."""

    def __init__(self, initial=0.1, eps=1e-7):
        self.initial, self.eps = initial, eps

    def init(self, param):
        return {"sum_of_squares": torch.full_like(param, self.initial)}

    def update(self, g, state, param):
        s = state["sum_of_squares"].addcmul_(g, g)
        return torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s)) * g


class _ScaleByAdadelta(_Transform):
    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def init(self, param):
        return {"e_g": torch.zeros_like(param), "e_x": torch.zeros_like(param)}

    def update(self, g, state, param):
        e_g = _moment(g, state["e_g"], self.rho, 2)
        u = torch.sqrt(state["e_x"] + self.eps) / torch.sqrt(e_g + self.eps) * g
        _moment(u, state["e_x"], self.rho, 2)
        return u


class _Trace(_Transform):
    """optax.trace: momentum (``nesterov``: g plus decay times the new trace)."""

    def __init__(self, decay, nesterov=False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, param):
        return {"trace": torch.zeros_like(param)}

    def update(self, g, state, param):
        t = state["trace"].mul_(self.decay).add_(g)
        return g + self.decay * t if self.nesterov else t


class _AdagradRMSProp(_Transform):
    """Ref ``pyro/optim/adagrad_rmsprop.py:9``: step size eta *
    step^(-1/2 + delta) over an RMSProp-style decayed second moment; the
    update carries its own sign."""

    def __init__(self, eta=1.0, delta=1e-16, t=0.1):
        self.eta, self.delta, self.t = eta, delta, t

    def init(self, param):
        return {"step": 0, "sum_sq": torch.zeros_like(param)}

    def update(self, g, state, param):
        state["step"] += 1
        s = state["sum_sq"].mul_(1.0 - self.t).addcmul_(g, g, value=self.t)
        lr = self.eta * state["step"] ** (-0.5 + self.delta)
        return -lr * g / (s.sqrt() + self.delta)


class PyroOptim:
    """Per-parameter optimiser state with per-parameter hyperparameters.

    ``optim_constructor(**optim_args)`` returns the optimiser's chain of
    transforms; ``clip_args`` with ``clip_norm`` and/or ``clip_value`` puts
    a clip by the parameter's norm and/or by value in front of it.  Each
    parameter gets its chain the first time its name is seen.
    """

    def __init__(
        self,
        optim_constructor: Callable[..., List[_Transform]],
        optim_args: Union[Dict, Callable],
        clip_args: Optional[Union[Dict, Callable]] = None,
    ):
        self.pt_optim_constructor = optim_constructor
        if not callable(optim_args):
            static_args = dict(optim_args)
            optim_args = lambda module_name, param_name: static_args  # noqa: E731
        self.pt_optim_args = optim_args
        if clip_args is not None and not callable(clip_args):
            static_clip = dict(clip_args)
            clip_args = lambda module_name, param_name: static_clip  # noqa: E731
        self.pt_clip_args = clip_args
        self._chains: Dict[str, List[_Transform]] = {}
        self._states: Dict[str, List[dict]] = {}

    def _chain(self, name: str) -> List[_Transform]:
        if name not in self._chains:
            module_name, param_name = module_from_param_with_module_name(name), user_param_name(name)
            clip = self.pt_clip_args(module_name, param_name) if self.pt_clip_args is not None else {}
            chain = []
            if "clip_norm" in clip:
                chain.append(_ClipByNorm(clip["clip_norm"]))
            if "clip_value" in clip:
                chain.append(_Clip(clip["clip_value"]))
            self._chains[name] = chain + list(self.pt_optim_constructor(**self.pt_optim_args(module_name, param_name)))
        return self._chains[name]

    @torch.no_grad()
    def __call__(self, params: Dict[str, torch.Tensor]) -> None:
        """Step every parameter that has a gradient, then clear its gradient."""
        for name, p in params.items():
            if p.grad is None:
                continue
            chain = self._chain(name)
            if name not in self._states:
                self._states[name] = [tr.init(p) for tr in chain]
            u = p.grad
            for tr, state in zip(chain, self._states[name]):
                u = tr.update(u, state, p)
            p.add_(u)
            p.grad = None

    # -- persistence (ref ``optim.py:157-240``) ----------------------------------
    def get_state(self) -> dict:
        """Every parameter's state, its tensors copied to the CPU."""
        states = {
            name: [{k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v for k, v in s.items()}
                   for s in chain]
            for name, chain in self._states.items()
        }
        return {"states": states}

    def set_state(self, state: dict) -> None:
        """Take the state of ``get_state``; copies of its tensors go to the
        package's device."""
        device = get_default_device()
        self._states = {
            name: [{k: v.to(device, copy=True) if isinstance(v, torch.Tensor) else v for k, v in s.items()} for s in chain]
            for name, chain in state["states"].items()
        }

    def save(self, filename: str) -> None:
        torch.save(self.get_state(), filename)

    def load(self, filename: str) -> None:
        self.set_state(torch.load(filename, weights_only=True))


def _wrap(constructor, name, doc):
    def factory(optim_args=None, clip_args=None, **kwargs):
        return PyroOptim(constructor, kwargs if optim_args is None else optim_args, clip_args)

    factory.__name__ = factory.__qualname__ = name
    factory.__doc__ = doc
    return factory


def _adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    if weight_decay:
        return _adamw(lr, betas, eps, weight_decay)
    return [_ScaleByAdam(*betas, eps), _ScaleByLearningRate(lr)]


def _adamw(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2):
    return [_ScaleByAdam(*betas, eps), _AddDecayedWeights(weight_decay), _ScaleByLearningRate(lr)]


def _sgd(lr=1e-3, momentum=0.0, nesterov=False, weight_decay=0.0):
    chain = [_AddDecayedWeights(weight_decay)] if weight_decay else []
    if momentum:
        chain.append(_Trace(momentum, nesterov))
    return chain + [_ScaleByLearningRate(lr)]


def _rmsprop(lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0, centered=False):
    chain = [_ScaleByRms(alpha, eps, centered), _ScaleByLearningRate(lr)]
    return chain + [_Trace(momentum)] if momentum else chain


def _adagrad(lr=1e-2, eps=1e-10):
    return [_ScaleByRss(0.1, eps), _ScaleByLearningRate(lr)]


def _clipped_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, clip_norm=10.0, lrd=1.0, weight_decay=0.0):
    chain = [_Clip(clip_norm)]
    if weight_decay:
        chain.append(_AddDecayedWeights(weight_decay))
    sched = (lambda step: lr * lrd**step) if lrd != 1.0 else lr
    return chain + [_ScaleByAdam(*betas, eps), _ScaleByLearningRate(sched)]


def _adadelta(lr=1.0, rho=0.9, eps=1e-6):
    return [_ScaleByAdadelta(rho, eps), _ScaleByLearningRate(lr)]


def _adamax(lr=2e-3, betas=(0.9, 0.999), eps=1e-8):
    return [_ScaleByAdamax(*betas, eps), _ScaleByLearningRate(lr)]


def _nadam(lr=2e-3, betas=(0.9, 0.999), eps=1e-8):
    return [_ScaleByAdam(*betas, eps, nesterov=True), _ScaleByLearningRate(lr)]


def _radam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
    return [_ScaleByRAdam(*betas, eps), _ScaleByLearningRate(lr)]


def _adagrad_rmsprop(eta=1.0, delta=1e-16, t=0.1):
    return [_AdagradRMSProp(eta, delta, t)]


Adam = _wrap(_adam, "Adam", "Adam (``lr``, ``betas``, ``eps``); with ``weight_decay``, AdamW's decoupled decay.")
AdamW = _wrap(_adamw, "AdamW", "AdamW: the decay (default 1e-2) added after Adam's scaling, before the step size.")
SGD = _wrap(_sgd, "SGD", "SGD with optional ``momentum`` (``nesterov``) and ``weight_decay`` added to the gradient.")
RMSprop = _wrap(_rmsprop, "RMSprop", "RMSprop (decay ``alpha``, eps inside the root; ``centered``, ``momentum``).")
Adagrad = _wrap(_adagrad, "Adagrad", "Adagrad: the sum of squares starts at 0.1.")
ClippedAdam = _wrap(
    _clipped_adam,
    "ClippedAdam",
    "Ref ``pyro/optim/clipped_adam.py:9``: each gradient entry clamped to +-``clip_norm``, then "
    "``weight_decay``, then Adam with step size ``lr * lrd**t`` (t updates before this one).",
)
AdagradRMSProp = _wrap(_adagrad_rmsprop, "AdagradRMSProp", "Ref ``pyro/optim/adagrad_rmsprop.py:9``.")
Adadelta = _wrap(_adadelta, "Adadelta", "Adadelta (``rho``, ``eps``) times ``lr``.")
Adamax = _wrap(_adamax, "Adamax", "Adamax: the first moment over a decayed max of |g|.")
NAdam = _wrap(_nadam, "NAdam", "Adam with a Nesterov first moment.")
RAdam = _wrap(_radam, "RAdam", "Rectified Adam: the first moment alone until the variance estimate is long enough.")
