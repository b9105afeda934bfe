"""Core effect handlers (counterpart of ``pyro_tpu/poutine/handlers.py``):
trace, replay, block, seed, mask, scale, condition, uncondition,
infer_config, and the escape that stops a model at a site.

Each handler is dual-use: ``trace(fn)(*args)`` or ``with trace() as t: ...``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..settings import get_default_device
from .messenger import Messenger
from .runtime import NonlocalExit
from .trace_struct import Trace


class TraceMessenger(Messenger):
    """Record sample and param sites, and the ``markov_chain`` records of
    ``vectorized_markov``, into a Trace."""

    def __init__(self, param_only: bool = False):
        super().__init__()
        self.param_only = param_only
        self.trace = Trace()

    def __enter__(self):
        self.trace = Trace()
        return super().__enter__()

    def __call__(self, fn):
        return TraceHandler(self, fn)

    def get_trace(self) -> Trace:
        return self.trace

    def _reset(self):
        self.trace = Trace()

    def _postprocess_message(self, msg):
        if msg["type"] in ("sample", "param", "markov_chain") and (
            not self.param_only or msg["type"] == "param"
        ):
            site = dict(msg)
            site.pop("continuation", None)
            self.trace.add_node(msg["name"], **site)


class TraceHandler:
    """Callable returned by ``trace(fn)``, with ``get_trace``."""

    def __init__(self, msngr: TraceMessenger, fn: Callable):
        self.msngr = msngr
        self.fn = fn
        functools.update_wrapper(self, fn, updated=[])

    def __call__(self, *args, **kwargs):
        with self.msngr:
            return self.fn(*args, **kwargs)

    def get_trace(self, *args, **kwargs) -> Trace:
        self(*args, **kwargs)
        return self.msngr.get_trace()


class ReplayMessenger(Messenger):
    """Force sample values from a previous trace."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def _pyro_sample(self, msg):
        name = msg["name"]
        if name in self.trace and not msg["is_observed"]:
            guide_msg = self.trace.nodes[name]
            if guide_msg["type"] != "sample" or guide_msg["is_observed"]:
                raise RuntimeError(f"site {name} must be sampled in trace")
            msg["done"] = True
            msg["value"] = guide_msg["value"]
            msg["infer"] = guide_msg["infer"]


class ConditionMessenger(Messenger):
    """Fix the value of sample sites as observed."""

    def __init__(self, data: Dict[str, Any]):
        super().__init__()
        self.data = data

    def _pyro_sample(self, msg):
        if self.data.get(msg["name"]) is not None:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True
            msg["done"] = True


class UnconditionMessenger(Messenger):
    """Strip observations, so that the model samples every site; the
    observed value stays in the site's ``infer`` dict under ``"obs"``, with
    ``"was_observed"`` set."""

    def _pyro_sample(self, msg):
        if msg["is_observed"]:
            msg["is_observed"] = False
            msg["infer"] = dict(msg["infer"])
            msg["infer"]["was_observed"] = True
            msg["infer"]["obs"] = msg["value"]
            msg["value"] = None
            msg["done"] = False


class SeedMessenger(Messenger):
    """Supply a ``torch.Generator`` to every unobserved sample site.

    ``rng_seed`` is a generator, or an int that seeds a fresh generator on
    the package's default device.  Sites draw from it in execution order.
    """

    def __init__(self, rng_seed: Union[int, torch.Generator]):
        super().__init__()
        if not isinstance(rng_seed, torch.Generator):
            seed = int(rng_seed)
            rng_seed = torch.Generator(device=get_default_device())
            rng_seed.manual_seed(seed)
        self.generator = rng_seed

    def _pyro_sample(self, msg):
        if msg["rng_key"] is None and not msg["is_observed"]:
            msg["rng_key"] = self.generator


class BlockMessenger(Messenger):
    """Hide sites from handlers above this one: those ``hide_fn`` selects,
    those ``expose_fn`` does not select, or (with neither) all."""

    _is_block = True

    def __init__(self, hide_fn: Optional[Callable] = None, expose_fn: Optional[Callable] = None):
        super().__init__()
        if not (hide_fn is None or expose_fn is None):
            raise ValueError("only specify one of hide_fn or expose_fn")
        if hide_fn is not None:
            self.hide_fn = hide_fn
        elif expose_fn is not None:
            self.hide_fn = lambda msg: not expose_fn(msg)
        else:
            self.hide_fn = lambda msg: True

    def _process_message(self, msg):
        msg["stop"] = bool(self.hide_fn(msg))


class MaskMessenger(Messenger):
    """AND a boolean mask into enclosed sample sites."""

    def __init__(self, mask):
        super().__init__()
        self.mask = mask

    def _process_message(self, msg):
        if msg["type"] == "sample":
            cur = msg["mask"]
            if cur is None:
                msg["mask"] = self.mask
            elif isinstance(cur, bool) and isinstance(self.mask, bool):
                msg["mask"] = cur and self.mask
            else:
                msg["mask"] = torch.as_tensor(cur) & torch.as_tensor(self.mask)


class ScaleMessenger(Messenger):
    """Multiply the log-prob scale of enclosed sites."""

    def __init__(self, scale):
        super().__init__()
        self.scale = scale

    def _process_message(self, msg):
        msg["scale"] = self.scale * msg["scale"]


class InferConfigMessenger(Messenger):
    """Update each sample and param site's ``infer`` dict with what
    ``config_fn(msg)`` returns."""

    def __init__(self, config_fn: Callable):
        super().__init__()
        self.config_fn = config_fn

    def _pyro_sample(self, msg):
        msg["infer"] = {**msg["infer"], **self.config_fn(msg)}

    def _pyro_param(self, msg):
        msg["infer"] = {**msg["infer"], **self.config_fn(msg)}


class EscapeMessenger(Messenger):
    """Stop the model at the first sample site ``escape_fn(msg)`` selects:
    the site is hidden from the handlers above and, once the handlers below
    have seen it, raises ``NonlocalExit`` carrying its message."""

    def __init__(self, escape_fn: Callable):
        super().__init__()
        self.escape_fn = escape_fn

    def _pyro_sample(self, msg):
        if self.escape_fn(msg):
            msg["done"] = True
            msg["stop"] = True

            def cont(m):
                raise NonlocalExit(m)

            msg["continuation"] = cont


def _make_handler(msngr_cls, name):
    def handler(fn=None, *args, **kwargs):
        if fn is not None and not callable(fn):
            args = (fn,) + args
            fn = None
        msngr = msngr_cls(*args, **kwargs)
        return msngr if fn is None else msngr(fn)

    handler.__name__ = name
    return handler


trace = _make_handler(TraceMessenger, "trace")
replay = _make_handler(ReplayMessenger, "replay")
condition = _make_handler(ConditionMessenger, "condition")
uncondition = _make_handler(UnconditionMessenger, "uncondition")
block = _make_handler(BlockMessenger, "block")
mask = _make_handler(MaskMessenger, "mask")
scale = _make_handler(ScaleMessenger, "scale")
seed = _make_handler(SeedMessenger, "seed")
infer_config = _make_handler(InferConfigMessenger, "infer_config")
