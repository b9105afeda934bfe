"""The reparametrisation handler (counterpart of
``pyro_tpu/poutine/reparam_messenger.py``).

A ``Reparam`` turns one sample site into auxiliary sites and a
deterministic reconstruction: the handler swaps the site's (fn, value)
for the reparam's.  Auxiliary sites (``infer["is_auxiliary"]``) are never
reparametrised themselves.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

from .messenger import Messenger


class ReparamMessenger(Messenger):
    """``config`` maps a site name to a ``Reparam`` (a dict), or a site's
    message to one or None (a callable)."""

    def __init__(self, config: Union[Dict, Callable]):
        self.config = config

    def _pyro_sample(self, msg) -> None:
        if msg["infer"].get("_do_not_trace") or msg["infer"].get("is_auxiliary"):
            return
        reparam = self.config.get(msg["name"]) if isinstance(self.config, dict) else self.config(msg)
        if reparam is None:
            return
        new_msg = reparam.apply({key: msg[key] for key in ("name", "fn", "value", "is_observed", "rng_key")})
        msg["fn"], msg["value"], msg["is_observed"] = new_msg["fn"], new_msg["value"], new_msg["is_observed"]
        if msg["value"] is not None:
            msg["done"] = True


def reparam(fn=None, config=None):
    """A ``ReparamMessenger`` over ``config``, wrapped around ``fn`` when given."""
    msngr = ReparamMessenger(config=config or {})
    return msngr if fn is None else msngr(fn)
