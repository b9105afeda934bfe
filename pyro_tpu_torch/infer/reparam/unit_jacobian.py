"""Reparametrisation through a volume-preserving transform (counterpart of
``pyro_tpu/infer/reparam/unit_jacobian.py``)."""

from __future__ import annotations

from ... import primitives as pyro
from ...distributions.delta import Delta
from ...distributions.distribution import TransformedDistribution
from .reparam import Reparam


class UnitJacobianReparam(Reparam):
    """The latent is drawn in the transform's coordinates, at an auxiliary
    site ``{name}_{suffix}`` (marked ``is_auxiliary``, so the handler does
    not reparametrise it again), and the site becomes the inverse
    transform of that draw, observed through a ``Delta``."""

    def __init__(self, transform, suffix: str = "transformed", *, experimental_allow_batch: bool = False):
        self.transform = transform
        self.suffix = suffix

    def apply(self, msg):
        name, fn, is_observed = msg["name"], msg["fn"], msg["is_observed"]
        if is_observed:
            return msg
        t = self.transform
        x_t = pyro.sample(f"{name}_{self.suffix}", TransformedDistribution(fn, [t]), infer={"is_auxiliary": True})
        x = t.inv(x_t)
        return {"fn": Delta(x, event_dim=fn.event_dim), "value": x, "is_observed": True}
