"""The reparametriser base (counterpart of ``pyro_tpu/infer/reparam/reparam.py``)."""

from __future__ import annotations

from typing import Dict


class Reparam:
    """Turns one sample site into auxiliary sites and a deterministic
    reconstruction.  ``apply`` takes and returns a dict with the keys
    name, fn, value and is_observed (and takes rng_key)."""

    def apply(self, msg: Dict) -> Dict:
        raise NotImplementedError

    def __call__(self, name, fn, obs):
        new_msg = self.apply({"name": name, "fn": fn, "value": obs, "is_observed": obs is not None})
        return new_msg["fn"], new_msg["value"]
