"""Global parameter store (counterpart of
``pyro_tpu/params/param_store.py``).

Stores *unconstrained* leaf tensors (``requires_grad=True``) keyed by name;
the constrained view is ``transform_to(constraint)(unconstrained)``, computed
on access so gradients reach the leaves.  A real-valued ``nn.Parameter``
given as an initial value is stored as is, so a module registered with
``pyro_tpu_torch.module`` shares its parameters with the store.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributions import constraints
from ..distributions.transforms import transform_to
from ..settings import get_default_device


class ParamStoreDict:
    def __init__(self) -> None:
        self._params: Dict[str, torch.Tensor] = {}  # unconstrained
        self._constraints: Dict[str, Any] = {}

    def clear(self) -> None:
        self._params.clear()
        self._constraints.clear()

    def __contains__(self, name):
        return name in self._params

    def get_all_unconstrained(self) -> Dict[str, torch.Tensor]:
        """Every parameter's unconstrained leaf, by name."""
        return dict(self._params)

    def __getitem__(self, name):
        return transform_to(self._constraints[name])(self._params[name])

    def _set(self, name, constrained_value, constraint):
        value = torch.as_tensor(constrained_value, device=get_default_device())
        unconstrained = transform_to(constraint).inv(value)
        if not (isinstance(unconstrained, torch.nn.Parameter) and unconstrained is constrained_value):
            unconstrained = unconstrained.detach().clone().requires_grad_(True)
        self._params[name] = unconstrained
        self._constraints[name] = constraint

    def setdefault(self, name, init_constrained_value, constraint=constraints.real):
        """The constrained value of ``name``, created from the initial value
        (or a callable returning it) if absent."""
        if name not in self._params:
            if callable(init_constrained_value):
                init_constrained_value = init_constrained_value()
            self._set(name, init_constrained_value, constraint)
        return self[name]

    def get_param(self, name: str, init_value=None, constraint=constraints.real, event_dim: Optional[int] = None):
        if init_value is None:
            if name not in self:
                raise KeyError(f"param '{name}' does not exist and no init given")
            return self[name]
        return self.setdefault(name, init_value, constraint)

    def get_unconstrained(self, name) -> torch.Tensor:
        return self._params[name]

    def set_unconstrained(self, name, value, constraint=None) -> None:
        """Store ``value`` as the unconstrained leaf of ``name``."""
        if constraint is None:
            constraint = self._constraints.get(name, constraints.real)
        if not isinstance(value, torch.nn.Parameter):
            value = torch.as_tensor(value, device=get_default_device()).detach().clone().requires_grad_(True)
        self._params[name] = value
        self._constraints[name] = constraint


_MODULE_NAMESPACE_DIVIDER = "$$$"

_PARAM_STORE = ParamStoreDict()


def get_param_store() -> ParamStoreDict:
    return _PARAM_STORE


def clear_param_store() -> None:
    _PARAM_STORE.clear()


def param_store_from_jax(named) -> None:
    """Load the JAX package's param store into this one: ``named`` maps each
    name to its constrained value as a numpy array (the JAX store's names,
    for example ``GenericLGSSM.trans_matrix``).  Each is stored under the
    same name and the constraint this store holds for it, so register the
    model's parameters first (run it once)."""
    store = get_param_store()
    for name, value in named.items():
        if name not in store:
            raise KeyError(f"param '{name}' is not registered here: run the model once before loading")
        store._set(name, torch.from_numpy(np.array(value)), store._constraints[name])


def param_with_module_name(pyro_name: str, param_name: str) -> str:
    return _MODULE_NAMESPACE_DIVIDER.join([pyro_name, param_name])


def module_from_param_with_module_name(param_name: str) -> str:
    return param_name.split(_MODULE_NAMESPACE_DIVIDER)[0]


def user_param_name(param_name: str) -> str:
    if _MODULE_NAMESPACE_DIVIDER in param_name:
        return param_name.split(_MODULE_NAMESPACE_DIVIDER)[1]
    return param_name
