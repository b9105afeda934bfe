"""Effect-handler runtime (counterpart of ``pyro_tpu/poutine/runtime.py``).

A global stack of messengers; every primitive statement becomes a message
dict sent down the stack (innermost handler first), given its default
behaviour, then sent back up.  Randomness comes from a ``torch.Generator``
in ``msg["rng_key"]``, supplied by the ``seed`` handler; without one,
sampling uses torch's global generator.
"""

from __future__ import annotations

import functools
from collections import namedtuple
from typing import Any, Callable, Dict, List, Optional

# The global effect-handler stack.  Append on __enter__, pop on __exit__.
_PYRO_STACK: List[Any] = []

# A conditional-independence frame pushed onto msg["cond_indep_stack"] by
# `plate`: dim counts from the right (negative); size is the full plate size.
CondIndepStackFrame = namedtuple("CondIndepStackFrame", ["name", "dim", "size", "subsample_size"])


class _DimAllocator:
    """Plate dims counted from the right; explicit ``dim=`` requests are
    honoured and collisions raise."""

    def __init__(self) -> None:
        self._stack: List[Optional[str]] = []  # index 0 == dim -1

    def allocate(self, name: str, dim: Optional[int]) -> int:
        if name in self._stack:
            raise ValueError(f"duplicate plate '{name}'")
        if dim is not None:
            if dim >= 0:
                raise ValueError(f"plate dim must be negative, got {dim}")
            while len(self._stack) < -dim:
                self._stack.append(None)
            if self._stack[-1 - dim] is not None:
                raise ValueError(
                    f"dim {dim} requested by plate '{name}' already claimed "
                    f"by plate '{self._stack[-1 - dim]}'"
                )
            self._stack[-1 - dim] = name
            return dim
        for i, occupant in enumerate(self._stack):
            if occupant is None:
                self._stack[i] = name
                return -1 - i
        self._stack.append(name)
        return -len(self._stack)

    def free(self, name: str, dim: int) -> None:
        i = -1 - dim
        if i < len(self._stack) and self._stack[i] == name:
            self._stack[i] = None
        while self._stack and self._stack[-1] is None:
            self._stack.pop()


_DIM_ALLOCATOR = _DimAllocator()


class _EnumAllocator:
    """Enumeration dims, allocated to the left of every plate dim.
    ``set_first_available_dim`` is called by enumeration-aware inference
    with ``-1 - max_plate_nesting``."""

    def __init__(self) -> None:
        self.next_available_dim: Optional[int] = None
        self.next_available_id = 0
        self.dim_to_id: Dict[int, int] = {}

    def set_first_available_dim(self, first_available_dim: int) -> None:
        assert first_available_dim < 0
        self.next_available_dim = first_available_dim
        self.next_available_id = 0
        self.dim_to_id.clear()

    def allocate(self, scope_dims=None):
        """A dim and its id.  Without ``scope_dims`` the dim is global: never
        recycled, and recorded in ``dim_to_id``.  With them (a site under
        ``pyro.markov``) it is local: the first dim from the next available
        one leftward that no site in the Markov scope holds, so sites out of
        each other's scope share dims."""
        if self.next_available_dim is None:
            raise ValueError(
                "enumeration requires an enclosing enum handler: use TraceEnum_ELBO "
                "or EnumMessenger(first_available_dim=...)"
            )
        dim = self.next_available_dim
        id_ = self.next_available_id
        self.next_available_id += 1
        if scope_dims is None:
            self.next_available_dim -= 1
            self.dim_to_id[dim] = id_
        else:
            while dim in scope_dims:
                dim -= 1
        return dim, id_


_ENUM_ALLOCATOR = _EnumAllocator()


class NonlocalExit(Exception):
    """Raised by ``EscapeMessenger`` to stop a model at a site; carries the
    site's message."""

    def __init__(self, site: Dict[str, Any], *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.site = site

    def reset_stack(self) -> None:
        """Reset the handlers left on the stack.  Unwinding has already
        popped those between the raise and the catch, so only the outer
        ones remain: each is reset, up to a block that hides the site."""
        for frame in reversed(_PYRO_STACK):
            frame._reset()
            if getattr(frame, "_is_block", False) and frame.hide_fn(self.site):
                break


def new_message(type: str, name: Optional[str], fn: Optional[Callable], args: tuple, kwargs: dict,
                value: Any = None, **extra: Any) -> Dict[str, Any]:
    msg: Dict[str, Any] = {
        "type": type,
        "name": name,
        "fn": fn,
        "args": args,
        "kwargs": kwargs,
        "value": value,
        "is_observed": False,
        "scale": 1.0,
        "mask": None,
        "cond_indep_stack": (),
        "infer": {},
        "done": False,
        "stop": False,
        "continuation": None,
        "rng_key": None,
    }
    msg.update(extra)
    return msg


def default_process_message(msg: Dict[str, Any]) -> None:
    """Default behaviour once every handler has seen the message: draw
    unobserved samples, fetch params."""
    if msg["done"] or msg["is_observed"] or msg["value"] is not None:
        msg["done"] = True
        return
    if msg["type"] == "sample":
        sample_shape = msg["kwargs"].get("sample_shape", ())
        msg["value"] = msg["fn"](*msg["args"], rng_key=msg["rng_key"], sample_shape=sample_shape)
    else:
        msg["value"] = msg["fn"](*msg["args"], **msg["kwargs"])
    msg["done"] = True


def apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    """Send a message down then back up the handler stack; ``stop``
    short-circuits, and postprocessing runs over exactly the handlers that
    processed it."""
    stack = _PYRO_STACK
    pointer = 0
    for frame in reversed(stack):
        pointer += 1
        frame._process_message(msg)
        if msg["stop"]:
            break
    default_process_message(msg)
    for frame in stack[-pointer:]:
        frame._postprocess_message(msg)
    cont = msg["continuation"]
    if cont is not None:
        cont(msg)
    return msg


def am_i_wrapped() -> bool:
    return len(_PYRO_STACK) > 0


def effectful(fn: Optional[Callable] = None, type: Optional[str] = None):
    """Wrap ``fn`` so that, under handlers, a call becomes a message of
    ``type`` sent down the stack (its default behaviour calls ``fn``)."""
    if fn is None:
        return functools.partial(effectful, type=type)
    assert type is not None and type != "message"

    @functools.wraps(fn)
    def _fn(*args, name=None, infer=None, obs=None, **kwargs):
        if not am_i_wrapped():
            return fn(*args, **kwargs)
        msg = new_message(type, name, fn, args, kwargs, value=obs, infer=infer or {})
        msg["is_observed"] = obs is not None
        return apply_stack(msg)["value"]

    return _fn
