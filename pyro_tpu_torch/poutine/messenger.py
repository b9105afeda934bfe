"""Messenger base class (counterpart of ``pyro_tpu/poutine/messenger.py``).

A context manager that installs itself on the global handler stack and
dispatches messages to ``_pyro_<type>`` / ``_pyro_post_<type>`` hooks.  Used
as a decorator, it wraps a callable so the handler is entered per call.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

from .runtime import _PYRO_STACK


class Messenger:
    def __call__(self, fn: Callable) -> Callable:
        if not callable(fn):
            raise ValueError(f"{fn} is not callable")

        @functools.wraps(fn)
        def _context_wrap(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        _context_wrap.msngr = self  # type: ignore[attr-defined]
        return _context_wrap

    def __enter__(self) -> "Messenger":
        if self in _PYRO_STACK:
            raise ValueError("cannot re-enter an active Messenger")
        _PYRO_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        # on clean exit we must be on top; on an exception, unwind
        # everything above us too
        if exc_type is None:
            if _PYRO_STACK[-1] is not self:
                raise ValueError("inconsistent handler stack on exit")
            _PYRO_STACK.pop()
        elif self in _PYRO_STACK:
            del _PYRO_STACK[_PYRO_STACK.index(self):]

    def _reset(self) -> None:
        """Drop any state kept for the run that a ``NonlocalExit`` stopped."""

    def _process_message(self, msg: Dict[str, Any]) -> None:
        method = getattr(self, "_pyro_{}".format(msg["type"]), None)
        if method is not None:
            method(msg)

    def _postprocess_message(self, msg: Dict[str, Any]) -> None:
        method = getattr(self, "_pyro_post_{}".format(msg["type"]), None)
        if method is not None:
            method(msg)
