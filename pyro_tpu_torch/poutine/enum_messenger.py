"""Parallel and sampled enumeration of discrete sites, and ``pyro.markov``
(counterpart of ``pyro_tpu/poutine/enum_messenger.py``).

An enumerated site's value is its whole support, laid along a dim to the
left of every plate dim; the dim allocation depends only on the order of
the sites, never on values.  Under ``pyro.markov`` a site's dim is local:
sites that are out of each other's Markov scope reuse dims, so an unrolled
chain of T steps needs history + 1 dims, not T.
"""

from __future__ import annotations

from collections import Counter
from contextlib import ExitStack
from typing import Dict, Iterable, List, Optional, Set

import torch

from ..distributions.distribution import Distribution
from .messenger import Messenger
from .plate_messenger import _Subsample
from .runtime import _ENUM_ALLOCATOR


def _tmc_sample(msg):
    """``num_samples`` draws of the site in a new leftmost dim, each batch
    dim that is not a plate thinned to one ancestor a draw: a fat draw over
    an upstream site's draws would make every draw depend on every upstream
    combination.  The ``"diagonal"`` strategy (the default) pairs draw k
    with ancestor k; ``"mixture"`` picks each draw's ancestor uniformly.
    Draws come from the site's generator (``msg["rng_key"]``)."""
    fn = msg["fn"]
    num_samples = msg["infer"]["num_samples"]
    strategy = msg["infer"].get("tmc", "diagonal")
    if strategy not in ("diagonal", "mixture"):
        raise ValueError(f"{strategy} not a valid TMC strategy")
    generator = msg["rng_key"]
    # plate dims keep their extent; every other batch dim is thinned to 1
    batch_shape = [1] * len(fn.batch_shape)
    for f in msg["cond_indep_stack"]:
        if f.dim is not None:
            batch_shape[f.dim] = f.subsample_size
    fat = fn.sample(generator, (num_samples,))
    target_shape = (num_samples,) + tuple(batch_shape) + tuple(fn.event_shape)
    thin = fat
    for i in range(len(fn.batch_shape)):
        axis = 1 + i  # after the leading draws' dim
        size = thin.shape[axis]
        if size <= 1 or batch_shape[i] != 1:
            continue
        if strategy == "diagonal":
            ancestor = torch.arange(num_samples, device=thin.device) % size
        else:
            ancestor = torch.randint(size, (num_samples,), generator=generator,
                                     device=thin.device if generator is None else generator.device)
        index = ancestor.reshape((num_samples,) + (1,) * (thin.ndim - 1))
        thin = torch.take_along_dim(thin, index.expand(thin.shape[:axis] + (1,) + thin.shape[axis + 1:]), dim=axis)
    assert thin.shape == target_shape, (tuple(thin.shape), target_shape)
    return thin


def enumerate_site(msg):
    """The site's support with its cardinality in a fresh leftmost dim, or,
    with ``infer["num_samples"]``, that many draws there (``_tmc_sample``)."""
    dist = msg["fn"]
    num_samples = msg["infer"].get("num_samples")
    if num_samples is None:
        value = dist.enumerate_support(expand=msg["infer"].get("expand", False))
    elif num_samples > 1:
        value = _tmc_sample(msg)
    else:
        raise ValueError(f"invalid num_samples: {num_samples}")
    assert value.ndim == 1 + len(dist.batch_shape) + len(dist.event_shape)
    return value


class EnumMessenger(Messenger):
    """Enumerate every sample site marked ``infer={"enumerate": "parallel"}``
    in parallel.  With ``first_available_dim`` it (re)starts the dim
    allocation there; without, it continues an allocation begun outside."""

    def __init__(self, first_available_dim: Optional[int] = None):
        assert first_available_dim is None or first_available_dim < 0
        self.first_available_dim = first_available_dim
        super().__init__()

    def __enter__(self):
        if self.first_available_dim is not None:
            _ENUM_ALLOCATOR.set_first_available_dim(self.first_available_dim)
        self._markov_depths: Dict[str, int] = {}
        self._param_dims: Dict[str, Dict[int, int]] = {}
        self._value_dims: Dict[str, Dict[int, int]] = {}
        return super().__enter__()

    def _pyro_sample(self, msg) -> None:
        if msg["done"] or not isinstance(msg["fn"], Distribution):
            return
        # the dims of the upstream sites in this site's Markov scope are
        # taken: its own dim may not be one of them
        scope = msg["infer"].get("_markov_scope")
        param_dims = dict(_ENUM_ALLOCATOR.dim_to_id)
        if scope is not None:
            for name, depth in scope.items():
                if self._markov_depths.get(name) == depth:
                    param_dims.update(self._value_dims.get(name, {}))
            self._markov_depths[msg["name"]] = msg["infer"]["_markov_depth"]
        self._param_dims[msg["name"]] = param_dims
        # a "sequential" site is left to the queue of TraceEnum_ELBO
        if msg["is_observed"] or msg["infer"].get("enumerate") != "parallel":
            return

        value = enumerate_site(msg)
        actual_dim = -1 - len(msg["fn"].batch_shape)
        target_dim, id_ = _ENUM_ALLOCATOR.allocate(None if scope is None else set(param_dims))
        event_dim = msg["fn"].event_dim
        if actual_dim < target_dim:
            # move the enumeration axis rightward to target_dim
            assert value.shape[target_dim - event_dim] == 1, f"pyro.markov dim conflict at dim {actual_dim}"
            value = value.transpose(target_dim - event_dim, actual_dim - event_dim)
            while value.ndim and value.shape[0] == 1:
                value = value[0]
        elif target_dim < actual_dim:
            diff = actual_dim - target_dim
            value = value.reshape(value.shape[:1] + (1,) * diff + value.shape[1:])

        value_dims = {
            dim: param_dims[dim]
            for dim in range(event_dim - value.ndim, 0)
            if value.shape[dim - event_dim] > 1 and dim in param_dims
        }
        value_dims[target_dim] = id_
        msg["infer"]["_enumerate_dim"] = target_dim
        msg["infer"]["_dim_to_id"] = value_dims
        msg["value"] = value
        msg["done"] = True

    def _pyro_post_sample(self, msg) -> None:
        # every site records the enumeration dims allocated before it, so
        # that its log-prob can be packed with their symbols; and the dims
        # its value spans, which a later site in its Markov scope may not take
        if not isinstance(msg["fn"], Distribution) or msg["value"] is None:
            return
        shape = tuple(getattr(msg["value"], "shape", ()))
        shape = shape[: len(shape) - msg["fn"].event_dim]
        dim_to_id = msg["infer"].setdefault("_dim_to_id", {})
        dim_to_id.update(self._param_dims.get(msg["name"], {}))
        self._value_dims[msg["name"]] = {
            dim: id_ for dim, id_ in dim_to_id.items() if len(shape) >= -dim and shape[dim] > 1
        }


class MarkovMessenger(Messenger):
    """Declares that the sites inside depend only on the last ``history``
    steps, so enumeration may recycle the dims of older ones.  Used as a
    context it marks one step; over an iterable (``pyro.markov(range(T))``)
    it enters one nested step per item.  Reentrant: entering it again while
    it is active opens another step without pushing it twice."""

    def __init__(self, history: int = 1, keep: bool = False):
        assert history >= 0
        self.history = history
        self.keep = keep
        self._iterable: Optional[Iterable] = None
        self._pos = -1
        self._stack: List[Set[str]] = []
        self._ref_count = 0
        super().__init__()

    def generator(self, iterable):
        self._iterable = iterable
        return self

    def __iter__(self):
        with ExitStack() as stack:
            assert self._iterable is not None
            for value in self._iterable:
                stack.enter_context(self)
                yield value

    def __enter__(self):
        self._pos += 1
        if len(self._stack) <= self._pos:
            self._stack.append(set())
        self._ref_count += 1
        if self._ref_count == 1:
            super().__enter__()
        return self

    def __exit__(self, *args, **kwargs):
        if not self.keep:
            self._stack.pop()
        self._pos -= 1
        self._ref_count -= 1
        if self._ref_count == 0:
            super().__exit__(*args, **kwargs)

    def _pyro_sample(self, msg) -> None:
        if msg["done"] or isinstance(msg["fn"], _Subsample):
            return
        infer = msg["infer"]
        scope = infer.setdefault("_markov_scope", Counter())
        for pos in range(max(0, self._pos - self.history), self._pos + 1):
            scope.update(self._stack[pos])
        infer["_markov_depth"] = 1 + infer.get("_markov_depth", 0)
        self._stack[self._pos].add(msg["name"])


def markov(fn=None, history: int = 1, keep: bool = False):
    """``pyro.markov``: a Markov context (``with pyro.markov():``), an
    iterator over steps (``for t in pyro.markov(range(T)):``) or a decorator."""
    if fn is None:
        return MarkovMessenger(history=history, keep=keep)
    if callable(fn) and not hasattr(fn, "__iter__"):
        return MarkovMessenger(history=history, keep=keep)(fn)
    return MarkovMessenger(history=history, keep=keep).generator(fn)
