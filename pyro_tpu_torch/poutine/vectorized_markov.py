"""Vectorized Markov chains: time as a tensor axis under enumeration
(counterpart of ``pyro_tpu/poutine/vectorized_markov.py``).

The ``for`` loop yields ``history`` ints (``0 .. history-1``) to start the
chain, then ``history + 1`` index tensors ``arange(i, size - history + i)``
inside a time plate, one pass per chain slot.  Each index tensor is a
:class:`_MarkovIndex`: it indexes like a plain tensor on the package's
device, and its ``str``/``format`` is the token ``str(slice(i, ...))``, so
a site named ``f"x_{t}"`` is ``x_slice(0, 127, None)`` whatever T is.  All
passes but the last are auxiliary (never scored); after the loop, a site
whose last-pass log-density depends on an auxiliary site's enumeration dim
is a Markov variable, and a ``markov_chain`` record of the chain enters the
trace, for ``TraceEnum_ELBO`` to eliminate.
"""

from __future__ import annotations

import torch

from ..distributions.util import broadcast_shape
from ..settings import get_default_device
from .messenger import Messenger
from .plate_messenger import PlateMessenger, _Subsample
from .runtime import effectful


class _MarkovIndex(torch.Tensor):
    """An int64 index tensor whose ``str``/``format`` is a slice token.
    Operations on it return plain tensors, which print as usual."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def make(sl: slice, device) -> "_MarkovIndex":
        index = torch.arange(sl.start, sl.stop, device=device).as_subclass(_MarkovIndex)
        index._token = str(sl)
        return index

    def __str__(self):
        return self._token

    __repr__ = __str__

    def __format__(self, spec):
        return format(self._token, spec)


@effectful(type="markov_chain")
def _markov_chain(chain=frozenset()):
    """Record a Markov chain's structure in the trace (the value is the chain)."""
    return chain


class VectorizedMarkovMessenger(Messenger):
    def __init__(self, name=None, size=None, dim=None, history=1):
        if name is None or size is None:
            raise ValueError("vectorized_markov requires name= and size=")
        if size <= 0:
            raise ValueError(f"vectorized_markov size must be positive, got {size}")
        self.name = name
        self.size = size
        self.dim = dim
        self.history = history
        super().__init__()

    def __iter__(self):
        self._aux_msgs = {}  # aux site name -> its message (its infer dict may be replaced by outer handlers)
        self._aux_var = {}  # aux site name -> markov var prefix
        self._markov_vars = set()
        self._suffixes = list(range(min(self.history, self.size)))
        self._suffix = None
        for i in self._suffixes:
            self._suffix = i
            yield i
        n_vec = self.size - self.history
        if n_vec <= 0:  # the int yields cover the whole chain
            return
        time_slices = [slice(i, n_vec + i) for i in range(self.history + 1)]
        self._suffixes.extend(time_slices)
        device = get_default_device()
        with self:
            with PlateMessenger(name=self.name, size=n_vec, dim=self.dim):
                for sl in time_slices:
                    self._suffix = sl
                    self._suffix_str = str(sl)
                    yield _MarkovIndex.make(sl, device)
        chain = frozenset(
            tuple(f"{var}{suffix}" for suffix in self._suffixes) for var in sorted(self._markov_vars)
        )
        _markov_chain(
            chain,
            name=f"_markov_chain_{self.name}",
            infer={"history": self.history, "size": self.size, "plate_name": self.name},
        )

    def _pyro_sample(self, msg):
        if isinstance(msg["fn"], _Subsample):
            return
        if not msg["name"].endswith(self._suffix_str):
            raise ValueError(
                "sites inside vectorized_markov must embed the yielded index in their name "
                f"(e.g. f'x_{{t}}'); got {msg['name']!r}"
            )
        if self._suffix != self._suffixes[-1]:
            # an auxiliary pass: traced, so that the last pass can depend on
            # its enumerated value, but never scored
            msg["infer"]["_do_not_score"] = True
            self._aux_var[msg["name"]] = msg["name"][: -len(self._suffix_str)]
            self._aux_msgs[msg["name"]] = msg

    def _pyro_post_sample(self, msg):
        if isinstance(msg["fn"], _Subsample) or self._suffix != self._suffixes[-1]:
            return
        # last pass: a site is a Markov variable iff its log-density depends
        # on some auxiliary site's enumeration dim
        fn = msg["fn"]
        val_shape = tuple(msg["value"].shape)
        if fn.event_dim:
            val_shape = val_shape[: len(val_shape) - fn.event_dim]
        lp_shape = broadcast_shape(fn.batch_shape, val_shape)
        for aux_name, aux_msg in self._aux_msgs.items():
            d = aux_msg["infer"].get("_enumerate_dim")
            if d is not None and len(lp_shape) >= -d and lp_shape[d] > 1:
                self._markov_vars.add(self._aux_var[aux_name])


def vectorized_markov(name=None, size=None, dim=None, history=1):
    """A Markov chain over a tensorized time dim; see
    ``VectorizedMarkovMessenger``."""
    return VectorizedMarkovMessenger(name=name, size=size, dim=dim, history=history)
