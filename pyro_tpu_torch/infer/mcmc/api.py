"""MCMC over a batch of chains (counterpart of ``pyro_tpu/infer/mcmc/api.py``).

The chains are the leading dim of the kernel's state, stepped together:
warmup, then sampling, one batched transition an iteration, with the
draws collected on the device.  ``chain_method="vectorized"`` (the
default) and ``"parallel"`` run all chains as one batch on the one card;
``"sequential"`` runs one chain at a time, as a batch of one.  All draws
come from one ``torch.Generator``: the sequential chains take their draws
from it one after another, so they are not the vectorized run's chains,
only chains of the same law.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...ops.stats import effective_sample_size, split_gelman_rubin
from ...settings import get_default_device

_EXTRA_FIELDS = ("diverging", "accept_prob", "num_steps", "step_size", "energy")
_LOG = logging.getLogger("pyro_tpu_torch")


def _concat_states(states):
    """Chain-batched states (NamedTuples of tensors, nested) joined along
    the chain dim; ints (the iteration counter) are taken from the first."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(states, dim=0)
    if isinstance(first, tuple):
        return type(first)(*(_concat_states(parts) for parts in zip(*states)))
    return first


class MCMC:
    def __init__(
        self,
        kernel,
        num_samples: int,
        warmup_steps: Optional[int] = None,
        initial_params: Optional[Dict] = None,
        num_chains: int = 1,
        hook_fn: Optional[Callable] = None,
        disable_progbar: bool = True,
        chain_method: str = "vectorized",
        thinning: int = 1,
        save_params=None,
    ):
        """``initial_params`` are unconstrained site values, each of the
        site's shape (shared by all chains) or with a leading chain dim;
        without them each chain starts at a valid draw of the kernel's
        init strategy.  ``hook_fn(kernel, params, stage, i)`` is called once
        an iteration of the batch, ``params`` holding each site's
        constrained value of every chain (chain dim first), ``stage``
        "warmup" or "sample", ``i`` the iteration within the stage; under
        ``chain_method="sequential"`` once an iteration of each chain, with
        that chain's values.  Progress goes to the ``pyro_tpu_torch`` logger
        (``disable_progbar=False``).  ``thinning`` keeps every n-th draw and
        ``save_params`` the named sites."""
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(
                f"unknown chain_method={chain_method!r}; expected 'vectorized', 'sequential' or 'parallel'"
            )
        self.kernel = kernel
        self.num_samples = num_samples
        self.warmup_steps = num_samples if warmup_steps is None else warmup_steps
        self.num_chains = num_chains
        self.chain_method = chain_method
        self.hook_fn = hook_fn
        self.disable_progbar = disable_progbar
        self.thinning = thinning
        self.save_params = tuple(save_params) if save_params else None
        self._initial_params = initial_params
        self._samples = None  # name -> (chains, samples, ...)
        self._diagnostics_extra = None
        self._last_state = None

    # -- the chains ---------------------------------------------------------
    def _init(self, generator, num_chains, chain=None):
        """The state of ``num_chains`` chains at their starting points (of
        chain ``chain`` alone, where ``initial_params`` have a chain dim)."""
        kernel = self.kernel
        if self._initial_params is not None:
            init = kernel._ravel({k: torch.as_tensor(v) for k, v in self._initial_params.items()})
            if chain is not None and init.ndim == 2:
                init = init[chain]
            init = init.expand((num_chains,) + init.shape[-1:]).to(torch.get_default_dtype())
        else:
            init = kernel._draw_init(generator, num_chains)
        return kernel.init_state(generator, init)

    def _report(self, stage, i, state, single):
        """The hook and the progress line of iteration ``i`` of ``stage``."""
        if self.hook_fn is not None:
            if single:
                params = self.kernel.postprocess_fn(self.kernel._unravel(state.z[0]))
            else:
                postprocess, unravel = self.kernel.postprocess_fn, self.kernel._unravel
                params = torch.func.vmap(lambda f: postprocess(unravel(f)))(state.z)
            self.hook_fn(self.kernel, params, stage, i)
        if not self.disable_progbar:
            total = self.warmup_steps if stage == "warmup" else self.num_samples
            if i % max(1, (self.warmup_steps + self.num_samples) // 20) == 0 or i == total - 1:
                _LOG.info("MCMC %s %d/%d", stage, i, total)

    def _states(self, generator, num_chains, chain=None):
        """The chains' states after each sampling iteration, after warmup;
        with ``chain`` that one chain's alone."""
        kernel = self.kernel
        single = chain is not None
        state = self._init(generator, num_chains, chain)
        report = self.hook_fn is not None or not self.disable_progbar
        for i in range(self.warmup_steps):
            state = kernel.sample_step(state, generator)
            if report:
                self._report("warmup", i, state, single)
        for i in range(self.num_samples):
            state = kernel.sample_step(state, generator)
            if report:
                self._report("sample", i, state, single)
            yield state

    def _setup(self, args, kwargs, generator):
        if generator is None:
            generator = torch.Generator(device=get_default_device()).manual_seed(0)
        self.kernel.setup(self.warmup_steps, *args, generator=generator, init_params=self._initial_params, **kwargs)
        return generator

    @staticmethod
    def _fields(state):
        return (state.z, state.diverging, state.accept_prob, state.num_steps, state.adapt.step_size, state.energy)

    def _collect(self, generator, num_chains, chain=None):
        collected = {name: [] for name in ("z",) + _EXTRA_FIELDS}
        state = None
        for j, state in enumerate(self._states(generator, num_chains, chain)):
            if j % self.thinning == 0:
                for values, value in zip(collected.values(), self._fields(state)):
                    values.append(value)
        return state, {name: torch.stack(values, dim=1) for name, values in collected.items()}  # (C, S, ...)

    def run(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        """Warm up and sample every chain; the model's arguments follow."""
        generator = self._setup(args, kwargs, generator)
        C = self.num_chains
        if self.chain_method == "sequential":
            runs = [self._collect(generator, 1, chain=c) for c in range(C)]
            self._last_state = _concat_states([state for state, _ in runs])
            collected = {name: torch.cat([c[name] for _, c in runs], dim=0) for name in runs[0][1]}
        else:
            self._last_state, collected = self._collect(generator, C)

        # constrained sites (and deterministic ones) of every draw at once
        unravel, postprocess = self.kernel._unravel, self.kernel.postprocess_fn
        z = collected.pop("z")
        constrained = torch.func.vmap(lambda f: postprocess(unravel(f)))(z.reshape(-1, z.shape[-1]))
        self._samples = {name: v.reshape((C, -1) + v.shape[1:]) for name, v in constrained.items()
                         if self.save_params is None or name in self.save_params}
        self._diagnostics_extra = collected
        return self

    # -- results ------------------------------------------------------------
    def get_samples(self, num_samples: Optional[int] = None, group_by_chain: bool = False):
        """Site -> draws, (chains, samples, ...) if ``group_by_chain``, else
        with the chains concatenated."""
        if self._samples is None:
            raise RuntimeError("no samples: call .run() first")
        samples = self._samples
        if not group_by_chain:
            samples = {k: v.reshape((-1,) + v.shape[2:]) for k, v in samples.items()}
        if num_samples is not None:
            samples = {k: v[:num_samples] for k, v in samples.items()}
        return samples

    @property
    def last_state(self):
        return self._last_state

    def diagnostics(self) -> Dict:
        """Per site ``n_eff`` and split ``r_hat`` (of the site's shape, or
        (1,) for a scalar site); the number of divergent transitions and the
        mean accept probability."""
        out = {}
        for name, v in self._samples.items():
            flat = v.reshape(v.shape[:2] + (-1,))
            shape = v.shape[2:] or (1,)
            out[name] = {
                "n_eff": effective_sample_size(flat).reshape(shape),
                "r_hat": split_gelman_rubin(flat).reshape(shape),
            }
        out["divergences"] = {"total": int(self._diagnostics_extra["diverging"].sum())}
        out["acceptance rate"] = {"mean": float(self._diagnostics_extra["accept_prob"].mean())}
        return out

    def summary(self, prob: float = 0.9):
        """Print mean, sd, median, the central ``prob`` interval, n_eff and
        r_hat of every element of every site."""
        diag = self.diagnostics()
        print(f"{'':>16} {'mean':>9} {'std':>9} {'median':>9} {f'{prob * 100:.1f}%':>9} {'n_eff':>9} {'r_hat':>7}")
        for name, v in self._samples.items():
            flat = v.detach().cpu().numpy().reshape((-1,) + tuple(v.shape[2:]))
            flat2 = flat.reshape(flat.shape[0], -1)
            n_eff = diag[name]["n_eff"].cpu().numpy().reshape(-1)
            r_hat = diag[name]["r_hat"].cpu().numpy().reshape(-1)
            for i in range(flat2.shape[1]):
                sub = f"{name}[{i}]" if flat2.shape[1] > 1 else name
                col = flat2[:, i]
                lo, hi = np.quantile(col, [(1 - prob) / 2, (1 + prob) / 2])
                print(f"{sub:>16} {col.mean():>9.3f} {col.std():>9.3f} {np.median(col):>9.3f} "
                      f"[{lo:>7.2f}, {hi:>7.2f}] {n_eff[i]:>9.1f} {r_hat[i]:>7.3f}")
        print(f"\nNumber of divergences: {diag['divergences']['total']}")
