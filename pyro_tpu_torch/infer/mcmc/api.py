"""MCMC over a batch of chains (counterpart of ``pyro_tpu/infer/mcmc/api.py``).

The chains are the leading dim of the kernel's state, stepped together:
warmup, then sampling, one batched transition an iteration, with the
draws collected on the device.  Only the vectorized chain method is
ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...ops.stats import effective_sample_size, split_gelman_rubin
from ...settings import get_default_device

_EXTRA_FIELDS = ("diverging", "accept_prob", "num_steps", "step_size", "energy")


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
    ):
        """``initial_params`` are unconstrained site values, each of the
        site's shape (shared by all chains) or with a leading chain dim;
        without them each chain starts at a valid uniform draw in [-2, 2)."""
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(
                f"unknown chain_method={chain_method!r}; expected 'vectorized', 'sequential' or 'parallel'"
            )
        if chain_method != "vectorized":
            raise NotImplementedError(f"chain_method={chain_method!r} is not ported yet; see ROADMAP.md Queue 1 item 5")
        if hook_fn is not None or not disable_progbar:
            raise NotImplementedError("hook_fn and progress output are not ported yet; see ROADMAP.md Queue 1 item 5")
        self.kernel = kernel
        self.num_samples = num_samples
        self.warmup_steps = num_samples if warmup_steps is None else warmup_steps
        self.num_chains = num_chains
        self._initial_params = initial_params
        self._samples = None  # name -> (chains, samples, ...)
        self._diagnostics_extra = None
        self._last_state = None

    def run(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        """Warm up and sample every chain; the model's arguments follow."""
        if generator is None:
            generator = torch.Generator(device=get_default_device()).manual_seed(0)
        kernel = self.kernel
        kernel.setup(self.warmup_steps, *args, generator=generator, init_params=self._initial_params, **kwargs)
        C = self.num_chains
        if self._initial_params is not None:
            init = kernel._ravel(self._initial_params)
            init = init.expand((C,) + init.shape[-1:]).to(torch.get_default_dtype())
        else:
            init = kernel._draw_init(generator, C)
        state = kernel.init_state(generator, init)
        for _ in range(self.warmup_steps):
            state = kernel.sample_step(state, generator)

        collected = {name: [] for name in ("z",) + _EXTRA_FIELDS}
        for _ in range(self.num_samples):
            state = kernel.sample_step(state, generator)
            fields = (state.z, state.diverging, state.accept_prob, state.num_steps, state.adapt.step_size,
                      state.energy)
            for values, value in zip(collected.values(), fields):
                values.append(value)
        self._last_state = state
        collected = {name: torch.stack(values, dim=1) for name, values in collected.items()}  # (C, S, ...)

        # constrained sites (and deterministic ones) of every draw at once
        unravel, postprocess = kernel._unravel, kernel.postprocess_fn
        z = collected.pop("z")
        constrained = torch.func.vmap(lambda f: postprocess(unravel(f)))(z.reshape(-1, z.shape[-1]))
        self._samples = {name: v.reshape((C, -1) + v.shape[1:]) for name, v in constrained.items()}
        self._diagnostics_extra = collected
        return self

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
