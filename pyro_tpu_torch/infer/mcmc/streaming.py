"""StreamingMCMC: chains whose draws are folded into running statistics
as they come (counterpart of ``pyro_tpu/infer/mcmc/streaming.py``), so the
memory does not grow with ``num_samples``.

It runs the chains of ``MCMC`` (the vectorized method): with the same
generator seed it takes the same draws, and its per-chain Welford mean and
variance of the unconstrained positions are those of ``MCMC``'s samples.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.welford import welford_init, welford_update
from .api import MCMC


class StreamingMCMC:
    def __init__(self, kernel, num_samples: int, warmup_steps: Optional[int] = None, num_chains: int = 1):
        self.kernel = kernel
        self.num_samples = num_samples
        self.warmup_steps = num_samples if warmup_steps is None else warmup_steps
        self.num_chains = num_chains
        self._stats = None

    def run(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        mcmc = MCMC(self.kernel, self.num_samples, warmup_steps=self.warmup_steps, num_chains=self.num_chains)
        generator = mcmc._setup(args, kwargs, generator)
        acc = None
        for state in mcmc._states(generator, self.num_chains):
            if acc is None:
                acc = welford_init(state.z.shape[-1], batch_shape=state.z.shape[:-1], device=state.z.device)
            acc = welford_update(acc, state.z)
        unravel, post = self.kernel._unravel, self.kernel.postprocess_fn
        variance = acc.m2 / torch.clamp(acc.n - 1, min=1)[..., None]
        self._stats = {
            "unconstrained_mean": acc.mean,
            "unconstrained_variance": variance,
            "constrained_mean_point": torch.func.vmap(lambda m: post(unravel(m)))(acc.mean),
        }
        return self

    def get_statistics(self) -> Dict:
        """Per chain: the mean and variance of the unconstrained draws, and
        the constrained sites at the mean."""
        if self._stats is None:
            raise RuntimeError("call .run() first")
        return self._stats
