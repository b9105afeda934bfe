"""MCMC kernel protocol (counterpart of ``pyro_tpu/infer/mcmc/mcmc_kernel.py``).

A kernel has ``setup`` (trace the model, build the potential),
``init_state`` (the state of every chain) and ``sample_step`` (one
transition of every chain).  Chains are a leading dim of every tensor of
the state, and randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations


class MCMCKernel:
    def setup(self, warmup_steps, *args, **kwargs):
        return self

    def init_state(self, generator, initial_flat):
        raise NotImplementedError

    def sample_step(self, state, generator):
        raise NotImplementedError
