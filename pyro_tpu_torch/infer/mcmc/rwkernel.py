"""Random-walk Metropolis over a batch of chains (counterpart of
``pyro_tpu/infer/mcmc/rwkernel.py``): the proposal z + s eps, eps ~ N(0, I),
with the scale s of each chain dual-averaged during warmup toward an
accept probability of 0.234.  It keeps HMC's state (momentum fields
unused), so ``MCMC`` runs it as it runs HMC and NUTS.
"""

from __future__ import annotations


import torch

from ...ops.dual_averaging import da_init, da_step
from ...ops.welford import welford_init
from .hmc import HMC, AdaptState, HMCState


class RandomWalkKernel(HMC):
    def __init__(self, model=None, potential_fn=None, init_step_size: float = 0.1, target_accept_prob: float = 0.234,
                 init_strategy="uniform"):
        super().__init__(model=model, potential_fn=potential_fn, step_size=init_step_size, num_steps=1,
                         adapt_step_size=True, adapt_mass_matrix=False, target_accept_prob=target_accept_prob,
                         init_strategy=init_strategy)

    def setup(self, warmup_steps, *args, **kwargs):
        super().setup(warmup_steps, *args, **kwargs)
        self._potential = torch.func.vmap(self.potential_fn)  # (C, D) -> (C,), no gradient
        return self

    def init_state(self, generator, initial_flat) -> HMCState:
        z = initial_flat
        pe = self._potential(z)
        step_size = torch.full_like(pe, self.step_size)
        adapt = AdaptState(step_size, torch.ones_like(z), da_init(torch.log(10.0 * step_size)),
                           welford_init(z.shape[-1], batch_shape=pe.shape, device=z.device))
        zero = torch.zeros_like(pe)
        one = torch.ones(pe.shape, dtype=torch.int64, device=z.device)
        return HMCState(0, z, pe, torch.zeros_like(z), pe, one, zero, zero, torch.zeros_like(pe, dtype=torch.bool),
                        adapt)

    def sample_step(self, state: HMCState, generator) -> HMCState:
        adapt = state.adapt
        step_size = adapt.step_size
        eps = torch.randn(state.z.shape, generator=generator, dtype=state.z.dtype, device=state.z.device)
        z_new = state.z + step_size[:, None] * eps
        pe_new = self._potential(z_new)
        delta = pe_new - state.potential_energy
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        accept = torch.rand(accept_prob.shape, generator=generator, device=accept_prob.device) < accept_prob
        z = torch.where(accept[:, None], z_new, state.z)
        pe = torch.where(accept, pe_new, state.potential_energy)

        da = adapt.da
        if state.i < self._num_warmup:
            da = da_step(da, self.target_accept_prob - accept_prob)
            step_size = torch.exp(da.x_avg if state.i == self._num_warmup - 1 else da.x_t)
        i = state.i + 1
        n = i if state.i < self._num_warmup else max(i - self._num_warmup, 1)
        mean_accept = state.mean_accept_prob + (accept_prob - state.mean_accept_prob) / n
        return HMCState(i, z, pe, state.z_grad, pe, torch.ones_like(state.num_steps), accept_prob, mean_accept,
                        torch.zeros_like(state.diverging), AdaptState(step_size, adapt.inverse_mass_diag, da,
                                                                      adapt.welford))
