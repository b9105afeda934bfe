"""Hamiltonian Monte Carlo over a batch of chains (counterpart of
``pyro_tpu/infer/mcmc/hmc.py``).

Every chain's state is one tensor with a leading chain dim C: positions,
momenta and gradients are (C, D); step sizes, energies and flags are (C,).
The JAX package ``vmap``s one chain's step; here the step is written for
the batch, and a chain that has finished its trajectory keeps its state
through ``torch.where``.  The iteration counter is a Python int shared by
all chains, so the warmup schedule (dual-averaged step size, and a mass
matrix from Welford's statistics over the slow windows: a diagonal, or with
``full_mass`` the dense covariance) is decided on the host.  The inverse
mass is (C, D), or (C, D, D) with ``full_mass``; every use of it (the
momentum draw, the kinetic energy, the leapfrog's M^-1 r, the U-turn check)
takes either.  The potential and its gradient for all chains come from one
``torch.func.vmap(torch.func.grad_and_value(potential))``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ...ops.dual_averaging import DAState, da_init, da_step
from ...ops.welford import WelfordState, welford_covariance, welford_init, welford_update
from .mcmc_kernel import MCMCKernel
from .util import _ravel_fns, batched_potential_and_grad, initialize_model


class AdaptState(NamedTuple):
    step_size: torch.Tensor  # (C,)
    inverse_mass_diag: torch.Tensor  # (C, D), or (C, D, D) with full_mass
    da: DAState
    welford: WelfordState


class HMCState(NamedTuple):
    i: int
    z: torch.Tensor  # (C, D) flat unconstrained positions
    potential_energy: torch.Tensor
    z_grad: torch.Tensor
    energy: torch.Tensor
    num_steps: torch.Tensor
    accept_prob: torch.Tensor
    mean_accept_prob: torch.Tensor
    diverging: torch.Tensor
    adapt: AdaptState


def _velocity(inverse_mass, r):
    """M^-1 r: ``inverse_mass`` is a diagonal (..., D), with r's number of
    dims, or a dense (..., D, D), with one more; it broadcasts against r."""
    if inverse_mass.ndim > r.ndim:
        return (inverse_mass @ r.unsqueeze(-1)).squeeze(-1)
    return inverse_mass * r


def _leapfrog(z, r, z_grad, step_size, inverse_mass, potential_and_grad):
    """One velocity-Verlet step of every chain; ``step_size`` broadcasts
    against (C, D)."""
    r = r - 0.5 * step_size * z_grad
    # the diagonal's product in the JAX package's order, for the same rounding
    z = z + (step_size * _velocity(inverse_mass, r) if inverse_mass.ndim > r.ndim else step_size * inverse_mass * r)
    pe, z_grad = potential_and_grad(z)
    r = r - 0.5 * step_size * z_grad
    return z, r, pe, z_grad


def _kinetic(r, inverse_mass):
    return 0.5 * (_velocity(inverse_mass, r) * r).sum(-1)


def _sample_momentum(generator, inverse_mass):
    """r ~ Normal(0, M) per chain, for an inverse mass (C, D) diagonal or
    (C, D, D) dense: eps / sqrt(M^-1), or L^-T eps with M^-1 = L L^T."""
    dense = inverse_mass.ndim == 3
    shape = inverse_mass.shape[:-1] if dense else inverse_mass.shape
    eps = torch.randn(shape, generator=generator, dtype=inverse_mass.dtype, device=inverse_mass.device)
    if dense:
        L = torch.linalg.cholesky(inverse_mass)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), eps.unsqueeze(-1), upper=True).squeeze(-1)
    return eps * torch.rsqrt(inverse_mass)


def build_adaptation_schedule(num_warmup: int):
    """Stan's three-phase warmup: an initial fast window (step size only),
    doubling slow windows (mass matrix), a terminal fast window.  Returns
    boolean numpy arrays of length ``num_warmup``: (update the mass matrix
    at the end of this iteration, this iteration is in a slow window)."""
    adapt_mass = np.zeros(num_warmup, dtype=bool)
    in_slow = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return adapt_mass, in_slow
    start_buffer, end_buffer, init_window = 75, 50, 25
    if num_warmup < start_buffer + end_buffer + init_window:
        start_buffer = int(0.15 * num_warmup)
        end_buffer = int(0.1 * num_warmup)
        init_window = num_warmup - start_buffer - end_buffer
    pos = start_buffer
    window = init_window
    while pos < num_warmup - end_buffer:
        end = min(pos + window, num_warmup - end_buffer)
        # the last window absorbs the remainder
        if end + 2 * window > num_warmup - end_buffer:
            end = num_warmup - end_buffer
        in_slow[pos:end] = True
        adapt_mass[end - 1] = True
        pos = end
        window *= 2
    return adapt_mass, in_slow


def find_reasonable_step_size(potential_and_grad, z, pe, z_grad, inverse_mass_diag, generator, target=0.8):
    """Per chain, from 1.0, double (or halve) the step size until one
    leapfrog step's accept probability crosses ``target``; at most 100
    times, and only within (1e-10, 1e7)."""

    def accept_prob(step_size):
        r = _sample_momentum(generator, inverse_mass_diag)
        energy0 = pe + _kinetic(r, inverse_mass_diag)
        _, r1, pe1, _ = _leapfrog(z, r, z_grad, step_size[:, None], inverse_mass_diag, potential_and_grad)
        delta = energy0 - (pe1 + _kinetic(r1, inverse_mass_diag))
        return torch.where(torch.isfinite(delta), torch.clamp(torch.exp(delta), max=1.0), 0.0)

    step_size = torch.ones_like(pe)
    direction = torch.where(accept_prob(step_size) > target, 1.0, -1.0)
    running = torch.ones_like(pe, dtype=torch.bool)
    for _ in range(100):
        ap = accept_prob(step_size)
        crossed = torch.where(direction > 0, ap <= target, ap >= target)
        running = running & ~crossed & (step_size > 1e-10) & (step_size < 1e7)
        if not bool(running.any()):
            break
        step_size = torch.where(running, step_size * torch.exp2(direction), step_size)
    return step_size


class HMC(MCMCKernel):
    """HMC with a fixed trajectory length (or number of steps) over a batch
    of chains, on a model or, without one, on ``potential_fn`` (a function
    of a dict of unconstrained values, which then needs ``init_params``).
    ``counts`` holds the leapfrog passes over the batch and the
    device-to-host syncs of the transitions since it was last reset."""

    def __init__(
        self,
        model=None,
        potential_fn=None,
        step_size: float = 1.0,
        trajectory_length: Optional[float] = None,
        num_steps: Optional[int] = None,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        full_mass: bool = False,
        target_accept_prob: float = 0.8,
        max_plate_nesting: Optional[int] = None,
        init_strategy="uniform",
        init_values=None,
    ):
        if model is None and potential_fn is None:
            raise ValueError("HMC requires a model or a potential_fn")
        self.model = model
        self._given_potential_fn = potential_fn
        self.step_size = step_size
        if trajectory_length is None and num_steps is None:
            trajectory_length = 2 * math.pi
        self.trajectory_length = trajectory_length
        self.num_steps = num_steps
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.full_mass = full_mass
        self.target_accept_prob = target_accept_prob
        self.max_plate_nesting = max_plate_nesting
        self.init_strategy = init_strategy
        self.init_values = init_values
        self.counts = {"leapfrogs": 0, "host_syncs": 0}
        # filled by setup()
        self.potential_fn: Optional[Callable] = None  # flat (D,) -> scalar
        self.postprocess_fn: Optional[Callable] = None
        self._potential_and_grad: Optional[Callable] = None  # (C, D) -> ((C,), (C, D))
        self._ravel = self._unravel = None
        self._draw_initial = None
        self._num_dims = 0
        self._num_warmup = 0

    def _any(self, mask) -> bool:
        """``mask.any()`` read on the host: a device-to-host sync, counted."""
        self.counts["host_syncs"] += 1
        return bool(mask.any())

    # -- setup ------------------------------------------------------------
    def setup(self, warmup_steps, *args, generator=None, init_params=None, **kwargs):
        """Trace the model on its arguments (or take ``potential_fn``) and
        build the potential of a flat (D,) vector and of a batch (C, D)."""
        self._num_warmup = warmup_steps
        if self.model is not None:
            info = initialize_model(self.model, args, kwargs, init_strategy=self.init_strategy,
                                    init_params=init_params, init_values=self.init_values, generator=generator,
                                    max_plate_nesting=self.max_plate_nesting)
            dict_potential, self.postprocess_fn = info.potential_fn, info.postprocess_fn
            nodes = info.prototype_trace.nodes
            prototype = {name: t.inv(nodes[name]["value"]) for name, t in info.transforms.items()}
            self._draw_initial = info.draw_initial
        else:
            if init_params is None:
                raise ValueError("potential_fn mode requires init_params")
            dict_potential, self.postprocess_fn = self._given_potential_fn, lambda z, **kw: z
            prototype = init_params
            self._draw_initial = None
        self._ravel, self._unravel = _ravel_fns(prototype)
        self._num_dims = self._ravel(prototype).shape[-1]
        self._initial_flat = None if init_params is None else self._ravel(init_params)
        self.potential_fn = lambda flat: dict_potential(self._unravel(flat))
        self._potential_and_grad = batched_potential_and_grad(self.potential_fn)
        self._adapt_mass_at, self._in_slow_window = build_adaptation_schedule(warmup_steps)
        return self

    def _draw_init(self, generator, num_chains: int):
        """A valid starting point per chain, (C, D), of the kernel's
        ``init_strategy`` and ``init_values``; in ``potential_fn`` mode the
        ``init_params`` for every chain."""
        if self._draw_initial is None:
            return self._initial_flat.expand(num_chains, self._num_dims).to(torch.get_default_dtype())
        return self._draw_initial(generator, num_chains)

    def init_state(self, generator, initial_flat) -> HMCState:
        """The state of every chain at ``initial_flat`` (C, D), with a step
        size found per chain and a unit inverse mass."""
        z = initial_flat
        pe, z_grad = self._potential_and_grad(z)
        inverse_mass_diag = torch.ones_like(z)
        if self.full_mass:
            inverse_mass_diag = torch.diag_embed(inverse_mass_diag)
        if self.adapt_step_size:
            step_size = find_reasonable_step_size(
                self._potential_and_grad, z, pe, z_grad, inverse_mass_diag, generator, self.target_accept_prob
            )
        else:
            step_size = torch.full_like(pe, self.step_size)
        da = da_init(torch.log(10.0 * step_size))
        welford = welford_init(z.shape[-1], diagonal=not self.full_mass, batch_shape=pe.shape, device=z.device)
        zero = torch.zeros_like(pe)
        zero_int = torch.zeros(pe.shape, dtype=torch.int64, device=z.device)
        return HMCState(0, z, pe, z_grad, pe, zero_int, zero, zero, torch.zeros_like(pe, dtype=torch.bool),
                        AdaptState(step_size, inverse_mass_diag, da, welford))

    # -- one transition -----------------------------------------------------
    def _trajectory(self, state: HMCState, step_size, inverse_mass_diag, generator):
        """A fixed-length trajectory per chain and its Metropolis test.
        Returns (z, pe, z_grad, energy, num_steps, accept_prob, diverging)."""
        r = _sample_momentum(generator, inverse_mass_diag)
        energy0 = state.potential_energy + _kinetic(r, inverse_mass_diag)
        if self.num_steps is not None:
            num_steps = torch.full_like(energy0, self.num_steps, dtype=torch.int64)
            max_steps = self.num_steps
        else:
            num_steps = torch.clamp(torch.ceil(self.trajectory_length / step_size), 1, 1024).to(torch.int64)
            self.counts["host_syncs"] += 1
            max_steps = int(num_steps.max())
        z, pe, z_grad, r_cur = state.z, state.potential_energy, state.z_grad, r
        for n in range(max_steps):
            z1, r1, pe1, g1 = _leapfrog(z, r_cur, z_grad, step_size[:, None], inverse_mass_diag,
                                        self._potential_and_grad)
            self.counts["leapfrogs"] += 1
            on = n < num_steps
            z, r_cur, pe, z_grad = (torch.where(on[:, None], z1, z), torch.where(on[:, None], r1, r_cur),
                                    torch.where(on, pe1, pe), torch.where(on[:, None], g1, z_grad))
        energy1 = pe + _kinetic(r_cur, inverse_mass_diag)
        delta = energy1 - energy0
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        diverging = delta > 1000.0
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        accept = torch.rand(accept_prob.shape, generator=generator, device=accept_prob.device) < accept_prob
        return (
            torch.where(accept[:, None], z, state.z),
            torch.where(accept, pe, state.potential_energy),
            torch.where(accept[:, None], z_grad, state.z_grad),
            torch.where(accept, energy1, energy0),
            num_steps,
            accept_prob,
            diverging,
        )

    def _adapt(self, state: HMCState, accept_prob, z_new) -> AdaptState:
        """The warmup update of step size and mass matrix (none after warmup)."""
        adapt = state.adapt
        i = state.i
        if i >= self._num_warmup:
            return adapt
        step_size, da = adapt.step_size, adapt.da
        if self.adapt_step_size:
            da = da_step(da, self.target_accept_prob - accept_prob)
            step_size = torch.exp(da.x_avg if i == self._num_warmup - 1 else da.x_t)
        welford, inverse_mass_diag = adapt.welford, adapt.inverse_mass_diag
        if self.adapt_mass_matrix:
            if self._in_slow_window[i]:
                welford = welford_update(welford, z_new)
            if self._adapt_mass_at[i]:
                inverse_mass_diag = welford_covariance(welford)
                welford = welford_init(z_new.shape[-1], diagonal=not self.full_mass, batch_shape=step_size.shape,
                                       device=z_new.device)
                if self.adapt_step_size:
                    da = da_init(torch.log(10.0 * step_size))
        return AdaptState(step_size, inverse_mass_diag, da, welford)

    def sample_step(self, state: HMCState, generator) -> HMCState:
        z, pe, z_grad, energy, num_steps, accept_prob, diverging = self._trajectory(
            state, state.adapt.step_size, state.adapt.inverse_mass_diag, generator
        )
        adapt = self._adapt(state, accept_prob, z)
        i = state.i + 1
        n = i if state.i < self._num_warmup else max(i - self._num_warmup, 1)
        mean_accept = state.mean_accept_prob + (accept_prob - state.mean_accept_prob) / n
        return HMCState(i, z, pe, z_grad, energy, num_steps, accept_prob, mean_accept, diverging, adapt)
