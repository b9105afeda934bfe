"""The No-U-Turn Sampler over a batch of chains (counterpart of
``pyro_tpu/infer/mcmc/nuts.py``): iterative doubling, multinomial
sampling, Stan's generalized U-turn criterion and a divergence threshold
of 1000.

Every chain of the batch doubles its trajectory in step with the others,
so at each doubling all chains still going build a subtree of the same
depth, and inside it all of them are at the same leaf.  A leaf is one
batched leapfrog step of every chain, and a chain that has turned or
diverged keeps its state through ``torch.where`` while the others go on.
The leaf counter ``k`` is therefore one for all chains: a chain's momentum
at an even leaf goes to checkpoint ``popcount(k >> 1)``, and at an odd leaf
the subtrees it completes are checked against checkpoints
``[popcount(k >> 1) - trailing_ones(k) + 1, popcount(k >> 1)]``, the
recursion-free bookkeeping of the JAX package.  The loop over leaves ends
when no chain is left in the subtree: one device-to-host sync a leapfrog.

A leaf works in place on buffers made once per batch shape, with ``k`` a
device scalar that indexes a table of each leaf's flags and the subtree's
uniform draws (drawn before its first leaf), so one leaf body serves every
leaf.  On a CUDA device that body, the potential's vmapped gradient
included, is captured once as a CUDA graph and replayed: a leaf is one
graph launch and the sync, where run eagerly it is some 200 launches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .hmc import HMC, HMCState, _kinetic, _leapfrog, _sample_momentum, _velocity


class _TreeState(NamedTuple):
    # trajectory extremes
    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    pe_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    pe_right: torch.Tensor
    # multinomial proposal, with its momentum for its energy
    z_proposal: torch.Tensor
    pe_proposal: torch.Tensor
    grad_proposal: torch.Tensor
    r_proposal: torch.Tensor
    # statistics
    r_sum: torch.Tensor
    weight: torch.Tensor  # log total weight relative to the initial energy
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_proposals: torch.Tensor


def _where(mask, new: _TreeState, old: _TreeState) -> _TreeState:
    """Each field of ``new`` for the chains in ``mask`` (C,), else ``old``'s."""
    return _TreeState(*(
        torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b) for a, b in zip(new, old)
    ))


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    return _popcount(x & ~(x + 1))


def _is_turning(inverse_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion: the velocity at either end of the
    trajectory has a non-positive projection on its momentum sum.  Reduces
    the last dim."""
    v_left = _velocity(inverse_mass, r_left)
    v_right = _velocity(inverse_mass, r_right)
    return ((v_left * r_sum).sum(-1) <= 0) | ((v_right * r_sum).sum(-1) <= 0)


class _Leaves:
    """The state a batch of subtrees is built in, leaf by leaf: the tree,
    which chains still run, the checkpoints, the subtree's inputs, its
    uniform draws (one a leaf and chain), the leaf index and a table of
    each leaf's flags (first, even, popcount(k >> 1) and the first
    checkpoint an odd leaf completes)."""

    def __init__(self, C: int, n_dim: int, max_depth: int, like, dense: bool = False):
        opts = {"dtype": like.dtype, "device": like.device}
        vec, mat = torch.zeros(C, **opts), torch.zeros(C, n_dim, **opts)
        self.tree = _TreeState(
            mat.clone(), mat.clone(), mat.clone(), vec.clone(), mat.clone(), mat.clone(), mat.clone(), vec.clone(),
            mat.clone(), vec.clone(), mat.clone(), mat.clone(),
            mat.clone(), vec.clone(), vec.bool(), vec.bool(), vec.clone(), vec.long(),
        )
        self.running = torch.ones(C, dtype=torch.bool, device=like.device)
        self.r_ckpts = torch.zeros(C, max_depth + 1, n_dim, **opts)
        self.r_sum_ckpts = torch.zeros_like(self.r_ckpts)
        self.signed_step = torch.full((C, 1), 0.1, **opts)
        self.energy0 = vec.clone()
        self.inverse_mass_diag = torch.eye(n_dim, **opts).expand(C, n_dim, n_dim).clone() if dense else \
            torch.ones(C, n_dim, **opts)
        self.u = torch.full((1 << max_depth, C), 0.5, **opts)
        self.k = torch.zeros(1, dtype=torch.long, device=like.device)
        flags = []
        for k in range(1 << max_depth):
            ck = _popcount(k >> 1)
            flags.append((k == 0, k % 2 == 0, ck, ck - _trailing_ones(k) + 1))
        self.flags = torch.tensor(flags, dtype=torch.long).to(like.device)
        self.slots = torch.arange(max_depth + 1, device=like.device)
        self.graph = None


class NUTS(HMC):
    def __init__(
        self,
        model=None,
        potential_fn=None,
        step_size: float = 1.0,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        full_mass: bool = False,
        max_tree_depth: int = 10,
        target_accept_prob: float = 0.8,
        max_plate_nesting=None,
        init_strategy="uniform",
        init_values=None,
    ):
        super().__init__(
            model,
            potential_fn=potential_fn,
            step_size=step_size,
            num_steps=1,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            full_mass=full_mass,
            target_accept_prob=target_accept_prob,
            max_plate_nesting=max_plate_nesting,
            init_strategy=init_strategy,
            init_values=init_values,
        )
        self.max_tree_depth = max_tree_depth
        self._leaf_buffers = {}

    def setup(self, warmup_steps, *args, **kwargs):
        self._leaf_buffers = {}  # a captured leaf holds the potential it was captured with
        return super().setup(warmup_steps, *args, **kwargs)

    # -- subtree builder ----------------------------------------------------
    def _leaves(self, C: int, n_dim: int, like) -> "_Leaves":
        """The buffers for batches of C chains in n_dim dims (with a dense
        inverse mass under ``full_mass``), made once; on a CUDA device the
        leaf is captured as a graph over them."""
        key = (C, n_dim, like.device, like.dtype, self.full_mass)
        b = self._leaf_buffers.get(key)
        if b is None:
            b = self._leaf_buffers[key] = _Leaves(C, n_dim, self.max_tree_depth, like, self.full_mass)
            if like.is_cuda:
                # warm up on a side stream, then capture; both run on the
                # buffers' benign initial values, which every subtree resets
                stream = torch.cuda.Stream(like.device)
                stream.wait_stream(torch.cuda.current_stream(like.device))
                with torch.cuda.stream(stream):
                    for _ in range(2):
                        self._leaf(b)
                torch.cuda.current_stream(like.device).wait_stream(stream)
                b.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(b.graph):
                    self._leaf(b)
        return b

    def _leaf(self, b: "_Leaves") -> None:
        """One leaf of every chain's subtree, in place on ``b``: a batched
        leapfrog step, the multinomial proposal, the checkpoints of an even
        leaf, the sub-U-turn checks of an odd one, all masked by
        ``b.running``.  The leaf index ``b.k`` is a device scalar, so one
        body (and one CUDA graph) serves every leaf."""
        t, running = b.tree, b.running
        k = b.k
        first, even, ck, lo = b.flags.index_select(0, k)[0].unbind()
        first, even = first.bool(), even.bool()
        u = b.u.index_select(0, k)[0]
        z_new, r_new, pe_new, grad_new = _leapfrog(
            t.z_right, t.r_right, t.grad_right, b.signed_step, b.inverse_mass_diag, self._potential_and_grad
        )
        delta = pe_new + _kinetic(r_new, b.inverse_mass_diag) - b.energy0
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        diverging = delta > 1000.0
        weight_new = torch.logaddexp(t.weight, -delta)
        take = running & (torch.log(u) < -delta - weight_new)
        r_sum_new = t.r_sum + r_new
        # an even leaf starts balanced subtrees: checkpoint ck keeps its
        # momentum and the momentum sum before it
        keep = (running[:, None] & (b.slots == ck) & even)[..., None]
        torch.where(keep, r_new[:, None], b.r_ckpts, out=b.r_ckpts)
        torch.where(keep, t.r_sum[:, None], b.r_sum_ckpts, out=b.r_sum_ckpts)
        # an odd leaf completes the subtrees of checkpoints lo..ck
        in_range = (b.slots >= lo) & (b.slots <= ck) & ~even
        rho = r_sum_new[:, None] - b.r_sum_ckpts
        turning = (_is_turning(b.inverse_mass_diag[:, None], b.r_ckpts, r_new[:, None], rho) & in_range).any(-1)

        left = running & first
        for dst, new, mask in (
            (t.z_left, z_new, left), (t.r_left, r_new, left), (t.grad_left, grad_new, left), (t.pe_left, pe_new, left),
            (t.z_right, z_new, running), (t.r_right, r_new, running), (t.grad_right, grad_new, running),
            (t.pe_right, pe_new, running),
            (t.z_proposal, z_new, take), (t.pe_proposal, pe_new, take), (t.grad_proposal, grad_new, take),
            (t.r_proposal, r_new, take),
            (t.r_sum, r_sum_new, running), (t.weight, weight_new, running), (t.turning, turning, running),
            (t.diverging, diverging, running),
            (t.sum_accept, t.sum_accept + torch.clamp(torch.exp(-delta), max=1.0), running),
            (t.num_proposals, t.num_proposals + 1, running),
        ):
            torch.where(mask.reshape(mask.shape + (1,) * (dst.ndim - 1)), new, dst, out=dst)
        running &= ~turning & ~diverging
        k += 1

    def _build_subtree(self, depth: int, z, r, z_grad, energy0, direction, step_size, inverse_mass_diag, generator,
                       active=None) -> Tuple[_TreeState, bool]:
        """A balanced subtree of 2^depth leaves for each chain in ``active``
        (all if None), starting one leapfrog step beyond (z, r) in
        ``direction`` (C,) (left = first leaf produced, right = last).  A
        chain stops at the leaf where it turns or diverges.  Returns the
        subtree and whether the leaves ran out before every chain stopped
        (if not, every chain in ``active`` turned or diverged in it)."""
        C, n_dim = z.shape
        b = self._leaves(C, n_dim, z)
        zero = torch.zeros_like(energy0)
        false = torch.zeros_like(energy0, dtype=torch.bool)
        init = _TreeState(
            z, r, z_grad, zero, z, r, z_grad, zero,
            z, zero, z_grad, r,
            torch.zeros_like(r), torch.full_like(energy0, -torch.inf), false, false, zero, zero.long(),
        )
        for dst, src in zip(b.tree, init):
            dst.copy_(src)
        b.running.copy_(~false if active is None else active)
        b.r_ckpts.zero_()
        b.r_sum_ckpts.zero_()
        b.signed_step.copy_((direction * step_size)[:, None])
        b.energy0.copy_(energy0)
        b.inverse_mass_diag.copy_(inverse_mass_diag)
        b.k.zero_()
        torch.rand(b.u[: 1 << depth].shape, generator=generator, out=b.u[: 1 << depth])
        for k in range(1 << depth):
            if k > 0 and not self._any(b.running):
                return _TreeState(*(x.clone() for x in b.tree)), False
            if b.graph is None:
                self._leaf(b)
            else:
                b.graph.replay()
            self.counts["leapfrogs"] += 1
        return _TreeState(*(x.clone() for x in b.tree)), True

    # -- main transition ----------------------------------------------------
    def _trajectory(self, state: HMCState, step_size, inverse_mass_diag, generator):
        """Doubling until each chain turns, diverges or reaches
        ``max_tree_depth``.  Returns (z, pe, z_grad, energy, num_steps,
        accept_prob, diverging) of every chain; the energy is the
        proposal's own, its potential plus the kinetic energy of its
        momentum."""
        r0 = _sample_momentum(generator, inverse_mass_diag)
        energy0 = state.potential_energy + _kinetic(r0, inverse_mass_diag)
        pe = state.potential_energy
        false = torch.zeros_like(pe, dtype=torch.bool)
        zero_int = torch.zeros_like(pe, dtype=torch.int64)
        tree = _TreeState(
            state.z, r0, state.z_grad, pe, state.z, r0, state.z_grad, pe,
            state.z, pe, state.z_grad, r0,
            r0, torch.zeros_like(pe), false, false, torch.zeros_like(pe), zero_int,
        )
        active = ~false
        leaves_ran_out = True
        for depth in range(self.max_tree_depth):
            # a subtree every chain left early leaves no chain active; else
            # one sync asks whether any chain goes on
            if depth > 0 and not (leaves_ran_out and self._any(active)):
                break
            u = torch.rand((2,) + pe.shape, generator=generator, dtype=pe.dtype, device=pe.device)
            going_right = u[0] < 0.5
            right = going_right[:, None]
            direction = torch.where(going_right, 1.0, -1.0)
            subtree, leaves_ran_out = self._build_subtree(
                depth,
                torch.where(right, tree.z_right, tree.z_left),
                torch.where(right, tree.r_right, tree.r_left),
                torch.where(right, tree.grad_right, tree.grad_left),
                energy0, direction, step_size, inverse_mass_diag, generator, active,
            )
            bad_subtree = subtree.turning | subtree.diverging
            # biased progressive sampling: take the new subtree's proposal
            # with probability min(1, w_new / w_old)
            take_new = (torch.log(u[1]) < subtree.weight - tree.weight) & ~bad_subtree
            take_v = take_new[:, None]
            z_left = torch.where(right, tree.z_left, subtree.z_right)
            r_left = torch.where(right, tree.r_left, subtree.r_right)
            grad_left = torch.where(right, tree.grad_left, subtree.grad_right)
            pe_left = torch.where(going_right, tree.pe_left, subtree.pe_right)
            z_right = torch.where(right, subtree.z_right, tree.z_right)
            r_right = torch.where(right, subtree.r_right, tree.r_right)
            grad_right = torch.where(right, subtree.grad_right, tree.grad_right)
            pe_right = torch.where(going_right, subtree.pe_right, tree.pe_right)
            r_sum = tree.r_sum + subtree.r_sum
            turning = bad_subtree | _is_turning(inverse_mass_diag, r_left, r_right, r_sum)
            merged = _TreeState(
                z_left, r_left, grad_left, pe_left, z_right, r_right, grad_right, pe_right,
                torch.where(take_v, subtree.z_proposal, tree.z_proposal),
                torch.where(take_new, subtree.pe_proposal, tree.pe_proposal),
                torch.where(take_v, subtree.grad_proposal, tree.grad_proposal),
                torch.where(take_v, subtree.r_proposal, tree.r_proposal),
                r_sum,
                torch.logaddexp(tree.weight, subtree.weight),
                turning & ~subtree.diverging,
                tree.diverging | subtree.diverging,
                tree.sum_accept + subtree.sum_accept,
                tree.num_proposals + subtree.num_proposals,
            )
            tree = _where(active, merged, tree)
            active = active & ~tree.turning & ~tree.diverging

        accept_prob = tree.sum_accept / torch.clamp(tree.num_proposals, min=1)
        energy = tree.pe_proposal + _kinetic(tree.r_proposal, inverse_mass_diag)
        return (tree.z_proposal, tree.pe_proposal, tree.grad_proposal, energy, tree.num_proposals, accept_prob,
                tree.diverging)
