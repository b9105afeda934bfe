"""Information-form Gaussian algebra for exact sequence marginalisation
(counterpart of ``pyro_tpu/ops/gaussian.py``).

A ``Gaussian`` represents exp(c + i.x - x'Px/2) with batched log normaliser
c, info vector i and precision P.  The time contractions halve a chain of
factors level by level; each level runs through the K4 wrappers of
``ops/gaussian_levels.py`` (hand-written CUDA kernels on the card, their
plain versions on the CPU):

- ``sequential_gaussian_tensordot_homogeneous`` and the homogeneous sampler
  run K4a, one launch a level for every power-of-two block still reducing
  (the blocks share each level's precision);
- ``sequential_gaussian_tensordot`` and ``sequential_gaussian_filter_sample``
  run K4b, one launch a level;
- both samplers draw each level's midpoints with K4c, one launch a level.

What lies outside the levels (the block joins, the endpoint and junction
draws, the contraction with the initial state) is a few small calls of
``ops/linalg_small.py``.  Draws take a ``torch.Generator``; where ``noise``
is given (standard white noise), a draw is a deterministic function of it.
"""

from __future__ import annotations

import math

import torch

from ..distributions.util import broadcast_shape
from . import gaussian_levels, linalg_small
from .gaussian_levels import _log_diag_sum


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _tri_solve_vec(L, b):
    return linalg_small.solve_lower(L, b.unsqueeze(-1)).squeeze(-1)


def _reorder_events(info_vec, precision, blocks):
    """``info_vec`` and ``precision`` with their event dims reordered as the
    (start, stop) ``blocks`` list them, by concatenation: an index tensor
    made from a Python list would be a copy from the host, which waits for
    the device."""
    info_vec = torch.cat([info_vec[..., a:b] for a, b in blocks], dim=-1)
    rows = torch.cat([precision[..., a:b, :] for a, b in blocks], dim=-2)
    return info_vec, torch.cat([rows[..., a:b] for a, b in blocks], dim=-1)


class Gaussian:
    """A batch of non-normalised Gaussians in information form."""

    def __init__(self, log_normalizer, info_vec, precision):
        self.log_normalizer = log_normalizer
        self.info_vec = info_vec
        self.precision = precision

    @property
    def dim(self) -> int:
        return self.info_vec.shape[-1]

    @property
    def batch_shape(self):
        return broadcast_shape(self.log_normalizer.shape, self.info_vec.shape[:-1], self.precision.shape[:-2])

    def expand(self, batch_shape) -> "Gaussian":
        n = self.dim
        batch_shape = tuple(batch_shape)
        return Gaussian(
            self.log_normalizer.expand(batch_shape),
            self.info_vec.expand(batch_shape + (n,)),
            self.precision.expand(batch_shape + (n, n)),
        )

    def reshape(self, batch_shape) -> "Gaussian":
        n = self.dim
        batch_shape = tuple(batch_shape)
        return Gaussian(
            self.log_normalizer.reshape(batch_shape),
            self.info_vec.reshape(batch_shape + (n,)),
            self.precision.reshape(batch_shape + (n, n)),
        )

    def __getitem__(self, index) -> "Gaussian":
        """Index batch dims only (event dims are kept)."""
        if not isinstance(index, tuple):
            index = (index,)
        return Gaussian(
            self.log_normalizer[index],
            self.info_vec[index + (slice(None),)],
            self.precision[index + (slice(None), slice(None))],
        )

    @staticmethod
    def cat(parts, dim: int = 0) -> "Gaussian":
        if dim < 0:
            dim += len(parts[0].batch_shape)
        return Gaussian(
            torch.cat([p.log_normalizer for p in parts], dim=dim),
            torch.cat([p.info_vec for p in parts], dim=dim),
            torch.cat([p.precision for p in parts], dim=dim),
        )

    def event_pad(self, left: int = 0, right: int = 0) -> "Gaussian":
        """Pad with zeros: the new dims are unconstrained."""
        info_vec = torch.nn.functional.pad(self.info_vec, (left, right))
        precision = torch.nn.functional.pad(self.precision, (left, right, left, right))
        return Gaussian(self.log_normalizer, info_vec, precision)

    def event_permute(self, perm) -> "Gaussian":
        perm = torch.as_tensor(perm, device=self.info_vec.device)
        info_vec = self.info_vec[..., perm]
        precision = self.precision[..., perm, :][..., :, perm]
        return Gaussian(self.log_normalizer, info_vec, precision)

    def _event_blocks(self, blocks) -> "Gaussian":
        return Gaussian(self.log_normalizer, *_reorder_events(self.info_vec, self.precision, blocks))

    def __add__(self, other) -> "Gaussian":
        if isinstance(other, Gaussian):
            assert self.dim == other.dim
            return Gaussian(
                self.log_normalizer + other.log_normalizer,
                self.info_vec + other.info_vec,
                self.precision + other.precision,
            )
        return Gaussian(self.log_normalizer + other, self.info_vec, self.precision)

    def __sub__(self, other) -> "Gaussian":
        return Gaussian(self.log_normalizer - other, self.info_vec, self.precision)

    def log_density(self, value):
        """The non-normalised log density at ``value``."""
        if self.dim == 0:
            return self.log_normalizer.expand(broadcast_shape(self.log_normalizer.shape, value.shape[:-1]))
        Px = _mv(self.precision, value)
        return self.log_normalizer + (value * (self.info_vec - 0.5 * Px)).sum(-1)

    def condition(self, value) -> "Gaussian":
        """Condition on the right-most block taking ``value``."""
        n_b = value.shape[-1]
        n_a = self.dim - n_b
        i_a, i_b = self.info_vec[..., :n_a], self.info_vec[..., n_a:]
        P_aa = self.precision[..., :n_a, :n_a]
        P_ab = self.precision[..., :n_a, n_a:]
        P_bb = self.precision[..., n_a:, n_a:]
        info_vec = i_a - _mv(P_ab, value)
        log_normalizer = self.log_normalizer + (i_b * value).sum(-1) - 0.5 * (value * _mv(P_bb, value)).sum(-1)
        return Gaussian(log_normalizer, info_vec, P_aa)

    def left_condition(self, value) -> "Gaussian":
        """Condition on the left-most block taking ``value``."""
        n_a, n = value.shape[-1], self.dim
        return self._event_blocks([(n_a, n), (0, n_a)]).condition(value)

    def marginalize(self, left: int = 0, right: int = 0) -> "Gaussian":
        """Integrate out the left and right blocks exactly."""
        if left == 0 and right == 0:
            return self
        n, n_b = self.dim, left + right
        g = self
        if left:
            g = self._event_blocks([(left, n - right), (0, left), (n - right, n)])
        n_a = n - n_b
        P_aa = g.precision[..., :n_a, :n_a]
        P_ab = g.precision[..., :n_a, n_a:]
        P_bb = g.precision[..., n_a:, n_a:]
        i_a, i_b = g.info_vec[..., :n_a], g.info_vec[..., n_a:]
        L_bb = linalg_small.cholesky(P_bb)
        LinvPba = linalg_small.solve_lower(L_bb, P_ab.transpose(-1, -2))
        Linvib = _tri_solve_vec(L_bb, i_b)
        precision = P_aa - LinvPba.transpose(-1, -2) @ LinvPba
        info_vec = i_a - _mv(LinvPba.transpose(-1, -2), Linvib)
        log_normalizer = (
            self.log_normalizer + 0.5 * n_b * math.log(2 * math.pi) - _log_diag_sum(L_bb)
            + 0.5 * (Linvib**2).sum(-1)
        )
        return Gaussian(log_normalizer, info_vec, precision)

    def event_logsumexp(self):
        """Integrate out every dim: the log normalisation constant."""
        n = self.dim
        L = linalg_small.cholesky(self.precision)
        Linvi = _tri_solve_vec(L, self.info_vec)
        return self.log_normalizer + 0.5 * n * math.log(2 * math.pi) - _log_diag_sum(L) + 0.5 * (Linvi**2).sum(-1)

    def rsample(self, generator=None, sample_shape=(), noise=None):
        """Draw from the normalised density.  Given ``noise`` (standard white
        noise of shape ``sample_shape + batch_shape + (dim,)``), the draw is
        loc + L^-T noise: zeros give the mean."""
        L = linalg_small.cholesky(self.precision)
        loc = linalg_small.cholesky_solve(L, self.info_vec.unsqueeze(-1)).squeeze(-1)
        shape = tuple(sample_shape) + self.batch_shape + (self.dim,)
        if noise is None:
            eps = torch.randn(shape, generator=generator, dtype=loc.dtype, device=loc.device)
        else:
            eps = noise.expand(shape)
        return loc + linalg_small.solve_lower_t(L, eps.unsqueeze(-1)).squeeze(-1)

    def to_mvn(self):
        from ..distributions.multivariate import MultivariateNormal

        L = linalg_small.cholesky(self.precision)
        loc = linalg_small.cholesky_solve(L, self.info_vec.unsqueeze(-1)).squeeze(-1)
        return MultivariateNormal(loc, precision_matrix=self.precision)


def mvn_to_gaussian(mvn) -> Gaussian:
    """A Gaussian of an ``Independent(Normal)`` or ``MultivariateNormal``."""
    from ..distributions.continuous import Normal
    from ..distributions.distribution import Independent

    if isinstance(mvn, Independent) and isinstance(mvn.base_dist, Normal):
        base = mvn.base_dist
        scale, loc = base.scale.expand(base.batch_shape), base.loc.expand(base.batch_shape)
        precision_diag = scale**-2
        precision = torch.diag_embed(precision_diag)
        info_vec = loc * precision_diag
        log_normalizer = (-0.5 * math.log(2 * math.pi) - torch.log(scale) - 0.5 * (loc / scale) ** 2).sum(-1)
        return Gaussian(log_normalizer, info_vec, precision)
    L, loc = mvn.scale_tril, mvn.loc
    n = loc.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
    Linv = linalg_small.solve_lower(L, eye)
    precision = Linv.transpose(-1, -2) @ Linv
    info_vec = _mv(precision, loc)
    log_normalizer = -0.5 * n * math.log(2 * math.pi) - _log_diag_sum(L) - 0.5 * (info_vec * loc).sum(-1)
    return Gaussian(log_normalizer, info_vec, precision)


def matrix_and_mvn_to_gaussian(matrix, mvn) -> Gaussian:
    """The joint Gaussian over (x, y) of y = x @ matrix + noise, noise ~
    ``mvn``; ``matrix`` (..., x_dim, y_dim)."""
    y_gaussian = mvn_to_gaussian(mvn)
    x_dim, y_dim = matrix.shape[-2:]
    P_yy, i_y = y_gaussian.precision, y_gaussian.info_vec
    A = matrix
    P_xy = -(A @ P_yy)
    P_xx = A @ P_yy @ A.transpose(-1, -2)
    i_x = -_mv(A, i_y)
    batch = broadcast_shape(P_xx.shape[:-2], P_yy.shape[:-2], A.shape[:-2])
    top = torch.cat([P_xx.expand(batch + (x_dim, x_dim)), P_xy.expand(batch + (x_dim, y_dim))], dim=-1)
    bottom = torch.cat(
        [P_xy.transpose(-1, -2).expand(batch + (y_dim, x_dim)), P_yy.expand(batch + (y_dim, y_dim))], dim=-1
    )
    precision = torch.cat([top, bottom], dim=-2)
    info_vec = torch.cat([i_x.expand(batch + (x_dim,)), i_y.expand(batch + (y_dim,))], dim=-1)
    return Gaussian(y_gaussian.log_normalizer.expand(batch), info_vec, precision)


def gaussian_tensordot(x: Gaussian, y: Gaussian, dims: int = 0) -> Gaussian:
    """Contract the last ``dims`` of x with the first ``dims`` of y.  The
    joint is built in (a, c, b) block order, so the shared block b is
    integrated out in place."""
    na, nb, nc = x.dim - dims, dims, y.dim - dims
    if nb == 0:
        return x.event_pad(right=nc) + y.event_pad(left=na)
    batch = broadcast_shape(x.batch_shape, y.batch_shape)
    Px = x.precision.expand(batch + (x.dim, x.dim))
    Py = y.precision.expand(batch + (y.dim, y.dim))
    ix = x.info_vec.expand(batch + (x.dim,))
    iy = y.info_vec.expand(batch + (y.dim,))
    Paa, Pab = Px[..., :na, :na], Px[..., :na, na:]
    Pbb = Px[..., na:, na:] + Py[..., :nb, :nb]
    Pbc, Pcc = Py[..., :nb, nb:], Py[..., nb:, nb:]
    z_ac = Px.new_zeros(batch + (na, nc))
    row_a = torch.cat([Paa, z_ac, Pab], dim=-1)
    row_c = torch.cat([z_ac.transpose(-1, -2), Pcc, Pbc.transpose(-1, -2)], dim=-1)
    row_b = torch.cat([Pab.transpose(-1, -2), Pbc, Pbb], dim=-1)
    precision = torch.cat([row_a, row_c, row_b], dim=-2)
    info_vec = torch.cat([ix[..., :na], iy[..., nb:], ix[..., na:] + iy[..., :nb]], dim=-1)
    joint = Gaussian(x.log_normalizer + y.log_normalizer, info_vec, precision)
    return joint.marginalize(right=nb)


def _pow2_blocks(T):
    """The maximal power-of-two blocks of T, in time order (largest first)."""
    sizes = []
    while T > 0:
        sizes.append(1 << (T.bit_length() - 1))
        T -= sizes[-1]
    return sizes


def _unflatten(g, batch):
    """``g`` with batch (R,) as batch ``batch``; a shared (2-D) precision
    stays shared."""
    n = g.dim
    P = g.precision if g.precision.ndim == 2 else g.precision.reshape(tuple(batch) + (n, n))
    return Gaussian(g.log_normalizer.reshape(batch), g.info_vec.reshape(tuple(batch) + (n,)), P)


def _pow2_halvings(P, rows, level):
    """Reduce each maximal power-of-two block of the time axis of a
    homogeneous chain: shared P (2n, 2n), ``rows`` a list of tensors (R, T,
    ...) (the info vectors, the log normalisers, and whatever else a factor
    carries per step).

    After k levels every block still reducing has the same precision, so
    one launch of ``level(P, *rows) -> (P', rows', saved)`` reduces level k
    of all of them: the blocks lie in time order, largest first, so those
    still reducing are a prefix of the rows, each of even length.  Returns
    each block's ``(P, *rows)`` (rows of batch R) in time order and, per
    level, ``(P, *saved)`` with P that level's input."""
    sizes = _pow2_blocks(rows[0].shape[1])
    blocks, levels = [None] * len(sizes), []
    k = 0
    while True:
        active = sum(1 for s in sizes if s >> k > 1)
        length = sum(s >> k for s in sizes[:active])
        for j in range(active, len(sizes)):  # finished blocks: one row each, after the active ones
            if blocks[j] is None:
                row = length + j - active
                blocks[j] = (P, *(x[:, row] for x in rows))
        if not active:
            return blocks, levels
        P_in = P
        P, rows, saved = level(P, *(x[:, :length] for x in rows))
        levels.append((P_in, *saved))
        k += 1


def _homogeneous_levels(P, info, logZ, tape=False):
    """``_pow2_halvings`` through K4a (info (R, T, 2n), logZ (R, T)): each
    block's Gaussian (batch R, its own P) in time order and, per level,
    (P, L, ib) with ib over the pairs of every block reducing at that level,
    in time order."""

    def level(P, info, logZ):
        P, info, logZ, L, ib = gaussian_levels.halving_level(P, info, logZ, tape)
        return P, (info, logZ), (L, ib)

    blocks, levels = _pow2_halvings(P, (info, logZ), level)
    return [Gaussian(logZ, info, P) for P, info, logZ in blocks], levels


def sequential_gaussian_tensordot_homogeneous(gaussian: Gaussian) -> Gaussian:
    """The Markov-chain contraction of a time-homogeneous chain: every factor
    along the trailing batch axis (time) shares one precision
    (``precision.ndim == 2``); only info vectors and log normalisers vary.
    Each halving level needs one n x n factorisation (K4a); the power-of-two
    blocks' results are folded left to right with ``gaussian_tensordot``."""
    assert gaussian.precision.ndim == 2
    two_n = gaussian.dim
    assert two_n % 2 == 0
    n = two_n // 2
    batch = gaussian.batch_shape
    info = gaussian.info_vec.expand(batch + (two_n,)).reshape(-1, batch[-1], two_n)
    logZ = gaussian.log_normalizer.expand(batch).reshape(-1, batch[-1])
    blocks, _ = _homogeneous_levels(gaussian.precision, info, logZ)
    result = blocks[0]
    for g in blocks[1:]:
        result = gaussian_tensordot(result, g, dims=n)
    return _unflatten(result, batch[:-1])


def sequential_gaussian_tensordot(gaussian: Gaussian) -> Gaussian:
    """Integrate a Markov product of T factors (batch ``(..., T)``, dim 2n
    over (previous, next) state) over the interior states: a Gaussian of
    dim 2n joining the first and last states.  Pairwise halving, one K4b
    launch a level, depth ceil(log2 T)."""
    assert gaussian.dim % 2 == 0
    two_n = gaussian.dim
    batch = gaussian.batch_shape
    g = gaussian.expand(batch)  # views: K4b reads a broadcast factor in place
    P, info, logZ = g.precision, g.info_vec, g.log_normalizer
    while P.shape[-3] > 1:
        P, info, logZ, _ = gaussian_levels.contract_pairs(P, info, logZ)
    return Gaussian(logZ[..., 0], info[..., 0, :], P[..., 0, :, :])


class _NoiseSlots:
    """Consumes time slots of a standard white noise buffer in order, or
    draws fresh noise from ``generator``."""

    def __init__(self, noise, generator):
        self.noise, self.generator, self.pos = noise, generator, 0

    def take(self, k, shape, like):
        """The next k slots, of shape ``shape`` (k slots of n each)."""
        if self.noise is None:
            return torch.randn(shape, generator=self.generator, dtype=like.dtype, device=like.device)
        block = self.noise[..., self.pos:self.pos + k, :]
        self.pos += k
        return block.reshape(shape)


def _descend(z, levels, slots, lead):
    """The midpoint descent: per level from the top, K4c draws the mids of
    the points ``z`` (D, R, m, n), taking their noise from ``slots``.
    ``levels`` holds per level (L, P_mk, i_m); ``lead`` is the shape of
    sample and batch dims the noise comes in."""
    D, R, _, n = z.shape
    for L, P_mk, i_m in reversed(levels):
        Np = i_m.shape[-2]
        eps = slots.take(Np, lead + (Np, n), z).reshape(D, R, Np, n)
        z = gaussian_levels.level_mids(z, L, P_mk, i_m, eps)
    return z


def sequential_gaussian_filter_sample_homogeneous(init: Gaussian, trans: Gaussian, sample_shape=(),
                                                  generator=None, noise=None):
    """Posterior draws of a time-homogeneous Gaussian Markov chain (shared
    ``trans.precision``): ``init`` over the first state (dim n), ``trans``
    (batch ``(..., T)``, dim 2n).  Returns draws of shape ``sample_shape +
    batch + (T + 1, n)``.

    Time splits into maximal power-of-two blocks, whose halving levels K4a
    builds (one launch a level for all blocks); the block junctions are
    drawn by forward filtering and backward sampling over the few blocks;
    then each level's midpoints are drawn in parallel given their segment
    ends (K4c, one launch a level for all blocks).  ``noise`` (standard
    white noise of shape ``sample_shape + batch + (T + 1, n)``), if given,
    is consumed in order: the junctions from the last back, then each
    level's midpoints from the top level down; zeros give the posterior
    mean."""
    assert trans.precision.ndim == 2
    two_n = trans.dim
    n = two_n // 2
    T = trans.batch_shape[-1]
    batch = trans.batch_shape[:-1]
    P0 = trans.precision
    info0 = trans.info_vec.expand(trans.batch_shape + (two_n,)).reshape(-1, T, two_n)
    logZ0 = info0.new_zeros(info0.shape[:-1])
    blocks, levels = _homogeneous_levels(P0, info0, logZ0, tape=True)
    blocks = [_unflatten(g, batch) for g in blocks]

    # forward filtering and backward sampling over the block junctions
    alphas = [init.expand(batch)]
    for g in blocks:
        alphas.append((g + alphas[-1].event_pad(right=n)).marginalize(left=n))
    lead = tuple(sample_shape) + tuple(batch)
    slots = _NoiseSlots(noise, generator)
    junctions = [alphas[-1].rsample(generator, sample_shape, noise=slots.take(1, lead + (n,), info0))]
    for j in range(len(blocks) - 1, -1, -1):
        posterior = blocks[j].condition(junctions[-1]) + alphas[j]
        junctions.append(posterior.rsample(generator, noise=slots.take(1, lead + (n,), info0)))
    junctions.reverse()  # junctions[j] is the state at the start of block j

    D = math.prod(sample_shape)
    R = info0.shape[0]
    z = torch.stack(junctions, dim=-2).reshape(D, R, len(junctions), n)
    tape = [(L, torch.cat([P[:n, n:].T, P[:n, n:]], dim=1), ib) for P, L, ib in levels]
    z = _descend(z, tape, slots, lead)
    assert noise is None or slots.pos == T + 1, "noise not fully consumed"
    return z.reshape(lead + (T + 1, n))


def sequential_gaussian_filter_sample(init: Gaussian, trans: Gaussian, sample_shape=(), generator=None,
                                      noise=None):
    """Forward-filter backward-sample for a Gaussian Markov chain in O(log T)
    depth, valid for time-varying transitions.  ``init`` is over the first
    state (dim n); ``trans`` has batch ``(..., T)`` over (previous, next).
    Returns draws of shape ``sample_shape + batch + (T + 1, n)``.

    The forward halves the chain with K4b, keeping per level each pair's
    mid-block Cholesky factor, P_mk and i_m on a tape; the backward draws
    the chain's ends from the contracted Gaussian, then each level's
    midpoints with K4c.  ``noise`` (standard white noise of shape
    ``sample_shape + batch + (T + 1, n)``), if given, is consumed in order
    as the reference consumes it: the two ends, then each level's
    midpoints from the top level down; zeros give the posterior mean."""
    n = init.dim
    assert trans.dim == 2 * n
    T = trans.batch_shape[-1]
    batch = broadcast_shape(trans.batch_shape[:-1], init.batch_shape)
    init = init.expand(batch)
    lead = tuple(sample_shape) + tuple(batch)
    slots = _NoiseSlots(noise, generator)
    if T == 0:
        return init.rsample(generator, sample_shape, noise=slots.take(1, lead + (n,), init.info_vec))[..., None, :]
    trans = trans.expand(batch + (T,))
    P = trans.precision.reshape(-1, T, 2 * n, 2 * n)
    info = trans.info_vec.reshape(-1, T, 2 * n)
    logZ = trans.log_normalizer.reshape(-1, T)
    tape = []
    while P.shape[-3] > 1:
        P, info, logZ, saved = gaussian_levels.contract_pairs(P, info, logZ, tape=True)
        tape.append(saved)
    g = Gaussian(logZ[:, 0].reshape(batch), info[:, 0].reshape(batch + (2 * n,)),
                 P[:, 0].reshape(batch + (2 * n, 2 * n)))
    g = g + init.event_pad(right=n)  # the joint over (z_0, z_T)
    ends = g.rsample(generator, sample_shape, noise=slots.take(2, lead + (2 * n,), info))
    D = math.prod(sample_shape)
    z = ends.reshape(D, P.shape[0], 2, n)
    z = _descend(z, tape, slots, lead)
    assert noise is None or slots.pos == T + 1, "noise not fully consumed"
    return z.reshape(lead + (T + 1, n))


def sequential_gaussian_filter_sample_sequential(init: Gaussian, trans: Gaussian, sample_shape=(),
                                                 generator=None):
    """The O(T) forward-filter backward-sample of the reference, a loop over
    time: the oracle of the tests for the O(log T) samplers."""
    n = init.dim
    trans = trans.expand(trans.batch_shape)
    T = trans.batch_shape[-1]
    batch = trans.batch_shape[:-1]
    alpha = init.expand(batch)
    alphas = []
    for t in range(T):
        alphas.append(alpha)
        alpha = (trans[..., t] + alpha.event_pad(right=n)).marginalize(left=n)
    z = alpha.rsample(generator, sample_shape)
    zs = [z]
    for t in range(T - 1, -1, -1):
        cond = trans[..., t].condition(z)
        a = alphas[t]
        posterior = Gaussian(cond.log_normalizer + a.log_normalizer, cond.info_vec + a.info_vec,
                             cond.precision + a.precision)
        z = posterior.rsample(generator)
        zs.append(z)
    return torch.stack(zs[::-1], dim=-2)
