"""Gamma-Gaussian algebra for Student-t state-space models (counterpart of
``pyro_tpu/ops/gamma_gaussian.py``).

A ``GammaGaussian`` over ``(x, s)`` is the non-normalised density

    exp(c) * s^alpha * exp(s * (i.x - 0.5 x'Px - beta)),

a Gaussian in ``x`` whose info vector and precision are both scaled by a
shared mixing variable ``s``.  Integrating ``s`` out gives a multivariate
Student-t.  Time is contracted by pairwise halving, as in ``ops/gaussian.py``,
with the Gamma bookkeeping added: each elimination of the n shared dims
takes n/2 from ``alpha`` and the quadratic completion from ``beta``.  The
levels run through the K5 wrappers of ``ops/gaussian_levels.py``:

- ``sequential_gamma_gaussian_tensordot_homogeneous`` runs K5a, one launch
  a level for every power-of-two block still reducing;
- ``sequential_gamma_gaussian_tensordot`` runs K5b, one launch a level.

What lies outside the levels (the block joins, the contraction with the
initial state, the converters) is a few small calls of
``ops/linalg_small.py``.
"""

from __future__ import annotations

import math

import torch

from ..distributions.util import broadcast_shape
from . import gaussian_levels, linalg_small
from .gaussian import _log_diag_sum, _mv, _pow2_halvings, _reorder_events, _tri_solve_vec


class Gamma:
    """The non-normalised Gamma density ``exp(c) * s^(conc - 1) * exp(-rate * s)``."""

    def __init__(self, log_normalizer, concentration, rate):
        self.log_normalizer = log_normalizer
        self.concentration = concentration
        self.rate = rate

    def log_density(self, s):
        return self.log_normalizer + (self.concentration - 1) * torch.log(s) - self.rate * s

    def logsumexp(self):
        """Integrate out ``s``."""
        return self.log_normalizer + torch.lgamma(self.concentration) - self.concentration * torch.log(self.rate)


class GammaGaussian:
    """A batch of gamma-Gaussians: ``log p(x, s) = log_normalizer + alpha
    log(s) + s (x.i - x'Px / 2 - beta)``, so given ``s``, ``x`` is Gaussian
    with info vector ``s i`` and precision ``s P``."""

    def __init__(self, log_normalizer, info_vec, precision, alpha, beta):
        self.log_normalizer = log_normalizer
        self.info_vec = info_vec
        self.precision = precision
        self.alpha = alpha
        self.beta = beta

    @property
    def dim(self) -> int:
        return self.info_vec.shape[-1]

    @property
    def batch_shape(self):
        return broadcast_shape(self.log_normalizer.shape, self.info_vec.shape[:-1], self.precision.shape[:-2],
                               self.alpha.shape, self.beta.shape)

    def _scalars(self):
        return self.log_normalizer, self.alpha, self.beta

    def expand(self, batch_shape) -> "GammaGaussian":
        n = self.dim
        batch_shape = tuple(batch_shape)
        logZ, alpha, beta = (x.expand(batch_shape) for x in self._scalars())
        return GammaGaussian(logZ, self.info_vec.expand(batch_shape + (n,)),
                             self.precision.expand(batch_shape + (n, n)), alpha, beta)

    def reshape(self, batch_shape) -> "GammaGaussian":
        n = self.dim
        batch_shape = tuple(batch_shape)
        logZ, alpha, beta = (x.reshape(batch_shape) for x in self._scalars())
        return GammaGaussian(logZ, self.info_vec.reshape(batch_shape + (n,)),
                             self.precision.reshape(batch_shape + (n, n)), alpha, beta)

    def __getitem__(self, index) -> "GammaGaussian":
        """Index batch dims only (event dims are kept)."""
        if not isinstance(index, tuple):
            index = (index,)
        logZ, alpha, beta = (x[index] for x in self._scalars())
        return GammaGaussian(logZ, self.info_vec[index + (slice(None),)],
                             self.precision[index + (slice(None), slice(None))], alpha, beta)

    @staticmethod
    def cat(parts, dim: int = 0) -> "GammaGaussian":
        if dim < 0:
            dim += len(parts[0].batch_shape)
        return GammaGaussian(*(torch.cat([getattr(p, k) for p in parts], dim=dim)
                               for k in ("log_normalizer", "info_vec", "precision", "alpha", "beta")))

    def event_pad(self, left: int = 0, right: int = 0) -> "GammaGaussian":
        """Pad with zeros: the new dims are unconstrained.  alpha and beta do
        not depend on the dim, so they stay as they are."""
        info_vec = torch.nn.functional.pad(self.info_vec, (left, right))
        precision = torch.nn.functional.pad(self.precision, (left, right, left, right))
        return GammaGaussian(self.log_normalizer, info_vec, precision, self.alpha, self.beta)

    def event_permute(self, perm) -> "GammaGaussian":
        perm = torch.as_tensor(perm, device=self.info_vec.device)
        info_vec = self.info_vec[..., perm]
        precision = self.precision[..., perm, :][..., :, perm]
        return GammaGaussian(self.log_normalizer, info_vec, precision, self.alpha, self.beta)

    def __add__(self, other) -> "GammaGaussian":
        assert self.dim == other.dim
        return GammaGaussian(self.log_normalizer + other.log_normalizer, self.info_vec + other.info_vec,
                             self.precision + other.precision, self.alpha + other.alpha, self.beta + other.beta)

    def log_density(self, value, s):
        """log p(value, s)."""
        if value.shape[-1] == 0:
            batch = broadcast_shape(value.shape[:-1], s.shape, self.batch_shape)
            return self.alpha * torch.log(s) - self.beta * s + self.log_normalizer.expand(batch)
        quad = (value * (self.info_vec - 0.5 * _mv(self.precision, value))).sum(-1)
        return self.alpha * torch.log(s) + (quad - self.beta) * s + self.log_normalizer

    def condition(self, value) -> "GammaGaussian":
        """Condition on the right-most block taking ``value``; the density of
        the bound dims goes into beta (it is scaled by s)."""
        n = self.dim - value.shape[-1]
        info_a, info_b = self.info_vec[..., :n], self.info_vec[..., n:]
        P_aa, P_ab, P_bb = self.precision[..., :n, :n], self.precision[..., :n, n:], self.precision[..., n:, n:]
        info_vec = info_a - _mv(P_ab, value)
        beta = self.beta + 0.5 * (_mv(P_bb, value) * value).sum(-1) - (value * info_b).sum(-1)
        return GammaGaussian(self.log_normalizer, info_vec, P_aa, self.alpha, beta)

    def marginalize(self, left: int = 0, right: int = 0) -> "GammaGaussian":
        """Integrate out the left or the right block: the s-dependent
        normaliser shifts alpha and the quadratic completion shifts beta."""
        if left == 0 and right == 0:
            return self
        if left > 0 and right > 0:
            raise NotImplementedError
        n, n_b = self.dim, left + right
        a = slice(left, n - right)
        b = slice(None, left) if left else slice(n - right, None)
        P_aa, P_ba, P_bb = self.precision[..., a, a], self.precision[..., b, a], self.precision[..., b, b]
        L_b = linalg_small.cholesky(P_bb)
        P_a = linalg_small.solve_lower(L_b, P_ba)
        P_at = P_a.transpose(-1, -2)
        b_tmp = _tri_solve_vec(L_b, self.info_vec[..., b])
        info_vec = self.info_vec[..., a]
        if n_b < n:
            info_vec = info_vec - _mv(P_at, b_tmp)
        log_normalizer = self.log_normalizer + 0.5 * n_b * math.log(2 * math.pi) - _log_diag_sum(L_b)
        return GammaGaussian(log_normalizer, info_vec, P_aa - P_at @ P_a, self.alpha - 0.5 * n_b,
                             self.beta - 0.5 * (b_tmp**2).sum(-1))

    def compound(self):
        raise NotImplementedError(
            "GammaGaussian.compound needs MultivariateStudentT, which the port does not have yet "
            "(ROADMAP.md Queue 1 item 7)"
        )

    def event_logsumexp(self) -> Gamma:
        """Integrate out all of ``x``: the density left over ``s`` is Gamma-shaped."""
        n = self.dim
        L = linalg_small.cholesky(self.precision)
        Lu = _tri_solve_vec(L, self.info_vec)
        log_normalizer = self.log_normalizer + 0.5 * n * math.log(2 * math.pi) - _log_diag_sum(L)
        return Gamma(log_normalizer, self.alpha - 0.5 * n + 1, self.beta - 0.5 * (Lu**2).sum(-1))


def gamma_and_mvn_to_gamma_gaussian(gamma, mvn) -> GammaGaussian:
    """The joint of ``s ~ gamma`` and ``x | s ~ mvn`` with its precision
    scaled by ``s``; ``gamma`` a ``distributions.Gamma``, ``mvn`` an
    ``Independent(Normal)`` or ``MultivariateNormal``."""
    from .gaussian import mvn_to_gaussian

    g = mvn_to_gaussian(mvn)
    n = g.dim
    loc = linalg_small.cholesky_solve(linalg_small.cholesky(g.precision), g.info_vec.unsqueeze(-1)).squeeze(-1)
    quad = 0.5 * (g.info_vec * loc).sum(-1)
    alpha = gamma.concentration + (0.5 * n - 1)
    # the s-scaled quadratic -loc'P loc / 2 moves from the Gaussian's
    # normaliser into beta; the joint's normaliser absorbs the Gamma's own
    beta = gamma.rate + quad
    log_normalizer = -Gamma(-(g.log_normalizer + quad), gamma.concentration, gamma.rate).logsumexp()
    return GammaGaussian(log_normalizer, g.info_vec, g.precision, alpha, beta)


def matrix_and_mvn_to_gamma_gaussian(matrix, mvn) -> GammaGaussian:
    """The joint over ``(x, y)`` of ``y = x @ matrix + noise``, the noise
    ``mvn`` with its precision scaled by ``s``."""
    from .gaussian import matrix_and_mvn_to_gaussian

    x_dim, y_dim = matrix.shape[-2:]
    g = matrix_and_mvn_to_gaussian(matrix, mvn)
    info_y, P_yy = g.info_vec[..., x_dim:], g.precision[..., x_dim:, x_dim:]
    loc_y = linalg_small.cholesky_solve(linalg_small.cholesky(P_yy), info_y.unsqueeze(-1)).squeeze(-1)
    beta = 0.5 * (info_y * loc_y).sum(-1)
    # the Gaussian's normaliser holds -loc'P loc / 2, which belongs to beta here
    return GammaGaussian(g.log_normalizer + beta, g.info_vec, g.precision, torch.full_like(beta, 0.5 * y_dim), beta)


def gamma_gaussian_tensordot(x: GammaGaussian, y: GammaGaussian, dims: int = 0) -> GammaGaussian:
    """Contract the last ``dims`` of x with the first ``dims`` of y, sharing
    the mixing variable.  The joint's event dims are put in (a, c, b) block
    order, so the shared block b is integrated out in place; a precision
    shared by x and y (2-D) stays shared."""
    na, nb, nc = x.dim - dims, dims, y.dim - dims
    joint = x.event_pad(right=nc) + y.event_pad(left=na)
    if nb == 0:
        return joint
    info_vec, precision = _reorder_events(joint.info_vec, joint.precision,
                                          [(0, na), (na + nb, na + nb + nc), (na, na + nb)])
    return GammaGaussian(joint.log_normalizer, info_vec, precision, joint.alpha, joint.beta).marginalize(right=nb)


def _unflatten(g, batch):
    """``g`` with batch (R,) as batch ``batch``; a shared (2-D) precision stays shared."""
    n = g.dim
    P = g.precision if g.precision.ndim == 2 else g.precision.reshape(tuple(batch) + (n, n))
    logZ, alpha, beta = (x.reshape(batch) for x in g._scalars())
    return GammaGaussian(logZ, g.info_vec.reshape(tuple(batch) + (n,)), P, alpha, beta)


def sequential_gamma_gaussian_tensordot_homogeneous(gg: GammaGaussian) -> GammaGaussian:
    """The Markov-chain contraction of a time-homogeneous gamma-Gaussian
    chain: every factor along the trailing batch axis (time) shares one
    precision (``precision.ndim == 2``).  One K5a launch a level for every
    power-of-two block still reducing; the blocks' results are folded left
    to right with ``gamma_gaussian_tensordot``."""
    assert gg.precision.ndim == 2
    two_n = gg.dim
    assert two_n % 2 == 0
    n = two_n // 2
    batch = gg.batch_shape
    T = batch[-1]
    rows = [gg.info_vec.expand(batch + (two_n,)).reshape(-1, T, two_n)]
    rows += [x.expand(batch).reshape(-1, T) for x in gg._scalars()]

    def level(P, info, logZ, alpha, beta):
        P, *rows = gaussian_levels.gamma_halving_level(P, info, logZ, alpha, beta)
        return P, rows, ()

    blocks, _ = _pow2_halvings(gg.precision, rows, level)
    blocks = [GammaGaussian(logZ, info, P, alpha, beta) for P, info, logZ, alpha, beta in blocks]
    result = blocks[0]
    for g in blocks[1:]:
        result = gamma_gaussian_tensordot(result, g, dims=n)
    return _unflatten(result, batch[:-1])


def sequential_gamma_gaussian_tensordot(gg: GammaGaussian) -> GammaGaussian:
    """Integrate a Markov product of T gamma-Gaussian factors (batch
    ``(..., T)``, dim 2n over (previous, next) state) over the interior
    states: pairwise halving, one K5b launch a level, depth ceil(log2 T)."""
    assert gg.dim % 2 == 0
    two_n = gg.dim
    batch = gg.batch_shape
    g = gg.expand(batch)  # views: K5b reads a broadcast factor in place
    P, info = g.precision, g.info_vec
    logZ, alpha, beta = g._scalars()
    while P.shape[-3] > 1:
        P, info, logZ, alpha, beta = gaussian_levels.gamma_contract_pairs(P, info, logZ, alpha, beta)
    return GammaGaussian(logZ[..., 0], info[..., 0, :], P[..., 0, :, :], alpha[..., 0], beta[..., 0])
