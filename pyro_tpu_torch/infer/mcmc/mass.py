"""Structured mass matrices with Welford adaptation, on flat vectors
(counterpart of ``pyro_tpu/infer/mcmc/mass.py``): ``BlockMassMatrix``, a
dense or diagonal inverse mass matrix adapted from the positions'
covariance, and ``ArrowheadMassMatrix``, a dense head over the first
``head_size`` coordinates with a diagonal tail, adapted from the
gradients' covariance (which approximates the precision of z, the mass
matrix itself), with its algebra in O(N head_size^2) through
``ops/arrowhead.py``.
"""

from __future__ import annotations

import torch

from ...ops.arrowhead import SymmArrowhead
from ...ops.arrowhead import sqrt as arrowhead_sqrt
from ...ops.arrowhead import triu_gram, triu_inverse, triu_matvecmul
from ...ops.welford import welford_covariance, welford_init, welford_update
from ...settings import get_default_device


class BlockMassMatrix:
    """A dense or diagonal inverse mass matrix, adapted by Welford."""

    def __init__(self, init_scale: float = 1.0):
        self._init_scale = init_scale
        self._adapt_scheme = None
        self.inverse_mass_matrix = None
        self._sqrt = None  # M^{1/2}, upper triangular where dense
        self._sqrt_inverse = None  # M^{-1/2}

    def configure(self, size: int, diagonal: bool = True, adapt_mass_matrix: bool = True):
        device = get_default_device()
        init = (torch.full((size,), self._init_scale, device=device) if diagonal
                else torch.eye(size, device=device) * self._init_scale)
        self._set_inverse_mass_matrix(init)
        if adapt_mass_matrix:
            self._adapt_scheme = welford_init(size, diagonal=diagonal, device=device)

    def _set_inverse_mass_matrix(self, inv_m):
        self.inverse_mass_matrix = inv_m
        if inv_m.ndim == 1:
            self._sqrt = 1.0 / torch.sqrt(inv_m)
            self._sqrt_inverse = torch.sqrt(inv_m)
        else:
            sqrt_inv = torch.linalg.cholesky(inv_m).T  # upper
            self._sqrt_inverse = sqrt_inv
            self._sqrt = torch.linalg.inv(sqrt_inv)

    def update(self, z_flat, z_grad_flat=None):
        self._adapt_scheme = welford_update(self._adapt_scheme, z_flat)

    def end_adaptation(self):
        self._set_inverse_mass_matrix(welford_covariance(self._adapt_scheme, regularize=True))

    def kinetic_grad(self, r_flat):
        if self.inverse_mass_matrix.ndim == 1:
            return self.inverse_mass_matrix * r_flat
        return self.inverse_mass_matrix @ r_flat

    def scale(self, r_unscaled):
        """M^{1/2} @ r_unscaled."""
        if self.inverse_mass_matrix.ndim == 1:
            return self._sqrt * r_unscaled
        return self._sqrt @ r_unscaled

    def unscale(self, r_flat):
        """M^{-1/2} @ r."""
        if self.inverse_mass_matrix.ndim == 1:
            return self._sqrt_inverse * r_flat
        return self._sqrt_inverse @ r_flat


class ArrowheadMassMatrix:
    """An arrowhead mass matrix: dense over the first ``head_size``
    coordinates, diagonal over the rest."""

    def __init__(self, init_scale: float = 1.0, head_size: int = 0):
        self._init_scale = init_scale
        self.head_size = head_size
        self._adapt_head = self._adapt_all = None
        self._sqrt = None
        self._sqrt_inverse = None

    def configure(self, size: int, adapt_mass_matrix: bool = True):
        device = get_default_device()
        self._size = size
        head = self.head_size
        top = torch.cat([torch.eye(head, device=device) / self._init_scale, torch.zeros(head, size - head,
                                                                                       device=device)], -1)
        bottom = torch.full((size - head,), 1.0 / self._init_scale, device=device)
        self._set_mass_matrix(SymmArrowhead(top, bottom))
        if adapt_mass_matrix:
            # dense statistics over the head block, diagonal over all
            self._adapt_head = welford_init(head, diagonal=False, device=device)
            self._adapt_all = welford_init(size, diagonal=True, device=device)

    def _set_mass_matrix(self, m: SymmArrowhead):
        self.mass_matrix = m
        self._sqrt = arrowhead_sqrt(m)
        self._sqrt_inverse = triu_inverse(self._sqrt)

    @property
    def inverse_mass_matrix(self):
        """The dense inverse, O(N^2 head_size): for tests; the kernel's
        algebra never needs it."""
        return triu_gram(self._sqrt_inverse)

    def update(self, z_flat, z_grad_flat):
        self._adapt_head = welford_update(self._adapt_head, z_grad_flat[: self.head_size])
        self._adapt_all = welford_update(self._adapt_all, z_grad_flat)

    def end_adaptation(self):
        head = self.head_size
        head_cov = welford_covariance(self._adapt_head, regularize=True)
        all_var = welford_covariance(self._adapt_all, regularize=True)
        cross = torch.zeros(head, self._size - head, dtype=head_cov.dtype, device=head_cov.device)
        self._set_mass_matrix(SymmArrowhead(torch.cat([head_cov, cross], -1), all_var[head:]))

    def kinetic_grad(self, r_flat):
        """v = M^{-1} r by two triangular products, O(N head_size)."""
        u = triu_matvecmul(self._sqrt_inverse, r_flat, transpose=False)
        return triu_matvecmul(self._sqrt_inverse, u, transpose=True)

    def scale(self, r_unscaled):
        """M^{1/2} @ r_unscaled."""
        return triu_matvecmul(self._sqrt, r_unscaled, transpose=False)

    def unscale(self, r_flat):
        """M^{-1/2} @ r."""
        return triu_matvecmul(self._sqrt_inverse, r_flat, transpose=False)
