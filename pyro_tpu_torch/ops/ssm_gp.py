"""State-space forms of the Matern kernels (counterpart of
``pyro_tpu/ops/ssm_gp.py``).

A Matern-nu GP over one time axis is a linear-Gaussian SSM of dim nu + 1/2;
``MaternKernel`` gives its transition matrix exp(F dt) over a step ``dt``,
the process covariance of that step and the stationary covariance, for nu
0.5, 1.5 and 2.5.  Each matrix is stacked from its entries (no write into
a leaf), so autograd reaches ``length_scale`` and ``kernel_scale``.
"""

from __future__ import annotations

import math

import torch


def _matrix(rows):
    """A (..., k, k) tensor from k rows of k (...)-shaped entries."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


class MaternKernel:
    """nu in {0.5, 1.5, 2.5}; ``length_scale`` and ``kernel_scale`` are
    (num_gps,) tensors, the matrices (num_gps, state_dim, state_dim), in the
    column convention z' = A z."""

    def __init__(self, nu: float, num_gps: int, length_scale_init=None, kernel_scale_init=None):
        assert nu in (0.5, 1.5, 2.5)
        self.nu = nu
        self.num_gps = num_gps
        self.state_dim = {0.5: 1, 1.5: 2, 2.5: 3}[nu]
        self.length_scale_init = torch.ones(num_gps) if length_scale_init is None else length_scale_init
        self.kernel_scale_init = torch.ones(num_gps) if kernel_scale_init is None else kernel_scale_init

    def stationary_covariance(self, length_scale, kernel_scale):
        s2 = kernel_scale**2
        if self.nu == 0.5:
            return s2[:, None, None]
        zero = torch.zeros_like(s2)
        if self.nu == 1.5:
            lam = math.sqrt(3.0) / length_scale
            return _matrix([[s2, zero], [zero, s2 * lam**2]])
        lam = math.sqrt(5.0) / length_scale
        off = -s2 * lam**2 / 3.0
        return _matrix([[s2, zero, off], [zero, s2 * lam**2 / 3.0, zero], [off, zero, s2 * lam**4]])

    def transition_matrix(self, length_scale, dt):
        """exp(F dt) per GP."""
        if self.nu == 0.5:
            lam = 1.0 / length_scale
            return torch.exp(-lam * dt)[:, None, None]
        if self.nu == 1.5:
            lam = math.sqrt(3.0) / length_scale
            e = torch.exp(-lam * dt)
            return _matrix([[e * (1 + lam * dt), e * dt], [-e * lam**2 * dt, e * (1 - lam * dt)]])
        lam = math.sqrt(5.0) / length_scale
        e = torch.exp(-lam * dt)
        ld = lam * dt
        return _matrix([
            [e * (1 + ld + 0.5 * ld**2), e * dt * (1 + ld), e * 0.5 * dt**2],
            [e * (-0.5 * lam**3 * dt**2), e * (1 + ld - ld**2), e * dt * (1 - 0.5 * ld)],
            [e * (0.5 * lam**4 * dt**2 - lam**3 * dt), e * (lam**3 * dt**2 - 3 * lam**2 * dt),
             e * (1 - 2 * ld + 0.5 * ld**2)],
        ])

    def transition_matrix_and_covariance(self, length_scale, kernel_scale, dt):
        """(A, Q) with Q = P - A P A^T (stationarity), symmetrised, plus
        1e-6 I."""
        A = self.transition_matrix(length_scale, dt)
        P = self.stationary_covariance(length_scale, kernel_scale)
        Q = P - A @ P @ A.transpose(-1, -2)
        Q = 0.5 * (Q + Q.transpose(-1, -2))
        return A, Q + 1e-6 * torch.eye(self.state_dim, dtype=Q.dtype, device=Q.device)
