"""Batched linear algebra for the small matrices of the Gaussian algebra
(counterpart of ``pyro_tpu/ops/linalg_small.py``).

The JAX package unrolls these over the columns, a workaround for XLA's
blocked algorithms on the TPU.  Here they are PyTorch's own batched
routines.  They serve the plain path and the few small calls outside the
halving levels of ``ops/gaussian_levels.py`` (the block joins, the final
contraction with the initial state, the endpoint draws), whose kernels
factorise their matrices themselves.  Batch dims broadcast.  The
factorisation does not check for positive definiteness (no host sync): a
matrix that is not positive definite gives a factor that is not finite, as
the JAX version gives NaN.
"""

from __future__ import annotations

import torch


def _bcast(L, B):
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    return L.expand(batch + L.shape[-2:]), B.expand(batch + B.shape[-2:])


def cholesky(A):
    """Batched lower Cholesky factor."""
    return torch.linalg.cholesky_ex(A).L


def solve_lower(L, B):
    """Solve L x = B (L lower-triangular, B (..., n, m))."""
    L, B = _bcast(L, B)
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_lower_t(L, B):
    """Solve L^T x = B."""
    L, B = _bcast(L, B)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)


def cholesky_solve(L, B):
    """Solve (L L^T) x = B given the lower Cholesky factor."""
    return solve_lower_t(L, solve_lower(L, B))
