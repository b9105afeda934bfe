"""Symmetric arrowhead matrices for structured HMC mass matrices
(counterpart of ``pyro_tpu/ops/arrowhead.py``): a dense ``head_size x N``
top block and a diagonal tail, so that products and square roots cost
O(N head_size^2) where a dense matrix costs O(N^3).

A failed Cholesky factor of the Schur complement is retried with the
tail's coupling halved, up to five times, as the JAX package does: the
first factor that is finite wins.
"""

from __future__ import annotations

from collections import namedtuple

import torch

SymmArrowhead = namedtuple("SymmArrowhead", ["top", "bottom_diag"])
TriuArrowhead = namedtuple("TriuArrowhead", ["top", "bottom_diag"])


def _upper_cholesky(a):
    """The upper-triangular U with U U^T = a (the flipped lower factor of
    the flipped matrix); NaN where the factorisation fails."""
    flipped = torch.flip(a, (-2, -1))
    factor, info = torch.linalg.cholesky_ex(flipped)
    factor = torch.where(info[..., None, None] == 0, factor, torch.nan)
    return torch.flip(factor, (-2, -1))


def sqrt(x: SymmArrowhead) -> TriuArrowhead:
    """The upper-triangular square root of a symmetric arrowhead matrix."""
    assert isinstance(x, SymmArrowhead)
    head_size = x.top.shape[0]
    if head_size == 0:
        return TriuArrowhead(x.top, torch.sqrt(x.bottom_diag))

    A, B = x.top[:, :head_size], x.top[:, head_size:]
    Dsqrt = torch.sqrt(x.bottom_diag)
    top_left = B_kept = ok_so_far = None
    for _ in range(6):
        B_Dsqrt = B / Dsqrt[None, :]
        candidate = _upper_cholesky(A - B_Dsqrt @ B_Dsqrt.T)
        ok = torch.isfinite(candidate).all()
        if top_left is None:
            top_left, B_kept, ok_so_far = candidate, B_Dsqrt, ok
        else:
            top_left = torch.where(ok_so_far, top_left, candidate)
            B_kept = torch.where(ok_so_far, B_kept, B_Dsqrt)
            ok_so_far = ok_so_far | ok
        B = B / 2
    return TriuArrowhead(torch.cat([top_left, B_kept], -1), Dsqrt)


def triu_inverse(x: TriuArrowhead) -> TriuArrowhead:
    """The inverse of an upper-triangular arrowhead matrix."""
    assert isinstance(x, TriuArrowhead)
    head_size = x.top.shape[0]
    if head_size == 0:
        return TriuArrowhead(x.top, 1.0 / x.bottom_diag)

    A, B = x.top[:, :head_size], x.top[:, head_size:]
    B_Dinv = B / x.bottom_diag[None, :]
    identity = torch.eye(head_size, dtype=A.dtype, device=A.device)
    top_left = torch.linalg.solve_triangular(A, identity, upper=True)
    top_right = -top_left @ B_Dinv
    return TriuArrowhead(torch.cat([top_left, top_right], -1), 1.0 / x.bottom_diag)


def triu_matvecmul(x: TriuArrowhead, y, transpose: bool = False):
    """x @ y (or x^T @ y) for an upper-triangular arrowhead x, O(N head_size)."""
    assert isinstance(x, TriuArrowhead)
    head_size = x.top.shape[0]
    if transpose:
        z = x.top.T @ y[:head_size]
        top = z[:head_size]
        bottom = z[head_size:] + x.bottom_diag * y[head_size:]
    else:
        top = x.top @ y
        bottom = x.bottom_diag * y[head_size:]
    return torch.cat([top, bottom], 0)


def triu_gram(x: TriuArrowhead):
    """The Gram matrix x^T @ x of an upper-triangular arrowhead x."""
    assert isinstance(x, TriuArrowhead)
    head_size = x.top.shape[0]
    if head_size == 0:
        return x.bottom_diag ** 2

    A, B = x.top[:, :head_size], x.top[:, head_size:]
    top = A.T @ x.top
    bottom_left = top[:, head_size:].T
    bottom_right = B.T @ B + torch.diag(x.bottom_diag ** 2)
    return torch.cat([top, torch.cat([bottom_left, bottom_right], -1)], 0)
