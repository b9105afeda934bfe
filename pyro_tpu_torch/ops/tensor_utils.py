"""Tensor utilities (the part of ``pyro_tpu/ops/tensor_utils.py`` this
package uses): ``block_diag_embed``."""

from __future__ import annotations

import torch


def block_diag_embed(mat):
    """(..., B, M, N) -> (..., B*M, B*N), the B blocks on the diagonal.
    One product with the identity, so gradients reach every block."""
    B, M, N = mat.shape[-3:]
    eye = torch.eye(B, dtype=mat.dtype, device=mat.device)
    out = mat.unsqueeze(-2) * eye.reshape(B, 1, B, 1)  # (..., B, M, B, N)
    return out.reshape(mat.shape[:-3] + (B * M, B * N))
