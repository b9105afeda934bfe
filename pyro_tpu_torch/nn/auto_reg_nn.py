"""Autoregressive conditioner networks, MADE (counterpart of
``pyro_tpu/nn/auto_reg_nn.py``; ref ``pyro/nn/auto_reg_nn.py``, Germain
et al. 2015).

The masks are the JAX package's, hidden degrees included
(``arange(h) % max(1, D - 1) + 1``, not upstream Pyro's), so weights carried
across give the same outputs.  ``hidden_layers.{i}`` is the JAX module's
``hidden_layers_{i}`` and ``output_layer`` its ``output_layer``; a weight is
stored (out, in), the transpose of the flax kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def create_mask(input_dim, context_dim, hidden_dims, permutation, output_multiplier):
    """MADE masks: one (h, in) mask a hidden layer and the output mask."""
    input_degrees = np.asarray(permutation) + 1  # 1..D
    hidden_degrees = [(np.arange(h) % max(1, input_dim - 1)) + 1 for h in hidden_dims]
    masks = []
    prev_deg = np.concatenate([np.zeros(context_dim, dtype=int), input_degrees])
    for deg in hidden_degrees:
        masks.append((deg[:, None] >= prev_deg[None, :]).astype(np.float32))
        prev_deg = deg
    out_deg = np.tile(input_degrees, output_multiplier)
    mask_out = (out_deg[:, None] > prev_deg[None, :]).astype(np.float32)
    return masks, mask_out


class MaskedLinear(nn.Module):
    """``x @ (weight * mask)^T + bias``; the weight drawn as flax's
    lecun_normal (a normal of variance 1/in truncated at two deviations),
    the bias zero."""

    def __init__(self, in_features: int, out_features: int, mask):
        super().__init__()
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        self.weight = nn.Parameter(nn.init.trunc_normal_(torch.empty(out_features, in_features), 0.0, std, -2 * std, 2 * std))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask), dtype=torch.float32))

    def forward(self, x):
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), (self.weight * self.mask).t()).reshape(
            x.shape[:-1] + (-1,)
        )


class AutoRegressiveNN(nn.Module):
    """MADE producing ``param_dims`` outputs per input dim: a tuple of
    (..., D) tensors (a piece of width > 1 is (..., width, D))."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int],
        param_dims: Sequence[int] = (1, 1),
        permutation: Optional[Sequence[int]] = None,
        context_dim: int = 0,
    ):
        super().__init__()
        self.input_dim, self.param_dims = input_dim, tuple(param_dims)
        self.output_multiplier = sum(self.param_dims)
        perm = np.arange(input_dim) if permutation is None else np.asarray(permutation)
        masks, mask_out = create_mask(input_dim, context_dim, hidden_dims, perm, self.output_multiplier)
        widths = [input_dim + context_dim, *hidden_dims]
        self.hidden_layers = nn.ModuleList(MaskedLinear(a, b, m) for a, b, m in zip(widths[:-1], widths[1:], masks))
        self.output_layer = MaskedLinear(widths[-1], input_dim * self.output_multiplier, mask_out)

    def forward(self, x, context=None):
        h = x if context is None else torch.cat([context.expand(x.shape[:-1] + context.shape[-1:]), x], dim=-1)
        for layer in self.hidden_layers:
            h = torch.relu(layer(h))
        out = self.output_layer(h)
        if self.output_multiplier == 1:
            return out
        out = out.reshape(out.shape[:-1] + (self.output_multiplier, self.input_dim))
        outs, start = [], 0
        for pd in self.param_dims:
            outs.append(out[..., start, :] if pd == 1 else out[..., start : start + pd, :])
            start += pd
        return tuple(outs) if len(outs) > 1 else outs[0]


class ConditionalAutoRegressiveNN(AutoRegressiveNN):
    """MADE with a conditioning context, put in front of x."""

    def forward(self, x, context):
        return super().forward(x, context=context)
