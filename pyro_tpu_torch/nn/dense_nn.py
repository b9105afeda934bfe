"""Dense conditioner networks (counterpart of ``pyro_tpu/nn/dense_nn.py``;
ref ``pyro/nn/dense_nn.py``).

``layers.{i}`` is the JAX package's flax layer ``Dense_{i}``: the hidden
layers in order, then the output layer.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..settings import get_default_device


def _split(out, param_dims):
    """The output's last dim cut into ``param_dims`` pieces (one: as is)."""
    if len(param_dims) == 1:
        return out
    return tuple(out.split(list(param_dims), dim=-1))


class DenseNN(nn.Module):
    """MLP with relu hidden layers emitting ``param_dims`` outputs."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], param_dims: Sequence[int] = (1, 1)):
        super().__init__()
        self.param_dims = tuple(param_dims)
        widths = [input_dim, *hidden_dims, sum(self.param_dims)]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return _split(self.layers[-1](x), self.param_dims)


class ConditionalDenseNN(DenseNN):
    """MLP on ``[x, context]`` (the context broadcast over x's batch dims)."""

    def __init__(
        self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], param_dims: Sequence[int] = (1, 1)
    ):
        super().__init__(input_dim + context_dim, hidden_dims, param_dims)

    def forward(self, x, context):
        context = context.expand(x.shape[:-1] + context.shape[-1:])
        return super().forward(torch.cat([x, context], dim=-1))


class MaskedLinear:
    """Linear layer whose weight is masked elementwise; its weight and bias
    are param-store sites ``{name}.weight`` and ``{name}.bias``, drawn
    U(-1/sqrt(in), 1/sqrt(in)) with numpy from a seed made of ``name``."""

    def __init__(self, name, in_features, out_features, mask, bias=True):
        self.name = name
        self.mask = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=get_default_device())
        assert self.mask.shape == (out_features, in_features)
        rs = np.random.RandomState(zlib.crc32(name.encode()) % (2**31))
        bound = 1.0 / np.sqrt(in_features)
        self._w_init = torch.tensor(rs.uniform(-bound, bound, (out_features, in_features)), dtype=torch.float32)
        self._b_init = (
            torch.tensor(rs.uniform(-bound, bound, (out_features,)), dtype=torch.float32) if bias else None
        )

    def __call__(self, x):
        from ..primitives import param

        out = x @ (param(f"{self.name}.weight", self._w_init) * self.mask).T
        if self._b_init is not None:
            out = out + param(f"{self.name}.bias", self._b_init)
        return out
