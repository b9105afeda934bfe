"""Recurrent conditioner networks (counterpart of
``pyro_tpu/nn/recurrent.py``): a multi-layer RNN, GRU or LSTM over a
batch-first sequence, and a single-step GRU cell.

The design follows the JAX package's.  For each layer the input projection
over all T steps is one ``addmm`` before the loop, so each step does only
the recurrent product ``h @ W_hh^T`` and its gates.  A masked step carries
the state through unchanged, and ``reverse=True`` runs right to left with
the outputs kept at the input's time index, so ``out[:, t]`` summarises
``x[:, t:]``.  The same loop runs on the CPU and the card.

Weight layout and gate order are torch's (``w_ih_l{l}: (G*H, I)``,
``w_hh_l{l}: (G*H, H)``; GRU gates r, z, n; LSTM gates i, f, g, o; init
U(-1/sqrt(H), 1/sqrt(H))), as in the JAX package, so weights carry across
under the same names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_GATES = {"relu": 1, "tanh": 1, "gru": 3, "lstm": 4}


def _uniform(shape, scale):
    return nn.Parameter(torch.empty(shape).uniform_(-scale, scale))


def _gru(xg, hp, h):
    """GRU gates r, z, n from the input projection ``xg`` and the recurrent
    one ``hp``; returns the next hidden state."""
    xr, xz, xn = xg.chunk(3, -1)
    hr, hz, hn = hp.chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


class RNN(nn.Module):
    """Multi-layer recurrent network over a batch-first sequence.

    Args:
        input_size: I, the last dim of the input.
        features: hidden size H.
        cell: ``"relu"``/``"tanh"`` (Elman), ``"gru"`` or ``"lstm"``.
        num_layers: stacked layers (layer l reads layer l-1's outputs).
        reverse: run right to left; outputs stay at the input's time index.

    Call: ``rnn(x, h0=None, mask=None)`` with ``x: (B, T, I)``, optional
    ``h0: (num_layers, B, H)`` (or an ``(h0, c0)`` tuple for LSTM) and
    optional boolean ``mask: (B, T)``.  Returns ``(outputs (B, T, H),
    final_state)``, the final state ``(num_layers, B, H)`` (a tuple of two
    for LSTM).
    """

    def __init__(self, input_size: int, features: int, cell: str = "gru", num_layers: int = 1, reverse: bool = False):
        super().__init__()
        if cell not in _GATES:
            raise ValueError(f"unknown cell {cell!r}")
        self.features, self.cell, self.num_layers, self.reverse = features, cell, num_layers, reverse
        G, H, k = _GATES[cell], features, 1.0 / math.sqrt(features)
        for layer in range(num_layers):
            width = input_size if layer == 0 else H
            setattr(self, f"w_ih_l{layer}", _uniform((G * H, width), k))
            setattr(self, f"w_hh_l{layer}", _uniform((G * H, H), k))
            setattr(self, f"b_ih_l{layer}", _uniform((G * H,), k))
            setattr(self, f"b_hh_l{layer}", _uniform((G * H,), k))

    def _step(self, xg, hp, h_prev, c_prev):
        """One step's gates: ``xg`` the input projection, ``hp`` the recurrent one."""
        if self.cell == "relu":
            return torch.relu(xg + hp), c_prev
        if self.cell == "tanh":
            return torch.tanh(xg + hp), c_prev
        if self.cell == "gru":
            return _gru(xg, hp, h_prev), c_prev
        xi, xf, xg_, xo = xg.chunk(4, -1)
        hi, hf, hg, ho = hp.chunk(4, -1)
        c = torch.sigmoid(xf + hf) * c_prev + torch.sigmoid(xi + hi) * torch.tanh(xg_ + hg)
        return torch.sigmoid(xo + ho) * torch.tanh(c), c

    def forward(self, x: torch.Tensor, h0=None, mask: Optional[torch.Tensor] = None):
        B, T, _ = x.shape
        H = self.features
        is_lstm = self.cell == "lstm"
        zeros = x.new_zeros((B, H))
        if h0 is None:
            h_layers, c_layers = [zeros] * self.num_layers, [zeros] * self.num_layers
        elif is_lstm and isinstance(h0, tuple):
            h_layers, c_layers = list(h0[0]), list(h0[1])
        else:
            h_layers, c_layers = list(h0), [zeros] * self.num_layers
        if mask is not None:
            mask = mask[..., None]  # (B, T, 1)
        steps = range(T - 1, -1, -1) if self.reverse else range(T)

        out = x
        finals_h, finals_c = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh = getattr(self, f"w_ih_l{layer}"), getattr(self, f"w_hh_l{layer}")
            b_ih, b_hh = getattr(self, f"b_ih_l{layer}"), getattr(self, f"b_hh_l{layer}")
            I = out.shape[-1]
            # the input projection over all T steps, one product
            xp = torch.addmm(b_ih, out.reshape(B * T, I), w_ih.t()).reshape(B, T, -1)
            h, c = h_layers[layer].expand(B, H), c_layers[layer].expand(B, H)
            ys = [None] * T
            for t in steps:
                h_new, c_new = self._step(xp[:, t], torch.addmm(b_hh, h, w_hh.t()), h, c)
                if mask is not None:
                    h_new = torch.where(mask[:, t], h_new, h)
                    c_new = torch.where(mask[:, t], c_new, c)
                h, c = h_new, c_new
                ys[t] = h
            finals_h.append(h)
            finals_c.append(c)
            out = torch.stack(ys, dim=1)

        final_h = torch.stack(finals_h)
        if is_lstm:
            return out, (final_h, torch.stack(finals_c))
        return out, final_h


class GRUCell(nn.Module):
    """Single-step GRU cell (torch ``nn.GRUCell`` layout and gate order):
    ``cell(h, x)`` returns the next hidden state."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        H, k = features, 1.0 / math.sqrt(features)
        self.features = features
        self.w_ih = _uniform((3 * H, input_size), k)
        self.w_hh = _uniform((3 * H, H), k)
        self.b_ih = _uniform((3 * H,), k)
        self.b_hh = _uniform((3 * H,), k)

    def forward(self, h, x):
        linear = torch.nn.functional.linear
        return _gru(linear(x, self.w_ih, self.b_ih), linear(h, self.w_hh, self.b_hh), h)


__all__ = ["RNN", "GRUCell"]
