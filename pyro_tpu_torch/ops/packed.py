"""Packed named-dim tensors for the enumeration engine (counterpart of
``pyro_tpu/ops/packed.py``).

A ``PackedTensor`` pairs a tensor with its dims string, one single-character
symbol per axis, rightmost axis last.  Size-1 axes are squeezed on packing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class PackedTensor:
    """A tensor whose every axis is named by a single-character symbol."""

    __slots__ = ("value", "dims")

    def __init__(self, value, dims: str):
        assert value.ndim == len(dims), (tuple(value.shape), dims)
        self.value = value
        self.dims = dims

    @property
    def shape(self):
        return tuple(self.value.shape)

    def size(self, dim_symbol: str) -> int:
        return self.shape[self.dims.index(dim_symbol)]

    def __repr__(self):
        return f"PackedTensor(dims='{self.dims}', shape={self.shape})"

    # identity hashing, so that packed tensors can key dicts
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def pack(value, dim_to_symbol: Dict[int, str]) -> PackedTensor:
    """A broadcast-shaped tensor as a packed one: size-1 dims squeezed, the
    rest named."""
    shape = value.shape
    dims = []
    keep = []
    for i, size in enumerate(shape):
        d = i - len(shape)  # negative dim
        if size == 1:
            continue
        if d not in dim_to_symbol:
            raise ValueError(
                f"invalid shape {tuple(shape)}: dim {d} (size {size}) is not allocated to a plate or "
                "enum site; try wrapping batched dims in a plate or using .to_event()"
            )
        dims.append(dim_to_symbol[d])
        keep.append(size)
    return PackedTensor(value.reshape(keep), "".join(dims))


def unpack(packed: PackedTensor, symbol_to_dim: Dict[str, int]):
    """A packed tensor expanded back to broadcast shape."""
    if not packed.dims:
        return packed.value
    min_dim = min(symbol_to_dim[d] for d in packed.dims)
    shape = [1] * (-min_dim)
    for d, size in zip(packed.dims, packed.shape):
        shape[symbol_to_dim[d]] = size
    order = sorted(range(len(packed.dims)), key=lambda i: symbol_to_dim[packed.dims[i]])
    return packed.value.permute(order).reshape(shape)


def broadcast_all(*parts: PackedTensor):
    """Align packed tensors to the sorted union of their dims (size 1 where
    a tensor lacks a dim)."""
    sizes: Dict[str, int] = {}
    for p in parts:
        sizes.update(zip(p.dims, p.shape))
    dims = "".join(sorted(sizes))
    return tuple(align(p, dims) for p in parts)


def align(p: PackedTensor, target_dims: str) -> PackedTensor:
    """Permute and reshape (never tile) to exactly ``target_dims``, size 1
    on the dims ``p`` lacks."""
    assert set(p.dims) <= set(target_dims), (p.dims, target_dims)
    order = sorted(range(len(p.dims)), key=lambda i: target_dims.index(p.dims[i]))
    value = p.value.permute(order) if order != list(range(len(order))) else p.value
    sizes = dict(zip(p.dims, p.shape))
    shape = [sizes.get(d, 1) for d in target_dims]
    return PackedTensor(value.reshape(shape), target_dims)


def neg(p: PackedTensor) -> PackedTensor:
    return PackedTensor(-p.value, p.dims)


def scale_and_mask(p: PackedTensor, scale=1.0, mask: Optional[PackedTensor] = None) -> PackedTensor:
    """Scale the log factor and zero it where ``mask`` is False."""
    if isinstance(scale, (int, float)) and scale == 1 and mask is None:
        return p
    if mask is None:
        return PackedTensor(p.value * scale, p.dims)
    m, v = broadcast_all(mask, p)
    return PackedTensor(torch.where(m.value, v.value * scale, 0.0), v.dims)


def gather(p: PackedTensor, index: PackedTensor, dim_symbol: str) -> PackedTensor:
    """Select along the named dim ``dim_symbol`` of ``p`` with a packed
    index tensor; size-1 dims of the result are squeezed."""
    target_dims = "".join(sorted(set(p.dims + index.dims) - {dim_symbol}))
    pv = align(p, dim_symbol + target_dims).value
    iv = align(index, target_dims).value.long()
    shape = torch.broadcast_shapes(pv.shape[1:], iv.shape)
    out = torch.gather(pv.expand((pv.shape[0],) + shape), 0, iv.expand(shape)[None])[0]
    keep = [(d, n) for d, n in zip(target_dims, out.shape) if n != 1]
    return PackedTensor(out.reshape([n for _, n in keep]), "".join(d for d, _ in keep))
