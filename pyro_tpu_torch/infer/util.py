"""Inference utilities (counterpart of ``pyro_tpu/infer/util.py``)."""

from __future__ import annotations


class MultiFrameTensor(dict):
    """Log-prob tensors on different plate-frame sets, summed down to a
    target frame set: a downstream cost on frames F is summed over the dims
    it does not share with the target before it multiplies a score term."""

    def __init__(self, *items):
        super().__init__()
        self.add(*items)

    def add(self, *items) -> None:
        for cond_indep_stack, value in items:
            frames = frozenset(f for f in cond_indep_stack if f.dim is not None)
            self[frames] = self[frames] + value if frames in self else value

    def sum_to(self, target_frames):
        target_frames = frozenset(f for f in target_frames if f.dim is not None)
        total = None
        for frames, value in self.items():
            for f in frames - target_frames:
                if value.ndim >= -f.dim and value.shape[f.dim] != 1:
                    value = value.sum(dim=f.dim, keepdim=True)
            while value.ndim and value.shape[0] == 1:
                value = value.squeeze(0)
            total = value if total is None else total + value
        return total
