"""Mergeable streaming statistics in O(1) memory (counterpart of
``pyro_tpu/ops/streaming.py``): ``update(sample)``, ``merge(other)`` and
``get()``."""

from __future__ import annotations

from typing import Callable, Dict, Hashable

import torch


class StreamingStats:
    def update(self, sample) -> None:
        raise NotImplementedError

    def merge(self, other: "StreamingStats") -> "StreamingStats":
        raise NotImplementedError

    def get(self):
        raise NotImplementedError


class CountStats(StreamingStats):
    def __init__(self):
        self.count = 0

    def update(self, sample) -> None:
        self.count += 1

    def merge(self, other):
        out = CountStats()
        out.count = self.count + other.count
        return out

    def get(self):
        return {"count": self.count}


class CountMeanStats(StreamingStats):
    def __init__(self):
        self.count = 0
        self.mean = 0.0

    def update(self, sample) -> None:
        self.count += 1
        self.mean = self.mean + (sample - self.mean) / self.count

    def merge(self, other):
        out = CountMeanStats()
        out.count = self.count + other.count
        if out.count:
            out.mean = (self.count * self.mean + other.count * other.mean) / out.count
        return out

    def get(self):
        return {"count": self.count, "mean": self.mean}


class CountMeanVarianceStats(StreamingStats):
    """Welford's update, and Chan's merge of two accumulators."""

    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, sample) -> None:
        self.count += 1
        delta = sample - self.mean
        self.mean = self.mean + delta / self.count
        self.m2 = self.m2 + delta * (sample - self.mean)

    def merge(self, other):
        out = CountMeanVarianceStats()
        out.count = self.count + other.count
        if out.count == 0:
            return out
        delta = other.mean - self.mean
        out.mean = (self.count * self.mean + other.count * other.mean) / out.count
        out.m2 = self.m2 + other.m2 + delta ** 2 * self.count * other.count / out.count
        return out

    def get(self):
        var = self.m2 / (self.count - 1) if self.count > 1 else torch.zeros_like(torch.as_tensor(self.m2))
        return {"count": self.count, "mean": self.mean, "variance": var}


class StatsOfDict(StreamingStats):
    """Statistics of each key of dict-valued samples: ``types[key]()``, else
    ``default()``."""

    def __init__(self, types: Dict[Hashable, Callable] = None, default: Callable = CountMeanVarianceStats):
        self.stats: Dict[Hashable, StreamingStats] = {k: t() for k, t in (types or {}).items()}
        self.default = default

    def update(self, sample: Dict) -> None:
        for k, v in sample.items():
            if k not in self.stats:
                self.stats[k] = self.default()
            self.stats[k].update(v)

    def merge(self, other):
        out = StatsOfDict(default=self.default)
        for k in set(self.stats) | set(other.stats):
            if k in self.stats and k in other.stats:
                out.stats[k] = self.stats[k].merge(other.stats[k])
            else:
                out.stats[k] = self.stats.get(k) or other.stats[k]
        return out

    def get(self):
        return {k: v.get() for k, v in self.stats.items()}


class StackStats(StreamingStats):
    """Keeps every sample."""

    def __init__(self):
        self.samples = []

    def update(self, sample) -> None:
        self.samples.append(sample)

    def merge(self, other):
        out = StackStats()
        out.samples = self.samples + other.samples
        return out

    def get(self):
        return {"count": len(self.samples), "samples": torch.stack(self.samples) if self.samples else None}
