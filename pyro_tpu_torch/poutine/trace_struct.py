"""Execution trace: an ordered map of site messages
(counterpart of ``pyro_tpu/poutine/trace_struct.py``)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator

from ..distributions.util import scale_and_mask


class Trace:
    def __init__(self) -> None:
        self.nodes: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __iter__(self) -> Iterator[str]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, name: str) -> Dict[str, Any]:
        return self.nodes[name]

    def add_node(self, site_name: str, **kwargs: Any) -> None:
        if site_name in self.nodes and kwargs["type"] != "param":
            raise RuntimeError(f"Multiple {kwargs['type']} sites named '{site_name}'")
        self.nodes[site_name] = kwargs

    def copy(self) -> "Trace":
        new = Trace()
        new.nodes = OrderedDict((name, dict(site)) for name, site in self.nodes.items())
        return new

    def compute_log_prob(self, site_filter=lambda name, site: True) -> None:
        """Scaled and masked ``log_prob`` at each sample site, with the raw
        ``unscaled_log_prob`` and the sum ``log_prob_sum``."""
        for name, site in self.nodes.items():
            if site["type"] == "sample" and site_filter(name, site) and "log_prob" not in site:
                lp = site["fn"].log_prob(site["value"], *site["args"])
                site["unscaled_log_prob"] = lp
                lp = scale_and_mask(lp, site["scale"], site["mask"])
                site["log_prob"] = lp
                site["log_prob_sum"] = lp.sum()

    def compute_score_parts(self) -> None:
        """The surrogate-gradient decomposition at each sample site."""
        for name, site in self.nodes.items():
            if site["type"] == "sample" and "score_parts" not in site:
                parts = site["fn"].score_parts(site["value"], *site["args"])
                site["unscaled_log_prob"] = parts.log_prob
                parts = parts.scale_and_mask(site["scale"], site["mask"])
                site["score_parts"] = parts
                site["log_prob"] = parts.log_prob
                site["log_prob_sum"] = parts.log_prob.sum()

    def param_nodes(self):
        return [n for n, s in self.nodes.items() if s["type"] == "param"]
