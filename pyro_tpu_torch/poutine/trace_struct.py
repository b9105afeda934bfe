"""Execution trace: an ordered map of site messages
(counterpart of ``pyro_tpu/poutine/trace_struct.py``)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator

from ..distributions.distribution import ExpandedDistribution
from ..distributions.util import is_identically_zero, scale_and_mask

_SYMBOLS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def get_symbol(i: int) -> str:
    """The i-th one-character dim symbol: the 52 letters, then ``chr(i + 140)``
    (``opt_einsum.get_symbol``'s table below the surrogate range)."""
    if i < 52:
        return _SYMBOLS[i]
    if i + 140 >= 0xD800:
        raise ValueError(f"too many dim symbols: {i}")
    return chr(i + 140)


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
        ``unscaled_log_prob`` and the sum ``log_prob_sum``.

        A model-enumerated site under a lazy plate broadcast keeps its factor
        compact (size-1 plate axes, squeezed when packed): the packed
        elimination knows each factor's plates, so a factor constant over a
        plate is never materialised at the plate's size."""
        for name, site in self.nodes.items():
            if site["type"] == "sample" and site_filter(name, site) and "log_prob" not in site:
                fn = site["fn"]
                if (
                    isinstance(fn, ExpandedDistribution)
                    and site["infer"].get("_enumerate_dim") is not None
                    and not site["is_observed"]
                ):
                    base = fn.base_dist
                    while isinstance(base, ExpandedDistribution):
                        base = base.base_dist
                    lp = base.log_prob(site["value"], *site["args"])
                    rank = max(len(fn.batch_shape), site["value"].ndim - fn.event_dim)
                    if lp.ndim < rank:
                        lp = lp.reshape((1,) * (rank - lp.ndim) + tuple(lp.shape))
                else:
                    lp = fn.log_prob(site["value"], *site["args"])
                site["unscaled_log_prob"] = lp
                lp = scale_and_mask(lp, site["scale"], site["mask"])
                site["log_prob"] = lp
                site["log_prob_sum"] = lp.sum()

    def log_prob_sum(self, site_filter=lambda name, site: True):
        """The trace's total log density over the sample sites
        ``site_filter`` selects, scaled and masked."""
        result = 0.0
        for name, site in self.nodes.items():
            if site["type"] == "sample" and site_filter(name, site):
                if "log_prob_sum" not in site:
                    lp = scale_and_mask(site["fn"].log_prob(site["value"]), site["scale"], site["mask"])
                    site["log_prob_sum"] = lp.sum()
                result = result + site["log_prob_sum"]
        return result

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

    def symbolize_dims(self, plate_to_symbol=None) -> None:
        """Give every plate and enumeration dim a one-character symbol:
        plates the even symbols, enumeration ids the odd ones."""
        plate_to_symbol = {} if plate_to_symbol is None else plate_to_symbol
        symbol_to_dim = {}
        for site in self.nodes.values():
            if site["type"] != "sample":
                continue
            dim_to_symbol = {}
            for frame in site["cond_indep_stack"]:
                if frame.dim is not None:
                    if frame.name not in plate_to_symbol:
                        plate_to_symbol[frame.name] = get_symbol(2 * len(plate_to_symbol))
                    symbol = plate_to_symbol[frame.name]
                    dim_to_symbol[frame.dim] = symbol
                    symbol_to_dim[symbol] = frame.dim
            for dim, id_ in site["infer"].get("_dim_to_id", {}).items():
                symbol = get_symbol(1 + 2 * id_)
                dim_to_symbol[dim] = symbol
                symbol_to_dim[symbol] = dim
                if dim == site["infer"].get("_enumerate_dim"):
                    site["infer"]["_enumerate_symbol"] = symbol
            site["infer"]["_dim_to_symbol"] = dim_to_symbol
        self.plate_to_symbol = plate_to_symbol
        self.symbol_to_dim = symbol_to_dim

    def pack_tensors(self, plate_to_symbol=None) -> None:
        """Packed (named-dim) forms of each sample site's log_prob,
        unscaled_log_prob, score parts and mask, in ``site["packed"]``."""
        from ..ops import packed

        self.symbolize_dims(plate_to_symbol)
        for site in self.nodes.values():
            if site["type"] != "sample":
                continue
            dim_to_symbol = site["infer"]["_dim_to_symbol"]
            p = site["packed"] = {}
            mask = site["mask"]
            p["mask"] = packed.pack(mask, dim_to_symbol) if mask is not None and not isinstance(mask, bool) else mask
            if "log_prob" in site:
                p["log_prob"] = packed.pack(site["log_prob"], dim_to_symbol)
                p["unscaled_log_prob"] = packed.pack(site["unscaled_log_prob"], dim_to_symbol)
            if "score_parts" in site:
                parts = site["score_parts"]
                p["score_parts"] = type(parts)(
                    p.get("log_prob"),
                    *(
                        part if is_identically_zero(part) else packed.pack(part, dim_to_symbol)
                        for part in (parts.score_function, parts.entropy_term)
                    ),
                )

    def param_nodes(self):
        return [n for n, s in self.nodes.items() if s["type"] == "param"]
