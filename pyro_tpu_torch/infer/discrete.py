"""Posterior draws and MAP decoding of enumerated discrete sites
(counterpart of ``pyro_tpu/infer/discrete.py``).

One taping forward contraction and one backward sweep draw the exact joint
posterior of every enumerated site (``temperature=1``), or decode its joint
MAP through the max-product ring (``temperature=0``); the number of
contractions does not grow with the number of sites
(``ops/einsum_sample.py``).
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch

from .. import poutine
from ..ops import packed
from ..ops.einsum_sample import sample_tensor_tree
from ..poutine.enum_messenger import EnumMessenger
from ..poutine.util import prune_subsample_sites


def _sample_posterior(model, first_available_dim, temperature, generator, *args, **kwargs):
    """The model conditioned on a joint draw (or the MAP) of its enumerated
    sites, and those values by site name."""
    enum_model = EnumMessenger(first_available_dim=first_available_dim)(model)
    if generator is not None:
        enum_model = poutine.seed(enum_model, rng_seed=generator)
    with poutine.block():
        trace = poutine.trace(enum_model).get_trace(*args, **kwargs)
    if any(site["type"] == "markov_chain" and site["value"] for site in trace.nodes.values()):
        raise NotImplementedError(
            "infer_discrete does not support vectorized_markov; use pyro.markov (unrolled) for posterior draws"
        )
    trace = prune_subsample_sites(trace)
    trace.compute_log_prob()
    trace.pack_tensors()

    # a factor's ordinal comes from its site's plates, not from its dims: an
    # enumerated site keeps a compact log_prob, with no axis for a plate it
    # is constant over.  Every factor is scaled and masked, except an
    # enumerated site's at temperature 1: there it is the unscaled, unmasked
    # log_prob that TraceEnum_ELBO and compute_marginals contract, so a
    # transition shared by a plate stays one matrix (and reaches
    # logmatmulexp), and a step masked off a sequence's end follows the
    # model's chain where a masked factor would draw it uniformly.  At
    # temperature 0 a masked step's factor must be flat, or the max over the
    # steps past a length would pull the MAP of the steps within it
    tensor_tree = OrderedDict()
    enum_sites = OrderedDict()
    sum_dims = set()
    for name, site in trace.nodes.items():
        if site["type"] != "sample" or site["infer"].get("_do_not_score"):
            continue
        ordinal = frozenset(trace.plate_to_symbol[f.name] for f in site["cond_indep_stack"] if f.dim is not None)
        enumerated = site["infer"].get("_enumerate_dim") is not None
        if enumerated:
            enum_sites[name] = site
            sum_dims.add(site["infer"]["_enumerate_symbol"])
        key = "unscaled_log_prob" if enumerated and temperature != 0 else "log_prob"
        tensor_tree.setdefault(ordinal, []).append(site["packed"][key])
    present = set()
    dim_to_size = {}
    for terms in tensor_tree.values():
        for term in terms:
            present |= set(term.dims) & sum_dims
            dim_to_size.update(zip(term.dims, term.shape))
    sampled = sample_tensor_tree(tensor_tree, present, generator, temperature=temperature, dim_to_size=dim_to_size)

    data = {}
    for name, site in enum_sites.items():
        symbol = site["infer"]["_enumerate_symbol"]
        device = site["value"].device
        # a site whose dim no factor carries has one value
        z = sampled.get(symbol, packed.PackedTensor(torch.zeros((), dtype=torch.long, device=device), ""))
        z = packed.unpack(z, trace.symbol_to_dim)
        fn = site["fn"]
        support = fn.enumerate_support(expand=False)
        support = support.reshape(support.shape[:1] + support.shape[support.ndim - fn.event_dim:])
        data[name] = support[z]
    return poutine.condition(model, data=data), data


def infer_discrete(fn=None, first_available_dim=None, temperature=1, generator=None):
    """A model whose enumerated discrete sites take a joint draw from their
    exact posterior (``temperature=1``) or their joint MAP
    (``temperature=0``).  ``first_available_dim`` is the first dim left of
    the model's plates; draws come from ``generator``."""
    if fn is None:
        return functools.partial(
            infer_discrete, first_available_dim=first_available_dim, temperature=temperature, generator=generator
        )

    @functools.wraps(fn)
    def _fn(*args, **kwargs):
        conditioned, _ = _sample_posterior(fn, first_available_dim, temperature, generator, *args, **kwargs)
        return conditioned(*args, **kwargs)

    return _fn
