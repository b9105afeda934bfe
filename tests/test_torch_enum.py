"""The port's enumeration engine against the JAX package's, on the CPU:
packed tensors (``ops/packed.py``), the log-space ring (``ops/rings.py``),
tensor variable elimination over a plated tree (``ops/contract.py``),
parallel enumeration (``EnumMessenger``) and ``vectorized_markov``'s site
names and ``markov_chain`` record.

Inputs are numpy arrays from a seed.  Tolerances: values rtol 1e-5 with
atol 1e-5 (float32 contractions in another pairwise order: the port's
greedy order may differ from opt_einsum's); enumerated values, dims and
names exactly.
"""

import functools
import types
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.hmm as jhmm
import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu.ops import contract as jcontract
from pyro_tpu.ops import packed as jpacked
from pyro_tpu.ops import rings as jrings
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu_torch import poutine
from pyro_tpu_torch.examples import hmm as thmm
from pyro_tpu_torch.ops import contract as tcontract
from pyro_tpu_torch.ops import packed as tpacked
from pyro_tpu_torch.ops import rings as trings

JAX = types.SimpleNamespace(packed=jpacked, rings=jrings, contract=jcontract, array=jnp.asarray)
PORT = types.SimpleNamespace(packed=tpacked, rings=trings, contract=tcontract, array=torch.tensor)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(actual, expected):
    assert actual.dims == expected.dims
    np.testing.assert_allclose(np.asarray(actual.value), np.asarray(expected.value), rtol=1e-5, atol=1e-5)


def _both(fn):
    return fn(PORT), fn(JAX)


def _sites(tr):
    """Names of the sample and markov_chain nodes, in order, without the
    plates' own subsample sites (the JAX traces record them only where the
    model reads the plate's index, and also hold inputs and return value)."""
    return [
        name
        for name, site in tr.nodes.items()
        if site["type"] in ("sample", "markov_chain") and type(site["fn"]).__name__ != "_Subsample"
    ]


# -- packed -----------------------------------------------------------------------


def test_packed_align_broadcast_and_gather():
    x, y = _normal(0, (3, 4)), _normal(1, (5,))

    index = np.array([3, 0, 2])

    def run(pkg):
        px, py = pkg.packed.PackedTensor(pkg.array(x), "ba"), pkg.packed.PackedTensor(pkg.array(y), "c")
        gathered = pkg.packed.gather(px, pkg.packed.PackedTensor(pkg.array(index), "b"), "a")
        return [pkg.packed.align(px, "cab"), *pkg.packed.broadcast_all(px, py), gathered]

    for a, e in zip(*_both(run)):
        assert a.shape == e.shape
        _close(a, e)


def test_pack_and_unpack():
    value = _normal(2, (3, 1, 4))

    def run(pkg):
        p = pkg.packed.pack(pkg.array(value), {-3: "e", -1: "i"})
        return p, pkg.packed.unpack(p, {"e": -3, "i": -1})

    (p, u), (jp, ju) = _both(run)
    _close(p, jp)
    assert tuple(u.shape) == tuple(ju.shape) == (3, 1, 4)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


# -- LogRing ----------------------------------------------------------------------

PAIRS = {
    "matmul": (((4, 5), "ab"), ((5, 3), "bc"), "ac"),  # routes to logmatmulexp in both
    "batched": (((2, 4, 5), "iab"), ((5, 3), "bc"), "iac"),
    "outer": (((4, 5), "ab"), ((3,), "c"), "abc"),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_logsumexp_pair_matches_jax(name):
    (sx, dx), (sy, dy), out_dims = PAIRS[name]
    x, y = _normal(3, sx, 3.0), _normal(4, sy, 3.0)
    x[0] = -np.inf  # an all -inf slice

    def run(pkg):
        P = pkg.packed.PackedTensor
        return pkg.rings.logsumexp_pair(P(pkg.array(x), dx), P(pkg.array(y), dy), out_dims)

    _close(*_both(run))


def test_logsumexp_single_matches_jax():
    x = _normal(5, (3, 4, 5), 3.0)
    for out_dims in ("b", "ac", ""):
        _close(*_both(lambda pkg: pkg.rings.logsumexp_single(pkg.packed.PackedTensor(pkg.array(x), "abc"), out_dims)))


def test_logring_contract_matches_jax():
    """A chain of five factors, contracted in each package's own order."""
    shapes = {"ab": (3, 4), "bc": (4, 5), "cd": (5, 2), "d": (2,), "ae": (3, 6)}
    values = {dims: _normal(10 + i, shape, 2.0) for i, (dims, shape) in enumerate(shapes.items())}

    def run(pkg):
        ring = pkg.rings.LogRing()
        terms = [pkg.packed.PackedTensor(pkg.array(v), d) for d, v in values.items()]
        return ring.sumproduct(terms, {"b", "c", "d", "e"})

    _close(*_both(run))


# -- contract_tensor_tree ---------------------------------------------------------


def test_contract_tensor_tree_two_plates():
    """Sum dims a (global) and b (inside plate i), with a factor inside the
    nested plates i, j: each component ends at its smallest ordinal."""
    factors = [
        (frozenset(), "a", (3,)),
        (frozenset("i"), "ai", (3, 4)),
        (frozenset("i"), "abi", (3, 2, 4)),
        (frozenset("ij"), "bij", (2, 4, 5)),
        (frozenset("ij"), "ij", (4, 5)),  # no sum dim: its own component
    ]
    values = [_normal(20 + k, shape, 2.0) for k, (_, _, shape) in enumerate(factors)]

    def run(pkg):
        tree = OrderedDict()
        for (ordinal, dims, _), v in zip(factors, values):
            tree.setdefault(ordinal, []).append(pkg.packed.PackedTensor(pkg.array(v), dims))
        return pkg.contract.contract_tensor_tree(tree, {"a", "b"}, ring=pkg.rings.LogRing())

    port, jax_ = _both(run)
    assert list(port) == list(jax_)
    for ordinal in port:
        assert len(port[ordinal]) == len(jax_[ordinal])
        for a, e in zip(port[ordinal], jax_[ordinal]):
            _close(a, e)


def test_contract_to_tensor_keeps_target_dim():
    values = [_normal(30, (3,), 2.0), _normal(31, (3, 4), 2.0)]

    def run(pkg):
        P = pkg.packed.PackedTensor
        tree = OrderedDict(
            [(frozenset(), [P(pkg.array(values[0]), "a")]), (frozenset("i"), [P(pkg.array(values[1]), "ai")])]
        )
        return pkg.contract.contract_to_tensor(tree, {"a"}, target_dims={"a"}, ring=pkg.rings.LogRing())

    _close(*_both(run))


# -- EnumMessenger ----------------------------------------------------------------

PROBS_Z = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
PROBS_W = np.array([0.2, 0.5, 0.7, 0.9], np.float32)
DATA = np.array([1.0, 0.0, 1.0], np.float32)


def two_site_model(p, d, array):
    with p.plate("data", 3, dim=-1):
        z = p.sample("z", d.Categorical(array(PROBS_Z)), infer={"enumerate": "parallel"})
        w = p.sample("w", d.Bernoulli(array(PROBS_W)[z]), infer={"enumerate": "parallel"})
        p.sample("obs", d.Bernoulli(0.2 + 0.6 * w), obs=array(DATA))


def _enum_trace(pkg):
    p, d, handlers, array = pkg
    tr = handlers.trace(handlers.EnumMessenger(first_available_dim=-2)(lambda: two_site_model(p, d, array))).get_trace()
    tr.compute_log_prob()
    return tr


def test_enum_messenger_dims_and_values():
    port = _enum_trace((pyro, tdist, poutine, torch.tensor))
    jax_ = _enum_trace((jpyro, jdist, jpoutine, jnp.asarray))
    assert _sites(port) == _sites(jax_) == ["z", "w", "obs"]
    for name in ("z", "w", "obs"):
        a, e = port.nodes[name], jax_.nodes[name]
        assert a["infer"].get("_enumerate_dim") == e["infer"].get("_enumerate_dim")
        assert a["infer"]["_dim_to_id"] == e["infer"]["_dim_to_id"]
        assert tuple(a["value"].shape) == tuple(e["value"].shape)
        np.testing.assert_array_equal(a["value"].numpy(), np.asarray(e["value"]))
        np.testing.assert_allclose(a["log_prob"].numpy(), np.asarray(e["log_prob"]), rtol=1e-5, atol=1e-6)
    assert port.nodes["z"]["infer"]["_enumerate_dim"] == -2
    assert port.nodes["w"]["infer"]["_enumerate_dim"] == -3


# -- vectorized_markov ------------------------------------------------------------

T, S, D = 6, 3, 2


def _markov_trace(pkg, model):
    handlers, array = pkg
    rng = np.random.default_rng(40)
    seq = (rng.random((2, T, D)) < 0.4).astype(np.float32)
    data = {
        "probs_x": array(rng.dirichlet(np.ones(S), size=S).astype(np.float32)),
        "probs_y": array(rng.uniform(0.1, 0.9, size=(S, D)).astype(np.float32)),
    }
    fn = functools.partial(model, args=types.SimpleNamespace(hidden_dim=S))
    fn = handlers.EnumMessenger(first_available_dim=-4)(handlers.condition(fn, data=data))
    return handlers.trace(fn).get_trace(array(seq), array(np.array([T, T - 2])))


def test_vectorized_markov_site_names_and_chain_record():
    port = _markov_trace((poutine, torch.tensor), thmm.model_1v)
    jax_ = _markov_trace((jpoutine, jnp.asarray), jhmm.model_1v)
    assert _sites(port) == _sites(jax_)
    assert "x_slice(0, 5, None)" in port.nodes
    for name in _sites(port):
        site, jsite = port.nodes[name], jax_.nodes[name]
        assert site["type"] == jsite["type"], name
        if site["type"] == "sample":
            assert bool(site["infer"].get("_do_not_score")) == bool(jsite["infer"].get("_do_not_score")), name
            assert site["infer"].get("_enumerate_dim") == jsite["infer"].get("_enumerate_dim"), name
    chain = port.nodes["_markov_chain_time"]
    assert chain["type"] == "markov_chain"
    assert chain["value"] == jax_.nodes["_markov_chain_time"]["value"] == frozenset(
        {("x_0", "x_slice(0, 5, None)", "x_slice(1, 6, None)")}
    )
    for key in ("history", "size", "plate_name"):
        assert chain["infer"][key] == jax_.nodes["_markov_chain_time"]["infer"][key]
