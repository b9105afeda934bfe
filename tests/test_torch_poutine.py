"""The port's effect handlers and param store against the JAX package's,
on the CPU: the same small model traced in both packages gives the same
sites in the same order, the same plate frames, and the same scaled and
masked log-probs (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu_torch import poutine

RNG = np.random.default_rng(0)
INIT_PROBS = RNG.uniform(0.1, 0.9, size=(3, 4)).astype(np.float32)
DATA = (RNG.random((3, 4)) < 0.5).astype(np.float32)
MASK = RNG.random((3, 4)) < 0.7
CONC = RNG.uniform(0.5, 2.0, size=5).astype(np.float32)
Z = RNG.dirichlet(np.ones(5)).astype(np.float32)

JAX_PKG = (jpyro, jdist, jpoutine, jnp.asarray)
PORT_PKG = (pyro, tdist, poutine, lambda x: torch.as_tensor(np.asarray(x)))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def model(pkg):
    p, d, handlers, a = pkg
    probs = p.param("probs", a(INIT_PROBS), constraint=d.constraints.unit_interval)
    with p.plate("outer", 3, dim=-2):
        with handlers.scale(scale=2.0), p.plate("inner", 4, dim=-1):
            with handlers.mask(mask=a(MASK)):
                p.sample("x", d.Bernoulli(probs=probs), obs=a(DATA))
    p.sample("z", d.Dirichlet(a(CONC)), obs=a(Z))


def _trace(pkg, fn=model):
    handlers = pkg[2]
    tr = handlers.trace(lambda: fn(pkg)).get_trace()
    tr.compute_log_prob()
    return tr


def _sites(tr):
    return [(name, s["type"]) for name, s in tr.nodes.items() if s["type"] in ("sample", "param")]


def test_site_order_matches_jax():
    assert _sites(_trace(PORT_PKG)) == _sites(_trace(JAX_PKG))


def test_plate_frames_match_jax():
    frames = {
        name: [(f.name, f.dim, f.size) for f in s["cond_indep_stack"]]
        for name, s in _trace(PORT_PKG).nodes.items()
        if s["type"] == "sample"
    }
    jframes = {
        name: [(f.name, f.dim, f.size) for f in s["cond_indep_stack"]]
        for name, s in _trace(JAX_PKG).nodes.items()
        if s["type"] == "sample"
    }
    assert frames == jframes
    assert frames["x"] == [("outer", -2, 3), ("inner", -1, 4)]


@pytest.mark.parametrize("site", ["x", "z"])
def test_scaled_masked_log_prob_matches_jax(site):
    port, jax_ = _trace(PORT_PKG).nodes[site], _trace(JAX_PKG).nodes[site]
    np.testing.assert_allclose(port["log_prob"].detach().numpy(), np.asarray(jax_["log_prob"]), rtol=1e-5)
    np.testing.assert_allclose(float(port["log_prob_sum"].detach()), float(jax_["log_prob_sum"]), rtol=1e-5)
    assert port["scale"] == jax_["scale"]


def test_mask_and_scale_values():
    site = _trace(PORT_PKG).nodes["x"]
    lp = site["fn"].log_prob(site["value"]).detach()
    expected = torch.where(torch.as_tensor(MASK), 2.0 * lp, 0.0)
    torch.testing.assert_close(site["log_prob"].detach(), expected)


def test_block_expose_fn_matches_jax():
    def blocked(pkg):
        pkg[2].block(lambda: model(pkg), expose_fn=lambda msg: msg["name"] in ("x", "probs"))()

    assert _sites(_trace(PORT_PKG, blocked)) == _sites(_trace(JAX_PKG, blocked))
    assert _sites(_trace(PORT_PKG, blocked)) == [("probs", "param"), ("x", "sample")]


def test_block_hides_from_outer_trace():
    with poutine.trace() as tr:
        with poutine.block():
            pyro.sample("hidden", tdist.Bernoulli(probs=torch.tensor(0.5)), obs=torch.tensor(1.0))
        pyro.sample("seen", tdist.Bernoulli(probs=torch.tensor(0.5)), obs=torch.tensor(1.0))
    assert list(tr.trace.nodes) == ["seen"]


def test_seed_is_reproducible():
    def draw():
        return pyro.sample("w", tdist.Dirichlet(torch.ones(4)))

    a = poutine.seed(draw, rng_seed=3)()
    b = poutine.seed(draw, rng_seed=3)()
    c = poutine.seed(draw, rng_seed=4)()
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)


def test_replay_and_condition():
    def latent():
        return pyro.sample("w", tdist.Dirichlet(torch.ones(4)))

    guide_trace = poutine.trace(poutine.seed(latent, rng_seed=0)).get_trace()
    replayed = poutine.trace(poutine.seed(poutine.replay(latent, trace=guide_trace), rng_seed=1)).get_trace()
    torch.testing.assert_close(replayed.nodes["w"]["value"], guide_trace.nodes["w"]["value"])
    value = torch.full((4,), 0.25)
    conditioned = poutine.trace(poutine.condition(latent, data={"w": value})).get_trace()
    assert conditioned.nodes["w"]["is_observed"] and torch.equal(conditioned.nodes["w"]["value"], value)


def test_plate_dim_collision_raises():
    with pytest.raises(ValueError):
        with pyro.plate("a", 3, dim=-1), pyro.plate("b", 4, dim=-1):
            pass


@pytest.mark.parametrize("name", ["unit_interval", "positive", "simplex", "independent_simplex"])
def test_param_store_round_trip_matches_jax(name):
    from pyro_tpu.distributions import constraints as jconstraints
    from pyro_tpu_torch.distributions import constraints

    def constraint(c):
        return c.independent(c.simplex, 1) if name == "independent_simplex" else getattr(c, name)

    init = RNG.dirichlet(np.ones(4), size=3).astype(np.float32)
    jpyro.clear_param_store()
    jpyro.param("p", jnp.asarray(init), constraint=constraint(jconstraints))
    pyro.param("p", torch.as_tensor(init), constraint=constraint(constraints))
    store = pyro.get_param_store()
    unconstrained = store.get_unconstrained("p")
    assert unconstrained.requires_grad and unconstrained.is_leaf
    np.testing.assert_allclose(
        unconstrained.detach().numpy(),
        np.asarray(jpyro.get_param_store().get_all_unconstrained()["p"]),
        rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(store["p"].detach().numpy(), np.asarray(jpyro.get_param_store()["p"]), rtol=1e-5)
    jpyro.clear_param_store()


def test_module_shares_parameters_with_store():
    net = torch.nn.Linear(3, 2)
    pyro.module("net", net)
    store = pyro.get_param_store()
    assert store.get_unconstrained("net$$$weight") is net.weight
    loaded = torch.zeros(2, 3)
    store.set_unconstrained("net$$$weight", loaded)
    pyro.module("net", net)
    assert store.get_unconstrained("net$$$weight") is net.weight
    assert torch.equal(net.weight.detach(), loaded)


def test_no_cuda_raises_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    pyro.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_default_device"):
            pyro.get_default_device()
    finally:
        pyro.set_default_device("cpu")
