"""The port's vectorized Markov chains against the JAX package, on the CPU:
the ten ``CASES`` of ``tests/test_vectorized_markov.py`` (models 0-7,
first- and second-order chains, one or two chain variables, a transition
per step), each through every route of ``ops/markov_product.py``.

The models are ``pyro_tpu_torch/examples/vectorized_markov.py`` in the
port and the JAX test module's own in the JAX package, at the JAX test's
data and at the JAX params (carried into the port's store).  For each
case the port's vectorized ``TraceEnum_ELBO`` loss must match the JAX
vectorized and unrolled losses and the port's own unrolled loss through
``pyro.markov`` (rtol 1e-5, atol 1e-4, as the JAX test holds its two), and
each param's gradient JAX's (rtol 1e-4, atol 1e-5: float32 sums in another
order).  The route each chain takes is counted (``markov_product.routes``).
"""

import jax
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
from pyro_tpu import poutine as jpoutine
import test_vectorized_markov as jvm
import pyro_tpu_torch as pyro
from pyro_tpu.infer import TraceEnum_ELBO as JTraceEnum_ELBO
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu_torch.examples import vectorized_markov as tvm
from pyro_tpu_torch.infer import TraceEnum_ELBO
from pyro_tpu_torch.ops import markov_product

IDS = [f"{m.__name__}-T{np.shape(d)[-2]}-h{h}" for m, d, h in jvm.CASES]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _run_jax(model, data, history):
    """Params, the vectorized and unrolled losses and the vectorized
    loss's gradients, by the JAX package (under ``jax.jit``: its eager ops
    compile one by one)."""
    jpyro.clear_param_store()
    jpoutine.trace(jpoutine.seed(model, rng_seed=0)).get_trace(data, history, True)  # registers the params
    params = jpyro.get_param_store().get_all_unconstrained()
    elbo = JTraceEnum_ELBO(max_plate_nesting=3)
    key = jax.random.key(0)

    def loss_fn(p, vectorized):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, jvm._guide, data, history, vectorized, rng_key=key)

    loss_vec, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, True)))(params)
    loss_unroll = jax.jit(lambda p: loss_fn(p, False))(params)
    jpyro.clear_param_store()
    return {
        "params": {k: np.asarray(v) for k, v in params.items()},
        "loss_vec": float(loss_vec),
        "loss_unroll": float(loss_unroll),
        "grads": {k: np.asarray(v) for k, v in grads.items()},
    }


@pytest.fixture(scope="module")
def jax_runs():
    return [_run_jax(*case) for case in jvm.CASES]


def _port_case(i, jax_run):
    """The port's model, data and history of case ``i``, with the JAX
    params in the store."""
    model, kind, shape, history = tvm.CASES[i]
    data = torch.tensor(np.asarray(jvm.CASES[i][1]))
    assert tuple(data.shape) == shape and (kind == "int") == (not data.is_floating_point())
    data = data.long() if kind == "int" else data.float()
    pyro.clear_param_store()
    for name, value in jax_run["params"].items():
        pyro.param(name, torch.tensor(value))
    return model, data, history


def _loss(model, data, history, vectorized):
    return float(TraceEnum_ELBO(max_plate_nesting=3).loss(model, tvm.no_guide, data, history, vectorized))


@pytest.mark.parametrize("i", range(len(jvm.CASES)), ids=IDS)
def test_vectorized_loss_matches_jax(jax_runs, i):
    model, data, history = _port_case(i, jax_runs[i])
    loss = _loss(model, data, history, True)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jax_runs[i]["loss_vec"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss, jax_runs[i]["loss_unroll"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("i", range(len(jvm.CASES)), ids=IDS)
def test_unrolled_loss_matches(jax_runs, i):
    """``pyro.markov`` unrolled, the port's own oracle for the vectorized
    chain, against the port's vectorized loss and the JAX unrolled one."""
    model, data, history = _port_case(i, jax_runs[i])
    loss_unroll = _loss(model, data, history, False)
    np.testing.assert_allclose(loss_unroll, _loss(model, data, history, True), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss_unroll, jax_runs[i]["loss_unroll"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("i", range(len(jvm.CASES)), ids=IDS)
def test_gradients_match_jax(jax_runs, i):
    model, data, history = _port_case(i, jax_runs[i])
    TraceEnum_ELBO(max_plate_nesting=3).differentiable_loss(model, tvm.no_guide, data, history, True).backward()
    store = pyro.get_param_store()
    expected = jax_runs[i]["grads"]
    for name, g in expected.items():
        assert name in store, name
        actual = store.get_unconstrained(name).grad
        assert actual is not None, name
        np.testing.assert_allclose(actual.numpy(), g, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("i", range(len(jvm.CASES)), ids=IDS)
def test_chain_takes_its_route(jax_runs, i):
    """model_0-2 through the scan (K2), model_6 through the general body
    (K2g), model_3, 4, 5 and 7 through the pairwise fallback (K1 rounds):
    one chain eliminated, by that route."""
    model, data, history = _port_case(i, jax_runs[i])
    markov_product.reset_routes()
    _loss(model, data, history, True)
    expected = {"scan": 0, "general": 0, "pairwise": 0}
    expected[tvm.ROUTES[model]] = 1
    assert markov_product.routes == expected


def test_unrolled_chain_recycles_dims():
    """Under ``pyro.markov`` a first-order chain of 31 steps enumerates in
    two alternating dims, not 31."""
    from pyro_tpu_torch import poutine

    model, kind, shape, history = tvm.CASES[7]
    data = tvm.make_data(kind, shape)
    with poutine.trace() as tr:
        with poutine.EnumMessenger(first_available_dim=-3):
            model(data, history, False)
    dims = {site["infer"]["_enumerate_dim"] for name, site in tr.trace.nodes.items()
            if site["type"] == "sample" and name.startswith("x_")}
    assert dims == {-3, -4}


def test_markov_forms():
    """``pyro.markov`` as a context, a decorator and an iterator marks the
    same scopes."""
    from pyro_tpu_torch.poutine.enum_messenger import MarkovMessenger

    assert isinstance(pyro.markov(), MarkovMessenger)
    assert list(pyro.markov(range(3))) == [0, 1, 2]

    @pyro.markov
    def f():
        return 7

    assert f() == 7
