"""The port's second slice end to end against the JAX package: model_1v of
``examples/hmm.py`` (vectorized_markov, enumerated hidden states) with
AutoDelta, TraceEnum_ELBO(max_plate_nesting=3) and Adam, on the CPU.

The guide's params are the JAX package's, carried over by
``params_from_jax``; AutoDelta's guide is deterministic once they are, so
loss, gradients and the Adam trajectory must agree.  B=3 sequences of
lengths (5, 7, 7) at T=7 (odd, and the mask cuts the first sequence), D=4
tones, S=5 states; and T=1, where the chain has no vectorized step.
Tolerances: loss rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 * max|g|
(float32 sums in another order); params after 3 Adam steps rtol 1e-4 with
atol 1e-5 (an Adam step divides by the root of the squared gradient, so a
gradient entry near zero moves its param by an amount that is sensitive to
rounding, but never by more than the learning rate times that entry's
relative error).  Neither reference fault of ROADMAP Queue 3 is on this
path (both need sequential enumeration), so no case is marked xfail.

The same for model_1vt (a transition per step, eliminated by the
time-varying scan; its JAX twin is written below) and model_1 (unrolled
under ``pyro.markov``, ``max_plate_nesting=2``) at B=3, T=9, D=5, S=4.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.hmm as jhmm
import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
from pyro_tpu import poutine as jpoutine
from pyro_tpu.infer import SVI as JSVI
from pyro_tpu.infer import TraceEnum_ELBO as JTraceEnum_ELBO
from pyro_tpu.infer.autoguide import AutoDelta as JAutoDelta
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.ops.indexing import Vindex as JVindex
from pyro_tpu.optim import Adam as JAdam
from pyro_tpu_torch.examples import hmm as thmm
from pyro_tpu_torch.infer import TraceEnum_ELBO

B, D, S, STEPS = 3, 4, 5, 3
CASES = {7: (5, 7, 7), 1: (1, 1, 1)}  # T -> lengths
PARAM_NAMES = ["AutoDelta.probs_x", "AutoDelta.probs_y"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _data(T):
    rng = np.random.default_rng(10 + T)
    return (rng.random((B, T, D)) < 0.3).astype(np.float32), np.array(CASES[T])


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _run_jax(T):
    """Loss and gradients at the initial params, and params after each step."""
    seq, lengths = (jnp.asarray(a) for a in _data(T))
    model = functools.partial(jhmm.model_1v, args=types.SimpleNamespace(hidden_dim=S))
    guide = JAutoDelta(jpoutine.block(model, expose=["probs_x", "probs_y"]))
    elbo = JTraceEnum_ELBO(max_plate_nesting=3)
    jpyro.clear_param_store()
    jpoutine.seed(guide, rng_seed=0)(seq, lengths)  # registers the params
    params0 = jpyro.get_param_store().get_all_unconstrained()

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, guide, seq, lengths, rng_key=jax.random.key(0))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params0)
    svi = JSVI(model, guide, JAdam({"lr": 0.05}), JTraceEnum_ELBO(max_plate_nesting=3))
    trajectory = []
    for _ in range(STEPS):
        svi.step(seq, lengths)
        trajectory.append(_np(jpyro.get_param_store().get_all_unconstrained()))
    jpyro.clear_param_store()
    return {"params0": _np(params0), "loss": float(loss), "grads": _np(grads), "trajectory": trajectory}


@pytest.fixture(scope="module")
def jax_runs():
    return {T: _run_jax(T) for T in CASES}


def _port_svi(T, params0):
    """The port's model_1v SVI with the JAX initial params loaded."""
    args = thmm.parse_args(["--model", "1v", "--hidden-dim", str(S)])
    model, guide, svi = thmm.make_svi(args)
    seq, lengths = (torch.tensor(a) for a in _data(T))
    svi.evaluate_loss(seq, lengths)  # registers the params with their constraints
    store = pyro.get_param_store()
    for name, value in thmm.params_from_jax(params0).items():
        store.set_unconstrained(name, value)
    return model, guide, svi, seq, lengths


def test_params_from_jax_names(jax_runs):
    assert sorted(thmm.params_from_jax(jax_runs[7]["params0"])) == PARAM_NAMES


@pytest.mark.parametrize("T", list(CASES))
def test_traceenum_elbo_loss_matches(jax_runs, T):
    model, guide, _, seq, lengths = _port_svi(T, jax_runs[T]["params0"])
    loss = TraceEnum_ELBO(max_plate_nesting=3).loss(model, guide, seq, lengths)
    np.testing.assert_allclose(float(loss), jax_runs[T]["loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def port_grads(jax_runs):
    out = {}
    for T in CASES:
        pyro.set_default_device("cpu")
        pyro.clear_param_store()
        model, guide, _, seq, lengths = _port_svi(T, jax_runs[T]["params0"])
        TraceEnum_ELBO(max_plate_nesting=3).differentiable_loss(model, guide, seq, lengths).backward()
        store = pyro.get_param_store()
        out[T] = {name: store.get_unconstrained(name).grad.numpy().copy() for name in PARAM_NAMES}
    pyro.clear_param_store()
    return out


@pytest.mark.parametrize("name", PARAM_NAMES)
@pytest.mark.parametrize("T", list(CASES))
def test_gradients_match(jax_runs, port_grads, T, name):
    expected = jax_runs[T]["grads"][name]
    np.testing.assert_allclose(port_grads[T][name], expected, rtol=1e-4, atol=1e-6 * np.abs(expected).max())


@pytest.fixture(scope="module")
def port_trajectories(jax_runs):
    out = {}
    for T in CASES:
        pyro.set_default_device("cpu")
        pyro.clear_param_store()
        _, _, svi, seq, lengths = _port_svi(T, jax_runs[T]["params0"])
        out[T] = []
        for _ in range(STEPS):
            svi.step(seq, lengths)
            store = pyro.get_param_store()
            out[T].append({name: store.get_unconstrained(name).detach().numpy().copy() for name in PARAM_NAMES})
    pyro.clear_param_store()
    return out


@pytest.mark.parametrize("name", PARAM_NAMES)
@pytest.mark.parametrize("T", list(CASES))
def test_adam_trajectory_matches(jax_runs, port_trajectories, T, name):
    for step in range(STEPS):
        expected = jax_runs[T]["trajectory"][step][name]
        np.testing.assert_allclose(port_trajectories[T][step][name], expected, rtol=1e-4, atol=1e-5)


def test_chain_goes_through_one_scan_and_no_log_matmul(jax_runs, monkeypatch):
    """The ELBO eliminates the chain with one markov_scan call and never
    reaches logmatmulexp (on the card: one K2 launch each way, no K1)."""
    from pyro_tpu_torch.ops import markov_product
    from pyro_tpu_torch.ops import log_matmul

    calls = {"scan": 0, "lme": 0}
    scan = markov_product.markov_scan

    def counting_scan(*args):
        calls["scan"] += 1
        return scan(*args)

    def no_lme(*args):
        calls["lme"] += 1
        raise AssertionError("logmatmulexp reached outside the scan")

    model, guide, svi, seq, lengths = _port_svi(7, jax_runs[7]["params0"])
    monkeypatch.setattr(markov_product, "markov_scan", counting_scan)
    monkeypatch.setattr(log_matmul, "logmatmulexp", no_lme)
    svi.step(seq, lengths)
    assert calls == {"scan": 1, "lme": 0}


# -- model_1vt (a transition per step, through K2g's plain form) and model_1
# (unrolled under pyro.markov) at B=3 sequences, T=9, D=5 tones, S=4 states;
# the same tolerances as above.

MORE_B, MORE_T, MORE_D, MORE_S = 3, 9, 5, 4
MORE_LENGTHS = (9, 6, 9)


def jax_model_1vt(sequences, lengths, args, include_prior=True):
    """``pyro_tpu_torch/examples/hmm.py::model_1vt`` in the JAX package:
    model_1v with ``probs_x`` (T, H, H), x_t ~ probs_x[t, x_{t-1}]."""
    num_sequences, max_length, data_dim = sequences.shape
    with jpoutine.mask(mask=include_prior):
        probs_x = jpyro.sample(
            "probs_x",
            jdist.Dirichlet(0.9 * jnp.eye(args.hidden_dim) + 0.1).expand((max_length, args.hidden_dim)).to_event(2),
        )
        probs_y = jpyro.sample(
            "probs_y", jdist.Beta(0.1, 0.9).expand((args.hidden_dim, data_dim)).to_event(2)
        )
    tones_plate = jpyro.plate("tones", data_dim, dim=-1)
    with jpyro.plate("sequences", num_sequences, dim=-3) as batch:
        lengths_b = lengths[batch]
        batch = batch[:, None]
        x_prev = 0
        for t in jpyro.vectorized_markov(name="time", size=max_length, dim=-2):
            with jpoutine.mask(mask=(t < lengths_b[:, None])[..., None]):
                step = t if isinstance(t, int) else t[:, None]
                x_curr = jpyro.sample(
                    f"x_{t}",
                    jdist.Categorical(JVindex(probs_x)[..., step, x_prev, :]),
                    infer={"enumerate": "parallel"},
                )
                with tones_plate:
                    jpyro.sample(
                        f"y_{t}",
                        jdist.Bernoulli(JVindex(probs_y)[..., x_curr.squeeze(-1), :]),
                        obs=JVindex(sequences)[batch, t],
                    )
                x_prev = x_curr


# port model name -> (JAX model, max_plate_nesting)
MORE_MODELS = {"1vt": (jax_model_1vt, 3), "1": (jhmm.model_1, 2)}


def _more_data():
    rng = np.random.default_rng(31)
    return (rng.random((MORE_B, MORE_T, MORE_D)) < 0.3).astype(np.float32), np.array(MORE_LENGTHS)


def _run_jax_more(name):
    jax_model, nesting = MORE_MODELS[name]
    seq, lengths = (jnp.asarray(a) for a in _more_data())
    model = functools.partial(jax_model, args=types.SimpleNamespace(hidden_dim=MORE_S))
    guide = JAutoDelta(jpoutine.block(model, expose=["probs_x", "probs_y"]))
    elbo = JTraceEnum_ELBO(max_plate_nesting=nesting)
    jpyro.clear_param_store()
    jpoutine.seed(guide, rng_seed=0)(seq, lengths)
    params0 = jpyro.get_param_store().get_all_unconstrained()

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, guide, seq, lengths, rng_key=jax.random.key(0))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params0)
    svi = JSVI(model, guide, JAdam({"lr": 0.05}), JTraceEnum_ELBO(max_plate_nesting=nesting))
    trajectory = []
    for _ in range(STEPS):
        svi.step(seq, lengths)
        trajectory.append(_np(jpyro.get_param_store().get_all_unconstrained()))
    jpyro.clear_param_store()
    return {"params0": _np(params0), "loss": float(loss), "grads": _np(grads), "trajectory": trajectory}


@pytest.fixture(scope="module")
def jax_more_runs():
    return {name: _run_jax_more(name) for name in MORE_MODELS}


def _port_more_svi(name, params0):
    args = thmm.parse_args(["--model", name, "--hidden-dim", str(MORE_S)])
    model, guide, svi = thmm.make_svi(args)
    seq, lengths = (torch.tensor(a) for a in _more_data())
    svi.evaluate_loss(seq, lengths)
    store = pyro.get_param_store()
    for pname, value in thmm.params_from_jax(params0).items():
        store.set_unconstrained(pname, value)
    return model, guide, svi, seq, lengths


@pytest.mark.parametrize("name", list(MORE_MODELS))
def test_more_models_loss_matches(jax_more_runs, name):
    model, guide, _, seq, lengths = _port_more_svi(name, jax_more_runs[name]["params0"])
    assert sorted(thmm.params_from_jax(jax_more_runs[name]["params0"])) == PARAM_NAMES
    loss = TraceEnum_ELBO(max_plate_nesting=MORE_MODELS[name][1]).loss(model, guide, seq, lengths)
    np.testing.assert_allclose(float(loss), jax_more_runs[name]["loss"], rtol=1e-5)


@pytest.mark.parametrize("pname", PARAM_NAMES)
@pytest.mark.parametrize("name", list(MORE_MODELS))
def test_more_models_gradients_match(jax_more_runs, name, pname):
    model, guide, _, seq, lengths = _port_more_svi(name, jax_more_runs[name]["params0"])
    TraceEnum_ELBO(max_plate_nesting=MORE_MODELS[name][1]).differentiable_loss(model, guide, seq, lengths).backward()
    got = pyro.get_param_store().get_unconstrained(pname).grad.numpy()
    expected = jax_more_runs[name]["grads"][pname]
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-6 * np.abs(expected).max())


@pytest.mark.parametrize("pname", PARAM_NAMES)
@pytest.mark.parametrize("name", list(MORE_MODELS))
def test_more_models_adam_trajectory_matches(jax_more_runs, name, pname):
    _, _, svi, seq, lengths = _port_more_svi(name, jax_more_runs[name]["params0"])
    for step in range(STEPS):
        svi.step(seq, lengths)
        got = pyro.get_param_store().get_unconstrained(pname).detach().numpy()
        np.testing.assert_allclose(got, jax_more_runs[name]["trajectory"][step][pname], rtol=1e-4, atol=1e-5)


def test_model_1vt_goes_through_the_time_varying_scan(jax_more_runs, monkeypatch):
    """One step of model_1vt eliminates its chain with one markov_scan_tv
    call (on the card: one K2g launch each way) and no markov_scan (K2)."""
    from pyro_tpu_torch.ops import markov_product

    calls = {"tv": 0}
    scan_tv = markov_product.markov_scan_tv

    def counting(*args):
        calls["tv"] += 1
        return scan_tv(*args)

    def no_scan(*args):
        raise AssertionError("markov_scan (K2) reached by a time-varying chain")

    _, _, svi, seq, lengths = _port_more_svi("1vt", jax_more_runs["1vt"]["params0"])
    monkeypatch.setattr(markov_product, "markov_scan_tv", counting)
    monkeypatch.setattr(markov_product, "markov_scan", no_scan)
    svi.step(seq, lengths)
    assert calls == {"tv": 1}
