"""The port's slice end to end against the JAX package: model_7 of
``examples/hmm.py`` with AutoDelta, Trace_ELBO and Adam, on the CPU.

The weights are the JAX package's, carried over by ``params_from_jax``;
AutoDelta's guide is deterministic once they are, so loss, gradients and
the Adam trajectory must agree.  Tolerances: loss rtol 1e-5; gradients
rtol 1e-4 with atol 1e-6 * max|g| (float32 sums in another order); params
after 3 Adam steps rtol 1e-4 with atol 1e-5 (an Adam step divides by the
root of the squared gradient, so a gradient entry near zero moves its
param by an amount that is sensitive to rounding, but never by more than
the learning rate times that entry's relative error).
"""

import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.hmm as jhmm
import pyro_tpu as jpyro
import pyro_tpu_torch as pyro
from pyro_tpu import poutine as jpoutine
from pyro_tpu.infer import SVI as JSVI
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer.autoguide import AutoDelta as JAutoDelta
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.optim import Adam as JAdam
from pyro_tpu_torch.examples import hmm as thmm
from pyro_tpu_torch.infer import Trace_ELBO

B, D, S, NN_DIM, STEPS = 4, 5, 8, 8, 3
LENGTHS = (13, 16)
PARAM_NAMES = ["AutoDelta.probs_x"] + [
    f"tones_generator$$${layer}.{kind}"
    for layer in ("conv", "dense_x", "dense_y", "dense_out")
    for kind in ("weight", "bias")
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _sequences(T):
    rng = np.random.default_rng(T)
    return (rng.random((B, T, D)) < 0.3).astype(np.float32)


def _args():
    return types.SimpleNamespace(hidden_dim=S, nn_dim=NN_DIM, nn_channels=2, data_dim=D, seed=0)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _run_jax(T):
    """Loss and gradients at the initial params, and params after each step."""
    seq = jnp.asarray(_sequences(T))
    lengths = np.full(B, T)
    args = _args()

    def model(sequences):
        return jhmm.model_7(sequences, lengths, args)

    guide = JAutoDelta(jpoutine.block(model, expose_fn=lambda msg: msg["name"].startswith("probs_")))
    jpyro.clear_param_store()
    elbo = JTrace_ELBO()
    elbo.loss(model, guide, seq, rng_key=jax.random.key(0))  # registers the params
    params0 = jpyro.get_param_store().get_all_unconstrained()

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, guide, seq, rng_key=jax.random.key(0))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params0)
    svi = JSVI(model, guide, JAdam({"lr": 0.05}), JTrace_ELBO())
    trajectory = []
    for _ in range(STEPS):
        svi.step(seq)
        trajectory.append(_np(jpyro.get_param_store().get_all_unconstrained()))
    jpyro.clear_param_store()
    return {"params0": _np(params0), "loss": float(loss), "grads": _np(grads), "trajectory": trajectory}


@pytest.fixture(scope="module")
def jax_runs():
    return {T: _run_jax(T) for T in LENGTHS}


def _port_svi(T, params0):
    """The port's model_7 SVI with the JAX initial params loaded."""
    args = _args()
    args.tones_generator = None
    model, guide, svi = thmm.make_svi(args)
    seq = torch.tensor(_sequences(T))
    lengths = torch.full((B,), T)
    svi.evaluate_loss(seq, lengths)  # registers the params with their constraints
    store = pyro.get_param_store()
    for name, value in thmm.params_from_jax(params0).items():
        store.set_unconstrained(name, value)
    return model, guide, svi, seq, lengths


def test_params_from_jax_names(jax_runs):
    assert sorted(thmm.params_from_jax(jax_runs[13]["params0"])) == sorted(PARAM_NAMES)


@pytest.mark.parametrize("T", LENGTHS)
def test_trace_elbo_loss_matches(jax_runs, T):
    model, guide, _, seq, lengths = _port_svi(T, jax_runs[T]["params0"])
    loss = Trace_ELBO().loss(model, guide, seq, lengths)
    np.testing.assert_allclose(float(loss), jax_runs[T]["loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def port_grads(jax_runs):
    out = {}
    for T in LENGTHS:
        pyro.set_default_device("cpu")
        pyro.clear_param_store()
        model, guide, _, seq, lengths = _port_svi(T, jax_runs[T]["params0"])
        Trace_ELBO().differentiable_loss(model, guide, seq, lengths).backward()
        store = pyro.get_param_store()
        out[T] = {name: store.get_unconstrained(name).grad.numpy().copy() for name in PARAM_NAMES}
    pyro.clear_param_store()
    return out


@pytest.mark.parametrize("name", PARAM_NAMES)
@pytest.mark.parametrize("T", LENGTHS)
def test_gradients_match(jax_runs, port_grads, T, name):
    expected = thmm.params_from_jax(jax_runs[T]["grads"])[name].numpy()
    actual = port_grads[T][name]
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-6 * np.abs(expected).max())


@pytest.fixture(scope="module")
def port_trajectories(jax_runs):
    out = {}
    for T in LENGTHS:
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
@pytest.mark.parametrize("T", LENGTHS)
def test_adam_trajectory_matches(jax_runs, port_trajectories, T, name):
    for step in range(STEPS):
        expected = thmm.params_from_jax(jax_runs[T]["trajectory"][step])[name].numpy()
        np.testing.assert_allclose(port_trajectories[T][step][name], expected, rtol=1e-4, atol=1e-5)


Q_INIT = np.array([0.3, 0.6, 0.8], np.float32)
X_OBS = np.array([1.0, 0.0, 1.0], np.float32)
Z_FIXED = np.array([1.0, 0.0, 0.0], np.float32)


def _score_model(pyro_, d, a):
    with pyro_.plate("data", 3):
        z = pyro_.sample("z", d.Bernoulli(probs=a(np.full(3, 0.3, np.float32))))
        pyro_.sample("x", d.Bernoulli(probs=0.2 + 0.6 * z), obs=a(X_OBS))
    pyro_.sample("w", d.Dirichlet(a(np.ones(2, np.float32))), obs=a(np.array([0.4, 0.6], np.float32)))


def _score_guide(pyro_, d, a, constraints):
    q = pyro_.param("q", a(Q_INIT), constraint=constraints.unit_interval)
    with pyro_.plate("data", 3):
        pyro_.sample("z", d.Bernoulli(probs=q))


def test_trace_elbo_score_function_term_matches_jax():
    """A non-reparameterised guide site (Bernoulli z in a plate) with its
    value fixed by replay: the surrogate's gradient carries the score
    function times the plate-summed downstream log_r."""
    import pyro_tpu.distributions as jdist
    from pyro_tpu.distributions import constraints as jconstraints
    from pyro_tpu.poutine.trace_struct import Trace as JTrace

    import pyro_tpu_torch.distributions as tdist
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.distributions import constraints
    from pyro_tpu_torch.poutine.trace_struct import Trace

    def fixed_z(trace_cls, a):
        tr = trace_cls()
        tr.add_node("z", name="z", type="sample", is_observed=False, value=a(Z_FIXED), infer={})
        return tr

    jpyro.clear_param_store()
    jpyro.param("q", jnp.asarray(Q_INIT), constraint=jconstraints.unit_interval)
    params = jpyro.get_param_store().get_all_unconstrained()
    jz = fixed_z(JTrace, jnp.asarray)

    def jax_loss(p):
        with ParamsMessenger(p):
            gt = jpoutine.trace(jpoutine.replay(lambda: _score_guide(jpyro, jdist, jnp.asarray, jconstraints), trace=jz)).get_trace()
            mt = jpoutine.trace(jpoutine.replay(lambda: _score_model(jpyro, jdist, jnp.asarray), trace=gt)).get_trace()
        mt.compute_log_prob()
        gt.compute_score_parts()
        loss, surrogate = JTrace_ELBO()._differentiable_loss_particle(mt, gt)
        return surrogate + jax.lax.stop_gradient(loss - surrogate)

    j_loss, j_grad = jax.value_and_grad(jax_loss)(params)
    jpyro.clear_param_store()

    def a(x):
        return torch.as_tensor(np.asarray(x))

    tz = fixed_z(Trace, a)
    gt = poutine.trace(poutine.replay(lambda: _score_guide(pyro, tdist, a, constraints), trace=tz)).get_trace()
    mt = poutine.trace(poutine.replay(lambda: _score_model(pyro, tdist, a), trace=gt)).get_trace()
    mt.compute_log_prob()
    gt.compute_score_parts()
    loss, surrogate = Trace_ELBO()._differentiable_loss_particle(mt, gt)
    (surrogate + (loss - surrogate).detach()).backward()
    grad = pyro.get_param_store().get_unconstrained("q").grad
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad["q"]), rtol=1e-4, atol=1e-6)
    assert np.abs(grad.numpy()).min() > 0  # every z's score term contributes


def test_run_steps_returns_losses():
    args = _args()
    args.tones_generator = None
    _, _, svi = thmm.make_svi(args)
    seq, lengths = thmm.synthetic_sequences(0, B, 7, D)
    losses = svi.run_steps(2, seq, lengths)
    assert losses.shape == (2,) and torch.isfinite(losses).all()


def test_import_leaves_out_jax():
    code = (
        "import sys, pyro_tpu_torch, pyro_tpu_torch.examples.hmm, pyro_tpu_torch.examples.vae\n"
        "import pyro_tpu_torch.examples.eight_schools, pyro_tpu_torch.infer.mcmc\n"
        "import pyro_tpu_torch.examples.gaussian_hmm, pyro_tpu_torch.ops.gaussian_levels\n"
        "import pyro_tpu_torch.examples.lgssm, pyro_tpu_torch.examples.vectorized_markov\n"
        "import pyro_tpu_torch.examples.gamma_gaussian_hmm, pyro_tpu_torch.ops.gamma_gaussian\n"
        "import pyro_tpu_torch.examples.contract_timing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')"
        " or m == 'pyro_tpu' or m.startswith('pyro_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert result.returncode == 0, result.stdout + result.stderr
