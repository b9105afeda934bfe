"""The port's deep Markov model (``pyro_tpu_torch/examples/dmm.py``)
against the JAX example (``examples/dmm.py``), on the CPU, at small widths
(z 8, x 6, transition 12, emission 10, rnn 16; B 4, T 7), with no IAF and
with one.

The JAX example's width constants are monkeypatched (nothing is edited).
Its parameters are drawn with numpy (normal, sd 0.15: the scale of the
RNN's own init, U(-1/4, 1/4) at width 16) and carried into the port through
``params_from_jax``, and the guide's standard-normal noise is shared by
patching ``jax.random.normal`` and ``torch.randn``.  The JAX side's three
ClippedAdam steps are SVI's: the gradient of ``Trace_ELBO`` at the current
parameters, then the JAX ``PyroOptim`` update (both compiled whole; the
port runs its own ``SVI``).  Tolerances: loss rtol 1e-5; gradients rtol
1e-4 with atol 1e-5; parameters after each step rtol 1e-4 with atol 1e-5
(the VAE's).

At twice that sd the gradients reach 5e3 with an IAF.  There both
packages' gradients are compared in float64 (rtol 1e-4, atol 1e-5), and
each package's float32 gradients against the float64 ones (1e-5 x each
leaf's largest entry).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.dmm as jdmm
import pyro_tpu as jpyro
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.optim import ClippedAdam as JClippedAdam
import pyro_tpu_torch as pyro
from pyro_tpu_torch import poutine
from pyro_tpu_torch.examples import dmm as tdmm
from pyro_tpu_torch.infer import Trace_ELBO

WIDTHS = {"X_DIM": 6, "Z_DIM": 8, "TRANS_DIM": 12, "EMISSION_DIM": 10, "RNN_DIM": 16}
B, T, STEPS, LR, CLIP = 4, 7, 3, 3e-3, 10.0
SD, SD_WIDE = 0.15, 0.3  # the weights' sd: the parity tests', and twice it
NUM_IAFS = [0, 1]
RNG = np.random.default_rng(9)
DATA = (RNG.random((B, T, WIDTHS["X_DIM"])) < 0.4).astype(np.float32)
EPS = RNG.standard_normal((B, T, WIDTHS["Z_DIM"])).astype(np.float32)


def _port_dmm(num_iafs):
    return tdmm.DMM(*(WIDTHS[k] for k in ("X_DIM", "Z_DIM", "TRANS_DIM", "EMISSION_DIM", "RNN_DIM")), num_iafs=num_iafs)


def _port_names(num_iafs):
    """Every parameter the port's model and guide register."""
    dmm = _port_dmm(num_iafs)
    names = ["z_0", "z_q_0", "h_0"]
    for module in ("transition", "emitter", "combiner", "rnn"):
        names += [f"{module}$$${n}" for n, _ in getattr(dmm, module).named_parameters()]
    for i, arn in enumerate(dmm.iafs):
        names += [f"iaf_{i}$$${n}" for n, _ in arn.named_parameters()]
    return names


CASES = [(n, name) for n in NUM_IAFS for name in _port_names(n)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _fixed_jax_draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
    assert tuple(shape) == EPS.shape, shape
    return jnp.asarray(EPS, dtype)


def _fixed_torch_draw(*shape, generator=None, dtype=None, device=None, **kwargs):
    shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
    assert shape == EPS.shape, shape
    return torch.tensor(EPS, dtype=dtype, device=device)


@contextlib.contextmanager
def _jax_dmm(num_iafs, dtype=np.float32):
    """The JAX example at the test's widths and noise with its parameters
    registered, in ``dtype`` (float64 under x64).  Yields the compiled
    ``value_and_grad`` of its Trace_ELBO loss at an unconstrained params
    dict, and weights drawn for each registered parameter by ``draw(sd)``
    (float32 numpy, normal with that sd, seeded by ``num_iafs``)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(dtype == np.float64):
        for name, value in WIDTHS.items():
            mp.setattr(jdmm, name, value)
        mp.setattr(jax.random, "normal", _fixed_jax_draw)
        x = jnp.asarray(DATA, dtype)

        def guide(seqs, annealing_factor=1.0):
            return jdmm.guide(seqs, annealing_factor, num_iafs=num_iafs)

        jpyro.clear_param_store()
        JTrace_ELBO().loss(jdmm.model, guide, x, rng_key=jax.random.key(0))  # registers the params
        shapes = {name: np.shape(v) for name, v in jpyro.get_param_store().get_all_unconstrained().items()}
        elbo = JTrace_ELBO()

        def loss_fn(p):
            with ParamsMessenger(p):
                return elbo.differentiable_loss(jdmm.model, guide, x, rng_key=jax.random.key(0))

        def draw(sd):
            rng = np.random.default_rng(31 + num_iafs)
            return {name: (sd * rng.standard_normal(shape)).astype(np.float32) for name, shape in shapes.items()}

        try:
            yield jax.jit(jax.value_and_grad(loss_fn)), draw
        finally:
            jpyro.clear_param_store()


@functools.cache
def _jax_run(num_iafs):
    """The JAX example's loss and gradients at numpy weights (sd ``SD``),
    its parameters after each of three ClippedAdam steps, and its gradients
    at weights of sd ``SD_WIDE`` (computed once a process for each
    ``num_iafs``)."""
    with _jax_dmm(num_iafs) as (value_and_grad, draw):
        params0, wide_params0 = draw(SD), draw(SD_WIDE)
        optim = JClippedAdam({"lr": LR, "clip_norm": CLIP})
        update = jax.jit(optim.update)
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        states = optim.init(params)
        loss, grads = value_and_grad(params)
        trajectory = []
        for _ in range(STEPS):
            _, g = value_and_grad(params)
            params, states = update(g, states, params)
            trajectory.append({k: np.asarray(v) for k, v in params.items()})
        _, wide_grads = value_and_grad({k: jnp.asarray(v) for k, v in wide_params0.items()})
    return {
        "num_iafs": num_iafs,
        "params0": params0,
        "loss": float(loss),
        "grads": {k: np.asarray(v) for k, v in grads.items()},
        "trajectory": trajectory,
        "wide_params0": wide_params0,
        "wide_grads": {k: np.asarray(v) for k, v in wide_grads.items()},
    }


@functools.cache
def _jax_wide_grads64(num_iafs):
    """The JAX example's gradients in float64 at the same float32 weights
    of sd ``SD_WIDE``."""
    params0 = _jax_run(num_iafs)["wide_params0"]
    with _jax_dmm(num_iafs, np.float64) as (value_and_grad, _):
        _, grads = value_and_grad({k: jnp.asarray(v, np.float64) for k, v in params0.items()})
    return {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture
def jax_run(request):
    return _jax_run(request.param)


def _port_with(params0, num_iafs, dtype=torch.float32):
    """The port's DMM with the JAX weights in the param store; the modules
    take them at their first ``pyro.module`` call."""
    pyro.clear_param_store()
    dmm = _port_dmm(num_iafs).to(dtype)
    store = pyro.get_param_store()
    for name, value in tdmm.params_from_jax(params0, dtype).items():
        store.set_unconstrained(name, value)
    return dmm


@pytest.mark.parametrize("jax_run", NUM_IAFS, indirect=True)
def test_params_from_jax_maps_every_param_once(jax_run):
    mapped = tdmm.params_from_jax(jax_run["params0"])
    assert len(mapped) == len(jax_run["params0"])
    assert sorted(mapped) == sorted(_port_names(jax_run["num_iafs"]))
    dmm = _port_with(jax_run["params0"], jax_run["num_iafs"])
    dmm.guide(torch.tensor(DATA))
    dmm.model(torch.tensor(DATA))
    store = pyro.get_param_store()
    for name, value in mapped.items():
        assert torch.equal(store.get_unconstrained(name).detach(), value), name


def test_the_transition_starts_at_the_identity():
    t = tdmm.GatedTransition(5, 7)
    assert torch.equal(t.z_to_loc.weight, torch.eye(5)) and not t.z_to_loc.bias.any()


@pytest.mark.parametrize("jax_run", NUM_IAFS, indirect=True)
def test_trace_elbo_loss_matches(jax_run, monkeypatch):
    dmm = _port_with(jax_run["params0"], jax_run["num_iafs"])
    monkeypatch.setattr(torch, "randn", _fixed_torch_draw)
    loss = Trace_ELBO().loss(dmm.model, dmm.guide, torch.tensor(DATA))
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-5)


@pytest.mark.parametrize("jax_run", NUM_IAFS, indirect=True)
def test_guide_site_is_reparameterized(jax_run):
    dmm = _port_with(jax_run["params0"], jax_run["num_iafs"])
    guide_trace = poutine.trace(dmm.guide).get_trace(torch.tensor(DATA))
    guide_trace.compute_score_parts()
    parts = guide_trace.nodes["z"]["score_parts"]
    assert parts.score_function == 0 and parts.log_prob.shape == (B,)
    assert guide_trace.nodes["z"]["value"].shape == (B, T, WIDTHS["Z_DIM"])


@functools.cache
def _port_grads(num_iafs, wide=False, dtype=torch.float32):
    """The port's gradients at the weights of ``_jax_run`` of sd ``SD``
    (or, ``wide``, of sd ``SD_WIDE``), in ``dtype``."""
    params0 = _jax_run(num_iafs)["wide_params0" if wide else "params0"]
    dmm = _port_with(params0, num_iafs, dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randn", _fixed_torch_draw)
        Trace_ELBO().differentiable_loss(dmm.model, dmm.guide, torch.tensor(DATA, dtype=dtype)).backward()
    store = pyro.get_param_store()
    grads = {name: store.get_unconstrained(name).grad.numpy().copy() for name in _port_names(num_iafs)}
    pyro.clear_param_store()
    return grads


@pytest.mark.parametrize("jax_run,name", CASES, indirect=["jax_run"])
def test_gradients_match(jax_run, name):
    expected = tdmm.params_from_jax(jax_run["grads"])[name].numpy()
    np.testing.assert_allclose(_port_grads(jax_run["num_iafs"])[name], expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("jax_run,name", CASES, indirect=["jax_run"])
def test_gradients_match_in_float64_at_twice_the_sd(jax_run, name):
    """At sd ``SD_WIDE`` the gradients reach 5e3 with an IAF; both packages in
    float64 on the same float32 weights, data and noise."""
    expected = tdmm.params_from_jax(_jax_wide_grads64(jax_run["num_iafs"]), torch.float64)[name]
    actual = _port_grads(jax_run["num_iafs"], wide=True, dtype=torch.float64)[name]
    np.testing.assert_allclose(actual, expected.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("jax_run", NUM_IAFS, indirect=True)
def test_float32_gradients_are_within_rounding_at_twice_the_sd(jax_run):
    """At sd ``SD_WIDE`` each package's float32 gradients lie within
    1e-5 x the largest entry of each leaf of the float64 ones: where an
    entry is small against its leaf, the two float32 results may differ by
    more than rtol 1e-4, each by its own order of float32 sums."""
    num_iafs = jax_run["num_iafs"]
    exact = tdmm.params_from_jax(_jax_wide_grads64(num_iafs), torch.float64)
    jax32 = tdmm.params_from_jax(jax_run["wide_grads"], torch.float64)
    port32 = _port_grads(num_iafs, wide=True)
    worst = {"jax": 0.0, "port": 0.0}
    for name, g in exact.items():
        scale = g.abs().max().item()
        for side, value in (("jax", jax32[name].numpy()), ("port", port32[name])):
            np.testing.assert_allclose(value, g.numpy(), rtol=0, atol=1e-5 * scale, err_msg=f"{side} {name}")
            worst[side] = max(worst[side], np.abs(value - g.numpy()).max() / scale)
    print(f"num_iafs {num_iafs}: float32 against float64, largest |diff| / leaf max: {worst}")  # shown by -rP


@functools.cache
def _port_trajectory(num_iafs):
    dmm = _port_with(_jax_run(num_iafs)["params0"], num_iafs)
    svi = tdmm.make_svi(dmm, LR)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randn", _fixed_torch_draw)
        for _ in range(STEPS):
            svi.step(torch.tensor(DATA))
            store = pyro.get_param_store()
            out.append({n: store.get_unconstrained(n).detach().numpy().copy() for n in _port_names(num_iafs)})
    pyro.clear_param_store()
    return out


@pytest.mark.parametrize("jax_run,name", CASES, indirect=["jax_run"])
def test_clipped_adam_trajectory_matches(jax_run, name):
    port_trajectory = _port_trajectory(jax_run["num_iafs"])
    for step in range(STEPS):
        expected = tdmm.params_from_jax(jax_run["trajectory"][step])[name].numpy()
        np.testing.assert_allclose(port_trajectory[step][name], expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("jax_run", NUM_IAFS, indirect=True)
def test_some_gradient_entry_is_clipped(jax_run):
    """ClippedAdam's clamp at 10 acts in these steps."""
    assert max(np.abs(g).max() for g in jax_run["grads"].values()) > CLIP


def test_synthetic_data_is_binary_and_seeded():
    data = tdmm.synthetic_data(torch.Generator().manual_seed(0), 3, 5, 4, 6)
    assert data.shape == (3, 5, 6) and set(np.unique(data.numpy())) <= {0.0, 1.0}
    assert torch.equal(data, tdmm.synthetic_data(torch.Generator().manual_seed(0), 3, 5, 4, 6))


def test_main_trains_at_small_width(monkeypatch, capsys):
    for name, value in WIDTHS.items():
        monkeypatch.setattr(tdmm, name, value)
    svi = tdmm.main(tdmm.parse_args(["--batch-size", "4", "--length", "7", "--num-steps", "6", "--num-iafs", "1"]))
    assert "6 steps in" in capsys.readouterr().out
    assert "iaf_0$$$output_layer.weight" in pyro.get_param_store()
    assert np.isfinite(svi.evaluate_loss(torch.zeros(B, T, WIDTHS["X_DIM"]), 1.0))
