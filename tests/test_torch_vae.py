"""The port's VAE slice against the JAX package, on the CPU: the Normal and
HalfCauchy distributions, and SVI on the VAE of ``examples/vae.py`` with
Trace_ELBO and Adam at a small width (B=8, X=20, H=16, Z=4).

The weights are drawn with numpy and loaded into both packages (into the
port through ``params_from_jax``), and the guide's standard-normal noise is
shared by patching each package's draw inside the test, so loss, gradients
and the Adam trajectory must agree.  Tolerances: distributions rtol 1e-6;
loss rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 * max|g|; params after 3
Adam steps rtol 1e-4 with atol 1e-5 (those of ``test_torch_svi_hmm.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.vae as jvae
import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu.infer import SVI as JSVI
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.optim import Adam as JAdam
from pyro_tpu_torch import poutine
from pyro_tpu_torch.examples import vae as tvae
from pyro_tpu_torch.infer import Trace_ELBO

B, X, H, Z, STEPS, LR = 8, 20, 16, 4, 3, 1e-3
PARAM_NAMES = [
    f"{module}$$${layer}.{kind}"
    for module, layers in (("encoder", ("fc", "loc", "log_scale")), ("decoder", ("fc", "out")))
    for layer in layers
    for kind in ("weight", "bias")
]
RNG = np.random.default_rng(5)
DATA = (RNG.random((B, X)) < 0.4).astype(np.float32)
EPS = RNG.standard_normal((B, Z)).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _fixed_jax_draw(value):
    def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        assert tuple(shape) == value.shape, (shape, value.shape)
        return jnp.asarray(value, dtype)

    return draw


def _fixed_torch_draw(value):
    def draw(*shape, generator=None, dtype=None, device=None, **kwargs):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        assert shape == value.shape, (shape, value.shape)
        return torch.tensor(value, dtype=dtype, device=device)

    return draw


# -- distributions ----------------------------------------------------------

LOC, SCALE = RNG.normal(size=(3, 4)).astype(np.float32), RNG.uniform(0.2, 3.0, (3, 4)).astype(np.float32)
VALUE = (RNG.normal(size=(2, 3, 4)) * 2).astype(np.float32)
POS_VALUE = RNG.uniform(0.01, 20.0, (2, 3, 4)).astype(np.float32)
HC_SCALE = RNG.uniform(0.5, 5.0, (4,)).astype(np.float32)


def _dists(d, a):
    return {
        "Normal": (d.Normal(a(LOC), a(SCALE)), VALUE),
        "Normal, scalar params": (d.Normal(0.0, 5.0), VALUE),
        "HalfCauchy": (d.HalfCauchy(a(HC_SCALE)), POS_VALUE),
        "HalfCauchy, scalar scale": (d.HalfCauchy(5.0), POS_VALUE),
    }


DIST_CASES = ["HalfCauchy", "HalfCauchy, scalar scale", "Normal", "Normal, scalar params"]


@pytest.mark.parametrize("case", DIST_CASES)
def test_log_prob_matches_jax(case):
    jd, value = _dists(jdist, jnp.asarray)[case]
    td, _ = _dists(tdist, torch.tensor)[case]
    assert td.batch_shape == jd.batch_shape
    assert td.has_rsample and type(td.support).__name__ == type(jd.support).__name__
    expected = np.asarray(jd.log_prob(jnp.asarray(value)))
    np.testing.assert_allclose(td.log_prob(torch.tensor(value)).numpy(), expected, rtol=1e-6)


@pytest.mark.parametrize("case", DIST_CASES)
def test_rsample_matches_jax_at_shared_noise(case, monkeypatch):
    jd, _ = _dists(jdist, jnp.asarray)[case]
    td, _ = _dists(tdist, torch.tensor)[case]
    shape = (2,) + td.batch_shape
    if case.startswith("Normal"):
        noise = RNG.standard_normal(shape).astype(np.float32)
        monkeypatch.setattr(jax.random, "normal", _fixed_jax_draw(noise))
        monkeypatch.setattr(torch, "randn", _fixed_torch_draw(noise))
    else:
        noise = RNG.uniform(0.0, 0.99, shape).astype(np.float32)
        monkeypatch.setattr(jax.random, "uniform", _fixed_jax_draw(noise))
        monkeypatch.setattr(torch, "rand", _fixed_torch_draw(noise))
    expected = np.asarray(jd.rsample(jax.random.key(0), (2,)))
    actual = td.rsample(None, (2,))
    assert actual.shape == shape
    np.testing.assert_allclose(actual.numpy(), expected, rtol=1e-6)


def test_expand_keeps_density():
    d = tdist.Normal(torch.tensor(LOC[0]), 2.0).expand((3, 4))
    assert d.batch_shape == (3, 4)
    np.testing.assert_allclose(
        d.log_prob(torch.tensor(VALUE)).numpy(), tdist.Normal(torch.tensor(LOC[0]), 2.0).log_prob(torch.tensor(VALUE))
    )
    h = tdist.HalfCauchy(torch.tensor(HC_SCALE)).expand((3, 4))
    assert h.batch_shape == (3, 4) and h.log_prob(torch.tensor(POS_VALUE)).shape == (2, 3, 4)


def test_scalar_params_follow_the_package_device():
    pyro.set_default_device("cuda")
    try:
        if torch.cuda.is_available():
            assert tdist.Normal(0.0, 1.0).loc.is_cuda
        else:
            with pytest.raises(RuntimeError, match="set_default_device"):
                tdist.Normal(0.0, 1.0)
    finally:
        pyro.set_default_device("cpu")


# -- the VAE ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """Loss and gradients at numpy weights, and the params after each of 3
    Adam steps, from the JAX example at the small width."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("X_DIM", X), ("HIDDEN", H), ("Z_DIM", Z)):
            mp.setattr(jvae, name, value)
        x = jnp.asarray(DATA)
        jpyro.clear_param_store()
        JTrace_ELBO().loss(jvae.model, jvae.guide, x, rng_key=jax.random.key(0))  # registers the params
        store = jpyro.get_param_store()
        rng = np.random.default_rng(11)
        params0 = {
            name: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for name, v in store.get_all_unconstrained().items()
        }
        store.set_all_unconstrained({k: jnp.asarray(v) for k, v in params0.items()})
        mp.setattr(jax.random, "normal", _fixed_jax_draw(EPS))
        elbo = JTrace_ELBO()

        def loss_fn(p):
            with ParamsMessenger(p):
                return elbo.differentiable_loss(jvae.model, jvae.guide, x, rng_key=jax.random.key(0))

        loss, grads = jax.value_and_grad(loss_fn)({k: jnp.asarray(v) for k, v in params0.items()})
        svi = JSVI(jvae.model, jvae.guide, JAdam({"lr": LR}), JTrace_ELBO())
        trajectory = []
        for _ in range(STEPS):
            svi.step(x)
            trajectory.append({k: np.asarray(v) for k, v in store.get_all_unconstrained().items()})
        jpyro.clear_param_store()
    return {
        "params0": params0,
        "loss": float(loss),
        "grads": {k: np.asarray(v) for k, v in grads.items()},
        "trajectory": trajectory,
    }


def _port_vae(params0):
    """The port's VAE with the JAX weights in the param store; the modules
    take them at their first ``pyro.module`` call."""
    pyro.clear_param_store()
    vae = tvae.VAE(X, H, Z)
    store = pyro.get_param_store()
    for name, value in tvae.params_from_jax(params0).items():
        store.set_unconstrained(name, value)
    return vae


def test_params_from_jax_names(jax_run):
    mapped = tvae.params_from_jax(jax_run["params0"])
    assert sorted(mapped) == sorted(PARAM_NAMES)
    vae = tvae.VAE(X, H, Z)
    shapes = {f"{m}$$${n}": tuple(p.shape) for m in ("encoder", "decoder") for n, p in getattr(vae, m).named_parameters()}
    assert {name: tuple(v.shape) for name, v in mapped.items()} == shapes


def test_trace_elbo_loss_matches(jax_run, monkeypatch):
    vae = _port_vae(jax_run["params0"])
    monkeypatch.setattr(torch, "randn", _fixed_torch_draw(EPS))
    loss = Trace_ELBO().loss(vae.model, vae.guide, torch.tensor(DATA))
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-5)


def test_reparameterized_guide_site_has_no_score_term(jax_run):
    vae = _port_vae(jax_run["params0"])
    guide_trace = poutine.trace(vae.guide).get_trace(torch.tensor(DATA))
    guide_trace.compute_score_parts()
    parts = guide_trace.nodes["z"]["score_parts"]
    assert parts.score_function == 0
    assert parts.entropy_term is parts.log_prob and parts.log_prob.shape == (B,)
    assert guide_trace.nodes["z"]["value"].requires_grad


@pytest.fixture(scope="module")
def port_grads(jax_run):
    pyro.set_default_device("cpu")
    vae = _port_vae(jax_run["params0"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randn", _fixed_torch_draw(EPS))
        Trace_ELBO().differentiable_loss(vae.model, vae.guide, torch.tensor(DATA)).backward()
    store = pyro.get_param_store()
    grads = {name: store.get_unconstrained(name).grad.numpy().copy() for name in PARAM_NAMES}
    pyro.clear_param_store()
    return grads


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_gradients_match(jax_run, port_grads, name):
    expected = tvae.params_from_jax(jax_run["grads"])[name].numpy()
    np.testing.assert_allclose(port_grads[name], expected, rtol=1e-4, atol=1e-6 * np.abs(expected).max())


@pytest.fixture(scope="module")
def port_trajectory(jax_run):
    pyro.set_default_device("cpu")
    vae = _port_vae(jax_run["params0"])
    svi = tvae.make_svi(vae, LR)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randn", _fixed_torch_draw(EPS))
        for _ in range(STEPS):
            svi.step(torch.tensor(DATA))
            store = pyro.get_param_store()
            out.append({name: store.get_unconstrained(name).detach().numpy().copy() for name in PARAM_NAMES})
    pyro.clear_param_store()
    return out


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_adam_trajectory_matches(jax_run, port_trajectory, name):
    for step in range(STEPS):
        expected = tvae.params_from_jax(jax_run["trajectory"][step])[name].numpy()
        np.testing.assert_allclose(port_trajectory[step][name], expected, rtol=1e-4, atol=1e-5)


def test_training_lowers_the_loss():
    pyro.clear_param_store()
    torch.manual_seed(0)
    vae = tvae.VAE(X, H, Z)
    data = tvae.synthetic_batches(0, 4, B, X)
    assert data.shape == (4, B, X) and set(np.unique(data.numpy())) <= {0.0, 1.0}
    svi = tvae.make_svi(vae, lr=1e-2)
    generator = torch.Generator().manual_seed(0)
    losses = [svi.step(data[i % 4], generator=generator) for i in range(60)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
