"""The port's Gaussian-process time series against the JAX package and
direct forms, on the CPU.

Inputs are drawn with numpy from a seed at small sizes (T <= 24, obs_dim
<= 3).  What is compared, and within what:

(a) ``MaternKernel`` at nu 0.5, 1.5 and 2.5 against the JAX one (float32,
    within 1e-6 times each matrix's largest entry: Q = P - A P A^T
    cancels), and in float64 against ``scipy.linalg.expm(F
    dt)`` and the stationary covariance that solves the continuous
    Lyapunov equation F P + P F^T + L q L^T = 0 (atol 1e-12);
    ``DependentMaternGP._stationary_covariance`` against
    ``scipy.linalg.solve_continuous_lyapunov`` for the coupled SSM (rtol
    1e-10, atol 1e-12 times its largest entry);
(b) ``log_prob`` of the four GP models with the JAX parameters carried
    across by ``param_store_from_jax``: rtol 1e-5; the gradient of every
    unconstrained parameter of the maximum-likelihood model within 1e-3 *
    its max|grad| (float32 rounds the obs-noise gradient, the smallest, at
    1e-4 to 2e-4 of itself in either package against a float64 run); ``IndependentMaternGP.forecast`` (mean and scale) within
    1e-5 * max + 1e-6, and the other models' ``forecast`` raising as the
    JAX ones do;
(c) ``IndependentMaternGP.log_prob`` in float64 against a dense Matern GP
    density (a T x T kernel matrix plus noise) built here: rtol 1e-6 (the
    SSM adds 1e-6 I to each step's process noise);
(d) three SVI steps of ``examples/timeseries_gp.py``'s ``make_svi`` (the
    example's own imgp and lcmgp at its widths, and the other two models)
    against three steps of the JAX package's Adam (lr 0.01) on the JAX
    example's loss: each unconstrained parameter after every step within
    rtol and atol 1e-4;
(e) the exports of ``pyro_tpu_torch.contrib.timeseries`` and
    ``block_diag_embed``.

The JAX side runs under ``jax.jit``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import pyro_tpu as jpyro
import pyro_tpu.contrib.timeseries as jts
import pyro_tpu_torch as pyro
import pyro_tpu_torch.contrib.timeseries as tts
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.ops import ssm_gp as jssm
from pyro_tpu.ops.tensor_utils import block_diag_embed as jblock_diag_embed
from pyro_tpu.optim import Adam as JAdam
from pyro_tpu_torch import poutine
from pyro_tpu_torch.examples import timeseries_gp as example
from pyro_tpu_torch.infer import Trace_ELBO
from pyro_tpu_torch.ops import ssm_gp as tssm
from pyro_tpu_torch.ops.tensor_utils import block_diag_embed
from pyro_tpu_torch.params import param_store_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    jpyro.clear_param_store()
    yield
    pyro.clear_param_store()
    jpyro.clear_param_store()


def _no_guide(*args):
    return None


def _near(actual, expected, scale, atol=0.0):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=scale * np.abs(expected).max() + atol)


# -- (a) MaternKernel ----------------------------------------------------------------

NUS = [0.5, 1.5, 2.5]
LS = np.array([0.6, 1.3, 4.0])
KS = np.array([1.2, 0.5, 2.0])


@pytest.mark.parametrize("nu", NUS)
def test_matern_kernel_matches_jax(nu):
    dt = 0.7
    jk, tk = jssm.MaternKernel(nu, 3), tssm.MaternKernel(nu, 3)
    ls32, ks32 = LS.astype(np.float32), KS.astype(np.float32)
    jA, jQ = jk.transition_matrix_and_covariance(jnp.asarray(ls32), jnp.asarray(ks32), dt)
    tA, tQ = tk.transition_matrix_and_covariance(torch.tensor(ls32), torch.tensor(ks32), dt)
    jP = jk.stationary_covariance(jnp.asarray(ls32), jnp.asarray(ks32))
    tP = tk.stationary_covariance(torch.tensor(ls32), torch.tensor(ks32))
    for t, j in ((tA, jA), (tQ, jQ), (tP, jP)):
        _near(t.numpy(), j, scale=1e-6)
    assert tk.state_dim == jk.state_dim == int(nu + 0.5)


def _matern_sde(nu, ls, ks):
    """F, the spectral density q and the noise selector L of the Matern SDE."""
    if nu == 0.5:
        lam = 1.0 / ls
        return np.array([[-lam]]), 2 * ks**2 * lam
    if nu == 1.5:
        lam = math.sqrt(3.0) / ls
        return np.array([[0.0, 1.0], [-lam**2, -2 * lam]]), 4 * ks**2 * lam**3
    lam = math.sqrt(5.0) / ls
    F = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-lam**3, -3 * lam**2, -3 * lam]])
    return F, 16.0 / 3.0 * ks**2 * lam**5


@pytest.mark.parametrize("nu", NUS)
def test_matern_kernel_matches_expm_and_lyapunov(nu):
    dt = 0.7
    k = tssm.MaternKernel(nu, 3)
    ls, ks = torch.tensor(LS), torch.tensor(KS)
    A, Q = k.transition_matrix_and_covariance(ls, ks, dt)
    P = k.stationary_covariance(ls, ks)
    for g in range(3):
        F, q = _matern_sde(nu, LS[g], KS[g])
        L = np.zeros((k.state_dim, 1))
        L[-1] = 1.0
        expected_A = scipy.linalg.expm(F * dt)
        expected_P = scipy.linalg.solve_continuous_lyapunov(F, -q * L @ L.T)
        np.testing.assert_allclose(A[g].numpy(), expected_A, rtol=0, atol=1e-12)
        np.testing.assert_allclose(P[g].numpy(), expected_P, rtol=0, atol=1e-12 * np.abs(expected_P).max())
        expected_Q = expected_P - expected_A @ expected_P @ expected_A.T + 1e-6 * np.eye(k.state_dim)
        np.testing.assert_allclose(Q[g].numpy(), expected_Q, rtol=0, atol=1e-12 * np.abs(expected_P).max())


def test_matern_kernel_gradients_reach_the_scales():
    ls = torch.tensor(LS, requires_grad=True)
    ks = torch.tensor(KS, requires_grad=True)
    A, Q = tssm.MaternKernel(2.5, 3).transition_matrix_and_covariance(ls, ks, 0.7)
    (A.sum() + Q.sum()).backward()
    assert bool((ls.grad != 0).all()) and bool((ks.grad != 0).all())


def test_dependent_matern_gp_stationary_covariance_solves_lyapunov():
    n = 3
    gp = tts.DependentMaternGP(obs_dim=n, length_scale_init=torch.tensor([0.7, 1.5, 3.0], dtype=torch.float64),
                               name="dmgp")
    tril = gp.wiener_noise_tril.detach().double().numpy()
    param_store_from_jax({"dmgp.wiener_noise_tril": tril})  # the float32 init, held in float64
    S = gp._stationary_covariance().detach().numpy()
    rho = math.sqrt(3.0) / np.array([0.7, 1.5, 3.0])
    F = scipy.linalg.block_diag(*[np.array([[0.0, 1.0], [-r**2, -2 * r]]) for r in rho])
    L = np.zeros((2 * n, n))
    L[2 * np.arange(n) + 1, np.arange(n)] = 1.0
    expected = scipy.linalg.solve_continuous_lyapunov(F, -L @ (tril @ tril.T) @ L.T)
    np.testing.assert_allclose(S, expected, rtol=1e-10, atol=1e-12 * np.abs(expected).max())


# -- (b) the four models against the JAX package ----------------------------------------

T, STEPS = 16, 3
# name -> (class name, constructor kwargs); imgp and lcmgp at the example's widths
MODELS = {
    "imgp": ("IndependentMaternGP", {"nu": 1.5, "obs_dim": 2}),
    "lcmgp": ("LinearlyCoupledMaternGP", {"nu": 1.5, "obs_dim": 2, "num_gps": 2}),
    "dmgp": ("DependentMaternGP", {"obs_dim": 3, "linearly_coupled": True}),
    "lgssmgp": ("GenericLGSSMWithGPNoiseModel", {"obs_dim": 3, "state_dim": 2, "nu": 0.5}),
}


def _targets(kwargs):
    return example.synthetic_series(0, T, kwargs["obs_dim"])


def _factor_model(lib, gp):
    def model(targets):
        lib.factor("log_prob", gp.log_prob(targets))

    return model


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_gp(request):
    """The JAX model's initial params (constrained), its log_prob, the
    maximum-likelihood loss (-log_prob summed, the example's Trace_ELBO loss
    with the empty guide) and gradients, for ``IndependentMaternGP`` the
    forecast at dts 1 and 2.5, all from one jitted function of the
    unconstrained params; and the unconstrained params after each of 3
    steps of the JAX package's Adam (lr 0.01) on those gradients."""
    cls, kwargs = MODELS[request.param]
    jpyro.clear_param_store()
    gp = getattr(jts, cls)(name="gp", **kwargs)
    store = jpyro.get_param_store()
    for name, (init, constraint) in gp._param_defs.items():  # as gp.get_dist() would, without eager ops
        store.setdefault(f"gp.{name}", init, constraint)
    targets = jnp.asarray(_targets(kwargs))

    def loss_fn(p):
        with ParamsMessenger(p):
            log_prob = gp.log_prob(targets)
            if cls != "IndependentMaternGP":
                return -log_prob.sum(), (log_prob, ())
            fc = gp.forecast(targets, jnp.asarray([1.0, 2.5]))
            return -log_prob.sum(), (log_prob, (fc.loc, fc.scale))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = store.get_all_unconstrained()
    (loss, (log_prob, forecast)), grads = value_and_grad(params)
    out = {
        "cls": cls, "kwargs": kwargs, "init": {k: np.asarray(v) for k, v in store.items()},
        "log_prob": np.asarray(log_prob), "loss": float(loss), "grads": {k: np.asarray(v) for k, v in grads.items()},
        "trajectory": [],
    }
    if forecast:
        out["forecast"] = tuple(np.asarray(x) for x in forecast)
    optim = JAdam({"lr": 0.01})
    opt_state = optim.init(params)
    for step in range(STEPS):
        if step:
            _, grads = value_and_grad(params)
        params, opt_state = optim.update(grads, opt_state, params)
        out["trajectory"].append({k: np.asarray(v) for k, v in params.items()})
    jpyro.clear_param_store()
    return out


def _port_gp(jax_gp):
    gp = getattr(tts, jax_gp["cls"])(name="gp", **jax_gp["kwargs"])
    gp.get_dist()  # registers the params
    param_store_from_jax(jax_gp["init"])
    return gp


def test_gp_log_prob_matches_jax(jax_gp):
    gp = _port_gp(jax_gp)
    with torch.no_grad():
        got = gp.log_prob(torch.tensor(_targets(jax_gp["kwargs"]))).numpy()
    np.testing.assert_allclose(got, jax_gp["log_prob"], rtol=1e-5)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_gp_float64_parameters_keep_their_dtype(model):
    """Float64 parameters under the float32 default: every matrix of the
    HMM takes the parameters' dtype, so log_prob equals, bit for bit, the
    one computed with the float64 default."""
    cls, kwargs = MODELS[model]
    targets = torch.tensor(_targets(kwargs), dtype=torch.float64)
    gp = getattr(tts, cls)(name="gp", **kwargs)
    gp.get_dist()  # registers the params
    store = pyro.get_param_store()
    params64 = {k: store[k].detach().double().numpy() for k in store.get_all_unconstrained()}
    param_store_from_jax(params64)
    with torch.no_grad():
        got = gp.log_prob(targets)
    pyro.clear_param_store()
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        gp64 = getattr(tts, cls)(name="gp", **kwargs)
        gp64.get_dist()
        param_store_from_jax(params64)
        with torch.no_grad():
            expected = gp64.log_prob(targets)
    finally:
        torch.set_default_dtype(saved)
    assert got.dtype == torch.float64
    assert torch.equal(got, expected)


def test_gp_gradients_match_jax(jax_gp):
    gp = _port_gp(jax_gp)
    with poutine.trace(param_only=True) as capture:
        loss = Trace_ELBO().differentiable_loss(_factor_model(pyro, gp), _no_guide,
                                                torch.tensor(_targets(jax_gp["kwargs"])))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jax_gp["loss"], rel=1e-5)
    store = pyro.get_param_store()
    assert sorted(capture.trace.param_nodes()) == sorted(jax_gp["grads"])
    for name, expected in jax_gp["grads"].items():
        _near(store.get_unconstrained(name).grad.numpy(), expected, scale=1e-3)


def test_gp_forecast_matches_jax(jax_gp):
    gp = _port_gp(jax_gp)
    targets = torch.tensor(_targets(jax_gp["kwargs"]))
    if "forecast" not in jax_gp:
        with pytest.raises(NotImplementedError):
            gp.forecast(targets, [1.0])
        return
    with torch.no_grad():
        got = gp.forecast(targets, torch.tensor([1.0, 2.5]))
    for t, j in zip((got.loc, got.scale), jax_gp["forecast"]):
        _near(t.numpy(), j, scale=1e-5, atol=1e-6)


# -- (c) IndependentMaternGP against a dense GP ------------------------------------------


def _matern(nu, r, ls, ks):
    if nu == 0.5:
        return ks**2 * np.exp(-r / ls)
    if nu == 1.5:
        a = math.sqrt(3.0) * r / ls
        return ks**2 * (1 + a) * np.exp(-a)
    a = math.sqrt(5.0) * r / ls
    return ks**2 * (1 + a + a**2 / 3.0) * np.exp(-a)


@pytest.mark.parametrize("nu", NUS)
def test_independent_matern_gp_matches_dense_gp(nu):
    dt, n = 0.37, 2
    rng = np.random.default_rng(5)
    ls, ks, noise = (0.5 + rng.uniform(size=n) for _ in range(3))
    y = rng.standard_normal((T, n))
    gp = tts.IndependentMaternGP(nu=nu, dt=dt, obs_dim=n, length_scale_init=torch.tensor(ls),
                                 kernel_scale_init=torch.tensor(ks), obs_noise_scale_init=torch.tensor(noise))
    with torch.no_grad():
        got = gp.log_prob(torch.tensor(y)).numpy()
    assert got.dtype == np.float64
    r = dt * np.abs(np.arange(T)[:, None] - np.arange(T)[None, :])
    for d in range(n):
        K = _matern(nu, r, ls[d], ks[d]) + noise[d] ** 2 * np.eye(T)
        _, logdet = np.linalg.slogdet(K)
        expected = -0.5 * (y[:, d] @ np.linalg.solve(K, y[:, d]) + logdet + T * math.log(2 * math.pi))
        assert got[d] == pytest.approx(expected, rel=1e-6)


# -- (d) the example's SVI against the JAX package's Adam --------------------------------


def test_example_svi_trajectory_matches_jax(jax_gp):
    gp = _port_gp(jax_gp)
    name = {"IndependentMaternGP": "imgp", "LinearlyCoupledMaternGP": "lcmgp"}.get(jax_gp["cls"])
    if name is not None:  # the example's own models, at its widths
        shapes = {k: tuple(v.shape) for k, v in pyro.get_param_store().get_all_unconstrained().items()}
        pyro.clear_param_store()
        gp = example.make_gp(name, name="gp")
        gp.get_dist()
        assert {k: tuple(v.shape) for k, v in pyro.get_param_store().get_all_unconstrained().items()} == shapes
        param_store_from_jax(jax_gp["init"])
    svi = example.make_svi(example.make_model(gp))
    targets = torch.tensor(_targets(jax_gp["kwargs"]))
    store = pyro.get_param_store()
    for step in range(STEPS):
        svi.step(targets)
        for k, expected in jax_gp["trajectory"][step].items():
            np.testing.assert_allclose(store.get_unconstrained(k).detach().numpy(), expected, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} after step {step + 1}")
    if name is not None:
        with torch.no_grad():
            forecast = example.one_step_forecast(gp, targets)
        assert forecast.shape == (2,) and bool(forecast.isfinite().all())


# -- (e) exports and helpers --------------------------------------------------------------


def test_timeseries_exports_match_jax():
    assert sorted(tts.__all__) == sorted(jts.__all__)
    for name in tts.__all__:
        assert hasattr(tts, name)


def test_block_diag_embed_matches_jax():
    mat = np.random.default_rng(3).standard_normal((2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(block_diag_embed(torch.tensor(mat)).numpy(),
                                  np.asarray(jblock_diag_embed(jnp.asarray(mat))))
