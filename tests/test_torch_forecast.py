"""The port's forecasting path against the JAX package and exact forms, on
the CPU.

Inputs are drawn with numpy from a seed at small sizes.  What is compared,
and within what (rel 1e-5 unless a line says otherwise):

(a) ``ops/tensor_utils.py``: ``dct``/``idct`` along the last and an inner
    dim (within 1e-5 of the largest entry), ``haar_transform``
    and its inverse at even and odd lengths, ``periodic_repeat``,
    ``periodic_cumsum``, ``periodic_features``, ``next_fast_len``,
    ``convolve`` in its three modes, ``repeated_matmul``;
(b) ``DCTAdam``: five updates of parameters of shapes (3, 4), (6, 1), (5,)
    and () from the same gradients against the JAX optax chain (rtol 1e-5,
    atol 5e-6: optax rounds its bias correction in float32; a new
    optimiser loads the saved state after the second);
    the schedulers' learning-rate sequences over eight steps, read from
    Adam steps on constant gradients (each step is -lr(t) / (1 + 1e-8)),
    against the JAX package's (rtol 2e-5: optax rounds its bias correction
    in float32) and the closed forms (rtol 1e-6);
(c) ``prefix_condition`` for each registered type, ``GaussianHMM``
    (homogeneous and with a transition per step) and ``IndependentHMM``
    included: the conditioned distribution's shapes and parameters (the
    HMM's initial Gaussian) and the ``log_prob`` of a fixed future;
(d) the example's ``Model`` and ``tests/test_forecast.py``'s
    ``HMMTrendModel``: -ELBO at one latent value (the AutoNormal guide's
    sites conditioned, the JAX store carried across by
    ``param_store_from_jax``) and its gradients within 1e-5 times each
    parameter's max|grad|, and the gradient of the model's log joint with
    respect to the latent values (through the GaussianHMM's ``log_prob``)
    against the JAX package's float64 run: within 1e-7 of the largest in
    float64, 1e-3 in float32;
(e) the Haar- and DCT-reparametrised model's log joint at fixed values
    against the JAX package's (with a dict config), and against the
    model without the reparam at the inverse-transformed values (less the
    smoothed DCT's log|det J|); the JAX ``HMCForecaster`` with a time
    reparam recurses (a strict xfail), the port's fits and forecasts
    through the reparametrised model;
(f) ``eval_mae``, ``eval_rmse`` and ``eval_crps`` on the same arrays;
(g) the example at 30 steps and 20 draws: with the latents at the guide's
    median, 4000 draws of the prefix-conditioned noise within 5 standard
    errors (mean) and 10% (variance) of the exact conditional moments of
    the local-level model, computed densely in float64, and the
    forecaster's own 20 draws within 5 standard errors of the exact mean.
"""

import contextlib
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu import optim as joptim
from pyro_tpu import poutine as jpoutine
from pyro_tpu.contrib.forecast import ForecastingModel as JForecastingModel
from pyro_tpu.contrib.forecast import HMCForecaster as JHMCForecaster
from pyro_tpu.contrib.forecast import evaluate as jevaluate
from pyro_tpu.contrib.forecast.forecaster import prefix_condition as jprefix_condition
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer import autoguide as jag
from pyro_tpu.infer import reparam as jreparam
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.ops import tensor_utils as jtu
from pyro_tpu_torch import optim as toptim
from pyro_tpu_torch import poutine
from pyro_tpu_torch.contrib.forecast import Forecaster, ForecastingModel, HMCForecaster, backtest, evaluate
from pyro_tpu_torch.contrib.forecast.forecaster import prefix_condition
from pyro_tpu_torch.examples import forecast_bart as example
from pyro_tpu_torch.infer import Trace_ELBO
from pyro_tpu_torch.infer import autoguide as tag
from pyro_tpu_torch.infer import reparam as treparam
from pyro_tpu_torch.ops import tensor_utils as tu
from pyro_tpu_torch.params import param_store_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
RNG = np.random.default_rng(19)
F32 = np.float32


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jexample = _load(os.path.join(HERE, os.pardir, "examples", "forecast_bart.py"), "jax_forecast_bart")
jtests = _load(os.path.join(HERE, "test_forecast.py"), "jax_test_forecast")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    # each test draws from the same state, whichever tests ran before it
    RNG.bit_generator.state = np.random.default_rng(19).bit_generator.state
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    jpyro.clear_param_store()
    yield
    pyro.clear_param_store()
    jpyro.clear_param_store()
    # the JAX package caches its DCT matrix by length: one made while a test
    # traced a jitted function is a tracer that a later eager call would meet
    jtu._dct_matrix.cache_clear()


def _near(actual, expected, rel=1e-5, atol=0.0):
    actual = np.asarray(actual.detach() if isinstance(actual, torch.Tensor) else actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rel * np.abs(expected).max() + atol)


# -- (a) tensor utilities ---------------------------------------------------------------


@pytest.mark.parametrize("dim, shape", [(-1, (3, 16)), (-1, (2, 13)), (-2, (9, 4)), (-1, (1,)), (-1, (2, 168))])
def test_dct_matches_jax(dim, shape):
    x = RNG.normal(size=shape).astype(F32)
    y = tu.dct(torch.tensor(x), dim)
    _near(y, jtu.dct(jnp.asarray(x), dim))
    _near(tu.idct(torch.tensor(x), dim), jtu.idct(jnp.asarray(x), dim))
    _near(tu.idct(y, dim), x)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 13, 168])
def test_haar_transform_matches_jax(n):
    x = RNG.normal(size=(3, n)).astype(F32)
    y = tu.haar_transform(torch.tensor(x))
    _near(y, jtu.haar_transform(jnp.asarray(x)))
    _near(tu.inverse_haar_transform(torch.tensor(x)), jtu.inverse_haar_transform(jnp.asarray(x)))
    _near(tu.inverse_haar_transform(y), x)
    np.testing.assert_allclose((y**2).sum(-1).numpy(), (x**2).sum(-1), rtol=1e-5)  # orthonormal


def test_periodic_utilities_match_jax():
    x = RNG.normal(size=(2, 7, 3)).astype(F32)
    for size, dim in ((20, -2), (5, -2), (10, -1)):
        _near(tu.periodic_repeat(torch.tensor(x), size, dim), jtu.periodic_repeat(jnp.asarray(x), size, dim))
    for period, dim in ((3, -2), (7, -2), (2, -1), (1, -3)):
        _near(tu.periodic_cumsum(torch.tensor(x), period, dim), jtu.periodic_cumsum(jnp.asarray(x), period, dim))
    for kwargs in ({}, {"max_period": 24.0, "min_period": 3}):
        _near(tu.periodic_features(50, **kwargs), jtu.periodic_features(50, **kwargs), atol=1e-6)


def test_fft_utilities_match_jax():
    for size in (1, 5, 7, 11, 97, 1000):
        assert tu.next_fast_len(size) == jtu.next_fast_len(size)
    signal, kernel = RNG.normal(size=(2, 17)).astype(F32), RNG.normal(size=(2, 5)).astype(F32)
    for mode in ("full", "valid", "same"):
        _near(tu.convolve(torch.tensor(signal), torch.tensor(kernel), mode),
              jtu.convolve(jnp.asarray(signal), jnp.asarray(kernel), mode), atol=1e-6)
    M = (0.5 * RNG.normal(size=(2, 3, 3))).astype(F32)
    _near(tu.repeated_matmul(torch.tensor(M), 6), jtu.repeated_matmul(jnp.asarray(M), 6))


# -- (b) DCTAdam and the schedulers -------------------------------------------------------

SHAPES = {"a": (3, 4), "b": (6, 1), "c": (5,), "s": ()}


def _trajectories(name, args, grads, params0, tmp_path, save_at=None):
    jopt = getattr(joptim, name)(args)
    jparams, expected = {k: jnp.asarray(v) for k, v in params0.items()}, []
    for g in grads:
        jparams = jopt(jparams, {k: jnp.asarray(v) for k, v in g.items()})
        expected.append({k: np.asarray(v) for k, v in jparams.items()})
    topt = getattr(toptim, name)(args)
    tparams, actual = {k: torch.tensor(v, requires_grad=True) for k, v in params0.items()}, []
    for i, g in enumerate(grads):
        if i == save_at:  # a new optimiser from the saved state takes over
            topt.save(tmp_path / "optim.pt")
            topt = getattr(toptim, name)(args)
            topt.load(tmp_path / "optim.pt")
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        topt(tparams)
        actual.append({k: p.detach().numpy().copy() for k, p in tparams.items()})
    return actual, expected


def test_dct_adam_matches_jax(tmp_path):
    params0 = {k: RNG.normal(size=s).astype(F32) for k, s in SHAPES.items()}
    grads = [{k: (2 * RNG.normal(size=s)).astype(F32) for k, s in SHAPES.items()} for _ in range(5)]
    actual, expected = _trajectories("DCTAdam", {"lr": 0.05}, grads, params0, tmp_path, save_at=2)
    # optax forms 1 - b2^t in float32, 1.3e-5 of a step (at most lr) off:
    # up to 5 * 0.05 * 1.3e-5 = 3.3e-6 over five steps (3.2e-6 the largest
    # seen over 40 seeds); the port's counts are float64
    for a, e in zip(actual, expected, strict=True):
        for k in SHAPES:
            np.testing.assert_allclose(a[k], e[k], rtol=1e-5, atol=5e-6)


def test_dct_adam_keeps_its_moments_over_frequencies():
    """A gradient that is one DCT basis vector moves only that frequency's
    moments: the others stay 0 (to float32 rounding)."""
    opt = toptim.DCTAdam({"lr": 0.1})
    p = torch.zeros(8, requires_grad=True)
    p.grad = tu.idct(torch.eye(8)[3])
    opt({"p": p})
    state = opt.get_state()["states"]["p"][0]
    others = torch.cat([state["mu"][:3], state["mu"][4:]])
    assert float(state["mu"][3]) == pytest.approx(0.1, rel=1e-6) and float(others.abs().max()) < 1e-7
    assert state["count"].ndim == 0 and float(state["count"]) == 1.0


SCHEDULERS = {
    "ExponentialLR": ({"lr": 0.1, "gamma": 0.8}, lambda t: 0.1 * 0.8**t),
    "StepLR": ({"lr": 0.1, "step_size": 3, "gamma": 0.5}, lambda t: 0.1 * 0.5 ** (t // 3)),
    "MultiStepLR": ({"lr": 0.1, "milestones": [2, 5], "gamma": 0.5}, lambda t: 0.1 * 0.5 ** ((t >= 2) + (t >= 5))),
    "CosineAnnealingLR": ({"lr": 0.1, "T_max": 5}, lambda t: 0.1 * 0.5 * (1 + math.cos(math.pi * min(t, 5) / 5))),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_learning_rates_match_jax(name, tmp_path):
    args, closed_form = SCHEDULERS[name]
    params0 = {"x": np.zeros(3, F32)}
    grads = [{"x": np.ones(3, F32)} for _ in range(8)]
    actual, expected = _trajectories(name, args, grads, params0, tmp_path, save_at=4)
    steps = lambda traj: -np.diff([np.zeros(3)] + [t["x"] for t in traj], axis=0)[:, 0]  # noqa: E731
    # optax forms 1 - 0.999^t in float32, 1.3e-5 of itself off at t = 1, so
    # the JAX package's first steps are 1e-5 short of the closed form; the
    # port's counts are float64
    np.testing.assert_allclose(steps(actual), steps(expected), rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(steps(actual), [closed_form(t) / (1 + 1e-8) for t in range(8)], rtol=1e-6)


# -- (c) prefix_condition ----------------------------------------------------------------

T, D, T_OBS = 7, 2, 3
LOC, SCALE = RNG.normal(size=(T, D)).astype(F32), np.exp(0.2 * RNG.normal(size=(T, D))).astype(F32)
POS = np.exp(0.3 * RNG.normal(size=(T, D))).astype(F32)
PROBS = RNG.uniform(0.2, 0.8, size=(T, D)).astype(F32)
MASK = RNG.random((T, D)) < 0.6
TRIL = np.tril(0.3 * RNG.normal(size=(T, D, D))).astype(F32) + np.eye(D, dtype=F32)
COUNTS = RNG.poisson(3.0, size=(T, D)).astype(F32)
BITS = (RNG.random((T, D)) < 0.5).astype(F32)
REAL = RNG.normal(size=(T, D)).astype(F32)
UNIT = RNG.uniform(0.1, 0.9, size=(T, D)).astype(F32)
HIDDEN = 2


def _ghmm(d, a, heterogeneous):
    init = d.MultivariateNormal(a(np.zeros(HIDDEN, F32)), scale_tril=a(np.eye(HIDDEN, dtype=F32)))
    trans_matrix = a((0.9 * np.eye(HIDDEN) + 0.05 * RNG_FIXED.normal(size=((T,) if heterogeneous else ())
                                                                      + (HIDDEN, HIDDEN))).astype(F32))
    trans = d.MultivariateNormal(a(np.zeros(HIDDEN, F32)), scale_tril=a(0.3 * np.eye(HIDDEN, dtype=F32)))
    obs_matrix = a(OBS_MATRIX)
    obs = d.MultivariateNormal(a(np.zeros(D, F32)), scale_tril=a(0.5 * np.eye(D, dtype=F32)))
    return d.GaussianHMM(init, trans_matrix, trans, obs_matrix, obs, duration=T)


OBS_MATRIX = RNG.normal(size=(HIDDEN, D)).astype(F32)
RNG_FIXED = np.random.default_rng(5)


def _independent_hmm(d, a):
    init = d.MultivariateNormal(a(np.zeros((D, 1), F32)), covariance_matrix=a(np.eye(1, dtype=F32)))
    trans_matrix = a(np.broadcast_to(0.8 * np.eye(1, dtype=F32), (D, 1, 1, 1)).copy())
    trans = d.MultivariateNormal(a(np.zeros((D, 1, 1), F32)), covariance_matrix=a(0.2 * np.eye(1, dtype=F32)))
    obs_matrix = a(np.broadcast_to(np.eye(1, dtype=F32), (D, 1, 1, 1)).copy())
    obs = d.MultivariateNormal(a(np.zeros((D, 1, 1), F32)), covariance_matrix=a(0.1 * np.eye(1, dtype=F32)))
    return d.IndependentHMM(d.GaussianHMM(init, trans_matrix, trans, obs_matrix, obs, duration=T))


# name -> (build(d, a), observed prefix, fixed future, the conditioned family's parameters)
PREFIX_CASES = {
    "Bernoulli": (lambda d, a: d.Bernoulli(probs=a(PROBS)).to_event(2), BITS, BITS, ("probs",)),
    "Beta": (lambda d, a: d.Beta(a(POS), a(POS + 1)).to_event(2), UNIT, UNIT, ("concentration1", "concentration0")),
    "Cauchy": (lambda d, a: d.Cauchy(a(LOC), a(SCALE)).to_event(2), REAL, REAL, ("loc", "scale")),
    "Exponential": (lambda d, a: d.Exponential(a(POS)).to_event(2), POS, POS, ("rate",)),
    "Gamma": (lambda d, a: d.Gamma(a(POS), a(SCALE)).to_event(2), POS, POS, ("concentration", "rate")),
    "GammaPoisson": (lambda d, a: d.GammaPoisson(a(POS), a(SCALE)).to_event(2), COUNTS, COUNTS,
                     ("concentration", "rate")),
    "Geometric": (lambda d, a: d.Geometric(probs=a(PROBS)).to_event(2), COUNTS, COUNTS, ("probs",)),
    "InverseGamma": (lambda d, a: d.InverseGamma(a(POS + 1), a(SCALE)).to_event(2), POS, POS,
                     ("concentration", "rate")),
    "Laplace": (lambda d, a: d.Laplace(a(LOC), a(SCALE)).to_event(2), REAL, REAL, ("loc", "scale")),
    "LogNormal": (lambda d, a: d.LogNormal(a(LOC), a(SCALE)).to_event(2), POS, POS, ("loc", "scale")),
    "NegativeBinomial": (lambda d, a: d.NegativeBinomial(a(POS * 3), probs=a(PROBS)).to_event(2), COUNTS, COUNTS,
                         ("total_count", "probs")),
    "Normal": (lambda d, a: d.Normal(a(LOC), a(SCALE)).to_event(2), REAL, REAL, ("loc", "scale")),
    "Poisson": (lambda d, a: d.Poisson(a(POS)).to_event(2), COUNTS, COUNTS, ("rate",)),
    "StudentT": (lambda d, a: d.StudentT(a(POS + 2), a(LOC), a(SCALE)).to_event(2), REAL, REAL,
                 ("df", "loc", "scale")),
    "Uniform": (lambda d, a: d.Uniform(a(LOC - 3), a(LOC + 3)).to_event(2), REAL, LOC, ("low", "high")),
    "ZeroInflatedPoisson": (lambda d, a: d.ZeroInflatedPoisson(a(POS), gate=a(PROBS / 2)).to_event(2), COUNTS,
                            COUNTS, ("rate", "gate")),
    "MultivariateNormal": (lambda d, a: d.MultivariateNormal(a(LOC), scale_tril=a(TRIL)).to_event(1), REAL, REAL,
                           ("loc", "scale_tril")),
    "Masked": (lambda d, a: d.Normal(a(LOC), a(SCALE)).mask(a(MASK)).to_event(2), REAL, REAL, ()),
    "Folded": (lambda d, a: d.FoldedDistribution(d.Normal(a(LOC), a(SCALE))).to_event(2), POS, POS, ()),
    "Transformed": (lambda d, a: d.TransformedDistribution(d.Normal(a(LOC), a(SCALE)).to_event(2),
                                                           [d.transforms.ExpTransform()]), POS, POS, ()),
    "GaussianHMM": (lambda d, a: _ghmm(d, a, False), REAL, REAL, ()),
    "GaussianHMM-heterogeneous": (lambda d, a: _ghmm(d, a, True), REAL, REAL, ()),
    "IndependentHMM": (lambda d, a: _independent_hmm(d, a), REAL, REAL, ()),
}


def _base(d):
    while isinstance(d, (tdist.Independent, jdist.Independent)):
        d = d.base_dist
    return d


INIT_FIELDS = ("log_normalizer", "info_vec", "precision")


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
def test_prefix_condition_matches_jax(name):
    build, observed, future, params = PREFIX_CASES[name]
    meta, state = {}, RNG_FIXED.bit_generator.state

    @jax.jit
    def jax_case(observed, future):
        jcond = jprefix_condition(build(jdist, jnp.asarray), observed, T_OBS, T)
        meta.update(type=type(jcond).__name__, shape=(tuple(jcond.batch_shape), tuple(jcond.event_shape)))
        out = {"log_prob": jcond.log_prob(future), **{p: getattr(_base(jcond), p) for p in params}}
        if name.startswith("GaussianHMM"):
            out.update({f: getattr(jcond._init, f) for f in INIT_FIELDS})
        return out

    expected = jax_case(jnp.asarray(observed), jnp.asarray(future[T_OBS:]))
    RNG_FIXED.bit_generator.state = state  # the same draws for the port's model
    tcond = prefix_condition(build(tdist, torch.tensor), torch.tensor(observed), T_OBS, T)
    assert type(tcond).__name__ == meta["type"]
    assert (tcond.batch_shape, tcond.event_shape) == meta["shape"]
    assert tcond.event_shape == (T - T_OBS, D)
    for param in params:
        _near(getattr(_base(tcond), param), expected[param])
    if name.startswith("GaussianHMM"):
        for field in INIT_FIELDS:
            _near(getattr(tcond._init, field), expected[field], atol=1e-6)
    _near(tcond.log_prob(torch.tensor(future[T_OBS:])), expected["log_prob"])


def test_prefix_condition_refuses_an_unregistered_type():
    d = tdist.Weibull(torch.tensor(POS), torch.tensor(POS)).to_event(2)
    with pytest.raises(NotImplementedError, match="Weibull"):
        prefix_condition(d, torch.tensor(POS), T_OBS, T)


# -- (d) the forecasting models at a fixed latent --------------------------------------

T_TRAIN = 120


class HMMTrendModel(ForecastingModel):
    """``tests/test_forecast.py``'s HMMTrendModel in the port."""

    def model(self, zero_data, covariates):
        bias = pyro.sample("bias", tdist.Normal(0.0, 10.0))
        prediction = bias * torch.ones(zero_data.shape)
        init = tdist.Normal(torch.zeros(1), 1.0).to_event(1)
        trans_scale = pyro.sample("trans_scale", tdist.LogNormal(-2.0, 1.0))
        obs_scale = pyro.sample("obs_scale", tdist.LogNormal(-2.0, 1.0))
        noise_dist = tdist.GaussianHMM(
            init, torch.ones((1, 1, 1)), tdist.Normal(torch.zeros((1, 1)), trans_scale).to_event(1),
            torch.ones((1, 1, 1)), tdist.Normal(torch.zeros((1, 1)), obs_scale).to_event(1), duration=zero_data.shape[-2])
        self.predict(noise_dist, prediction)


def _fake_data():
    data, _ = example.fake_data()
    jdata = jnp.log1p(jexample.load_fake_od()["counts"].reshape(744, -1)[:, :1])
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=1e-7)
    return data[:T_TRAIN].numpy()


MODELS = {
    "bart": (jexample.Model, example.Model, _fake_data,
             lambda: {"weekly": (0.2 * RNG.normal(size=(168, 1)) + 2.3).astype(F32), "trans_scale": F32(0.3),
                      "obs_scale": F32(0.2)}),
    "hmm_trend": (jtests.HMMTrendModel, HMMTrendModel,
                  lambda: (1.0 + np.cumsum(0.1 * RNG.normal(size=32)))[:, None].astype(F32),
                  lambda: {"bias": F32(0.9), "trans_scale": F32(0.12), "obs_scale": F32(0.05)}),
}


@contextlib.contextmanager
def _default_dtype(dtype):
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def _loss_at(poutine_mod, model, guide, cond, *args):
    """-ELBO at one latent value: log q(z) - log p(data, z), the guide's
    sites conditioned at ``cond`` and the model at the guide's values."""
    guide_trace = poutine_mod.trace(poutine_mod.condition(guide, data=cond)).get_trace(*args)
    values = {name: site["value"] for name, site in guide_trace.nodes.items() if site["type"] == "sample"}
    model_trace = poutine_mod.trace(poutine_mod.condition(model, data=values)).get_trace(*args)
    return guide_trace.log_prob_sum() - model_trace.log_prob_sum()


def _log_joint(poutine_mod, model, values, *args):
    return poutine_mod.trace(poutine_mod.condition(model, data=values)).get_trace(*args).log_prob_sum()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forecasting_model_elbo_and_gradients_match_jax(name):
    jmodel_cls, tmodel_cls, make_data, make_latent = MODELS[name]
    data, latent = make_data(), make_latent()
    cov = np.zeros((data.shape[0], 0), F32)

    jmodel = jmodel_cls()
    jmodel_fn = lambda d, c: jmodel(d, c)  # noqa: E731
    jguide = jag.AutoNormal(jmodel_fn, init_scale=0.1)
    jargs = (jnp.asarray(data), jnp.asarray(cov))
    JTrace_ELBO().loss(jmodel_fn, jguide, *jargs, rng_key=jax.random.key(0))
    jstore = jpyro.get_param_store()
    jcond = {k: jnp.asarray(v) for k, v in latent.items()}

    def jloss(p):
        with ParamsMessenger(p):
            return _loss_at(jpoutine, jmodel_fn, jguide, jcond, *jargs)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jstore.get_all_unconstrained())
    jlp = jax.jit(lambda z: _log_joint(jpoutine, jmodel_fn, z, *jargs))(jcond)

    tmodel = tmodel_cls()
    tmodel_fn = lambda d, c: tmodel(d, c)  # noqa: E731
    tguide = tag.AutoNormal(tmodel_fn, init_scale=0.1)
    targs = (torch.tensor(data), torch.tensor(cov))
    Trace_ELBO().loss(tmodel_fn, tguide, *targs)  # registers the params
    param_store_from_jax({k: np.asarray(v) for k, v in jstore.items()})
    with poutine.trace(param_only=True) as capture:
        tl = _loss_at(poutine, tmodel_fn, tguide, {k: torch.tensor(v) for k, v in latent.items()}, *targs)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    store = pyro.get_param_store()
    assert sorted(capture.trace.param_nodes()) == sorted(jgrads)
    for k, g in jgrads.items():
        _near(store.get_unconstrained(k).grad, g)

    # the log joint's gradient in the latents, against the JAX package's in
    # float64 within 1e-7 of the largest (the JAX models' Python-float
    # parameters stay float32 under x64); in float32 within 1e-3 of the
    # largest (as a training step's on the card: these are sums over time
    # of terms that cancel, the trend's bias to 4e-4 of itself in float32
    # in either package)
    with jax.enable_x64(True):
        jlp64, jz64 = jax.jit(jax.value_and_grad(lambda z: _log_joint(jpoutine, jmodel_fn, z, *(
            jnp.asarray(a, jnp.float64) for a in (data, cov)))))({k: jnp.asarray(v, jnp.float64)
                                                                 for k, v in latent.items()})
        jz64 = {k: np.asarray(v) for k, v in jz64.items()}
    scale = max(float(np.abs(v).max()) for v in jz64.values())
    for dtype in (torch.float64, torch.float32):
        z = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in latent.items()}
        with _default_dtype(dtype):
            tlp = _log_joint(poutine, tmodel_cls(), z, *(torch.tensor(a, dtype=dtype) for a in (data, cov)))
        tlp.backward()
        if dtype == torch.float32:
            assert float(tlp.detach()) == pytest.approx(float(jlp), rel=1e-5)
        else:
            assert float(tlp.detach()) == pytest.approx(float(jlp64), rel=1e-7)
        for k, g64 in jz64.items():
            err = np.abs(z[k].grad.double().numpy() - g64).max()
            if dtype == torch.float32:
                assert err <= 1e-3 * scale, (k, err)
            else:
                assert err <= 1e-7 * scale, (k, err)


# -- (e) time reparametrisations -----------------------------------------------------------

SEASON = 12


class SeasonalModel(ForecastingModel):
    """A seasonal profile (one latent per step of the period, along the last
    dim) and a GaussianHMM local level."""

    def model(self, zero_data, covariates):
        duration, dim = zero_data.shape[-2:]
        season = pyro.sample("season", tdist.Normal(0.0, 1.0).expand((dim, SEASON)).to_event(2))
        prediction = tu.periodic_repeat(season.transpose(-1, -2), duration, dim=-2)
        scale = pyro.sample("scale", tdist.LogNormal(-1.0, 0.5))
        noise = tdist.GaussianHMM(
            tdist.Normal(torch.zeros(1), 1.0).to_event(1), torch.ones((1, 1, 1)),
            tdist.Normal(torch.zeros((1, 1)), 0.1).to_event(1), torch.ones((1, 1, dim)),
            tdist.Normal(torch.zeros((1, dim)), scale).to_event(1), duration=duration)
        self.predict(noise, prediction)


class JSeasonalModel(JForecastingModel):
    def model(self, zero_data, covariates):
        duration, dim = zero_data.shape[-2:]
        season = jpyro.sample("season", jdist.Normal(0.0, 1.0).expand((dim, SEASON)).to_event(2))
        prediction = jtu.periodic_repeat(jnp.swapaxes(season, -1, -2), duration, dim=-2)
        scale = jpyro.sample("scale", jdist.LogNormal(-1.0, 0.5))
        noise = jdist.GaussianHMM(
            jdist.Normal(jnp.zeros(1), 1.0).to_event(1), jnp.ones((1, 1, 1)),
            jdist.Normal(jnp.zeros((1, 1)), 0.1).to_event(1), jnp.ones((1, 1, dim)),
            jdist.Normal(jnp.zeros((1, dim)), scale).to_event(1), duration=duration)
        self.predict(noise, prediction)


SEASONAL_T = 40
SEASONAL_DATA = (np.sin(2 * np.pi * np.arange(SEASONAL_T) / SEASON)[:, None]
                 + 0.1 * RNG.normal(size=(SEASONAL_T, 1))).astype(F32)
REPARAMS = {
    "haar": (lambda m: m.HaarReparam(), "season_haar", lambda x: tu.inverse_haar_transform(x), 0.0),
    "dct": (lambda m: m.DiscreteCosineReparam(), "season_dct", lambda x: tu.idct(x), 0.0),
    "dct_smooth": (lambda m: m.DiscreteCosineReparam(smooth=1.0), "season_dct",
                   lambda x: tu.idct(x / (1.0 + torch.arange(SEASON)) ** -1.0),
                   -sum(math.log(1.0 + k) for k in range(SEASON))),
}


@pytest.mark.parametrize("name", sorted(REPARAMS))
def test_reparametrised_log_joint_matches_jax_and_the_direct_form(name):
    make, site, inverse, ladj = REPARAMS[name]
    values = {site: RNG.normal(size=(1, SEASON)).astype(F32), "scale": F32(0.4)}
    cov = np.zeros((SEASONAL_T, 0), F32)
    jmodel = jpoutine.reparam(JSeasonalModel(), config={"season": make(jreparam)})
    log_joint = lambda v, *args: _log_joint(jpoutine, jmodel, v, *args)  # noqa: E731
    # the JAX smoothed DCT's log|det J| reads a shape product with int(),
    # which jax.jit cannot trace
    log_joint = log_joint if name == "dct_smooth" else jax.jit(log_joint)
    expected = log_joint({k: jnp.asarray(v) for k, v in values.items()}, jnp.asarray(SEASONAL_DATA),
                         jnp.asarray(cov))
    tmodel = poutine.reparam(SeasonalModel(), config={"season": make(treparam)})
    targs = (torch.tensor(SEASONAL_DATA), torch.tensor(cov))
    actual = _log_joint(poutine, tmodel, {k: torch.tensor(v) for k, v in values.items()}, *targs)
    assert float(actual) == pytest.approx(float(expected), rel=1e-5)
    # the direct form: the model without the reparam at the inverse-transformed
    # values, less the transform's log|det J| (0 for an orthonormal one)
    season = inverse(torch.tensor(values[site]))
    direct = _log_joint(poutine, SeasonalModel(), {"season": season, "scale": torch.tensor(values["scale"])}, *targs)
    assert float(actual) == pytest.approx(float(direct) - ladj, rel=1e-5)


@pytest.mark.xfail(strict=True, raises=RecursionError,
                   reason="pyro_tpu/infer/reparam/unit_jacobian.py:32 samples its auxiliary site without marking it "
                          "auxiliary, so HMCForecaster's time reparam (pyro_tpu/contrib/forecast/forecaster.py:286) "
                          "reparametrises that site again without end (test_hmc_forecaster_time_reparam)")
def test_jax_hmc_forecaster_time_reparam():
    JHMCForecaster(JSeasonalModel(), jnp.asarray(SEASONAL_DATA), jnp.zeros((SEASONAL_T, 0)), num_warmup=1,
                   num_samples=1, time_reparam="dct", rng_key=jax.random.key(0))


@pytest.mark.parametrize("time_reparam", [None, "haar", "dct"])
def test_hmc_forecaster_time_reparam(time_reparam):
    """NUTS over the reparametrised model: the auxiliary site is the latent
    (the scalar site has no dim to transform and stays as it is), and a
    forecast conditions the reparametrised model on a draw, so the season
    it uses is the draw's inverse transform."""
    data, cov = torch.tensor(SEASONAL_DATA[:32]), torch.zeros((SEASONAL_T, 0))
    fc = HMCForecaster(SeasonalModel(), data, cov[:32], num_warmup=4, num_samples=3, num_chains=2,
                       time_reparam=time_reparam, max_tree_depth=3, generator=torch.Generator().manual_seed(0))
    site = {None: "season", "haar": "season_haar", "dct": "season_dct"}[time_reparam]
    assert sorted(fc._samples) == sorted([site, "scale"])
    assert fc._samples[site].shape == (6, 1, SEASON) and bool(torch.isfinite(fc._samples[site]).all())
    draw = {k: v[0] for k, v in fc._samples.items()}
    trace = poutine.trace(poutine.condition(fc._model_fn, data=draw)).get_trace(data, cov)
    inverse = {None: lambda x: x, "haar": tu.inverse_haar_transform, "dct": tu.idct}[time_reparam]
    torch.testing.assert_close(trace.nodes["season"]["value"], inverse(draw[site]))
    samples = fc(data, cov, num_samples=4, generator=torch.Generator().manual_seed(1))
    assert samples.shape == (4, SEASONAL_T - 32, 1) and bool(torch.isfinite(samples).all())


# -- (f) metrics, and the engines end to end -------------------------------------------------


def test_metrics_match_jax():
    pred, truth = RNG.normal(size=(50, 6, 2)).astype(F32), RNG.normal(size=(6, 2)).astype(F32)
    for name in ("eval_mae", "eval_rmse", "eval_crps"):
        actual = getattr(evaluate, name)(torch.tensor(pred), torch.tensor(truth))
        expected = getattr(jevaluate, name)(jnp.asarray(pred), jnp.asarray(truth))
        assert actual == pytest.approx(expected, rel=1e-5), name


class TrendModel(ForecastingModel):
    def model(self, zero_data, covariates):
        slope = pyro.sample("slope", tdist.Normal(0.0, 1.0))
        bias = pyro.sample("bias", tdist.Normal(0.0, 10.0))
        noise_scale = pyro.sample("noise_scale", tdist.LogNormal(-2.0, 1.0))
        self.predict(tdist.Normal(torch.zeros(zero_data.shape), noise_scale).to_event(2),
                     bias + slope * covariates[..., :1])


def test_forecaster_and_backtest_run():
    """``tests/test_forecast.py``'s HMM-noise case: the forecast starts
    within 0.5 of the last observed value (the filtered level); then a
    backtest of the trend model gives finite metrics."""
    T_all, T_obs = 32, 24
    data = (1.0 + torch.cumsum(0.1 * torch.tensor(RNG.normal(size=T_all), dtype=torch.float32), 0))[:, None]
    forecaster = Forecaster(HMMTrendModel(), data[:T_obs], torch.zeros((T_obs, 0)), num_steps=400,
                            learning_rate=0.05)
    assert forecaster.losses[-1] < forecaster.losses[0]
    samples = forecaster(data[:T_obs], torch.zeros((T_all, 0)), num_samples=60)
    assert samples.shape == (60, T_all - T_obs, 1)
    assert abs(float(samples.mean(0)[0, 0]) - float(data[T_obs - 1, 0])) < 0.5
    t = torch.arange(36.0)
    trend = (2.0 + 0.1 * t + 0.2 * torch.tensor(RNG.normal(size=36), dtype=torch.float32))[:, None]
    results = backtest(trend, t[:, None], TrendModel, test_window=6, num_samples=10,
                       forecaster_options={"num_steps": 50, "learning_rate": 0.05})
    assert len(results) == 1 and all(math.isfinite(results[0][k]) for k in ("mae", "rmse", "crps"))


def _local_level_conditional(y, t_obs, trans_scale, obs_scale, init_scale=10.0):
    """The exact mean and variance of y[t_obs:] given y[:t_obs] for the local
    level y_t = z_t + v_t, z_t = z_{t-1} + w_t, z_0 ~ N(0, init_scale^2)
    (t = 1 .. T), densely in float64."""
    T_all = y.shape[0]
    steps = np.arange(1, T_all + 1)
    cov = init_scale**2 + np.minimum.outer(steps, steps) * trans_scale**2 + np.eye(T_all) * obs_scale**2
    o, f = slice(0, t_obs), slice(t_obs, T_all)
    gain = cov[f, o] @ np.linalg.inv(cov[o, o])
    return gain @ y[o], np.diag(cov[f, f] - gain @ cov[o, f])


def test_example_forecast_matches_the_exact_conditional():
    data, t_train = example.fake_data()
    T_all = data.shape[0]
    covariates = data.new_zeros((T_all, 0))
    forecaster = Forecaster(example.Model(), data[:t_train], covariates[:t_train], num_steps=30, learning_rate=0.05,
                            generator=torch.Generator().manual_seed(0))
    assert all(math.isfinite(l) for l in forecaster.losses)
    median = {k: v.detach() for k, v in forecaster.guide.median(data[:t_train], covariates[:t_train]).items()}

    # the residual's prefix-conditioned law at the median latents
    trace = poutine.trace(poutine.condition(forecaster.model, data=median)).get_trace(data[:t_train], covariates)
    cond = trace.nodes["residual"]["fn"]
    prediction = tu.periodic_repeat(median["weekly"], T_all, dim=-2)
    residual = (data - prediction)[:, 0].double().numpy()
    mean, var = _local_level_conditional(residual, t_train, float(median["trans_scale"]), float(median["obs_scale"]))
    draws = cond.rsample(torch.Generator().manual_seed(2), (4000,))[..., 0].double()
    se = np.sqrt(var / 4000)
    assert np.all(np.abs(draws.mean(0).numpy() - mean) <= 5 * se)
    np.testing.assert_allclose(draws.var(0).numpy(), var, rtol=0.1)

    # the forecaster's own draws, with its guide at the median
    def guide_at_median(*args):
        for name, value in median.items():
            pyro.sample(name, tdist.Delta(value, event_dim=value.ndim))

    forecaster.guide = guide_at_median
    samples = forecaster(data[:t_train], covariates, num_samples=20, generator=torch.Generator().manual_seed(3))
    assert samples.shape == (20, T_all - t_train, 1)
    forecast_mean = mean + prediction[t_train:, 0].double().numpy()
    assert np.all(np.abs(samples[..., 0].double().mean(0).numpy() - forecast_mean) <= 5 * np.sqrt(var / 20))


def test_load_bart_od_raises_and_fake_od_matches_jax():
    from pyro_tpu_torch.contrib.examples import bart

    with pytest.raises(RuntimeError, match="network"):
        bart.load_bart_od()
    np.testing.assert_array_equal(bart.load_fake_od()["counts"].numpy(),
                                  np.asarray(jexample.load_fake_od()["counts"]))
