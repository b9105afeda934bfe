"""The port's epidemiology (``pyro_tpu_torch/contrib/epidemiology``) and
the pieces it brings (``ExtendedBinomial``, ``ExtendedBetaBinomial``,
``ImproperUniform``, ``poutine.uncondition``, ``Predictive``) against the
JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages.  Random streams
cannot match, so the comparisons are of deterministic values: log
densities, log joints and their gradients at shared points, the quantized
potential and its gradient, and ``Predictive``'s deterministic sites given
the same posterior samples.

Tolerances: helper and distribution log densities rtol 1e-5 (float32, the
same formulas); relaxed log joints rtol 1e-5 and their gradients within
1e-4 * max|grad|; the quantized potential within 1e-5 * |value| + 1e-5 and
its gradient within 1e-4 * max|grad| (its chain reduction is the exact
log-sum-exp here and the clipped factored form in the JAX package, both
float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as tpyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu.contrib import epidemiology as je
from pyro_tpu.contrib.epidemiology import util as jutil
from pyro_tpu.infer import Predictive as JPredictive
from pyro_tpu_torch import poutine as tpoutine
from pyro_tpu_torch.contrib import epidemiology as te
from pyro_tpu_torch.contrib.epidemiology import compartmental as tcompartmental
from pyro_tpu_torch.contrib.epidemiology import util as tutil
from pyro_tpu_torch.infer import Predictive as TPredictive
from pyro_tpu_torch.ops import log_matmul as lm
from pyro_tpu_torch.poutine.util import site_is_subsample


@pytest.fixture(autouse=True)
def _port_on_cpu():
    tpyro.set_default_device("cpu")
    yield


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


# -- quantization ---------------------------------------------------------------------


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_compute_bin_probs(Q):
    s = np.linspace(0.0, 1.0, 11)
    np.testing.assert_allclose(tutil.compute_bin_probs(_t(s), Q).numpy(),
                               np.asarray(jutil.compute_bin_probs(_j(s), Q)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("Q", [2, 4, 8])
@pytest.mark.parametrize("bound", ["number", "tensor"])
def test_quantize_enumerate(Q, bound):
    """Values, logits and the logits' gradient (the only path from x)."""
    x = np.array([[3.3, 0.1, 7.9], [9.6, 0.5, 5.0]], np.float32)
    hi = 10.0 if bound == "number" else np.array([10.0, 8.0, 9.0], np.float32)
    w = np.random.default_rng(Q).standard_normal(x.shape + (Q,)).astype(np.float32)
    xt = _t(x).requires_grad_()
    vals, logits = tutil.quantize_enumerate(xt, 0.0, hi if bound == "number" else _t(hi), Q)
    (logits * _t(w)).sum().backward()

    def f(xj):
        v, lg = jutil.quantize_enumerate(xj, 0.0, hi if bound == "number" else _j(hi), Q)
        return (lg * _j(w)).sum(), (v, lg)

    (_, (vj, lj)), gj = jax.value_and_grad(f, has_aux=True)(_j(x))
    np.testing.assert_array_equal(vals.detach().numpy(), np.asarray(vj))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Q", [1, 4])
def test_quantize_given_its_bin(Q):
    x = np.array([3.3, 0.2, 9.9], np.float32)
    q = np.array([0, 3, 2])
    tmodel = tpoutine.condition(lambda: tutil.quantize("x", _t(x), 0.0, 10.0, Q), data={"Q_x": torch.tensor(q)})
    jmodel = jpoutine.condition(lambda: jutil.quantize("x", _j(x), 0.0, 10.0, Q), data={"Q_x": jnp.asarray(q)})
    np.testing.assert_array_equal(tmodel().numpy(), np.asarray(jmodel()))


# -- the distribution helpers -------------------------------------------------------------

S_VALUES = np.array([-2.0, 0.0, 3.0, 7.0, 12.0, 40.0], np.float32)

HELPERS = {
    "binomial": lambda m, a: m.binomial_dist(a(30.0), a(0.2)),
    "binomial_od": lambda m, a: m.binomial_dist(a(30.0), a(0.2), overdispersion=a(0.3)),
    "beta_binomial": lambda m, a: m.beta_binomial_dist(a(2.0), a(5.0), a(30.0)),
    "poisson": lambda m, a: m.poisson_dist(a(6.0)),
    "poisson_od": lambda m, a: m.poisson_dist(a(6.0), overdispersion=0.4),
    "negative_binomial": lambda m, a: m.negative_binomial_dist(a(3.0), a(0.4)),
    "negative_binomial_logits": lambda m, a: m.negative_binomial_dist(a(3.0), logits=a(0.3)),
    "infection": lambda m, a: m.infection_dist(individual_rate=a(0.6), num_infectious=a(10.0),
                                               num_susceptible=a(30.0), population=1000.0),
    "infection_od": lambda m, a: m.infection_dist(individual_rate=0.6, num_infectious=a(10.0),
                                                  num_susceptible=a(30.0), population=1000, overdispersion=0.5),
    "superspreading": lambda m, a: m.infection_dist(individual_rate=a(2.0), num_infectious=a(10.0),
                                                    num_susceptible=a(30.0), population=a(100.0),
                                                    concentration=a(0.5)),
}
# the exact family of each helper, which support its values must lie in
EXACT = {"binomial": "ExtendedBinomial", "binomial_od": "ExtendedBetaBinomial", "beta_binomial": "BetaBinomial",
         "poisson": "Poisson", "poisson_od": "GammaPoisson", "negative_binomial": "NegativeBinomial",
         "negative_binomial_logits": "NegativeBinomial", "infection": "ExtendedBinomial",
         "infection_od": "ExtendedBetaBinomial", "superspreading": "BetaBinomial"}


@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_log_prob(name, relaxed):
    """The family and the log density at counts inside and (for the
    extended Binomials, -inf) outside the support."""
    with te.set_relaxed_distributions(relaxed), je.set_relaxed_distributions(relaxed):
        td = HELPERS[name](te, _t)
        jd = HELPERS[name](je, _j)
    assert type(td).__name__ == type(jd).__name__ == ("Normal" if relaxed else EXACT[name])
    values = S_VALUES if relaxed or EXACT[name].startswith("Extended") else S_VALUES[1:]
    lp = td.log_prob(_t(values)).numpy()
    np.testing.assert_allclose(lp, np.asarray(jd.log_prob(_j(values))), rtol=1e-5, atol=1e-5)
    if EXACT[name].startswith("Extended") and not relaxed:
        assert np.isneginf(lp[0]) and np.isneginf(lp[-1]) and np.isfinite(lp[1:-1]).all()


def test_helper_overdispersion_is_validated():
    with pytest.raises(ValueError):
        te.binomial_dist(_t(10.0), 0.5, overdispersion=2.5)


@pytest.mark.parametrize("family", ["ExtendedBinomial", "ExtendedBetaBinomial"])
def test_extended_gradients_outside_the_support(family):
    """-inf outside, and the parameters' gradients finite (the formula is
    evaluated at a safe value there) and equal to JAX's."""
    values = np.array([-3.0, 0.0, 2.0, 5.0, 9.0, 1.5], np.float32)
    total = np.array([5.0, 5.0, 4.0, 5.0, 6.0, 5.0], np.float32)
    params = np.array([0.3, 2.0], np.float32)

    def make(d, a, p):
        if family == "ExtendedBinomial":
            return getattr(d, family)(a(total), probs=p[0])
        return getattr(d, family)(p[0] * 4.0, p[1], a(total))

    pt = _t(params).requires_grad_()
    lp = make(tdist, _t, pt).log_prob(_t(values))
    finite = torch.isfinite(lp)
    assert finite.tolist() == [False, True, True, True, False, False]
    lp[finite].sum().backward()
    jlp = make(jdist, _j, _j(params)).log_prob(_j(values))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    gj = jax.grad(lambda p: jnp.sum(jnp.where(jnp.isfinite(jlp), make(jdist, _j, p).log_prob(_j(values)), 0.0)))(
        _j(params))
    assert torch.isfinite(pt.grad).all()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)


def test_improper_uniform():
    t = tdist.ImproperUniform(tdist.constraints.positive, (3,), (2,))
    j = jdist.ImproperUniform(jdist.constraints.positive, (3,), (2,))
    value = np.ones((4, 3, 2), np.float32)
    np.testing.assert_array_equal(t.log_prob(_t(value)).numpy(), np.asarray(j.log_prob(_j(value))))
    e = t.expand((5, 3)).to_event(1)
    assert e.batch_shape == (5,) and e.event_shape == (3, 2) and e.support.check(_t(np.ones((3, 2)))).all()
    assert e.log_prob(_t(np.ones((5, 3, 2)))).shape == (5,)
    with pytest.raises(NotImplementedError):
        t.sample()


# -- uncondition --------------------------------------------------------------------------


def _obs_model(pyro, dist, a):
    def model():
        z = pyro.sample("z", dist.Normal(0.0, 1.0))
        return pyro.sample("x", dist.Normal(z, 1.0), obs=a(5.0))
    return model


def test_uncondition():
    tr_t = tpoutine.trace(tpoutine.seed(tpoutine.uncondition(_obs_model(tpyro, tdist, _t)), rng_seed=0)).get_trace()
    tr_j = jpoutine.trace(jpoutine.seed(jpoutine.uncondition(_obs_model(jpyro, jdist, _j)),
                                        rng_key=jax.random.key(0))).get_trace()
    for tr in (tr_t, tr_j):
        site = tr.nodes["x"]
        assert not site["is_observed"] and site["infer"]["was_observed"]
        assert float(site["infer"]["obs"]) == 5.0 and float(site["value"]) != 5.0
    # conditioning outside takes the value back
    model = tpoutine.condition(tpoutine.uncondition(_obs_model(tpyro, tdist, _t)), data={"x": _t(2.0)})
    site = tpoutine.trace(tpoutine.seed(model, rng_seed=0)).get_trace().nodes["x"]
    assert site["is_observed"] and float(site["value"]) == 2.0


# -- the models: shared points --------------------------------------------------------------

T_SMALL = 8
DATA = np.array([1, 2, 3, 5, 4, 6, 8, 5], np.float32)
REGIONAL_DATA = np.array([[1, 0], [2, 1], [3, 1], [4, 2], [3, 3], [5, 2], [6, 4], [4, 3]], np.float32)
COUPLING = np.array([[0.9, 0.1], [0.1, 0.9]], np.float32)


def _models(name):
    """(port model, JAX model) over the same data."""
    if name == "SIR":
        return te.SimpleSIRModel(200, 4.0, _t(DATA)), je.SimpleSIRModel(200, 4.0, _j(DATA))
    if name == "SEIR":
        return te.SimpleSEIRModel(200, 3.0, 4.0, _t(DATA)), je.SimpleSEIRModel(200, 3.0, 4.0, _j(DATA))
    if name == "SEIRD":
        return (te.SimpleSEIRDModel(200, 3.0, 4.0, 0.1, _t(DATA)),
                je.SimpleSEIRDModel(200, 3.0, 4.0, 0.1, _j(DATA)))
    if name == "Regional":
        pop = np.array([300.0, 200.0], np.float32)
        return (te.RegionalSIRModel(_t(pop), _t(COUPLING), 4.0, _t(REGIONAL_DATA)),
                je.RegionalSIRModel(_j(pop), _j(COUPLING), 4.0, _j(REGIONAL_DATA)))
    if name == "Heterogeneous":
        return te.HeterogeneousSIRModel(200, 4.0, _t(DATA)), je.HeterogeneousSIRModel(200, 4.0, _j(DATA))
    raise ValueError(name)


def _latent_point(model, seed):
    """A value for every latent site of the port model's relaxed trace:
    flows and other real sites in [0.5, 4], rates in [0.2, 0.8], positive
    sites in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    tr = tpoutine.trace(tpoutine.seed(model._model, rng_seed=0)).get_trace()
    point = {}
    for name, site in tr.nodes.items():
        if site["type"] != "sample" or site["is_observed"] or site_is_subsample(site):
            continue
        shape = tuple(site["value"].shape)
        support = site["fn"].support
        if support is tdist.constraints.unit_interval:
            lo, hi = 0.2, 0.8
        elif support is tdist.constraints.positive:
            lo, hi = 0.5, 2.0
        else:
            lo, hi = 0.5, 4.0
        point[name] = rng.uniform(lo, hi, shape).astype(np.float32)
    return point


def _port_log_joint(model_fn, point):
    values = {k: _t(v).requires_grad_() for k, v in point.items()}
    tr = tpoutine.trace(tpoutine.condition(model_fn, data=values)).get_trace()
    tr.compute_log_prob()
    lj = sum(s["log_prob_sum"] for s in tr.nodes.values()
             if s["type"] == "sample" and not s["infer"].get("_deterministic"))
    lj.backward()
    return float(lj.detach()), {k: v.grad.numpy() for k, v in values.items()}


def _jax_log_joint(model_fn, point):
    def f(values):
        tr = jpoutine.trace(jpoutine.condition(model_fn, data=values)).get_trace()
        tr.compute_log_prob()
        return sum(s["log_prob_sum"] for s in tr.nodes.values()
                   if s["type"] == "sample" and not s["infer"].get("_deterministic"))

    value, grads = jax.jit(jax.value_and_grad(f))({k: _j(v) for k, v in point.items()})
    return float(value), {k: np.asarray(g) for k, g in grads.items()}


def _grads_close(got, expected):
    assert sorted(got) == sorted(expected)
    scale = max(np.abs(g).max() for g in expected.values())
    for k in expected:
        np.testing.assert_allclose(got[k], expected[k], rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["SIR", "SEIR", "SEIRD", "Regional", "Heterogeneous"])
def test_relaxed_log_joint_matches_jax(name):
    tm, jm = _models(name)
    point = _latent_point(tm, 0)
    lj_t, g_t = _port_log_joint(tm._model, point)
    lj_j, g_j = _jax_log_joint(jm._model, point)
    np.testing.assert_allclose(lj_t, lj_j, rtol=1e-5)
    _grads_close(g_t, g_j)


def _quantized_point(name, seed):
    """R0, the response rate(s) and an auxiliary series near a simulated
    outbreak's compartments, (C, T[, R])."""
    rng = np.random.default_rng(seed)
    infections = np.cumsum(DATA) * 1.6
    if name == "SIR":
        series = [199 - infections, 1 + 0.6 * infections]
        rho = 0.45
    elif name == "SEIR":
        series = [199 - infections, 0.3 * infections + 1, 1 + 0.4 * infections]
        rho = 0.45
    else:
        infections = np.cumsum(REGIONAL_DATA, 0) * 1.6
        series = [np.array([299.0, 199.0]) - infections, 1 + 0.6 * infections]
        rho = np.array([0.45, 0.55], np.float32)
    aux = np.stack(series).astype(np.float32) + rng.uniform(0, 1, np.shape(series)).astype(np.float32)
    return {"R0": np.float32(1.7), "rho": np.asarray(rho, np.float32), "auxiliary": aux}


def _quantize(tm, jm):
    for m in (tm, jm):
        m.num_quant_bins, m.relaxed = 4, False
    jm._non_compartmental  # noqa: B018 -- trace it once outside jax.jit


QUANTIZED = ["SIR", "SEIR", "Regional"]


@pytest.mark.parametrize("name", QUANTIZED)
def test_quantized_potential_matches_jax(name):
    """The quantized model's log joint at S = 16 (SIR, Regional over 2
    regions) and 64 (SEIR) enumerated states: the chain reduction takes the
    chain route."""
    tm, jm = _models(name)
    _quantize(tm, jm)
    point = _quantized_point(name, 1)
    lm.reset_chain_counts()
    lj_t, _ = _port_log_joint(tm._quantized_model, point)
    assert lm.routes == {"chain": 1, "rounds": 0}
    lj_j, _ = _jax_log_joint(jm._quantized_model, point)
    assert np.isfinite(lj_t)
    assert abs(lj_t - lj_j) <= 1e-5 * abs(lj_j) + 1e-5


def _direct_fold64(logits):
    """The chain reduction as a direct fold in float64: each pair by
    ``torch.logsumexp`` over its middle index, a -inf entry standing as
    -1e4 (a path through one weighs exp(-1e4) = 0 in float64)."""
    cur = torch.where(torch.isinf(logits), -1e4, logits.double())
    while cur.shape[0] > 1:
        time, even = cur.shape[0], cur.shape[0] // 2 * 2
        nxt = torch.logsumexp(cur[0:even:2].unsqueeze(-1) + cur[1:even:2].unsqueeze(-3), dim=-2)
        cur = torch.cat([nxt, cur[even:]], 0) if time > even else nxt
    return cur[0]


def _float64_direct(name, point, monkeypatch):
    """The quantized log joint and gradient of the port's model in float64
    with the chain reduction replaced by ``_direct_fold64``."""
    monkeypatch.setattr(tcompartmental, "sequential_logmatmulexp_timemajor", _direct_fold64)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tm, _ = _models(name)
        tm.num_quant_bins, tm.relaxed = 4, False
        values = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True) for k, v in point.items()}
        tr = tpoutine.trace(tpoutine.condition(tm._quantized_model, data=values)).get_trace()
        tr.compute_log_prob()
        lj = sum(s["log_prob_sum"] for s in tr.nodes.values()
                 if s["type"] == "sample" and not s["infer"].get("_deterministic"))
        lj.backward()
        return float(lj.detach()), {k: v.grad.numpy() for k, v in values.items()}
    finally:
        torch.set_default_dtype(old)


@pytest.mark.parametrize("name", QUANTIZED)
def test_quantized_gradient_matches_float64_direct_form(name, monkeypatch):
    """The gradient of the quantized log joint in R0, rho and the auxiliary
    series against float64 autograd of a direct fold of the chain."""
    tm, _ = _models(name)
    tm.num_quant_bins, tm.relaxed = 4, False
    point = _quantized_point(name, 1)
    lj_t, g_t = _port_log_joint(tm._quantized_model, point)
    lj_64, g_64 = _float64_direct(name, point, monkeypatch)
    assert abs(lj_t - lj_64) <= 1e-5 * abs(lj_64) + 1e-5
    _grads_close(g_t, g_64)


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue 3: the JAX log-matmul-exp _bwd shifts over whole rows and "
                   "columns, so the all -inf rows of the quantized factors (previous states with no feasible "
                   "step) flush the other terms")
@pytest.mark.parametrize("name", QUANTIZED)
def test_jax_quantized_gradient_matches_float64_direct_form(name, monkeypatch):
    tm, jm = _models(name)
    _quantize(tm, jm)
    point = _quantized_point(name, 1)
    _, g_j = _jax_log_joint(jm._quantized_model, point)
    _, g_64 = _float64_direct(name, point, monkeypatch)
    _grads_close(g_j, g_64)


def test_quantized_infeasible_point_is_neg_inf_without_nan():
    """An auxiliary series no integer path can follow: the log joint is
    -inf and its gradient finite (NUTS sees a divergence, not a NaN)."""
    tm, _ = _models("SIR")
    tm.num_quant_bins, tm.relaxed = 4, False
    point = _quantized_point("SIR", 1)
    point["auxiliary"][0, 3] = 199.5  # S climbs back up at step 3
    lj, g = _port_log_joint(tm._quantized_model, point)
    assert lj == -np.inf and all(np.isfinite(v).all() for v in g.values())


def test_heterogeneous_quantized_model_finds_the_drift():
    tm, jm = _models("Heterogeneous")
    assert list(tm._non_compartmental) == list(jm._non_compartmental) == ["beta"]
    tm.num_quant_bins, tm.relaxed = 4, False
    point = _quantized_point("SIR", 2)
    point.update(R0=np.float32(1.5), rho0=np.float32(0.3), rho1=np.float32(0.5), rho2=np.float32(0.6),
                 beta=np.full(T_SMALL, 1.1, np.float32))
    del point["rho"]
    lj, g = _port_log_joint(tm._quantized_model, point)
    assert np.isfinite(lj) and sorted(g) == ["R0", "auxiliary", "beta", "rho0", "rho1", "rho2"]


# -- prediction ---------------------------------------------------------------------------


def _posterior(tm, n, seed):
    """n posterior-like draws of every latent site of the relaxed model."""
    draws = [_latent_point(tm, seed + i) for i in range(n)]
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


def test_predictive_given_posterior_samples_matches_jax():
    tm, jm = _models("SIR")
    samples = _posterior(tm, 3, 10)
    sites = [f"{c}_{t}" for c in ("S", "I") for t in range(T_SMALL)]
    out_t = TPredictive(tm._model, posterior_samples={k: _t(v) for k, v in samples.items()}, return_sites=sites)()
    out_j = JPredictive(jm._model, posterior_samples={k: _j(v) for k, v in samples.items()},
                        return_sites=sites)(rng_key=jax.random.key(0))
    assert sorted(out_t) == sorted(sites)
    for k in sites:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-5, atol=1e-4)


def test_predict_given_samples_matches_jax():
    """``predict`` subsamples the draws with numpy seed 0 in both packages;
    the compartments are then functions of the given flows, and the
    forecast steps are finite draws."""
    tm, jm = _models("SIR")
    samples = _posterior(tm, 6, 20)
    tm.samples = {k: _t(v) for k, v in samples.items()}
    jm.samples = {k: _j(v) for k, v in samples.items()}
    out_t = tm.predict(num_samples=4, forecast=3)
    out_j = jm.predict(num_samples=4, forecast=3, rng_key=jax.random.key(0))
    assert sorted(out_t) == sorted(out_j)
    for t in range(T_SMALL):
        for c in ("S", "I"):
            np.testing.assert_allclose(out_t[f"{c}_{t}"].numpy(), np.asarray(out_j[f"{c}_{t}"]), rtol=1e-5,
                                       atol=1e-4)
    assert out_t["S2I_10"].shape == (4,) and torch.isfinite(out_t["I_10"]).all()


def test_fit_svi_then_predict_forecast():
    tm, _ = _models("SIR")
    tpyro.clear_param_store()
    losses = tm.fit_svi(num_steps=20, learning_rate=0.05)
    assert len(losses) == 20 and np.isfinite(losses).all()
    s = tm.predict(num_samples=5, forecast=2)
    assert s["obs_9"].shape == (5,) and torch.isfinite(s["I_9"]).all() and not s["R0"].requires_grad
    tpyro.clear_param_store()


def test_generate():
    tm, _ = _models("SEIR")
    sample = tm.generate({"R0": 2.0, "rho": 0.5}, generator=3)
    assert float(sample["R0"]) == 2.0 and float(sample["rho"]) == 0.5
    obs = torch.stack([sample[f"obs_{t}"] for t in range(T_SMALL)])
    assert torch.equal(obs, obs.round()) and (obs >= 0).all()
    S = torch.stack([sample[f"S_{t}"] for t in range(T_SMALL)])
    assert (S[1:] <= S[:-1]).all() and (S >= 0).all()


def test_superspreading_seir_phylogeny_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 7"):
        te.SuperspreadingSEIRModel(100, 3.0, 4.0, _t(DATA), leaf_times=_t([1.0]), coal_times=_t([2.0]))


def test_fit_mcmc_quantized_smoke():
    data = _t(DATA[:6])
    m = te.SimpleSIRModel(200, 4.0, data)
    tpyro.clear_param_store()
    m.fit_mcmc(num_quant_bins=4, num_samples=10, warmup_steps=10, num_chains=2, max_tree_depth=3,
               heuristic_num_steps=20)
    assert m.samples["auxiliary"].shape == (20, 2, 6) and m.samples["R0"].shape == (20,)
    assert all(torch.isfinite(v).all() for v in m.samples.values())
    tpyro.clear_param_store()


EXAMPLES = {
    "sir_hmc": ["-n", "3", "-w", "3", "--duration", "5", "--max-tree-depth", "2", "--num-quant-bins", "4"],
    "epidemiology_sir": ["--num-steps", "5", "--duration", "6", "--forecast", "2"],
    "epidemiology_regional": ["--num-steps", "5", "--duration", "5", "--forecast", "2"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    """The examples' CLIs end to end at tiny sizes, ``--cpu``."""
    import importlib

    example = importlib.import_module(f"pyro_tpu_torch.examples.{name}")
    tpyro.clear_param_store()
    result = example.main(example.parse_args(EXAMPLES[name] + ["--cpu"]))
    r0 = result.samples["R0"] if name == "sir_hmc" else torch.tensor(result)
    assert torch.isfinite(r0).all()
    tpyro.clear_param_store()


@pytest.mark.parametrize("family", ["Binomial", "NegativeBinomial", "ExtendedBinomial"])
def test_count_keeps_its_device_with_a_number_probability(family):
    """A number ``probs`` goes to the count tensor's device; it used to land
    on the CPU and pull the count there (a copy from the card, which a
    captured NUTS leaf refuses)."""
    count = torch.tensor([3.0, 5.0], device="meta")
    d = getattr(tdist, family)(count, probs=0.25)
    assert d.total_count.device.type == "meta" and d.probs.device.type == "meta"


def test_particle_init_repairs_an_infeasible_start():
    """A relaxed series whose quantized log joint is -inf (a flow below its
    observed count) is replaced by a particle filter's integer series,
    which is feasible; the shapes of the start are kept."""
    tm, _ = _models("SIR")
    tm.num_quant_bins, tm.relaxed = 4, False
    point = _quantized_point("SIR", 3)
    point["auxiliary"][0] = np.linspace(199.0, 195.0, T_SMALL)  # S barely falls: every flow below its count
    start = {k: _t(v) for k, v in point.items()}
    assert tm._quantized_log_density(start) == -np.inf
    repaired = tm._particle_init(start)
    assert np.isfinite(tm._quantized_log_density(repaired))
    assert {k: v.shape for k, v in repaired.items()} == {k: v.shape for k, v in start.items()}
    assert float(repaired["R0"]) == float(start["R0"]) and torch.equal(repaired["auxiliary"], repaired["auxiliary"].round())


def test_infeasible_start_raises():
    """When no particle survives the exact transitions (more infections
    observed than the population holds), ``fit_mcmc`` raises instead of
    starting NUTS at a point whose log joint is -inf."""
    tpyro.clear_param_store()
    tm = te.SimpleSIRModel(200, 4.0, _t(np.full(T_SMALL, 100.0)))
    with pytest.raises(ValueError, match="infeasible"):
        tm.fit_mcmc(num_quant_bins=4, num_samples=2, warmup_steps=2, heuristic_num_steps=2)
    tpyro.clear_param_store()


@pytest.mark.parametrize("family,args", [("Beta", (10.0, 10.0)), ("Uniform", (-0.5, 1.5))])
def test_number_parameters_go_to_the_package_device(family, args):
    """A prior built from numbers alone lives on the package's device; on
    the card it used to hold CPU tensors, and NUTS's starting point then
    mixed devices (the relaxed SIR model's ``rho``)."""
    tpyro.set_default_device("meta")
    try:
        d = getattr(tdist, family)(*args)
        assert all(getattr(d, k).device.type == "meta" for k in d.arg_constraints or ("low", "high"))
    finally:
        tpyro.set_default_device("cpu")
