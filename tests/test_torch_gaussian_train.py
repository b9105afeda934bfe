"""Training through the port's Gaussian halving levels against autograd and
the JAX package, on the CPU.

Inputs are drawn with numpy from a seed at small sizes.  What is compared,
and within what:

(a) each plain backward of ``ops/gaussian_levels.py`` (written out, not
    autograd) against torch autograd of its plain forward, float64, state
    dim n in {1, 3, 5}, odd and even t, random SPD blocks, P gradients
    symmetrised: rtol 1e-9 (with atol 1e-12 for entries that vanish);
(b) the VJPs of the port's ``sequential_gaussian_tensordot`` and
    ``sequential_gaussian_tensordot_homogeneous`` (through the autograd
    Functions of K4b and K4a) against ``jax.vjp`` of the JAX package's, R=2,
    T in {37, 64}, n=3, float32: the outputs within 1e-4 * max + 1e-4, the
    gradients within 1e-3 * max|grad| + 1e-4, P gradients symmetrised
    (the two packages read other triangles of P);
(c) ``GenericLGSSM`` (obs 2, state 3, T=37) with the JAX init carried
    across by ``param_store_from_jax``: log_prob rtol 1e-5, the gradient
    of every unconstrained parameter within 1e-4 * its max|grad|, and the
    parameters after 3 SVI steps with Adam (lr 0.01) within rtol and atol
    1e-4;
(d) the homogeneous ``--train`` model of ``examples/gaussian_hmm.py`` at
    batch 2, T=37, hidden 3, obs 2 against its JAX twin built from the JAX
    package's public API: loss rtol 1e-5, gradients within 1e-4 * max|grad|;
(e) ``factor`` and ``Unit``, and ``Parameterized.set_prior`` with the Delta
    and the "Normal" guide, against the JAX package: densities rtol 1e-6,
    ELBO rtol 1e-5, gradients within 1e-5 * max|grad|; the "Normal"
    guide's errors (a discrete prior, an unknown parameter) as the JAX
    package's.

The JAX side runs under ``jax.jit`` where it is more than a few ops (its
eager ops compile one by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu.contrib.gp.parameterized import Parameterized as JParameterized
from pyro_tpu.contrib.timeseries import GenericLGSSM as JGenericLGSSM
from pyro_tpu.distributions import constraints as jconstraints
from pyro_tpu.infer import SVI as JSVI
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu.ops import gaussian as jg
from pyro_tpu.optim import Adam as JAdam
from pyro_tpu_torch import poutine
from pyro_tpu_torch.contrib.gp import Parameterized
from pyro_tpu_torch.contrib.timeseries import GenericLGSSM
from pyro_tpu_torch.distributions import constraints
from pyro_tpu_torch.examples import gaussian_hmm as ex
from pyro_tpu_torch.examples import lgssm as tlgssm
from pyro_tpu_torch.infer import Trace_ELBO
from pyro_tpu_torch.ops import gaussian as tg
from pyro_tpu_torch.ops import gaussian_levels as gl
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


def _sym(g):
    return 0.5 * (g + g.swapaxes(-1, -2))


def _spd(rng, shape, n):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return M @ np.swapaxes(M, -1, -2) / n + np.eye(n)


def _near(actual, expected, scale=1e-3, atol=1e-4):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=scale * np.abs(expected).max() + atol)


# -- (a) the plain backward versions against autograd ----------------------------------


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("t", [7, 8])
def test_contract_backward_plain_matches_autograd(n, t):
    rng = np.random.default_rng(10 * n + t)
    R, t_out = 2, t - t // 2
    P = torch.tensor(_spd(rng, (R, t), 2 * n), requires_grad=True)
    info = torch.tensor(rng.standard_normal((R, t, 2 * n)), requires_grad=True)
    logZ = torch.tensor(rng.standard_normal((R, t)), requires_grad=True)
    g = [torch.tensor(rng.standard_normal(s)) for s in ((R, t_out, 2 * n, 2 * n), (R, t_out, 2 * n), (R, t_out))]
    P_out, info_out, logZ_out, tape = gl.contract_pairs_plain(P, info, logZ, tape=True)
    expected = torch.autograd.grad((P_out * g[0]).sum() + (info_out * g[1]).sum() + (logZ_out * g[2]).sum(),
                                   (P, info, logZ))
    got = gl.contract_pairs_bwd_plain(t, *(x.detach() for x in tape), *g)
    torch.testing.assert_close(got[0], _sym(expected[0]), rtol=1e-9, atol=1e-12)
    for a, b in zip(got[1:], expected[1:]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("m", [3, 4])
def test_halving_backward_plain_matches_autograd(n, m):
    rng = np.random.default_rng(10 * n + m)
    R = 2
    P = torch.tensor(_spd(rng, (), 2 * n), requires_grad=True)
    info = torch.tensor(rng.standard_normal((R, 2 * m, 2 * n)), requires_grad=True)
    logZ = torch.tensor(rng.standard_normal((R, 2 * m)), requires_grad=True)
    g = [torch.tensor(rng.standard_normal(s)) for s in ((2 * n, 2 * n), (R, m, 2 * n), (R, m))]
    P_out, info_out, logZ_out, L, ib = gl.halving_level_plain(P, info, logZ, tape=True)
    expected = torch.autograd.grad((P_out * g[0]).sum() + (info_out * g[1]).sum() + (logZ_out * g[2]).sum(),
                                   (P, info, logZ))
    got = gl.halving_level_bwd_plain(P.detach(), L.detach(), ib.detach(), *g)
    torch.testing.assert_close(got[0], _sym(expected[0]), rtol=1e-9, atol=1e-12)
    for a, b in zip(got[1:], expected[1:]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_plain_backward_takes_missing_gradients_as_zero():
    """An upstream gradient that autograd leaves out (None) counts as zero."""
    rng = np.random.default_rng(0)
    n, R, t = 2, 1, 5
    P = torch.tensor(_spd(rng, (R, t), 2 * n))
    info = torch.tensor(rng.standard_normal((R, t, 2 * n)))
    *_, tape = gl.contract_pairs_plain(P, info, torch.zeros(R, t, dtype=P.dtype), tape=True)
    g_logZ = torch.tensor(rng.standard_normal((R, 3)))
    got = gl.contract_pairs_bwd_plain(t, *tape, None, None, g_logZ)
    zeros = gl.contract_pairs_bwd_plain(t, *tape, torch.zeros(R, 3, 2 * n, 2 * n, dtype=P.dtype),
                                        torch.zeros(R, 3, 2 * n, dtype=P.dtype), g_logZ)
    for a, b in zip(got, zeros):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_route_the_backward_through_the_plain_adjoints(monkeypatch):
    """On the CPU the levels' backward is the written-out adjoint, not
    autograd of the forward; a gradient that reaches the tape raises."""
    rng = np.random.default_rng(1)
    n, R, t = 2, 2, 6
    calls = []
    for name in ("halving_level_bwd_plain", "contract_pairs_bwd_plain"):
        fn = getattr(gl, name)
        monkeypatch.setattr(gl, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    P = torch.tensor(_spd(rng, (), 2 * n), requires_grad=True)
    info = torch.tensor(rng.standard_normal((R, t, 2 * n)), requires_grad=True)
    logZ = torch.zeros(R, t, dtype=P.dtype)
    gl.halving_level(P, info, logZ)[2].sum().backward()
    Pt = torch.tensor(_spd(rng, (R, t), 2 * n), requires_grad=True)
    gl.contract_pairs(Pt, info, logZ)[2].sum().backward()
    assert calls == ["halving_level_bwd_plain", "contract_pairs_bwd_plain"]
    with pytest.raises(NotImplementedError, match="K4c's backward, ROADMAP.md Queue 2"):
        gl.halving_level(P, info, logZ, tape=True)[4].sum().backward()
    with pytest.raises(NotImplementedError, match="K4c's backward, ROADMAP.md Queue 2"):
        gl.contract_pairs(Pt, info, logZ, tape=True)[3][0].sum().backward()


# -- (b) the time contractions' VJPs against jax.vjp -------------------------------------


def _contraction_case(T, homogeneous, seed=3, R=2, n=3):
    rng = np.random.default_rng(seed + T)
    P = _spd(rng, () if homogeneous else (R, T), 2 * n).astype(np.float32)
    info = rng.standard_normal((R, T, 2 * n)).astype(np.float32)
    logZ = rng.standard_normal((R, T)).astype(np.float32)
    return logZ, info, P


@pytest.mark.parametrize("homogeneous", [False, True], ids=["heterogeneous", "homogeneous"])
@pytest.mark.parametrize("T", [37, 64])
def test_contraction_vjp_matches_jax(T, homogeneous):
    logZ, info, P = _contraction_case(T, homogeneous)
    t_fn = tg.sequential_gaussian_tensordot_homogeneous if homogeneous else tg.sequential_gaussian_tensordot
    j_fn = jg.sequential_gaussian_tensordot_homogeneous if homogeneous else jg.sequential_gaussian_tensordot

    def jax_fn(lz, iv, p):
        out = j_fn(jg.Gaussian(lz, iv, p))
        return out.log_normalizer, out.info_vec, out.precision

    outs_j, vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(P))
    rng = np.random.default_rng(T)
    cot = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs_j]
    grads_j = jax.jit(vjp)(tuple(jnp.asarray(c) for c in cot))

    leaves = [torch.tensor(x, requires_grad=True) for x in (logZ, info, P)]
    out = t_fn(tg.Gaussian(*leaves))
    outs_t = (out.log_normalizer, out.info_vec, out.precision)
    for a, b in zip(outs_t, outs_j):
        _near(a.detach().numpy(), b, scale=1e-4)
    sum(((o * torch.tensor(c)).sum() for o, c in zip(outs_t, cot))).backward()
    _near(leaves[0].grad.numpy(), grads_j[0])
    _near(leaves[1].grad.numpy(), grads_j[1])
    _near(_sym(leaves[2].grad.numpy()), _sym(np.asarray(grads_j[2])))


# -- (c) GenericLGSSM against the JAX package --------------------------------------------

LGSSM_OBS, LGSSM_STATE, LGSSM_T, LGSSM_STEPS, LGSSM_LR = 2, 3, 37, 3, 0.01  # the lr of make_train_svi
LGSSM_TARGETS = np.random.default_rng(7).standard_normal((LGSSM_T, LGSSM_OBS)).astype(np.float32)


def _jax_loss_and_grads(model, args, store):
    """-ELBO of ``model`` (empty guide) and its gradients with respect to
    the JAX store's unconstrained params."""
    elbo = JTrace_ELBO()

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(model, _no_guide, *args, rng_key=jax.random.key(0))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(store.get_all_unconstrained())
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grads(model, args):
    with poutine.trace(param_only=True) as capture:
        loss = Trace_ELBO().differentiable_loss(model, _no_guide, *args)
    loss.backward()
    store = pyro.get_param_store()
    return float(loss.detach()), {k: store.get_unconstrained(k).grad.numpy() for k in capture.trace.param_nodes()}


@pytest.fixture(scope="module")
def jax_lgssm():
    """The JAX GenericLGSSM's initial params (constrained), its log_prob, the
    gradients, and the unconstrained params after each of 3 SVI steps."""
    jpyro.clear_param_store()
    m = JGenericLGSSM(obs_dim=LGSSM_OBS, state_dim=LGSSM_STATE, name="GenericLGSSM")

    def model(targets):
        jpyro.factor("log_prob", m.log_prob(targets))

    targets = jnp.asarray(LGSSM_TARGETS)
    JTrace_ELBO().loss(model, _no_guide, targets, rng_key=jax.random.key(0))  # registers the params
    store = jpyro.get_param_store()
    init = {k: np.asarray(v) for k, v in store.items()}
    log_prob = float(jax.jit(m.log_prob)(targets))
    loss, grads = _jax_loss_and_grads(model, (targets,), store)
    svi = JSVI(model, _no_guide, JAdam({"lr": LGSSM_LR}), JTrace_ELBO())
    trajectory = []
    for _ in range(LGSSM_STEPS):
        svi.step(targets)
        trajectory.append({k: np.asarray(v) for k, v in store.get_all_unconstrained().items()})
    jpyro.clear_param_store()
    return {"init": init, "log_prob": log_prob, "loss": loss, "grads": grads, "trajectory": trajectory}


def _port_lgssm(init):
    m = GenericLGSSM(obs_dim=LGSSM_OBS, state_dim=LGSSM_STATE, name="GenericLGSSM")
    m.get_dist()  # registers the params
    param_store_from_jax(init)
    return tlgssm.make_model(m), m


def test_param_store_from_jax_keeps_names_and_constraints(jax_lgssm):
    _, m = _port_lgssm(jax_lgssm["init"])
    store = pyro.get_param_store()
    for name, value in jax_lgssm["init"].items():
        np.testing.assert_allclose(store[name].detach().numpy(), value, rtol=1e-6)
    # a positive parameter is stored as its log
    np.testing.assert_allclose(store.get_unconstrained("GenericLGSSM.obs_noise_scale").detach().numpy(),
                               np.log(jax_lgssm["init"]["GenericLGSSM.obs_noise_scale"]), rtol=1e-6)
    with pytest.raises(KeyError):
        param_store_from_jax({"GenericLGSSM.not_a_param": np.zeros(2)})


def test_lgssm_log_prob_and_gradients_match_jax(jax_lgssm):
    model, m = _port_lgssm(jax_lgssm["init"])
    targets = torch.tensor(LGSSM_TARGETS)
    with torch.no_grad():
        assert float(m.log_prob(targets)) == pytest.approx(jax_lgssm["log_prob"], rel=1e-5)
    loss, grads = _port_loss_and_grads(model, (targets,))
    assert loss == pytest.approx(jax_lgssm["loss"], rel=1e-5)
    assert sorted(grads) == sorted(jax_lgssm["grads"])
    for name, expected in jax_lgssm["grads"].items():
        _near(grads[name], expected, scale=1e-4, atol=0)


def test_lgssm_svi_trajectory_matches_jax(jax_lgssm):
    model, _ = _port_lgssm(jax_lgssm["init"])
    svi = ex.make_train_svi(model)
    targets = torch.tensor(LGSSM_TARGETS)
    store = pyro.get_param_store()
    for step in range(LGSSM_STEPS):
        svi.step(targets)
        for name, expected in jax_lgssm["trajectory"][step].items():
            np.testing.assert_allclose(store.get_unconstrained(name).detach().numpy(), expected, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} after step {step + 1}")


def test_lgssm_forecast_matches_jax(jax_lgssm):
    _, m = _port_lgssm(jax_lgssm["init"])
    jpyro.clear_param_store()
    jm = JGenericLGSSM(obs_dim=LGSSM_OBS, state_dim=LGSSM_STATE, name="GenericLGSSM")
    jstore = jpyro.get_param_store()
    for name, value in jax_lgssm["init"].items():
        jstore.setdefault(name, jnp.asarray(value), jconstraints.positive if "scale" in name else jconstraints.real)
    expected = jm.forecast(jnp.asarray(LGSSM_TARGETS), 3)
    with torch.no_grad():
        got = m.forecast(torch.tensor(LGSSM_TARGETS), 3)
    _near(got.loc.numpy(), expected.loc, scale=1e-4)
    _near(got.covariance_matrix.numpy(), expected.covariance_matrix, scale=1e-4)


# -- (d) the homogeneous --train model against its JAX twin --------------------------------

HOM_SIZES = {"batch": 2, "T": 37, "hidden": 3, "obs": 2}
JAX_TRAIN_CONSTRAINTS = {
    "trans_mat": jconstraints.real, "obs_mat": jconstraints.real, "init_scale": jconstraints.positive,
    "trans_scale": jconstraints.positive, "obs_scale": jconstraints.positive,
}


def _jax_train_model(arrays):
    """The twin of ``examples/gaussian_hmm.py::make_train_model``, from the
    JAX package's public API."""

    def model(data):
        p = {k: jnp.asarray(v) for k, v in arrays.items() if k not in JAX_TRAIN_CONSTRAINTS}
        p.update({k: jpyro.param(k, jnp.asarray(arrays[k]), constraint=c) for k, c in JAX_TRAIN_CONSTRAINTS.items()})
        hmm = jdist.GaussianHMM(
            jdist.Normal(p["init_loc"], p["init_scale"]).to_event(1), p["trans_mat"],
            jdist.Normal(p["trans_loc"], p["trans_scale"]).to_event(1), p["obs_mat"],
            jdist.Normal(p["obs_loc"], p["obs_scale"]).to_event(1), duration=data.shape[-2],
        )
        jpyro.factor("log_prob", hmm.log_prob(data).sum())

    return model


def test_train_model_names_match_the_jax_twin():
    assert list(ex.TRAIN_PARAMS) == list(JAX_TRAIN_CONSTRAINTS)


def test_homogeneous_train_model_matches_jax():
    arrays = ex.make_arrays("homogeneous", 0, **HOM_SIZES)
    data = arrays.pop("data")
    jmodel = _jax_train_model(arrays)
    JTrace_ELBO().loss(jmodel, _no_guide, jnp.asarray(data), rng_key=jax.random.key(0))  # registers the params
    loss_j, grads_j = _jax_loss_and_grads(jmodel, (jnp.asarray(data),), jpyro.get_param_store())

    params = ex.params_from_jax(arrays)
    loss_t, grads_t = _port_loss_and_grads(ex.make_train_model(params), (torch.tensor(data),))
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert sorted(grads_t) == sorted(grads_j)
    for name, expected in grads_j.items():
        _near(grads_t[name], expected, scale=1e-4, atol=0)


# -- (e) factor, Unit and Parameterized --------------------------------------------------


def test_unit_matches_jax():
    log_factor = np.random.default_rng(2).standard_normal((3, 2)).astype(np.float32)
    t, j = tdist.Unit(torch.tensor(log_factor)), jdist.Unit(jnp.asarray(log_factor))
    assert t.batch_shape == j.batch_shape and t.event_shape == j.event_shape == (0,)
    assert tuple(t.sample(sample_shape=(4,)).shape) == j.sample(jax.random.key(0), (4,)).shape
    value = np.zeros((5, 3, 2, 0), np.float32)
    np.testing.assert_allclose(t.log_prob(torch.tensor(value)).numpy(), j.log_prob(jnp.asarray(value)), rtol=1e-6)
    assert tuple(t.expand((4, 3, 2)).batch_shape) == j.expand((4, 3, 2)).batch_shape


def test_factor_site_matches_jax():
    log_factor = np.random.default_rng(3).standard_normal(4).astype(np.float32)

    def tmodel():
        pyro.factor("f", torch.tensor(log_factor))

    def jmodel():
        jpyro.factor("f", jnp.asarray(log_factor))

    site = poutine.trace(tmodel).get_trace().nodes["f"]
    assert site["is_observed"] and site["infer"]["is_auxiliary"] and isinstance(site["fn"], tdist.Unit)
    loss_t = float(Trace_ELBO().loss(tmodel, _no_guide))
    loss_j = float(JTrace_ELBO().loss(jmodel, _no_guide, rng_key=jax.random.key(0)))
    assert loss_t == pytest.approx(loss_j, rel=1e-6)
    assert loss_t == pytest.approx(-float(log_factor.sum()), rel=1e-6)


class _TScaled(Parameterized):
    def __init__(self):
        super().__init__(name="Scaled")
        self._register_param("loc", torch.tensor([0.5, -1.0, 2.0]))
        self._register_param("scale", torch.tensor([1.5, 0.7, 2.0]), constraints.positive)


class _JScaled(JParameterized):
    def __init__(self):
        super().__init__(name="Scaled")
        self._register_param("loc", jnp.asarray([0.5, -1.0, 2.0]))
        self._register_param("scale", jnp.asarray([1.5, 0.7, 2.0]), jconstraints.positive)


SCALED_DATA = np.random.default_rng(4).standard_normal((6, 3)).astype(np.float32)


def _scaled_model_and_guide(m, pyro_mod, dist_mod):
    def model(data):
        m.set_mode("model")
        pyro_mod.sample("obs", dist_mod.Normal(m.loc, m.scale).to_event(1), obs=data)

    def guide(data):
        m.set_mode("guide")
        m.scale  # noqa: B018  (the Delta guide's site)

    return model, guide


def test_parameterized_set_prior_with_delta_guide_matches_jax():
    tm, jm = _TScaled(), _JScaled()
    tm.set_prior("scale", tdist.HalfCauchy(torch.ones(3)).to_event(1))
    jm.set_prior("scale", jdist.HalfCauchy(jnp.ones(3)).to_event(1))
    tmodel, tguide = _scaled_model_and_guide(tm, pyro, tdist)
    jmodel, jguide = _scaled_model_and_guide(jm, jpyro, jdist)
    data_j = jnp.asarray(SCALED_DATA)
    JTrace_ELBO().loss(jmodel, jguide, data_j, rng_key=jax.random.key(0))  # registers the params
    jstore = jpyro.get_param_store()
    assert sorted(jstore.keys()) == ["Scaled.loc", "Scaled.scale_map"]
    elbo = JTrace_ELBO()

    def loss_fn(p):
        with ParamsMessenger(p):
            return elbo.differentiable_loss(jmodel, jguide, data_j, rng_key=jax.random.key(0))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jstore.get_all_unconstrained())

    guide_trace = poutine.trace(tguide).get_trace(torch.tensor(SCALED_DATA))
    assert isinstance(guide_trace.nodes["Scaled.scale"]["fn"], tdist.Delta)
    with poutine.trace(param_only=True) as capture:
        loss_t = Trace_ELBO().differentiable_loss(tmodel, tguide, torch.tensor(SCALED_DATA))
    loss_t.backward()
    store = pyro.get_param_store()
    assert sorted(capture.trace.param_nodes()) == ["Scaled.loc", "Scaled.scale_map"]
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for name, expected in grads_j.items():
        _near(store.get_unconstrained(name).grad.numpy(), expected, scale=1e-5, atol=0)


def test_parameterized_normal_autoguide_raises():
    """The errors the "Normal" per-site guide keeps, as the JAX package's:
    a prior with a discrete support has no bijection to draw through
    (NotImplementedError in both packages), and a prior for an unknown
    parameter is a KeyError."""
    tm, jm = _TScaled(), _JScaled()
    tm.set_prior("scale", tdist.Bernoulli(torch.full((3,), 0.5)).to_event(1))
    jm.set_prior("scale", jdist.Bernoulli(jnp.full((3,), 0.5)).to_event(1))
    for m, poutine_mod in ((tm, poutine), (jm, jpoutine)):
        m.autoguide("scale", "Normal")
        m.set_mode("guide")
        with pytest.raises(NotImplementedError):
            poutine_mod.trace(lambda: m.scale).get_trace()  # noqa: B023
    with pytest.raises(KeyError):
        tm.set_prior("not_a_param", tdist.HalfCauchy(torch.ones(3)))


def test_parameterized_normal_autoguide_matches_jax():
    """The "Normal" per-site guide against the JAX package's (it raised
    before the port had ``TransformedDistribution``).  At one fixed value of the site, -ELBO
    = log q(scale) - log p(data, scale) (the guide conditioned there, the
    model conditioned on it: the JAX replay refuses a conditioned guide
    site) rtol 1e-5, gradients within 1e-5 * max|grad|."""
    fixed = np.array([1.2, 0.6, 2.5], np.float32)
    tm, jm = _TScaled(), _JScaled()
    tm.set_prior("scale", tdist.HalfCauchy(torch.ones(3)).to_event(1))
    jm.set_prior("scale", jdist.HalfCauchy(jnp.ones(3)).to_event(1))
    tm.autoguide("scale", "Normal")
    jm.autoguide("scale", "Normal")
    tmodel, tguide = _scaled_model_and_guide(tm, pyro, tdist)
    jmodel, jguide = _scaled_model_and_guide(jm, jpyro, jdist)

    def loss_at(poutine_mod, model, guide, value, data):
        guide_trace = poutine_mod.trace(poutine_mod.condition(guide, data={"Scaled.scale": value})).get_trace(data)
        model_trace = poutine_mod.trace(poutine_mod.condition(model, data={"Scaled.scale": value})).get_trace(data)
        return guide_trace.log_prob_sum() - model_trace.log_prob_sum()

    data_j = jnp.asarray(SCALED_DATA)
    JTrace_ELBO().loss(jmodel, jguide, data_j, rng_key=jax.random.key(0))  # registers the params
    jstore = jpyro.get_param_store()
    assert sorted(jstore.keys()) == ["Scaled.loc", "Scaled.scale_map", "Scaled.scale_scale"]

    def loss_fn(p):
        with ParamsMessenger(p):
            return loss_at(jpoutine, jmodel, jguide, jnp.asarray(fixed), data_j)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(jstore.get_all_unconstrained())

    data_t = torch.tensor(SCALED_DATA)
    Trace_ELBO().loss(tmodel, tguide, data_t)  # registers the params; the guide draws through the transform
    guide_trace = poutine.trace(tguide).get_trace(data_t)
    site = guide_trace.nodes["Scaled.scale"]
    assert isinstance(site["fn"], tdist.TransformedDistribution) and bool((site["value"] > 0).all())
    param_store_from_jax({k: np.asarray(v) for k, v in jstore.items()})
    with poutine.trace(param_only=True) as capture:
        loss_t = loss_at(poutine, tmodel, tguide, torch.tensor(fixed), data_t)
    loss_t.backward()
    store = pyro.get_param_store()
    assert sorted(capture.trace.param_nodes()) == ["Scaled.loc", "Scaled.scale_map", "Scaled.scale_scale"]
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for name, expected in grads_j.items():
        _near(store.get_unconstrained(name).grad.numpy(), expected, scale=1e-5, atol=0)
