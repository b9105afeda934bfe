"""The port's distributions and transforms against the JAX package's, on
the CPU.  Each case builds the same distribution in both packages from
seeded numpy arrays.  Tolerances: values rtol 1e-5 (atol 1e-5 for values
near 0); the DiscreteHMM gradient rtol 1e-4 with atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu.distributions import transforms as jtransforms
from pyro_tpu_torch.distributions import constraints, transforms

RNG = np.random.default_rng(0)
F32 = np.float32


def _a(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(F32)


def _probs(*shape):
    return RNG.uniform(0.05, 0.95, size=shape).astype(F32)


def _simplex(*shape):
    return RNG.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(F32)


def _bits(*shape):
    return (RNG.random(shape) < 0.5).astype(F32)


LOGITS, BITS = _a(3, 4, scale=3), _bits(2, 3, 4)
PROBS = _probs(3, 4)
CAT_LOGITS, CAT_VALUE = _a(5, 6), RNG.integers(0, 6, size=(2, 5))
CAT_PROBS = _simplex(5, 6)
CONC, DIR_VALUE = RNG.uniform(0.5, 3.0, size=(3, 4)).astype(F32), _simplex(2, 3, 4)
DELTA_V = _a(3, 2)
MASK = RNG.random((2, 3)) < 0.5


def _hmm(init, trans, obs_logits):
    """Builder of a DiscreteHMM over Bernoulli emissions in package ``d``."""

    def build(d, a):
        obs = d.Bernoulli(logits=a(obs_logits)).to_event(1)
        return d.DiscreteHMM(a(init), a(trans), obs)

    return build


HMM_INIT = np.log(_simplex(4))
HMM_INIT_NEG_INF = np.where(np.arange(4) == 0, 0.0, -np.inf).astype(F32)
HMM_TRANS = _a(4, 4)

# name -> (build(d, a) -> distribution, value)
CASES = {
    "bernoulli_logits": (lambda d, a: d.Bernoulli(logits=a(LOGITS)), BITS),
    "bernoulli_probs": (lambda d, a: d.Bernoulli(probs=a(PROBS)), BITS),
    "categorical_logits": (lambda d, a: d.Categorical(logits=a(CAT_LOGITS)), CAT_VALUE),
    "categorical_probs": (lambda d, a: d.Categorical(probs=a(CAT_PROBS)), CAT_VALUE),
    "dirichlet": (lambda d, a: d.Dirichlet(a(CONC)), DIR_VALUE),
    "delta": (lambda d, a: d.Delta(a(DELTA_V)), DELTA_V),
    "delta_event": (lambda d, a: d.Delta(a(DELTA_V), event_dim=1, log_density=a(np.ones(3, F32))), DELTA_V),
    "delta_miss": (lambda d, a: d.Delta(a(DELTA_V), event_dim=1), DELTA_V + 1),
    "independent": (lambda d, a: d.Bernoulli(logits=a(LOGITS)).to_event(1), BITS),
    "independent_nested": (lambda d, a: d.Bernoulli(logits=a(LOGITS)).to_event(1).to_event(1), BITS),
    "masked": (lambda d, a: d.Bernoulli(logits=a(LOGITS)).mask(a(MASK[..., None])), BITS),
    "masked_false": (lambda d, a: d.Bernoulli(logits=a(LOGITS)).mask(False), BITS),
    "masked_event": (lambda d, a: d.Bernoulli(logits=a(LOGITS)).to_event(1).mask(a(MASK)), BITS),
    "expanded": (lambda d, a: d.ExpandedDistribution(d.Bernoulli(logits=a(LOGITS)), (2, 3, 4)), BITS),
    "expanded_dirichlet": (lambda d, a: d.Dirichlet(a(CONC)).expand((2, 3)), DIR_VALUE),
    "hmm_t7": (_hmm(HMM_INIT, HMM_TRANS, _a(2, 7, 4, 5, scale=2)), _bits(2, 7, 5)),
    "hmm_t13": (_hmm(HMM_INIT, HMM_TRANS, _a(2, 13, 4, 5, scale=2)), _bits(2, 13, 5)),
    "hmm_t13_neg_inf_init": (_hmm(HMM_INIT_NEG_INF, HMM_TRANS, _a(2, 13, 4, 5, scale=2)), _bits(2, 13, 5)),
    "hmm_batched_trans": (_hmm(HMM_INIT, _a(2, 7, 4, 4), _a(2, 7, 4, 5, scale=2)), _bits(3, 2, 7, 5)),
}


# the Beta cases draw from a generator of their own, so that the draws
# above and below keep their values
_BETA_RNG = np.random.default_rng(1)
BETA_C1, BETA_C0 = (_BETA_RNG.uniform(0.1, 3.0, size=(3, 4)).astype(F32) for _ in range(2))
BETA_VALUE = _BETA_RNG.uniform(0.05, 0.95, size=(2, 3, 4)).astype(F32)
CASES["beta"] = (lambda d, a: d.Beta(a(BETA_C1), a(BETA_C0)), BETA_VALUE)
# model_1v's probs_y prior: scalar concentrations expanded to (S, D)
CASES["beta_expanded_event"] = (
    lambda d, a: d.Beta(a(F32(0.1)), a(F32(0.9))).expand((3, 4)).to_event(2),
    BETA_VALUE,
)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_prob_matches_jax(case):
    build, value = CASES[case]
    jd = build(jdist, _jax)
    expected = np.asarray(jax.jit(jd.log_prob)(_jax(value)))
    d = build(tdist, _torch)
    actual = d.log_prob(_torch(value)).numpy()
    assert actual.shape == expected.shape
    assert (d.batch_shape, d.event_shape) == (jd.batch_shape, jd.event_shape)
    np.testing.assert_allclose(actual, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("time", [7, 13])
def test_discrete_hmm_gradient_matches_jax(time):
    obs_logits, value = _a(2, time, 4, 5, scale=2), _bits(2, time, 5)

    def jax_loss(trans):
        obs = jdist.Bernoulli(logits=_jax(obs_logits)).to_event(1)
        return jdist.DiscreteHMM(_jax(HMM_INIT_NEG_INF), trans, obs).log_prob(_jax(value)).sum()

    expected = np.asarray(jax.jit(jax.grad(jax_loss))(_jax(HMM_TRANS)))
    trans = torch.tensor(HMM_TRANS, requires_grad=True)
    obs = tdist.Bernoulli(logits=_torch(obs_logits)).to_event(1)
    tdist.DiscreteHMM(_torch(HMM_INIT_NEG_INF), trans, obs).log_prob(_torch(value)).sum().backward()
    np.testing.assert_allclose(trans.grad.numpy(), expected, rtol=1e-4, atol=1e-6)


def test_discrete_hmm_rejects_bad_time_axis():
    build, _ = CASES["hmm_t7"]
    with pytest.raises(ValueError):
        build(tdist, _torch).log_prob(_torch(_bits(2, 6, 5)))


X_SB = _a(3, 5, scale=2)


@pytest.mark.parametrize("what", ["forward", "inverse", "log_abs_det_jacobian"])
def test_stick_breaking_matches_jax(what):
    jt, tt = jtransforms.StickBreakingTransform(), transforms.StickBreakingTransform()
    jy, ty = jt(_jax(X_SB)), tt(_torch(X_SB))
    expected = {"forward": jy, "inverse": jt.inv(jy), "log_abs_det_jacobian": jt.log_abs_det_jacobian(_jax(X_SB), jy)}
    actual = {"forward": ty, "inverse": tt.inv(ty), "log_abs_det_jacobian": tt.log_abs_det_jacobian(_torch(X_SB), ty)}
    np.testing.assert_allclose(actual[what].numpy(), np.asarray(expected[what]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name", ["real", "positive", "unit_interval", "simplex", "independent_simplex"]
)
def test_transform_to_matches_jax(name):
    from pyro_tpu.distributions import constraints as jconstraints

    def constraint(c):
        return c.independent(c.simplex, 1) if name == "independent_simplex" else getattr(c, name)

    x = _a(3, 4)
    for registry in ("biject_to", "transform_to"):
        jt = getattr(jdist, registry)(constraint(jconstraints))
        tt = getattr(tdist, registry)(constraint(constraints))
        np.testing.assert_allclose(tt(_torch(x)).numpy(), np.asarray(jt(_jax(x))), rtol=1e-5, atol=1e-6)


def test_broadcast_shape():
    from pyro_tpu_torch.distributions.util import broadcast_shape

    assert broadcast_shape((3, 1), (4,), ()) == (3, 4)
    with pytest.raises(ValueError):
        broadcast_shape((3,), (4,))
    with pytest.raises(ValueError):
        broadcast_shape((1,), (4,), strict=True)


ENUMERABLE = {
    "bernoulli": lambda d, a: d.Bernoulli(probs=a(PROBS)),
    "categorical": lambda d, a: d.Categorical(logits=a(CAT_LOGITS)),
    "expanded_categorical": lambda d, a: d.Categorical(logits=a(CAT_LOGITS[0])).expand((2, 5)),
    "masked_bernoulli": lambda d, a: d.Bernoulli(logits=a(LOGITS)).mask(a(MASK[..., None])),
}


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("case", sorted(ENUMERABLE))
def test_enumerate_support_matches_jax(case, expand):
    expected = np.asarray(ENUMERABLE[case](jdist, _jax).enumerate_support(expand=expand))
    actual = ENUMERABLE[case](tdist, _torch).enumerate_support(expand=expand).numpy()
    assert actual.shape == expected.shape
    np.testing.assert_array_equal(actual, expected)


@pytest.mark.parametrize("name", ["Bernoulli-probs", "Bernoulli-logits", "Categorical-probs", "Categorical-logits",
                                  "Beta", "Dirichlet"])
def test_float64_parameters_keep_their_dtype(name):
    """A float64 parameter stays float64 under the float32 default dtype, so
    a float64 model computes in float64 throughout (a float32 cast here kept
    the DMM's float64 gradients at float32 rounding); its log_prob equals the
    same distribution's built under the float64 default."""
    rng = np.random.default_rng(4)
    p = torch.tensor(rng.uniform(0.1, 0.9, size=(3, 4)), dtype=torch.float64)
    build = {
        "Bernoulli-probs": lambda x: (tdist.Bernoulli(probs=x), torch.ones(3, 4, dtype=torch.float64)),
        "Bernoulli-logits": lambda x: (tdist.Bernoulli(logits=x), torch.zeros(3, 4, dtype=torch.float64)),
        "Categorical-probs": lambda x: (tdist.Categorical(probs=x), torch.tensor([0, 1, 3])),
        "Categorical-logits": lambda x: (tdist.Categorical(logits=x), torch.tensor([2, 1, 0])),
        "Beta": lambda x: (tdist.Beta(x, 2 * x), 0.5 * torch.ones(3, 4, dtype=torch.float64)),
        "Dirichlet": lambda x: (tdist.Dirichlet(x), (x / x.sum(-1, keepdim=True)).detach()),
    }[name]
    d, value = build(p)
    lp = d.log_prob(value)
    assert torch.get_default_dtype() == torch.float32 and lp.dtype == torch.float64
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        d64, _ = build(p)
        expected = d64.log_prob(value)
    finally:
        torch.set_default_dtype(old)
    assert torch.equal(lp, expected)


def test_beta_takes_one_dtype_for_both_concentrations():
    c64 = torch.tensor([0.5, 2.0], dtype=torch.float64)
    for d in (tdist.Beta(c64, 2.0), tdist.Beta(c64.float(), c64), tdist.Beta(1.5, c64)):
        assert d.concentration1.dtype == d.concentration0.dtype == torch.float64
        assert d.log_prob(torch.tensor([0.3, 0.6], dtype=torch.float64)).dtype == torch.float64
