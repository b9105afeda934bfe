"""The port's gamma-Gaussian algebra (``ops/gamma_gaussian.py``), its K5
halving levels' plain versions (``ops/gaussian_levels.py``), ``Gamma`` and
``GammaGaussianHMM`` (built by ``examples/gamma_gaussian_hmm.py``) against
the JAX package, on the CPU.

Inputs are drawn with numpy from a seed at small sizes (batch 2, hidden 3,
obs 2, T in {1, 7, 8, 13}: one step, odd, a power of two, and blocks of 8,
4 and 1) and go through both packages; the JAX side runs under
``jax.jit``.  Tolerances: float32 throughout, rtol 1e-4 with atol 1e-4
(the factors are of order 1 to 10, summed in another order than XLA sums
them, and Cholesky-factorised by another algorithm); alpha, which only
sums constants, to 1e-6; ``log_prob`` against quadrature over the mixing
variable atol 1e-2 (the grid's own error, as ``tests/test_gamma_gaussian.py``
holds the JAX package).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu.ops import gamma_gaussian as jgg
from pyro_tpu_torch.examples import gamma_gaussian_hmm as ex
from pyro_tpu_torch.ops import gamma_gaussian as tgg
from pyro_tpu_torch.ops import gaussian_levels as gl

RTOL = ATOL = 1e-4
SMALL = {"hidden": 3, "obs": 2, "batch": 2}
TIMES = [1, 7, 8, 13]
FIELDS = ("log_normalizer", "info_vec", "precision", "alpha", "beta")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    gl.reset_counts()
    yield
    assert not any(gl.launches.values()), f"a kernel was launched on the CPU: {gl.launches}"


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _close(actual, expected, rtol=RTOL, atol=ATOL):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol)


def _close_gg(t, j):
    for k in FIELDS:
        _close(getattr(t, k), getattr(j, k))


def _spd(rng, shape, n):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return (M @ np.swapaxes(M, -1, -2) / n + np.eye(n)).astype(np.float32)


def _arrays(seed, batch, n, shared_precision=False):
    """log_normalizer, info_vec, precision, alpha and beta of a batch."""
    rng = np.random.default_rng(seed)
    P = _spd(rng, () if shared_precision else batch, n)
    logZ = rng.standard_normal(batch).astype(np.float32)
    info = rng.standard_normal(tuple(batch) + (n,)).astype(np.float32)
    alpha = (2.0 + rng.integers(0, 4, batch)).astype(np.float32)
    beta = (1.0 + rng.random(batch)).astype(np.float32)
    return logZ, info, P, alpha, beta


def _both(*arrays):
    return (tgg.GammaGaussian(*(torch.tensor(a) for a in arrays)),
            jgg.GammaGaussian(*(jnp.asarray(a) for a in arrays)))


def _chain(seed, batch, T, n, shared_precision):
    """A chain of T factors over (z_t, z_t+1): batch + (T,) of dim 2n."""
    return _arrays(seed, tuple(batch) + (T,), 2 * n, shared_precision)


def _mvn_both(seed, batch, n):
    """The same MultivariateNormal in both packages."""
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal(tuple(batch) + (n,)).astype(np.float32)
    cov = _spd(rng, batch, n)
    return (tdist.MultivariateNormal(torch.tensor(loc), covariance_matrix=torch.tensor(cov)),
            jdist.MultivariateNormal(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov)))


# -- Gamma ----------------------------------------------------------------------------


def test_gamma_distribution():
    conc = np.array([0.7, 2.0, 5.5], np.float32)
    rate = np.array([1.0, 2.0, 0.3], np.float32)
    t, j = tdist.Gamma(torch.tensor(conc), torch.tensor(rate)), jdist.Gamma(jnp.asarray(conc), jnp.asarray(rate))
    x = np.array([[0.2, 1.3, 9.0], [3.0, 0.5, 20.0]], np.float32)
    _close(t.log_prob(torch.tensor(x)), j.log_prob(jnp.asarray(x)))
    _close(t.mean, j.mean)
    _close(t.variance, j.variance)
    assert t.batch_shape == (3,) and t.expand((4, 3)).batch_shape == (4, 3)
    scalar = tdist.Gamma(2.0, 2.0)
    assert scalar.concentration.device.type == "cpu" and scalar.batch_shape == ()
    draws = t.rsample(torch.Generator().manual_seed(0), (20000,))
    again = t.rsample(torch.Generator().manual_seed(0), (20000,))
    assert draws.shape == (20000, 3) and bool((draws > 0).all()) and torch.equal(draws, again)
    se = torch.sqrt(t.variance / 20000)
    assert bool(((draws.mean(0) - t.mean).abs() < 5 * se).all())


# -- GammaGaussian methods ------------------------------------------------------------


def test_gamma_gaussian_shape_methods():
    t, j = _both(*_arrays(0, (3, 1), 4))
    assert t.dim == j.dim and t.batch_shape == tuple(j.batch_shape)
    _close_gg(t.expand((2, 3, 5)), j.expand((2, 3, 5)))
    _close_gg(t.expand((3, 2)).reshape((6,)), j.expand((3, 2)).reshape((6,)))
    _close_gg(t[1], j[1])
    _close_gg(t[:, 0], j[:, 0])
    _close_gg(tgg.GammaGaussian.cat([t, t[:2]], dim=0), jgg.GammaGaussian.cat([j, j[:2]], dim=0))
    _close_gg(t.event_pad(left=2, right=1), j.event_pad(left=2, right=1))
    _close_gg(t.event_permute([2, 0, 3, 1]), j.event_permute(jnp.array([2, 0, 3, 1])))
    t2, j2 = _both(*_arrays(1, (3, 1), 4))
    _close_gg(t + t2, j + j2)


def test_gamma_gaussian_log_density():
    t, j = _both(*_arrays(2, (3,), 4))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 4)).astype(np.float32)
    s = (0.5 + rng.random((5, 3))).astype(np.float32)
    _close(t.log_density(torch.tensor(x), torch.tensor(s)), j.log_density(jnp.asarray(x), jnp.asarray(s)))
    empty = np.zeros((5, 3, 0), np.float32)
    t0, j0 = _both(*_arrays(2, (3,), 0))
    _close(t0.log_density(torch.tensor(empty), torch.tensor(s)), j0.log_density(jnp.asarray(empty), jnp.asarray(s)))


@pytest.mark.parametrize("nb", [1, 3])
def test_gamma_gaussian_condition(nb):
    t, j = _both(*_arrays(4, (2, 3), 5))
    v = np.random.default_rng(5).standard_normal((2, 3, nb)).astype(np.float32)
    _close_gg(t.condition(torch.tensor(v)), _jit(lambda g, v: g.condition(v), j, jnp.asarray(v)))


@pytest.mark.parametrize("left,right", [(0, 0), (2, 0), (0, 3), (5, 0)])
def test_gamma_gaussian_marginalize(left, right):
    t, j = _both(*_arrays(6, (2, 3), 5))
    _close_gg(t.marginalize(left, right), _jit(lambda g: g.marginalize(left, right), j))
    with pytest.raises(NotImplementedError):
        t.marginalize(1, 1)


def test_gamma_gaussian_event_logsumexp():
    logZ, info, P, alpha, beta = _arrays(7, (2, 3), 4)
    t, j = _both(logZ, info, P, alpha, beta + 10.0)  # a positive rate: beta above info'P^-1 info / 2
    tg_, jg_ = t.event_logsumexp(), _jit(lambda g: g.event_logsumexp(), j)
    for k in ("log_normalizer", "concentration", "rate"):
        _close(getattr(tg_, k), getattr(jg_, k))
    _close(tg_.logsumexp(), jg_.logsumexp())
    s = np.array([0.5, 1.7], np.float32)[:, None, None]
    _close(tg_.log_density(torch.tensor(s)), jg_.log_density(jnp.asarray(s)))


def test_compound_names_the_roadmap():
    t, _ = _both(*_arrays(8, (2,), 3))
    with pytest.raises(NotImplementedError, match="item 7"):
        t.compound()


@pytest.mark.parametrize("kind", ["independent_normal", "mvn"])
def test_gamma_and_mvn_to_gamma_gaussian(kind):
    if kind == "mvn":
        tm, jm = _mvn_both(9, (2,), 3)
    else:
        rng = np.random.default_rng(10)
        loc, scale = rng.standard_normal((2, 3)).astype(np.float32), (0.5 + rng.random((2, 3))).astype(np.float32)
        tm = tdist.Normal(torch.tensor(loc), torch.tensor(scale)).to_event(1)
        jm = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)).to_event(1)
    t = tgg.gamma_and_mvn_to_gamma_gaussian(tdist.Gamma(2.5, 3.0), tm)
    j = _jit(lambda: jgg.gamma_and_mvn_to_gamma_gaussian(jdist.Gamma(2.5, 3.0), jm))
    _close_gg(t, j)


@pytest.mark.parametrize("mat_batch", [(), (5,)])
def test_matrix_and_mvn_to_gamma_gaussian(mat_batch):
    mat = np.random.default_rng(11).standard_normal(mat_batch + (4, 3)).astype(np.float32)
    tm, jm = _mvn_both(12, (), 3)
    t = tgg.matrix_and_mvn_to_gamma_gaussian(torch.tensor(mat), tm)
    j = _jit(lambda m: jgg.matrix_and_mvn_to_gamma_gaussian(m, jm), jnp.asarray(mat))
    _close_gg(t, j)


@pytest.mark.parametrize("dims", [0, 2])
def test_gamma_gaussian_tensordot(dims):
    t1, j1 = _both(*_arrays(13, (3,), 4))
    t2, j2 = _both(*_arrays(14, (3,), 5))
    _close_gg(tgg.gamma_gaussian_tensordot(t1, t2, dims), _jit(lambda x, y: jgg.gamma_gaussian_tensordot(x, y, dims),
                                                               j1, j2))


# -- K5's plain versions against the JAX level code ----------------------------------


def test_gamma_halving_level_plain_matches_jax():
    """K5a: one level, as the JAX homogeneous contraction of chains of two
    factors (one block, one level), each pair a batch item."""
    R, m, n = 2, 3, 3
    logZ, info, P, alpha, beta = _chain(15, (R, m), 2, n, shared_precision=True)
    out = gl.gamma_halving_level_plain(
        torch.tensor(P), torch.tensor(info.reshape(R, 2 * m, 2 * n)),
        *(torch.tensor(x.reshape(R, 2 * m)) for x in (logZ, alpha, beta)))
    ref = _jit(jgg.sequential_gamma_gaussian_tensordot_homogeneous, _both(logZ, info, P, alpha, beta)[1])
    _close(out[0], ref.precision)
    _close(out[1], ref.info_vec)
    _close(out[2], ref.log_normalizer)
    _close(out[3], ref.alpha, rtol=1e-6, atol=1e-6)
    _close(out[4], ref.beta)


@pytest.mark.parametrize("T", [2, 7])
def test_gamma_contract_pairs_plain_matches_jax(T):
    """K5b: each pair against ``gamma_gaussian_tensordot(x, y, n)``, the odd
    level's last factor carried."""
    n = 3
    arrays = _chain(16, (2,), T, n, shared_precision=False)
    logZ, info, P, alpha, beta = (torch.tensor(a) for a in arrays)
    out = gl.gamma_contract_pairs_plain(P, info, logZ, alpha, beta)
    e = T // 2 * 2
    x = jgg.GammaGaussian(*(jnp.asarray(a[:, 0:e:2]) for a in arrays))
    y = jgg.GammaGaussian(*(jnp.asarray(a[:, 1:e:2]) for a in arrays))
    ref = _jit(lambda x, y: jgg.gamma_gaussian_tensordot(x, y, n), x, y)
    if T > e:
        ref = jgg.GammaGaussian.cat([ref, jgg.GammaGaussian(*(jnp.asarray(a[:, e:]) for a in arrays))], dim=-1)
    for got, k in zip(out, ("precision", "info_vec", "log_normalizer", "alpha", "beta")):
        _close(got, getattr(ref, k))


# -- the time contractions ----------------------------------------------------------


@pytest.mark.parametrize("T", TIMES)
def test_sequential_gamma_gaussian_tensordot_homogeneous(T):
    t, j = _both(*_chain(17, (2,), T, 2, shared_precision=True))
    _close_gg(tgg.sequential_gamma_gaussian_tensordot_homogeneous(t),
              _jit(jgg.sequential_gamma_gaussian_tensordot_homogeneous, j))


@pytest.mark.parametrize("T", TIMES)
def test_sequential_gamma_gaussian_tensordot(T):
    t, j = _both(*_chain(18, (2,), T, 2, shared_precision=False))
    _close_gg(tgg.sequential_gamma_gaussian_tensordot(t), _jit(jgg.sequential_gamma_gaussian_tensordot, j))


# -- GammaGaussianHMM ---------------------------------------------------------------


def _models(config, T, **overrides):
    arrays = ex.make_arrays(config, 0, T=T, **{**SMALL, **overrides})
    params = ex.params_from_jax(arrays)
    data = params.pop("data")
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jhmm = jdist.GammaGaussianHMM(
        jdist.Gamma(j["scale_concentration"], j["scale_rate"]),
        jdist.Normal(j["init_loc"], j["init_scale"]).to_event(1), j["trans_mat"],
        jdist.Normal(j["trans_loc"], j["trans_scale"]).to_event(1), j["obs_mat"],
        jdist.Normal(j["obs_loc"], j["obs_scale"]).to_event(1), duration=T,
    )
    return ex.make_hmm(params, T), data, jhmm, j["data"]


@pytest.mark.parametrize("config", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("T", TIMES)
def test_gamma_gaussian_hmm_log_prob_and_filter_match_jax(config, T):
    """Both routes of ``log_prob`` (homogeneous: K5a; a transition per step:
    K5b) and ``filter`` (K5b on both) against the JAX package."""
    hmm, data, jhmm, jdata = _models(config, T)
    assert hmm.batch_shape == tuple(jhmm.batch_shape) and hmm.event_shape == tuple(jhmm.event_shape)
    assert (hmm._conditioned(data).precision.ndim == 2) == (config == "homogeneous")
    jlp, (jgamma, jmvn) = _jit(lambda x: (jhmm.log_prob(x), jhmm.filter(x)), jdata)
    _close(hmm.log_prob(data), jlp, rtol=1e-5)
    gamma, mvn = hmm.filter(data)
    assert isinstance(gamma, tdist.Gamma) and isinstance(mvn, tdist.MultivariateNormal)
    _close(gamma.concentration, jgamma.concentration, rtol=1e-6, atol=1e-6)
    _close(gamma.rate, jgamma.rate)
    _close(mvn.loc, jmvn.loc)
    _close(mvn.covariance_matrix, jmvn.covariance_matrix)
    with pytest.raises(NotImplementedError):
        hmm.mean
    with pytest.raises(NotImplementedError):
        hmm.variance


@pytest.mark.parametrize("T", [1, 3, 8, 13, 50])
def test_homogeneous_route_matches_general(T):
    """The shared-precision route (K5a) against the general contraction
    (K5b) on the same chain, as ``tests/test_gamma_gaussian.py`` holds the
    JAX package's: within 1e-3 times max(1, |log p|)."""
    hmm, data, _, _ = _models("homogeneous", T)
    r = hmm._conditioned(data)
    assert r.precision.ndim == 2
    r = tgg.sequential_gamma_gaussian_tensordot(r.expand(r.batch_shape))
    ref = tgg.gamma_gaussian_tensordot(hmm._init, r, dims=hmm.hidden_dim).event_logsumexp().logsumexp()
    lp = hmm.log_prob(data)
    assert bool(((lp - ref).abs() < 1e-3 * ref.abs().clamp(min=1.0)).all()), (lp, ref)


def test_expand_and_bad_values():
    hmm, data, _, _ = _models("homogeneous", 9)
    big = hmm.expand((3, 2))
    assert big.batch_shape == (3, 2) and big.event_shape == (9, SMALL["obs"])
    _close(big.log_prob(data), hmm.log_prob(data).expand(3, 2), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        hmm.log_prob(data[..., :1])
    with pytest.raises(ValueError):
        hmm.log_prob(data[:, :5])


@pytest.mark.parametrize("T", [1, 2])
def test_log_prob_against_quadrature(T):
    """``log_prob`` against the integral over the mixing variable s of the
    Gamma's density times the GaussianHMM with every noise precision scaled
    by s (a Riemann sum on a grid of 4001 points in (0, 12])."""
    hmm, data, _, _ = _models("heterogeneous", T, batch=1, hidden=2, obs=1)
    arrays = ex.make_arrays("heterogeneous", 0, T=T, batch=1, hidden=2, obs=1)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in arrays.items()}
    s = torch.linspace(1e-3, 12.0, 4001, dtype=torch.float64)
    r = s.sqrt()[:, None, None]  # the grid as a batch dim, before the time dim of the noise

    def scaled(name, time=True):
        loc, scale = p[f"{name}_loc"], p[f"{name}_scale"] / (r if time else r[:, 0])
        return tdist.Normal(loc, scale).to_event(1)

    ghmm = tdist.GaussianHMM(scaled("init", time=False), p["trans_mat"], scaled("trans"), p["obs_mat"],
                             scaled("obs"), duration=T)
    logps = ghmm.log_prob(p["data"][0]) + tdist.Gamma(p["scale_concentration"], p["scale_rate"]).log_prob(s)
    expected = torch.logsumexp(logps, 0) + math.log(float(s[1] - s[0]))
    _close(hmm.log_prob(data)[0], expected.float(), rtol=0, atol=1e-2)
