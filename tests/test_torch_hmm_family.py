"""The rest of the port's Gaussian HMM family against the JAX package, on
the CPU: ``GaussianHMM.conjugate_update`` and ``prefix_condition``,
``IndependentHMM`` and ``GaussianMRF`` (``distributions/hmm.py``).

Models come from ``examples/gaussian_hmm.py``'s ``make_arrays`` at small
sizes (hidden 3, obs 2, batch 2, T in {7, 13}: odd, and blocks of 8, 4 and
1), the likelihoods and the random fields' factors from numpy seeds; both
packages get the same arrays.  On the CPU the port launches no kernel: each
test checks that the counters stay 0.  ``GaussianMRF`` with time-homogeneous
factors normalises by one step of p(hidden) in the JAX package, where the
port (as the upstream design) takes as many steps as the data has: there
the port is held against a dense float64 oracle and the JAX comparison is a
strict xfail.  Tolerances: float32, log densities rtol 1e-5 with atol 1e-4
(sums of T terms of order 10), means and covariances atol 1e-4; the dense
oracle rtol 1e-5 with atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu_torch.examples import gaussian_hmm as ex
from pyro_tpu_torch.ops import gaussian_levels as gl

SMALL = {"hidden": 3, "obs": 2, "batch": 2}
CASES = [("homogeneous", 13), ("heterogeneous", 7)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    gl.reset_counts()
    yield
    assert not any(gl.launches.values()), f"a kernel was launched on the CPU: {gl.launches}"


def _close(actual, expected, rtol=1e-5, atol=1e-4):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol)


def _models(config, T, **overrides):
    """The port's and the JAX package's GaussianHMM at the same arrays, and
    the data (numpy)."""
    arrays = ex.make_arrays(config, 0, T=T, **{**SMALL, **overrides})
    params = ex.params_from_jax(arrays)
    params.pop("data")
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jhmm = jdist.GaussianHMM(
        jdist.Normal(j["init_loc"], j["init_scale"]).to_event(1), j["trans_mat"],
        jdist.Normal(j["trans_loc"], j["trans_scale"]).to_event(1), j["obs_mat"],
        jdist.Normal(j["obs_loc"], j["obs_scale"]).to_event(1), duration=T,
    )
    return ex.make_hmm(params, T), jhmm, arrays["data"]


def _spd(rng, shape, n):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return (M @ np.swapaxes(M, -1, -2) / n + np.eye(n)).astype(np.float32)


def _mvn_both(rng, batch, n):
    loc = rng.standard_normal(tuple(batch) + (n,)).astype(np.float32)
    cov = _spd(rng, batch, n)
    return (tdist.MultivariateNormal(torch.tensor(loc), covariance_matrix=torch.tensor(cov)),
            jdist.MultivariateNormal(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov)), loc, cov)


# -- conjugate_update -----------------------------------------------------------------


def _likelihood(kind, data_shape, seed):
    """The same likelihood over (T, obs) in both packages, batch ``data_shape[:-2]``."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        loc = rng.standard_normal(data_shape).astype(np.float32)
        scale = (0.5 + rng.random(data_shape)).astype(np.float32)
        return (tdist.Normal(torch.tensor(loc), torch.tensor(scale)).to_event(2),
                jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)).to_event(2))
    t, j, _, _ = _mvn_both(rng, data_shape[:-1], data_shape[-1])
    return t.to_event(1), j.to_event(1)


@pytest.mark.parametrize("kind", ["normal", "mvn"])
@pytest.mark.parametrize("config,T", CASES)
def test_conjugate_update(config, T, kind):
    """``f.log_prob(x) + g.log_prob(x) == fg.log_prob(x) + log_normalizer``,
    and ``log_normalizer`` and ``fg.log_prob`` against the JAX package's."""
    hmm, jhmm, data = _models(config, T)
    data = data.reshape((-1, T, SMALL["obs"]))  # (batch, T, obs) on both configurations
    g, jg = _likelihood(kind, data.shape, 1)
    fg, log_normalizer = hmm.conjugate_update(g)
    assert fg.batch_shape == tuple(log_normalizer.shape) and fg.event_shape == (T, SMALL["obs"])
    x = torch.tensor(data)
    _close(hmm.log_prob(x) + g.log_prob(x), fg.log_prob(x) + log_normalizer, atol=1e-3)

    def ref(x):
        jfg, jlog_normalizer = jhmm.conjugate_update(jg)
        return jfg.log_prob(x), jlog_normalizer

    jlp, jlog_normalizer = jax.jit(ref)(jnp.asarray(data))
    _close(log_normalizer, jlog_normalizer)
    _close(fg.log_prob(x), jlp)
    with pytest.raises(NotImplementedError):
        hmm.mean
    with pytest.raises(ValueError, match="conjugate_update"):
        hmm.conjugate_update(tdist.Gamma(torch.ones(T, SMALL["obs"]), 1.0).to_event(2))


# -- prefix_condition -----------------------------------------------------------------


@pytest.mark.parametrize("config,T", CASES)
@pytest.mark.parametrize("t", [1, 5])
def test_prefix_condition(config, T, t):
    """The posterior predictive model of the last ``T - t`` steps: its
    shapes (as ``tests/test_forecast.py`` checks the JAX package's), its
    ``log_prob`` against the JAX package's, and the chain rule log p(x) =
    log p(x[:t]) + log p(x[t:] | x[:t])."""
    hmm, jhmm, data = _models(config, T)
    data = data.reshape((-1, T, SMALL["obs"]))
    x = torch.tensor(data)
    right = hmm.prefix_condition(x[:, :t])
    assert right.event_shape == (T - t, SMALL["obs"]) and right.duration == T - t
    assert right.batch_shape == (data.shape[0],)
    lp = right.log_prob(x[:, t:])
    jlp = jax.jit(lambda x: jhmm.prefix_condition(x[:, :t]).log_prob(x[:, t:]))(jnp.asarray(data))
    _close(lp, jlp)
    draws = right.rsample(torch.Generator().manual_seed(0), (3,))
    assert draws.shape == (3, data.shape[0], T - t, SMALL["obs"]) and bool(torch.isfinite(right.log_prob(draws)).all())
    left = ex.make_hmm(ex.params_from_jax({k: v[:t] if k == "trans_mat" and v.ndim == 3 else v
                                           for k, v in ex.make_arrays(config, 0, T=T, **SMALL).items()}), t)
    _close(left.log_prob(x[:, :t]) + lp, hmm.log_prob(x), atol=1e-3)


# -- IndependentHMM -------------------------------------------------------------------


def _independent(T, C):
    """``tests/test_hmm.py::test_independent_hmm``'s model in both packages,
    each channel with its own transition matrix and noise."""
    rng = np.random.default_rng(2)
    h = 2
    init_loc = rng.standard_normal((C, h)).astype(np.float32)
    trans_mat = (0.5 * np.eye(h) + 0.1 * rng.standard_normal((C, 1, h, h))).astype(np.float32)
    trans_scale = (0.3 + rng.random((C, 1, h))).astype(np.float32)
    obs_mat = rng.standard_normal((C, 1, h, 1)).astype(np.float32)
    obs_scale = (0.2 + rng.random((C, 1, 1))).astype(np.float32)

    def build(d, tensor):
        base = d.GaussianHMM(
            d.Normal(tensor(init_loc), tensor(np.ones_like(init_loc))).to_event(1), tensor(trans_mat),
            d.Normal(tensor(np.zeros_like(trans_scale)), tensor(trans_scale)).to_event(1), tensor(obs_mat),
            d.Normal(tensor(np.zeros_like(obs_scale)), tensor(obs_scale)).to_event(1), duration=T,
        )
        return d.IndependentHMM(base), base

    return build(tdist, torch.tensor), build(jdist, jnp.asarray)


@pytest.mark.parametrize("T,C", [(5, 3), (13, 1)])
def test_independent_hmm(T, C):
    (t, tbase), (j, _) = _independent(T, C)
    assert t.event_shape == tuple(j.event_shape) == (T, C) and t.batch_shape == tuple(j.batch_shape)
    x = t.rsample(torch.Generator().manual_seed(0))
    assert x.shape == (T, C) and bool(torch.isfinite(x).all())
    assert t.rsample(torch.Generator().manual_seed(0), (4,)).shape == (4, T, C)
    value = np.random.default_rng(3).standard_normal((2, T, C)).astype(np.float32)
    lp = t.log_prob(torch.tensor(value))
    _close(lp, jax.jit(j.log_prob)(jnp.asarray(value)))
    _close(lp, tbase.log_prob(torch.tensor(value).movedim(-1, -2).unsqueeze(-1)).sum(-1))
    big = t.expand((4,))
    assert big.batch_shape == (4,) and big.event_shape == (T, C)
    _close(big.log_prob(torch.tensor(value[0])), lp[0].expand(4))
    with pytest.raises(ValueError):
        tdist.IndependentHMM(ex.make_hmm(ex.params_from_jax(ex.make_arrays("homogeneous", 0, T=T, **SMALL)), T))


# -- GaussianMRF ----------------------------------------------------------------------


def _mrf(T, time_varying, seed=4):
    """A random field with hidden 2, obs 1: MVN factors over z_0, (z, z')
    and (z', y), one per step or shared (batch (1,)), in both packages;
    also the numpy arrays for the dense oracle."""
    rng = np.random.default_rng(seed)
    h, o = 2, 1
    steps = (T,) if time_varying else (1,)
    ti, ji, *init = _mvn_both(rng, (), h)
    tt, jt, *trans = _mvn_both(rng, steps, 2 * h)
    to, jo, *obs = _mvn_both(rng, steps, h + o)
    return (tdist.GaussianMRF(ti, tt, to, duration=T), jdist.GaussianMRF(ji, jt, jo, duration=T),
            (init, trans, obs, h, o))


def _mrf_dense_log_prob(arrays, T, value):
    """log p(y) of the field in float64: the joint of (z_0..z_T, y_1..y_T) in
    information form from every factor's density, conditioned on y and
    integrated over z, less the same integrated over z and y."""
    (mu0, cov0), (mu_t, cov_t), (mu_o, cov_o), h, o = arrays
    N = (T + 1) * h + T * o
    J, hv, c = np.zeros((N, N)), np.zeros(N), 0.0

    def add(idx, mu, cov):
        nonlocal c
        P = np.linalg.inv(cov.astype(np.float64))
        mu = mu.astype(np.float64)
        J[np.ix_(idx, idx)] += P
        hv[idx] += P @ mu
        c += -0.5 * len(idx) * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(cov.astype(np.float64))[1] - 0.5 * mu @ P @ mu

    z = lambda t: list(range(t * h, (t + 1) * h))  # noqa: E731
    y = lambda t: list(range((T + 1) * h + (t - 1) * o, (T + 1) * h + t * o))  # noqa: E731
    add(z(0), mu0, cov0)
    for t in range(1, T + 1):
        k = t - 1 if mu_t.shape[0] == T else 0
        add(z(t - 1) + z(t), mu_t[k], cov_t[k])
        add(z(t) + y(t), mu_o[k], cov_o[k])

    def log_integral(J, hv, c):
        return c + 0.5 * len(hv) * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(J)[1] + 0.5 * hv @ np.linalg.solve(J, hv)

    zi, yi = list(range((T + 1) * h)), list(range((T + 1) * h, N))
    out = []
    for v in value.reshape(-1, T * o).astype(np.float64):
        Jc = J[np.ix_(zi, zi)]
        hc = hv[zi] - J[np.ix_(zi, yi)] @ v
        cc = c + hv[yi] @ v - 0.5 * v @ J[np.ix_(yi, yi)] @ v
        out.append(log_integral(Jc, hc, cc) - log_integral(J, hv, c))
    return np.array(out).reshape(value.shape[:-2])


@pytest.mark.parametrize("time_varying", [True, False])
def test_gaussian_mrf_against_dense(time_varying):
    T = 7
    t, _, arrays = _mrf(T, time_varying)
    assert t.event_shape == (T, 1)
    value = np.random.default_rng(5).standard_normal((2, T, 1)).astype(np.float32)
    _close(t.log_prob(torch.tensor(value)), _mrf_dense_log_prob(arrays, T, value), atol=1e-3)


@pytest.mark.parametrize("time_varying", [
    True,
    pytest.param(False, marks=pytest.mark.xfail(strict=True, reason=(
        "the JAX GaussianMRF contracts p(hidden) over its factors' own time axis, one step where they are "
        "homogeneous (pyro_tpu/distributions/hmm.py:831-840); ROADMAP.md Queue 3"))),
])
@pytest.mark.parametrize("T", [7, 13])
def test_gaussian_mrf_matches_jax(T, time_varying):
    t, j, _ = _mrf(T, time_varying)
    value = np.random.default_rng(6).standard_normal((2, T, 1)).astype(np.float32)
    _close(t.log_prob(torch.tensor(value)), jax.jit(j.log_prob)(jnp.asarray(value)))
