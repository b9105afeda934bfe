"""The port's information-form Gaussian algebra (``ops/gaussian.py``), its
K4 halving levels' plain versions (``ops/gaussian_levels.py``) and
``MultivariateNormal`` against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed at small sizes (state dim n <= 4,
T <= 33, odd and not a power of two among them) and go through both
packages.  The general sampler takes the same standard white noise in
both; the homogeneous one takes no noise in the JAX package, so the port's
is held by its posterior mean (zero noise) and covariance (its Jacobian
with respect to the noise, the draw being linear in it) against the
general sampler's and against the dense joint over every state, and the
sequential oracle's draws by their mean against the dense one.
Tolerances: float32 throughout, rtol 1e-4 with atol 1e-4 (the factors are
of order 1 to 10, summed in another order than XLA sums them, and
Cholesky-factorised by another algorithm); sample means of the oracle
within 5 standard errors.
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
from pyro_tpu.ops import gaussian as jg
from pyro_tpu.ops import linalg_small as jlinalg
from pyro_tpu_torch.ops import gaussian as tg
from pyro_tpu_torch.ops import gaussian_levels as gl

RTOL = ATOL = 1e-4


def _jit(fn, *args):
    """``fn(*args)`` of the JAX package, compiled whole: its eager ops
    would each compile on their own."""
    return jax.jit(fn)(*args)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _close(actual, expected, rtol=RTOL, atol=ATOL):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol)


def _close_g(t, j):
    _close(t.log_normalizer, j.log_normalizer)
    _close(t.info_vec, j.info_vec)
    _close(t.precision, j.precision)


def _spd(rng, shape, n, jitter=1.0):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return (M @ np.swapaxes(M, -1, -2) / n + jitter * np.eye(n)).astype(np.float32)


def _arrays(seed, batch, n, shared_precision=False):
    rng = np.random.default_rng(seed)
    P = _spd(rng, () if shared_precision else batch, n)
    return (
        rng.standard_normal(batch).astype(np.float32),
        rng.standard_normal(tuple(batch) + (n,)).astype(np.float32),
        P,
    )


def _both(logZ, info, P):
    return (
        tg.Gaussian(torch.tensor(logZ), torch.tensor(info), torch.tensor(P)),
        jg.Gaussian(jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(P)),
    )


# -- Gaussian methods ---------------------------------------------------------------


def test_gaussian_shape_methods():
    t, j = _both(*_arrays(0, (3, 1), 4))
    assert t.dim == j.dim and t.batch_shape == tuple(j.batch_shape)
    _close_g(t.expand((2, 3, 5)), j.expand((2, 3, 5)))
    _close_g(t.expand((3, 2)).reshape((6,)), j.expand((3, 2)).reshape((6,)))
    _close_g(t[1], j[1])
    _close_g(t[:, 0], j[:, 0])
    _close_g(tg.Gaussian.cat([t, t[:2]], dim=0), jg.Gaussian.cat([j, j[:2]], dim=0))
    _close_g(tg.Gaussian.cat([t, t], dim=-1), jg.Gaussian.cat([j, j], dim=-1))
    _close_g(t.event_pad(left=2, right=1), j.event_pad(left=2, right=1))
    _close_g(t.event_permute([2, 0, 3, 1]), j.event_permute(jnp.array([2, 0, 3, 1])))


def test_gaussian_arithmetic_and_density():
    t, j = _both(*_arrays(1, (3,), 4))
    t2, j2 = _both(*_arrays(2, (3,), 4))
    _close_g(t + t2, j + j2)
    _close_g(t + 1.5, j + 1.5)
    _close_g(t - 0.5, j - 0.5)
    x = np.random.default_rng(3).standard_normal((5, 3, 4)).astype(np.float32)
    _close(t.log_density(torch.tensor(x)), j.log_density(jnp.asarray(x)))


@pytest.mark.parametrize("nb", [1, 3])
def test_gaussian_condition(nb):
    t, j = _both(*_arrays(4, (2, 3), 5))
    v = np.random.default_rng(5).standard_normal((2, 3, nb)).astype(np.float32)
    _close_g(t.condition(torch.tensor(v)), j.condition(jnp.asarray(v)))
    _close_g(t.left_condition(torch.tensor(v)), j.left_condition(jnp.asarray(v)))


@pytest.mark.parametrize("left,right", [(0, 0), (2, 0), (0, 3), (1, 2)])
def test_gaussian_marginalize(left, right):
    t, j = _both(*_arrays(6, (4,), 6))
    _close_g(t.marginalize(left=left, right=right), _jit(lambda g: g.marginalize(left=left, right=right), j))


def test_gaussian_event_logsumexp_rsample_to_mvn():
    t, j = _both(*_arrays(7, (3,), 4))
    _close(t.event_logsumexp(), _jit(lambda g: g.event_logsumexp(), j))
    noise = np.random.default_rng(8).standard_normal((2, 3, 4)).astype(np.float32)
    _close(t.rsample(sample_shape=(2,), noise=torch.tensor(noise)),
           _jit(lambda g, e: g.rsample(None, (2,), noise=e), j, jnp.asarray(noise)))
    draw = t.rsample(torch.Generator().manual_seed(0), (7,))
    assert draw.shape == (7, 3, 4) and torch.isfinite(draw).all()
    tm = t.to_mvn()
    jloc, jcov = _jit(lambda g: (g.to_mvn().loc, g.to_mvn().covariance_matrix), j)
    _close(tm.loc, jloc)
    _close(tm.covariance_matrix, jcov)


# -- MultivariateNormal and the converters ------------------------------------------


@pytest.mark.parametrize("param", ["scale_tril", "covariance_matrix", "precision_matrix"])
def test_multivariate_normal(param):
    rng = np.random.default_rng(9)
    loc = rng.standard_normal((2, 3)).astype(np.float32)
    cov = _spd(rng, (2,), 3)
    mat = {"scale_tril": np.linalg.cholesky(cov), "covariance_matrix": cov,
           "precision_matrix": np.linalg.inv(cov)}[param].astype(np.float32)
    t = tdist.MultivariateNormal(torch.tensor(loc), **{param: torch.tensor(mat)})
    j = jdist.MultivariateNormal(jnp.asarray(loc), **{param: jnp.asarray(mat)})
    assert t.batch_shape == (2,) and t.event_shape == (3,)
    x = rng.standard_normal((4, 2, 3)).astype(np.float32)
    _close(t.log_prob(torch.tensor(x)), j.log_prob(jnp.asarray(x)))
    for name in ("scale_tril", "covariance_matrix", "precision_matrix", "mean", "variance"):
        _close(getattr(t, name), getattr(j, name), rtol=1e-3, atol=1e-4)
    _close(t.expand((5, 2)).log_prob(torch.tensor(x[:1])), j.expand((5, 2)).log_prob(jnp.asarray(x[:1])))
    draws = t.rsample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000, 2, 3)
    se = np.sqrt(np.diagonal(cov, axis1=-2, axis2=-1) / 4000)
    assert np.all(np.abs(draws.mean(0).numpy() - loc) < 5 * se)


def test_mvn_to_gaussian():
    rng = np.random.default_rng(10)
    loc = rng.standard_normal((2, 3)).astype(np.float32)
    scale = (0.5 + rng.random((2, 3))).astype(np.float32)
    _close_g(tg.mvn_to_gaussian(tdist.Normal(torch.tensor(loc), torch.tensor(scale)).to_event(1)),
             jg.mvn_to_gaussian(jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)).to_event(1)))
    tril = np.linalg.cholesky(_spd(rng, (2,), 3)).astype(np.float32)
    _close_g(tg.mvn_to_gaussian(tdist.MultivariateNormal(torch.tensor(loc), scale_tril=torch.tensor(tril))),
             jg.mvn_to_gaussian(jdist.MultivariateNormal(jnp.asarray(loc), scale_tril=jnp.asarray(tril))))


@pytest.mark.parametrize("mat_batch", [(), (5,)])
def test_matrix_and_mvn_to_gaussian(mat_batch):
    rng = np.random.default_rng(11)
    mat = rng.standard_normal(mat_batch + (3, 2)).astype(np.float32)
    loc = rng.standard_normal(2).astype(np.float32)
    scale = (0.5 + rng.random(2)).astype(np.float32)
    _close_g(
        tg.matrix_and_mvn_to_gaussian(torch.tensor(mat), tdist.Normal(torch.tensor(loc), torch.tensor(scale)).to_event(1)),
        jg.matrix_and_mvn_to_gaussian(jnp.asarray(mat), jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)).to_event(1)),
    )


@pytest.mark.parametrize("dims", [0, 2])
def test_gaussian_tensordot(dims):
    t1, j1 = _both(*_arrays(12, (3,), 4))
    t2, j2 = _both(*_arrays(13, (3,), 5))
    _close_g(tg.gaussian_tensordot(t1, t2, dims), _jit(lambda x, y: jg.gaussian_tensordot(x, y, dims), j1, j2))


# -- K4's plain versions against the JAX level code ----------------------------------


def _chain(seed, batch, T, n, shared_precision):
    """A chain of T factors over (z_t, z_t+1): batch + (T,) of dim 2n."""
    return _arrays(seed, tuple(batch) + (T,), 2 * n, shared_precision)


def test_halving_level_plain_matches_jax():
    """K4a: one level, as the JAX homogeneous contraction of chains of two
    factors (one block, one level), each pair a batch item."""
    R, m, n = 2, 3, 3
    logZ, info, P = _chain(14, (R, m), 2, n, shared_precision=True)
    P_new, info_new, logZ_new, L, ib = gl.halving_level_plain(
        torch.tensor(P), torch.tensor(info.reshape(R, 2 * m, 2 * n)), torch.tensor(logZ.reshape(R, 2 * m)), tape=True)
    ref = _jit(jg.sequential_gaussian_tensordot_homogeneous,
               jg.Gaussian(jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(P)))
    _close(P_new, ref.precision)
    _close(info_new, ref.info_vec)
    _close(logZ_new, ref.log_normalizer)
    _close(L, jlinalg.cholesky(jnp.asarray(P[n:, n:] + P[:n, :n])))
    _close(ib, info[..., 0, n:] + info[..., 1, :n])


@pytest.mark.parametrize("T", [2, 7])
def test_contract_pairs_plain_matches_jax(T):
    """K4b: each pair against ``gaussian_tensordot(x, y, n)``, the odd
    level's last factor carried; the tape against the joint's blocks."""
    n = 3
    logZ, info, P = _chain(15, (2,), T, n, shared_precision=False)
    P_new, info_new, logZ_new, (L, P_mk, i_m) = gl.contract_pairs_plain(
        torch.tensor(P), torch.tensor(info), torch.tensor(logZ), tape=True)
    e = T // 2 * 2
    x = jg.Gaussian(jnp.asarray(logZ[:, 0:e:2]), jnp.asarray(info[:, 0:e:2]), jnp.asarray(P[:, 0:e:2]))
    y = jg.Gaussian(jnp.asarray(logZ[:, 1:e:2]), jnp.asarray(info[:, 1:e:2]), jnp.asarray(P[:, 1:e:2]))
    ref = _jit(lambda x, y: jg.gaussian_tensordot(x, y, n), x, y)
    if T > e:
        ref = jg.Gaussian.cat([ref, jg.Gaussian(jnp.asarray(logZ[:, e:]), jnp.asarray(info[:, e:]),
                                                jnp.asarray(P[:, e:]))], dim=-1)
    _close(P_new, ref.precision)
    _close(info_new, ref.info_vec)
    _close(logZ_new, ref.log_normalizer)
    Px, Py = P[:, 0:e:2], P[:, 1:e:2]
    _close(L, jlinalg.cholesky(jnp.asarray(Px[..., n:, n:] + Py[..., :n, :n])))
    _close(P_mk, np.concatenate([np.swapaxes(Px[..., :n, n:], -1, -2), Py[..., :n, n:]], -1))
    _close(i_m, info[:, 0:e:2, n:] + info[:, 1:e:2, :n])


@pytest.mark.parametrize("shared", [True, False])
def test_level_mids_plain_matches_jax(shared):
    """K4c: info_c = i_m - P_mk (l, r), mid = L^-T (L^-1 info_c + eps),
    against the JAX descent's arithmetic (``cholesky_solve`` plus
    ``solve_lower_t`` of the noise), the mids interleaved, the tail kept."""
    rng = np.random.default_rng(16)
    D, R, m, Np, n = 2, 3, 6, 4, 3  # an odd level: two points carried
    L = np.linalg.cholesky(_spd(rng, () if shared else (R, Np), n)).astype(np.float32)
    P_mk = rng.standard_normal((() if shared else (R, Np)) + (n, 2 * n)).astype(np.float32)
    i_m = rng.standard_normal((R, Np, n)).astype(np.float32)
    cur = rng.standard_normal((D, R, m, n)).astype(np.float32)
    eps = rng.standard_normal((D, R, Np, n)).astype(np.float32)
    out = gl.level_mids_plain(*(torch.tensor(a) for a in (cur, L, P_mk, i_m, eps)))
    cond = np.concatenate([cur[..., :Np, :], cur[..., 1:Np + 1, :]], -1)
    info_c = i_m - np.einsum("...ij,...j->...i", P_mk, cond)
    Lb = jnp.broadcast_to(jnp.asarray(L), (D, R, Np, n, n))
    mids = (jlinalg.cholesky_solve(Lb, jnp.asarray(info_c)[..., None])
            + jlinalg.solve_lower_t(Lb, jnp.asarray(eps)[..., None]))[..., 0]
    _close(out[..., 0:2 * Np:2, :], cur[..., :Np, :])
    _close(out[..., 1:2 * Np:2, :], mids)
    _close(out[..., 2 * Np:, :], cur[..., Np:, :])


# -- the four time contractions -----------------------------------------------------


@pytest.mark.parametrize("T", [1, 13, 33])
def test_sequential_tensordot_homogeneous(T):
    """Blocks of 8, 4 and 1 at T=13, of 32 and 1 at T=33."""
    logZ, info, P = _chain(17, (2,), T, 2, shared_precision=True)
    t, j = _both(logZ, info, P)
    _close_g(tg.sequential_gaussian_tensordot_homogeneous(t), _jit(jg.sequential_gaussian_tensordot_homogeneous, j))


@pytest.mark.parametrize("T", [7, 33])
def test_sequential_tensordot(T):
    t, j = _both(*_chain(18, (2,), T, 2, shared_precision=False))
    _close_g(tg.sequential_gaussian_tensordot(t), _jit(jg.sequential_gaussian_tensordot, j))


def _init_gaussian(seed, batch, n):
    logZ, info, P = _arrays(seed, batch, n)
    return _both(logZ, info, P)


@pytest.mark.parametrize("T,batch,sample_shape", [(1, (), (2,)), (6, (2,), ()), (13, (), (3,)), (33, (2,), (2,))])
def test_filter_sample_same_noise(T, batch, sample_shape):
    """The general sampler against the JAX one at the same white noise."""
    n = 2
    ti, ji = _init_gaussian(19, batch, n)
    tt, jt = _both(*_chain(20, batch, T, n, shared_precision=False))
    noise = np.random.default_rng(21).standard_normal(tuple(sample_shape) + batch + (T + 1, n)).astype(np.float32)
    out = tg.sequential_gaussian_filter_sample(ti, tt, sample_shape, noise=torch.tensor(noise))
    ref = _jit(lambda i, t, e: jg.sequential_gaussian_filter_sample(i, t, sample_shape, noise=e), ji, jt,
               jnp.asarray(noise))
    _close(out, ref, rtol=1e-3, atol=1e-3)


def _dense_posterior(init, trans):
    """Mean and covariance of every state z_0..z_T of the chain, from the
    dense joint precision (float64 numpy); batch ()."""
    n = init.dim
    T = trans.batch_shape[-1]
    N = (T + 1) * n
    Pj, ij = np.zeros((N, N)), np.zeros(N)
    Pj[:n, :n] += init.precision.double().numpy()
    ij[:n] += init.info_vec.double().numpy()
    trans = trans.expand((T,))
    for t in range(T):
        s = slice(t * n, (t + 2) * n)
        Pj[s, s] += trans.precision[t].double().numpy()
        ij[s] += trans.info_vec[t].double().numpy()
    cov = np.linalg.inv(Pj)
    return cov @ ij, cov


def _mean_and_cov(sampler, init, trans, T, n):
    """The draw at zero noise and, the draw being linear in the noise, the
    covariance J J^T of its Jacobian J."""
    zeros = torch.zeros(T + 1, n)
    mean = sampler(init, trans, noise=zeros).reshape(-1)
    J = torch.autograd.functional.jacobian(lambda e: sampler(init, trans, noise=e).reshape(-1), zeros)
    J = J.reshape(mean.shape[0], -1).double()
    return mean.double().numpy(), (J @ J.T).numpy()


@pytest.mark.parametrize("T", [1, 6, 13])
def test_homogeneous_filter_sample_moments(T):
    """The homogeneous sampler's posterior mean and covariance against the
    general sampler's and the dense joint's."""
    n = 2
    ti, _ = _init_gaussian(22, (), n)
    logZ, info, P = _chain(23, (), T, n, shared_precision=True)
    trans = tg.Gaussian(torch.tensor(logZ), torch.tensor(info), torch.tensor(P))
    mean_h, cov_h = _mean_and_cov(tg.sequential_gaussian_filter_sample_homogeneous, ti, trans, T, n)
    mean_g, cov_g = _mean_and_cov(tg.sequential_gaussian_filter_sample, ti, trans.expand((T,)), T, n)
    mean_d, cov_d = _dense_posterior(ti, trans)
    np.testing.assert_allclose(mean_h, mean_g, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cov_h, cov_g, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mean_h, mean_d, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cov_h, cov_d, rtol=1e-3, atol=1e-4)


def test_homogeneous_filter_sample_draws():
    """Draws from a generator, batched: the same as the draws from the
    noise that generator gives in the documented order (the 3 junctions of
    blocks 8 and 1, then the levels' 1, 2 and 4 midpoints from the top)."""
    n, T = 2, 9
    ti, _ = _init_gaussian(24, (3,), n)
    logZ, info, P = _chain(25, (3,), T, n, shared_precision=True)
    trans = tg.Gaussian(torch.tensor(logZ), torch.tensor(info), torch.tensor(P))
    z = tg.sequential_gaussian_filter_sample_homogeneous(ti, trans, (4,), torch.Generator().manual_seed(0))
    assert z.shape == (4, 3, T + 1, n) and torch.isfinite(z).all()
    gen = torch.Generator().manual_seed(0)
    noise = torch.cat([torch.randn((4, 3, k, n), generator=gen) for k in (1, 1, 1, 1, 2, 4)], dim=-2)
    _close(z, tg.sequential_gaussian_filter_sample_homogeneous(ti, trans, (4,), noise=noise), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T", [5, 12])
def test_sequential_oracle_matches_dense_posterior(T):
    """The O(T) oracle's draws (port and JAX) against the dense posterior
    mean, within 5 standard errors."""
    n, draws = 2, 4000
    ti, ji = _init_gaussian(26, (), n)
    tt, jt = _both(*_chain(27, (), T, n, shared_precision=False))
    mean_d, cov_d = _dense_posterior(ti, tt)
    se = np.sqrt(np.diagonal(cov_d) / draws)
    z = tg.sequential_gaussian_filter_sample_sequential(ti, tt, (draws,), torch.Generator().manual_seed(0))
    jz = _jit(lambda i, t: jg.sequential_gaussian_filter_sample_sequential(i, t, (draws,), jax.random.key(0)), ji, jt)
    for draw in (z.double().numpy(), np.asarray(jz, np.float64)):
        assert draw.shape == (draws, T + 1, n)
        assert np.all(np.abs(draw.reshape(draws, -1).mean(0) - mean_d) < 5 * se)
