"""The port's ``GaussianHMM`` (``distributions/hmm.py``, built by
``examples/gaussian_hmm.py``) against the JAX package's, on the CPU.

Both packages' models are built from the same numpy arrays
(``make_arrays``, seed 0) at small sizes: hidden 3, obs 2, T=13 (odd,
blocks of 8, 4 and 1) for the homogeneous configuration with 2 sequences,
T=11 for the heterogeneous one (a transition matrix per step; odd
levels).  ``log_prob`` and ``filter`` go against the JAX ones, and
``log_prob`` against the dense multivariate normal of the whole
observation sequence (``tests/test_hmm.py``'s oracle).  The posterior
draws of ``rsample_posterior`` come from other generators in the two
packages, so their means over 2000 draws go against the exact posterior
mean (the general sampler at zero noise, itself held against the JAX
sampler in ``tests/test_torch_gaussian.py``), within 5 standard errors.
Tolerances: log densities rtol 1e-5 with atol 1e-4 (float32 sums of T
terms of order 10); filter means and covariances atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
from pyro_tpu_torch.examples import gaussian_hmm as ex
from pyro_tpu_torch.ops import gaussian as tg

SMALL = {"hidden": 3, "obs": 2, "batch": 2}
CASES = [("homogeneous", 13), ("heterogeneous", 11)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _models(config, T):
    arrays = ex.make_arrays(config, 0, T=T, **SMALL)
    params = ex.params_from_jax(arrays)
    data = params.pop("data")
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jhmm = jdist.GaussianHMM(
        jdist.Normal(j["init_loc"], j["init_scale"]).to_event(1), j["trans_mat"],
        jdist.Normal(j["trans_loc"], j["trans_scale"]).to_event(1), j["obs_mat"],
        jdist.Normal(j["obs_loc"], j["obs_scale"]).to_event(1), duration=T,
    )
    return ex.make_hmm(params, T), data, jhmm, j["data"], arrays


@pytest.mark.parametrize("config,T", CASES)
def test_log_prob_and_filter_match_jax(config, T):
    hmm, data, jhmm, jdata, _ = _models(config, T)
    lp = hmm.log_prob(data)
    jlp, jloc, jcov = jax.jit(lambda x: (jhmm.log_prob(x), jhmm.filter(x).loc, jhmm.filter(x).covariance_matrix))(jdata)
    assert lp.shape == jlp.shape
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
    post = hmm.filter(data)
    np.testing.assert_allclose(post.loc.numpy(), np.asarray(jloc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(post.covariance_matrix.numpy(), np.asarray(jcov), rtol=0, atol=1e-4)


def _dense_log_prob(arrays, T):
    """log p(y_1..T) of the model as one multivariate normal (float64):
    z_t = z_t-1 A_t + w, y_t = z_t H + v, with the row-vector convention."""
    h, o = arrays["obs_mat"].shape
    A = np.broadcast_to(arrays["trans_mat"].astype(np.float64), (T, h, h))
    H = arrays["obs_mat"].astype(np.float64)
    Q, R = np.diag(arrays["trans_scale"] ** 2.0), np.diag(arrays["obs_scale"] ** 2.0)
    # z_t = sum_s z_0 (A_1..A_t) + sum_s w_s (A_s+1..A_t): cov by blocks
    M = [np.eye(h)]  # M[t] = A_1 ... A_t
    for t in range(T):
        M.append(M[-1] @ A[t])
    Z = np.zeros(((T + 1) * h, (T + 1) * h))
    cov0 = np.diag(arrays["init_scale"] ** 2.0)
    for i in range(T + 1):
        for k in range(T + 1):
            c = M[i].T @ cov0 @ M[k]
            for s in range(1, min(i, k) + 1):
                Mi = np.eye(h)
                for t in range(s, i):
                    Mi = Mi @ A[t]
                Mk = np.eye(h)
                for t in range(s, k):
                    Mk = Mk @ A[t]
                c = c + Mi.T @ Q @ Mk
            Z[i * h:(i + 1) * h, k * h:(k + 1) * h] = c
    Zy = Z[h:, h:]
    Hbig = np.kron(np.eye(T), H.T)
    ycov = Hbig @ Zy @ Hbig.T + np.kron(np.eye(T), R)
    data = arrays["data"].reshape(-1, T * o).astype(np.float64)
    return multivariate_normal.logpdf(data, np.zeros(T * o), ycov)


@pytest.mark.parametrize("config,T", [("homogeneous", 5), ("heterogeneous", 6)])
def test_log_prob_matches_dense_mvn(config, T):
    hmm, data, _, _, arrays = _models(config, T)
    expected = _dense_log_prob(arrays, T)
    np.testing.assert_allclose(hmm.log_prob(data).numpy().reshape(-1), np.reshape(expected, -1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("config,T", CASES)
def test_rsample_posterior_mean(config, T):
    """Means of 2000 draws (port and JAX) against the exact posterior mean;
    the draws' shape is ``sample_shape + batch + (T, hidden)``."""
    hmm, data, jhmm, jdata, _ = _models(config, T)
    draws = 2000
    z = hmm.rsample_posterior(data, torch.Generator().manual_seed(0), (draws,))
    jz = jax.jit(lambda x: jhmm.rsample_posterior(x, jax.random.key(0), (draws,)))(jdata)
    assert z.shape == tuple(jz.shape) == (draws,) + tuple(data.shape[:-1]) + (SMALL["hidden"],)
    trans = hmm._conditioned(data)
    trans = trans.expand(trans.batch_shape)
    zeros = torch.zeros(trans.batch_shape[:-1] + (T + 1, SMALL["hidden"]))
    mean = tg.sequential_gaussian_filter_sample(hmm._init, trans, noise=zeros)[..., 1:, :].numpy()
    for draw in (z.numpy(), np.asarray(jz)):
        se = draw.std(0) / np.sqrt(draws)
        assert np.all(np.abs(draw.mean(0) - mean) < 5 * se + 1e-5)


def test_rsample_shapes_and_expand():
    hmm, data, _, _, _ = _models("homogeneous", 9)
    x = hmm.rsample(torch.Generator().manual_seed(0), (4,))
    assert x.shape == (4, 9, SMALL["obs"]) and torch.isfinite(x).all()
    big = hmm.expand((3,))
    assert big.batch_shape == (3,) and big.event_shape == (9, SMALL["obs"])
    assert big.log_prob(data[0]).shape == (3,)
    np.testing.assert_allclose(big.log_prob(data[0]).numpy(), hmm.log_prob(data[0]).expand(3).numpy(), rtol=1e-6)
    het, hdata, _, _, _ = _models("heterogeneous", 7)
    assert het.rsample(torch.Generator().manual_seed(0), (2,)).shape == (2, 7, SMALL["obs"])
    with pytest.raises(ValueError):
        hmm.log_prob(data[..., :1])
    with pytest.raises(ValueError):
        hmm.log_prob(data[:, :5])
    with pytest.raises(ValueError):
        hmm.log_prob(data[0, 0])
