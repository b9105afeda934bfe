"""The port's MCMC slice against the JAX package, on the CPU: the
eight-schools potential, the integrators, dual averaging, Welford's
variance, the warmup schedule, the chain statistics, the NUTS subtree
builder (the port's batch of chains against the JAX builder on each
chain), and NUTS posteriors against quadrature and a conjugate model.

Tolerances: potential, gradient and integrators rtol 1e-5; dual averaging
and Welford rtol 1e-6; the warmup schedule exact; statistics rtol 1e-4;
the subtree's fields per chain rtol 1e-5 with atol 1e-5 * the chain's
max|field|, its log weight and accept sum with atol 1e-6 * |initial
energy| (both are sums over leaves of energy differences, and float32
rounds an energy E at 6e-8 |E|), flags and counts exact.  Posterior means within 4 Monte Carlo
standard errors (sd / sqrt(ESS), by the port's own ESS) plus 0.01.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.eight_schools as jes
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu.infer.mcmc import HMC as JHMC
from pyro_tpu.infer.mcmc import MCMC as JMCMC
from pyro_tpu.infer.mcmc import NUTS as JNUTS
from pyro_tpu.infer.mcmc import hmc as jhmc
from pyro_tpu.infer.mcmc import nuts as jnuts
from pyro_tpu.infer.mcmc.util import initialize_model as jinitialize_model
from pyro_tpu.ops import dual_averaging as jda
from pyro_tpu.ops import integrator as jintegrator
from pyro_tpu.ops import stats as jstats
from pyro_tpu.ops import welford as jwelford
from pyro_tpu_torch.examples import eight_schools as tes
from pyro_tpu_torch.infer import HMC, MCMC, NUTS
from pyro_tpu_torch.infer.mcmc import hmc as thmc
from pyro_tpu_torch.infer.mcmc import nuts as tnuts
from pyro_tpu_torch.infer.mcmc.util import initialize_model
from pyro_tpu_torch.ops import dual_averaging as tda
from pyro_tpu_torch.ops import integrator as tintegrator
from pyro_tpu_torch.ops import stats as tstats
from pyro_tpu_torch.ops import welford as twelford

D = 10  # eight schools: eta (8), mu, tau
RNG = np.random.default_rng(3)
Z16 = RNG.uniform(-2, 2, (16, D)).astype(np.float32)
# the 2-D quadrature of the eight-schools posterior (eta integrated out)
MU_MEAN, TAU_MEAN = 4.398, 3.580


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield


def _close(actual, expected, rtol, atol_scale=0.0):
    expected = np.asarray(expected)
    atol = atol_scale * (np.abs(expected[np.isfinite(expected)]).max() if np.isfinite(expected).any() else 0.0)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def kernels():
    """Both packages' NUTS, set up on eight schools."""
    jk = JNUTS(jes.model)
    jk.setup(0, jes.Y, jes.SIGMA, rng_key=jax.random.key(0))
    pyro.set_default_device("cpu")
    tk = NUTS(tes.model)
    tk.setup(0, *tes.data(), generator=torch.Generator().manual_seed(0))
    return jk, tk


def _jax_pe_grad(jk, z):
    pe, grad = jax.vmap(jax.value_and_grad(jk.potential_fn))(jnp.asarray(z))
    return np.asarray(pe), np.asarray(grad)


# -- the potential ------------------------------------------------------------


def test_ravel_order_matches_jax(kernels):
    jk, tk = kernels
    flat = np.arange(D, dtype=np.float32)
    expected = {k: np.asarray(v) for k, v in jk._unravel(jnp.asarray(flat)).items()}
    actual = {k: v.numpy() for k, v in tk._unravel(torch.tensor(flat)).items()}
    assert sorted(actual) == sorted(expected) == ["eta", "mu", "tau"]
    for name in expected:
        np.testing.assert_array_equal(actual[name], expected[name])


def test_potential_and_gradient_match_jax(kernels):
    jk, tk = kernels
    pe, grad = _jax_pe_grad(jk, Z16)
    t_pe, t_grad = tk._potential_and_grad(torch.tensor(Z16))
    _close(t_pe.numpy(), pe, 1e-5)
    _close(t_grad.numpy(), grad, 1e-5)


def test_postprocess_returns_constrained_and_deterministic_sites(kernels):
    jk, tk = kernels
    z = Z16[0]
    expected = jk.postprocess_fn(jk._unravel(jnp.asarray(z)))
    actual = tk.postprocess_fn(tk._unravel(torch.tensor(z)))
    assert sorted(actual) == sorted(expected) == ["eta", "mu", "tau", "theta"]
    for name in expected:
        _close(actual[name].numpy(), expected[name], 1e-6)


# -- integrators ----------------------------------------------------------------

STEP, INV_MASS = 0.05, RNG.uniform(0.5, 2.0, (16, D)).astype(np.float32)
R16 = RNG.standard_normal((16, D)).astype(np.float32)


def test_leapfrog_matches_jax_over_10_steps(kernels):
    jk, tk = kernels
    pe, grad = _jax_pe_grad(jk, Z16)

    def jax_chain(z, r, g, inv):
        out = (z, r, 0.0, g)
        for _ in range(10):
            out = jhmc._leapfrog(out[0], out[1], out[3], STEP, inv, jk.potential_fn)
        return out

    expected = jax.vmap(jax_chain)(jnp.asarray(Z16), jnp.asarray(R16), jnp.asarray(grad), jnp.asarray(INV_MASS))
    out = (torch.tensor(Z16), torch.tensor(R16), None, torch.tensor(grad))
    for _ in range(10):
        out = thmc._leapfrog(out[0], out[1], out[3], STEP, torch.tensor(INV_MASS), tk._potential_and_grad)
    for a, e in zip(out, expected):
        _close(a.numpy(), e, 1e-5)


def test_velocity_verlet_matches_jax_over_10_steps():
    jinfo = jinitialize_model(jes.model, (jes.Y, jes.SIGMA), rng_key=jax.random.key(0))
    tinfo = initialize_model(tes.model, tes.data(), generator=torch.Generator().manual_seed(0))
    z = {"eta": Z16[0, :8], "mu": Z16[0, 8], "tau": Z16[0, 9]}
    r = {"eta": R16[0, :8], "mu": R16[0, 8], "tau": R16[0, 9]}
    inv = {"eta": INV_MASS[0, :8], "mu": INV_MASS[0, 8], "tau": INV_MASS[0, 9]}

    def run(integrator, potential_fn, a):
        kinetic_grad = lambda r: {k: a(inv[k]) * r[k] for k in r}  # noqa: E731
        return integrator.velocity_verlet(
            {k: a(v) for k, v in z.items()}, {k: a(v) for k, v in r.items()}, potential_fn, kinetic_grad, STEP,
            num_steps=10,
        )

    expected = run(jintegrator, jinfo.potential_fn, jnp.asarray)
    actual = run(tintegrator, tinfo.potential_fn, torch.tensor)
    for a, e in zip(actual[:3], expected[:3]):
        for name in e:
            _close(a[name].numpy(), e[name], 1e-5)
    _close(float(actual[3]), float(expected[3]), 1e-5)


# -- adaptation ---------------------------------------------------------------

G_SEQ = RNG.normal(0.0, 0.3, (50, 3)).astype(np.float32)
X_SEQ = RNG.normal(1.0, 2.0, (30, 3, 5)).astype(np.float32)


def test_dual_averaging_matches_jax():
    prox = np.array([0.1, -1.0, 2.0], np.float32)
    t_state = tda.da_init(torch.tensor(prox))
    for g in G_SEQ:
        t_state = tda.da_step(t_state, torch.tensor(g))
    for c in range(3):
        j_state = jda.da_init(prox[c])
        for g in G_SEQ[:, c]:
            j_state = jda.da_step(j_state, g)
        for a, e in zip(t_state, j_state):
            _close(a[c].numpy(), e, 1e-6)


@pytest.mark.parametrize("regularize", [True, False])
def test_welford_matches_jax(regularize):
    t_state = twelford.welford_init(5, batch_shape=(3,))
    for x in X_SEQ:
        t_state = twelford.welford_update(t_state, torch.tensor(x))
    cov = twelford.welford_covariance(t_state, regularize)
    for c in range(3):
        j_state = jwelford.welford_init(5)
        for x in X_SEQ[:, c]:
            j_state = jwelford.welford_update(j_state, jnp.asarray(x))
        for a, e in zip(t_state, j_state):
            _close(a[c].numpy(), e, 1e-6)
        _close(cov[c].numpy(), jwelford.welford_covariance(j_state, regularize), 1e-6)


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 100, 150, 500, 1000])
def test_adaptation_schedule_matches_jax(num_warmup):
    expected = jhmc.build_adaptation_schedule(num_warmup)
    actual = thmc.build_adaptation_schedule(num_warmup)
    for a, e in zip(actual, expected):
        np.testing.assert_array_equal(a, np.asarray(e))


# -- statistics ---------------------------------------------------------------


def _ar1_draws():
    """(4, 500, 3) AR(1) draws with coefficients 0, 0.5 and 0.9, chain
    means apart by a little."""
    rng = np.random.default_rng(7)
    phi = np.array([0.0, 0.5, 0.9])
    x = np.zeros((4, 500, 3))
    eps = rng.standard_normal((4, 500, 3))
    for t in range(1, 500):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return (x + 0.1 * np.arange(4)[:, None, None]).astype(np.float32)


DRAWS = _ar1_draws()
STATS = {
    "autocorrelation": lambda m, x: m.autocorrelation(x, dim=1),
    "autocovariance": lambda m, x: m.autocovariance(x, dim=1),
    "gelman_rubin": lambda m, x: m.gelman_rubin(x),
    "split_gelman_rubin": lambda m, x: m.split_gelman_rubin(x),
    "effective_sample_size": lambda m, x: m.effective_sample_size(x),
    "quantile": lambda m, x: m.quantile(x, [0.05, 0.5, 0.95], dim=1),
    "pi": lambda m, x: m.pi(x, 0.8, dim=1),
    "hpdi": lambda m, x: m.hpdi(x, 0.9, dim=1),
}


@pytest.mark.parametrize("name", sorted(STATS))
def test_stats_match_jax(name):
    expected = np.asarray(STATS[name](jstats, jnp.asarray(DRAWS)))
    actual = STATS[name](tstats, torch.tensor(DRAWS)).numpy()
    assert actual.shape == expected.shape
    _close(actual, expected, 1e-4, atol_scale=1e-6 if "correlation" in name or "covariance" in name else 0.0)


# -- the NUTS tree --------------------------------------------------------------


def test_bit_helpers_match_jax():
    ks = np.arange(1024)
    np.testing.assert_array_equal([tnuts._popcount(int(k)) for k in ks], np.asarray(jnuts._popcount(jnp.asarray(ks))))
    np.testing.assert_array_equal(
        [tnuts._trailing_ones(int(k)) for k in ks], np.asarray(jnuts._trailing_ones(jnp.asarray(ks)))
    )


def test_is_turning_matches_jax():
    r_left, r_right, r_sum = (RNG.standard_normal((64, D)).astype(np.float32) for _ in range(3))
    expected = jax.vmap(jnuts._is_turning)(*(jnp.asarray(a) for a in (INV_MASS[:1].repeat(64, 0), r_left, r_right,
                                                                          r_sum)))
    actual = tnuts._is_turning(torch.tensor(INV_MASS[:1]), torch.tensor(r_left), torch.tensor(r_right),
                               torch.tensor(r_sum))
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


C6 = 6
SUB_STEP = np.array([0.02, 0.05, 0.1, 0.25, 0.6, 8.0], np.float32)  # the last one diverges
SUB_DIR = np.array([1.0, -1.0, 1.0, -1.0, 1.0, 1.0], np.float32)
COMPARED = ("z_left", "r_left", "grad_left", "pe_left", "z_right", "r_right", "grad_right", "pe_right", "r_sum",
            "weight", "sum_accept")
FLAGS = ("turning", "diverging", "num_proposals")


@pytest.fixture(scope="module")
def subtrees(kernels):
    """Both builders from shared (z, r, direction, step size, inverse mass)
    at depths 0 to 6: JAX's on each chain (vmapped), the port's on the batch."""
    jk, tk = kernels
    z, r, inv = Z16[:C6], R16[:C6], INV_MASS[:C6]
    pe, grad = _jax_pe_grad(jk, z)
    energy0 = pe + 0.5 * (inv * r * r).sum(-1)
    keys = jax.random.split(jax.random.key(1), C6)
    out = {"energy0": energy0}
    for depth in range(7):
        build = jax.jit(jax.vmap(lambda *a, d=depth: jk._build_subtree(d, *a)))
        j_tree = build(*(jnp.asarray(a) for a in (z, r, grad, energy0, SUB_DIR, SUB_STEP, inv)), keys)
        t_tree, _ = tk._build_subtree(
            depth, *(torch.tensor(a) for a in (z, r, grad, energy0, SUB_DIR, SUB_STEP, inv)),
            torch.Generator().manual_seed(depth),
        )
        out[depth] = (j_tree, t_tree)
    return out


@pytest.mark.parametrize("depth", range(7))
def test_subtree_batched_matches_jax_per_chain(subtrees, depth):
    j_tree, t_tree = subtrees[depth]
    for name in FLAGS:
        np.testing.assert_array_equal(getattr(t_tree, name).numpy(), np.asarray(getattr(j_tree, name)), err_msg=name)
    for name in COMPARED:
        actual, expected = getattr(t_tree, name).numpy(), np.asarray(getattr(j_tree, name))
        for c in range(C6):
            if name in ("weight", "sum_accept"):
                atol = 1e-6 * abs(subtrees["energy0"][c])
                np.testing.assert_allclose(actual[c], expected[c], rtol=1e-5, atol=atol, err_msg=f"{name}[{c}]")
            else:
                _close(actual[c], expected[c], 1e-5, atol_scale=1e-5)


def test_subtree_cases_cover_turning_and_divergence(subtrees):
    """The shared inputs do what the comparison needs: at depth 6 chains
    turn after different numbers of leaves, and one diverges."""
    j_tree, _ = subtrees[6]
    turning, diverging = np.asarray(j_tree.turning), np.asarray(j_tree.diverging)
    n = np.asarray(j_tree.num_proposals)
    assert diverging.sum() == 1 and diverging[-1]
    assert len(set(n[turning])) >= 2
    assert (n < 64).sum() >= 3


def _fix_nuts_draws(monkeypatch, r0):
    """Shared randomness for one NUTS trajectory in both packages: momentum
    ``r0``, always to the right, every proposal taken."""
    monkeypatch.setattr(jnuts, "_sample_momentum", lambda key, inv: jnp.asarray(r0))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, *a, **k: jnp.asarray(True))
    monkeypatch.setattr(jax.random, "uniform", lambda key, *a, **k: jnp.asarray(0.0, jnp.float32))
    monkeypatch.setattr(tnuts, "_sample_momentum", lambda generator, inv: torch.tensor(r0)[None])
    monkeypatch.setattr(torch, "rand", lambda shape, out=None, **k: (
        torch.zeros(shape, dtype=k.get("dtype")) if out is None else out.zero_()))


@pytest.fixture
def trajectories(kernels, monkeypatch):
    """One NUTS trajectory from Z16[1] in each package at shared draws."""
    jk, tk = kernels
    z0, step, inv = Z16[1], 0.15, INV_MASS[1]
    j_state = jk.init_state(jax.random.key(0), jnp.asarray(z0))
    t_state = tk.init_state(torch.Generator().manual_seed(0), torch.tensor(z0)[None])
    _fix_nuts_draws(monkeypatch, R16[1])
    expected = jk._trajectory(j_state, jnp.asarray(step), jnp.asarray(inv), jax.random.key(2))
    actual = tk._trajectory(t_state, torch.tensor([step]), torch.tensor(inv)[None], torch.Generator())
    return [np.asarray(e) for e in expected], [a[0].numpy() for a in actual]


def test_trajectory_matches_jax_at_shared_draws(trajectories):
    """z, potential, gradient, number of steps, accept probability and
    divergence of a whole NUTS transition."""
    expected, actual = trajectories
    assert int(actual[4]) > 4  # several doublings
    for i in (0, 1, 2, 5):
        _close(actual[i], expected[i], 1e-5)
    np.testing.assert_array_equal(actual[4], expected[4])
    np.testing.assert_array_equal(actual[6], expected[6])


@pytest.mark.xfail(strict=True, reason=(
    "fault of the reference: pyro_tpu/infer/mcmc/nuts.py:358 records the proposal's potential plus the kinetic "
    "energy of the initial momentum; the port records the proposal's own total energy, as NumPyro's NUTS does"
))
def test_trajectory_energy_matches_jax(trajectories):
    expected, actual = trajectories
    _close(actual[3], expected[3], 1e-5)


def test_trajectory_energy_is_the_proposals_own(kernels, monkeypatch):
    jk, tk = kernels
    z0, step, inv = Z16[1], 0.15, INV_MASS[1]
    t_state = tk.init_state(torch.Generator().manual_seed(0), torch.tensor(z0)[None])
    _fix_nuts_draws(monkeypatch, R16[1])
    z, pe, _, energy, _, _, _ = tk._trajectory(t_state, torch.tensor([step]), torch.tensor(inv)[None],
                                               torch.Generator())
    # every proposal taken: the proposal is the last leaf to the right, whose
    # momentum the tree's right end keeps; rebuild it by leapfrog steps
    zc, rc, gc = t_state.z, torch.tensor(R16[1])[None], t_state.z_grad
    for _ in range(1 << tk.max_tree_depth):
        if torch.equal(zc, z):
            break
        zc, rc, _, gc = thmc._leapfrog(zc, rc, gc, step, torch.tensor(inv)[None], tk._potential_and_grad)
    assert torch.equal(zc, z)
    _close(energy.numpy(), (pe + thmc._kinetic(rc, torch.tensor(inv)[None])).numpy(), 1e-6)


# -- MCMC -----------------------------------------------------------------------


def _eight_schools_init():
    return {"eta": np.zeros(8, np.float32), "mu": np.float32(100.0), "tau": np.float32(math.log(3.0))}


@pytest.mark.xfail(strict=True, reason=(
    "fault of the reference: pyro_tpu/infer/mcmc/api.py:168 starts every vectorized chain at a uniform draw "
    "(self.kernel._draw_init), so MCMC(initial_params=...) has no effect"
))
def test_jax_mcmc_starts_at_initial_params():
    init = {k: jnp.asarray(v) for k, v in _eight_schools_init().items()}
    kernel = JHMC(jes.model, step_size=1e-3, num_steps=1, adapt_step_size=False, adapt_mass_matrix=False)
    mcmc = JMCMC(kernel, num_samples=1, warmup_steps=0, initial_params=init)
    mcmc.run(jes.Y, jes.SIGMA, rng_key=jax.random.key(0))
    assert abs(float(mcmc.get_samples()["mu"][0]) - 100.0) < 1.0


def test_mcmc_starts_at_initial_params():
    init = {k: torch.tensor(v) for k, v in _eight_schools_init().items()}
    kernel = HMC(tes.model, step_size=1e-3, num_steps=1, adapt_step_size=False, adapt_mass_matrix=False)
    mcmc = MCMC(kernel, num_samples=1, warmup_steps=0, initial_params=init, num_chains=3)
    mcmc.run(*tes.data(), generator=torch.Generator().manual_seed(0))
    mu = mcmc.get_samples()["mu"]
    assert mu.shape == (3,) and (mu - 100.0).abs().max() < 1.0


@pytest.fixture(scope="module")
def eight_schools_run():
    pyro.set_default_device("cpu")
    kernel = NUTS(tes.model)
    mcmc = MCMC(kernel, num_samples=200, warmup_steps=150, num_chains=8)
    mcmc.run(*tes.data(), generator=torch.Generator().manual_seed(0))
    return mcmc, kernel


@pytest.mark.parametrize("site, mean", [("mu", MU_MEAN), ("tau", TAU_MEAN)])
def test_eight_schools_posterior_matches_quadrature(eight_schools_run, site, mean):
    mcmc, _ = eight_schools_run
    draws = mcmc.get_samples(group_by_chain=True)[site]
    ess = float(tstats.effective_sample_size(draws))
    mcse = float(draws.std()) / math.sqrt(ess)
    assert abs(float(draws.mean()) - mean) <= 4 * mcse + 0.01, (float(draws.mean()), mean, mcse)
    assert float(tstats.split_gelman_rubin(draws)) < 1.05


def test_mcmc_outputs(eight_schools_run, capsys):
    mcmc, kernel = eight_schools_run
    samples = mcmc.get_samples(group_by_chain=True)
    assert {k: tuple(v.shape) for k, v in samples.items()} == {
        "eta": (8, 200, 8), "mu": (8, 200), "tau": (8, 200), "theta": (8, 200, 8)
    }
    torch.testing.assert_close(samples["theta"], samples["mu"][..., None] + samples["tau"][..., None] * samples["eta"])
    assert mcmc.get_samples()["eta"].shape == (1600, 8)
    diag = mcmc.diagnostics()
    assert diag["mu"]["n_eff"].shape == (1,) and diag["eta"]["r_hat"].shape == (8,)
    assert 0.6 < diag["acceptance rate"]["mean"] < 0.95 and diag["divergences"]["total"] >= 0
    assert kernel.counts["host_syncs"] <= kernel.counts["leapfrogs"]
    assert (mcmc.last_state.adapt.step_size > 0).all()
    mcmc.summary()
    assert "Number of divergences" in capsys.readouterr().out


def test_conjugate_normal_posterior():
    """z ~ Normal(0, 2) in 3 dims, 5 observations ~ Normal(z, 1) each: the
    posterior is Normal with precision 1/4 + 5."""
    y = torch.tensor(np.random.default_rng(2).normal(1.0, 1.0, (5, 3)).astype(np.float32))

    def model(y):
        with pyro.plate("dims", 3):
            z = pyro.sample("z", tdist.Normal(0.0, 2.0))
            with pyro.plate("obs", 5, dim=-2):
                pyro.sample("y", tdist.Normal(z, 1.0), obs=y)

    post_var = 1.0 / (0.25 + 5.0)
    post_mean = post_var * y.sum(0)
    for kernel in (NUTS(model, max_tree_depth=5), HMC(model, trajectory_length=1.0)):
        mcmc = MCMC(kernel, num_samples=150, warmup_steps=100, num_chains=4)
        mcmc.run(y, generator=torch.Generator().manual_seed(1))
        draws = mcmc.get_samples(group_by_chain=True)["z"]
        ess = tstats.effective_sample_size(draws)
        mean, var = draws.mean((0, 1)), draws.var((0, 1))
        assert ((mean - post_mean).abs() <= 4 * torch.sqrt(var / ess) + 0.01).all(), (mean, post_mean)
        assert ((var / post_var - 1).abs() <= 4 * torch.sqrt(2 / ess) + 0.01).all(), (var, post_var)


def test_unknown_chain_method_raises(kernels):
    _, tk = kernels
    with pytest.raises(ValueError, match="chain_method"):
        MCMC(tk, num_samples=1, chain_method="threads")
