"""K4a and K5a (one homogeneous halving level, the kernel
``gl_halving_kernel<GAMMA>`` of ``pyro_tpu_torch/csrc/gaussian_levels.cu``)
on the CPU: the wrapper's launch plan, and the kernel's arithmetic form.

The kernel runs only on the card.  What its wrapper plans on the host, and
the form of its arithmetic, are held here:

(a) ``halving_plan`` at the 13 levels of a homogeneous ``log_prob`` at
    8.10000.32.4 (8 rows of 5000 pairs down to 8 rows of 1) on a card of
    132 SMs, and where tiles and CTAs change, with exact values;
(b) a float32 emulation of the kernel's form (L in the factorisation's
    order, each entry less L[i][k] L[j][k] for k in turn, pivots by a
    reciprocal square root; L^-1 by substitution of the unit vectors, as
    warp 0 forms it; Kt = L^-1 [B^T | B]; P' = diag(A, D) - Kt^T Kt written
    from its lower triangle; over tiles of 64 pairs of one row, S = IB L^-T
    and info' = OUTER - S Kt; |s|^2 summed in index order; logZ', alpha' and
    beta') against one level of the JAX package's ``reduce_pow2_block``
    (``pyro_tpu/ops/gaussian.py:448-475`` and
    ``pyro_tpu/ops/gamma_gaussian.py:401-439``, reached through
    ``sequential_gaussian_tensordot_homogeneous`` and its gamma twin at
    T=2) in float64 at n=32 over 130 pairs (three tiles, the last of 2):
    each output within 1e-4 times its largest entry, the bar the kernel is
    held to against its plain version on the card; alpha' exactly;
(c) the same emulation against the port's plain versions in float64 at n
    in {1, 2, 5, 16, 17, 31, 32}, within the same bar: the explicit inverse
    keeps the kernel's accuracy at every n it takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro_tpu.ops import gamma_gaussian as jgg
from pyro_tpu.ops import gaussian as jg
from pyro_tpu_torch.ops import gaussian_levels as gl

# the kernel's shape as gl_halving_shape reports it on an H100: tiles of 64
# pairs of one row, one CTA an SM (its launch bound: up to 255 registers a
# thread)
SHAPE = gl.HalvingShape(tile=64, ctas_per_sm=1)
TILE = SHAPE.tile
HALF_LOG_2PI = 0.91893853320467274178


# -- (a) the launch plan ----------------------------------------------------------------

# (R, m, tiles, blocks) on 132 SMs: the 13 levels of a homogeneous log_prob,
# first to last
LOG_PROB_LEVELS = [
    (8, 5000, 632, 132), (8, 2500, 320, 132), (8, 1250, 160, 132), (8, 625, 80, 80), (8, 312, 40, 40),
    (8, 156, 24, 24), (8, 78, 16, 16), (8, 39, 8, 8), (8, 19, 8, 8), (8, 9, 8, 8), (8, 4, 8, 8), (8, 2, 8, 8),
    (8, 1, 8, 8),
]


@pytest.mark.parametrize("R,m,tiles,blocks", LOG_PROB_LEVELS)
def test_plan_at_a_log_probs_levels(R, m, tiles, blocks):
    assert tuple(gl.halving_plan(R, m, 132, SHAPE)) == (tiles, blocks)


@pytest.mark.parametrize("R,m,sms,expected", [
    (1, 1, 132, (1, 1)),  # one pair: one CTA
    (1, 64, 132, (1, 1)),  # a full tile
    (1, 65, 132, (2, 2)),  # a second tile, of one pair
    (3, 1, 132, (3, 3)),  # a tile a row, however few its pairs
    (4, 2112, 132, (132, 132)),  # a tile a CTA
    (4, 2113, 132, (136, 132)),  # the first CTAs take two tiles
    (8, 5000, 16, (632, 16)),  # a smaller card
])
def test_plan_where_tiles_and_ctas_change(R, m, sms, expected):
    assert tuple(gl.halving_plan(R, m, sms, SHAPE)) == expected


# -- the kernel's form, emulated in float32 ---------------------------------------------


def emulate_kernel(P, info, logZ, alpha=None, beta=None):
    """K4a (K5a with ``alpha`` and ``beta``) in the kernel's arithmetic form,
    float32 on the CPU: ``(P', info', logZ', L, ib)`` as ``_halving_cuda``
    returns them with the tape, or ``(P', info', logZ', alpha', beta')`` as
    ``_gamma_halving_cuda`` returns them."""
    n = P.shape[-1] // 2
    R, two_m, _ = info.shape
    m = two_m // 2
    # L in the kernel's order: column j's entries less L[i][k] L[j][k], k in turn
    J = P[n:, n:] + P[:n, :n]
    L = torch.zeros(n, n, dtype=P.dtype)
    for j in range(n):
        col = J[j:, j].clone()
        for k in range(j):
            col = col - L[j:, k] * L[j, k]
        rs = 1 / torch.sqrt(col[0])
        L[j, j] = col[0] * rs
        L[j + 1:, j] = col[1:] * rs
    # L^-1 by substitution of the unit vectors, right-looking, scaled by 1 / L_kk
    invd = 1 / torch.diagonal(L)
    Linv = torch.eye(n, dtype=P.dtype)
    for k in range(n):
        Linv[k] = Linv[k] * invd[k]
        Linv[k + 1:] -= L[k + 1:, k:k + 1] * Linv[k:k + 1]
    B = P[:n, n:]
    Kt = Linv @ torch.cat([B.T, B], dim=1)
    low = torch.block_diag(P[:n, :n], P[n:, n:]) - Kt.T @ Kt
    P_new = torch.tril(low) + torch.tril(low, -1).T
    half_logdet = torch.log(torch.diagonal(L)).sum()
    info_new = torch.empty(R, m, 2 * n, dtype=P.dtype)
    logZ_new = torch.empty(R, m, dtype=P.dtype)
    ib = torch.empty(R, m, n, dtype=P.dtype)
    beta_new = None if beta is None else torch.empty(R, m, dtype=P.dtype)
    for r in range(R):
        for p0 in range(0, m, TILE):  # a tile: pairs p0 .. p0 + 63 of row r
            q = slice(p0, min(p0 + TILE, m))
            i1, i2 = info[r, 2 * p0:2 * q.stop:2], info[r, 2 * p0 + 1:2 * q.stop:2]
            IB = i1[:, n:] + i2[:, :n]
            S = IB @ Linv.T
            info_new[r, q] = torch.cat([i1[:, :n], i2[:, n:]], dim=-1) - S @ Kt
            ss = torch.zeros(S.shape[0], dtype=P.dtype)
            for k in range(n):
                ss = ss + S[:, k] * S[:, k]
            lz = logZ[r, 2 * p0:2 * q.stop:2] + logZ[r, 2 * p0 + 1:2 * q.stop:2] + n * HALF_LOG_2PI - half_logdet
            ib[r, q] = IB
            if beta is None:
                logZ_new[r, q] = lz + 0.5 * ss
            else:
                logZ_new[r, q] = lz
                beta_new[r, q] = beta[r, 2 * p0:2 * q.stop:2] + beta[r, 2 * p0 + 1:2 * q.stop:2] - 0.5 * ss
    if beta is None:
        return P_new, info_new, logZ_new, L, ib
    return P_new, info_new, logZ_new, alpha[:, 0::2] + alpha[:, 1::2] - 0.5 * n, beta_new


def _spd(rng, n):
    M = rng.standard_normal((n, n))
    return M @ M.T / n + np.eye(n)


def _within(got, ref, label):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), label
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * scale, f"{label}: max abs err {err:.3g} over 1e-4 * {scale:.3g}"


def _level_inputs(rng, R, m, n):
    """P (2n, 2n) positive definite, info (R, 2m, 2n), logZ, alpha (whole
    and half values: exact in float32) and beta (R, 2m), float64 numpy."""
    return (_spd(rng, 2 * n), rng.standard_normal((R, 2 * m, 2 * n)), rng.standard_normal((R, 2 * m)),
            2.0 + 0.5 * rng.integers(0, 8, (R, 2 * m)), 1.0 + rng.random((R, 2 * m)))


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


# -- (b) against one reduce_pow2_block level of the JAX package in float64 -------------


@pytest.mark.parametrize("gamma", [False, True], ids=["K4a", "K5a"])
def test_kernel_form_matches_jax_at_n32(gamma):
    n, pairs = 32, 130  # one row of 130 pairs: tiles of 64, 64 and 2
    P, info, logZ, alpha, beta = _level_inputs(np.random.default_rng(13), 1, pairs, n)
    # the JAX side: 130 chains of two factors, one level each
    chains = (info.reshape(pairs, 2, 2 * n), logZ.reshape(pairs, 2), alpha.reshape(pairs, 2), beta.reshape(pairs, 2))
    with jax.enable_x64(True):
        if gamma:
            def level(iv, lz, al, be, p):
                out = jgg.sequential_gamma_gaussian_tensordot_homogeneous(jgg.GammaGaussian(lz, iv, p, al, be))
                return out.precision, out.info_vec, out.log_normalizer, out.alpha, out.beta
        else:
            def level(iv, lz, al, be, p):
                out = jg.sequential_gaussian_tensordot_homogeneous(jg.Gaussian(lz, iv, p))
                return out.precision, out.info_vec, out.log_normalizer
        ref = [np.asarray(x) for x in jax.jit(level)(*(jnp.asarray(x) for x in chains), jnp.asarray(P))]
    got = emulate_kernel(_f32(P), _f32(info), _f32(logZ), *((_f32(alpha), _f32(beta)) if gamma else ()))
    labels = ("P'", "info'", "logZ'", "alpha'", "beta'")
    for label, a, b in zip(labels, got, ref):
        _within(a.numpy().reshape(b.shape), b, label)
    if gamma:
        assert np.array_equal(got[3].numpy().reshape(-1).astype(np.float64), ref[3]), "alpha' exactly"


# -- (c) against the port's plain versions in float64 over n ----------------------------


@pytest.mark.parametrize("n,R,m", [(1, 2, 70), (2, 3, 65), (5, 1, 129), (16, 2, 64), (17, 3, 5), (31, 1, 66),
                                   (32, 2, 65)])
def test_kernel_form_matches_the_plain_versions(n, R, m):
    P, info, logZ, alpha, beta = (torch.tensor(x) for x in _level_inputs(np.random.default_rng(n), R, m, n))
    ref = gl.halving_level_plain(P, info, logZ, tape=True)
    got = emulate_kernel(P.float(), info.float(), logZ.float())
    for label, a, b in zip(("P'", "info'", "logZ'", "L", "ib"), got, ref):
        _within(a.numpy(), b.numpy(), f"K4a {label}")
    ref = gl.gamma_halving_level_plain(P, info, logZ, alpha, beta)
    got5 = emulate_kernel(P.float(), info.float(), logZ.float(), alpha.float(), beta.float())
    for label, a, b in zip(("P'", "info'", "logZ'", "alpha'", "beta'"), got5, ref):
        _within(a.numpy(), b.numpy(), f"K5a {label}")
    assert torch.equal(got5[3].double(), ref[3]), "alpha' exactly"
    # one template: K4a's and K5a's P' and info' are the same arithmetic
    assert torch.equal(got[0], got5[0]) and torch.equal(got[1], got5[1])
