"""K4a's backward (one halving level of a homogeneous chain, the kernel
``gl_halving_bwd_kernel`` of ``pyro_tpu_torch/csrc/gaussian_levels.cu``) on
the CPU: the wrapper's launch plan, and the kernel's arithmetic form.

The kernel runs only on the card.  What its wrapper plans on the host, and
the form of its arithmetic, are held here:

(a) ``halving_bwd_plan`` at the pair counts of the 13 levels of a
    ``homogeneous`` training step (8.10000.32.4) on a card of 132 SMs, and
    at the counts where tiles, CTAs and groups change, with exact values;
(b) a float32 emulation of the kernel's form (L^-1 formed once and every
    solve a product with it, over tiles of 64 pairs; the sums over pairs
    per CTA in tile order, then by groups of CTAs in block order; the
    shared adjoint as products with L^-1) against ``jax.vjp`` of one level
    of the JAX package's ``reduce_pow2_block``
    (``pyro_tpu/ops/gaussian.py:448-475``, reached through
    ``sequential_gaussian_tensordot_homogeneous`` at T=2) in float64 at
    n=32 over 1100 pairs (18 tiles, 18 CTAs in two groups): each gradient
    within 1e-4 times its largest entry, the bar the kernel is held to
    against its plain version on the card (P gradients symmetrised: the
    two packages read other triangles of P);
(c) the same emulation against the port's plain backward in float64 at
    n in {1, 2, 5, 16, 17, 31, 32}, within the same bar: the explicit
    inverse keeps the kernel's accuracy at every n it takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro_tpu.ops import gaussian as jg
from pyro_tpu_torch.ops import gaussian_levels as gl

# the kernel's shape as gl_halving_bwd_shape reports it: tiles of 64 pairs,
# partials of 12 * 256 + 1 floats (12 entries a thread, then the sum of
# gZ'), one CTA an SM
SHAPE = gl.HalvingBwdShape(tile=64, partial=3073, ctas_per_sm=1)
TILE = SHAPE.tile


# -- (a) the launch plan ----------------------------------------------------------------

# (pairs, tiles, blocks, group, groups, sums_at, counters_at, scratch floats)
# on 132 SMs: the 13 levels of a homogeneous training step, first to last
STEP_LEVELS = [
    (40000, 625, 132, 16, 9, 132 * 3073, 141 * 3073, 141 * 3073 + 10),
    (20000, 313, 132, 16, 9, 132 * 3073, 141 * 3073, 141 * 3073 + 10),
    (10000, 157, 132, 16, 9, 132 * 3073, 141 * 3073, 141 * 3073 + 10),
    (5000, 79, 79, 16, 5, 79 * 3073, 84 * 3073, 84 * 3073 + 6),
    (2496, 39, 39, 16, 3, 39 * 3073, 42 * 3073, 42 * 3073 + 4),
    (1248, 20, 20, 16, 2, 20 * 3073, 22 * 3073, 22 * 3073 + 3),
    (624, 10, 10, 16, 1, 10 * 3073, 10 * 3073, 10 * 3073 + 2),
    (312, 5, 5, 16, 1, 5 * 3073, 5 * 3073, 5 * 3073 + 2),
    (152, 3, 3, 16, 1, 3 * 3073, 3 * 3073, 3 * 3073 + 2),
    (72, 2, 2, 16, 1, 2 * 3073, 2 * 3073, 2 * 3073 + 2),
    (32, 1, 1, 16, 1, 0, 0, 0),
    (16, 1, 1, 16, 1, 0, 0, 0),
    (8, 1, 1, 16, 1, 0, 0, 0),
]


@pytest.mark.parametrize("pairs,tiles,blocks,group,groups,sums_at,counters_at,scratch", STEP_LEVELS)
def test_plan_at_a_training_steps_levels(pairs, tiles, blocks, group, groups, sums_at, counters_at, scratch):
    plan = gl.halving_bwd_plan(pairs, 132, SHAPE)
    assert tuple(plan) == (tiles, blocks, group, groups, sums_at, counters_at, scratch)


@pytest.mark.parametrize("pairs,sms,expected", [
    (1, 132, (1, 1, 16, 1, 0, 0, 0)),  # one pair: one CTA, no partials, no counters
    (64, 132, (1, 1, 16, 1, 0, 0, 0)),  # a full tile
    (65, 132, (2, 2, 16, 1, 2 * 3073, 2 * 3073, 2 * 3073 + 2)),  # a second tile: a second CTA and one ticket
    (1024, 132, (16, 16, 16, 1, 16 * 3073, 16 * 3073, 16 * 3073 + 2)),  # one group of 16
    (1025, 132, (17, 17, 16, 2, 17 * 3073, 19 * 3073, 19 * 3073 + 3)),  # two groups: their sums after the partials
    (8448, 132, (132, 132, 16, 9, 132 * 3073, 141 * 3073, 141 * 3073 + 10)),  # a tile a CTA
    (8449, 132, (133, 132, 16, 9, 132 * 3073, 141 * 3073, 141 * 3073 + 10)),  # the first CTA takes two tiles
    # groups of ceil(sqrt(blocks)) past 256 CTAs
    (40000, 300, (625, 300, 18, 17, 300 * 3073, 317 * 3073, 317 * 3073 + 18)),
])
def test_plan_where_tiles_ctas_and_groups_change(pairs, sms, expected):
    plan = gl.halving_bwd_plan(pairs, sms, SHAPE)
    assert tuple(plan) == expected
    assert plan.group * plan.groups >= plan.blocks > plan.group * (plan.groups - 1)


# -- the kernel's form, emulated in float32 ---------------------------------------------


def emulate_kernel(P, L, ib, g_P, g_info, g_logZ, sms):
    """K4a's backward in the kernel's arithmetic form, float32 on the CPU:
    ``(gP, ginfo, glogZ)`` as ``_halving_bwd_cuda`` returns them, the grid
    and groups from ``halving_bwd_plan(pairs, sms, SHAPE)``."""
    n = P.shape[-1] // 2
    R, m, _ = ib.shape
    pairs = R * m
    plan = gl.halving_bwd_plan(pairs, sms, SHAPE)
    # L^-1 by substitution of the unit vectors, right-looking, scaled by 1 / L_kk
    invd = 1 / torch.diagonal(L)
    Linv = torch.eye(n, dtype=P.dtype)
    for k in range(n):
        Linv[k] = Linv[k] * invd[k]
        Linv[k + 1:] -= L[k + 1:, k:k + 1] * Linv[k:k + 1]
    B = P[:n, n:]
    Kt = Linv @ torch.cat([B.T, B], dim=1)
    IB = ib.reshape(pairs, n)
    GI = torch.zeros(pairs, 2 * n, dtype=P.dtype) if g_info is None else g_info.reshape(pairs, 2 * n)
    GZ = torch.zeros(pairs, dtype=P.dtype) if g_logZ is None else g_logZ.reshape(pairs)
    # per tile of 64 pairs, the products; per CTA, the sums over its tiles in order
    Gib = torch.empty(pairs, n, dtype=P.dtype)
    parts = []
    for b in range(plan.blocks):
        S1, S2, z = torch.zeros(n, 2 * n, dtype=P.dtype), torch.zeros(n, n, dtype=P.dtype), 0.0
        for t in range(b, plan.tiles, plan.blocks):
            rows = slice(t * TILE, min((t + 1) * TILE, pairs))
            S = IB[rows] @ Linv.T
            GS = GZ[rows, None] * S - GI[rows] @ Kt.T
            Gib[rows] = GS @ Linv
            S1 = S1 + S.T @ GI[rows]
            S2 = S2 + Gib[rows].T @ S
            z = z + GZ[rows].sum()
        parts.append((S1, S2, z))

    def in_order(xs):
        total = xs[0]
        for x in xs[1:]:
            total = tuple(a + b for a, b in zip(total, x))
        return total

    groups = [in_order(parts[g * plan.group:(g + 1) * plan.group]) for g in range(plan.groups)]
    S1, S2, z = in_order(groups)
    # the shared adjoint
    G = torch.zeros(2 * n, 2 * n, dtype=P.dtype) if g_P is None else g_P + g_P.T
    gKt = -(S1 + Kt @ G)
    gCt = Linv.T @ gKt
    gL = torch.tril(-(S2 + gCt @ Kt.T)) - torch.diag(z * invd)
    M = torch.tril(L.T @ gL)
    Sm = 0.5 * (M + torch.tril(M, -1).T)
    W = Linv.T @ (Sm @ Linv)
    gJ = 0.5 * (W + W.T)
    gB = 0.5 * (gCt[:, :n].T + gCt[:, n:])
    gP = torch.cat([torch.cat([0.5 * G[:n, :n] + gJ, gB], dim=1), torch.cat([gB.T, 0.5 * G[n:, n:] + gJ], dim=1)])
    gi = GI.reshape(R, m, 2 * n)
    gib = Gib.reshape(R, m, n)
    ginfo = torch.stack([torch.cat([gi[..., :n], gib], -1), torch.cat([gib, gi[..., n:]], -1)], dim=-2)
    glogZ = GZ.reshape(R, m, 1).expand(R, m, 2)
    return gP, ginfo.reshape(R, 2 * m, 2 * n), glogZ.reshape(R, 2 * m)


def _spd(rng, n):
    M = rng.standard_normal((n, n))
    return M @ M.T / n + np.eye(n)


def _within(got, ref, label):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), label
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * scale, f"{label}: max abs err {err:.3g} over 1e-4 * {scale:.3g}"


def _sym(g):
    return 0.5 * (g + np.swapaxes(g, -1, -2))


# -- (b) against jax.vjp of one reduce_pow2_block level in float64 ---------------------


def test_kernel_form_matches_jax_vjp_at_n32():
    n, R = 32, 1100  # 1100 pairs: 18 tiles, on 18 CTAs in groups of 16 and 2
    rng = np.random.default_rng(11)
    P = _spd(rng, 2 * n)
    info = rng.standard_normal((R, 2, 2 * n))
    logZ = rng.standard_normal((R, 2))
    g_P, g_info, g_logZ = rng.standard_normal((2 * n, 2 * n)), rng.standard_normal((R, 2 * n)), rng.standard_normal(R)

    def level(lz, iv, p):
        out = jg.sequential_gaussian_tensordot_homogeneous(jg.Gaussian(lz, iv, p))
        return out.log_normalizer, out.info_vec, out.precision

    with jax.enable_x64(True):
        _, vjp = jax.vjp(jax.jit(level), jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(P))
        ref_logZ, ref_info, ref_P = (np.asarray(x) for x in jax.jit(vjp)(
            (jnp.asarray(g_logZ), jnp.asarray(g_info), jnp.asarray(g_P))))

    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    _, _, _, L, ib = gl.halving_level_plain(f32(P), f32(info), f32(logZ), tape=True)
    assert gl.halving_bwd_plan(R, 18, SHAPE)[1:4] == (18, 16, 2)
    gP, ginfo, glogZ = emulate_kernel(f32(P), L, ib, f32(g_P), f32(g_info)[:, None], f32(g_logZ)[:, None], sms=18)
    _within(gP.numpy(), _sym(ref_P), "gP")
    _within(ginfo.numpy(), ref_info, "ginfo")
    _within(glogZ.numpy(), ref_logZ, "glogZ")


# -- (c) against the plain backward in float64 over n -----------------------------------


@pytest.mark.parametrize("n,R,m,sms", [(1, 2, 40, 1), (2, 3, 50, 2), (5, 1, 129, 3), (16, 2, 70, 2),
                                       (17, 3, 30, 1), (31, 1, 200, 4), (32, 4, 33, 2)])
def test_kernel_form_matches_the_plain_backward(n, R, m, sms):
    rng = np.random.default_rng(n)
    P = torch.tensor(_spd(rng, 2 * n))
    info = torch.tensor(rng.standard_normal((R, 2 * m, 2 * n)))
    logZ = torch.tensor(rng.standard_normal((R, 2 * m)))
    grads = [torch.tensor(rng.standard_normal(s)) for s in ((2 * n, 2 * n), (R, m, 2 * n), (R, m))]
    _, _, _, L, ib = gl.halving_level_plain(P, info, logZ, tape=True)
    ref = gl.halving_level_bwd_plain(P, L, ib, *grads)
    got = emulate_kernel(P.float(), L.float(), ib.float(), *(g.float() for g in grads), sms=sms)
    _within(got[0].numpy(), _sym(ref[0].numpy()), "gP")
    for label, a, b in zip(("ginfo", "glogZ"), got[1:], ref[1:]):
        _within(a.numpy(), b.numpy(), label)
    # an upstream gradient that is None counts as zero, as in the kernel
    none = emulate_kernel(P.float(), L.float(), ib.float(), None, grads[1].float(), None, sms=sms)
    ref_none = gl.halving_level_bwd_plain(P, L, ib, None, grads[1], None)
    _within(none[0].numpy(), _sym(ref_none[0].numpy()), "gP, gP' and gZ' None")
