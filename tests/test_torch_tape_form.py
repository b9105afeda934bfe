"""The two kernels that read K4b's tape, K4c (a level's midpoint draws,
``gl_mids_kernel<NP>``) and K4b's backward (``gl_contract_bwd_kernel<NP>``)
of ``pyro_tpu_torch/csrc/gaussian_levels.cu``, on the CPU: their
arithmetic form, and their wrappers' launch plans.

The kernels run only on the card.  The form of their arithmetic, and what
their wrappers plan on the host, are held here:

(a) K4c's form, emulated in float32: L^-1 formed as one warp forms it (the
    unit vectors substituted right-looking, each row scaled by 1 / L_kk),
    then per (draw, pair) info_c = i_m - P_mk [l; r], y = L^-1 info_c + eps
    and mid = L^-T y, each entry summed in the kernel's order.  Against the
    port's ``level_mids_plain`` in float64 at n in {1, 2, 5, 16, 17, 31,
    32}, per pair and shared, an even and an odd level, D in {1, 3} and Np
    at a tile's edges; and through both packages' descents: the port's
    ``sequential_gaussian_filter_sample`` at T=9 (odd levels) with its
    levels' draws through the emulation against the JAX package's in
    float64, at the same white noise.  Each within 1e-4 times the output's
    largest entry, the bar the kernel is held to on the card.
(b) K4b backward's form, emulated in float32: L^-1 as in (a), then X1 =
    L^-1 P_mk, x2 = L^-1 i_m, gX1, gx2, gB = L^-T [gX1 | gx2], gL, and the
    Cholesky adjoint as L^-T S L^-1, every solve a product with L^-1 and
    every sum in the kernel's order.  Against ``contract_pairs_bwd_plain``
    in float64 at the same n, t in {2, 3, 9}, with each upstream gradient
    None in turn, within 1e-4 times each output's largest entry (P
    gradients symmetrised); and against ``jax.vjp`` of the JAX package's
    ``sequential_gaussian_tensordot`` at T=2 and T=3 (an odd level), the
    port's backward levels through the emulation, within the bars of
    ``tests/test_torch_gaussian_train.py::test_contraction_vjp_matches_jax``.
(c) ``mids_plan`` and ``contract_bwd_plan`` at the levels of their paths
    (the heterogeneous ``rsample_posterior`` at 64.4000.16.4 and the
    homogeneous one at 8.10000.32.4; an ``lgssm`` training step at T=4000,
    n=16) on a card of 132 SMs, and where tiles and CTAs change, with exact
    values, at the shapes the kernels report on an H100.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu_torch as pyro
from pyro_tpu.ops import gaussian as jg
from pyro_tpu_torch.ops import gaussian as tg
from pyro_tpu_torch.ops import gaussian_levels as gl

DIMS = [1, 2, 5, 16, 17, 31, 32]
TILE, TILE_SHARED = 4, 32  # K4c's pairs a tile, per pair and shared (MD_TP, MD_TPS)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _within(got, ref, label):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), label
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-4 * scale, f"{label}: max abs err {err:.3g} over 1e-4 * {scale:.3g}"


def _spd(rng, shape, n):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return M @ np.swapaxes(M, -1, -2) / n + np.eye(n)


def _f32(x):
    """float32 values of ``x``, and the same values in float64."""
    x = torch.as_tensor(np.asarray(x)).float()
    return x, x.double()


# -- the kernels' forms, emulated in float32 --------------------------------------------


def tri_inverse(L):
    """L^-1 of lower L (..., n, n) as hb_tri_inverse forms it: column c of
    the identity substituted right-looking, row k scaled by 1 / L_kk, then
    every later row less L[i][k] times it."""
    n = L.shape[-1]
    invd = 1 / torch.diagonal(L, dim1=-2, dim2=-1)
    X = torch.eye(n, dtype=L.dtype).expand(L.shape).clone()
    for k in range(n):
        X[..., k, :] = X[..., k, :] * invd[..., k, None]
        X[..., k + 1:, :] = X[..., k + 1:, :] - L[..., k + 1:, k, None] * X[..., k, None, :]
    return X, invd


def emulate_mids(cur, L, P_mk, i_m, eps):
    """K4c's arithmetic form in float32: the next level's points (D, R, m +
    Np, n) from the points ``cur`` (D, R, m, n) and the level's tape, as
    ``level_mids_plain``."""
    D, R, m, n = cur.shape
    Np = i_m.shape[-2]
    Linv, _ = tri_inverse(torch.tril(L))
    x = torch.cat([cur[..., :Np, :], cur[..., 1:Np + 1, :]], dim=-1)  # [l | r] a pair
    v = i_m.expand(D, R, Np, n).clone()
    for c in range(2 * n):  # info_c = i_m - P_mk x, c in order
        v = v - P_mk[..., c] * x[..., c, None]
    y = torch.zeros_like(v)
    for k in range(n):  # L^-1 info_c, k in order; then + eps
        y = y + Linv[..., :, k] * v[..., k, None]
    y = y + eps
    mid = torch.zeros_like(v)
    for k in range(n):  # mid[i] = sum_k L^-1[k][i] y[k], k in order
        mid = mid + Linv[..., k, :] * y[..., k, None]
    pairs = torch.stack([cur[..., :Np, :], mid], dim=-2).reshape(D, R, 2 * Np, n)
    return torch.cat([pairs, cur[..., Np:, :]], dim=-2)


def _col_sum(A, B):
    """sum_k A[..., :, k] (x) B[..., k, :] in k order: the product A B as the
    kernels form it, a lane's column (or row) stepping through the summed
    index."""
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=A.dtype)
    for k in range(A.shape[-1]):
        acc = acc + A[..., :, k, None] * B[..., k, None, :]
    return acc


def emulate_contract_bwd(t, L, P_mk, i_m, g_P, g_info, g_logZ):
    """K4b backward's arithmetic form in float32, with the signature and
    outputs of ``contract_pairs_bwd_plain``."""
    R, np_, n, _ = L.shape
    t_out, e = t - np_, 2 * np_
    g_P = gl._or_zeros(g_P, (R, t_out, 2 * n, 2 * n), L)
    g_info = gl._or_zeros(g_info, (R, t_out, 2 * n), L)
    g_logZ = gl._or_zeros(g_logZ, (R, t_out), L)
    L = torch.tril(L)
    Linv, invd = tri_inverse(L)
    G = g_P[:, :np_] + g_P[:, :np_].transpose(-1, -2)
    gi, gz = g_info[:, :np_], g_logZ[:, :np_]
    X1 = _col_sum(Linv, P_mk)
    x2 = _col_sum(Linv, i_m[..., None])[..., 0]
    gX1 = -(x2[..., :, None] * gi[..., None, :] + _col_sum(X1, G))
    gx2 = gz[..., None] * x2
    for c in range(2 * n):
        gx2 = gx2 - X1[..., :, c] * gi[..., c, None]
    LinvT = Linv.transpose(-1, -2)
    gB = _col_sum(LinvT, torch.cat([gX1, gx2[..., None]], dim=-1))  # (n, 2n + 1)
    X = torch.cat([X1, x2[..., None]], dim=-1)
    gL = -torch.tril(_col_sum(gB, X.transpose(-1, -2))) - torch.diag_embed(gz[..., None] * invd)
    M = torch.tril(_col_sum(L.transpose(-1, -2), gL))
    S = 0.5 * (M + torch.tril(M, -1).transpose(-1, -2))
    W = _col_sum(LinvT, _col_sum(S, Linv))
    gPmm = 0.5 * (W + W.transpose(-1, -2))
    gl_, gr, gim = 0.5 * gB[..., :n], 0.5 * gB[..., n:-1], gB[..., -1]
    gPx = torch.cat([torch.cat([0.5 * G[..., :n, :n], gl_.transpose(-1, -2)], dim=-1),
                     torch.cat([gl_, gPmm], dim=-1)], dim=-2)
    gPy = torch.cat([torch.cat([gPmm, gr], dim=-1),
                     torch.cat([gr.transpose(-1, -2), 0.5 * G[..., n:, n:]], dim=-1)], dim=-2)
    g_P_in = torch.stack([gPx, gPy], dim=2).reshape(R, e, 2 * n, 2 * n)
    g_info_in = torch.stack([torch.cat([gi[..., :n], gim], dim=-1), torch.cat([gim, gi[..., n:]], dim=-1)],
                            dim=2).reshape(R, e, 2 * n)
    g_logZ_in = gz[..., None].expand(R, np_, 2).reshape(R, e)
    if t > e:  # the odd level's last factor passes its gradient through
        g_P_in = torch.cat([g_P_in, 0.5 * (g_P[:, -1:] + g_P[:, -1:].transpose(-1, -2))], dim=1)
        g_info_in = torch.cat([g_info_in, g_info[:, -1:]], dim=1)
        g_logZ_in = torch.cat([g_logZ_in, g_logZ[:, -1:]], dim=1)
    return g_P_in, g_info_in, g_logZ_in


# -- (a) K4c ----------------------------------------------------------------------------


def _mids_inputs(rng, D, R, m, Np, n, shared):
    """float64 numpy: cur, L (a Cholesky factor), P_mk, i_m, eps."""
    per = () if shared else (R, Np)
    return (rng.standard_normal((D, R, m, n)), np.linalg.cholesky(_spd(rng, per, n)),
            rng.standard_normal(per + (n, 2 * n)), rng.standard_normal((R, Np, n)),
            rng.standard_normal((D, R, Np, n)))


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("n", DIMS)
def test_mids_form_matches_the_plain_version(n, shared, odd):
    """Np at a tile's edges (1, k - 1, k, k + 1), D of 1 and 3, one point
    carried (an even level) or two (an odd one)."""
    k = TILE_SHARED if shared else TILE
    rng = np.random.default_rng(100 * n + 10 * shared + odd)
    for Np in (1, k - 1, k, k + 1):
        for D in (1, 3):
            inputs = [_f32(x) for x in _mids_inputs(rng, D, 2, Np + 1 + odd, Np, n, shared)]
            got = emulate_mids(*(x32 for x32, _ in inputs))
            ref = gl.level_mids_plain(*(x64 for _, x64 in inputs))
            _within(got.numpy(), ref.numpy(), f"K4c n={n} Np={Np} D={D}")


@pytest.mark.parametrize("n", [3, 16])
def test_descent_through_the_mids_form_matches_jax(n, monkeypatch):
    """The port's sampler at T=9 (levels of 4, 2, 1 and 1 pairs, the first
    three odd) with K4c's form at every level, against the JAX package's in
    float64, both at the same white noise."""
    T, batch, sample_shape = 9, (2,), (3,)
    rng = np.random.default_rng(n)
    init = (rng.standard_normal(batch), rng.standard_normal(batch + (n,)), _spd(rng, batch, n))
    trans = (rng.standard_normal(batch + (T,)), rng.standard_normal(batch + (T, 2 * n)), _spd(rng, batch + (T,), 2 * n))
    noise = rng.standard_normal(sample_shape + batch + (T + 1, n))
    init32, trans32, noise32 = ([_f32(x)[0] for x in xs] for xs in (init, trans, (noise,)))
    calls = []

    def mids(*args):
        calls.append(args[-1].shape)
        return emulate_mids(*args)

    monkeypatch.setattr(gl, "level_mids_plain", mids)
    got = tg.sequential_gaussian_filter_sample(tg.Gaussian(*init32), tg.Gaussian(*trans32), sample_shape,
                                               noise=noise32[0])
    assert [s[-2] for s in calls] == [1, 1, 2, 4]
    with jax.enable_x64(True):
        ref = jax.jit(lambda i, t, e: jg.sequential_gaussian_filter_sample(
            jg.Gaussian(*i), jg.Gaussian(*t), sample_shape, noise=e))(
            tuple(jnp.asarray(x) for x in init), tuple(jnp.asarray(x) for x in trans), jnp.asarray(noise))
        ref = np.asarray(ref)
    _within(got.numpy(), ref, f"descent n={n}")


# -- (b) K4b's backward -----------------------------------------------------------------


def _sym(g):
    return 0.5 * (g + g.transpose(-1, -2))


@pytest.mark.parametrize("t", [2, 3, 9])
@pytest.mark.parametrize("n", DIMS)
def test_contract_bwd_form_matches_the_plain_version(n, t):
    """All three upstream gradients, then each of them None in turn."""
    R = 2
    rng = np.random.default_rng(10 * n + t)
    P, info, logZ = _f32(_spd(rng, (R, t), 2 * n))[1], *(_f32(x)[1] for x in (
        rng.standard_normal((R, t, 2 * n)), rng.standard_normal((R, t))))
    _, _, _, tape = gl.contract_pairs_plain(P, info, logZ, tape=True)
    tape = [_f32(x.numpy()) for x in tape]
    t_out = t - t // 2
    grads = [_f32(x) for x in (rng.standard_normal((R, t_out, 2 * n, 2 * n)), rng.standard_normal((R, t_out, 2 * n)),
                               rng.standard_normal((R, t_out)))]
    for drop in (None, 0, 1, 2):
        g32 = [None if i == drop else g for i, (g, _) in enumerate(grads)]
        g64 = [None if i == drop else g for i, (_, g) in enumerate(grads)]
        got = emulate_contract_bwd(t, *(x for x, _ in tape), *g32)
        ref = gl.contract_pairs_bwd_plain(t, *(x for _, x in tape), *g64)
        for label, a, b in zip(("gP", "ginfo", "glogZ"), (_sym(got[0]), *got[1:]), (_sym(ref[0]), *ref[1:])):
            if float(b.abs().max()) > 0:
                _within(a.numpy(), b.numpy(), f"K4b backward {label}, upstream {drop} None")
            else:
                assert not a.any(), f"K4b backward {label}: zero upstream, nonzero output"


def _near(actual, expected, scale=1e-3, atol=1e-4):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape and np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=scale * np.abs(expected).max() + atol)


@pytest.mark.parametrize("T", [2, 3])
def test_contraction_vjp_through_the_backward_form_matches_jax(T, monkeypatch):
    """The port's ``sequential_gaussian_tensordot`` (R=2, n=3) backward
    through K4b backward's form at every level, against ``jax.vjp`` of the
    JAX package's: outputs within 1e-4 of max + 1e-4, gradients within 1e-3
    of max|grad| + 1e-4, P gradients symmetrised."""
    R, n = 2, 3
    rng = np.random.default_rng(30 + T)
    P = _spd(rng, (R, T), 2 * n).astype(np.float32)
    info = rng.standard_normal((R, T, 2 * n)).astype(np.float32)
    logZ = rng.standard_normal((R, T)).astype(np.float32)

    def jax_fn(lz, iv, p):
        out = jg.sequential_gaussian_tensordot(jg.Gaussian(lz, iv, p))
        return out.log_normalizer, out.info_vec, out.precision

    outs_j, vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(P))
    cot = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs_j]
    grads_j = jax.jit(vjp)(tuple(jnp.asarray(c) for c in cot))

    calls = []

    def bwd(*args):
        calls.append(args[0])
        return emulate_contract_bwd(*args)

    monkeypatch.setattr(gl, "contract_pairs_bwd_plain", bwd)
    leaves = [torch.tensor(x, requires_grad=True) for x in (logZ, info, P)]
    out = tg.sequential_gaussian_tensordot(tg.Gaussian(*leaves))
    outs_t = (out.log_normalizer, out.info_vec, out.precision)
    for a, b in zip(outs_t, outs_j):
        _near(a.detach().numpy(), b, scale=1e-4)
    sum(((o * torch.tensor(c)).sum() for o, c in zip(outs_t, cot))).backward()
    assert calls == ([2] if T == 2 else [2, 3])
    _near(leaves[0].grad.numpy(), grads_j[0])
    _near(leaves[1].grad.numpy(), grads_j[1])
    _near(_sym(leaves[2].grad).numpy(), _sym(torch.tensor(np.asarray(grads_j[2]))).numpy())


# -- (c) the launch plans ---------------------------------------------------------------

# the kernels' shapes as gl_mids_shape and gl_contract_bwd_shape report them
# on an H100 at the paths' state dims: K4c at n=16 per pair (4 pairs a tile,
# 2 CTAs of 128 threads an SM by registers) and at n=32 shared (32 pairs a
# tile, 2 CTAs an SM); K4b's backward at n=16 (2 pairs a CTA, a warp each;
# 7 CTAs an SM by shared memory)
MIDS_SHAPE = gl.HalvingShape(tile=TILE, ctas_per_sm=2)
MIDS_SHAPE_SHARED = gl.HalvingShape(tile=TILE_SHARED, ctas_per_sm=2)
BWD_SHAPE = gl.HalvingShape(tile=2, ctas_per_sm=7)

# (R, Np, tiles, blocks): the 12 K4c levels of a heterogeneous
# rsample_posterior at 64.4000.16.4, top level first
SAMPLE_LEVELS = [
    (1, 1, 1, 1), (1, 2, 1, 1), (1, 4, 1, 1), (1, 8, 2, 2), (1, 16, 4, 4), (1, 31, 8, 8), (1, 62, 16, 16),
    (1, 125, 32, 32), (1, 250, 63, 63), (1, 500, 125, 125), (1, 1000, 250, 250), (1, 2000, 500, 264),
]
# the 13 of a homogeneous one at 8.10000.32.4 (L and P_mk shared)
HOMOGENEOUS_LEVELS = [
    (8, 1, 8, 8), (8, 2, 8, 8), (8, 4, 8, 8), (8, 9, 8, 8), (8, 19, 8, 8), (8, 39, 16, 16), (8, 78, 24, 24),
    (8, 156, 40, 40), (8, 312, 80, 80), (8, 625, 160, 160), (8, 1250, 320, 264), (8, 2500, 632, 264),
    (8, 5000, 1256, 264),
]
# (items, tiles, blocks): the 12 K4b backward levels of an lgssm step
# (R=1, T=4000), first to last
BWD_LEVELS = [
    (2000, 1000, 924), (1000, 500, 500), (500, 250, 250), (250, 125, 125), (125, 63, 63), (63, 32, 32),
    (32, 16, 16), (16, 8, 8), (8, 4, 4), (4, 2, 2), (2, 1, 1), (1, 1, 1),
]


@pytest.mark.parametrize("R,Np,tiles,blocks", SAMPLE_LEVELS)
def test_mids_plan_at_a_samplers_levels(R, Np, tiles, blocks):
    assert tuple(gl.mids_plan(R, Np, 132, MIDS_SHAPE)) == (tiles, blocks)


@pytest.mark.parametrize("R,Np,tiles,blocks", HOMOGENEOUS_LEVELS)
def test_mids_plan_at_a_homogeneous_samplers_levels(R, Np, tiles, blocks):
    assert tuple(gl.mids_plan(R, Np, 132, MIDS_SHAPE_SHARED)) == (tiles, blocks)


@pytest.mark.parametrize("items,tiles,blocks", BWD_LEVELS)
def test_contract_bwd_plan_at_an_lgssm_steps_levels(items, tiles, blocks):
    assert tuple(gl.contract_bwd_plan(items, 132, BWD_SHAPE)) == (tiles, blocks)


@pytest.mark.parametrize("plan,args,expected", [
    ("mids", (1, 1, 132, MIDS_SHAPE), (1, 1)),  # one pair: one CTA
    ("mids", (1, 4, 132, MIDS_SHAPE), (1, 1)),  # a full tile
    ("mids", (1, 5, 132, MIDS_SHAPE), (2, 2)),  # a second tile, of one pair
    ("mids", (3, 1, 132, MIDS_SHAPE), (3, 3)),  # a tile a row, however few its pairs
    ("mids", (1, 1056, 132, MIDS_SHAPE), (264, 264)),  # a tile a CTA
    ("mids", (1, 1057, 132, MIDS_SHAPE), (265, 264)),  # the first CTA takes two tiles
    ("mids", (8, 5000, 132, MIDS_SHAPE_SHARED), (1256, 264)),  # shared: 32 pairs a tile
    ("mids", (1, 2000, 16, MIDS_SHAPE), (500, 32)),  # a smaller card
    ("bwd", (1, 132, BWD_SHAPE), (1, 1)),  # one item: one CTA
    ("bwd", (3, 132, BWD_SHAPE), (2, 2)),  # a CTA's second warp idle
    ("bwd", (1848, 132, BWD_SHAPE), (924, 924)),  # a warp an item
    ("bwd", (1849, 132, BWD_SHAPE), (925, 924)),  # the first warp takes two
    ("bwd", (2000, 16, BWD_SHAPE), (1000, 112)),  # a smaller card
])
def test_plans_where_tiles_and_ctas_change(plan, args, expected):
    fn = gl.mids_plan if plan == "mids" else gl.contract_bwd_plan
    assert tuple(fn(*args)) == expected
