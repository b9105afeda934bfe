"""K2g's cluster route (``mstvc_*`` of ``pyro_tpu_torch/csrc/markov_scan.cu``)
on the CPU: the wrapper's launch plan, and the kernels' arithmetic form.

The kernels run only on the card.  What their wrapper plans on the host,
and the form of their arithmetic, are held here:

(a) ``plan_scan_tv`` at H100 limits given as arguments, with exact values,
    ``tv_cluster_smem_bytes`` at model_1vt's shape, and the strides the
    wrapper passes for A (a transition constant in time is not copied);
(b) a float32 emulation of the route's form: the columns cut into the C
    CTAs' slices and l into the parts of a CTA's product, each step's
    column maxima c and E = exp(A_t - c), the factored sum z = exp(hs) @ E
    added part by part, o = log z + c, a column recomputed exactly where
    z < 2^-60 (or -inf where c is); the backward's classes
    (class 0: e = c - o <= 60 ln 2, weights P0[l] E[l, r] F0[r]; class 1:
    exact per-term weights), the reverse scan's partials added slice by
    slice in rank order, and the factored dA_t fold.  It is held against
    the JAX package's general body (``pyro_tpu/ops/markov_product.py:427-451``
    through ``_try_scan_elimination``, as
    ``tests/test_torch_markov_scan.py::test_tv_elimination_matches_jax``
    reaches it) in float64 at S in {7, 33, 64, 257}, A_t shared and one per
    row, with and without L; against ``markov_scan_tv_plain`` in float64 on
    data with unreachable states (the data of ``chip_smoke.py::tv_inputs``);
    and on a built underflow case, where hs and A_t peak at different l so
    that the factored sum is 0 at half of the columns while the true value
    is finite: there the emulation without its exact recomputation fails.

Tolerances (the kernels' on the card): -inf exactly where float64 has it,
the finite values within atol 1e-4 plus rtol 1e-6 of float64, every
gradient finite and within 1e-3 times its largest entry of float64's.
"""

import math
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro_tpu.ops import markov_product as jmp
from pyro_tpu.ops import packed as jpacked
from pyro_tpu_torch.ops import markov_scan as ms

TAU = 2.0 ** -60  # TV_TAU of the source
LOG_TAU = 60 * math.log(2)  # TV_LOG_TAU
K2G_TOL = 1e-3


# -- (a) the launch plan --------------------------------------------------------------

# H100 limits: 227 KB of shared memory a block may opt in to, and the
# clusters the card runs at once as tests/test_torch_markov_scan.py gives
# them for K2's cluster kernels (one CTA an SM)
H100_SMEM = 232448


def _h100_active_clusters(C, rows):
    return {4: 30, 8: 15, 16: 7}.get(C, 132 // C)


@pytest.mark.parametrize(
    "B,S,nA,plan",
    [
        (32, 256, 1, ms.ScanPlan("cluster", 8, 3)),  # model_1vt's shape: 11 clusters of 3 rows
        (32, 256, 32, ms.ScanPlan("cluster", 8, 1)),  # one A_t per row: one row a cluster
        (8, 64, 8, ms.ScanPlan("cluster", 8, 1)),
        (4, 33, 1, ms.ScanPlan("cluster", 7, 1)),  # 8 slices of 5 would leave the 8th CTA without a column
        (4, 7, 1, ms.ScanPlan("cluster", 7, 1)),
        (2, 257, 2, ms.ScanPlan("cluster", 8, 1)),
        (2, 512, 1, ms.ScanPlan("cluster", 16, 1)),  # at C=8 a slice and its E take 264 KB
        (8, 640, 1, ms.ScanPlan("cluster", 16, 1)),  # 2 rows a cluster would not fit
        (32, 768, 1, ms.ScanPlan("stream")),  # 305 KB at C=16
        (2, 3072, 1, ms.ScanPlan("stream")),
    ],
)
def test_tv_route_selection(B, S, nA, plan):
    """The route ``plan_scan_tv`` chooses from the shape and the card's
    limits, and that every cluster plan fits the shared memory and the
    kernels' limits, and every streaming plan is forced by them."""
    got = ms.plan_scan_tv(B, S, nA, H100_SMEM, _h100_active_clusters)
    assert got == plan
    if got.route == "cluster":
        assert ms.cluster_takes(S, got.cluster, got.rows)
        assert max(ms.tv_cluster_smem_bytes(S, got.cluster, got.rows, bw) for bw in (False, True)) <= H100_SMEM
    else:
        assert all(ms.tv_cluster_smem_bytes(S, C, 1) > H100_SMEM for C in ms.CLUSTER_SIZES)


def test_tv_cluster_smem_bytes_at_model_1vt():
    """A CTA's shared memory at model_1vt's plan (S=256, C=8, 3 rows): the
    staged slice (256 x 32 floats) and E (256 x 33, padded) beside the carry
    rows, p, hs and the sums (forward) or the exchange buffers (backward)."""
    slices = 8 + 256 * 32 + 256 * 33
    assert ms.tv_cluster_smem_bytes(256, 8, 3) == 4 * (slices + 4 * 3 * 256 + 3 * 256 + 3 * 32 + 24 + 8 + 256 + 32)
    assert ms.tv_cluster_smem_bytes(256, 8, 3, True) == 4 * (slices + 4 * 8 * 3 * 32 + 2 * 3 * 256 + 3 * 3 * 32)


def test_tv_strides_read_a_constant_transition_in_place():
    """A transition constant in time reaches K2g as an ``expand`` with time
    stride 0: the wrapper passes its strides and copies nothing; a tensor
    whose last dim is not contiguous is copied once."""
    base = torch.randn(1, 5, 5)
    A = base.expand(9, 5, 5)
    got, st, sb, sl = ms._tv_strides(A)
    assert got.data_ptr() == base.data_ptr() and (st, sb, sl) == (0, 0, 5)
    per_row = torch.randn(9, 1, 5, 5).expand(9, 3, 5, 5)
    assert ms._tv_strides(per_row)[1:] == (25, 0, 5)
    transposed = torch.randn(9, 5, 5).transpose(-1, -2)
    got, st, sb, sl = ms._tv_strides(transposed)
    assert got.is_contiguous() and (st, sb, sl) == (25, 0, 5)
    torch.testing.assert_close(got, transposed, rtol=0, atol=0)


# -- (b) the emulation of the kernels' form -----------------------------------------------


def _finite(v):
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def _slices(S, C):
    """The CTAs' column slices, C cut as the plan cuts it."""
    W = -(-S // C)
    C = -(-S // W)
    return [(k * W, min(S, (k + 1) * W)) for k in range(C)]


def _parts(S, C):
    """The chunks of l over which a CTA's product parts sum (256 threads,
    one part per W4 of them), as mstvc_forward_kernel cuts S4."""
    W4 = -(-(-(-S // C)) // 4) * 4
    S4 = -(-S // 4) * 4
    nparts = 256 // W4
    chunk = -(-(-(-S4 // nparts)) // 4) * 4
    return [(min(S4, q * chunk), min(S, min(S4, q * chunk) + chunk)) for q in range(nparts)]


def _per_row(At, B):
    return At if At.ndim == 3 else At.expand(B, *At.shape)


def emulate_forward(alpha0, A, R, L=None, C=8, exact=True):
    """alpha_T and the stacks hs, o (T, B, S) and c (T, B, S), in float32 as
    mstvc_forward_kernel computes them; ``exact=False`` leaves out the exact
    recomputation of the columns with z < 2^-60."""
    T, B, S = R.shape
    alpha = alpha0
    norm = torch.zeros(B, 1, dtype=torch.float64)
    hs_st, o_st, c_st = [], [], []
    for t in range(T):
        At = _per_row(A[t], B)  # (B, l, r)
        h = alpha if L is None else alpha + L[t]
        m = _finite(h.amax(-1, keepdim=True))
        hs = h - m
        p = torch.exp(hs)
        c = At.amax(-2)  # raw column maxima, -inf for a column of -inf
        E = torch.exp(At - _finite(c)[:, None, :])
        # each CTA's columns, its product's parts added in order
        z = torch.zeros(B, S)
        for lo, hi in _parts(S, C):
            z = z + torch.cat([torch.einsum("bl,blr->br", p[:, lo:hi], E[:, lo:hi, a:b]) for a, b in _slices(S, C)], -1)
        o = torch.log(z) + c
        if exact:
            o = torch.where(z >= TAU, o, torch.logsumexp(hs[:, :, None] + At, 1))
        o = torch.where(c == -torch.inf, -torch.inf, o)
        alpha = o + R[t]
        norm = norm + m.double()
        hs_st.append(hs)
        o_st.append(o)
        c_st.append(c)
    out = (alpha.double() + norm).float()
    return out, torch.stack(hs_st), torch.stack(o_st), torch.stack(c_st)


def emulate_backward(A, L, hs, os, cs, g, C=8):
    """dalpha0, dA (A's shape), dR and dL as mstvc_stats_kernel,
    mstvc_backward_kernel and mstvc_fold_kernel compute them, in float32."""
    T, B, S = hs.shape
    # the classes and factors of each row (t, b)
    e = cs - os
    class0 = torch.isfinite(cs) & torch.isfinite(os) & (e <= LOG_TAU)
    class1 = ~class0 & (os > -torch.inf)
    cr = _finite(torch.where(class0, e, -torch.inf).amax(-1, keepdim=True))
    F0 = torch.where(class0, torch.exp(e - cr), torch.zeros_like(e))
    X1 = torch.where(class1, os, torch.full_like(os, torch.inf))
    P0 = torch.exp(hs + cr)
    dR = torch.empty(T, B, S)
    dL = torch.empty(T, B, S)
    dA = torch.empty(A.shape)
    for t in reversed(range(T)):
        At = _per_row(A[t], B)
        E = torch.exp(At - _finite(cs[t])[:, None, :])
        dR[t] = g
        u0 = g * F0[t]
        # exact class-1 weights times g, -inf terms 0
        w1 = torch.where(class1[t][:, None, :], torch.exp(hs[t][:, :, None] + At - X1[t][:, None, :]), 0.0)
        g1 = w1 * g[:, None, :]
        # each CTA's partials over its own columns, added in rank order
        rx0 = torch.zeros(B, S)
        rx1 = torch.zeros(B, S)
        for lo, hi in _slices(S, C):
            rx0 = rx0 + torch.einsum("blr,br->bl", E[:, :, lo:hi], u0[:, lo:hi])
            rx1 = rx1 + g1[:, :, lo:hi].sum(-1)
        dh = P0[t] * rx0 + rx1
        dL[t] = dh
        # the fold: E times the (S x B) by (B x S) product, plus class 1
        fold = E * torch.einsum("bl,br->blr", P0[t], dR[t] * F0[t])
        if A.ndim == 3:
            dA[t] = fold.sum(0) + g1.sum(0)
        else:
            dA[t] = fold + g1
        g = dh
    return g, dA, dR, (None if L is None else dL)


def _emulate(inputs, g, C):
    """out and the four gradients of sum(out * g)."""
    alpha0, A, R, L = (None if x is None else torch.as_tensor(x, dtype=torch.float32) for x in inputs)
    out, hs, os, cs = emulate_forward(alpha0, A, R, L, C)
    grads = emulate_backward(A, L, hs, os, cs, torch.as_tensor(g, dtype=torch.float32), C)
    return out.numpy(), [None if x is None else x.numpy() for x in grads]


def _check(out, grads, out64, grads64):
    """-inf where float64's is, finite values within atol 1e-4 + rtol 1e-6,
    each gradient finite and within K2G_TOL * max|grad| of float64's."""
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(out64))
    live = np.isfinite(out64)
    np.testing.assert_allclose(out[live], out64[live], rtol=1e-6, atol=1e-4)
    for name, a, e in zip(("alpha0", "A", "R", "L"), grads, grads64):
        if e is None:
            continue
        assert np.isfinite(a).all(), name
        err = np.abs(a.astype(np.float64) - e).max() / (np.abs(e).max() + 1e-30)
        assert err <= K2G_TOL, f"d{name}: {err:.3g} * max|grad| from float64"


def _log_transitions(rng, shape):
    A = rng.normal(size=shape) * 2
    return A - np.log(np.exp(A).sum(-1, keepdims=True))


def _jax_general_body64(inputs, g):
    """out and the gradients of sum(out * g) through the JAX package's
    general body in float64."""
    alpha0, A, R, L = inputs
    T, B, S = R.shape
    keys = [k for k, v in zip(("alpha0", "A", "R", "L"), inputs) if v is not None]
    a_dims = "tblr" if A.ndim == 4 else "tlr"

    def f(*args):
        v = dict(zip(keys, args))
        reduced = [jpacked.PackedTensor(v["A"], a_dims), jpacked.PackedTensor(v["R"], "tbr")]
        if "L" in v:
            reduced.append(jpacked.PackedTensor(v["L"], "tbl"))
        log_factors = OrderedDict([(frozenset("b"), [jpacked.PackedTensor(v["alpha0"], "bx")])])
        assert jmp._try_scan_elimination(log_factors, {"x", "l", "r"}, reduced, "x", "l", "r", S, "t",
                                         frozenset("b"), {"b": B, "t": T})
        (term,) = log_factors[frozenset("b")]
        return (term.value * jnp.asarray(g, dtype=jnp.float64)).sum(), term.value

    with jax.enable_x64(True):
        args = [jnp.asarray(x, dtype=jnp.float64) for x in inputs if x is not None]
        (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(keys))), has_aux=True))(*args)
        grads = dict(zip(keys, (np.asarray(x) for x in grads)))
        return np.asarray(out), [grads.get(k) for k in ("alpha0", "A", "R", "L")]


@pytest.mark.parametrize("with_L", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("S", [7, 33, 64, 257])
def test_form_matches_jax_general_body_float64(S, per_row, with_L):
    rng = np.random.default_rng(S + 10 * per_row + 100 * with_L)
    B, T = 3, 6
    inputs = [
        rng.normal(size=(B, S)),
        _log_transitions(rng, (T, B, S, S) if per_row else (T, S, S)),
        rng.normal(size=(T, B, S)),
        rng.normal(size=(T, B, S)) if with_L else None,
    ]
    inputs = [None if x is None else x.astype(np.float32).astype(np.float64) for x in inputs]
    g = rng.normal(size=(B, S)).astype(np.float32)
    out, grads = _emulate(inputs, g, C=8)
    _check(out, grads, *_jax_general_body64(inputs, g))


def _plain64(inputs, g):
    leaves = [None if x is None else torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in inputs]
    out = ms.markov_scan_tv_plain(*leaves)
    (out * torch.as_tensor(g, dtype=torch.float64)).sum().backward()
    return out.detach().numpy(), [None if x is None else x.grad.numpy() for x in leaves]


def tv_inputs(rng, B, T, S, per_row=False, with_L=False, unreachable=False, emission=0.0):
    """The data of chip_smoke.py::tv_inputs, from numpy: log transition
    probabilities; with ``unreachable``, -inf entries, a column no state
    reaches at every third step and half of alpha0's states -inf."""
    A = _log_transitions(rng, (T, B, S, S) if per_row else (T, S, S))
    alpha0 = rng.normal(size=(B, S))
    if unreachable:
        A[A < -6.0] = -np.inf
        A[::3, ..., :, S // 3] = -np.inf
        alpha0[:, S // 2:] = -np.inf
    R = rng.normal(size=(T, B, S)) * (3.0 if emission else 1.0) + emission
    L = rng.normal(size=(T, B, S)) if with_L else None
    inputs = [None if x is None else x.astype(np.float32) for x in (alpha0, A, R, L)]
    return inputs, rng.normal(size=(B, S)).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("per_row", [False, True])
def test_form_unreachable_states_match_plain_float64(seed, per_row):
    """-inf entries, columns no state reaches and -inf states of alpha0 over
    64 steps of emissions about -35 (the last step's column 21 unreachable):
    -inf exactly where float64's plain version has it, gradients 0 through
    them and within the bar elsewhere."""
    inputs, g = tv_inputs(np.random.default_rng(1200 + seed), 8, 64, 64, per_row, unreachable=True, emission=-35.0)
    out, grads = _emulate(inputs, g, C=8)
    out64, grads64 = _plain64(inputs, g)
    assert np.isneginf(out).any()
    _check(out, grads, out64, grads64)
    assert (grads[1][np.isneginf(inputs[1])] == 0).all()


def underflow_inputs(rng, B, T, S, per_row=False):
    """Data on which the factored sum is 0 at the even columns of every
    step while the true value is finite: hs peaks at l = 0 (R keeps state
    0 about 200 above the others), and A_t[0, r] is about -200 at the even
    columns r while the other l have log-weights of order 1 there, so
    p[l] E[l, r] underflows at every l; the odd columns keep a factored sum
    of order 1 through A_t[0, r]."""
    A = rng.normal(size=(T, B, S, S) if per_row else (T, S, S)) * 2.0
    A[..., 0, 0::2] = -200.0 + rng.normal(size=A[..., 0, 0::2].shape)
    R = rng.normal(size=(T, B, S))
    R[..., 1::2] -= 400.0
    R[..., 2::2] -= 200.0
    alpha0 = rng.normal(size=(B, S)) - 200.0
    alpha0[:, 0] = 0.0
    inputs = [x.astype(np.float32) for x in (alpha0, A, R)] + [None]
    return inputs, rng.normal(size=(B, S)).astype(np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_form_underflow_case_needs_the_exact_recomputation(per_row):
    """hs and A_t peak at different l: at the even columns z = 0 while
    logsumexp(hs + A_t) is finite.  The emulation matches float64 (class 1,
    exact weights, beside class 0 in every row); without the exact
    recomputation its forward is -inf there, and fails."""
    B, T, S = 4, 9, 64
    inputs, g = underflow_inputs(np.random.default_rng(7 + per_row), B, T, S, per_row)
    alpha0, A, R = (torch.as_tensor(x) for x in inputs[:3])
    _, hs, os, cs = emulate_forward(alpha0, A, R)
    z = torch.exp(os - cs)
    assert bool((z[:, :, 0::2] < TAU).all()) and bool((z[:, :, 1::2] >= TAU).all())
    out, grads = _emulate(inputs, g, C=8)
    out64, grads64 = _plain64(inputs, g)
    assert np.isfinite(out64).all()
    _check(out, grads, out64, grads64)
    factored = emulate_forward(alpha0, A, R, exact=False)[0].numpy()
    assert np.isneginf(factored).any()
