"""The port's kernel Functions under ``torch.func``, on the CPU.

HMC and NUTS take the potential's gradient over the chains as
``vmap(grad_and_value(potential))``; every custom ``autograd.Function`` of
the port (K1, K2, K2g, K4a-c, K5) must run under those transforms and reach
its implementation with plain tensors, on which a kernel can launch.

- K1's plain route and the K4 levels (which run through their Functions on
  every device) against ``jax.vmap(jax.grad(...))`` of the JAX functions.
- The CUDA Functions' vmap rules, with the launches replaced by CPU
  stand-ins that refuse a batched or grad-tracking tensor (as a ctypes
  launch on its ``data_ptr`` would) and compute the plain values: against
  the plain version under the same transforms, per example.

Tolerances: float32 K1 values and gradients rtol 1e-5 with atol 1e-5 *
max|expected|; float64 comparisons rtol 1e-9 (the K4 levels against JAX
rtol 1e-8, the same arithmetic in a different order); the stand-in
routes, which run the plain arithmetic on folded tensors, rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor

import pyro_tpu_torch as pyro
from pyro_tpu.ops import gaussian as jg
from pyro_tpu.ops import log_matmul as jlm
from pyro_tpu_torch.ops import gaussian as tg
from pyro_tpu_torch.ops import gaussian_levels as gl
from pyro_tpu_torch.ops import log_matmul as lm
from pyro_tpu_torch.ops import markov_scan as ms

vmap, grad = torch.func.vmap, torch.func.grad


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _close(actual, expected, rtol, atol_scale=0.0):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol_scale * np.abs(expected).max())


def _plain(*tensors):
    """What a launch needs: plain tensors with storage."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            assert not is_batchedtensor(t) and not is_gradtrackingtensor(t)
            t.data_ptr()


# -- K1 under vmap(grad) against JAX -------------------------------------------------

# (x shape, y shape, x mapped, y mapped): the chain dim C=4 leads a mapped operand
K1_CASES = {
    "x-mapped": ((3, 5), (5, 4), True, False),
    "y-mapped": ((3, 5), (5, 4), False, True),
    "both-batched": ((2, 3, 5), (5, 4), True, True),
    "y-batched-unmapped": ((3, 5), (2, 5, 4), True, False),
    "x-batched-unmapped": ((6, 1, 3, 5), (2, 5, 4), False, True),
}


def _k1_inputs(name):
    xs, ys, xm, ym = K1_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(((4,) if xm else ()) + xs).astype(np.float32)
    y = rng.standard_normal(((4,) if ym else ()) + ys).astype(np.float32)
    batch = np.broadcast_shapes(xs[:-2], ys[:-2]) + (xs[-2], ys[-1])
    w = rng.standard_normal((4,) + batch).astype(np.float32)
    return x, y, w, (0 if xm else None, 0 if ym else None, 0)


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_vmap_grad_matches_jax(name):
    x, y, w, in_dims = _k1_inputs(name)

    def t_loss(x, y, w):
        return (lm.logmatmulexp(x, y) * w).sum()

    def j_loss(x, y, w):
        return (jlm.logmatmulexp(x, y) * w).sum()

    got = vmap(torch.func.grad_and_value(t_loss, argnums=(0, 1)), in_dims=in_dims)(*map(torch.tensor, (x, y, w)))
    expected = jax.vmap(jax.value_and_grad(j_loss, argnums=(0, 1)), in_axes=in_dims)(*map(jnp.asarray, (x, y, w)))
    _close(got[1].numpy(), expected[0], 1e-5, 1e-5)
    for a, e in zip(got[0], expected[1]):
        _close(a.numpy(), e, 1e-5, 1e-5)


def _k1_fake_route():
    """K1's Function pair built by the factory the CUDA route uses, over
    stand-ins with the kernels' interface: the forward gives (out, row
    maxima of x, column maxima of y), the backward takes them back."""
    seen = {"forward": [], "backward": []}

    def forward(x, y):
        _plain(x, y)
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        lm._kernel_layout(batch, list(lm._unit_columns([x, y], "forward")), "forward")
        seen["forward"].append((tuple(x.shape), tuple(y.shape)))
        out = lm._logmatmulexp_raw(x, y)
        return out, x.amax(-1).expand(batch + x.shape[-2:-1]), y.amax(-2).expand(batch + y.shape[-1:])

    def backward(x, y, out, xs, ys, g):
        _plain(x, y, out, xs, ys, g)
        assert xs.shape == out.shape[:-1] and ys.shape == out.shape[:-2] + out.shape[-1:]
        lm._kernel_layout(out.shape[:-2], list(lm._unit_columns([x, y, out, g], "backward")), "backward")
        seen["backward"].append((tuple(x.shape), tuple(y.shape)))
        return lm._logmatmulexp_bwd(x, y, out, g)

    Forward, _ = lm._functions(forward, backward, "stand-in")
    return Forward, seen


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_route_vmap_rules_fold_the_chains(name):
    """The CUDA route's Functions under vmap(grad): one forward and one
    backward call at the folded shapes, the chains leading the batch; an
    operand without the chain dim is not expanded in the forward."""
    x, y, w, in_dims = _k1_inputs(name)
    Forward, seen = _k1_fake_route()

    def loss(fn):
        return lambda x, y, w: (fn(x, y) * w).sum()

    args = tuple(torch.tensor(a, dtype=torch.float64) for a in (x, y, w))
    got = vmap(grad(loss(lambda a, b: Forward.apply(a, b)[0]), argnums=(0, 1)), in_dims=in_dims)(*args)
    expected = vmap(grad(loss(lm.logmatmulexp_plain), argnums=(0, 1)), in_dims=in_dims)(*args)
    for a, e in zip(got, expected):
        _close(a.numpy(), e.numpy(), 1e-9)
    assert len(seen["forward"]) == len(seen["backward"]) == 1
    (fx, fy), = seen["forward"]
    assert (fx[0] == 4) == (in_dims[0] == 0) and (fy[0] == 4) == (in_dims[1] == 0)
    if in_dims[0] is None:
        assert fx == x.shape
    if in_dims[1] is None:
        assert fy == y.shape


def test_k1_route_without_transforms_is_one_launch_each_way():
    Forward, seen = _k1_fake_route()
    x, y = (torch.randn(3, 5, dtype=torch.float64, requires_grad=True),
            torch.randn(2, 5, 4, dtype=torch.float64, requires_grad=True))
    Forward.apply(x, y)[0].sum().backward()
    x2, y2 = x.detach().requires_grad_(), y.detach().requires_grad_()
    lm.logmatmulexp_plain(x2, y2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-12, atol=0)
    torch.testing.assert_close(y.grad, y2.grad, rtol=1e-12, atol=0)
    assert seen == {"forward": [((3, 5), (2, 5, 4))], "backward": [((3, 5), (2, 5, 4))]}


def test_k1_nested_vmap_recurses():
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64)
    y = torch.randn(3, 5, 6, dtype=torch.float64)

    def f(x, y):
        return lm.logmatmulexp_plain(x, y).logsumexp((-1, -2))

    got = vmap(vmap(grad(f, argnums=(0, 1))), in_dims=(0, None))(x, y)
    for i in range(2):
        for j in range(3):
            expected = torch.func.grad(f, argnums=(0, 1))(x[i, j], y[j])
            torch.testing.assert_close(got[0][i, j], expected[0], rtol=1e-12, atol=1e-14)
            torch.testing.assert_close(got[1][i, j], expected[1], rtol=1e-12, atol=1e-14)


def test_k1_layout_copies_a_vmapped_operand_past_three_strided_dims():
    """A vmapped operand's stride-0 dims can leave more than three strided
    batch dims; the kernel's operands are then copied whole, and counted."""
    x = torch.zeros(2, 2, 2, 2, 4, 4).permute(3, 2, 1, 0, 4, 5)
    y = torch.zeros(2, 2, 2, 2, 4, 4)
    before = lm.copies["forward"]
    (xc, yc), (sizes, _) = lm._kernel_layout(x.shape[:-2], [x, y], "forward")
    assert xc.is_contiguous() and yc.is_contiguous() and sum(n != 1 for n in sizes) == 1
    assert lm.copies["forward"] == before + 2


# -- the K4 levels under grad and vmap(grad) against JAX, in float64 -------------------


def _spd(rng, shape, n):
    M = rng.standard_normal(tuple(shape) + (n, n))
    return M @ np.swapaxes(M, -1, -2) / n + np.eye(n)


@pytest.mark.parametrize("homogeneous", [False, True], ids=["contract_pairs", "halving_level"])
def test_k4_levels_vmap_grad_match_jax_in_float64(homogeneous):
    """The gradient, by chain, of the time contraction's log normaliser
    (its levels: contract_pairs, or halving_level) against JAX's autodiff
    of the same contraction; P given per chain."""
    C, R, T, n = 3, 2, 13, 2
    rng = np.random.default_rng(5 + homogeneous)
    P = _spd(rng, (C,) if homogeneous else (C, R, T), 2 * n)
    info = rng.standard_normal((C, R, T, 2 * n))
    logZ = rng.standard_normal((C, R, T))
    t_fn = tg.sequential_gaussian_tensordot_homogeneous if homogeneous else tg.sequential_gaussian_tensordot
    j_fn = jg.sequential_gaussian_tensordot_homogeneous if homogeneous else jg.sequential_gaussian_tensordot

    def t_loss(lz, iv, p):
        out = t_fn(tg.Gaussian(lz, iv, p))
        return out.log_normalizer.sum() + (out.info_vec ** 2).sum()

    def j_loss(lz, iv, p):
        out = j_fn(jg.Gaussian(lz, iv, p))
        return out.log_normalizer.sum() + (out.info_vec ** 2).sum()

    got = vmap(torch.func.grad_and_value(t_loss, argnums=(0, 1, 2)))(*map(torch.tensor, (logZ, info, P)))
    with jax.enable_x64(True):
        expected = jax.jit(jax.vmap(jax.value_and_grad(j_loss, argnums=(0, 1, 2))))(
            *map(jnp.asarray, (logZ, info, P)))
        expected = jax.tree.map(np.asarray, expected)
    _close(got[1].numpy(), expected[0], 1e-8)
    _close(got[0][0].numpy(), expected[1][0], 1e-8, 1e-12)
    _close(got[0][1].numpy(), expected[1][1], 1e-8, 1e-12)
    sym = lambda g: 0.5 * (g + np.swapaxes(g, -1, -2))  # noqa: E731
    _close(sym(got[0][2].numpy()), sym(expected[1][2]), 1e-8, 1e-12)
    # the same gradient without vmap, chain by chain
    for c in range(C):
        one = grad(t_loss, argnums=2)(*(torch.tensor(a[c]) for a in (logZ, info, P)))
        torch.testing.assert_close(one, got[0][2][c], rtol=1e-12, atol=1e-14)


def test_k4_contract_vmap_folds_the_chains_into_rows(monkeypatch):
    """contract_pairs under vmap(grad): one forward and one backward call a
    level, on plain tensors with the chains as leading rows; an operand
    with no chain dim is read through a stride-0 view."""
    calls = []
    fwd, bwd = gl.contract_pairs_plain, gl.contract_pairs_bwd_plain

    def forward(P, info, logZ, tape=False):
        _plain(P, info, logZ)
        calls.append(("forward", P.shape[:-3], P.stride()[0]))
        return fwd(P, info, logZ, tape)

    def backward(t, *args):
        _plain(*args)
        calls.append(("backward", args[0].shape[0], None))
        return bwd(t, *args)

    monkeypatch.setattr(gl, "contract_pairs_plain", forward)
    monkeypatch.setattr(gl, "contract_pairs_bwd_plain", backward)
    rng = np.random.default_rng(2)
    P = torch.tensor(_spd(rng, (2, 6), 4))  # shared by the chains
    info = torch.tensor(rng.standard_normal((3, 2, 6, 4)))

    def loss(info):
        P_out, info_out, logZ_out, _ = gl.contract_pairs(P, info, torch.zeros(2, 6, dtype=P.dtype))
        return logZ_out.sum() + (info_out ** 2).sum()

    got = vmap(grad(loss))(info)
    assert calls == [("forward", (3, 2), 0), ("backward", 6, None)]
    for c in range(3):
        torch.testing.assert_close(got[c], grad(loss)(info[c]), rtol=1e-12, atol=1e-14)


# -- the CUDA Functions' vmap rules, with CPU stand-ins for the launches ---------------


def _scan_stand_ins(monkeypatch, tv):
    """Stand-ins for K2's (or K2g's) launches: the forward keeps alpha0 and
    R where the kernel keeps its carry stack, the backward differentiates
    the plain scan.  Records the rows of each call."""
    plain = ms.markov_scan_tv_plain if tv else ms.markov_scan_plain
    calls = []

    def forward(alpha0, A, R, L=None, plan=None):
        _plain(alpha0, A, R, L)
        (ms._check_tv_shapes if tv else ms._check_shapes)(alpha0, A, R, L)
        calls.append(("forward", alpha0.shape[0], A.ndim))
        out = plain(alpha0, A, R, L)
        stack = alpha0.expand(R.shape)
        if tv:
            return out, (plan, R.clone(), stack.clone(), A.amax(-2).reshape(R.shape[0], -1, R.shape[-1]))
        return out, (plan, R.clone(), stack.clone(), A.reshape(-1, *A.shape[-2:]).amax(-2), None, None)

    def backward(A, L, saved, g):
        R, stack = saved[1], saved[2]
        _plain(A, L, R, stack, g)
        assert saved[0] == ms.ScanPlan("cluster", 8, 1)
        calls.append(("backward", g.shape[0], A.ndim))
        leaves = [t.detach().requires_grad_() for t in (stack[0], A, R)]
        Ld = None if L is None else L.detach().requires_grad_()
        with torch.enable_grad():
            out = plain(*leaves, Ld)
            grads = torch.autograd.grad(out, leaves + ([Ld] if Ld is not None else []), g)
        return grads[0], grads[1], grads[2], (grads[3] if Ld is not None else None)

    prefix = "_tv" if tv else ""
    monkeypatch.setattr(ms, f"{prefix}_forward_cuda", forward)
    monkeypatch.setattr(ms, f"{prefix}_backward_cuda", backward)
    monkeypatch.setattr(ms, "_device_plan_tv" if tv else "_device_plan", lambda *a: ms.ScanPlan("cluster", 8, 1))
    return calls


SCAN_CASES = ["A-mapped", "A-shared", "A-per-row-mapped", "with-L", "A-shared-grad-A"]


@pytest.mark.parametrize("tv", [False, True], ids=["K2", "K2g"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_functions_vmap_rules(monkeypatch, tv, case):
    calls = _scan_stand_ins(monkeypatch, tv)
    C, T, B, S = 3, 4, 2, 5
    rng = np.random.default_rng(len(case) + 10 * tv)
    a_shape = ((T,) if tv else ()) + ((B,) if case == "A-per-row-mapped" else ()) + (S, S)
    A_mapped = case in ("A-mapped", "A-per-row-mapped", "with-L")
    A = torch.tensor(rng.standard_normal(((C,) if A_mapped else ()) + a_shape))
    alpha0 = torch.tensor(rng.standard_normal((C, B, S)))
    R = torch.tensor(rng.standard_normal((C, T, B, S)))
    L = torch.tensor(rng.standard_normal((C, T, B, S))) if case == "with-L" else None
    Fn = ms._MarkovScanTVCUDA if tv else ms._MarkovScanCUDA
    plain = ms.markov_scan_tv_plain if tv else ms.markov_scan_plain

    def loss(fn):
        def f(alpha0, A, R, L=None):
            out = fn(alpha0, A, R, L)
            return (out * torch.linspace(0.5, 1.5, S, dtype=out.dtype)).logsumexp(-1).sum()
        return f

    argnums = (1,) if case == "A-shared-grad-A" else (0, 1, 2) + ((3,) if L is not None else ())
    in_dims = (0, 0 if A_mapped else None, 0, None if L is None else 0)
    kernel = loss(lambda *a: Fn.apply(*a, None)[0])
    got = vmap(grad(kernel, argnums=argnums), in_dims=in_dims)(alpha0, A, R, L)
    expected = vmap(grad(loss(plain), argnums=argnums), in_dims=in_dims)(alpha0, A, R, L)
    for a, e in zip(got, expected):
        assert a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-9)
    forwards = [c for c in calls if c[0] == "forward"]
    backwards = [c for c in calls if c[0] == "backward"]
    # a chain's A becomes one A a row of its B rows; a shared A stays shared
    assert forwards == [("forward", C * B, len(a_shape) + (A_mapped and case != "A-per-row-mapped"))]
    # a shared A's gradient is each chain's own: one backward a chain
    shared = not A_mapped
    assert len(backwards) == (C if shared else 1)
    assert all(rows == (B if shared else C * B) for _, rows, _ in backwards)


def test_mids_and_gamma_functions_vmap_once_an_example(monkeypatch):
    """K4c's and K5's Functions (forward only) under vmap: one launch an
    example, on plain tensors."""
    calls = []

    def mids(*args):
        _plain(*args)
        calls.append("mids")
        return gl.level_mids_plain(*args)

    monkeypatch.setattr(gl, "_mids_cuda", mids)
    rng = np.random.default_rng(4)
    C, D, R, m, Np, n = 3, 2, 2, 5, 3, 2
    cur = torch.tensor(rng.standard_normal((C, D, R, m, n)))
    L = torch.tensor(np.linalg.cholesky(_spd(rng, (R, Np), n)))
    P_mk = torch.tensor(rng.standard_normal((R, Np, n, 2 * n)))
    i_m = torch.tensor(rng.standard_normal((R, Np, n)))
    eps = torch.tensor(rng.standard_normal((D, R, Np, n)))
    got = vmap(lambda c: gl._MidsCUDA.apply(c, L, P_mk, i_m, eps))(cur)
    for c in range(C):
        torch.testing.assert_close(got[c], gl.level_mids_plain(cur[c], L, P_mk, i_m, eps), rtol=1e-12, atol=0)
    assert calls == ["mids"] * C

    def gamma(*args):
        _plain(*args)
        calls.append("gamma")
        return gl.gamma_contract_pairs_plain(*args)

    P = torch.tensor(_spd(rng, (C, 1, 4), 2 * n))
    info, logZ = torch.tensor(rng.standard_normal((1, 4, 2 * n))), torch.zeros(1, 4, dtype=P.dtype)
    alpha, beta = torch.full((1, 4), 2.0, dtype=P.dtype), torch.full((1, 4), 3.0, dtype=P.dtype)
    got = vmap(lambda p: gl._GammaLevelCUDA.apply("gamma_contract_pairs", gamma, p, info, logZ, alpha, beta))(P)
    for c in range(C):
        for a, e in zip(got, gl.gamma_contract_pairs_plain(P[c], info, logZ, alpha, beta)):
            torch.testing.assert_close(a[c], e, rtol=1e-12, atol=0)
    assert calls[C:] == ["gamma"] * C


def test_no_function_of_the_port_refuses_the_transforms():
    """Each custom Function of the port is in the new form, with a vmap rule."""
    functions = [lm._LogMatMulExpPlain, lm._LogMatMulExpPlainBackward, lm._LogMatMulExpCUDA,
                 lm._LogMatMulExpCUDABackward, ms._MarkovScanCUDA, ms._MarkovScanBackward, ms._MarkovScanTVCUDA,
                 ms._MarkovScanTVBackward, gl._Halving, gl._HalvingBackward, gl._Contract, gl._ContractBackward,
                 gl._MidsCUDA, gl._GammaLevelCUDA]
    for fn in functions:
        assert fn.setup_context is not torch.autograd.Function.setup_context, fn
        assert fn.vmap is not torch.autograd.Function.vmap, fn
