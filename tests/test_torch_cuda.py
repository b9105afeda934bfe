"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip elsewhere.  They import neither JAX nor
the JAX package, so on a machine without JAX run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 forward atol 1e-4 on log values; gradients rtol 1e-4 with
atol 1e-5 * max|g| (the kernel sums in another order than cuBLAS, and its
3xTF32 products round like float32); with entries clipped at FLT_MIN, the
gradients within 1e-3 * max|grad| of the float64 direct form.  K2,
the Markov-chain scan: forward atol 1e-4 plus rtol 1e-6 (the carry grows
like T times the emission scale, and float32 rounds it at that size);
gradients as K1's over a few steps, and rtol 1e-3 with atol 1e-4 times the
gradient's largest entry over the main path's 127 dependent steps, where
the plain version's own float32 gradient was about 7e-4 of that from
float64's before the carry was kept shifted, and is about 1e-5 since
(``chip_smoke.py`` prints both distances); the two routes of K2
against each other as each against the plain version.  K2's cases run on
the route the wrapper chooses, which they check, unless a test names one.
K4, the Gaussian halving levels: each kernel within rtol 1e-4 plus atol
1e-4 times the largest entry of its plain version's output, forward and
backward (the P gradients symmetrised), and K4a's backward also against
the float64 plain version within 1e-4 times the largest entry of each
output; GaussianHMM on the card against
the port's float64 CPU run, log_prob rtol 1e-4 with atol 1e-3, the
filter's mean and the posterior mean rtol and atol 1e-3; a training step's
loss rtol 1e-5 and gradients within 1e-3 times their largest entry (also
an IndependentMaternGP step at the EEG shape, 14 channels of 14,980 steps,
with K4a and K4b held at the GP models' state dims n = 1, 2 and 28).  K5,
the gamma-Gaussian levels, as K4, with alpha' exact; GammaGaussianHMM on the
card against the port's float64 CPU run, log_prob rtol 1e-4 with atol 1e-3,
the filter's Gamma rtol 1e-4 and its mean and covariance rtol and atol
1e-3.  K2g,
the time-varying scan: -inf exactly where the float64 plain version has
it, finite values within atol 1e-4 plus rtol 1e-6 of it, each gradient
within 1e-4 (a few steps) or 1e-3 (127 dependent steps, or unreachable
states) times its largest entry of float64's, on both of its routes (the
cluster route the wrapper's choice at every case that it takes, the
streaming route forced), with a built underflow case and a transition read
in place with time stride 0; model_1vt's step as a
training step's; the pairwise fallback's loss rtol 1e-5 and gradients rtol
1e-4 with atol 1e-5 times their largest entry of the float64 CPU run's.
K3f, the chain of small log-space factors: -inf exactly where its plain
version has it, finite values within 1e-5 * max|out| + 1e-5, gradients
within 1e-4 * max|grad| (the same sums in another order), two launches
bit-equal; the quantized SIR potential on the card against the port's
float64 CPU run within 1e-5 of its value and its gradient within 1e-3 *
max|grad| (float32 rounds the spline logits and the chain's sums).
"""

import numpy as np
import pytest
import torch

from pyro_tpu_torch.ops import log_matmul as lm
from pyro_tpu_torch.ops import markov_scan as ms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(x, y, g):
    xk = x.clone().requires_grad_()
    yk = y.clone().requires_grad_()
    xp = x.clone().requires_grad_()
    yp = y.clone().requires_grad_()
    out_k = lm.logmatmulexp(xk, yk)
    out_p = lm.logmatmulexp_plain(xp, yp)
    (out_k * g).sum().backward()
    (out_p * g).sum().backward()
    torch.cuda.synchronize()
    atol = 1e-5 * g.abs().max().item()
    assert torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-4, atol=atol)
    torch.testing.assert_close(yk.grad, yp.grad, rtol=1e-4, atol=atol)


@pytest.mark.parametrize(
    "xshape,yshape",
    [
        ((8, 16), (16, 8)),
        ((3, 37, 129), (1, 129, 61)),
        ((37, 129), (5, 129, 61)),
        ((2, 3, 70, 65), (3, 65, 66)),
        ((16, 128, 128), (16, 128, 128)),
        ((5, 100, 68), (5, 68, 132)),  # 16-byte copies, partial slabs and tiles
        ((2, 7, 12), (2, 12, 9)),  # K a multiple of 4 but not of 8, N not of 4
    ],
)
def test_kernel_matches_plain(cuda, xshape, yshape):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=xshape) * 3, dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.normal(size=yshape) * 3, dtype=torch.float32, device=cuda)
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    g = torch.tensor(rng.normal(size=batch + (xshape[-2], yshape[-1])), dtype=torch.float32, device=cuda)
    n = lm.launches["forward"], lm.launches["backward"]
    _compare(x, y, g)
    assert (lm.launches["forward"], lm.launches["backward"]) == (n[0] + 1, n[1] + 1)


@pytest.mark.parametrize("time", [12, 13])
def test_kernel_on_strided_halves(cuda, time):
    """The time-paired halves of a (B, T, S, S) chain are strided views."""
    rng = np.random.default_rng(1)
    logits = torch.tensor(rng.normal(size=(3, time, 24, 24)), dtype=torch.float32, device=cuda)
    even = time // 2 * 2
    x_y = logits[..., :even, :, :].reshape(3, even // 2, 2, 24, 24)
    x, y = x_y[..., 0, :, :], x_y[..., 1, :, :]
    assert not x.is_contiguous()
    g = torch.tensor(rng.normal(size=(3, even // 2, 24, 24)), dtype=torch.float32, device=cuda)
    before = dict(lm.copies)
    _compare(x, y, g)
    assert lm.copies == before


def test_kernel_copies_an_operand_with_strided_columns(cuda):
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(40, 33)), dtype=torch.float32, device=cuda).T  # (33, 40), column stride 33
    y = torch.tensor(rng.normal(size=(40, 17)), dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.normal(size=(33, 17)), dtype=torch.float32, device=cuda)
    before = lm.copies["forward"]
    _compare(x, y, g)
    assert lm.copies["forward"] == before + 1


def test_kernel_clipped_entries_match_float64(cuda):
    """Half the rows of x have their support in the first quarter of k, from
    which y reaches no column of the last quarter, so their z is 0 there
    (clipped at FLT_MIN): the gradients within 1e-3 * max|grad| of the
    direct form dx[i,k] = sum_j g exp(x[i,k] + y[k,j] - out[i,j]) in float64
    with the kernel's own out (and dy likewise)."""
    n, S = 64, 256
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, S, S)) * 2
    y = rng.normal(size=(n, S, S)) * 2
    x[:, : S // 2, S // 4:] = -np.inf
    y[:, : S // 4, 3 * S // 4:] = -np.inf
    g = torch.tensor(rng.normal(size=(n, S, S)), dtype=torch.float32, device=cuda)
    xk = torch.tensor(x, dtype=torch.float32, device=cuda, requires_grad=True)
    yk = torch.tensor(y, dtype=torch.float32, device=cuda, requires_grad=True)
    out = lm.logmatmulexp(xk, yk)
    (out * g).sum().backward()
    assert (out < -80).any()
    x64, y64, out64 = xk.detach().double(), yk.detach().double(), out.detach().double()
    xs = torch.nan_to_num(x64.amax(-1, keepdim=True), neginf=0.0)
    ys = torch.nan_to_num(y64.amax(-2, keepdim=True), neginf=0.0)
    P, Q = torch.exp(x64 - xs), torch.exp(y64 - ys)
    W = g.double() * torch.exp(-(out64 - xs - ys))
    for got, want in ((xk.grad, P * (W @ Q.transpose(-1, -2))), (yk.grad, Q * (P.transpose(-1, -2) @ W))):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-3 * want.abs().max().item())


def test_kernel_neg_inf_and_underflow(cuda):
    x = torch.full((4, 8), -300.0, device=cuda)
    x[:, 0] = 0.0
    y = torch.full((8, 8), -200.0, device=cuda)
    y[1:, :] = -1.0
    g = torch.tensor(np.random.default_rng(7).normal(size=(4, 8)) * 5, dtype=torch.float32, device=cuda)
    _compare(x, y, g)
    x[0, :] = -float("inf")
    y = torch.full((8, 8), -200.0, device=cuda)
    y[:, 3] = -float("inf")
    _compare(x, y, torch.ones(4, 8, device=cuda))
    out = lm.logmatmulexp(x, y)
    assert (out[0] < -80).all() and torch.isfinite(out).all()


def test_kernel_rejects_bad_operands(cuda):
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        lm.logmatmulexp(x, x.T)
    with pytest.raises(ValueError):
        lm.logmatmulexp(torch.zeros(4, 8, device=cuda), torch.zeros(8, 4))


def _scan_inputs(rng, B, T, S, cuda, per_row_A=False, with_L=False, r_scale=1.0):
    A = rng.normal(size=(B, S, S) if per_row_A else (S, S)) * 2
    alpha0 = rng.normal(size=(B, S))
    R = rng.normal(size=(T, B, S)) * r_scale - (35.0 if r_scale > 1 else 0.0)
    L = rng.normal(size=(T, B, S)) if with_L else None
    return [None if a is None else torch.tensor(a, dtype=torch.float32, device=cuda) for a in (alpha0, A, R, L)]


def _scan_plan(inputs):
    alpha0, A = inputs[0], inputs[1]
    B, S = alpha0.shape
    return ms._device_plan(B, S, 1 if A.ndim == 2 else B, alpha0.device)


def _compare_scan(inputs, g, grad_rtol=1e-4, grad_atol=None, route="cluster", plan=None):
    """The kernel on ``route`` (the wrapper's choice, or ``plan``) against
    the plain version; returns the kernel's output and gradients."""
    leaves_k = [None if t is None else t.clone().requires_grad_() for t in inputs]
    leaves_p = [None if t is None else t.clone().requires_grad_() for t in inputs]
    n = dict(ms.launches)
    on_route = dict(ms.route_launches[route])
    out_k = ms.markov_scan(*leaves_k, plan=plan)
    out_p = ms.markov_scan_plain(*leaves_p)
    (out_k * g).sum().backward()
    (out_p * g).sum().backward()
    torch.cuda.synchronize()
    assert ms.launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1}
    assert ms.route_launches[route] == {"forward": on_route["forward"] + 1, "backward": on_route["backward"] + 1}
    assert torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k, out_p, rtol=1e-6, atol=1e-4)
    for k, p in zip(leaves_k, leaves_p):
        if k is not None:
            assert torch.isfinite(k.grad).all()
            atol = 1e-5 * g.abs().max().item() if grad_atol is None else grad_atol * p.grad.abs().max().item()
            torch.testing.assert_close(k.grad, p.grad, rtol=grad_rtol, atol=atol)
    return out_k.detach(), [None if k is None else k.grad for k in leaves_k]


@pytest.mark.parametrize(
    "B,T,S,per_row_A,with_L,r_scale",
    [
        (32, 127, 256, False, False, 3.0),  # the main path's shape, emissions about -35 per step
        (3, 6, 37, False, False, 1.0),
        (3, 6, 37, True, True, 1.0),
        (1, 5, 300, False, True, 1.0),
    ],
)
def test_scan_kernel_matches_plain(cuda, B, T, S, per_row_A, with_L, r_scale):
    rng = np.random.default_rng(S)
    inputs = _scan_inputs(rng, B, T, S, cuda, per_row_A, with_L, r_scale)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    assert _scan_plan(inputs).route == "cluster"
    if T > 100:
        _compare_scan(inputs, g, grad_rtol=1e-3, grad_atol=1e-4)
    else:
        _compare_scan(inputs, g)


def test_scan_kernel_neg_inf(cuda):
    """Zero-probability transitions (-inf in A, a whole column among them)
    and a row of alpha0 that is all -inf give finite gradients."""
    rng = np.random.default_rng(3)
    alpha0, A, R, _ = _scan_inputs(rng, 4, 7, 33, cuda)
    A[A < -1.5] = -float("inf")
    A[:, 5] = -float("inf")
    alpha0[2] = -float("inf")
    g = torch.tensor(rng.normal(size=(4, 33)), dtype=torch.float32, device=cuda)
    assert _scan_plan([alpha0, A]).route == "cluster"
    _compare_scan([alpha0, A, R, None], g)


@pytest.mark.parametrize("B,T,S,tol", [(4, 20, 16, 1e-4), (32, 127, 256, 1e-3)])
def test_scan_kernel_unreachable_states(cuda, B, T, S, tol):
    """Structural zeros of A leave a quarter of the states unreachable from
    alpha0's support, so their z is 0, clipped at FLT_MIN, at the first
    step and at no later one.  The dA fold must not let those entries set
    the shift of their columns for every step: each gradient stays within
    ``tol * max|grad|`` of the plain version's in float64."""
    rng = np.random.default_rng(11)
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    A[: S // 4, 3 * S // 4:] = -np.inf
    alpha0 = rng.normal(size=(B, S))
    alpha0[:, S // 4:] = -np.inf
    R = rng.normal(size=(T, B, S)) * 3 - 35.0
    inputs = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (alpha0, A, R)]
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    leaves = [t.clone().requires_grad_() for t in inputs]
    assert _scan_plan(inputs).route == "cluster"
    before = ms.route_launches["cluster"]["backward"]
    out = ms.markov_scan(*leaves)
    (out * g).sum().backward()
    assert ms.route_launches["cluster"]["backward"] == before + 1
    leaves64 = [t.double().requires_grad_() for t in inputs]
    out64 = ms.markov_scan_plain(*leaves64)
    (out64 * g.double()).sum().backward()
    torch.testing.assert_close(out.double(), out64, rtol=1e-6, atol=1e-4)
    for k, p in zip(leaves, leaves64):
        assert torch.isfinite(k.grad).all()
        torch.testing.assert_close(k.grad.double(), p.grad, rtol=0, atol=tol * p.grad.abs().max().item())
    # dalpha0 against autograd of the float64 direct form, which shares no
    # code with the plain version's analytic backward
    alpha0_64 = inputs[0].double().requires_grad_()
    (_direct_scan64(alpha0_64, inputs[1].double(), inputs[2].double()) * g.double()).sum().backward()
    want = alpha0_64.grad
    torch.testing.assert_close(leaves[0].grad.double(), want, rtol=0, atol=tol * want.abs().max().item())


def _direct_scan64(alpha0, A, R):
    """alpha_T by the definition, with detached shifts and the clip at FLT_MIN."""
    tiny = torch.finfo(torch.float32).tiny
    c = torch.nan_to_num(A.amax(0), neginf=0.0)
    alpha = alpha0
    for t in range(R.shape[0]):
        m = torch.nan_to_num(alpha.detach().amax(-1, keepdim=True), neginf=0.0)
        z = torch.exp(alpha - m) @ torch.exp(A - c)
        alpha = torch.log(z.clamp(min=tiny)) + m + c + R[t]
    return alpha


def _main_inputs(cuda, S=256):
    rng = np.random.default_rng(21)
    inputs = _scan_inputs(rng, 32, 127, S, cuda, r_scale=3.0)
    g = torch.tensor(rng.normal(size=(32, S)), dtype=torch.float32, device=cuda)
    return inputs, g


@pytest.mark.parametrize("S", [256, 512])
def test_scan_routes_at_main_shape(cuda, S):
    """Both routes at B=32, T'=127 (the main path's shape at S=256), each
    against the plain version and against the other."""
    inputs, g = _main_inputs(cuda, S)
    assert _scan_plan(inputs).route == "cluster"
    out_c, grads_c = _compare_scan(inputs, g, grad_rtol=1e-3, grad_atol=1e-4, route="cluster")
    out_s, grads_s = _compare_scan(inputs, g, grad_rtol=1e-3, grad_atol=1e-4, route="stream",
                                   plan=ms.ScanPlan("stream"))
    torch.testing.assert_close(out_c, out_s, rtol=1e-6, atol=1e-4)
    for c, s in zip(grads_c, grads_s):
        if c is not None:
            torch.testing.assert_close(c, s, rtol=1e-3, atol=1e-4 * s.abs().max().item())


@pytest.mark.parametrize(
    "B,T,S,per_row_A,with_L",
    [(3, 6, 37, False, True), (3, 6, 37, True, False), (2, 4, 1024, False, True)],
)
def test_scan_stream_route(cuda, B, T, S, per_row_A, with_L):
    """The streaming route, forced at ragged shapes and chosen at S=1024,
    where a cluster's shared memory cannot hold exp(A - c)."""
    rng = np.random.default_rng(S + B)
    inputs = _scan_inputs(rng, B, T, S, cuda, per_row_A, with_L)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    if S > 1000:
        assert _scan_plan(inputs) == ms.ScanPlan("stream")
        _compare_scan(inputs, g, route="stream")
    else:
        _compare_scan(inputs, g, route="stream", plan=ms.ScanPlan("stream"))


@pytest.mark.parametrize("C,rows", [(4, 3), (8, 1), (8, 2), (16, 5)])
def test_scan_cluster_shapes(cuda, C, rows):
    """Other cluster sizes and rows per cluster than the wrapper's choice,
    with L, a last CTA that owns fewer columns and a last cluster that
    takes fewer rows."""
    rng = np.random.default_rng(C * 10 + rows)
    inputs = _scan_inputs(rng, 11, 9, 77, cuda, with_L=True)
    g = torch.tensor(rng.normal(size=(11, 77)), dtype=torch.float32, device=cuda)
    _compare_scan(inputs, g, plan=ms.ScanPlan("cluster", C, rows))


def test_scan_cluster_is_deterministic(cuda):
    """Two runs of the cluster route give bit-identical outputs and gradients."""
    inputs, g = _main_inputs(cuda)
    runs = []
    for _ in range(2):
        leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
        out = ms.markov_scan(*leaves)
        (out * g).sum().backward()
        runs.append([out.detach()] + [t.grad for t in leaves if t is not None])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_scan_cluster_smem_layout(cuda):
    """The wrapper's shared-memory sizes are the kernels' own."""
    lib = ms._lib()
    for S, C, rows in [(256, 8, 2), (512, 16, 3), (37, 8, 1), (900, 16, 1)]:
        for backward in (False, True):
            assert lib.msc_smem_bytes(S, C, rows, int(backward)) == ms.cluster_smem_bytes(S, C, rows, backward)


def test_scan_refused_launch_raises(cuda):
    """A cluster plan whose shared memory the card cannot give raises, and
    so does one with a CTA that owns no column (S=33 over 8 CTAs of 5)."""
    rng = np.random.default_rng(4)
    inputs = _scan_inputs(rng, 2, 3, 1024, cuda)
    with pytest.raises(RuntimeError):
        ms.markov_scan(*inputs, plan=ms.ScanPlan("cluster", 8, 1))
    inputs = _scan_inputs(rng, 2, 3, 33, cuda)
    with pytest.raises(ValueError):
        ms.markov_scan(*inputs, plan=ms.ScanPlan("cluster", 8, 1))
    assert _scan_plan(inputs) == ms.ScanPlan("cluster", 7, 1)


def test_scan_kernel_rejects_bad_operands(cuda):
    alpha0 = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        ms.markov_scan(alpha0, torch.zeros(8, 8, device=cuda), torch.zeros(3, 4, 9, device=cuda))
    with pytest.raises(TypeError):
        ms.markov_scan(alpha0.double(), torch.zeros(8, 8, device=cuda).double(), torch.zeros(3, 4, 8, device=cuda))


def _eight_schools_nuts(cls):
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import eight_schools as es

    pyro.set_default_device("cuda")
    kernel = cls(es.model)
    kernel.setup(0, *es.data(), generator=torch.Generator(device="cuda").manual_seed(0))
    return kernel


@pytest.mark.parametrize("depth", [0, 3, 6])
def test_nuts_graphed_leaf_matches_eager(cuda, depth):
    """NUTS replays its leaf as a CUDA graph on the card: the subtree must be
    the one the same leaf builds when it runs eagerly."""
    from pyro_tpu_torch.infer import NUTS
    from pyro_tpu_torch.infer.mcmc.nuts import _Leaves

    class EagerNUTS(NUTS):
        def _leaves(self, C, n_dim, like):
            return self._leaf_buffers.setdefault((C, n_dim), _Leaves(C, n_dim, self.max_tree_depth, like))

    graphed, eager = _eight_schools_nuts(NUTS), _eight_schools_nuts(EagerNUTS)
    gen = torch.Generator(device="cuda").manual_seed(depth)
    C = 256
    z = torch.rand(C, 10, generator=gen, device="cuda") * 4 - 2
    r = torch.randn(C, 10, generator=gen, device="cuda")
    inv = torch.rand(C, 10, generator=gen, device="cuda") + 0.5
    step = torch.rand(C, generator=gen, device="cuda") * 0.5 + 0.01
    direction = torch.where(torch.rand(C, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    pe, grad = graphed._potential_and_grad(z)
    energy0 = pe + 0.5 * (inv * r * r).sum(-1)
    trees = [
        k._build_subtree(depth, z, r, grad, energy0, direction, step, inv,
                         torch.Generator(device="cuda").manual_seed(9))[0]
        for k in (graphed, eager)
    ]
    assert graphed._leaf_buffers and next(iter(graphed._leaf_buffers.values())).graph is not None
    for name, a, b in zip(trees[0]._fields, *trees):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, equal_nan=True, msg=name)


def test_nuts_runs_on_the_card(cuda):
    """A short eight-schools run on the card: finite draws, and at most one
    host sync a leapfrog pass."""
    from pyro_tpu_torch.examples import eight_schools as es
    from pyro_tpu_torch.infer import MCMC, NUTS

    import pyro_tpu_torch as pyro

    pyro.set_default_device("cuda")
    kernel = NUTS(es.model)
    mcmc = MCMC(kernel, num_samples=30, warmup_steps=30, num_chains=64)
    mcmc.run(*es.data(), generator=torch.Generator(device="cuda").manual_seed(0))
    samples = mcmc.get_samples(group_by_chain=True)
    assert samples["mu"].shape == (64, 30) and samples["theta"].shape == (64, 30, 8)
    assert all(bool(torch.isfinite(v).all()) for v in samples.values())
    assert kernel.counts["host_syncs"] <= kernel.counts["leapfrogs"]


# -- K4: the Gaussian halving levels ----------------------------------------------------
#
# Tolerances: each kernel against its plain version at the same inputs,
# float32 on the card, rtol 1e-4 with atol 1e-4 times the largest entry of
# the plain output (the kernels factorise right-looking and sum in another
# order than cuSOLVER and cuBLAS do).


def _spd(gen, shape, n, device):
    M = torch.randn(tuple(shape) + (n, n), generator=gen, device=device)
    return M @ M.transpose(-1, -2) / n + torch.eye(n, device=device)


def _assert_near(a, b):
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


# K4a and K5a (one kernel template) at every state dim class and at the
# tile's edges (tiles of 64 pairs of one row): m of 1, 63, 64, 65 and 5000.
HALVING_DIMS = [1, 2, 5, 16, 17, 31, 32]
HALVING_PAIRS = [1, 63, 64, 65, 5000]


def _halving_inputs(gen, R, m, n, cuda):
    """P, and info and logZ as a prefix of each row: strided rows, as the
    merged levels pass them."""
    P = _spd(gen, (), 2 * n, cuda)
    info = torch.randn(R, 2 * m + 3, 2 * n, generator=gen, device=cuda)[:, : 2 * m]
    logZ = torch.randn(R, 2 * m + 3, generator=gen, device=cuda)[:, : 2 * m]
    return P, info, logZ


@pytest.mark.parametrize("m", HALVING_PAIRS)
@pytest.mark.parametrize("n", HALVING_DIMS)
def test_halving_kernel_matches_plain(cuda, n, m):
    """With the tape; a second launch gives the same bits."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R = 8 if m == 5000 else 3
    gen = torch.Generator(device="cuda").manual_seed(n)
    P, info, logZ = _halving_inputs(gen, R, m, n, cuda)
    before = gl.launches["halving"]
    out_k = gl.halving_level(P, info, logZ, tape=True)
    out_p = gl.halving_level_plain(P, info, logZ, tape=True)
    again = gl.halving_level(P, info, logZ, tape=True)
    torch.cuda.synchronize()
    assert gl.launches["halving"] == before + 2
    for a, b in zip(out_k, out_p):
        _assert_near(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    assert torch.equal(out_k[0], out_k[0].T)  # P' written symmetric


def test_halving_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (an empty grid) raises, for K4a and K5a, and
    the next launch runs and is right."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(3)
    P, info, logZ = _halving_inputs(gen, 2, 65, 16, cuda)
    alpha, beta = (x[:, :130] for x in _gamma_rows(gen, 2, 133, cuda))
    plan = gl.halving_plan
    monkeypatch.setattr(gl, "halving_plan", lambda *args: plan(*args)._replace(blocks=0))
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.halving_level(P, info, logZ)
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.gamma_halving_level(P, info, logZ, alpha, beta)
    monkeypatch.setattr(gl, "halving_plan", plan)
    for a, b in zip(gl.halving_level(P, info, logZ, tape=True), gl.halving_level_plain(P, info, logZ, tape=True)):
        _assert_near(a, b)
    for a, b in zip(gl.gamma_halving_level(P, info, logZ, alpha, beta),
                    gl.gamma_halving_level_plain(P, info, logZ, alpha, beta)):
        _assert_near(a, b)


# K4b and K5b (one kernel template) at every state dim class: n of 1, 2, an
# odd 5, 16, 17, 31 and 32; t of 2, 3, odd and 4000; up to 8 rows; P
# contiguous, a slice of each row (rows strided), or expanded with stride 0
# over rows, time or both (read in place, never copied).
CONTRACT_CASES = [
    (1, 4000, 16, "contiguous"), (2, 13, 32, "contiguous"), (3, 2, 7, "contiguous"),
    (8, 3, 1, "sliced"), (3, 9, 2, "stride0_time"), (2, 2, 5, "sliced"), (8, 4000, 16, "stride0_rows"),
    (1, 9, 17, "contiguous"), (4, 3, 31, "stride0_time"), (8, 9, 32, "stride0_both"),
    (8, 4000, 32, "stride0_both"), (2, 13, 17, "sliced"),
]


def _contract_inputs(gen, R, t, n, layout, cuda):
    """P (R, t, 2n, 2n), info and logZ laid out as ``layout``."""
    n2 = 2 * n
    if layout == "stride0_rows":
        P = _spd(gen, (1, t), n2, cuda).expand(R, t, n2, n2)
    elif layout == "stride0_time":
        P = _spd(gen, (R, 1), n2, cuda).expand(R, t, n2, n2)
    elif layout == "stride0_both":
        P = _spd(gen, (), n2, cuda).expand(R, t, n2, n2)
    elif layout == "sliced":  # each row a slice of a longer one
        P = _spd(gen, (R, t + 1), n2, cuda)[:, 1:]
    else:
        P = _spd(gen, (R, t), n2, cuda)
    pad = 3 if layout == "sliced" else 0
    info = torch.randn(R, t + pad, n2, generator=gen, device=cuda)[:, pad:]
    logZ = torch.randn(R, t + pad, generator=gen, device=cuda)[:, pad:]
    return P, info, logZ


@pytest.mark.parametrize("R,t,n,layout", CONTRACT_CASES)
def test_contract_kernel_matches_plain(cuda, R, t, n, layout):
    """K4b against its plain version, the tape included; a second launch on
    the same inputs gives the same bits; the backward kernel from the
    kernel's tape against the plain backward from the plain version's."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(t + n)
    P, info, logZ = _contract_inputs(gen, R, t, n, layout, cuda)
    before = gl.launches["contract"]
    *out_k, tape_k = gl.contract_pairs(P, info, logZ, tape=True)
    *out_p, tape_p = gl.contract_pairs_plain(P, info, logZ, tape=True)
    *again, tape_again = gl.contract_pairs(P, info, logZ, tape=True)
    torch.cuda.synchronize()
    assert gl.launches["contract"] == before + 2
    for a, b in zip(out_k + list(tape_k), out_p + list(tape_p)):
        _assert_near(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out_k + list(tape_k), again + list(tape_again)))
    t_out = t - t // 2
    grads = (torch.randn(R, t_out, 2 * n, 2 * n, generator=gen, device=cuda),
             torch.randn(R, t_out, 2 * n, generator=gen, device=cuda), torch.randn(R, t_out, generator=gen, device=cuda))
    g_k = gl._contract_bwd_cuda(t, *tape_k, *grads)
    g_p = gl.contract_pairs_bwd_plain(t, *tape_p, *grads)
    torch.cuda.synchronize()
    _assert_near(_sym(g_k[0]), _sym(g_p[0]))
    for a, b in zip(g_k[1:], g_p[1:]):
        _assert_near(a, b)


def _mids_inputs(gen, D, R, m, Np, n, shared, cuda):
    per = () if shared else (R, Np)
    L = torch.linalg.cholesky(_spd(gen, per, n, cuda))
    P_mk = torch.randn(per + (n, 2 * n), generator=gen, device=cuda)
    i_m = torch.randn(R, Np, n, generator=gen, device=cuda)
    cur = torch.randn(D, R, m, n, generator=gen, device=cuda)
    eps = torch.randn(D, R, Np, n, generator=gen, device=cuda)
    return cur, L, P_mk, i_m, eps


def _mids_cases(n, shared, k):
    """(D, R, m, Np): Np at the edges of the kernel's tile of k pairs (1, k
    - 1, k, k + 1) and 2000, D of 1, 3 and 64, each at an even level (one
    point carried) and an odd one (two).  The grid holds the heterogeneous
    sampler's first level at T=4000 (64, 1, 2001, 2000) at n=16 per pair;
    the earlier cases (3, 2, 9, 7) at n=5 per pair and (4, 8, 40, 39) at
    n=32, shared, are added."""
    cases = [(D, 2, Np + 1 + odd, Np) for Np in (1, k - 1, k, k + 1) for D in (1, 3, 64) for odd in (0, 1)]
    cases += [(64, 1, 2001, 2000), (64, 1, 2002, 2000)]
    if shared and n == 32:
        cases.append((4, 8, 40, 39))
    if not shared and n == 5:
        cases.append((3, 2, 9, 7))
    return cases


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("n", HALVING_DIMS)
def test_mids_kernel_matches_plain(cuda, n, shared):
    """K4c against its plain version over ``_mids_cases`` (each case's
    inputs from seed Np, as the earlier cases had them); a second launch
    gives the same bits."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    for D, R, m, Np in _mids_cases(n, shared, gl._tile_shape("gl_mids_shape", n, int(shared)).tile):
        gen = torch.Generator(device="cuda").manual_seed(Np)
        args = _mids_inputs(gen, D, R, m, Np, n, shared, cuda)
        before = gl.launches["mids"]
        out_k = gl.level_mids(*args)
        out_p = gl.level_mids_plain(*args)
        again = gl.level_mids(*args)
        torch.cuda.synchronize()
        assert gl.launches["mids"] == before + 2
        _assert_near(out_k, out_p)
        assert torch.equal(out_k, again), (D, R, m, Np)


def test_tape_kernels_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (an empty grid) raises, for K4c and for
    K4b's backward, and the next launch runs and is right."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _mids_inputs(gen, 3, 2, 11, 9, 16, False, cuda)
    R, t, n = 2, 9, 16
    *_, tape = gl.contract_pairs(_spd(gen, (R, t), 2 * n, cuda), torch.randn(R, t, 2 * n, generator=gen, device=cuda),
                                 torch.randn(R, t, generator=gen, device=cuda), tape=True)
    grads = (torch.randn(R, 5, 2 * n, 2 * n, generator=gen, device=cuda),
             torch.randn(R, 5, 2 * n, generator=gen, device=cuda), torch.randn(R, 5, generator=gen, device=cuda))
    plans = {name: getattr(gl, name) for name in ("mids_plan", "contract_bwd_plan")}
    for name, plan in plans.items():
        monkeypatch.setattr(gl, name, lambda *a, plan=plan: plan(*a)._replace(blocks=0))
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.level_mids(*args)
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl._contract_bwd_cuda(t, *tape, *grads)
    for name, plan in plans.items():
        monkeypatch.setattr(gl, name, plan)
    _assert_near(gl.level_mids(*args), gl.level_mids_plain(*args))
    g_k, g_p = gl._contract_bwd_cuda(t, *tape, *grads), gl.contract_pairs_bwd_plain(t, *tape, *grads)
    _assert_near(_sym(g_k[0]), _sym(g_p[0]))
    for a, b in zip(g_k[1:], g_p[1:]):
        _assert_near(a, b)


def test_k4_backward_raises(cuda):
    """On the card a backward through K4a and K4b runs the backward kernels
    (never the plain versions), and one through K4c raises, naming the
    roadmap; a gradient that reaches a level's tape raises too."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(0)
    P = _spd(gen, (), 8, cuda).requires_grad_()
    info = torch.randn(2, 6, 8, generator=gen, device=cuda, requires_grad=True)
    logZ = torch.randn(2, 6, generator=gen, device=cuda)
    gl.reset_counts()
    gl.halving_level(P, info, logZ)[1].sum().backward()
    Pt = _spd(gen, (2, 6), 8, cuda).requires_grad_()
    gl.contract_pairs(Pt, info, logZ)[2].sum().backward()
    torch.cuda.synchronize()
    assert gl.launches["halving_bwd"] == 1 and gl.launches["contract_bwd"] == 1
    assert bool(P.grad.isfinite().all()) and bool(Pt.grad.isfinite().all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gl.halving_level(P, info, logZ, tape=True)[3].sum().backward()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gl.contract_pairs(Pt, info, logZ, tape=True)[3][1].sum().backward()
    L = torch.linalg.cholesky(_spd(gen, (), 4, cuda)).requires_grad_()
    cur = torch.randn(1, 2, 4, 4, generator=gen, device=cuda)
    mids = gl.level_mids(cur, L, torch.randn(4, 8, device=cuda), torch.randn(2, 3, 4, device=cuda),
                         torch.randn(1, 2, 3, 4, device=cuda))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mids.sum().backward()


def _sym(g):
    return 0.5 * (g + g.transpose(-1, -2))


# K4a backward's cases: (R, m, n).  The first five date from its first
# kernels; the rest cover n in {1, 2, 5, 16, 17, 31, 32} and pair counts
# across its tiles of 64 pairs, its grid of one CTA an SM (132 on an H100)
# and its groups of 16 or more CTAs: 1, 8, 64, 65, 72, 1088 (17 CTAs, two
# groups), 2496, 16897 (265 tiles: the first CTA takes three, the last of
# them one pair) and 40000 pairs.
HALVING_BWD_CASES = [(8, 5000, 32), (1, 7, 16), (8, 3, 1), (1, 1, 32), (8, 9, 16),
                     (1, 1, 2), (1, 8, 5), (1, 64, 32), (1, 65, 2), (8, 9, 17), (1, 1088, 32), (8, 312, 31),
                     (1, 16897, 5), (4, 10000, 16), (8, 5000, 1)]


@pytest.mark.parametrize("R,m,n", HALVING_BWD_CASES)
def test_halving_backward_kernel_matches_plain(cuda, R, m, n):
    """K4a's backward kernel against the plain backward at the same tape and
    upstream gradients: all three, then each of them None in turn, then only
    gP'."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(m + n)
    P = _spd(gen, (), 2 * n, cuda)
    info = torch.randn(R, 2 * m, 2 * n, generator=gen, device=cuda)
    logZ = torch.randn(R, 2 * m, generator=gen, device=cuda)
    _, _, _, L, ib = gl.halving_level(P, info, logZ, tape=True)
    g_P = torch.randn(2 * n, 2 * n, generator=gen, device=cuda)
    g_info = torch.randn(R, m, 2 * n, generator=gen, device=cuda)
    g_logZ = torch.randn(R, m, generator=gen, device=cuda)
    for grads in ((g_P, g_info, g_logZ), (None, g_info, g_logZ), (g_P, None, g_logZ), (g_P, g_info, None),
                  (g_P, None, None)):
        before = gl.launches["halving_bwd"]
        out_k = gl._halving_bwd_cuda(P, L, ib, *grads)
        out_p = gl.halving_level_bwd_plain(P, L, ib, *grads)
        torch.cuda.synchronize()
        assert gl.launches["halving_bwd"] == before + 1
        _assert_near(_sym(out_k[0]), _sym(out_p[0]))
        for a, b in zip(out_k[1:], out_p[1:]):
            _assert_near(a, b)


def test_halving_backward_against_float64(cuda):
    """K4a's backward in float32 against the plain backward in float64 on the
    same inputs, at the main path's first level (R=8, 5000 pairs a row,
    n=32): within 1e-4 times the largest entry of each float64 output, the
    float32 bar the kernel is held to against its plain version (its L^-1
    and its sums over 40000 pairs round like float32, about 1e-6 here)."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R, m, n = 8, 5000, 32
    gen = torch.Generator(device="cuda").manual_seed(64)
    P = _spd(gen, (), 2 * n, cuda)
    _, _, _, L, ib = gl.halving_level(P, torch.randn(R, 2 * m, 2 * n, generator=gen, device=cuda),
                                      torch.randn(R, 2 * m, generator=gen, device=cuda), tape=True)
    grads = (torch.randn(2 * n, 2 * n, generator=gen, device=cuda),
             torch.randn(R, m, 2 * n, generator=gen, device=cuda), torch.randn(R, m, generator=gen, device=cuda))
    out_k = gl._halving_bwd_cuda(P, L, ib, *grads)
    out_64 = gl.halving_level_bwd_plain(P.double(), L.double(), ib.double(), *(g.double() for g in grads))
    for a, b in zip((_sym(out_k[0]), *out_k[1:]), (_sym(out_64[0]), *out_64[1:])):
        assert bool(a.isfinite().all())
        assert float((a.double() - b).abs().max()) <= 1e-4 * float(b.abs().max())


# K4b backward's cases at each n: (R, t) of 2 rows at t of 2, 3, 4 and 5
# (one pair; a pair and a factor passed through; two pairs, a CTA's at
# n <= 16; two and one passed through) and 1 row at t = 4001 (the lgssm
# step's first level at n=16, with its last factor passed through); and the
# earlier cases (8, 13) and (1, 2) at n=32, (1, 7) at n=1, (8, 9) at n=16.
def _contract_bwd_cases(n):
    earlier = {32: [(8, 13), (1, 2)], 1: [(1, 7)], 16: [(8, 9)]}
    return [(2, t) for t in (2, 3, 4, 5)] + [(1, 4001)] + earlier.get(n, [])


@pytest.mark.parametrize("n", HALVING_DIMS)
def test_contract_backward_kernel_matches_plain(cuda, n):
    """K4b's backward kernel against the plain backward at the same tape and
    upstream gradients (an odd t passes the last factor's through): all
    three, gP' None, then only gP' (each case's inputs from seed t + n, as
    the earlier cases had them); a second launch gives the same bits."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    for R, t in _contract_bwd_cases(n):
        gen = torch.Generator(device="cuda").manual_seed(t + n)
        P = _spd(gen, (R, t), 2 * n, cuda)
        info = torch.randn(R, t, 2 * n, generator=gen, device=cuda)
        logZ = torch.randn(R, t, generator=gen, device=cuda)
        *_, tape = gl.contract_pairs(P, info, logZ, tape=True)
        t_out = t - t // 2
        g_P = torch.randn(R, t_out, 2 * n, 2 * n, generator=gen, device=cuda)
        g_info = torch.randn(R, t_out, 2 * n, generator=gen, device=cuda)
        g_logZ = torch.randn(R, t_out, generator=gen, device=cuda)
        for grads in ((g_P, g_info, g_logZ), (None, g_info, g_logZ), (g_P, None, None)):
            before = gl.launches["contract_bwd"]
            out_k = gl._contract_bwd_cuda(t, *tape, *grads)
            out_p = gl.contract_pairs_bwd_plain(t, *tape, *grads)
            again = gl._contract_bwd_cuda(t, *tape, *grads)
            torch.cuda.synchronize()
            assert gl.launches["contract_bwd"] == before + 2
            _assert_near(_sym(out_k[0]), _sym(out_p[0]))
            for a, b in zip(out_k[1:], out_p[1:]):
                _assert_near(a, b)
            assert all(torch.equal(a, b) for a, b in zip(out_k, again)), (R, t)


def test_backward_kernels_reject_a_state_dim_above_32(cuda):
    from pyro_tpu_torch.ops import gaussian_levels as gl

    n = 33
    gen = torch.Generator(device="cuda").manual_seed(n)
    L = torch.linalg.cholesky(_spd(gen, (), n, cuda))
    with pytest.raises(ValueError, match="n <= 32"):
        gl._halving_bwd_cuda(_spd(gen, (), 2 * n, cuda), L, torch.randn(1, 2, n, device=cuda), None, None,
                             torch.ones(1, 2, device=cuda))
    with pytest.raises(ValueError, match="n <= 32"):
        gl._contract_bwd_cuda(3, L[None, None], torch.randn(1, 1, n, 2 * n, device=cuda),
                              torch.randn(1, 1, n, device=cuda), None, None, torch.ones(1, 2, device=cuda))


def test_halving_backward_is_deterministic(cuda):
    """The reductions over pairs run in a fixed order: two runs give the
    same bits, back to back on one stream and at once on two streams (each
    call has its own partials and counters)."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R, m, n = 8, 5000, 32
    gen = torch.Generator(device="cuda").manual_seed(1)
    P = _spd(gen, (), 2 * n, cuda)
    _, _, _, L, ib = gl.halving_level(P, torch.randn(R, 2 * m, 2 * n, generator=gen, device=cuda),
                                      torch.randn(R, 2 * m, generator=gen, device=cuda), tape=True)
    grads = (torch.randn(2 * n, 2 * n, generator=gen, device=cuda),
             torch.randn(R, m, 2 * n, generator=gen, device=cuda), torch.randn(R, m, generator=gen, device=cuda))
    first = gl._halving_bwd_cuda(P, L, ib, *grads)
    second = gl._halving_bwd_cuda(P, L, ib, *grads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):  # launches on the two streams interleaved
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(gl._halving_bwd_cuda(P, L, ib, *grads))
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(first, out))


@pytest.mark.parametrize("path", ["lgssm", "homogeneous"])
def test_training_step_on_the_card(cuda, path):
    """One training step's loss and gradients through the K4 kernels (forward
    and backward) against the port's float64 CPU run at small widths: loss
    rtol 1e-5, each gradient within 1e-3 times its largest entry."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.contrib.timeseries import GenericLGSSM
    from pyro_tpu_torch.examples import gaussian_hmm as ex
    from pyro_tpu_torch.examples import lgssm
    from pyro_tpu_torch.infer import Trace_ELBO
    from pyro_tpu_torch.ops import gaussian_levels as gl
    from pyro_tpu_torch.params import param_store_from_jax

    out = []
    pyro.clear_param_store()
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        pyro.set_default_device(device)
        if path == "lgssm":
            data = ex.params_from_jax({"data": ex.make_arrays("heterogeneous", 0, T=45)["data"][:, :2]}, dtype)["data"]
            model = lgssm.make_model(GenericLGSSM(obs_dim=2, state_dim=5, name="GenericLGSSM"))
        else:
            params = ex.params_from_jax(ex.make_arrays("homogeneous", 0, batch=3, T=45, hidden=6, obs=2), dtype)
            data = params.pop("data")
            model = ex.make_train_model(params)
        store = pyro.get_param_store()
        if device == "cpu":
            param_store_from_jax({k: store[k].detach().double().cpu().numpy() for k in names})
        gl.reset_counts()
        with poutine.trace(param_only=True) as capture:
            loss = Trace_ELBO().differentiable_loss(model, lambda *a: None, data)
        loss.backward()
        names = sorted(capture.trace.param_nodes())
        if device == "cuda":
            torch.cuda.synchronize()
            kind = "contract" if path == "lgssm" else "halving"
            assert gl.launches[kind] > 0 and gl.launches[f"{kind}_bwd"] > 0
        out.append((float(loss.detach()), {k: store.get_unconstrained(k).grad.detach().double().cpu() for k in names}))
    pyro.clear_param_store()
    pyro.set_default_device("cuda")
    (loss32, g32), (loss64, g64) = out
    assert loss32 == pytest.approx(loss64, rel=1e-5)
    for k in g64:
        torch.testing.assert_close(g32[k], g64[k], rtol=0, atol=1e-3 * float(g64[k].abs().max()))


@pytest.mark.parametrize("config,T,hidden", [("homogeneous", 37, 32), ("heterogeneous", 45, 16)])
def test_gaussian_hmm_on_the_card(cuda, monkeypatch, config, T, hidden):
    """GaussianHMM on the card goes through the K4 kernels and never reaches
    their plain versions: log_prob and filter against the port's float64
    CPU run, and the posterior draws at zero noise (the mean) likewise."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import gaussian_hmm as ex
    from pyro_tpu_torch.ops import gaussian as tg
    from pyro_tpu_torch.ops import gaussian_levels as gl

    arrays = ex.make_arrays(config, 0, T=T, hidden=hidden, batch=3)
    pyro.set_default_device("cpu")
    p64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in arrays.items()}
    data64 = p64.pop("data")
    hmm64 = ex.make_hmm(p64, T)
    lp64 = hmm64.log_prob(data64)
    pyro.set_default_device("cuda")
    params = ex.params_from_jax(arrays)
    data = params.pop("data")
    hmm = ex.make_hmm(params, T)
    def cpu_only(name):
        plain = getattr(gl, name)

        def guarded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                pytest.fail(f"a CUDA tensor reached {name}")
            return plain(*args, **kwargs)

        return guarded

    for name in ("halving_level_plain", "contract_pairs_plain", "level_mids_plain"):
        monkeypatch.setattr(gl, name, cpu_only(name))
    gl.reset_counts()
    lp = hmm.log_prob(data)
    loc = hmm.filter(data).loc
    z = hmm.rsample_posterior(data, torch.Generator(device="cuda").manual_seed(0), (4,))
    trans = hmm._conditioned(data)
    zeros = torch.zeros(trans.batch_shape[:-1] + (T + 1, hidden), device=cuda)
    if trans.precision.ndim == 2:
        mean = tg.sequential_gaussian_filter_sample_homogeneous(hmm._init, trans, noise=zeros)
    else:
        mean = tg.sequential_gaussian_filter_sample(hmm._init, trans.expand(trans.batch_shape), noise=zeros)
    torch.cuda.synchronize()
    counts = dict(gl.launches)
    assert counts["contract"] > 0 and counts["mids"] > 0
    assert (counts["halving"] > 0) == (config == "homogeneous")
    assert z.shape == (4,) + tuple(data.shape[:-1]) + (hidden,) and bool(torch.isfinite(z).all())
    torch.testing.assert_close(lp.double().cpu(), lp64, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(loc.double().cpu(), hmm64.filter(data64).loc, rtol=1e-3, atol=1e-3)
    trans64 = hmm64._conditioned(data64)
    zeros64 = zeros.double().cpu()
    if trans64.precision.ndim == 2:
        mean64 = tg.sequential_gaussian_filter_sample_homogeneous(hmm64._init, trans64, noise=zeros64)
    else:
        mean64 = tg.sequential_gaussian_filter_sample(hmm64._init, trans64.expand(trans64.batch_shape), noise=zeros64)
    torch.testing.assert_close(mean.double().cpu(), mean64, rtol=1e-3, atol=1e-3)


# -- K5, the gamma-Gaussian levels ------------------------------------------------
#
# Tolerances: as K4's; alpha', a sum of constants, exactly.


def _gamma_rows(gen, R, t, cuda):
    """Per-factor alpha and beta (R, t)."""
    alpha = 2.0 + torch.randint(0, 4, (R, t), generator=gen, device=cuda).float()
    return alpha, 1.0 + torch.rand(R, t, generator=gen, device=cuda)


@pytest.mark.parametrize("m", HALVING_PAIRS)
@pytest.mark.parametrize("n", HALVING_DIMS)
def test_gamma_halving_kernel_matches_plain(cuda, n, m):
    """Strided rows; a second launch gives the same bits, and K4a on the
    same input gives P' and info' bit for bit."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R = 8 if m == 5000 else 3
    gen = torch.Generator(device="cuda").manual_seed(n)
    P, info, logZ = _halving_inputs(gen, R, m, n, cuda)
    alpha, beta = (x[:, : 2 * m] for x in _gamma_rows(gen, R, 2 * m + 3, cuda))
    before = gl.launches["gamma_halving"]
    out_k = gl.gamma_halving_level(P, info, logZ, alpha, beta)
    out_p = gl.gamma_halving_level_plain(P, info, logZ, alpha, beta)
    again = gl.gamma_halving_level(P, info, logZ, alpha, beta)
    k4 = gl.halving_level(P, info, logZ)
    torch.cuda.synchronize()
    assert gl.launches["gamma_halving"] == before + 2
    assert torch.equal(out_k[3], out_p[3])
    for a, b in zip(out_k, out_p):
        _assert_near(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    assert torch.equal(out_k[0], k4[0]) and torch.equal(out_k[1], k4[1])


GAMMA_CONTRACT_CASES = [
    (1, 4003, 16, "contiguous"), (2, 15, 32, "contiguous"), (3, 7, 3, "contiguous"),
    (8, 2, 1, "stride0_rows"), (2, 3, 2, "sliced"), (3, 9, 5, "stride0_time"), (1, 13, 17, "contiguous"),
    (8, 4001, 31, "stride0_both"), (8, 4000, 32, "stride0_both"), (4, 9, 32, "sliced"),
]


@pytest.mark.parametrize("R,t,n,layout", GAMMA_CONTRACT_CASES)
def test_gamma_contract_kernel_matches_plain(cuda, R, t, n, layout):
    """Odd pair counts, an odd t whose last factor is carried, strided and
    broadcast P; a second launch gives the same bits."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(t)
    P, info, logZ = _contract_inputs(gen, R, t, n, layout, cuda)
    alpha, beta = _gamma_rows(gen, R, t, cuda)
    before = gl.launches["gamma_contract"]
    out_k = gl.gamma_contract_pairs(P, info, logZ, alpha, beta)
    out_p = gl.gamma_contract_pairs_plain(P, info, logZ, alpha, beta)
    again = gl.gamma_contract_pairs(P, info, logZ, alpha, beta)
    torch.cuda.synchronize()
    assert gl.launches["gamma_contract"] == before + 2
    assert torch.equal(out_k[3], out_p[3])
    for a, b in zip(out_k, out_p):
        _assert_near(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))


@pytest.mark.parametrize("n", [3, 16, 32])
def test_gamma_kernels_are_k4_with_the_completion_moved(cuda, n):
    """On the same input K5 gives K4's info' and P' bit for bit (one
    template), and logZ' of K4 less the completion |s|^2 / 2, which K5 takes
    from beta instead (s = L^-1 ib from K4a's tape, L^-1 i_m from K4b's)."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(n + 1)
    R, t = 2, 9
    P = _spd(gen, (), 2 * n, cuda)
    info = torch.randn(R, t - 1, 2 * n, generator=gen, device=cuda)
    logZ = torch.randn(R, t - 1, generator=gen, device=cuda)
    alpha, beta = _gamma_rows(gen, R, t - 1, cuda)
    P4, info4, logZ4, L, ib = gl.halving_level(P, info, logZ, tape=True)
    P5, info5, logZ5, _, beta5 = gl.gamma_halving_level(P, info, logZ, alpha, beta)
    half_ss = 0.5 * (torch.linalg.solve_triangular(L, ib.reshape(-1, n).T, upper=False).T ** 2).sum(-1).reshape(R, -1)
    assert torch.equal(P4, P5) and torch.equal(info4, info5)
    _assert_near(logZ5, logZ4 - half_ss)
    _assert_near(beta5, beta[:, 0::2] + beta[:, 1::2] - half_ss)

    Pt = _spd(gen, (R, t), 2 * n, cuda)
    info = torch.randn(R, t, 2 * n, generator=gen, device=cuda)
    logZ = torch.randn(R, t, generator=gen, device=cuda)
    alpha, beta = _gamma_rows(gen, R, t, cuda)
    P4, info4, logZ4, (L, _, i_m) = gl.contract_pairs(Pt, info, logZ, tape=True)
    P5, info5, logZ5, _, beta5 = gl.gamma_contract_pairs(Pt, info, logZ, alpha, beta)
    half_ss = 0.5 * (torch.linalg.solve_triangular(L, i_m.unsqueeze(-1), upper=False).squeeze(-1) ** 2).sum(-1)
    assert torch.equal(P4, P5) and torch.equal(info4, info5)
    _assert_near(logZ5[:, :-1], logZ4[:, :-1] - half_ss)
    _assert_near(beta5[:, :-1], beta[:, 0:t - 1:2] + beta[:, 1:t - 1:2] - half_ss)
    assert torch.equal(logZ5[:, -1], logZ[:, -1]) and torch.equal(beta5[:, -1], beta[:, -1])


def test_gamma_kernels_backward_and_bad_operands_raise(cuda):
    """A gradient that reaches K5's outputs on the card raises, naming the
    roadmap; a state dim above 32 raises."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    gen = torch.Generator(device="cuda").manual_seed(0)
    P = _spd(gen, (), 8, cuda).requires_grad_()
    info = torch.randn(2, 6, 8, generator=gen, device=cuda, requires_grad=True)
    logZ = torch.randn(2, 6, generator=gen, device=cuda)
    alpha, beta = _gamma_rows(gen, 2, 6, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gl.gamma_halving_level(P, info, logZ, alpha, beta)[4].sum().backward()
    Pt = _spd(gen, (2, 6), 8, cuda).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gl.gamma_contract_pairs(Pt, info, logZ, alpha, beta)[2].sum().backward()
    n = 33
    alpha, beta = _gamma_rows(gen, 1, 4, cuda)
    with pytest.raises(ValueError, match="n <= 32"):
        gl.gamma_halving_level(_spd(gen, (), 2 * n, cuda), torch.randn(1, 4, 2 * n, device=cuda),
                               torch.zeros(1, 4, device=cuda), alpha, beta)
    with pytest.raises(ValueError, match="n <= 32"):
        gl.gamma_contract_pairs(_spd(gen, (1, 4), 2 * n, cuda), torch.randn(1, 4, 2 * n, device=cuda),
                                torch.zeros(1, 4, device=cuda), alpha, beta)


@pytest.mark.parametrize("config,T,hidden", [("homogeneous", 37, 32), ("heterogeneous", 45, 16)])
def test_gamma_gaussian_hmm_on_the_card(cuda, monkeypatch, config, T, hidden):
    """GammaGaussianHMM on the card goes through the K5 kernels and never
    reaches their plain versions: log_prob (rtol 1e-4, atol 1e-3) and
    filter (the Gamma's parameters rtol 1e-4, the MVN's mean and covariance
    rtol and atol 1e-3) against the port's float64 CPU run."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import gamma_gaussian_hmm as ex
    from pyro_tpu_torch.ops import gaussian_levels as gl

    arrays = ex.make_arrays(config, 0, T=T, hidden=hidden, batch=3)
    pyro.set_default_device("cpu")
    p64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in arrays.items()}
    data64 = p64.pop("data")
    hmm64 = ex.make_hmm(p64, T)
    lp64, (gamma64, mvn64) = hmm64.log_prob(data64), hmm64.filter(data64)
    pyro.set_default_device("cuda")
    params = ex.params_from_jax(arrays)
    data = params.pop("data")
    hmm = ex.make_hmm(params, T)

    def cpu_only(name):
        plain = getattr(gl, name)

        def guarded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                pytest.fail(f"a CUDA tensor reached {name}")
            return plain(*args, **kwargs)

        return guarded

    for name in ("gamma_halving_level_plain", "gamma_contract_pairs_plain"):
        monkeypatch.setattr(gl, name, cpu_only(name))
    gl.reset_counts()
    lp = hmm.log_prob(data)
    torch.cuda.synchronize()
    levels = {"homogeneous": (T.bit_length() - 1, 0), "heterogeneous": (0, (T - 1).bit_length())}[config]
    assert (gl.launches["gamma_halving"], gl.launches["gamma_contract"]) == levels
    gamma, mvn = hmm.filter(data)
    torch.cuda.synchronize()
    assert gl.launches["gamma_contract"] == levels[1] + (T - 1).bit_length()
    torch.testing.assert_close(lp.double().cpu(), lp64, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(gamma.concentration.double().cpu(), gamma64.concentration, rtol=1e-4, atol=0)
    torch.testing.assert_close(gamma.rate.double().cpu(), gamma64.rate, rtol=1e-4, atol=0)
    torch.testing.assert_close(mvn.loc.double().cpu(), mvn64.loc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(mvn.covariance_matrix.double().cpu(), mvn64.covariance_matrix, rtol=1e-3, atol=1e-3)


# -- K2g, the time-varying scan (markov_scan_tv) -------------------------------


def _tv_inputs(rng, B, T, S, cuda, per_row_A=False, with_L=False, unreachable=False, emission=0.0):
    """alpha0, A_t (log transition probabilities, shared or one per row), R
    and L; with ``unreachable``, -inf entries, a column no state reaches at
    every third step and half of alpha0's states -inf."""
    A = rng.normal(size=(T, B, S, S) if per_row_A else (T, S, S)) * 2
    A = A - np.log(np.exp(A).sum(-1, keepdims=True))
    alpha0 = rng.normal(size=(B, S))
    if unreachable:
        A[A < -6.0] = -np.inf
        A[::3, ..., :, S // 3] = -np.inf
        alpha0[:, S // 2:] = -np.inf
    R = rng.normal(size=(T, B, S)) * (3.0 if emission else 1.0) + emission
    L = rng.normal(size=(T, B, S)) if with_L else None
    return [None if a is None else torch.tensor(a, dtype=torch.float32, device=cuda) for a in (alpha0, A, R, L)]


def _underflow_inputs(rng, B, T, S, cuda, per_row_A=False):
    """Data on which K2g's factored sum is 0 at the even columns of every
    step while the true value is finite: hs peaks at l = 0 (R keeps state 0
    about 200 above the others) and A_t[0, r] is about -200 at the even
    columns (``tests/test_torch_scan_tv_form.py::underflow_inputs``)."""
    A = rng.normal(size=(T, B, S, S) if per_row_A else (T, S, S)) * 2.0
    A[..., 0, 0::2] = -200.0 + rng.normal(size=A[..., 0, 0::2].shape)
    R = rng.normal(size=(T, B, S))
    R[..., 1::2] -= 400.0
    R[..., 2::2] -= 200.0
    alpha0 = rng.normal(size=(B, S)) - 200.0
    alpha0[:, 0] = 0.0
    return [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (alpha0, A, R)] + [None]


def _tv_route(inputs, route):
    """The plan that runs K2g on ``route``: the wrapper's choice (checked to
    be that route), or the streaming route forced."""
    alpha0, A = inputs[0], inputs[1]
    B, S = alpha0.shape
    chosen = ms._device_plan_tv(B, S, 1 if A.ndim == 3 else B, alpha0.device)
    if route == "cluster":
        assert chosen.route == "cluster", chosen
        return None
    return None if chosen.route == route else ms.ScanPlan(route)


def _compare_tv(inputs, g, tol, route=None):
    """K2g forward and every gradient against the plain version in float64:
    -inf exactly where it is -inf, the finite values within atol 1e-4 plus
    rtol 1e-6, each gradient finite and within ``tol * max|grad|``; on
    ``route`` if one is named (one launch each way counted there)."""
    leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
    plan = None if route is None else _tv_route(inputs, route)
    n = dict(ms.tv_launches)
    on_route = {k: dict(v) for k, v in ms.tv_route_launches.items()}
    k2 = dict(ms.launches)
    out = ms.markov_scan_tv(*leaves, plan=plan)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert ms.tv_launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1}
    if route is not None:
        assert ms.tv_route_launches[route] == {k: v + 1 for k, v in on_route[route].items()}
    assert ms.launches == k2
    leaves64 = [None if t is None else t.double().requires_grad_() for t in inputs]
    out64 = ms.markov_scan_tv_plain(*leaves64)
    (out64 * g.double()).sum().backward()
    assert torch.equal(torch.isneginf(out), torch.isneginf(out64))
    live = torch.isfinite(out64)
    torch.testing.assert_close(out.double()[live], out64[live], rtol=1e-6, atol=1e-4)
    for k, p in zip(leaves, leaves64):
        if k is not None:
            assert torch.isfinite(k.grad).all()
            torch.testing.assert_close(k.grad.double(), p.grad, rtol=0, atol=tol * p.grad.abs().max().item())
    return out.detach(), [None if k is None else k.grad for k in leaves]


_TV_CASES = [
    (32, 127, 256, False, False, 1e-3),  # model_1vt's shape
    (8, 63, 64, True, False, 1e-4),
    (3, 6, 37, False, True, 1e-4),
    (3, 6, 37, True, True, 1e-4),
    (4, 9, 7, False, True, 1e-4),  # odd S
    (2, 5, 257, True, False, 1e-4),
    (5, 1, 33, False, True, 1e-4),  # T=1
    (2, 3, 640, False, True, 1e-4),  # the cluster route at C=16, W=40
]
TV_ROUTES = ["cluster", "stream"]


@pytest.mark.parametrize("route", TV_ROUTES)
@pytest.mark.parametrize("B,T,S,per_row_A,with_L,tol", _TV_CASES)
def test_tv_scan_kernel_matches_plain(cuda, B, T, S, per_row_A, with_L, tol, route):
    rng = np.random.default_rng(1000 + S)
    inputs = _tv_inputs(rng, B, T, S, cuda, per_row_A, with_L, emission=-35.0 if T > 100 else 0.0)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    _compare_tv(inputs, g, tol, route)


@pytest.mark.parametrize("B,T,S", [(2, 2, ms.MAX_STATES_TV), (2, 3, 1024)])
def test_tv_scan_past_the_cluster_route_takes_the_streaming_route(cuda, B, T, S):
    """A shape whose slice and E fit no CTA's shared memory (S=1024, and the
    largest S the streaming route takes) is routed to the streaming route by
    plan, before any launch, and matches the plain version in float64."""
    assert ms._device_plan_tv(B, S, 1, cuda) == ms.ScanPlan("stream")
    rng = np.random.default_rng(1000 + S)
    inputs = _tv_inputs(rng, B, T, S, cuda, with_L=True)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    _compare_tv(inputs, g, 1e-4, "stream")


def test_model_1vt_shape_takes_the_cluster_route(cuda):
    """At model_1vt's shape (B=32, S=256, A_t shared) the wrapper plans K2g's
    cluster route; one forward launch is counted on it."""
    plan = ms._device_plan_tv(32, 256, 1, cuda)
    assert plan.route == "cluster" and plan.cluster >= 8, plan
    rng = np.random.default_rng(4)
    alpha0, A, R, _ = _tv_inputs(rng, 32, 4, 256, cuda)
    n = dict(ms.tv_route_launches["cluster"])
    with torch.no_grad():
        ms.markov_scan_tv(alpha0, A, R)
    assert ms.tv_route_launches["cluster"]["forward"] == n["forward"] + 1


@pytest.mark.parametrize("route", TV_ROUTES)
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("per_row_A", [False, True])
def test_tv_scan_kernel_unreachable_states(cuda, seed, per_row_A, route):
    """Columns of A_t that no state reaches, -inf entries and -inf states
    of alpha0: -inf values where the plain version has them, no NaN, each
    gradient within 1e-3 * max|grad| of float64."""
    rng = np.random.default_rng(2000 + seed)
    B, T, S = (8, 63, 64) if per_row_A else (32, 127, 256)
    inputs = _tv_inputs(rng, B, T, S, cuda, per_row_A, unreachable=True, emission=-35.0)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    _compare_tv(inputs, g, 1e-3, route)


@pytest.mark.parametrize("route", TV_ROUTES)
@pytest.mark.parametrize("per_row_A", [False, True])
def test_tv_scan_kernel_underflow_case(cuda, per_row_A, route):
    """hs and A_t peak at different l, so that the cluster route's factored
    sum is 0 at half of the columns while the true value is finite: its
    exact recomputation (and the backward's class of exact weights) must
    match float64 there, beside the factored columns."""
    rng = np.random.default_rng(3000 + per_row_A)
    B, T, S = (4, 9, 64) if per_row_A else (32, 31, 256)
    inputs = _underflow_inputs(rng, B, T, S, cuda, per_row_A)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    out, _ = _compare_tv(inputs, g, 1e-3, route)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("route", TV_ROUTES)
@pytest.mark.parametrize("per_row_A", [False, True])
def test_tv_scan_reads_a_time_constant_transition_in_place(cuda, per_row_A, route):
    """A transition constant in time reaches K2g as an ``expand`` with time
    stride 0 (``ops/markov_product.py``): the kernels read it by its strides,
    match the plain version, and return dA in the expanded shape, which
    autograd sums over time into the base's gradient."""
    rng = np.random.default_rng(6 + per_row_A)
    B, T, S = 4, 7, 64
    alpha0, _, R, L = _tv_inputs(rng, B, T, S, cuda, with_L=True)
    base = _tv_inputs(rng, 1, 1, S, cuda, per_row_A=per_row_A)[1]  # (1, S, S) or (1, 1, S, S)
    g = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32, device=cuda)
    expand = (T, S, S) if not per_row_A else (T, B, S, S)
    leaves, ref = [], []
    for fn, dtype in ((ms.markov_scan_tv, torch.float32), (ms.markov_scan_tv_plain, torch.float64)):
        b = base.to(dtype).clone().requires_grad_()
        A = b.expand(*expand)
        assert A.stride(0) == 0
        args = [x.to(dtype) for x in (alpha0, A, R, L)]
        kwargs = {"plan": _tv_route(args, route)} if fn is ms.markov_scan_tv else {}
        out = fn(*args, **kwargs)
        (out * g.to(dtype)).sum().backward()
        ref.append(out.detach())
        leaves.append(b.grad)
    torch.testing.assert_close(ref[0].double(), ref[1], rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(leaves[0].double(), leaves[1], rtol=0, atol=1e-4 * leaves[1].abs().max().item())


def test_launch_after_a_refused_launch(cuda):
    """A refused cluster launch returns its error without reading the
    library's last-error state; the next launch of the library's kernels,
    K2g's and K2's, must not report it as its own."""
    rng = np.random.default_rng(6)
    refused = _scan_inputs(rng, 2, 3, 1024, cuda)
    with pytest.raises(RuntimeError):
        ms.markov_scan(*refused, plan=ms.ScanPlan("cluster", 8, 1))
    inputs = _tv_inputs(rng, 3, 6, 37, cuda)
    _compare_tv(inputs, torch.tensor(rng.normal(size=(3, 37)), dtype=torch.float32, device=cuda), 1e-4)
    with pytest.raises(RuntimeError):
        ms.markov_scan(*refused, plan=ms.ScanPlan("cluster", 8, 1))
    _compare_scan(_scan_inputs(rng, 3, 6, 37, cuda), torch.tensor(rng.normal(size=(3, 37)), dtype=torch.float32,
                                                                device=cuda))


@pytest.mark.parametrize("route", TV_ROUTES)
def test_tv_scan_backward_is_deterministic(cuda, route):
    """Two runs of K2g's backward (the reverse scan and the dA_t fold, sums
    in a fixed order, no float atomics) give the same bits."""
    rng = np.random.default_rng(5)
    inputs = _tv_inputs(rng, 32, 127, 256, cuda, with_L=True)
    alpha0, A, R, L = inputs
    g = torch.tensor(rng.normal(size=(32, 256)), dtype=torch.float32, device=cuda)
    with torch.no_grad():
        _, saved = ms._tv_forward_cuda(alpha0, A, R, L, plan=_tv_route(inputs, route))
    assert saved[0].route == route
    first = ms._tv_backward_cuda(A, L, saved, g)
    second = ms._tv_backward_cuda(A, L, saved, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_tv_scan_kernel_rejects_bad_operands(cuda):
    alpha0 = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        ms.markov_scan_tv(alpha0, torch.zeros(3, 8, 8, device=cuda), torch.zeros(2, 4, 8, device=cuda))
    with pytest.raises(TypeError):
        ms.markov_scan_tv(alpha0.double(), torch.zeros(3, 8, 8, device=cuda).double(),
                          torch.zeros(3, 4, 8, device=cuda).double())
    with pytest.raises(ValueError):
        ms.markov_scan_tv(alpha0, torch.zeros(3, 8, 8), torch.zeros(3, 4, 8, device=cuda))
    S = ms.MAX_STATES_TV + 1
    with pytest.raises(ValueError):
        ms.markov_scan_tv(torch.zeros(1, S, device=cuda), torch.zeros(1, S, S, device=cuda),
                          torch.zeros(1, 1, S, device=cuda))


def test_model_1vt_on_the_card_runs_k2g_not_the_plain_loop(cuda, monkeypatch):
    """A time-varying chain on CUDA tensors goes through K2g: one launch
    each way a step, no K2, and the plain loop never sees a CUDA tensor.  The step's loss and gradients match the
    port's float64 CPU run (loss rtol 1e-5, gradients within 1e-3 times
    their largest entry)."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.infer import TraceEnum_ELBO

    def guard(name):
        plain = getattr(ms, name)

        def guarded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                pytest.fail(f"a CUDA tensor reached {name}")
            return plain(*args, **kwargs)

        return guarded

    monkeypatch.setattr(ms, "markov_scan_tv_plain", guard("markov_scan_tv_plain"))
    args = example.parse_args(["--model", "1vt", "--hidden-dim", "6", "--num-sequences", "3", "--max-length", "11",
                               "--data-dim", "5"])
    names = ("AutoDelta.probs_x", "AutoDelta.probs_y")
    elbo = TraceEnum_ELBO(max_plate_nesting=3)
    store = pyro.get_param_store()
    try:
        pyro.set_default_device("cuda")
        pyro.clear_param_store()
        sequences, lengths = example.synthetic_sequences(0, 3, 11, 5)
        model, guide, _ = example.make_svi(args)
        elbo.loss(model, guide, sequences, lengths)  # registers the params
        values = {k: store.get_unconstrained(k).detach().double().cpu() for k in names}
        n, k2 = dict(ms.tv_launches), dict(ms.launches)
        loss = elbo.differentiable_loss(model, guide, sequences, lengths)
        loss.backward()
        torch.cuda.synchronize()
        assert ms.tv_launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1}
        assert ms.launches == k2
        loss32, g32 = float(loss.detach()), {k: store.get_unconstrained(k).grad.double().cpu() for k in names}

        pyro.set_default_device("cpu")
        torch.set_default_dtype(torch.float64)
        pyro.clear_param_store()
        sequences, lengths = sequences.double().cpu(), lengths.cpu()
        model, guide, _ = example.make_svi(args)
        elbo.loss(model, guide, sequences, lengths)
        for k, v in values.items():
            store.set_unconstrained(k, v)
        loss = elbo.differentiable_loss(model, guide, sequences, lengths)
        loss.backward()
        loss64, g64 = float(loss.detach()), {k: store.get_unconstrained(k).grad for k in names}
    finally:
        torch.set_default_dtype(torch.float32)
        pyro.clear_param_store()
        pyro.set_default_device("cuda")
    assert loss32 == pytest.approx(loss64, rel=1e-5)
    for k in g64:
        torch.testing.assert_close(g32[k], g64[k], rtol=0, atol=1e-3 * float(g64[k].abs().max()))


@pytest.mark.parametrize("case", [3, 5, 9])
def test_pairwise_fallback_on_the_card(cuda, case):
    """The O(log T) fallback of vectorized chains (model_3, model_5 with
    history 2, model_7 at T=23) through K3f on the card (their windows hold
    at most 64 states): the loss and every param's gradient against the
    port's float64 CPU run (loss rtol 1e-5, gradients rtol 1e-4 with atol
    1e-5 * max|grad|), K3f launched each way."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import vectorized_markov as vm
    from pyro_tpu_torch.infer import TraceEnum_ELBO
    from pyro_tpu_torch.ops import markov_product

    model, kind, shape, history = vm.CASES[case]
    out = []
    try:
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            pyro.set_default_device(device)
            torch.set_default_dtype(dtype)
            pyro.clear_param_store()
            data = vm.make_data(kind, shape)
            n = dict(lm.chain_launches)
            markov_product.reset_routes()
            with poutine.trace(param_only=True) as capture:
                loss = TraceEnum_ELBO(max_plate_nesting=3).differentiable_loss(model, vm.no_guide, data, history, True)
            loss.backward()
            assert markov_product.routes["pairwise"] == 1
            if device == "cuda":
                torch.cuda.synchronize()
                assert lm.chain_launches["forward"] > n["forward"] and lm.chain_launches["backward"] > n["backward"]
            store = pyro.get_param_store()
            out.append((float(loss.detach()), {k: store.get_unconstrained(k).grad.double().cpu()
                                      for k in capture.trace.param_nodes()}))
    finally:
        torch.set_default_dtype(torch.float32)
        pyro.clear_param_store()
        pyro.set_default_device("cuda")
    (loss32, g32), (loss64, g64) = out
    assert loss32 == pytest.approx(loss64, rel=1e-5)
    assert sorted(g32) == sorted(g64)
    for k in g64:
        torch.testing.assert_close(g32[k], g64[k], rtol=1e-4, atol=1e-5 * float(g64[k].abs().max()))


# -- the GP time series' state dims: n of 1 and 2 (IndependentMaternGP at nu 0.5
# and 1.5) and 28 (DependentMaternGP at 14 channels) ----------------------------------

GP_DIMS = [1, 2, 28]


@pytest.mark.parametrize("n", GP_DIMS)
def test_k4a_forward_and_backward_at_the_gp_state_dims(cuda, n):
    """K4a with its tape, then its backward from that tape, against the
    plain versions at 14 rows of 749 pairs (DependentMaternGP's chain of
    14,980 steps is one row of 7490 pairs at its first level)."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R, m = 14, 749
    gen = torch.Generator(device="cuda").manual_seed(100 + n)
    P = _spd(gen, (), 2 * n, cuda)
    info = torch.randn(R, 2 * m, 2 * n, generator=gen, device=cuda)
    logZ = torch.randn(R, 2 * m, generator=gen, device=cuda)
    out_k = gl.halving_level(P, info, logZ, tape=True)
    out_p = gl.halving_level_plain(P, info, logZ, tape=True)
    for a, b in zip(out_k, out_p):
        _assert_near(a, b)
    _, _, _, L, ib = out_k
    grads = (torch.randn(2 * n, 2 * n, generator=gen, device=cuda), torch.randn(R, m, 2 * n, generator=gen, device=cuda),
             torch.randn(R, m, generator=gen, device=cuda))
    before = gl.launches["halving_bwd"]
    back_k = gl._halving_bwd_cuda(P, L, ib, *grads)
    back_p = gl.halving_level_bwd_plain(P, L, ib, *grads)
    torch.cuda.synchronize()
    assert gl.launches["halving_bwd"] == before + 1
    _assert_near(_sym(back_k[0]), _sym(back_p[0]))
    for a, b in zip(back_k[1:], back_p[1:]):
        _assert_near(a, b)


@pytest.mark.parametrize("n", GP_DIMS)
def test_k4b_forward_and_backward_at_the_gp_state_dims(cuda, n):
    """K4b at IndependentMaternGP's layout, 14 channels each with one
    precision read with stride 0 over an odd 7491 steps, with its tape, then
    its backward from that tape, against the plain versions."""
    from pyro_tpu_torch.ops import gaussian_levels as gl

    R, t = 14, 7491
    gen = torch.Generator(device="cuda").manual_seed(200 + n)
    P, info, logZ = _contract_inputs(gen, R, t, n, "stride0_time", cuda)
    before = gl.launches["contract"]
    *out_k, tape = gl.contract_pairs(P, info, logZ, tape=True)
    *out_p, _ = gl.contract_pairs_plain(P, info, logZ, tape=True)
    assert gl.launches["contract"] == before + 1
    for a, b in zip(out_k, out_p):
        _assert_near(a, b)
    t_out = t - t // 2
    grads = (torch.randn(R, t_out, 2 * n, 2 * n, generator=gen, device=cuda),
             torch.randn(R, t_out, 2 * n, generator=gen, device=cuda), torch.randn(R, t_out, generator=gen, device=cuda))
    back_k = gl._contract_bwd_cuda(t, *tape, *grads)
    back_p = gl.contract_pairs_bwd_plain(t, *tape, *grads)
    torch.cuda.synchronize()
    _assert_near(_sym(back_k[0]), _sym(back_p[0]))
    for a, b in zip(back_k[1:], back_p[1:]):
        _assert_near(a, b)


def test_independent_matern_gp_step_at_the_eeg_shape(cuda):
    """One maximum-likelihood step of IndependentMaternGP (nu 1.5) on the
    synthetic series of the EEG shape (14 channels, 14,980 steps) through
    K4b and its backward, against the port's float64 CPU run: loss rtol
    1e-5, each gradient within 1e-3 times its largest entry."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import timeseries_gp as example
    from pyro_tpu_torch.infer import Trace_ELBO
    from pyro_tpu_torch.ops import gaussian_levels as gl

    series = example.synthetic_series(0, 14_980, 14)
    out = []
    pyro.clear_param_store()
    try:
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            pyro.set_default_device(device)
            pyro.clear_param_store()
            gp = example.make_gp("imgp", "eeg", name="gp")
            if dtype == torch.float64:
                from pyro_tpu_torch.params import param_store_from_jax

                gp.get_dist()
                param_store_from_jax({k: v.astype(np.float64) for k, v in init.items()})
            else:
                gp.get_dist()
                init = {k: pyro.get_param_store()[k].detach().cpu().numpy()
                        for k in pyro.get_param_store().get_all_unconstrained()}
            gl.reset_counts()
            with poutine.trace(param_only=True) as capture:
                loss = Trace_ELBO().differentiable_loss(example.make_model(gp), lambda *a: None,
                                                        torch.tensor(series, dtype=dtype, device=device))
            loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                assert gl.launches["contract"] > 0 and gl.launches["contract_bwd"] > 0, dict(gl.launches)
            store = pyro.get_param_store()
            out.append((float(loss.detach()), {k: store.get_unconstrained(k).grad.detach().double().cpu()
                                               for k in capture.trace.param_nodes()}))
    finally:
        pyro.clear_param_store()
        pyro.set_default_device("cuda")
    (loss32, g32), (loss64, g64) = out
    assert loss32 == pytest.approx(loss64, rel=1e-5)
    for k in g64:
        torch.testing.assert_close(g32[k], g64[k], rtol=0, atol=1e-3 * float(g64[k].abs().max()))


# -- the kernels under torch.func, and the NUTS leaf over an enumerated potential ----------

# (x shape, y shape, x mapped, y mapped), the chain dim C=8 leading a mapped operand
VMAP_K1_CASES = {
    "x-mapped": ((20, 16, 16), (16, 16), True, False),
    "y-mapped": ((20, 1, 16), (16, 16), False, True),
    "both": ((20, 16, 16), (20, 16, 16), True, True),
    "x-unmapped-batched": ((5, 1, 16, 24), (3, 24, 16), False, True),
}


@pytest.mark.parametrize("name", sorted(VMAP_K1_CASES))
def test_k1_under_vmap_grad_matches_plain(cuda, name):
    """vmap(grad) over 8 chains through K1 (the chains folded into its
    batch: one launch each way) against the same through the plain
    version, an operand without the chain dim among the cases."""
    xs, ys, xm, ym = VMAP_K1_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    x = torch.randn(((8,) if xm else ()) + xs, generator=gen, device=cuda)
    y = torch.randn(((8,) if ym else ()) + ys, generator=gen, device=cuda)
    w = torch.randn((8,) + torch.broadcast_shapes(xs[:-2], ys[:-2]) + (xs[-2], ys[-1]), generator=gen, device=cuda)
    in_dims = (0 if xm else None, 0 if ym else None, 0)

    def loss(fn):
        return lambda x, y, w: (fn(x, y) * w).sum()

    before = dict(lm.launches)
    got = torch.func.vmap(torch.func.grad_and_value(loss(lm.logmatmulexp), argnums=(0, 1)), in_dims=in_dims)(x, y, w)
    torch.cuda.synchronize()
    assert lm.launches == {"forward": before["forward"] + 1, "backward": before["backward"] + 1}
    want = torch.func.vmap(torch.func.grad_and_value(loss(lm.logmatmulexp_plain), argnums=(0, 1)),
                           in_dims=in_dims)(x, y, w)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    for a, b in zip(got[0], want[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("shared_A", [False, True])
def test_k2_under_vmap_grad_matches_plain(cuda, shared_A):
    """vmap(grad) over 8 chains through K2 (the chains folded into its rows:
    one forward launch; the backward one launch, or one a chain where A is
    shared) against the same through the plain scan."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    C, B, T, S = 8, 20, 31, 16
    A = torch.randn((S, S) if shared_A else (C, S, S), generator=gen, device=cuda)
    alpha0 = torch.randn(C, B, S, generator=gen, device=cuda)
    R = torch.randn(C, T, B, S, generator=gen, device=cuda)
    in_dims = (0, None if shared_A else 0, 0)

    def loss(fn):
        return lambda alpha0, A, R: fn(alpha0, A, R).logsumexp(-1).sum()

    argnums = (0, 1, 2)
    ms.reset_counts()
    got = torch.func.vmap(torch.func.grad(loss(ms.markov_scan), argnums=argnums), in_dims=in_dims)(alpha0, A, R)
    torch.cuda.synchronize()
    assert ms.launches == {"forward": 1, "backward": C if shared_A else 1}
    want = torch.func.vmap(torch.func.grad(loss(ms.markov_scan_plain), argnums=argnums), in_dims=in_dims)(alpha0, A, R)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


def test_nuts_leaf_over_the_enumerated_potential_replays_to_the_same_result(cuda):
    """NUTS on model_1 (8 sequences, T=12, 16 tones, 8 states; K1 inside
    the potential): the leaf is captured as a CUDA graph; two subtrees
    built by replays from the same inputs are bitwise equal, and equal the
    same subtree with the leaf run eagerly within 1e-5 of each field's
    largest entry."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.infer import NUTS
    from pyro_tpu_torch.infer.mcmc.nuts import _Leaves

    pyro.set_default_device("cuda")
    args = example.parse_args(["--model", "1", "--hidden-dim", "8", "--num-sequences", "8", "--max-length", "12",
                               "--data-dim", "16"])
    data = example.synthetic_sequences(0, 8, 12, 16)

    class EagerNUTS(NUTS):
        def _leaves(self, C, n_dim, like):
            return self._leaf_buffers.setdefault((C, n_dim), _Leaves(C, n_dim, self.max_tree_depth, like))

    kernels = [NUTS(example.model_1, max_plate_nesting=2), EagerNUTS(example.model_1, max_plate_nesting=2)]
    for k in kernels:
        k.setup(0, *data, args, generator=torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    z = kernels[0]._draw_init(gen, 8)
    pe, grad = kernels[0]._potential_and_grad(z)
    r = torch.randn(z.shape, generator=gen, device=cuda)
    inv = torch.ones_like(z)
    energy0 = pe + 0.5 * (r * r).sum(-1)
    direction = torch.where(torch.rand(pe.shape, generator=gen, device=cuda) < 0.5, 1.0, -1.0)
    step = torch.full_like(pe, 0.01)

    def subtree(k):
        return k._build_subtree(3, z, r, grad, energy0, direction, step, inv,
                                torch.Generator(device=cuda).manual_seed(2))[0]

    first, second, eager = subtree(kernels[0]), subtree(kernels[0]), subtree(kernels[1])
    assert all(b.graph is not None for b in kernels[0]._leaf_buffers.values())
    for name, a, b, c in zip(first._fields, first, second, eager):
        assert torch.equal(a, b), name
        a, c = a.double(), c.double()
        assert float((a - c).abs().max()) <= 1e-5 * float(c.abs().max()) + 1e-6, name


# -- forecasting at the length of upstream's BART counts (T = 78,888) ------------------


def _record(module, name, calls):
    """``module.<name>`` wrapped so that each call's arguments and result
    land in ``calls``."""
    fn = getattr(module, name)

    def recorder(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    return recorder


def _long_forecast_model(cuda):
    """The example's Model over the synthetic series of 78,888 hours, its
    latents fixed (the weekly profile at the training window's hour-of-week
    means, both scales 0.1)."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import forecast_bart as example

    pyro.set_default_device("cuda")
    data, t_train = example.synthetic_total_ridership(0)
    weeks = data[:t_train - t_train % 168].reshape(-1, 168, 1)
    latent = {"weekly": weeks.mean(0), "trans_scale": torch.tensor(0.1, device=cuda),
              "obs_scale": torch.tensor(0.1, device=cuda)}
    return example.Model(), data, t_train, latent


def test_forecast_training_step_levels_at_the_bart_length(cuda, monkeypatch):
    """One gradient of the example model's log joint over the 78,552-hour
    training window: every K4b level it launches, forward (with its tape)
    and backward, against the plain versions at the same inputs."""
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.ops import gaussian_levels as gl

    model, data, t_train, latent = _long_forecast_model(cuda)
    cov = data.new_zeros((t_train, 0))
    fwd, bwd = [], []
    monkeypatch.setattr(gl, "contract_pairs", _record(gl, "contract_pairs", fwd))
    monkeypatch.setattr(gl, "_contract_bwd_cuda", _record(gl, "_contract_bwd_cuda", bwd))
    z = {k: v.clone().requires_grad_() for k, v in latent.items()}
    gl.reset_counts()
    trace = poutine.trace(poutine.condition(model, data=z)).get_trace(data[:t_train], cov)
    trace.log_prob_sum().backward()
    torch.cuda.synchronize()
    assert fwd and bwd and gl.launches["contract"] == len(fwd) and gl.launches["contract_bwd"] == len(bwd)
    with torch.no_grad():
        for args, kwargs, out in fwd:
            for a, b in zip(out[:3], gl.contract_pairs_plain(*args, **kwargs)[:3]):
                _assert_near(a, b)
        for args, _, out in bwd:
            want = gl.contract_pairs_bwd_plain(*args)
            _assert_near(_sym(out[0]), _sym(want[0]))
            for a, b in zip(out[1:], want[1:]):
                _assert_near(a, b)
    assert all(bool(torch.isfinite(v.grad).all()) for v in z.values())


def test_forecast_call_levels_at_the_bart_length(cuda, monkeypatch):
    """One forecast of the 336 held-out hours after the 78,552-hour window:
    the filter's K4b levels, the draw's K4b levels (with their tapes) and
    its K4c levels, each against the plain version at the same inputs."""
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.ops import gaussian_levels as gl

    model, data, t_train, latent = _long_forecast_model(cuda)
    cov = data.new_zeros((data.shape[0], 0))
    contract, mids = [], []
    monkeypatch.setattr(gl, "contract_pairs", _record(gl, "contract_pairs", contract))
    monkeypatch.setattr(gl, "level_mids", _record(gl, "level_mids", mids))
    gl.reset_counts()
    with torch.no_grad(), poutine.seed(rng_seed=torch.Generator(device=cuda).manual_seed(0)):
        forecast = poutine.condition(model, data=latent)(data[:t_train], cov)
        torch.cuda.synchronize()
        assert forecast.shape == (data.shape[0] - t_train, 1) and bool(torch.isfinite(forecast).all())
        assert gl.launches["contract"] == len(contract) > 0 and gl.launches["mids"] == len(mids) > 0
        for args, kwargs, out in contract:
            for a, b in zip(out[:3], gl.contract_pairs_plain(*args, **kwargs)[:3]):
                _assert_near(a, b)
        for args, _, out in mids:
            _assert_near(out, gl.level_mids_plain(*args))


# -- K3f: the chain of small log-space factors -------------------------------------------

CHAIN_CASES = [(T, (3,), S) for T in (2, 3, 5, 20, 60) for S in (1, 16, 64)] + [(33, (2, 2, 2, 2), 8)]


def _chain_inputs(gen, T, batch, S, cuda, neg_inf=0.0, strided=False):
    x = 3 * torch.randn((T,) + batch + (S, S), generator=gen, device=cuda)
    if neg_inf:
        x = torch.where(torch.rand(x.shape, generator=gen, device=cuda) < neg_inf, -torch.inf, x)
        x[0, ..., 0, :] = -torch.inf  # an all -inf row
        x[-1, ..., :, S // 2] = -torch.inf  # an all -inf column
    if strided:
        big = torch.randn((T,) + batch + (S, 2 * S), generator=gen, device=cuda)
        big[..., :S] = x
        x = big[..., :S]
    return x


def _compare_chain(x, g):
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = lm.log_chain(xk)
    ref = lm.sequential_logmatmulexp_plain(xp)
    out.backward(g)
    ref.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(out == -torch.inf, ref == -torch.inf) and not torch.isnan(out).any()
    finite = torch.isfinite(ref)
    if finite.any():
        scale = float(ref[finite].abs().max())
        torch.testing.assert_close(out[finite], ref[finite], rtol=0, atol=1e-5 * scale + 1e-5)
    assert not torch.isnan(xk.grad).any()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=0, atol=1e-4 * float(xp.grad.abs().max()) + 1e-30)
    return out.detach()


@pytest.mark.parametrize("T,batch,S", CHAIN_CASES)
def test_chain_kernel_matches_plain(cuda, T, batch, S):
    gen = torch.Generator(device=cuda).manual_seed(T * 100 + S)
    x = _chain_inputs(gen, T, batch, S, cuda)
    g = torch.randn(x.shape[1:], generator=gen, device=cuda)
    n = dict(lm.chain_launches)
    out = _compare_chain(x, g)
    assert lm.chain_launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1}
    assert torch.equal(out, lm.log_chain(x))  # two launches bit-equal


@pytest.mark.parametrize("T,batch,S,strided", [(20, (4,), 16, False), (60, (4,), 64, False), (20, (2, 3), 16, True)])
def test_chain_kernel_neg_inf(cuda, T, batch, S, strided):
    gen = torch.Generator(device=cuda).manual_seed(T + S)
    x = _chain_inputs(gen, T, batch, S, cuda, neg_inf=0.3, strided=strided)
    out = _compare_chain(x, torch.randn(x.shape[1:], generator=gen, device=cuda))
    assert (out == -torch.inf).any()


def test_chain_kernel_infeasible_chain_under_logsumexp(cuda):
    """Every path of one row -inf: the row is -inf and no NaN reaches the
    factors through the logsumexp's NaN adjoint."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _chain_inputs(gen, 7, (2,), 16, cuda).requires_grad_()
    with torch.no_grad():
        x[3, 0] = -torch.inf
    lse = torch.logsumexp(lm.log_chain(x), dim=(-2, -1))
    lse.sum().backward()
    torch.cuda.synchronize()
    assert torch.isneginf(lse[0]) and torch.isfinite(lse[1])
    assert not torch.isnan(x.grad).any() and bool((x.grad[:, 0] == 0).all())


def test_chain_vmap_grad_is_one_launch_each_way(cuda):
    x = torch.randn(4, 20, 16, 16, device=cuda)
    lm.reset_chain_counts()

    def f(fn):
        return lambda z: torch.logsumexp(fn(z), dim=(-2, -1))

    got = torch.func.vmap(torch.func.grad(f(lm.log_chain)))(x)
    assert lm.chain_launches == {"forward": 1, "backward": 1}
    want = torch.func.vmap(torch.func.grad(f(lm.sequential_logmatmulexp_plain)))(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_chain_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        lm.log_chain(torch.zeros(3, 4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        lm.log_chain(torch.zeros(3, 65, 65, device=cuda))
    lm.reset_chain_counts()
    out = lm.sequential_logmatmulexp_timemajor(torch.zeros(3, 65, 65, device=cuda))  # K1's rounds
    assert lm.routes == {"chain": 0, "rounds": 1} and out.shape == (65, 65)


def test_quantized_sir_potential_on_the_card(cuda):
    """The quantized SIR model's log joint and gradient through K3f against
    the port's float64 CPU run at the same point."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.contrib.epidemiology import SimpleSIRModel

    data = np.array([1, 2, 3, 5, 4, 6, 8, 5, 7, 6, 4, 5], np.float32)
    rng = np.random.default_rng(0)
    infections = np.cumsum(data) * 1.6
    aux = np.stack([199 - infections, 1 + 0.6 * infections]) + rng.uniform(0, 1, (2, len(data)))
    point = {"R0": 1.7, "rho": 0.45, "auxiliary": aux}
    out = []
    try:
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            pyro.set_default_device(device)
            torch.set_default_dtype(dtype)
            m = SimpleSIRModel(200, 4.0, torch.tensor(data))
            m.num_quant_bins, m.relaxed = 4, False
            values = {k: torch.tensor(np.asarray(v), dtype=dtype, device=device, requires_grad=True)
                      for k, v in point.items()}
            n = dict(lm.chain_launches)
            tr = poutine.trace(poutine.condition(m._quantized_model, data=values)).get_trace()
            lj = tr.log_prob_sum(site_filter=lambda name, site: not site["infer"].get("_deterministic"))
            lj.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                assert lm.chain_launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1}
            out.append((float(lj.detach()), {k: v.grad.double().cpu() for k, v in values.items()}))
    finally:
        torch.set_default_dtype(torch.float32)
        pyro.set_default_device("cuda")
    (lj32, g32), (lj64, g64) = out
    assert abs(lj32 - lj64) <= 1e-5 * abs(lj64) + 1e-5
    scale = max(float(g.abs().max()) for g in g64.values())
    for k in g64:
        torch.testing.assert_close(g32[k], g64[k], rtol=0, atol=1e-3 * scale)
