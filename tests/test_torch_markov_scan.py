"""The port's Markov-chain scan (``ops/markov_scan.py``, K2's plain version)
and its chain elimination (``ops/markov_product.py::_try_scan_elimination``)
against a float64 forward filter and the JAX package, on the CPU.

The same packed factors (an initial potential ``alpha0`` over the chain's
first state, a transition ``A`` shared by the plate rows or one per row, or
one per step, emissions ``R`` on the current state and ``L`` on the
previous one) go through the port's and the JAX ``_try_scan_elimination``;
gradients go against ``jax.vjp`` of the JAX scan and against torch autograd
of a float64 direct form with the same clip at FLT_MIN.
Tolerances: values rtol 1e-5 with atol 1e-5 (float32 carries of size T
times the emission scale); gradients rtol 1e-4 with atol 1e-5 * max|grad|
(float32 products summed in another order).
"""

import functools
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro_tpu.ops import markov_product as jmp
from pyro_tpu.ops import packed as jpacked
import pyro_tpu_torch as pyro
from pyro_tpu_torch.ops import markov_product as tmp
from pyro_tpu_torch.ops import markov_scan as ms
from pyro_tpu_torch.ops import packed as tpacked

FLT_MIN = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _case(seed, B, T, S, per_row_A=False, with_L=False, emission=0.0, time_varying=False):
    rng = np.random.default_rng(seed)
    a_dims, shape_A = ("tlr", (T, S, S)) if time_varying else ("blr", (B, S, S)) if per_row_A else ("lr", (S, S))
    A = rng.normal(size=shape_A) * 2
    A = A - np.log(np.exp(A).sum(-1, keepdims=True))  # log transition probabilities
    out = {
        "alpha0": rng.normal(size=(B, S)),
        "A": A,
        "R": rng.normal(size=(T, B, S)) + emission,
        "L": rng.normal(size=(T, B, S)) if with_L else None,
        "g": rng.normal(size=(B, S)),
    }
    out = {k: None if v is None else v.astype(np.float32) for k, v in out.items()}
    out["a_dims"] = a_dims
    return out


def _neg_inf_A():
    c = _case(3, 4, 6, 7)
    diag = np.diag(c["A"]).copy()
    c["A"][c["A"] < -3.0] = -np.inf
    # every state keeps itself reachable, but for state 2, which no
    # transition reaches: its log-potential is clipped to log(FLT_MIN) at
    # every step
    np.fill_diagonal(c["A"], diag)
    c["A"][:, 2] = -np.inf
    return c


def _neg_inf_row():
    c = _case(4, 4, 6, 7)
    c["alpha0"][1] = -np.inf
    return c


CASES = {
    "shared": lambda: _case(0, 4, 6, 7),
    "with_L": lambda: _case(1, 3, 7, 5, with_L=True),
    "per_row_A": lambda: _case(2, 3, 6, 5, per_row_A=True, with_L=True),
    "neg_inf_A": _neg_inf_A,
    "neg_inf_row": _neg_inf_row,
    "large_emissions": lambda: _case(5, 4, 6, 7, emission=-35.0),
}
def _direct64(a_dims, alpha0, A, R, L=None):
    """alpha_T by the definition, in float64 torch, with detached shifts
    and the clip at FLT_MIN; A (S, S), (B, S, S) or, one per step, (T, S, S)."""
    finite = lambda v: torch.where(torch.isfinite(v), v, torch.zeros_like(v))  # noqa: E731
    alpha = alpha0
    for t in range(R.shape[0]):
        At = A[t] if a_dims == "tlr" else A
        h = alpha if L is None else alpha + L[t]
        m = finite(h.detach().amax(-1, keepdim=True))
        c = finite(At.detach().amax(-2, keepdim=True))
        if At.ndim == 2:
            z = torch.exp(h - m) @ torch.exp(At - c)
        else:
            z = torch.einsum("bl,blr->br", torch.exp(h - m), torch.exp(At - c))
        alpha = torch.log(z.clamp(min=FLT_MIN)) + m + c.squeeze(-2) + R[t]
    return alpha


def _torch_leaves(c, dtype=torch.float32):
    return [
        None if c[k] is None else torch.tensor(c[k], dtype=dtype, requires_grad=True)
        for k in ("alpha0", "A", "R", "L")
    ]


def _grads(leaves):
    return [None if x is None else x.grad.numpy() for x in leaves]


def _close(actual, expected, rtol=1e-4):
    for a, e in zip(actual, expected):
        if e is None:
            continue
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, e, rtol=rtol, atol=1e-5 * np.abs(e).max())


def _filter64(c):
    """alpha_T by a float64 numpy forward filter with the clip at FLT_MIN."""
    A = c["A"].astype(np.float64)
    alpha = c["alpha0"].astype(np.float64)
    for t in range(c["R"].shape[0]):
        h = alpha if c["L"] is None else alpha + c["L"][t]
        At = A[t] if c["a_dims"] == "tlr" else A
        m = np.nan_to_num(h.max(-1, keepdims=True), neginf=0.0)
        cA = np.nan_to_num(At.max(-2, keepdims=True), neginf=0.0)
        if At.ndim == 2:
            z = np.exp(h - m) @ np.exp(At - cA)
        else:
            z = np.einsum("bl,blr->br", np.exp(h - m), np.exp(At - cA))
        alpha = np.log(np.maximum(z, FLT_MIN)) + m + cA[..., 0, :] + c["R"][t]
    return alpha


@pytest.mark.parametrize("name", list(CASES))
def test_plain_scan_forward_matches_float64_filter(name):
    c = CASES[name]()
    out = ms.markov_scan_plain(*(None if c[k] is None else torch.tensor(c[k]) for k in ("alpha0", "A", "R", "L")))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), _filter64(c), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_scan_gradients_match_float64(name):
    c = CASES[name]()
    leaves = _torch_leaves(c)
    (ms.markov_scan_plain(*leaves) * torch.tensor(c["g"])).sum().backward()
    leaves64 = _torch_leaves(c, torch.float64)
    (_direct64(c["a_dims"], *leaves64) * torch.tensor(c["g"], dtype=torch.float64)).sum().backward()
    _close(_grads(leaves), _grads(leaves64))


def _eliminate(pkg, a_dims, alpha0, A, R, L):
    """Run ``pkg``'s ``_try_scan_elimination`` on the chain x_0 -> x_t with
    plate b (rows), time t; returns the packed result's value."""
    mp, packed = pkg
    (T, B, S) = R.shape
    reduced = [packed.PackedTensor(A, a_dims), packed.PackedTensor(R, "tbr")]
    if L is not None:
        reduced.append(packed.PackedTensor(L, "tbl"))
    log_factors = OrderedDict([(frozenset("b"), [packed.PackedTensor(alpha0, "bx")])])
    sum_dims = {"x", "l", "r"}
    ok = mp._try_scan_elimination(
        log_factors, sum_dims, reduced, "x", "l", "r", S, "t", frozenset("b"), {"b": B, "t": T}
    )
    assert ok and sum_dims == {"r"}
    (term,) = log_factors[frozenset("b")]
    assert term.dims == "br"
    return term.value


@functools.partial(jax.jit, static_argnums=0)
def _jax_value_and_grads(a_dims, alpha0, A, R, L, g):
    def f(*args):
        out = _eliminate((jmp, jpacked), a_dims, *args)
        return (out * g).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(alpha0, A, R, L)
    return out, grads


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for name, make in CASES.items():
        c = make()
        args = [None if c[k] is None else jnp.asarray(c[k]) for k in ("alpha0", "A", "R", "L", "g")]
        out, grads = _jax_value_and_grads(c["a_dims"], *args)
        runs[name] = np.asarray(out), [None if x is None else np.asarray(x) for x in grads]
    return runs


def _port_elimination(c):
    leaves = _torch_leaves(c)
    out = _eliminate((tmp, tpacked), c["a_dims"], *leaves)
    (out * torch.tensor(c["g"])).sum().backward()
    return out.detach().numpy(), _grads(leaves)


@pytest.mark.parametrize("name", list(CASES))
def test_elimination_matches_jax(jax_runs, name):
    out, _ = _port_elimination(CASES[name]())
    np.testing.assert_allclose(out, jax_runs[name][0], rtol=1e-5, atol=1e-5)


# an all -inf column of A or row of alpha0 meets the fault of the JAX
# package's logmatmulexp backward (ROADMAP.md Queue 3): its shifts span
# every row and column, so the clipped entry's -log Z sets them and the
# other terms underflow; the port's gradients there are held against the
# float64 direct form above
_JAX_BWD_FAULT = pytest.mark.xfail(
    strict=True, reason="pyro_tpu/ops/log_matmul.py::_bwd shift fault, ROADMAP.md Queue 3"
)


@pytest.mark.parametrize(
    "name", [pytest.param(n, marks=_JAX_BWD_FAULT) if n in ("neg_inf_A", "neg_inf_row") else n for n in CASES]
)
def test_elimination_gradients_match_jax(jax_runs, name):
    _, grads = _port_elimination(CASES[name]())
    _close(grads, jax_runs[name][1])


def test_time_varying_transition_matches_jax():
    """A transition with a time axis takes the elementwise body in both."""
    c = _case(6, 3, 5, 4, with_L=True, time_varying=True)
    out, grads = _port_elimination(c)
    args = [jnp.asarray(c[k]) for k in ("alpha0", "A", "R", "L", "g")]
    jout, jgrads = _jax_value_and_grads(c["a_dims"], *args)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    _close(grads, [np.asarray(x) for x in jgrads])
    leaves64 = _torch_leaves(c, torch.float64)
    np.testing.assert_allclose(out, _direct64(c["a_dims"], *leaves64).detach().numpy(), rtol=1e-5, atol=1e-5)


def _unreachable():
    """Structural zeros of A leave a quarter of the states unreachable from
    alpha0's support: their z is 0, clipped at FLT_MIN, at the first step."""
    B, T, S = 4, 20, 16
    rng = np.random.default_rng(11)
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    A[: S // 4, 3 * S // 4:] = -np.inf
    alpha0 = rng.normal(size=(B, S))
    alpha0[:, S // 4:] = -np.inf
    out = {"alpha0": alpha0, "A": A, "R": rng.normal(size=(T, B, S)) * 3 - 35.0, "L": None,
           "g": rng.normal(size=(B, S))}
    out = {k: None if v is None else v.astype(np.float32) for k, v in out.items()}
    out["a_dims"] = "lr"
    return out


def test_plain_scan_unreachable_states_match_float64():
    """Each gradient, dalpha0 among them, within 1e-4 * max|grad| of the
    float64 direct form."""
    c = _unreachable()
    leaves = _torch_leaves(c)
    (ms.markov_scan_plain(*leaves) * torch.tensor(c["g"])).sum().backward()
    leaves64 = _torch_leaves(c, torch.float64)
    (_direct64(c["a_dims"], *leaves64) * torch.tensor(c["g"], dtype=torch.float64)).sum().backward()
    for a, e in zip(_grads(leaves), _grads(leaves64)):
        if e is not None:
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, e, rtol=0, atol=1e-4 * np.abs(e).max())


@pytest.mark.parametrize("seed", range(5))
def test_plain_scan_long_unreachable_chain_matches_float64(seed):
    """The float32 plain scan over 127 dependent steps of unreachable-states
    data (emissions about -35 a step, so the true carry drifts to about
    -4400): each gradient within 1e-3 * max|grad| of float64, on every seed.
    The carry is kept shifted near 0 (ROADMAP.md Queue 3, the float32
    carry); unshifted, float32 rounding of h - m near -4400 put the
    gradients about 1e-3 * max|grad| from float64."""
    B, T, S = 8, 127, 64
    rng = np.random.default_rng(100 + seed)
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    A[: S // 4, 3 * S // 4:] = -np.inf
    alpha0 = rng.normal(size=(B, S))
    alpha0[:, S // 4:] = -np.inf
    c = {"alpha0": alpha0, "A": A, "R": rng.normal(size=(T, B, S)) * 3 - 35.0, "L": None}
    g = rng.normal(size=(B, S))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        leaves = _torch_leaves(c, dtype)
        (ms.markov_scan_plain(*leaves) * torch.tensor(g, dtype=dtype)).sum().backward()
        grads[dtype] = _grads(leaves)
    for a, e in zip(grads[torch.float32], grads[torch.float64]):
        if e is not None:
            assert np.isfinite(a).all()
            assert np.abs(a - e).max() <= 1e-3 * np.abs(e).max()


@_JAX_BWD_FAULT
def test_elimination_unreachable_states_match_jax():
    c = _unreachable()
    _, grads = _port_elimination(c)
    args = [None if c[k] is None else jnp.asarray(c[k]) for k in ("alpha0", "A", "R", "L", "g")]
    _, jgrads = _jax_value_and_grads(c["a_dims"], *args)
    _close(grads, [None if x is None else np.asarray(x) for x in jgrads])


def test_scan_rejects_bad_shapes():
    alpha0 = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ms.markov_scan(alpha0, torch.zeros(8, 8), torch.zeros(3, 4, 9))
    with pytest.raises(ValueError):
        ms.markov_scan(alpha0, torch.zeros(3, 8, 8), torch.zeros(3, 4, 8))
    with pytest.raises(ValueError):
        ms.markov_scan(alpha0, torch.zeros(8, 8), torch.zeros(3, 4, 8), torch.zeros(2, 4, 8))


# H100 limits: 227 KB of shared memory a block may opt in to; one cluster
# of C CTAs of these kernels per C SMs of the 132, as the card's occupancy
# query reports them on an H100 80GB HBM3 (15 clusters of 8, 7 of 16)
H100_SMEM = 232448


def _h100_active_clusters(C, rows):
    return {4: 30, 8: 15, 16: 7}.get(C, 132 // C)


@pytest.mark.parametrize(
    "B,S,nA,plan",
    [
        (32, 256, 1, ms.ScanPlan("cluster", 8, 3)),  # model_1v's shape: 11 clusters of 3 rows run at once
        (32, 512, 1, ms.ScanPlan("cluster", 8, 3)),
        (32, 256, 32, ms.ScanPlan("cluster", 8, 1)),  # one A per row: one row a cluster
        (4, 33, 1, ms.ScanPlan("cluster", 7, 1)),  # 8 slices of 5 would leave the 8th CTA without a column
        (2, 1024, 1, ms.ScanPlan("stream")),  # Q's slice over 16 CTAs (256 KB each) fits no CTA
        (32, 2048, 1, ms.ScanPlan("stream")),
    ],
)
def test_scan_route_selection(B, S, nA, plan):
    """The route ``plan_scan`` chooses from the shape and the card's limits
    (given here as arguments), and that every cluster plan it returns fits
    the shared memory and the kernels' limits."""
    got = ms.plan_scan(B, S, nA, H100_SMEM, _h100_active_clusters)
    assert got == plan
    if got.route == "cluster":
        assert ms.cluster_takes(S, got.cluster, got.rows)
        assert max(ms.cluster_smem_bytes(S, got.cluster, got.rows, backward) for backward in (False, True)) <= H100_SMEM
    else:
        assert all(ms.cluster_smem_bytes(S, C, 1) > H100_SMEM for C in ms.CLUSTER_SIZES)



# -- the time-varying scan (K2g): markov_scan_tv_plain, the repaired general
# body, which markov_scan_tv runs on CPU tensors.  Held against a direct
# float64 form in linear space (probabilities multiplied step by step,
# exp(-inf) = 0 exactly, the log taken once at the end), which shares no
# code with it.


def _direct_tv_linear64(alpha0, A, R, L=None):
    """alpha_T of alpha_{t+1} = R_t + logsumexp_l(alpha_t + L_t + A_t) in
    float64 probabilities; A (T, S, S) or (T, B, S, S)."""
    p = torch.exp(alpha0)
    for t in range(R.shape[0]):
        h = p if L is None else p * torch.exp(L[t])
        Q = torch.exp(A[t])
        p = torch.exp(R[t]) * (h @ Q if Q.ndim == 2 else torch.einsum("bl,blr->br", h, Q))
    return torch.log(p)


def _tv_case(seed, B, T, S, per_row_A=False, with_L=False, unreachable=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(T, B, S, S) if per_row_A else (T, S, S)) * 2
    A = A - np.log(np.exp(A).sum(-1, keepdims=True))
    alpha0 = rng.normal(size=(B, S))
    if unreachable:
        # structural zeros, and at steps 1 and 3 a column no state reaches:
        # alpha_2 and alpha_4 are -inf there, and the next step's row of
        # that state is all -inf
        A[A < -4.0] = -np.inf
        A[1, ..., :, 2] = -np.inf
        A[3, ..., :, S - 1] = -np.inf
        alpha0[0, : S // 2] = -np.inf
    out = {"alpha0": alpha0, "A": A, "R": rng.normal(size=(T, B, S)), "L": rng.normal(size=(T, B, S)) if with_L else None,
           "g": rng.normal(size=(B, S))}
    out = {k: None if v is None else v.astype(np.float32) for k, v in out.items()}
    out["a_dims"] = ("tblr" if per_row_A else "tlr")
    return out


TV_CASES = {
    "shared": lambda: _tv_case(20, 4, 6, 7),
    "shared_with_L": lambda: _tv_case(21, 3, 7, 5, with_L=True),
    "per_row": lambda: _tv_case(22, 3, 6, 5, per_row_A=True),
    "per_row_with_L": lambda: _tv_case(23, 4, 5, 6, per_row_A=True, with_L=True),
    "T1": lambda: _tv_case(24, 2, 1, 4, with_L=True),
    "unreachable": lambda: _tv_case(25, 4, 6, 7, unreachable=True),
    "unreachable_per_row_with_L": lambda: _tv_case(26, 3, 6, 7, per_row_A=True, with_L=True, unreachable=True),
}


@pytest.mark.parametrize("fn", ["markov_scan_tv_plain", "markov_scan_tv"])
@pytest.mark.parametrize("name", list(TV_CASES))
def test_tv_scan_matches_direct_float64(name, fn):
    """Values (-inf exactly where the direct form's probability is 0) and
    every gradient, finite, against the direct float64 form: values rtol
    1e-5 with atol 1e-5, gradients rtol 1e-4 with atol 1e-5 * max|grad|."""
    c = TV_CASES[name]()
    leaves = _torch_leaves(c)
    out = getattr(ms, fn)(*leaves)
    (out * torch.tensor(c["g"])).sum().backward()
    leaves64 = _torch_leaves(c, torch.float64)
    out64 = _direct_tv_linear64(*leaves64)
    (out64 * torch.tensor(c["g"], dtype=torch.float64)).sum().backward()
    out, out64 = out.detach().numpy(), out64.detach().numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(out64))
    live = np.isfinite(out64)
    np.testing.assert_allclose(out[live], out64[live], rtol=1e-5, atol=1e-5)
    _close(_grads(leaves), _grads(leaves64))


def test_tv_scan_unreachable_values_and_zero_gradients():
    """A state no path reaches is -inf in the plain version (the general
    body's value, not log(FLT_MIN)); every gradient is finite, and exactly 0
    through each -inf entry of A_t and alpha0."""
    c = TV_CASES["unreachable"]()
    c["A"][-1, :, 3] = -np.inf  # the last step reaches no state 3
    leaves = _torch_leaves(c)
    out = ms.markov_scan_tv_plain(*leaves)
    assert bool(torch.isneginf(out[:, 3]).all()) and bool(torch.isfinite(out[:, :3]).all())
    g = torch.tensor(c["g"])
    g[:, 3] = 0.0  # the loss reads the reachable states only
    (out * g).sum().backward()
    dalpha0, dA, dR, _ = _grads(leaves)
    for d in (dalpha0, dA, dR):
        assert np.isfinite(d).all()
    assert (dA[np.isneginf(c["A"])] == 0).all()
    assert (dalpha0[np.isneginf(c["alpha0"])] == 0).all()


def test_tv_scan_on_the_cpu_runs_the_plain_loop(monkeypatch):
    """On CPU tensors ``markov_scan_tv`` is ``markov_scan_tv_plain``: it
    returns the plain loop's result and counts no kernel launch."""
    c = TV_CASES["shared_with_L"]()
    calls = []
    plain = ms.markov_scan_tv_plain
    monkeypatch.setattr(ms, "markov_scan_tv_plain", lambda *a: calls.append(a) or plain(*a))
    n = dict(ms.tv_launches)
    leaves = _torch_leaves(c)
    out = ms.markov_scan_tv(*leaves)
    assert len(calls) == 1 and ms.tv_launches == n
    torch.testing.assert_close(out, plain(*leaves), rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(3))
def test_tv_plain_long_chain_matches_float64(seed):
    """127 dependent steps of emissions about -35 (the carry drifts to
    about -4400) with unreachable columns: the float32 plain version within
    1e-3 * max|grad| of itself in float64 (the carry is kept shifted)."""
    B, T, S = 4, 127, 16
    rng = np.random.default_rng(200 + seed)
    A = np.log(rng.dirichlet(np.ones(S), size=(T, S)))
    A[::7, :, 5] = -np.inf
    c = {"alpha0": rng.normal(size=(B, S)), "A": A, "R": rng.normal(size=(T, B, S)) * 3 - 35.0, "L": None}
    g = rng.normal(size=(B, S))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        leaves = _torch_leaves(c, dtype)
        (ms.markov_scan_tv_plain(*leaves) * torch.tensor(g, dtype=dtype)).sum().backward()
        grads[dtype] = _grads(leaves)
    for a, e in zip(grads[torch.float32], grads[torch.float64]):
        if e is not None:
            assert np.isfinite(a).all()
            assert np.abs(a - e).max() <= 1e-3 * np.abs(e).max()


def _eliminate_tv(pkg, c):
    """``_try_scan_elimination`` of ``pkg`` on a chain whose transition has
    a time axis (and a row axis for "tblr"): the general body."""
    mp, packed = pkg
    T, B, S = c["R"].shape
    reduced = [packed.PackedTensor(c["A"], c["a_dims"]), packed.PackedTensor(c["R"], "tbr")]
    if c["L"] is not None:
        reduced.append(packed.PackedTensor(c["L"], "tbl"))
    log_factors = OrderedDict([(frozenset("b"), [packed.PackedTensor(c["alpha0"], "bx")])])
    sum_dims = {"x", "l", "r"}
    assert mp._try_scan_elimination(log_factors, sum_dims, reduced, "x", "l", "r", S, "t", frozenset("b"),
                                    {"b": B, "t": T})
    (term,) = log_factors[frozenset("b")]
    return term.value


@pytest.fixture(scope="module")
def jax_tv_runs():
    runs = {}
    for name, make in TV_CASES.items():
        c = make()
        keys = [k for k in ("alpha0", "A", "R", "L") if c[k] is not None]

        def f(*args, c=c, keys=keys):
            out = _eliminate_tv((jmp, jpacked), {**c, **dict(zip(keys, args))})
            return (out * jnp.asarray(c["g"])).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(keys))), has_aux=True))(
            *[jnp.asarray(c[k]) for k in keys])
        grads = dict(zip(keys, grads))
        runs[name] = np.asarray(out), [None if k not in grads else np.asarray(grads[k]) for k in ("alpha0", "A", "R", "L")]
    return runs


# the JAX general body's jax.scipy.special.logsumexp gives NaN gradients at
# a column of A_t that is all -inf (ROADMAP.md Queue 3); the port is held
# there against the direct float64 form above
_JAX_TV_FAULT = pytest.mark.xfail(
    strict=True, reason="pyro_tpu/ops/markov_product.py:448 logsumexp NaN gradient at an all -inf column, "
                        "ROADMAP.md Queue 3")


@pytest.mark.parametrize(
    "name", [pytest.param(n, marks=_JAX_TV_FAULT) if n.startswith("unreachable") else n for n in TV_CASES]
)
def test_tv_elimination_matches_jax(jax_tv_runs, name):
    c = TV_CASES[name]()
    leaves = _torch_leaves(c)
    out = _eliminate_tv((tmp, tpacked), {**c, **dict(zip(("alpha0", "A", "R", "L"), leaves))})
    (out * torch.tensor(c["g"])).sum().backward()
    jout, jgrads = jax_tv_runs[name]
    out = out.detach().numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(jout))
    live = np.isfinite(jout)
    np.testing.assert_allclose(out[live], jout[live], rtol=1e-5, atol=1e-5)
    _close(_grads(leaves), jgrads)
