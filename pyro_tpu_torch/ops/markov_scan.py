"""The Markov-chain scan that eliminates a vectorized Markov chain:

    h_t = alpha_t + L_t,   alpha_{t+1} = R_t + logmatmulexp(h_t, A),   t < T

over rows ``alpha_t`` (B, S), with ``A`` (S, S) shared by every row or
(B, S, S) one per row, and ``R``, ``L`` (T, B, S).  ``markov_scan`` returns
``alpha_T``.

Counterpart of the ``lax.scan(jax.checkpoint(step))`` of
``pyro_tpu/ops/markov_product.py::_try_scan_elimination``.  On CUDA tensors
the whole scan is one launch of the hand-written kernels of
``csrc/markov_scan.cu`` (its backward one more), behind a
``torch.autograd.Function``; on CPU tensors ``markov_scan_plain`` runs,
which loops ``logmatmulexp_plain`` steps.  A CUDA tensor never falls back
to the plain version: the kernel launches or the call raises.

The kernels have two routes, which ``plan_scan`` chooses from the shape
and the device's limits before the launch: the cluster route, which keeps
``exp(A - c)`` in the shared memory of a thread-block cluster, wherever
that fits, and the streaming route, which re-reads it from L2 every step,
for larger S.  A refused launch raises; neither route stands in for the
other.

``markov_scan_tv`` is the same scan with a transition per step (K2g),

    alpha_{t+1} = R_t + logsumexp_l(alpha_t + L_t + A_t),   A_t (T, S, S) or (T, B, S, S),

the general body of the JAX package's ``_try_scan_elimination``.  Its
values are that body's (-inf for a state no path reaches), its gradients
finite and 0 through every -inf entry.  On CUDA tensors it is one launch of
K2g's kernels in ``csrc/markov_scan.cu`` (its backward one more), behind a
``torch.autograd.Function``; on CPU tensors ``markov_scan_tv_plain`` runs,
the plain loop under autograd that the kernels are held against.  K2g has
two routes too, which ``plan_scan_tv`` chooses by shape: the cluster route
(``mstvc_*``), which streams each step's column slices of A_t into the
shared memory of a cluster's CTAs one step ahead, wherever a slice fits,
and the streaming route (``mstv_*``), a block a row reading A_t from L2,
for larger S.  Both read A_t by its strides, so a transition constant in
time (an ``expand`` with time stride 0) is not copied.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build, func_rules
from .log_matmul import logmatmulexp_plain

def _check_shapes(alpha0, A, R, L):
    if alpha0.ndim != 2:
        raise ValueError(f"markov_scan: alpha0 must be (B, S), got {tuple(alpha0.shape)}")
    B, S = alpha0.shape
    if A.shape not in ((S, S), (B, S, S)):
        raise ValueError(f"markov_scan: A must be ({S}, {S}) or ({B}, {S}, {S}), got {tuple(A.shape)}")
    for name, x in (("R", R), ("L", L)):
        if x is not None and (x.ndim != 3 or x.shape[1:] != (B, S)):
            raise ValueError(f"markov_scan: {name} must be (T, {B}, {S}), got {tuple(x.shape)}")
    if L is not None and L.shape[0] != R.shape[0]:
        raise ValueError(f"markov_scan: R and L differ in length: {R.shape[0]} vs {L.shape[0]}")


def markov_scan_plain(alpha0, A, R, L=None):
    """The plain PyTorch version, on any device: one ``logmatmulexp_plain``
    per step, with its analytic VJP.

    The carry is kept shifted: each step subtracts the row max m of h (a
    constant to autograd) before the product, so the carry stays within the
    size of one step's factors instead of drifting like T times the
    emission scale, and the shifts add up beside it in float64.  The
    softmax weights of the backward do not change when a row is shifted,
    and at the carry's own size float32 rounds them finely."""
    _check_shapes(alpha0, A, R, L)
    alpha = alpha0
    norm = torch.zeros(alpha0.shape[:-1] + (1,), dtype=torch.float64, device=alpha0.device)
    for t in range(R.shape[0]):
        h = alpha if L is None else alpha + L[t]
        m = h.detach().amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        if A.ndim == 2:
            z = logmatmulexp_plain(h - m, A)
        else:
            z = logmatmulexp_plain((h - m).unsqueeze(-2), A).squeeze(-2)
        alpha = z + R[t]
        norm = norm + m.double()
    return (alpha.double() + norm).to(alpha.dtype)


# -- the time-varying scan (K2g): plain versions ----------------------------------


def _check_tv_shapes(alpha0, A, R, L):
    if alpha0.ndim != 2:
        raise ValueError(f"markov_scan_tv: alpha0 must be (B, S), got {tuple(alpha0.shape)}")
    B, S = alpha0.shape
    if R.ndim != 3 or R.shape[1:] != (B, S):
        raise ValueError(f"markov_scan_tv: R must be (T, {B}, {S}), got {tuple(R.shape)}")
    T = R.shape[0]
    if A.shape not in ((T, S, S), (T, B, S, S)):
        raise ValueError(f"markov_scan_tv: A must be ({T}, {S}, {S}) or ({T}, {B}, {S}, {S}), got {tuple(A.shape)}")
    if L is not None and L.shape != R.shape:
        raise ValueError(f"markov_scan_tv: L must be {tuple(R.shape)}, got {tuple(L.shape)}")


def _finite(v):
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def masked_logsumexp(x, dim):
    """``logsumexp`` over ``dim`` that is -inf where every term is -inf,
    with gradient 0 there (and through every -inf term) instead of NaN:
    the shift skips all -inf slices, and the log is taken only where the
    sum is positive."""
    m = _finite(x.detach().amax(dim, keepdim=True))
    s = torch.exp(x - m).sum(dim)
    live = s > 0
    return torch.where(live, torch.log(torch.where(live, s, torch.ones_like(s))), -torch.inf) + m.squeeze(dim)


def markov_scan_tv_plain(alpha0, A, R, L=None):
    """``alpha_T`` of the time-varying scan

        alpha_{t+1} = R_t + logsumexp_l(alpha_t + L_t + A_t),   t < T

    with A_t (T, S, S) shared by the B rows or (T, B, S, S) one per row:
    the general body of ``pyro_tpu/ops/markov_product.py:427-451`` as a
    plain PyTorch loop, differentiated by autograd, on any device.

    Its values are the general body's, -inf for a state no path reaches.
    Unlike the JAX body, whose ``logsumexp`` gives NaN gradients at an all
    -inf column, the gradients are finite and exactly 0 through every -inf
    entry (``masked_logsumexp``).  The carry is kept shifted as in
    ``markov_scan_plain``: each step subtracts the row max of h before
    adding A_t, and the shifts add up beside it in float64."""
    _check_tv_shapes(alpha0, A, R, L)
    alpha = alpha0
    norm = torch.zeros(alpha0.shape[:-1] + (1,), dtype=torch.float64, device=alpha0.device)
    for t in range(R.shape[0]):
        h = alpha if L is None else alpha + L[t]
        m = _finite(h.detach().amax(-1, keepdim=True))
        alpha = masked_logsumexp((h - m).unsqueeze(-1) + A[t], -2) + R[t]
        norm = norm + m.double()
    return (alpha.double() + norm).to(alpha.dtype)


# -- CUDA kernels -----------------------------------------------------------------

# Launches of the CUDA scan, counted by the wrapper, on either route.  On
# the cluster route a forward launch runs one kernel, on the streaming route
# two (the exp'd transition, then the scan); a backward launch runs the
# reverse scan (on the cluster route after its statistics kernel), then the
# dA fold's three kernels (column maxima, fold, epilogue).
launches = {"forward": 0, "backward": 0}
# the same launches by route
route_launches = {"cluster": {"forward": 0, "backward": 0}, "stream": {"forward": 0, "backward": 0}}

# the streaming backward keeps 6 rows of S floats in a block's shared memory
MAX_STATES = 2048
# CTAs per cluster, in order of preference (timed in chip_smoke.py, PERF.md)
CLUSTER_SIZES = (8, 16)
CLUSTER_THREADS = 256  # NTC of csrc/markov_scan.cu


# Launches of the time-varying scan's kernels (K2g), counted by the wrapper,
# on either route: a forward launch runs one kernel; a backward launch runs,
# on the cluster route, the statistics kernel, the reverse scan and the
# dA_t fold, on the streaming route the reverse scan and the fold.
tv_launches = {"forward": 0, "backward": 0}
# the same launches by route
tv_route_launches = {"cluster": {"forward": 0, "backward": 0}, "stream": {"forward": 0, "backward": 0}}
# K2g's streaming backward block keeps 4 rows of S floats in dynamic shared
# memory, under the 48 KB a launch gets without opting in to more (the
# forward's 2 S + 2080 floats allow a larger S)
MAX_STATES_TV = 48 * 1024 // (4 * 4)


def reset_counts():
    """Set every launch count to 0."""
    launches.update(forward=0, backward=0)
    tv_launches.update(forward=0, backward=0)
    for counts in (*route_launches.values(), *tv_route_launches.values()):
        counts.update(forward=0, backward=0)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """A route of the CUDA scan: ``"cluster"``, with ``cluster`` CTAs a
    cluster each taking ``rows`` rows, or ``"stream"``."""

    route: str
    cluster: int = 0
    rows: int = 0


def _round4(n):
    return -(-n // 4) * 4


def cluster_smem_bytes(S, C, rows, backward=False):
    """Dynamic shared memory of a CTA of the cluster route's forward or
    backward kernel; the layout of ``cl_forward_floats`` and
    ``cl_backward_floats`` in ``csrc/markov_scan.cu``."""
    W4, S4, R = _round4(-(-S // C)), _round4(S), rows
    q = 4 + _round4(S4 * (W4 + 1))
    if backward:
        floats = q + 4 * C * R * W4 + 2 * R * S4 + 2 * R * W4
    else:
        floats = q + 3 * R * S4 + R * CLUSTER_THREADS + R * W4 + 8 * R + _round4(2 * R) + W4
    return 4 * floats


def cluster_takes(S, C, rows):
    """Whether the cluster kernels take (S, C, rows): ``cl_takes`` of
    ``csrc/markov_scan.cu``.  Every CTA owns a column of the S (the
    backward's exchange is safe only if every CTA waits for every step's
    partials), a thread holds at most 8 elements of its CTA's rows in the
    row passes (each row cut into segments over the 8 warps) and at most 4
    outputs in the forward's epilogue, and the forward's product has a
    thread for each column of a CTA's slice."""
    if C < 1 or rows < 1 or (C - 1) * -(-S // C) >= S:
        return False
    warps = CLUSTER_THREADS // 32
    wpr = 1
    while 2 * wpr * rows <= warps:
        wpr *= 2
    groups, seglen = warps // wpr, -(-S // wpr)
    slots = -(-rows // groups) * -(-seglen // 32)
    W = -(-S // C)
    return slots <= 8 and rows * W <= 4 * CLUSTER_THREADS and _round4(W) <= CLUSTER_THREADS


def tv_cluster_smem_bytes(S, C, rows, backward=False):
    """Dynamic shared memory of a CTA of K2g's cluster route, forward or
    backward; the layout of ``tvc_forward_floats`` and
    ``tvc_backward_floats`` in ``csrc/markov_scan.cu``: the staged slice of
    A_t and E = exp(A_t - c) beside K2's carry and exchange buffers."""
    W4, S4, R = _round4(-(-S // C)), _round4(S), rows
    slices = 8 + S4 * W4 + _round4(S4 * (W4 + 1))
    if backward:
        floats = slices + 4 * C * R * W4 + 2 * R * S4 + 3 * R * W4
    else:
        floats = slices + 4 * R * S4 + R * CLUSTER_THREADS + R * W4 + 8 * R + _round4(2 * R) + CLUSTER_THREADS + W4
    return 4 * floats


def plan_scan(B, S, nA, smem_limit, active_clusters):
    """The route of K2 for B rows of S states with nA transition matrices
    (1 or B), given a block's shared-memory limit in bytes and
    ``active_clusters(C, rows)``, how many clusters of C CTAs taking
    ``rows`` rows each the device runs at once.

    The cluster route takes the first size C of ``CLUSTER_SIZES`` whose
    kernels fit at one row
    a cluster (C cut to ceil(S / W), W = ceil(S / C), where a small S
    would leave CTAs without a column): one row a cluster when each row
    has its own A, else the fewest rows a cluster that let all
    ceil(B / rows) clusters run at once (the most that fit, if none do).
    The streaming route takes what no cluster holds."""
    return _plan(B, S, nA, smem_limit, active_clusters, cluster_smem_bytes)


def plan_scan_tv(B, S, nA, smem_limit, active_clusters):
    """The route of K2g for B rows of S states with A_t shared (nA = 1) or
    one per row (nA = B), chosen as ``plan_scan`` chooses K2's, with the
    shared memory of K2g's cluster kernels (``tv_cluster_smem_bytes``) and
    ``active_clusters`` counting their clusters."""
    return _plan(B, S, nA, smem_limit, active_clusters, tv_cluster_smem_bytes)


def _plan(B, S, nA, smem_limit, active_clusters, smem_bytes):
    def fits(C, rows):
        smem = max(smem_bytes(S, C, rows), smem_bytes(S, C, rows, True))
        return cluster_takes(S, C, rows) and smem <= smem_limit

    for C in CLUSTER_SIZES:
        C = -(-S // -(-S // C))  # as many CTAs as the column slices need
        if not fits(C, 1):
            continue
        if nA > 1:
            return ScanPlan("cluster", C, 1)
        best = 1
        for rows in range(1, B + 1):
            if not fits(C, rows):
                break
            best = rows
            if -(-B // rows) <= active_clusters(C, rows):
                break
        return ScanPlan("cluster", C, best)
    return ScanPlan("stream")


_P = ctypes.c_void_p
_c = ctypes.c_int


@functools.cache
def _lib():
    lib = cuda_build.load("markov_scan")
    lib.ms_forward.argtypes = [_P, _P, _P, _P, _c, _c, _c, _c, _P, _P, _P, _P, _P, _P, _P]
    lib.ms_forward.restype = ctypes.c_int
    lib.ms_backward.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _c, _c, _c, _c, _c] + [_P] * 10
    lib.ms_backward.restype = ctypes.c_int
    lib.msc_forward.argtypes = [_P, _P, _P, _P, _c, _c, _c, _c, _c, _c, _P, _P, _P, _P, _P]
    lib.msc_forward.restype = ctypes.c_int
    lib.msc_backward.argtypes = [_P, _P, _P, _P, _P, _P, _c, _c, _c, _c, _c, _c, _c] + [_P] * 16
    lib.msc_backward.restype = ctypes.c_int
    lib.msc_smem_bytes.argtypes = [_c, _c, _c, _c]
    lib.msc_smem_bytes.restype = ctypes.c_longlong
    lib.msc_active_clusters.argtypes = [_c, _c, _c, ctypes.POINTER(ctypes.c_int)]
    lib.msc_active_clusters.restype = ctypes.c_int
    lib.msc_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.msc_smem_limit.restype = ctypes.c_int
    _l = ctypes.c_longlong
    lib.mstv_forward.argtypes = [_P, _P, _l, _l, _l, _P, _P, _c, _c, _c, _c, _P, _P, _P, _P]
    lib.mstv_forward.restype = ctypes.c_int
    lib.mstv_backward.argtypes = [_P, _l, _l, _l] + [_P] * 4 + [_c] * 4 + [_P] * 4
    lib.mstv_backward.restype = ctypes.c_int
    lib.mstvc_forward.argtypes = [_P, _P, _l, _l, _l, _P, _P] + [_c] * 6 + [_P] * 5
    lib.mstvc_forward.restype = ctypes.c_int
    lib.mstvc_backward.argtypes = [_P, _l, _l, _l] + [_P] * 5 + [_c] * 6 + [_P] * 8
    lib.mstvc_backward.restype = ctypes.c_int
    lib.mstvc_smem_bytes.argtypes = [_c, _c, _c, _c]
    lib.mstvc_smem_bytes.restype = ctypes.c_longlong
    lib.mstvc_active_clusters.argtypes = [_c, _c, _c, ctypes.POINTER(ctypes.c_int)]
    lib.mstvc_active_clusters.restype = ctypes.c_int
    return lib


def _query(fn, *args, device):
    """The int that ``fn(*args, &out)`` of the library writes on ``device``."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = fn(*args, ctypes.byref(out))
    if err:
        raise RuntimeError(f"markov_scan: device query {fn.__name__} failed: CUDA error {err}")
    return out.value


def active_clusters(S, C, rows, device):
    """How many clusters of C CTAs, taking ``rows`` rows of S states each,
    the card runs at once (``cudaOccupancyMaxActiveClusters``)."""
    return _query(_lib().msc_active_clusters, S, C, rows, device=device)


def active_clusters_tv(S, C, rows, device):
    """``active_clusters`` for K2g's cluster kernels."""
    return _query(_lib().mstvc_active_clusters, S, C, rows, device=device)


@functools.cache
def _device_plan(B, S, nA, device):
    smem_limit = _query(_lib().msc_smem_limit, device=device)
    return plan_scan(B, S, nA, smem_limit, lambda C, rows: active_clusters(S, C, rows, device))


@functools.cache
def _device_plan_tv(B, S, nA, device):
    smem_limit = _query(_lib().msc_smem_limit, device=device)
    return plan_scan_tv(B, S, nA, smem_limit, lambda C, rows: active_clusters_tv(S, C, rows, device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(*tensors):
    device = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise ValueError(f"markov_scan: operands must lie on one CUDA device, got {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"markov_scan: the CUDA kernel takes float32, got {t.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(alpha0, A, R, L=None, plan=None):
    """alpha_T, and what the backward needs: the plan, the shifted carry
    stack (T, B, S) (alpha_t less a constant per row and step), each step's z = exp(h - m) @ Q
    (T, B, S), the raw column maxima of A and, on the streaming route,
    Q = exp(A - c) and its transpose.  ``plan`` forces a route; by default
    ``plan_scan`` chooses by shape."""
    _check_shapes(alpha0, A, R, L)
    _check_cuda(alpha0, A, R, L)
    T = R.shape[0]
    B, S = alpha0.shape
    nA = 1 if A.ndim == 2 else B
    if plan is None:
        plan = _device_plan(B, S, nA, alpha0.device)
    if T == 0 or B == 0 or S == 0 or (plan.route == "stream" and S > MAX_STATES):
        raise ValueError(f"markov_scan: the kernel takes 1 <= T, 1 <= B and 1 <= S <= {MAX_STATES}, got {T, B, S}")
    if plan.route == "cluster" and (not cluster_takes(S, plan.cluster, plan.rows) or (nA > 1 and plan.rows != 1)):
        raise ValueError(f"markov_scan: bad cluster plan {plan} for nA={nA}")
    alpha0, A, R = alpha0.contiguous(), A.contiguous(), R.contiguous()
    L = None if L is None else L.contiguous()
    new = functools.partial(torch.empty, dtype=alpha0.dtype, device=alpha0.device)
    alphas, zs, out, craw = new((T, B, S)), new((T, B, S)), new((B, S)), new((nA, S))
    Q = QT = None
    if plan.route == "cluster":
        err = _lib().msc_forward(
            alpha0.data_ptr(), A.data_ptr(), R.data_ptr(), _ptr(L), B, T, S, nA, plan.cluster, plan.rows,
            alphas.data_ptr(), zs.data_ptr(), out.data_ptr(), craw.data_ptr(), _stream(alpha0),
        )
    else:
        Q, QT = new((nA, S, S)), new((nA, S, S))
        err = _lib().ms_forward(
            alpha0.data_ptr(), A.data_ptr(), R.data_ptr(), _ptr(L), B, T, S, nA,
            alphas.data_ptr(), zs.data_ptr(), out.data_ptr(), Q.data_ptr(), QT.data_ptr(), craw.data_ptr(),
            _stream(alpha0),
        )
    if err:
        raise RuntimeError(f"markov_scan forward ({plan}) failed to launch: CUDA error {err}")
    launches["forward"] += 1
    route_launches[plan.route]["forward"] += 1
    return out, (plan, alphas, zs, craw, Q, QT)


def _fold_splits(rows, tiles, nA, device):
    """Blocks of the dA fold per output tile: about two waves over the
    card's SMs, at least 64 rows each."""
    blocks = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-blocks // (tiles * nA)), -(-rows // 64)))


def _backward_cuda(A, L, saved, g):
    """dalpha0, dA, dR and dL (None without L) from dloss/dalpha_T, on the
    forward's route."""
    plan, alphas, zs, craw, Q, QT = saved
    _check_cuda(g, A, L, alphas, zs)
    # one example's slice of a vmapped forward's stack is a strided view
    alphas, zs, craw = alphas.contiguous(), zs.contiguous(), craw.contiguous()
    Q, QT = (None if t is None else t.contiguous() for t in (Q, QT))
    T, B, S = alphas.shape
    if g.shape != (B, S):
        raise ValueError(f"markov_scan: gradient shape {tuple(g.shape)} != ({B}, {S})")
    nA = craw.shape[0]
    g = g.contiguous()
    A = A.contiguous()
    L = None if L is None else L.contiguous()
    tiles = (-(-S // 64)) ** 2
    rows = T if nA > 1 else T * B
    splits = _fold_splits(rows, tiles, nA, g.device)
    new = functools.partial(torch.empty, dtype=g.dtype, device=g.device)
    dalpha0, dR, dA = new((B, S)), new((T, B, S)), new((nA, S, S))
    dL = None if L is None else new((T, B, S))
    # the fold's two classes: entries whose z was clipped at FLT_MIN, and the rest
    P, W, Wc = new((T, B, S)), new((T, B, S)), new((T, B, S))
    cc, partial = new((2, nA, S)), new((2, splits, nA, S, S))
    outputs = (dalpha0.data_ptr(), dR.data_ptr(), _ptr(dL), dA.data_ptr(),
               P.data_ptr(), W.data_ptr(), Wc.data_ptr(), cc.data_ptr(), partial.data_ptr())
    if plan.route == "cluster":
        # the scan's per-entry factors and per-step clip flags (msc_stats_kernel)
        G0, G1, F0, F1 = new((T, B, S)), new((T, B, S)), new((T, B, S)), new((T, B, S))
        crcs = new((T, B))
        two = torch.empty((T, -(-B // plan.rows)), dtype=torch.int32, device=g.device)
        err = _lib().msc_backward(
            A.data_ptr(), alphas.data_ptr(), zs.data_ptr(), _ptr(L), craw.data_ptr(), g.data_ptr(),
            B, T, S, nA, plan.cluster, plan.rows, splits, *outputs,
            G0.data_ptr(), G1.data_ptr(), F0.data_ptr(), F1.data_ptr(), crcs.data_ptr(), two.data_ptr(), _stream(g),
        )
    else:
        err = _lib().ms_backward(
            A.data_ptr(), alphas.data_ptr(), zs.data_ptr(), _ptr(L), Q.data_ptr(), QT.data_ptr(), craw.data_ptr(),
            g.data_ptr(), B, T, S, nA, splits, *outputs, _stream(g),
        )
    if err:
        raise RuntimeError(f"markov_scan backward ({plan}) failed to launch: CUDA error {err}")
    launches["backward"] += 1
    route_launches[plan.route]["backward"] += 1
    return dalpha0, dA.reshape(A.shape), dR, dL


def _saved_plan(plan, B, S, nA, Q, device):
    """The route the backward runs on: the forward's, which kept Q on the
    streaming route only; the cluster route's plan is the one given, or
    ``plan_scan``'s for the backward's own rows (the backward reads the
    forward's carry stack by global index, whatever the forward's rows)."""
    if Q is not None:
        return ScanPlan("stream")
    if plan is not None and plan.route == "cluster":
        return plan
    return _device_plan(B, S, nA, device)


def _fold_rows(t, dim, C, time_major):
    """An operand of B rows (B, ...) or, ``time_major``, (T, B, ...), mapped
    at ``dim`` (or None, then expanded), as C * B rows, chain-major."""
    if dim is None:
        t = t.unsqueeze(int(time_major)).expand(*t.shape[: int(time_major)], C, *t.shape[int(time_major):])
    else:
        t = t.movedim(dim, int(time_major))
    return t.reshape(*t.shape[: int(time_major)], -1, *t.shape[int(time_major) + 2:])


def _unfold_rows(t, C, time_major):
    """The inverse of ``_fold_rows``: (C, B, ...) or (T, C, B, ...), mapped at 0 or 1."""
    k = int(time_major)
    return t.reshape(*t.shape[:k], C, -1, *t.shape[k + 1:])


def _fold_A(A, dim, C, B, per_step):
    """The transition(s) of the folded scan: a shared A ((S, S), or with
    ``per_step`` (T, S, S)) with no mapped dim stays shared; else one A a
    row of the C * B rows."""
    k = int(per_step)
    if dim is None and A.ndim == 2 + k:
        return A
    if dim is None:
        A = A.unsqueeze(k).expand(*A.shape[:k], C, *A.shape[k:])
    else:
        A = A.movedim(dim, k)
    if A.ndim == 3 + k:  # one A a chain: the same for its B rows
        A = A.unsqueeze(k + 1).expand(*A.shape[: k + 1], B, *A.shape[k + 1:])
    return A.reshape(*A.shape[:k], C * B, *A.shape[k + 2:])


def _dA_per_example(dA, A, dim, C, per_step):
    """dA of the folded scan, one a row, as each example's gradient of its A."""
    k = int(per_step)
    logical = A.ndim - (dim is not None)
    dA = dA.reshape(*dA.shape[:k], C, -1, *dA.shape[k + 1:]).movedim(k, 0)
    return dA.sum(k + 1) if logical == 2 + k else dA


class _MarkovScanBackward(torch.autograd.Function):
    """K2's backward launch, as a Function with a vmap rule of its own."""

    @staticmethod
    def forward(A, L, alphas, zs, craw, Q, QT, g, plan):
        T, B, S = alphas.shape
        plan = _saved_plan(plan, B, S, craw.shape[0], Q, g.device)
        return _backward_cuda(A, L, (plan, alphas, zs, craw, Q, QT), g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("markov_scan: no second derivative")

    @staticmethod
    def vmap(info, in_dims, A, L, alphas, zs, craw, Q, QT, g, plan):
        args = (A, L, alphas, zs, craw, Q, QT, g, plan)
        if in_dims[0] is None and A.ndim == 2:
            # a shared A: each example's dA is its own sum over rows
            return func_rules.loop(_MarkovScanBackward.apply, info, in_dims, args)
        C, B = info.batch_size, func_rules.logical_shape(alphas, in_dims[2])[1]
        Af = _fold_A(A, in_dims[0], C, B, False)
        per_row = [None if t is None else _fold_rows(t, d, C, True) for t, d in zip((L, alphas, zs), in_dims[1:4])]
        crawf, Qf, QTf = (None if t is None else _fold_rows(t, d, C, False) for t, d in zip((craw, Q, QT),
                                                                                           in_dims[4:7]))
        dalpha0, dA, dR, dL = _MarkovScanBackward.apply(Af, per_row[0], per_row[1], per_row[2], crawf, Qf, QTf,
                                                         _fold_rows(g, in_dims[7], C, False), plan)
        out = (_unfold_rows(dalpha0, C, False), _dA_per_example(dA, A, in_dims[0], C, False),
               _unfold_rows(dR, C, True).movedim(1, 0), None if dL is None else _unfold_rows(dL, C, True).movedim(1, 0))
        return out, (0, 0, 0, None if dL is None else 0)


class _MarkovScanCUDA(torch.autograd.Function):
    """K2's forward launch; its outputs after alpha_T are what the backward
    reads (the carry stack, the z's, the raw column maxima of A and, on the
    streaming route, Q and its transpose)."""

    @staticmethod
    def forward(alpha0, A, R, L, plan):
        out, (_, alphas, zs, craw, Q, QT) = _forward_cuda(alpha0, A, R, L, plan)
        return out, alphas, zs, craw, Q, QT

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*(t for t in output[1:] if t is not None))
        ctx.plan = inputs[4]
        ctx.save_for_backward(inputs[1], inputs[3], *output[1:])

    @staticmethod
    def backward(ctx, g, *saved_grads):
        A, L, *saved = ctx.saved_tensors
        return (*_MarkovScanBackward.apply(A, L, *saved, g, ctx.plan), None)

    @staticmethod
    def vmap(info, in_dims, alpha0, A, R, L, plan):
        C, B = info.batch_size, func_rules.logical_shape(alpha0, in_dims[0])[0]
        out, alphas, zs, craw, Q, QT = _MarkovScanCUDA.apply(
            _fold_rows(alpha0, in_dims[0], C, False), _fold_A(A, in_dims[1], C, B, False),
            _fold_rows(R, in_dims[2], C, True), None if L is None else _fold_rows(L, in_dims[3], C, True), plan)
        shared = in_dims[1] is None and A.ndim == 2
        per_A = (lambda t: t) if shared else (lambda t: None if t is None else _unfold_rows(t, C, False))
        outs = (_unfold_rows(out, C, False), _unfold_rows(alphas, C, True), _unfold_rows(zs, C, True),
                per_A(craw), per_A(Q), per_A(QT))
        A_dim = None if shared else 0
        return outs, (0, 1, 1, A_dim, None if Q is None else A_dim, None if QT is None else A_dim)


def markov_scan(alpha0, A, R, L=None, plan=None):
    """``alpha_T`` of the scan above, with its analytic backward.  CUDA
    tensors go through the hand-written kernels, on the route ``plan_scan``
    chooses by shape unless ``plan`` (a ``ScanPlan``) names one; CPU tensors
    go through the plain version."""
    if any(t is not None and t.is_cuda for t in (alpha0, A, R, L)):
        return _MarkovScanCUDA.apply(alpha0, A, R, L, plan)[0]
    return markov_scan_plain(alpha0, A, R, L)


# -- the time-varying scan (K2g): CUDA kernels and the wrapper ---------------------


def _tv_strides(A):
    """A with its last dim contiguous and its l stride below 2^31 (copied
    only if not), and the strides of A_t's time, row (0 where A_t is shared)
    and l dims."""
    if (A.stride(-1) != 1 and A.shape[-1] > 1) or A.stride(-2) >= 2**31:
        A = A.contiguous()
    st = A.stride()
    return A, st[0], (st[1] if A.ndim == 4 else 0), st[-2]


def _tv_plan(plan, B, S, nA, device):
    if plan is None:
        plan = _device_plan_tv(B, S, nA, device)
    if plan.route == "stream" and S > MAX_STATES_TV:
        raise ValueError(f"markov_scan_tv: the streaming route takes S <= {MAX_STATES_TV}, got {S}")
    if plan.route == "cluster" and (not cluster_takes(S, plan.cluster, plan.rows) or (nA > 1 and plan.rows != 1)):
        raise ValueError(f"markov_scan_tv: bad cluster plan {plan} for nA={nA}")
    return plan


def _tv_forward_cuda(alpha0, A, R, L=None, plan=None):
    """alpha_T and what the backward reads: the plan, hs_t = h_t - m_t and
    o_t = logsumexp_l(hs_t + A_t) (T, B, S) each and, on the cluster route,
    c_t, the raw column maxima of each A_t (T, nA, S); one kernel launch.
    ``plan`` (a ``ScanPlan``) forces a route; by default ``plan_scan_tv``
    chooses by shape."""
    _check_tv_shapes(alpha0, A, R, L)
    _check_cuda(alpha0, A, R, L)
    T, B, S = R.shape
    if T == 0 or B == 0 or S == 0:
        raise ValueError(f"markov_scan_tv: the kernel takes 1 <= T, 1 <= B and 1 <= S, got {T, B, S}")
    nA = 1 if A.ndim == 3 else B
    plan = _tv_plan(plan, B, S, nA, alpha0.device)
    A, sAt, sAb, sAl = _tv_strides(A)
    alpha0, R = alpha0.contiguous(), R.contiguous()
    L = None if L is None else L.contiguous()
    new = functools.partial(torch.empty, dtype=alpha0.dtype, device=alpha0.device)
    hs, os, out = new((T, B, S)), new((T, B, S)), new((B, S))
    cs = None
    if plan.route == "cluster":
        cs = new((T, nA, S))
        err = _lib().mstvc_forward(alpha0.data_ptr(), A.data_ptr(), sAt, sAb, sAl, R.data_ptr(), _ptr(L), B, T, S, nA,
                                   plan.cluster, plan.rows, hs.data_ptr(), os.data_ptr(), cs.data_ptr(),
                                   out.data_ptr(), _stream(alpha0))
    else:
        err = _lib().mstv_forward(alpha0.data_ptr(), A.data_ptr(), sAt, sAb, sAl, R.data_ptr(), _ptr(L), B, T, S, nA,
                                  hs.data_ptr(), os.data_ptr(), out.data_ptr(), _stream(alpha0))
    if err:
        raise RuntimeError(f"markov_scan_tv forward ({plan}) failed to launch: CUDA error {err}")
    tv_launches["forward"] += 1
    tv_route_launches[plan.route]["forward"] += 1
    return out, (plan, hs, os, cs)


def _tv_backward_cuda(A, L, saved, g):
    """dalpha0, dA (A's shape: one per step, and per row where A has a row
    axis), dR and dL (None without L) from dloss/dalpha_T, on the forward's
    route: ``mstvc_stats_kernel``, ``mstvc_backward_kernel`` (the reverse
    scan) and ``mstvc_fold_kernel`` (dA_t), or ``mstv_backward_kernel`` and
    ``mstv_fold_kernel``."""
    plan, hs, os, cs = saved
    _check_cuda(g, A, L, hs, os, cs)
    # one example's slice of a vmapped forward's stack is a strided view
    hs, os, cs = hs.contiguous(), os.contiguous(), None if cs is None else cs.contiguous()
    T, B, S = hs.shape
    if g.shape != (B, S):
        raise ValueError(f"markov_scan_tv: gradient shape {tuple(g.shape)} != ({B}, {S})")
    nA = 1 if A.ndim == 3 else B
    shape = A.shape
    A, sAt, sAb, sAl = _tv_strides(A)
    g = g.contiguous()
    L = None if L is None else L.contiguous()
    new = functools.partial(torch.empty, dtype=g.dtype, device=g.device)
    dalpha0, dR, dA = new((B, S)), new((T, B, S)), new(shape)
    dL = None if L is None else new((T, B, S))
    if plan.route == "cluster":
        # the classes of the columns and their factors (mstvc_stats_kernel)
        P0, F0, X1 = new((T, B, S)), new((T, B, S)), new((T, B, S))
        two = torch.empty((T, -(-B // plan.rows)), dtype=torch.int32, device=g.device)
        err = _lib().mstvc_backward(A.data_ptr(), sAt, sAb, sAl, hs.data_ptr(), os.data_ptr(), cs.data_ptr(),
                                    g.data_ptr(), _ptr(dL), B, T, S, nA, plan.cluster, plan.rows, dalpha0.data_ptr(),
                                    dR.data_ptr(), dA.data_ptr(), P0.data_ptr(), F0.data_ptr(), X1.data_ptr(),
                                    two.data_ptr(), _stream(g))
    else:
        err = _lib().mstv_backward(A.data_ptr(), sAt, sAb, sAl, hs.data_ptr(), os.data_ptr(), g.data_ptr(), _ptr(dL),
                                   B, T, S, nA, dalpha0.data_ptr(), dR.data_ptr(), dA.data_ptr(), _stream(g))
    if err:
        raise RuntimeError(f"markov_scan_tv backward ({plan}) failed to launch: CUDA error {err}")
    tv_launches["backward"] += 1
    tv_route_launches[plan.route]["backward"] += 1
    return dalpha0, dA, dR, dL


class _MarkovScanTVBackward(torch.autograd.Function):
    """K2g's backward launch, as a Function with a vmap rule of its own."""

    @staticmethod
    def forward(A, L, hs, os, cs, g, plan):
        T, B, S = hs.shape
        nA = 1 if A.ndim == 3 else B
        if cs is None:
            plan = ScanPlan("stream")
        elif plan is None or plan.route != "cluster":
            plan = _device_plan_tv(B, S, nA, g.device)
        return _tv_backward_cuda(A, L, (plan, hs, os, cs), g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("markov_scan_tv: no second derivative")

    @staticmethod
    def vmap(info, in_dims, A, L, hs, os, cs, g, plan):
        args = (A, L, hs, os, cs, g, plan)
        if in_dims[0] is None and A.ndim == 3:
            # a shared A_t: each example's dA_t is its own sum over rows
            return func_rules.loop(_MarkovScanTVBackward.apply, info, in_dims, args)
        C, B = info.batch_size, func_rules.logical_shape(hs, in_dims[2])[1]
        Lf, hsf, osf, csf = (None if t is None else _fold_rows(t, d, C, True) for t, d in zip((L, hs, os, cs),
                                                                                               in_dims[1:5]))
        dalpha0, dA, dR, dL = _MarkovScanTVBackward.apply(_fold_A(A, in_dims[0], C, B, True), Lf, hsf, osf, csf,
                                                           _fold_rows(g, in_dims[5], C, False), plan)
        out = (_unfold_rows(dalpha0, C, False), _dA_per_example(dA, A, in_dims[0], C, True),
               _unfold_rows(dR, C, True).movedim(1, 0), None if dL is None else _unfold_rows(dL, C, True).movedim(1, 0))
        return out, (0, 0, 0, None if dL is None else 0)


class _MarkovScanTVCUDA(torch.autograd.Function):
    """K2g's forward launch; its outputs after alpha_T are what the
    backward reads (hs, o and, on the cluster route, c)."""

    @staticmethod
    def forward(alpha0, A, R, L, plan):
        out, (_, hs, os, cs) = _tv_forward_cuda(alpha0, A, R, L, plan)
        return out, hs, os, cs

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*(t for t in output[1:] if t is not None))
        ctx.plan = inputs[4]
        ctx.save_for_backward(inputs[1], inputs[3], *output[1:])

    @staticmethod
    def backward(ctx, g, *saved_grads):
        A, L, *saved = ctx.saved_tensors
        return (*_MarkovScanTVBackward.apply(A, L, *saved, g, ctx.plan), None)

    @staticmethod
    def vmap(info, in_dims, alpha0, A, R, L, plan):
        C, B = info.batch_size, func_rules.logical_shape(R, in_dims[2])[1]
        out, hs, os, cs = _MarkovScanTVCUDA.apply(
            _fold_rows(alpha0, in_dims[0], C, False), _fold_A(A, in_dims[1], C, B, True),
            _fold_rows(R, in_dims[2], C, True), None if L is None else _fold_rows(L, in_dims[3], C, True), plan)
        shared = in_dims[1] is None and A.ndim == 3
        cs_out = cs if shared or cs is None else _unfold_rows(cs, C, True)
        outs = (_unfold_rows(out, C, False), _unfold_rows(hs, C, True), _unfold_rows(os, C, True), cs_out)
        return outs, (0, 1, 1, None if shared or cs is None else 1)


def markov_scan_tv(alpha0, A, R, L=None, plan=None):
    """``alpha_T`` of ``markov_scan_tv_plain``'s recurrence.  CUDA tensors
    go through the hand-written kernels with their analytic backward (one
    launch forward, one backward; float32 only, raising rather than
    falling back), on the route ``plan_scan_tv`` chooses by shape unless
    ``plan`` (a ``ScanPlan``) names one; CPU tensors go through the plain
    version.  Replaces the general body of
    ``pyro_tpu/ops/markov_product.py:427-451`` scanned at ``:469``."""
    if any(t is not None and t.is_cuda for t in (alpha0, A, R, L)):
        return _MarkovScanTVCUDA.apply(alpha0, A, R, L, plan)[0]
    return markov_scan_tv_plain(alpha0, A, R, L)
