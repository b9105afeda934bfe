"""How the pair contraction (K4b, K5b) reads its operands in place, on the
CPU: ``gaussian_levels.row_layout`` (the strides the kernels index with)
and ``_kernel_operands`` (which operands it copies) on contiguous,
sliced-row, stride-0 (rows, time, both, and one of two leading dims) and
non-contiguous tensors; the wrappers over several leading batch dims
against the same rows flattened; and the two time contractions over a
broadcast factor with two leading dims against the JAX package.

Each layout is checked by rebuilding the operand from its storage with
the kernel's own index, element (r, p) at ``(r // R_lo) * hi + (r % R_lo)
* lo + p * ts``, and comparing every element exactly.  The wrappers over
leading dims run the plain versions on the same rows in other batch
shapes: rtol and atol 1e-6 (batched products may round apart), their
gradients (the written-out adjoint against autograd of the plain
version, P's symmetrised) rtol and atol 1e-5; the
contractions against JAX hold float32 at rtol 1e-4 with atol 1e-4, as
``test_torch_gaussian.py`` does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu_torch as pyro
from pyro_tpu.ops import gamma_gaussian as jgg
from pyro_tpu.ops import gaussian as jg
from pyro_tpu_torch.ops import gamma_gaussian as tgg
from pyro_tpu_torch.ops import gaussian as tg
from pyro_tpu_torch.ops import gaussian_levels as gl


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    yield


def _rebuild(x, lead, R_lo, strides, inner):
    """``x`` read as the kernel reads it, shape (*lead, t, *inner)."""
    hi, lo, ts = strides
    R = math.prod(lead)
    t = x.shape[len(lead)]
    inner_strides = tuple(math.prod(inner[d + 1:]) for d in range(len(inner)))
    view = torch.as_strided(x, (R // R_lo, R_lo, t, *inner), (hi, lo, ts, *inner_strides), x.storage_offset())
    return view.reshape(*lead, t, *inner)


@pytest.mark.parametrize("lead,strides,want", [
    ((8,), (0, 0), (8, [(0, 0, 0)])),  # a precision expanded over rows and time
    ((8,), (0, 4096), (8, [(0, 0, 4096)])),  # expanded over rows only
    ((8,), (4096, 0), (8, [(0, 4096, 0)])),  # expanded over time only
    ((8, 4), (0, 4096, 0), (4, [(0, 4096, 0)])),  # one precision a channel, as IndependentHMM's
    ((8, 4), (4 * 70, 70, 7), (32, [(0, 70, 7)])),  # contiguous: one group
    ((3, 4, 5), (0, 5, 1, 0), (20, [(0, 1, 0)])),  # a broadcast outer dim over contiguous rows
    ((), (9,), (1, [(0, 0, 9)])),  # no leading dim: one row
])
def test_row_layout(lead, strides, want):
    assert gl.row_layout(lead, [(strides, True, 1)]) == want


def test_row_layout_copies_what_it_cannot_index():
    """No split walks dims whose strides interleave; an operand whose inner
    dims are not contiguous, or whose strides miss the alignment, is copied;
    the split taken copies the fewest operands."""
    assert gl.row_layout((2, 3, 4), [((8, 1, 2, 24), True, 1)]) == (24, [None])
    assert gl.row_layout((8,), [((64, 4), False, 1)]) == (8, [None])
    assert gl.row_layout((8,), [((66, 6), True, 4)]) == (8, [None])
    # P broadcast over the outer dim, info contiguous: both split (8 | 4) in place
    R_lo, plan = gl.row_layout((8, 4), [((0, 4096, 0), True, 4), ((4 * 5 * 6, 5 * 6, 6), True, 1)])
    assert (R_lo, plan) == (4, [(0, 4096, 0), (120, 30, 6)])


def _levels_inputs(case, R=3, t=5, n=2):
    """(P, info, logZ) laid out as ``case`` and the lead dims."""
    g = torch.Generator().manual_seed(0)
    n2 = 2 * n
    full = torch.randn(R, t + 2, n2, n2, generator=g)
    info = torch.randn(R, t, n2, generator=g)
    logZ = torch.randn(R, t, generator=g)
    lead = (R,)
    if case == "contiguous":
        P = full[:, :t].contiguous()
    elif case == "sliced_rows":  # a prefix of each row: strided rows, as the merged levels pass them
        P, info, logZ = full[:, 1:t + 1], torch.randn(R, t + 3, n2, generator=g)[:, 2:t + 2], logZ
    elif case == "stride0_rows":
        P = full[:1, :t].expand(R, t, n2, n2)
    elif case == "stride0_time":
        P = full[:, :1].expand(R, t, n2, n2)
        logZ = torch.randn(R, 1, generator=g).expand(R, t)
    elif case == "stride0_both":
        P = full[0, 0].expand(R, t, n2, n2)
        info = torch.randn(n2, generator=g).expand(R, t, n2)
    elif case == "two_lead_dims":  # one precision a channel, broadcast over the sequences
        lead = (2, R)
        P = full[:, :1].unsqueeze(0).expand(2, R, t, n2, n2)
        info = torch.randn(2, R, t, n2, generator=g)
        logZ = torch.randn(2, R, t, generator=g)
    elif case == "noncontiguous_inner":
        P = full[:, :t].transpose(-1, -2)
        info = torch.randn(R, t, n2, 2, generator=g)[..., 0]  # entries two apart
    elif case == "misaligned":  # P's base one float off 16 bytes: bulk copies need 16
        P = full.flatten()[1:1 + R * t * n2 * n2].view(R, t, n2, n2)
    return lead, P, info, logZ


# (case, which of P, info, logZ must be copied)
LAYOUT_CASES = [
    ("contiguous", (False, False, False)),
    ("sliced_rows", (False, False, False)),
    ("stride0_rows", (False, False, False)),
    ("stride0_time", (False, False, False)),
    ("stride0_both", (False, False, False)),
    ("two_lead_dims", (False, False, False)),
    ("noncontiguous_inner", (True, True, False)),
    ("misaligned", (True, False, False)),
]


@pytest.mark.parametrize("case,copied", LAYOUT_CASES)
def test_kernel_operands_read_in_place(case, copied):
    lead, P, info, logZ = _levels_inputs(case)
    ops = [(P, 2), (info, 1), (logZ, 0)]
    tensors, layout = gl._kernel_operands(lead, ops)
    layout = list(layout)
    R_lo = layout[0]
    assert math.prod(lead) % R_lo == 0
    for k, ((x, inner), got, was_copied) in enumerate(zip(ops, tensors, copied)):
        assert (got.data_ptr() != x.data_ptr() or got.stride() != x.stride()) == was_copied, k
        if not was_copied:
            assert got is x
        if k == 0:
            assert got.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in layout[1:4])
        strides = tuple(layout[1 + 3 * k:4 + 3 * k])
        assert torch.equal(_rebuild(got, lead, R_lo, strides, x.shape[x.ndim - inner:]), x)


def _chain(lead, t, n, gen):
    n2 = 2 * n
    M = torch.randn(*lead, 1, n2, n2, generator=gen)
    P = (M @ M.transpose(-1, -2) / n2 + torch.eye(n2)).expand(*lead, t, n2, n2)
    return P, torch.randn(*lead, t, n2, generator=gen), torch.randn(*lead, t, generator=gen)


@pytest.mark.parametrize("lead,t", [((2, 3), 7), ((), 6), ((4,), 5)])
def test_contract_pairs_over_leading_dims(lead, t):
    """The wrappers over any leading batch dims (a broadcast precision among
    them) give the plain versions' outputs on the same rows flattened,
    forward and, for K4b, backward."""
    gen = torch.Generator().manual_seed(t)
    P, info, logZ = _chain(lead, t, 2, gen)
    R, k = math.prod(lead), len(lead)

    def rows(x):
        return x.reshape(R, *x.shape[k:])

    P_, info_, logZ_ = (x.clone().requires_grad_() for x in (P, info, logZ))
    out = gl.contract_pairs(P_, info_, logZ_, tape=True)
    flat = [x.clone().requires_grad_() for x in (rows(P), rows(info), rows(logZ))]
    ref = gl.contract_pairs_plain(*flat, tape=True)
    for a, b in zip(out[:3] + tuple(out[3]), ref[:3] + tuple(ref[3])):
        assert a.shape == (*lead, *b.shape[1:])
        torch.testing.assert_close(rows(a), b, rtol=1e-6, atol=1e-6)
    weights = [torch.randn(x.shape, generator=gen) for x in ref[:3]]
    sum((rows(a) * w).sum() for a, w in zip(out[:3], weights)).backward()
    sum((a * w).sum() for a, w in zip(ref[:3], weights)).backward()
    sym = gl._sym  # the backward returns P's gradient symmetrised
    for a, b, s in zip((P_, info_, logZ_), flat, (sym, None, None)):
        got, want = rows(a.grad), b.grad
        if s:
            got, want = s(got), s(want)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    alpha = (2.0 + torch.randint(0, 4, (*lead, t), generator=gen)).float()
    beta = 1.0 + torch.rand(*lead, t, generator=gen)
    out = gl.gamma_contract_pairs(P, info, logZ, alpha, beta)
    ref = gl.gamma_contract_pairs_plain(*(rows(x) for x in (P, info, logZ, alpha, beta)))
    for a, b in zip(out, ref):
        assert a.shape == (*lead, *b.shape[1:])
        torch.testing.assert_close(rows(a), b, rtol=1e-6, atol=1e-6)


def _close(actual, expected):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [6, 9])
def test_sequential_contractions_of_a_broadcast_factor_match_jax(T):
    """K4b's and K5b's time contractions of a chain whose precision is
    broadcast over the sequences (two leading dims, stride 0 over the outer
    one and over time), as IndependentHMM's and the filters' are, against
    the JAX package on the same values."""
    rng = np.random.default_rng(T)
    n2 = 4
    M = rng.standard_normal((3, 1, n2, n2))
    P = (M @ np.swapaxes(M, -1, -2) / n2 + np.eye(n2)).astype(np.float32)
    info = rng.standard_normal((2, 3, T, n2)).astype(np.float32)
    logZ = rng.standard_normal((2, 3, T)).astype(np.float32)
    alpha = (2.0 + rng.integers(0, 4, (2, 3, T))).astype(np.float32)
    beta = (1.0 + rng.random((2, 3, T))).astype(np.float32)
    Pb = np.broadcast_to(P, (2, 3, T, n2, n2))

    t = tg.Gaussian(torch.tensor(logZ), torch.tensor(info), torch.tensor(P))
    j = jg.Gaussian(jnp.asarray(logZ), jnp.asarray(info), jnp.asarray(Pb))
    got, ref = tg.sequential_gaussian_tensordot(t), jax.jit(jg.sequential_gaussian_tensordot)(j)
    for k in ("log_normalizer", "info_vec", "precision"):
        _close(getattr(got, k), getattr(ref, k))

    t = tgg.GammaGaussian(*(torch.tensor(a) for a in (logZ, info, P, alpha, beta)))
    j = jgg.GammaGaussian(*(jnp.asarray(a) for a in (logZ, info, Pb, alpha, beta)))
    got, ref = tgg.sequential_gamma_gaussian_tensordot(t), jax.jit(jgg.sequential_gamma_gaussian_tensordot)(j)
    for k in ("log_normalizer", "info_vec", "precision", "alpha", "beta"):
        _close(getattr(got, k), getattr(ref, k))
