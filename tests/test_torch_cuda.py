"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip elsewhere.  They import neither JAX nor
the JAX package, so on a machine without JAX run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: forward atol 1e-4 on log values; gradients rtol 1e-4 with atol
1e-5 * max|g| (the kernel sums in another order than cuBLAS).
"""

import numpy as np
import pytest
import torch

from pyro_tpu_torch.ops import log_matmul as lm

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
    _compare(x, y, g)


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
