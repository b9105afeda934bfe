"""Chain diagnostics and interval summaries (counterpart of the part of
``pyro_tpu/ops/stats.py`` that MCMC uses).

Chain statistics take input of shape (num_chains, num_samples, ...), with
``chain_dim`` and ``sample_dim`` to move them; the trailing dims are a
batch, computed at once.
"""

from __future__ import annotations

import math

import torch


def autocorrelation(x, dim: int = 0):
    """Autocorrelation along ``dim`` by FFT, zero-padded to a power of two
    at least twice the length."""
    n = x.shape[dim]
    x = torch.movedim(x, dim, -1)
    centered = x - x.mean(-1, keepdim=True)
    m = int(2 ** math.ceil(math.log2(2 * n)))
    f = torch.fft.rfft(centered, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n]
    return torch.movedim(acov / acov[..., :1], -1, dim)


def autocovariance(x, dim: int = 0):
    """Autocovariance along ``dim``: the autocorrelation times the variance."""
    var = torch.movedim(x, dim, -1).var(-1, correction=0, keepdim=True)
    return torch.movedim(torch.movedim(autocorrelation(x, dim), dim, -1) * var, -1, dim)


def gelman_rubin(x, chain_dim: int = 0, sample_dim: int = 1):
    """The potential scale reduction factor R-hat."""
    x = torch.movedim(x, (chain_dim, sample_dim), (0, 1))
    N = x.shape[1]
    W = x.var(1, correction=1).mean(0)
    B = N * x.mean(1).var(0, correction=1)
    var_hat = (N - 1) / N * W + B / N
    return torch.sqrt(var_hat / W)


def split_gelman_rubin(x, chain_dim: int = 0, sample_dim: int = 1):
    """R-hat over the chains split in halves."""
    x = torch.movedim(x, (chain_dim, sample_dim), (0, 1))
    half = x.shape[1] // 2
    return gelman_rubin(torch.cat([x[:, :half], x[:, half: 2 * half]], dim=0))


def effective_sample_size(x, chain_dim: int = 0, sample_dim: int = 1):
    """Effective sample size with Geyer's initial monotone sequence."""
    x = torch.movedim(x, (chain_dim, sample_dim), (0, 1))
    C, N = x.shape[0], x.shape[1]
    gamma_mean = autocovariance(x, dim=1).mean(0)  # (N, ...)
    W = x.var(1, correction=1).mean(0)
    B_over_n = x.mean(1).var(0, correction=1) if C > 1 else torch.zeros_like(W)
    var_hat = (N - 1) / N * W + B_over_n
    rho = 1.0 - (W - gamma_mean) / var_hat
    # sums of consecutive pairs, made non-increasing, cut at the first
    # that is not positive
    n_pairs = N // 2
    paired = rho[: 2 * n_pairs].reshape((n_pairs, 2) + rho.shape[1:]).sum(1)
    paired_mono = torch.cummin(paired, dim=0).values
    keep = torch.cumprod((paired_mono > 0).to(paired.dtype), dim=0)
    tau = -1.0 + 2.0 * (paired_mono * keep).sum(0)
    tau = torch.clamp(tau, min=1.0 / math.log10(C * N))
    return C * N / tau


def quantile(x, probs, dim: int = 0):
    """Quantiles at ``probs`` along ``dim``, by linear interpolation; the
    quantiles make a new leading dim."""
    return torch.quantile(x, torch.as_tensor(probs, dtype=x.dtype, device=x.device), dim=dim)


def pi(x, prob: float, dim: int = 0):
    """The central interval that holds ``prob`` of the draws."""
    return quantile(x, [(1 - prob) / 2, (1 + prob) / 2], dim)


def hpdi(x, prob: float, dim: int = 0):
    """The narrowest interval that holds ``prob`` of the draws: lower and
    upper bound along ``dim``."""
    x_sorted = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    mass = max(1, min(int(prob * n), n - 1))
    lower_all = x_sorted.narrow(dim, 0, n - mass)
    upper_all = x_sorted.narrow(dim, mass, n - mass)
    best = torch.argmin(upper_all - lower_all, dim=dim, keepdim=True)
    lower = torch.take_along_dim(lower_all, best, dim=dim)
    upper = torch.take_along_dim(upper_all, best, dim=dim)
    return torch.cat([lower, upper], dim=dim)
