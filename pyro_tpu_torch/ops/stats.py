"""Chain diagnostics, interval summaries and scores of draws (counterpart
of ``pyro_tpu/ops/stats.py``).

Chain statistics take input of shape (num_chains, num_samples, ...), with
``chain_dim`` and ``sample_dim`` to move them; the trailing dims are a
batch, computed at once.
"""

from __future__ import annotations

import math

import numpy as np
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


def resample(x, num_samples: int, dim: int = 0, replacement: bool = False, generator=None):
    """``num_samples`` entries of ``x`` along ``dim``, drawn with or without
    replacement."""
    n = x.shape[dim]
    if replacement:
        idx = torch.randint(n, (num_samples,), generator=generator, device=x.device)
    else:
        idx = torch.randperm(n, generator=generator, device=x.device)[:num_samples]
    return torch.index_select(x, dim, idx)


def _weighted_mean(x, log_weights, dim=0, keepdim=False):
    dim = x.ndim + dim if dim < 0 else dim
    lw = log_weights.reshape((-1,) + (1,) * (x.ndim - dim - 1))
    rel = torch.exp(lw - lw.max(0).values)
    return (x * rel).sum(dim, keepdim=keepdim) / rel.sum()


def _weighted_variance(x, log_weights, dim=0, keepdim=False, unbiased=True):
    dev2 = (x - _weighted_mean(x, log_weights, dim, keepdim=True)) ** 2
    n = log_weights.shape[0]
    correction = n / (n - 1.0) if unbiased else 1.0
    return _weighted_mean(dev2, log_weights, dim, keepdim) * correction


def waic(x, log_weights=None, pointwise: bool = False, dim: int = 0):
    """The widely applicable information criterion and its effective number
    of parameters, of log likelihoods ``x`` with draws along ``dim``
    (optionally importance-weighted); summed over the data unless
    ``pointwise``."""
    if log_weights is None:
        log_weights = torch.zeros(x.shape[dim], dtype=x.dtype, device=x.device)
    dim = x.ndim + dim if dim < 0 else dim
    lw = log_weights.reshape((-1,) + (1,) * (x.ndim - dim - 1))
    lpd = torch.logsumexp(x + lw, dim) - torch.logsumexp(log_weights, 0)
    p_waic = _weighted_variance(x, log_weights, dim)
    waic_val = -2 * (lpd - p_waic)
    if pointwise:
        return waic_val, p_waic
    return waic_val.sum(), p_waic.sum()


def crps_empirical(pred, truth):
    """The continuous ranked probability score of draws ``pred``
    (num_samples,) + truth.shape, by the sorted-weight form (O(n log n))."""
    n = pred.shape[0]
    mean_abs_err = (pred - truth[None]).abs().mean(0)
    pred_sorted = torch.sort(pred, dim=0).values
    i = torch.arange(n, dtype=pred.dtype, device=pred.device)
    weights = (2 * i + 1 - n).reshape((n,) + (1,) * (pred.ndim - 1))
    return mean_abs_err - (weights * pred_sorted).sum(0) / (n * n)


def fit_generalized_pareto(x):
    """Zhang and Stephens' (2009) fit of a generalized Pareto distribution
    to the 1-D samples ``x`` (the PSIS diagnostic's): (k, sigma)."""
    x = np.sort(np.asarray(torch.as_tensor(x).detach().cpu(), dtype=np.float64))
    n = len(x)
    prior_bs = 3.0
    m_est = 30 + int(math.sqrt(n))
    b = 1 - np.sqrt(m_est / (np.arange(1, m_est + 1) - 0.5))
    b = b / (prior_bs * x[int(n / 4 + 0.5) - 1]) + 1 / x[-1]
    k = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    log_lik = n * (np.log(-b / k) - k - 1)
    w = 1 / np.sum(np.exp(log_lik - log_lik[:, None]), axis=1)
    b_post = np.sum(b * w)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    k_post = k_post * n / (n + 10.0) + 5.0 / (n + 10.0) * 0.5
    return k_post, sigma


def energy_score_empirical(pred, truth):
    """The energy score (the multivariate CRPS) of draws ``pred``
    (num_samples, d) against ``truth`` (d,)."""
    n = pred.shape[0]
    t1 = torch.linalg.norm(pred - truth[None], dim=-1).mean()
    t2 = torch.linalg.norm(pred[:, None, :] - pred[None, :, :], dim=-1).sum() / (2 * n * n)
    return t1 - t2


def weighed_quantile(input, probs, log_weights, dim: int = 0):
    """Quantiles at ``probs`` of draws ``input`` along ``dim`` with weights
    exp(``log_weights``), interpolated between the sorted draws."""
    input = torch.as_tensor(input)
    dim = dim if dim >= 0 else input.ndim + dim
    probs = torch.as_tensor(probs, dtype=input.dtype, device=input.device)
    log_weights = torch.as_tensor(log_weights, dtype=input.dtype, device=input.device)
    weights = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    order = torch.argsort(input, dim=dim)
    sorted_input = torch.take_along_dim(input, order, dim=dim)
    w = torch.cumsum(weights[order], dim=dim)
    w = w - w.amin(dim, keepdim=True)
    w = w / w.amax(dim, keepdim=True)
    above = (w.unsqueeze(-1) <= probs).sum(dim, keepdim=True).transpose(dim, -1).squeeze(-1)
    above = above.clamp(max=input.shape[dim] - 1)
    below = (above - 1).clamp(min=0)
    q_below = torch.take_along_dim(sorted_input, below, dim=dim)
    q_above = torch.take_along_dim(sorted_input, above, dim=dim)
    view = [1] * input.ndim
    view[dim] = -1
    expanded = list(input.shape)
    expanded[dim] = len(probs)
    probs_b = probs.reshape(view).expand(expanded)
    w_below = torch.take_along_dim(w, below, dim=dim)
    w_above = torch.take_along_dim(w, above, dim=dim)
    frac_below = (w_above - probs_b) / torch.clamp(w_above - w_below, min=torch.finfo(input.dtype).tiny)
    return frac_below * q_below + (1 - frac_below) * q_above
