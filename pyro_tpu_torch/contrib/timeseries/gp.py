"""State-space Gaussian-process time series (counterpart of
``pyro_tpu/contrib/timeseries/gp.py``).

Each model is a ``GaussianHMM`` over Matern state-space GPs, so scoring,
filtering and training run the K4 kernels on the card:
``IndependentMaternGP`` and ``LinearlyCoupledMaternGP`` give the chain a
time axis of one (the heterogeneous route, K4b; the former batched over its
channels, the precision read with stride 0 over time), ``DependentMaternGP``
one shared transition (the homogeneous route, K4a).  The matrices come from
``ops/ssm_gp.py::MaternKernel`` in the column convention z' = A z and are
transposed for ``GaussianHMM``'s rows, z' = z @ M.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import distributions as dist
from ...distributions import constraints
from ...ops.ssm_gp import MaternKernel
from ...ops.tensor_utils import block_diag_embed
from .base import TimeSeriesModel


def _selector(rows, cols, sd, device, dtype):
    """A (rows, cols) matrix with 1 at (i, sd * i): picks each GP's
    position component."""
    sel = torch.zeros(rows, cols, dtype=dtype, device=device)
    i = torch.arange(rows, device=device)
    sel[i, sd * i] = 1.0
    return sel


class IndependentMaternGP(TimeSeriesModel):
    """One Matern GP per observed dim, each scored by its own exact filter:
    an ``IndependentHMM`` over a ``GaussianHMM`` batched over the dims."""

    def __init__(self, nu: float = 1.5, dt: float = 1.0, obs_dim: int = 1, length_scale_init=None,
                 kernel_scale_init=None, obs_noise_scale_init=None, name=None):
        super().__init__(name)
        self.nu = nu
        self.dt = dt
        self.obs_dim = obs_dim
        self.kernel = MaternKernel(nu, obs_dim)
        self._register_param("length_scale", length_scale_init if length_scale_init is not None
                             else torch.ones(obs_dim), constraints.positive)
        self._register_param("kernel_scale", kernel_scale_init if kernel_scale_init is not None
                             else torch.ones(obs_dim), constraints.positive)
        self._register_param("obs_noise_scale", obs_noise_scale_init if obs_noise_scale_init is not None
                             else 0.2 * torch.ones(obs_dim), constraints.positive)

    def get_dist(self, duration=None):
        """The ``IndependentHMM`` over (T, obs_dim)."""
        length_scale, kernel_scale = self.length_scale, self.kernel_scale
        A, Q = self.kernel.transition_matrix_and_covariance(length_scale, kernel_scale, self.dt)
        P = self.kernel.stationary_covariance(length_scale, kernel_scale)
        sd = self.kernel.state_dim
        zeros = Q.new_zeros(self.obs_dim, 1, sd)
        init = dist.MultivariateNormal(zeros[:, 0], covariance_matrix=P)
        trans = dist.MultivariateNormal(zeros, covariance_matrix=Q[:, None])
        obs_matrix = Q.new_zeros(self.obs_dim, 1, sd, 1)
        obs_matrix[:, 0, 0, 0] = 1.0
        obs_noise = dist.Normal(Q.new_zeros(self.obs_dim, 1, 1), self.obs_noise_scale[:, None, None]).to_event(1)
        base = dist.GaussianHMM(init, A.transpose(-1, -2)[:, None], trans, obs_matrix, obs_noise, duration=duration)
        return dist.IndependentHMM(base)

    def log_prob(self, targets):
        """targets (T, obs_dim) -> the (obs_dim,) log densities, each GP
        scored on its own."""
        base = self.get_dist(duration=targets.shape[0]).base_dist
        return base.log_prob(targets.movedim(-1, 0)[..., None])

    def forecast(self, targets, dts):
        """The predictive ``Normal`` over (len(dts), obs_dim) at the offsets
        ``dts`` after ``targets``, from the filtered final state."""
        base = self.get_dist(duration=targets.shape[0]).base_dist
        filtered = base.filter(targets.movedim(-1, 0)[..., None])
        loc, cov = filtered.loc, filtered.covariance_matrix
        length_scale, kernel_scale = self.length_scale, self.kernel_scale
        noise_var = self.obs_noise_scale**2
        locs, scales = [], []
        for dt in torch.atleast_1d(torch.as_tensor(dts, dtype=loc.dtype, device=loc.device)):
            A, Q = self.kernel.transition_matrix_and_covariance(length_scale, kernel_scale, dt)
            pred_loc = (A @ loc.unsqueeze(-1)).squeeze(-1)
            pred_cov = A @ cov @ A.transpose(-1, -2) + Q
            locs.append(pred_loc[:, 0])
            scales.append(torch.sqrt(pred_cov[:, 0, 0] + noise_var))
        return dist.Normal(torch.stack(locs), torch.stack(scales))


class LinearlyCoupledMaternGP(TimeSeriesModel):
    """obs_dim outputs as linear mixtures (``A_mix``) of num_gps latent
    Matern GPs, one ``GaussianHMM`` over their stacked states.  ``A_mix``
    starts from a ``torch.Generator`` seeded 0 (the JAX package draws its
    own from ``jax.random.key(0)``)."""

    def __init__(self, nu: float = 1.5, dt: float = 1.0, obs_dim: int = 2, num_gps: int = 1,
                 length_scale_init=None, kernel_scale_init=None, obs_noise_scale_init=None, name=None):
        super().__init__(name)
        self.nu = nu
        self.dt = dt
        self.obs_dim = obs_dim
        self.num_gps = num_gps
        self.kernel = MaternKernel(nu, num_gps)
        self._register_param("length_scale", length_scale_init if length_scale_init is not None
                             else torch.ones(num_gps), constraints.positive)
        self._register_param("kernel_scale", kernel_scale_init if kernel_scale_init is not None
                             else torch.ones(num_gps), constraints.positive)
        self._register_param("obs_noise_scale", obs_noise_scale_init if obs_noise_scale_init is not None
                             else 0.2 * torch.ones(obs_dim), constraints.positive)
        gen = torch.Generator().manual_seed(0)
        self._register_param("A_mix", 0.3 * torch.randn(num_gps, obs_dim, generator=gen))

    def get_dist(self, duration=None):
        length_scale, kernel_scale = self.length_scale, self.kernel_scale
        A, Q = self.kernel.transition_matrix_and_covariance(length_scale, kernel_scale, self.dt)
        P = block_diag_embed(self.kernel.stationary_covariance(length_scale, kernel_scale))
        sd = self.kernel.state_dim
        full_dim = self.num_gps * sd
        # each output mixes the position components of the GPs
        sel = _selector(self.num_gps, full_dim, sd, Q.device, Q.dtype)
        obs_matrix = sel.T @ self.A_mix
        init = dist.MultivariateNormal(Q.new_zeros(full_dim), covariance_matrix=P)
        trans = dist.MultivariateNormal(Q.new_zeros(1, full_dim), covariance_matrix=block_diag_embed(Q)[None])
        obs_noise = dist.Normal(Q.new_zeros(1, self.obs_dim), self.obs_noise_scale[None]).to_event(1)
        trans_matrix = block_diag_embed(A.transpose(-1, -2))
        return dist.GaussianHMM(init, trans_matrix[None], trans, obs_matrix[None], obs_noise, duration=duration)

    def log_prob(self, targets):
        return self.get_dist(duration=targets.shape[0]).log_prob(targets)

    def forecast(self, targets, dts):
        raise NotImplementedError("use get_dist().filter + manual rollout; see IndependentMaternGP")


class DependentMaternGP(TimeSeriesModel):
    """Matern-1.5 GPs, one per output, driven by a correlated Wiener process
    whose covariance is ``wiener_noise_tril @ wiener_noise_tril.T``
    (optionally mixed linearly as ``LinearlyCoupledMaternGP``); one
    ``GaussianHMM`` over the stacked states, a state dim of 2 obs_dim.
    ``wiener_noise_tril`` (and ``mix_matrix``) start from numpy's
    ``RandomState(0)``, as in the JAX package."""

    def __init__(self, nu: float = 1.5, dt: float = 1.0, obs_dim: int = 1, linearly_coupled: bool = False,
                 length_scale_init=None, obs_noise_scale_init=None, name=None):
        if nu != 1.5:
            raise NotImplementedError("The only supported value of nu is 1.5")
        super().__init__(name)
        self.nu = nu
        self.dt = dt
        self.obs_dim = obs_dim
        self.linearly_coupled = linearly_coupled
        self.kernel = MaternKernel(nu, obs_dim)
        self.full_state_dim = self.kernel.state_dim * obs_dim
        self._register_param("length_scale", length_scale_init if length_scale_init is not None
                             else torch.ones(obs_dim), constraints.positive)
        self._register_param("obs_noise_scale", obs_noise_scale_init if obs_noise_scale_init is not None
                             else 0.2 * torch.ones(obs_dim), constraints.positive)
        rs, dtype = np.random.RandomState(0), torch.get_default_dtype()
        tril = np.eye(obs_dim) + 0.03 * np.tril(rs.randn(obs_dim, obs_dim), -1)
        self._register_param("wiener_noise_tril", torch.tensor(tril, dtype=dtype), constraints.lower_cholesky)
        if linearly_coupled:
            self._register_param("mix_matrix", torch.tensor(0.3 * rs.randn(obs_dim, obs_dim), dtype=dtype))

    def _get_wiener_cov(self):
        """W = tril tril^T, each entry spread over its (sd, sd) block."""
        sd = self.kernel.state_dim
        chol = self.wiener_noise_tril
        return (chol @ chol.T).repeat_interleave(sd, dim=0).repeat_interleave(sd, dim=1)

    def _stationary_covariance(self):
        """The coupled SSM's stationary covariance: for GPs i and j the 2x2
        block [[2, rho_i - rho_j], [rho_j - rho_i, 2 rho_i rho_j]] /
        (rho_i + rho_j)^3, rho = sqrt(3) / length_scale, times W_ij."""
        rho = math.sqrt(3.0) / self.length_scale
        rho_i, rho_j = rho[:, None], rho[None, :]
        denom = (rho_i + rho_j) ** 3
        block = torch.stack([
            torch.stack([2.0 / denom, (rho_i - rho_j) / denom], dim=-1),
            torch.stack([(rho_j - rho_i) / denom, 2.0 * rho_i * rho_j / denom], dim=-1),
        ], dim=-2)  # (n, n, 2, 2)
        full = block.permute(0, 2, 1, 3).reshape(self.full_state_dim, self.full_state_dim)
        return self._get_wiener_cov() * full

    def _get_obs_matrix(self):
        """(full_state_dim, obs_dim): each output reads its GP's position
        (or, linearly coupled, a mixture of every GP's)."""
        sel = _selector(self.obs_dim, self.full_state_dim, self.kernel.state_dim, self.length_scale.device,
                        self.length_scale.dtype)
        if self.linearly_coupled:
            return sel.T @ self.mix_matrix
        return sel.T

    def get_dist(self, duration=None):
        A_col = block_diag_embed(self.kernel.transition_matrix(self.length_scale, self.dt))  # z' = A z
        S = self._stationary_covariance()
        trans_cov = S - A_col @ S @ A_col.T
        eye = torch.eye(self.full_state_dim, dtype=S.dtype, device=S.device)
        trans_cov = 0.5 * (trans_cov + trans_cov.T) + 1e-6 * eye
        zeros = S.new_zeros(self.full_state_dim)
        init = dist.MultivariateNormal(zeros, covariance_matrix=S)
        trans = dist.MultivariateNormal(zeros, covariance_matrix=trans_cov)
        obs_noise_scale = self.obs_noise_scale
        obs_noise = dist.Normal(obs_noise_scale.new_zeros(self.obs_dim), obs_noise_scale).to_event(1)
        return dist.GaussianHMM(init, A_col.T, trans, self._get_obs_matrix(), obs_noise, duration=duration)

    def log_prob(self, targets):
        """targets (T, obs_dim) -> the scalar log density."""
        assert targets.ndim == 2 and targets.shape[-1] == self.obs_dim
        return self.get_dist(duration=targets.shape[0]).log_prob(targets)

