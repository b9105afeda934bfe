"""Generic learnable linear-Gaussian state-space models (counterpart of
``pyro_tpu/contrib/timeseries/lgssm.py``).

``GenericLGSSM``'s ``GaussianHMM`` takes the transition with a leading time
axis of one (``trans_matrix[None]``), so the conditioned chain's precision
has a time axis and ``log_prob`` runs the heterogeneous route: one K4b
level after another (on the card, the hand-written kernels forward and
backward).  ``GenericLGSSMWithGPNoiseModel`` shares one transition over
time, so its ``log_prob`` runs the homogeneous route, K4a.
"""

from __future__ import annotations

import torch

from ... import distributions as dist
from ...distributions import constraints
from ...ops.ssm_gp import MaternKernel
from ...ops.tensor_utils import block_diag_embed
from .base import TimeSeriesModel
from .gp import _selector


class GenericLGSSM(TimeSeriesModel):
    """z_t = z_{t-1} @ trans_matrix + N(0, diag(trans_noise_scale_sq)),
    y_t = z_t @ obs_matrix + N(obs_loc, obs_noise_scale^2), z_0 ~
    N(0, diag(init_noise_scale_sq)).  The initial ``trans_matrix`` and
    ``obs_matrix`` are drawn from a ``torch.Generator`` seeded 3 (the JAX
    package draws its own from ``jax.random.key(3)``)."""

    def __init__(self, obs_dim: int = 1, state_dim: int = 2, obs_noise_scale_init=None,
                 learnable_observation_loc: bool = False, name=None):
        super().__init__(name)
        self.obs_dim = obs_dim
        self.state_dim = state_dim
        gen = torch.Generator().manual_seed(3)
        self._register_param(
            "trans_matrix", torch.eye(state_dim) + 0.03 * torch.randn(state_dim, state_dim, generator=gen))
        self._register_param("trans_noise_scale_sq", 0.1 * torch.ones(state_dim), constraints.positive)
        self._register_param("obs_matrix", 0.3 * torch.randn(state_dim, obs_dim, generator=gen))
        self._register_param(
            "obs_noise_scale",
            obs_noise_scale_init if obs_noise_scale_init is not None else 0.2 * torch.ones(obs_dim),
            constraints.positive,
        )
        self._register_param("init_noise_scale_sq", torch.ones(state_dim), constraints.positive)
        self.learnable_observation_loc = learnable_observation_loc
        if learnable_observation_loc:
            self._register_param("obs_loc", torch.zeros(obs_dim))

    def get_dist(self, duration=None):
        init_scale_sq = self.init_noise_scale_sq
        zeros = init_scale_sq.new_zeros(self.state_dim)
        init = dist.MultivariateNormal(zeros, covariance_matrix=torch.diag(init_scale_sq))
        trans = dist.MultivariateNormal(zeros[None], covariance_matrix=torch.diag(self.trans_noise_scale_sq)[None])
        obs_noise_scale = self.obs_noise_scale
        obs_loc = self.obs_loc if self.learnable_observation_loc else obs_noise_scale.new_zeros(self.obs_dim)
        obs_noise = dist.Normal(obs_loc[None], obs_noise_scale[None]).to_event(1)
        return dist.GaussianHMM(init, self.trans_matrix[None], trans, self.obs_matrix[None], obs_noise,
                                duration=duration)

    def log_prob(self, targets):
        """The log density of one series ``targets`` (T, obs_dim)."""
        return self.get_dist(duration=targets.shape[0]).log_prob(targets)

    def forecast(self, targets, N_timesteps: int):
        """The predictive distribution of the next ``N_timesteps``
        observations after ``targets``: an MVN over (N_timesteps, obs_dim)."""
        filtered = self.get_dist(duration=targets.shape[0]).filter(targets)
        loc, cov = filtered.loc, filtered.covariance_matrix
        A = self.trans_matrix
        Q = torch.diag(self.trans_noise_scale_sq)
        H = self.obs_matrix
        R = torch.diag(self.obs_noise_scale**2)
        locs, covs = [], []
        for _ in range(N_timesteps):
            loc = loc @ A
            cov = A.T @ cov @ A + Q
            locs.append(loc @ H)
            covs.append(H.T @ cov @ H + R)
        return dist.MultivariateNormal(torch.stack(locs), covariance_matrix=torch.stack(covs))


class GenericLGSSMWithGPNoiseModel(TimeSeriesModel):
    """A linear-Gaussian SSM whose outputs also carry Matern GP noise, one
    GP an output: y_i(t) = sum_j z_j(t) z_obs_matrix_ji + f_i(t) +
    eps_i(t).  The GP states and the z-state stack into one
    ``GaussianHMM`` of state dim ``obs_dim * (nu + 1/2) + state_dim``.
    ``z_trans_matrix`` and ``z_obs_matrix`` start from a ``torch.Generator``
    seeded 7 (the JAX package draws its own from ``jax.random.key(7)``)."""

    def __init__(self, obs_dim: int = 1, state_dim: int = 2, nu: float = 1.5, obs_noise_scale_init=None,
                 length_scale_init=None, kernel_scale_init=None, learnable_observation_loc: bool = False,
                 name=None):
        super().__init__(name)
        self.obs_dim = obs_dim
        self.state_dim = state_dim
        self.nu = nu
        self.kernel = MaternKernel(nu, obs_dim)
        self.gp_state_dim = self.kernel.state_dim * obs_dim
        self.full_state_dim = self.gp_state_dim + state_dim
        self.dt = 1.0
        gen = torch.Generator().manual_seed(7)
        self._register_param("length_scale", length_scale_init if length_scale_init is not None
                             else torch.ones(obs_dim), constraints.positive)
        self._register_param("kernel_scale", kernel_scale_init if kernel_scale_init is not None
                             else torch.ones(obs_dim), constraints.positive)
        self._register_param("obs_noise_scale", obs_noise_scale_init if obs_noise_scale_init is not None
                             else 0.2 * torch.ones(obs_dim), constraints.positive)
        self._register_param(
            "z_trans_matrix", torch.eye(state_dim) + 0.03 * torch.randn(state_dim, state_dim, generator=gen))
        self._register_param("z_obs_matrix", 0.3 * torch.randn(state_dim, obs_dim, generator=gen))
        self._register_param("trans_noise_scale_sq", torch.ones(state_dim), constraints.positive)
        self._register_param("init_noise_scale_sq", torch.ones(state_dim), constraints.positive)
        if learnable_observation_loc:
            self._register_param("obs_loc", torch.zeros(obs_dim))
        self._learnable_obs_loc = learnable_observation_loc

    def get_dist(self, duration=None):
        length_scale, kernel_scale = self.length_scale, self.kernel_scale
        A_gp, Q_gp = self.kernel.transition_matrix_and_covariance(length_scale, kernel_scale, self.dt)
        P_gp = block_diag_embed(self.kernel.stationary_covariance(length_scale, kernel_scale))
        # rows: the GP block's column-convention transition transposed, the
        # z-state's own row-convention matrix
        trans_matrix = torch.block_diag(block_diag_embed(A_gp).T, self.z_trans_matrix)
        trans_cov = torch.block_diag(block_diag_embed(Q_gp), torch.diag(self.trans_noise_scale_sq))
        init_cov = torch.block_diag(P_gp, torch.diag(self.init_noise_scale_sq))
        gp_obs = _selector(self.obs_dim, self.gp_state_dim, self.kernel.state_dim, Q_gp.device, Q_gp.dtype).T
        obs_matrix = torch.cat([gp_obs, self.z_obs_matrix], dim=0)
        obs_noise_scale = self.obs_noise_scale
        obs_loc = self.obs_loc if self._learnable_obs_loc else obs_noise_scale.new_zeros(self.obs_dim)
        n = self.full_state_dim
        zeros = Q_gp.new_zeros(n)
        eye = torch.eye(n, dtype=Q_gp.dtype, device=Q_gp.device)
        init = dist.MultivariateNormal(zeros, covariance_matrix=init_cov)
        trans = dist.MultivariateNormal(zeros, covariance_matrix=trans_cov + 1e-6 * eye)
        obs_noise = dist.Normal(obs_loc, obs_noise_scale).to_event(1)
        return dist.GaussianHMM(init, trans_matrix, trans, obs_matrix, obs_noise, duration=duration)

    def log_prob(self, targets):
        assert targets.ndim == 2 and targets.shape[-1] == self.obs_dim
        return self.get_dist(duration=targets.shape[0]).log_prob(targets)
