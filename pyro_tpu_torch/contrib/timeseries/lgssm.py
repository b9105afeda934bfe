"""A generic learnable linear-Gaussian state-space model (counterpart of
``pyro_tpu/contrib/timeseries/lgssm.py``).

Its ``GaussianHMM`` takes the transition with a leading time axis of one
(``trans_matrix[None]``), so the conditioned chain's precision has a time
axis and ``log_prob`` runs the heterogeneous route: one K4b level after
another (on the card, the hand-written kernels forward and backward).
"""

from __future__ import annotations

import torch

from ... import distributions as dist
from ...distributions import constraints
from .base import TimeSeriesModel


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
