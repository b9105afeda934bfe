"""Discrete hidden Markov model with O(log T) exact marginalisation
(counterpart of ``DiscreteHMM`` in ``pyro_tpu/distributions/hmm.py``).

Generative semantics: ``z ~ initial; repeat T times: z ~ trans(z); emit
y ~ obs(z)``, so ``event_shape = (T,) + observation event shape`` and
homogeneous parameters broadcast along a size-1 time axis.  Time is
eliminated by a pairwise log-matmul-exp reduction, one batched
``logmatmulexp`` (the CUDA kernel on the card) per round.
"""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .util import broadcast_shape
from ..ops.log_matmul import logmatmulexp


def _sequential_logmatmulexp(logits, logmatmulexp=logmatmulexp):
    """Reduce a (..., T, S, S) chain of log transition factors to one
    (..., S, S) factor in ceil(log2 T) rounds.  The paired halves are
    strided views, which the kernel reads in place."""
    while logits.shape[-3] > 1:
        time = logits.shape[-3]
        even_time = time // 2 * 2
        x_y = logits[..., :even_time, :, :].reshape(logits.shape[:-3] + (even_time // 2, 2) + logits.shape[-2:])
        contracted = logmatmulexp(x_y[..., 0, :, :], x_y[..., 1, :, :])
        if time > even_time:
            contracted = torch.cat([contracted, logits[..., even_time:, :, :]], dim=-3)
        logits = contracted
    return logits[..., 0, :, :]


class DiscreteHMM(Distribution):
    arg_constraints = {"initial_logits": constraints.real, "transition_logits": constraints.real}

    def __init__(self, initial_logits, transition_logits, observation_dist, duration=None):
        if initial_logits.ndim < 1:
            raise ValueError("initial_logits needs at least 1 dim")
        if transition_logits.ndim < 2:
            raise ValueError("transition_logits needs at least 2 dims")
        if len(observation_dist.batch_shape) < 1:
            raise ValueError("observation_dist needs at least 1 batch dim")
        shape = broadcast_shape(
            initial_logits.shape[:-1] + (1,), transition_logits.shape[:-2], observation_dist.batch_shape[:-1]
        )
        batch_shape, time_shape = shape[:-1], shape[-1:]
        event_shape = tuple(time_shape) + observation_dist.event_shape
        self.initial_logits = initial_logits - torch.logsumexp(initial_logits, dim=-1, keepdim=True)
        self.transition_logits = transition_logits - torch.logsumexp(transition_logits, dim=-1, keepdim=True)
        self.observation_dist = observation_dist
        if duration is None and event_shape[0] != 1:
            duration = event_shape[0]
        elif duration is not None and event_shape[0] == 1:
            event_shape = (duration,) + tuple(event_shape[1:])
        self.duration = duration
        super().__init__(batch_shape, event_shape)

    @property
    def support(self):  # type: ignore[override]
        return constraints.independent(self.observation_dist.support, 1)

    def _validate_value(self, value):
        """Reject values with missing event dims, a mismatched event shape,
        or a time axis that disagrees with the model's."""
        obs_ed = self.observation_dist.event_dim
        event_ndim = 1 + obs_ed
        if value.ndim < event_ndim:
            raise ValueError(f"value has too few dimensions: {tuple(value.shape)}")
        bad_event = obs_ed and tuple(value.shape[-obs_ed:]) != tuple(self.event_shape[1:])
        t_model = self.event_shape[0]
        if bad_event or (t_model != 1 and value.shape[-event_ndim] != t_model):
            raise ValueError(
                f"The right-most size of value must match event_shape: {tuple(value.shape)} vs {self.event_shape}"
            )
        broadcast_shape(value.shape[:-event_ndim], self.batch_shape)
        return value

    def log_prob(self, value):
        value = self._validate_value(value)
        value = value.unsqueeze(-1 - self.observation_dist.event_dim)
        observation_logits = self.observation_dist.log_prob(value)
        result = self.transition_logits + observation_logits.unsqueeze(-2)
        result = _sequential_logmatmulexp(result)
        result = self.initial_logits + torch.logsumexp(result, dim=-1)
        return torch.logsumexp(result, dim=-1)
