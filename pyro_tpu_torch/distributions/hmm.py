"""Hidden Markov models with O(log T) exact marginalisation (counterpart
of ``DiscreteHMM`` and ``GaussianHMM`` in ``pyro_tpu/distributions/hmm.py``).

Generative semantics: ``z ~ initial; repeat T times: z ~ trans(z); emit
y ~ obs(z)``, so ``event_shape = (T,) + observation event shape`` and
homogeneous parameters broadcast along a size-1 time axis.  DiscreteHMM
eliminates time by a pairwise log-matmul-exp reduction, one batched
``logmatmulexp`` (the CUDA kernel on the card) per round; GaussianHMM by the
information-form Gaussian algebra of ``ops/gaussian.py``, whose halving
levels are the K4 kernels on the card.
"""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .util import broadcast_shape
from ..ops.gaussian import (
    Gaussian,
    gaussian_tensordot,
    matrix_and_mvn_to_gaussian,
    mvn_to_gaussian,
    sequential_gaussian_filter_sample,
    sequential_gaussian_filter_sample_homogeneous,
    sequential_gaussian_tensordot,
    sequential_gaussian_tensordot_homogeneous,
)
from ..ops.log_matmul import logmatmulexp, sequential_logmatmulexp_timemajor


def _sequential_logmatmulexp(logits, logmatmulexp=logmatmulexp):
    """Reduce a (..., T, S, S) chain of log transition factors to one
    (..., S, S) factor: ``sequential_logmatmulexp_timemajor`` on the view
    with time leading."""
    return sequential_logmatmulexp_timemajor(logits.movedim(-3, 0), logmatmulexp)


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


class GaussianHMM(Distribution):
    """A linear-Gaussian state-space model: ``initial_dist`` over the first
    hidden state (an MVN of dim ``hidden_dim``), ``z' = z @ transition_matrix
    + transition noise``, ``y = z' @ observation_matrix + observation
    noise``, each noise an ``Independent(Normal)`` or ``MultivariateNormal``.
    Parameters with a time axis (``transition_matrix`` (T, hidden, hidden),
    for one) make the chain heterogeneous.  Draws take a ``torch.Generator``."""

    arg_constraints = {}
    has_rsample = True
    support = constraints.independent(constraints.real, 2)

    def __init__(self, initial_dist, transition_matrix, transition_dist, observation_matrix, observation_dist,
                 duration=None):
        hidden_dim, obs_dim = observation_matrix.shape[-2:]
        assert initial_dist.event_shape == (hidden_dim,)
        assert transition_matrix.shape[-2:] == (hidden_dim, hidden_dim)
        assert transition_dist.event_shape == (hidden_dim,)
        assert observation_dist.event_shape == (obs_dim,)
        shape = broadcast_shape(
            initial_dist.batch_shape + (1,), transition_matrix.shape[:-2], transition_dist.batch_shape,
            observation_matrix.shape[:-2], observation_dist.batch_shape,
        )
        batch_shape, time_shape = shape[:-1], shape[-1:]
        event_shape = tuple(time_shape) + (obs_dim,)
        if duration is None and event_shape[0] != 1:
            duration = event_shape[0]
        elif duration is not None and event_shape[0] == 1:
            event_shape = (duration,) + tuple(event_shape[1:])
        self.duration = duration
        super().__init__(batch_shape, event_shape)
        self.hidden_dim = hidden_dim
        self.obs_dim = obs_dim
        self._init = mvn_to_gaussian(initial_dist).expand(self.batch_shape)
        self._trans = matrix_and_mvn_to_gaussian(transition_matrix, transition_dist)
        self._obs = matrix_and_mvn_to_gaussian(observation_matrix, observation_dist)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        new = object.__new__(GaussianHMM)
        new.hidden_dim, new.obs_dim = self.hidden_dim, self.obs_dim
        new._obs, new._trans = self._obs, self._trans
        new._init = self._init.expand(batch_shape)
        new.duration = self.duration
        Distribution.__init__(new, batch_shape, self.event_shape)
        return new

    def _validate_value(self, value):
        """Reject values with missing event dims, a mismatched event shape,
        or a time axis that disagrees with the model's."""
        if value.ndim < 2:
            raise ValueError(f"value has too few dimensions: {tuple(value.shape)}")
        t_model = self.event_shape[0]
        if value.shape[-1] != self.obs_dim or (t_model != 1 and value.shape[-2] != t_model):
            raise ValueError(
                f"The right-most size of value must match event_shape: {tuple(value.shape)} vs {self.event_shape}"
            )
        broadcast_shape(value.shape[:-2], self.batch_shape)
        return value

    def _conditioned(self, value):
        return self._trans + self._obs.condition(value).event_pad(left=self.hidden_dim)

    def log_prob(self, value):
        value = self._validate_value(value)
        result = self._conditioned(value)
        if result.precision.ndim == 2:
            # time-invariant parameters: the data enters only the info
            # vectors, so every step shares one precision (K4a)
            result = sequential_gaussian_tensordot_homogeneous(result)
        else:
            result = sequential_gaussian_tensordot(result.expand(result.batch_shape))
        result = gaussian_tensordot(self._init, result, dims=self.hidden_dim)
        return result.event_logsumexp()

    def rsample(self, generator=None, sample_shape=()):
        assert self.duration is not None
        trans = self._trans + self._obs.marginalize(right=self.obs_dim).event_pad(left=self.hidden_dim)
        T = self.duration
        if trans.precision.ndim == 2 and not self.batch_shape:
            trans_b = Gaussian(
                trans.log_normalizer.expand((T,)), trans.info_vec.expand((T,) + trans.info_vec.shape[-1:]),
                trans.precision,
            )
            z = sequential_gaussian_filter_sample_homogeneous(self._init, trans_b, sample_shape, generator)
        else:
            trans = trans.expand(broadcast_shape(trans.batch_shape, self.batch_shape + (T,)))
            z = sequential_gaussian_filter_sample(self._init, trans, sample_shape, generator)
        z = z[..., 1:, :]  # drop the initial hidden state
        return self._obs.left_condition(z).rsample(generator)

    def rsample_posterior(self, value, generator=None, sample_shape=()):
        """Draws of the hidden states (T, hidden_dim) given observations."""
        value = self._validate_value(value)
        trans = self._conditioned(value)
        if trans.precision.ndim == 2:
            z = sequential_gaussian_filter_sample_homogeneous(self._init, trans, sample_shape, generator)
        else:
            z = sequential_gaussian_filter_sample(self._init, trans.expand(trans.batch_shape), sample_shape,
                                                  generator)
        return z[..., 1:, :]

    def filter(self, value):
        """The posterior over the final hidden state, as an MVN."""
        logp = self._conditioned(value)
        logp = sequential_gaussian_tensordot(logp.expand(logp.batch_shape))
        logp = gaussian_tensordot(self._init, logp, dims=self.hidden_dim)
        return logp.to_mvn()
