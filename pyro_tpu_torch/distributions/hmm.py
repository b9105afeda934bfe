"""Hidden Markov models with O(log T) exact marginalisation (counterpart
of ``DiscreteHMM``, ``GaussianHMM``, ``GammaGaussianHMM``, ``IndependentHMM``
and ``GaussianMRF`` in ``pyro_tpu/distributions/hmm.py``).

Generative semantics: ``z ~ initial; repeat T times: z ~ trans(z); emit
y ~ obs(z)``, so ``event_shape = (T,) + observation event shape`` and
homogeneous parameters broadcast along a size-1 time axis.  DiscreteHMM
eliminates time by a pairwise log-matmul-exp reduction: at S <= 64 states
the whole chain in one launch each way (K3f on the card), above it one
batched ``logmatmulexp`` (K1) per round; GaussianHMM by the
information-form Gaussian algebra of ``ops/gaussian.py``, whose halving
levels are the K4 kernels on the card; GammaGaussianHMM (Student-t noise
through a shared Gamma scale) by the gamma-Gaussian algebra of
``ops/gamma_gaussian.py``, whose levels are the K5 kernels.
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
from ..ops.gamma_gaussian import (
    gamma_and_mvn_to_gamma_gaussian,
    gamma_gaussian_tensordot,
    matrix_and_mvn_to_gamma_gaussian,
    sequential_gamma_gaussian_tensordot,
    sequential_gamma_gaussian_tensordot_homogeneous,
)
from ..ops.log_matmul import sequential_logmatmulexp_timemajor


def _sequential_logmatmulexp(logits, logmatmulexp=None):
    """Reduce a (..., T, S, S) chain of log transition factors to one
    (..., S, S) factor: ``sequential_logmatmulexp_timemajor`` on the view
    with time leading (K3f at S <= 64, K1 rounds above, or rounds of the
    ``logmatmulexp`` given)."""
    return sequential_logmatmulexp_timemajor(logits.movedim(-3, 0), logmatmulexp)


def _with_duration(duration, event_shape):
    """``(duration, event_shape)`` of an HMM whose factors give
    ``event_shape`` (time first, 1 where they are homogeneous)."""
    if duration is None and event_shape[0] != 1:
        duration = event_shape[0]
    elif duration is not None and event_shape[0] == 1:
        event_shape = (duration,) + tuple(event_shape[1:])
    return duration, tuple(event_shape)


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
        self.initial_logits = initial_logits - torch.logsumexp(initial_logits, dim=-1, keepdim=True)
        self.transition_logits = transition_logits - torch.logsumexp(transition_logits, dim=-1, keepdim=True)
        self.observation_dist = observation_dist
        self.duration, event_shape = _with_duration(duration, tuple(time_shape) + observation_dist.event_shape)
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


class _StateSpaceModel(Distribution):
    """What GaussianHMM and GammaGaussianHMM share: factors ``_init`` (over
    the first hidden state), ``_trans`` (over (z, z')) and ``_obs`` (over
    (z', y)) of the Gaussian or gamma-Gaussian algebra."""

    arg_constraints = {}
    support = constraints.independent(constraints.real, 2)

    def _with_factors(self, init, trans, obs, batch_shape, duration):
        """A model of this class over the given factors."""
        new = object.__new__(type(self))
        new.hidden_dim, new.obs_dim = self.hidden_dim, self.obs_dim
        new._init, new._trans, new._obs = init, trans, obs
        new.duration = duration
        Distribution.__init__(new, batch_shape, (self.event_shape[0] if duration is None else duration, self.obs_dim))
        return new

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return self._with_factors(self._init.expand(batch_shape), self._trans, self._obs, batch_shape, self.duration)

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

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError


class GaussianHMM(_StateSpaceModel):
    """A linear-Gaussian state-space model: ``initial_dist`` over the first
    hidden state (an MVN of dim ``hidden_dim``), ``z' = z @ transition_matrix
    + transition noise``, ``y = z' @ observation_matrix + observation
    noise``, each noise an ``Independent(Normal)`` or ``MultivariateNormal``.
    Parameters with a time axis (``transition_matrix`` (T, hidden, hidden),
    for one) make the chain heterogeneous.  Draws take a ``torch.Generator``."""

    has_rsample = True

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
        self.duration, event_shape = _with_duration(duration, tuple(time_shape) + (obs_dim,))
        super().__init__(batch_shape, event_shape)
        self.hidden_dim = hidden_dim
        self.obs_dim = obs_dim
        self._init = mvn_to_gaussian(initial_dist).expand(self.batch_shape)
        self._trans = matrix_and_mvn_to_gaussian(transition_matrix, transition_dist)
        self._obs = matrix_and_mvn_to_gaussian(observation_matrix, observation_dist)

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

    def _likelihood_to_gaussian(self, other):
        """The per-step likelihood Gaussian over obs_dim (batch ``(..., T)``)
        of an ``Independent`` Normal or MultivariateNormal of event shape
        ``(T, obs_dim)``."""
        from .continuous import Normal
        from .distribution import Independent
        from .multivariate import MultivariateNormal

        if isinstance(other, Independent):
            base = other.base_dist
            if isinstance(base, Normal):
                shape = tuple(other.batch_shape) + tuple(other.event_shape)
                return mvn_to_gaussian(Independent(Normal(base.loc.expand(shape), base.scale.expand(shape)), 1))
            if isinstance(base, MultivariateNormal):
                return mvn_to_gaussian(base)
        raise ValueError(
            "conjugate_update requires an Independent Normal or MultivariateNormal likelihood with "
            f"event_shape (T, obs_dim); got {type(other).__name__}"
        )

    def conjugate_update(self, other):
        """Fuse a Normal or MultivariateNormal likelihood ``other`` over the
        observations into the model: ``(updated, log_normalizer)`` with
        ``self.log_prob(x) + other.log_prob(x) == updated.log_prob(x) +
        log_normalizer``."""
        duration = other.event_shape[0] if self.duration is None else self.duration
        assert tuple(other.event_shape) == (duration, self.obs_dim)
        obs = self._obs + self._likelihood_to_gaussian(other).event_pad(left=self.hidden_dim)
        # the updated init absorbs -log Z, so the result is normalised over observations
        logp = self._trans + obs.marginalize(right=self.obs_dim).event_pad(left=self.hidden_dim)
        logp = sequential_gaussian_tensordot(logp.expand(logp.batch_shape))
        log_normalizer = gaussian_tensordot(self._init, logp, dims=self.hidden_dim).event_logsumexp()
        new = self._with_factors(self._init - log_normalizer, self._trans, obs, log_normalizer.shape, duration)
        return new, log_normalizer

    def prefix_condition(self, data):
        """Condition on the first ``t = data.shape[-2]`` observations and return
        the posterior predictive model of the remaining ``duration - t`` (the
        forecasting primitive)."""
        assert data.ndim >= 2 and data.shape[-1] == self.event_shape[-1] and data.shape[-2] < self.duration
        t = data.shape[-2]

        def split(g):  # homogeneous factors are shared; heterogeneous ones split in time
            if g.batch_shape == () or g.batch_shape[-1] == 1:
                return g, g
            return g[..., :t], g[..., t:]

        (left_trans, right_trans), (left_obs, right_obs) = split(self._trans), split(self._obs)
        left = self._with_factors(self._init, left_trans, left_obs, self.batch_shape, t)
        init = mvn_to_gaussian(left.filter(data))
        return self._with_factors(init, right_trans, right_obs, broadcast_shape(init.batch_shape, self.batch_shape),
                                  self.duration - t)


class GammaGaussianHMM(_StateSpaceModel):
    """A linear state-space model with Student-t noise: a shared mixing
    variable ``s ~ scale_dist`` (a ``Gamma``) scales the precision of every
    noise term, ``z ~ scale(initial_dist, s)``, ``z' = z @
    transition_matrix + scale(transition_dist, s)``, ``y = z' @
    observation_matrix + scale(observation_dist, s)``, where
    ``scale(mvn(loc, P), s) = mvn(loc, s P)``.  ``log_prob`` integrates out
    the hidden states and ``s``; time is contracted by K5a where every step
    shares one precision, else by K5b."""

    def __init__(self, scale_dist, initial_dist, transition_matrix, transition_dist, observation_matrix,
                 observation_dist, duration=None):
        hidden_dim, obs_dim = observation_matrix.shape[-2:]
        assert initial_dist.event_shape == (hidden_dim,)
        assert transition_matrix.shape[-2:] == (hidden_dim, hidden_dim)
        assert transition_dist.event_shape == (hidden_dim,)
        assert observation_dist.event_shape == (obs_dim,)
        shape = broadcast_shape(
            tuple(scale_dist.batch_shape) + (1,), initial_dist.batch_shape + (1,), transition_matrix.shape[:-2],
            transition_dist.batch_shape, observation_matrix.shape[:-2], observation_dist.batch_shape,
        )
        batch_shape, time_shape = shape[:-1], shape[-1:]
        self.duration, event_shape = _with_duration(duration, tuple(time_shape) + (obs_dim,))
        super().__init__(batch_shape, event_shape)
        self.hidden_dim = hidden_dim
        self.obs_dim = obs_dim
        self._init = gamma_and_mvn_to_gamma_gaussian(scale_dist, initial_dist).expand(self.batch_shape)
        self._trans = matrix_and_mvn_to_gamma_gaussian(transition_matrix, transition_dist)
        self._obs = matrix_and_mvn_to_gamma_gaussian(observation_matrix, observation_dist)

    def log_prob(self, value):
        value = self._validate_value(value)
        result = self._conditioned(value)
        if result.precision.ndim == 2:
            # time-invariant parameters: every step shares one precision (K5a)
            result = sequential_gamma_gaussian_tensordot_homogeneous(result)
        else:
            result = sequential_gamma_gaussian_tensordot(result.expand(result.batch_shape))
        result = gamma_gaussian_tensordot(self._init, result, dims=self.hidden_dim)
        return result.event_logsumexp().logsumexp()

    def filter(self, value):
        """The posterior over the mixing variable and the final hidden state:
        a ``Gamma`` and the ``MultivariateNormal`` at unit scale."""
        from .continuous import Gamma

        logp = self._conditioned(value)
        logp = sequential_gamma_gaussian_tensordot(logp.expand(logp.batch_shape))
        logp = gamma_gaussian_tensordot(self._init, logp, dims=self.hidden_dim)
        gamma = logp.event_logsumexp()
        mvn = Gaussian(logp.info_vec.new_zeros(logp.batch_shape), logp.info_vec, logp.precision).to_mvn()
        return Gamma(gamma.concentration, gamma.rate), mvn


class IndependentHMM(Distribution):
    """Independent copies of a base HMM of obs_dim 1 over its rightmost
    batch dim, which becomes the event's channel dim: ``event_shape = (T,
    channels)``."""

    arg_constraints = {}
    support = constraints.independent(constraints.real, 2)

    def __init__(self, base_dist):
        if base_dist.event_shape[-1] != 1:
            raise ValueError("IndependentHMM requires a base with obs_dim=1")
        self.base_dist = base_dist
        self.duration = base_dist.duration
        channels = base_dist.batch_shape[-1] if base_dist.batch_shape else 1
        super().__init__(base_dist.batch_shape[:-1], (base_dist.event_shape[0], channels))

    @property
    def has_rsample(self):  # type: ignore[override]
        return self.base_dist.has_rsample

    def log_prob(self, value):
        return self.base_dist.log_prob(value.movedim(-1, -2).unsqueeze(-1)).sum(-1)

    def rsample(self, generator=None, sample_shape=()):
        return self.base_dist.rsample(generator, sample_shape).squeeze(-1).movedim(-2, -1)

    def expand(self, batch_shape, _instance=None):
        return IndependentHMM(self.base_dist.expand(tuple(batch_shape) + self.event_shape[-1:]))


class GaussianMRF(Distribution):
    """A temporal Gaussian Markov random field: ``initial_dist`` over the
    first hidden state, ``transition_dist`` over (z, z') and
    ``observation_dist`` over (z', y), each a MultivariateNormal (or
    Independent Normal) factor; ``log_prob`` is log p(obs, hidden) less log
    p(hidden), each integrated over the hidden states by K4b."""

    arg_constraints = {}
    support = constraints.independent(constraints.real, 2)

    def __init__(self, initial_dist, transition_dist, observation_dist, duration=None):
        assert initial_dist.event_dim == transition_dist.event_dim == observation_dist.event_dim == 1
        hidden_dim = initial_dist.event_shape[0]
        obs_dim = observation_dist.event_shape[0] - hidden_dim
        assert transition_dist.event_shape[0] == 2 * hidden_dim and obs_dim > 0
        shape = broadcast_shape(initial_dist.batch_shape + (1,), transition_dist.batch_shape,
                                observation_dist.batch_shape)
        batch_shape, time_shape = shape[:-1], shape[-1:]
        self.duration, event_shape = _with_duration(duration, tuple(time_shape) + (obs_dim,))
        super().__init__(batch_shape, event_shape)
        self.hidden_dim = hidden_dim
        self.obs_dim = obs_dim
        self._init = mvn_to_gaussian(initial_dist)
        self._trans = mvn_to_gaussian(transition_dist)
        self._obs = mvn_to_gaussian(observation_dist)

    def log_prob(self, value):
        logp_oh = self._trans + self._obs.condition(value).event_pad(left=self.hidden_dim)
        logp_h = self._trans + self._obs.marginalize(right=self.obs_dim).event_pad(left=self.hidden_dim)
        # p(hidden) over as many steps as p(obs, hidden); the JAX package
        # contracts it over its factors' own time axis, one step where they
        # are homogeneous (ROADMAP.md Queue 3)
        logp_h = logp_h.expand(broadcast_shape(logp_h.batch_shape, logp_oh.batch_shape[-1:]))
        logp_oh = sequential_gaussian_tensordot(logp_oh.expand(logp_oh.batch_shape))
        logp_h = sequential_gaussian_tensordot(logp_h)
        logp_oh = gaussian_tensordot(self._init, logp_oh, dims=self.hidden_dim)
        logp_h = gaussian_tensordot(self._init, logp_h, dims=self.hidden_dim)
        return logp_oh.event_logsumexp() - logp_h.event_logsumexp()
