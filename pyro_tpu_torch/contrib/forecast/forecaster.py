"""Forecasting models and the engines that fit and forecast them (counterpart
of ``pyro_tpu/contrib/forecast/forecaster.py``).

Training observes the residual ``data - prediction`` under the model's
noise distribution; forecasting conditions that distribution on the
observed window (``prefix_condition``) and draws the future residual.  A
``GaussianHMM`` noise runs its ``log_prob``, ``filter`` and ``rsample``
through the K4 kernels on the card.
"""

from __future__ import annotations

from functools import singledispatch

import torch

from ... import distributions as dist
from ... import poutine
from ... import primitives as pyro
from ...distributions.distribution import Independent
from ...infer import SVI, Trace_ELBO
from ...infer.autoguide import AutoNormal
from ...optim import DCTAdam
from ...settings import get_default_device


@singledispatch
def _prefix_condition(d, data):
    """The distribution of the future given the first ``data.shape[-2]``
    steps of ``d``'s time axis: a type's own ``prefix_condition`` method
    (the HMMs filter exactly) unless a rule below is registered."""
    try:
        return d.prefix_condition(data)
    except AttributeError as e:
        raise NotImplementedError(f"prefix_condition() does not support {type(d).__name__}") from e


def _slice_future(param, t, batch_shape):
    """A time-indexed parameter broadcast to the (..., T, D) batch and cut
    to the future window; a Python int (a count) stays as it is."""
    if isinstance(param, int):
        return param
    return torch.as_tensor(param).expand(batch_shape)[..., t:, :]


# iid families: the future is independent of the prefix, so their
# time-indexed parameters are sliced (Stable and StableWithLogProb wait for
# the rest of extra.py)
_UNIVARIATE_DISTS = {
    dist.Bernoulli: ("probs",),
    dist.Beta: ("concentration1", "concentration0"),
    dist.Cauchy: ("loc", "scale"),
    dist.Exponential: ("rate",),
    dist.Gamma: ("concentration", "rate"),
    dist.GammaPoisson: ("concentration", "rate"),
    dist.Geometric: ("probs",),
    dist.InverseGamma: ("concentration", "rate"),
    dist.Laplace: ("loc", "scale"),
    dist.LogNormal: ("loc", "scale"),
    dist.NegativeBinomial: ("total_count", "probs"),
    dist.Normal: ("loc", "scale"),
    dist.Poisson: ("rate",),
    dist.StudentT: ("df", "loc", "scale"),
    dist.Uniform: ("low", "high"),
    dist.ZeroInflatedPoisson: ("rate", "gate"),
}


def _prefix_condition_univariate(d, data):
    t = data.shape[-2]
    return type(d)(**{name: _slice_future(getattr(d, name), t, d.batch_shape) for name in _UNIVARIATE_DISTS[type(d)]})


for _type in _UNIVARIATE_DISTS:
    _prefix_condition.register(_type)(_prefix_condition_univariate)


@_prefix_condition.register(dist.MultivariateNormal)
def _(d, data):
    # batch (..., T), event (D,): the time axis is the last batch dim
    t, n = data.shape[-2], d.event_shape[0]
    loc = d.loc.expand(d.batch_shape + (n,))[..., t:, :]
    scale_tril = d.scale_tril.expand(d.batch_shape + (n, n))[..., t:, :, :]
    return dist.MultivariateNormal(loc, scale_tril=scale_tril)


@_prefix_condition.register(dist.MaskedDistribution)
def _(d, data):
    base_dist = _prefix_condition(d.base_dist, data)
    mask = d._mask
    if isinstance(mask, torch.Tensor) and mask.ndim:
        mask = mask.expand(d.batch_shape)[tuple(slice(-size, None) for size in base_dist.batch_shape)]
    return base_dist.mask(mask)


@_prefix_condition.register(Independent)
def _(d, data):
    return _prefix_condition(d.base_dist, data).to_event(d.reinterpreted_batch_ndims)


@_prefix_condition.register(dist.FoldedDistribution)
def _(d, data):
    return dist.FoldedDistribution(_prefix_condition(d.base_dist, data))


@_prefix_condition.register(dist.TransformedDistribution)
def _(d, data):
    for t in reversed(d.transforms):
        data = t.inv(data)
    return dist.TransformedDistribution(_prefix_condition(d.base_dist, data), d.transforms)


@_prefix_condition.register(dist.IndependentHMM)
def _(d, data):
    # (..., t, D) -> one HMM of obs_dim 1 per output dim
    return dist.IndependentHMM(_prefix_condition(d.base_dist, data.transpose(-1, -2).unsqueeze(-1)))


def prefix_condition(d, data, prefix_len: int, duration_total: int):
    """The conditional distribution of the future given the observed prefix
    ``data[..., :prefix_len, :]``: exact filtering for the HMMs, parameter
    slices for iid families, recursion through the wrappers.
    ``duration_total`` is implied by ``d`` and kept for the JAX package's
    signature."""
    return _prefix_condition(d, data[..., :prefix_len, :])


class ForecastingModel:
    """Subclass and implement ``model(zero_data, covariates)``, which calls
    ``self.predict(noise_dist, prediction)`` exactly once."""

    def model(self, zero_data, covariates):
        raise NotImplementedError

    def predict(self, noise_dist, prediction) -> None:
        """In training (data as long as the covariates), observe the residual
        under ``noise_dist``; in forecasting, draw the future residual from
        ``noise_dist`` conditioned on the observed window."""
        assert self._data is not None
        t_obs, t_total = self._data.shape[-2], self._zero_data.shape[-2]
        if t_obs == t_total:
            pyro.sample("residual", noise_dist, obs=self._data - prediction)
            self._forecast_value = None
        else:
            cond = prefix_condition(noise_dist, self._data - prediction[..., :t_obs, :], t_obs, t_total)
            noise = pyro.sample("residual", cond)
            self._forecast_value = prediction[..., t_obs:, :] + noise

    def __call__(self, data, covariates):
        self._data = data
        t_total = covariates.shape[0] if covariates is not None and covariates.ndim else data.shape[-2]
        t_total = max(t_total, data.shape[-2])
        self._zero_data = data.new_zeros(data.shape[:-2] + (t_total,) + data.shape[-1:])
        self._forecast_value = None
        self.model(self._zero_data, covariates)
        return self._forecast_value


class Forecaster:
    """Fits a ``ForecastingModel`` by SVI (an ``AutoNormal`` guide unless
    one is given, ``DCTAdam`` at ``learning_rate`` unless ``optim`` is
    given, ``Trace_ELBO``; the guide's draws from ``generator``) and draws
    forecasts.  ``losses`` holds each step's loss."""

    def __init__(self, model: ForecastingModel, data, covariates, *, guide=None, learning_rate: float = 0.01,
                 num_steps: int = 1001, optim=None, generator=None, **kwargs):
        self.model = model
        if guide is None:
            guide = AutoNormal(lambda d, c: model(d, c), init_scale=0.1)
        self.guide = guide
        svi = SVI(lambda d, c: model(d, c), guide, optim or DCTAdam({"lr": learning_rate}), Trace_ELBO())
        # one read of the losses after the last step
        self.losses = svi.run_steps(num_steps, data, covariates, generator=generator).tolist()

    def __call__(self, data, covariates, num_samples: int, generator=None):
        """``num_samples`` forecasts over the window the covariates add
        beyond the data: (num_samples,) + batch + (t_future, obs_dim).  Each
        draws a latent from the guide and replays the model at it."""
        if generator is None:
            generator = torch.Generator(device=get_default_device()).manual_seed(13)
        outs = []
        with torch.no_grad():
            for _ in range(num_samples):
                with poutine.seed(rng_seed=generator):
                    guide_trace = poutine.trace(self.guide).get_trace(data, covariates)
                    outs.append(poutine.replay(self.model, trace=guide_trace)(data, covariates))
        return torch.stack(outs)


def _time_reparam(reparam):
    """The config of ``HMCForecaster``'s time reparametrisation: every
    latent site with a rightmost dim to transform."""

    def config(site):
        return reparam() if not site["is_observed"] and site["fn"].shape() else None

    return config


class HMCForecaster:
    """Fits a ``ForecastingModel`` by NUTS (``num_chains`` chains as one
    batch) and forecasts from posterior draws.  ``time_reparam`` "haar" or
    "dct" reparametrises each latent site along its rightmost dim, in
    fitting and in forecasting alike."""

    def __init__(self, model: ForecastingModel, data, covariates=None, *, num_warmup: int = 1000,
                 num_samples: int = 1000, num_chains: int = 1, time_reparam=None, dense_mass: bool = False,
                 max_tree_depth: int = 10, generator=None):
        from ...infer.mcmc import MCMC, NUTS
        from ...infer.reparam import DiscreteCosineReparam, HaarReparam

        if time_reparam == "haar":
            self._model_fn = poutine.reparam(model, config=_time_reparam(HaarReparam))
        elif time_reparam == "dct":
            self._model_fn = poutine.reparam(model, config=_time_reparam(DiscreteCosineReparam))
        elif time_reparam is None:
            self._model_fn = model
        else:
            raise ValueError(f"unknown time_reparam: {time_reparam!r}")
        self.model = model
        kernel = NUTS(self._model_fn, full_mass=dense_mass, max_tree_depth=max_tree_depth)
        mcmc = MCMC(kernel, warmup_steps=num_warmup, num_samples=num_samples, num_chains=num_chains)
        if generator is None:
            generator = torch.Generator(device=get_default_device()).manual_seed(0)
        mcmc.run(data, covariates, generator=generator)
        self._mcmc = mcmc
        self._samples = mcmc.get_samples()
        self._num_samples = num_samples * num_chains

    def __call__(self, data, covariates, num_samples: int, generator=None):
        """``num_samples`` forecasts, each from a posterior draw picked at
        random and the model (reparametrised as in fitting) conditioned on
        it."""
        if generator is None:
            generator = torch.Generator(device=get_default_device()).manual_seed(17)
        idx = torch.randint(0, self._num_samples, (num_samples,), generator=generator, device=generator.device)
        outs = []
        with torch.no_grad():
            for i in idx.tolist():
                sample_i = {name: value[i] for name, value in self._samples.items()}
                with poutine.seed(rng_seed=generator):
                    outs.append(poutine.condition(self._model_fn, data=sample_i)(data, covariates))
        return torch.stack(outs)
