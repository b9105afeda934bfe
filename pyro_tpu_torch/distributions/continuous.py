"""Univariate continuous distributions (counterpart of
``pyro_tpu/distributions/continuous.py``).  Draws take a ``torch.Generator``;
the families built on a base and transforms (LogNormal, InverseGamma,
Pareto, Kumaraswamy) are ``TransformedDistribution``s, as in the JAX
package."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.special import log_beta, log_i0, log_i1
from ..settings import get_default_device
from . import constraints
from .distribution import Distribution, TransformedDistribution
from .multivariate import _standard_gamma
from .transforms import AffineTransform, ExpTransform, PowerTransform
from .util import broadcast_shape, clamp_probs


def _param(value, like=None):
    """A float tensor parameter.  A Python number becomes a fill on the
    device of ``like`` (else the package's device): ``torch.full`` launches a
    kernel, where ``torch.as_tensor`` of a number would copy it from the
    host and wait for the device."""
    if isinstance(value, torch.Tensor):
        return value if value.is_floating_point() else value.to(torch.get_default_dtype())
    device = like.device if isinstance(like, torch.Tensor) else get_default_device()
    return torch.full((), float(value), dtype=torch.get_default_dtype(), device=device)


def _params(*values):
    """Parameters as tensors of one floating dtype on one device, broadcast
    to one shape: ``(shape, [tensors])``."""
    like = next((v for v in values if isinstance(v, torch.Tensor)), None)
    ts = [_param(v, like) for v in values]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    shape = broadcast_shape(*(t.shape for t in ts))
    return shape, [t.to(dtype).expand(shape) for t in ts]


def _uniform(shape, like, generator, low=0.0, high=1.0):
    u = torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)
    return u if (low, high) == (0.0, 1.0) else low + (high - low) * u


def _exponential(shape, like, generator):
    return torch.empty(shape, dtype=like.dtype, device=like.device).exponential_(generator=generator)


class _Univariate(Distribution):
    """``expand`` by broadcasting each parameter named in
    ``arg_constraints`` and rebuilding from them."""

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        if batch_shape == self.batch_shape:
            return self
        return type(self)(**{name: getattr(self, name).expand(batch_shape) for name in self.arg_constraints})


class Beta(Distribution):
    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive}
    support = constraints.unit_interval
    has_rsample = True

    def __init__(self, concentration1, concentration0):
        shape, (self.concentration1, self.concentration0) = _params(concentration1, concentration0)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        g1 = _standard_gamma(self.concentration1.expand(shape), generator)
        g0 = _standard_gamma(self.concentration0.expand(shape), generator)
        return clamp_probs(g1 / (g1 + g0))

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return (
            (a - 1) * torch.log(value)
            + (b - 1) * torch.log1p(-value)
            - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))
        )

    @property
    def mean(self):
        return self.concentration1 / (self.concentration1 + self.concentration0)

    @property
    def variance(self):
        total = self.concentration1 + self.concentration0
        return self.concentration1 * self.concentration0 / (total**2 * (total + 1))

    def entropy(self):
        a, b = self.concentration1, self.concentration0
        total = a + b
        return (
            torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(total)
            - (a - 1) * torch.digamma(a) - (b - 1) * torch.digamma(b) + (total - 2) * torch.digamma(total)
        )

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Beta(self.concentration1.expand(batch_shape), self.concentration0.expand(batch_shape))


class Normal(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        like = loc if isinstance(loc, torch.Tensor) else scale
        loc, scale = _param(loc, like), _param(scale, like)
        shape = broadcast_shape(loc.shape, scale.shape)
        self.loc, self.scale = loc.expand(shape), scale.expand(shape)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        var = self.scale**2
        log_scale = torch.log(self.scale)
        return -((value - self.loc) ** 2) / (2 * var) - log_scale - 0.5 * math.log(2 * math.pi)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale**2

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def cdf(self, value):
        # erfc keeps the lower tail's relative accuracy, which float32
        # ``torch.special.ndtr`` loses (all of it by -6 standard deviations)
        return 0.5 * torch.special.erfc((self.loc - value) / (self.scale * math.sqrt(2.0)))

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Normal(self.loc.expand(batch_shape), self.scale.expand(batch_shape))


class HalfCauchy(Distribution):
    arg_constraints = {"scale": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, scale=1.0):
        self.scale = _param(scale)
        super().__init__(self.scale.shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        u = torch.rand(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        return self.scale * torch.tan(math.pi * u / 2)

    def log_prob(self, value):
        return math.log(2 / math.pi) - torch.log(self.scale) - torch.log1p((value / self.scale) ** 2)

    @property
    def mean(self):
        return torch.full_like(self.scale, torch.inf)

    @property
    def variance(self):
        return torch.full_like(self.scale, torch.inf)

    def cdf(self, value):
        return 2 / math.pi * torch.atan(value / self.scale)

    def icdf(self, q):
        return self.scale * torch.tan(math.pi * q / 2)

    def expand(self, batch_shape, _instance=None):
        return HalfCauchy(self.scale.expand(tuple(batch_shape)))


class Gamma(Distribution):
    """Gamma(concentration, rate); draws take a ``torch.Generator``."""

    arg_constraints = {"concentration": constraints.positive, "rate": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, concentration, rate=1.0):
        like = concentration if isinstance(concentration, torch.Tensor) else rate
        concentration, rate = _param(concentration, like), _param(rate, like)
        shape = broadcast_shape(concentration.shape, rate.shape)
        self.concentration, self.rate = concentration.expand(shape), rate.expand(shape)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        return _standard_gamma(self.concentration.expand(self.shape(sample_shape)), generator) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * torch.log(b) + (a - 1) * torch.log(value) - b * value - torch.lgamma(a)

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.concentration / self.rate**2

    def entropy(self):
        a = self.concentration
        return a - torch.log(self.rate) + torch.lgamma(a) + (1 - a) * torch.digamma(a)

    def cdf(self, value):
        return torch.special.gammainc(self.concentration, self.rate * value)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Gamma(self.concentration.expand(batch_shape), self.rate.expand(batch_shape))


class Uniform(Distribution):
    has_rsample = True

    def __init__(self, low=0.0, high=1.0):
        shape, (self.low, self.high) = _params(low, high)
        super().__init__(shape)

    @property
    def support(self):
        return constraints.interval(self.low, self.high)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, -torch.log(self.high - self.low), -torch.inf)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Uniform(self.low.expand(batch_shape), self.high.expand(batch_shape))

    @property
    def mean(self):
        return (self.low + self.high) / 2

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12

    def entropy(self):
        return torch.log(self.high - self.low)

    def cdf(self, value):
        return ((value - self.low) / (self.high - self.low)).clamp(0.0, 1.0)

    def icdf(self, q):
        return self.low + (self.high - self.low) * q


class Exponential(_Univariate):
    arg_constraints = {"rate": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, rate=1.0):
        shape, (self.rate,) = _params(rate)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        return _exponential(self.shape(sample_shape), self.rate, generator) / self.rate

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * value

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / self.rate**2

    def entropy(self):
        return 1.0 - torch.log(self.rate)

    def cdf(self, value):
        return -torch.expm1(-self.rate * value)

    def icdf(self, q):
        return -torch.log1p(-q) / self.rate


class Chi2(Gamma):
    arg_constraints = {"df": constraints.positive}

    def __init__(self, df):
        self.df = _param(df)
        super().__init__(0.5 * self.df, 0.5)

    def expand(self, batch_shape, _instance=None):
        return Chi2(self.df.expand(tuple(batch_shape)))


class InverseGamma(TransformedDistribution):
    """1 / Gamma(concentration, rate)."""

    arg_constraints = {"concentration": constraints.positive, "rate": constraints.positive}
    support = constraints.positive

    def __init__(self, concentration, rate=1.0):
        base = Gamma(concentration, rate)
        self.concentration, self.rate = base.concentration, base.rate
        super().__init__(base, PowerTransform(-1.0))

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return InverseGamma(self.concentration.expand(batch_shape), self.rate.expand(batch_shape))

    @property
    def mean(self):
        a = self.concentration
        return torch.where(a > 1, self.rate / (a - 1), torch.inf)

    @property
    def variance(self):
        a = self.concentration
        return torch.where(a > 2, self.rate**2 / ((a - 1) ** 2 * (a - 2)), torch.inf)


class LogNormal(TransformedDistribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.positive

    def __init__(self, loc=0.0, scale=1.0):
        base = Normal(loc, scale)
        self.loc, self.scale = base.loc, base.scale
        super().__init__(base, ExpTransform())

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return LogNormal(self.loc.expand(batch_shape), self.scale.expand(batch_shape))

    @property
    def mean(self):
        return torch.exp(self.loc + self.scale**2 / 2)

    @property
    def variance(self):
        return torch.expm1(self.scale**2) * torch.exp(2 * self.loc + self.scale**2)

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale) + self.loc


class Cauchy(_Univariate):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        shape, (self.loc, self.scale) = _params(loc, scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        u = _uniform(self.shape(sample_shape), self.loc, generator)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -math.log(math.pi) - torch.log(self.scale) - torch.log1p(z**2)

    @property
    def mean(self):
        return torch.full_like(self.loc, torch.nan)

    @property
    def variance(self):
        return torch.full_like(self.loc, torch.inf)

    def entropy(self):
        return math.log(4 * math.pi) + torch.log(self.scale)

    def cdf(self, value):
        return torch.atan((value - self.loc) / self.scale) / math.pi + 0.5

    def icdf(self, q):
        return self.loc + self.scale * torch.tan(math.pi * (q - 0.5))


class HalfNormal(_Univariate):
    arg_constraints = {"scale": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, scale=1.0):
        shape, (self.scale,) = _params(scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        eps = torch.randn(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        return eps.abs() * self.scale

    def log_prob(self, value):
        return -(value**2) / (2 * self.scale**2) - torch.log(self.scale) - 0.5 * math.log(2 * math.pi) + math.log(2.0)

    @property
    def mean(self):
        return self.scale * math.sqrt(2 / math.pi)

    @property
    def variance(self):
        return self.scale**2 * (1 - 2 / math.pi)

    def cdf(self, value):
        return 2 * torch.special.ndtr(value / self.scale) - 1

    def icdf(self, q):
        return self.scale * torch.special.ndtri((q + 1) / 2)


class StudentT(_Univariate):
    arg_constraints = {"df": constraints.positive, "loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, df, loc=0.0, scale=1.0):
        shape, (self.df, self.loc, self.scale) = _params(df, loc, scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        z = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        g = _standard_gamma(self.df.expand(shape) / 2, generator) * 2 / self.df
        return self.loc + self.scale * z * torch.rsqrt(g)

    def log_prob(self, value):
        df = self.df
        y = (value - self.loc) / self.scale
        z = (
            0.5 * torch.log(df) + 0.5 * math.log(math.pi) + torch.lgamma(0.5 * df) - torch.lgamma(0.5 * (df + 1))
            + torch.log(self.scale)
        )
        return -0.5 * (df + 1) * torch.log1p(y**2 / df) - z

    @property
    def mean(self):
        return torch.where(self.df > 1, self.loc, torch.nan)

    @property
    def variance(self):
        v = self.scale**2 * self.df / (self.df - 2)
        return torch.where(self.df > 2, v, torch.where(self.df > 1, torch.inf, torch.nan))


class Laplace(_Univariate):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        shape, (self.loc, self.scale) = _params(loc, scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        u = _uniform(self.shape(sample_shape), self.loc, generator, -0.5 + 1e-7, 0.5)
        return self.loc - self.scale * torch.sign(u) * torch.log1p(-2 * u.abs())

    def log_prob(self, value):
        return -(value - self.loc).abs() / self.scale - torch.log(2 * self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return 2 * self.scale**2

    def entropy(self):
        return 1 + torch.log(2 * self.scale)

    def cdf(self, value):
        z = (value - self.loc) / self.scale
        return 0.5 - 0.5 * torch.sign(z) * torch.expm1(-z.abs())

    def icdf(self, q):
        term = q - 0.5
        return self.loc - self.scale * torch.sign(term) * torch.log1p(-2 * term.abs())


class Gumbel(_Univariate):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        shape, (self.loc, self.scale) = _params(loc, scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        u = _uniform(self.shape(sample_shape), self.loc, generator).clamp(min=torch.finfo(self.loc.dtype).tiny)
        return self.loc - self.scale * torch.log(-torch.log(u))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    @property
    def mean(self):
        return self.loc + self.scale * 0.5772156649015329  # Euler's constant

    @property
    def variance(self):
        return math.pi**2 / 6 * self.scale**2

    def cdf(self, value):
        return torch.exp(-torch.exp(-(value - self.loc) / self.scale))

    def icdf(self, q):
        return self.loc - self.scale * torch.log(-torch.log(q))


class Logistic(_Univariate):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc=0.0, scale=1.0):
        shape, (self.loc, self.scale) = _params(loc, scale)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        finfo = torch.finfo(self.loc.dtype)
        u = _uniform(self.shape(sample_shape), self.loc, generator).clamp(finfo.tiny, 1 - finfo.eps)
        return self.loc + self.scale * (torch.log(u) - torch.log1p(-u))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -z - 2 * F.softplus(-z) - torch.log(self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return (self.scale * math.pi) ** 2 / 3

    def cdf(self, value):
        return torch.sigmoid((value - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * (torch.log(q) - torch.log1p(-q))


class Weibull(_Univariate):
    arg_constraints = {"scale": constraints.positive, "concentration": constraints.positive}
    support = constraints.positive
    has_rsample = True

    def __init__(self, scale, concentration):
        shape, (self.scale, self.concentration) = _params(scale, concentration)
        super().__init__(shape)

    def rsample(self, generator=None, sample_shape=()):
        e = _exponential(self.shape(sample_shape), self.scale, generator)
        return self.scale * e ** (1.0 / self.concentration)

    def log_prob(self, value):
        k = self.concentration
        return torch.log(k / self.scale) + (k - 1) * (torch.log(value) - torch.log(self.scale)) - (value / self.scale) ** k

    @property
    def mean(self):
        return self.scale * torch.exp(torch.lgamma(1 + 1 / self.concentration))

    @property
    def variance(self):
        g1 = torch.exp(torch.lgamma(1 + 1 / self.concentration))
        g2 = torch.exp(torch.lgamma(1 + 2 / self.concentration))
        return self.scale**2 * (g2 - g1**2)


class Pareto(TransformedDistribution):
    """scale * exp(Exponential(alpha))."""

    arg_constraints = {"scale": constraints.positive, "alpha": constraints.positive}

    def __init__(self, scale, alpha):
        _, (self.scale, self.alpha) = _params(scale, alpha)
        super().__init__(Exponential(self.alpha), [ExpTransform(), AffineTransform(0.0, self.scale)])

    @property
    def support(self):  # type: ignore[override]
        return constraints.greater_than(self.scale)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Pareto(self.scale.expand(batch_shape), self.alpha.expand(batch_shape))

    @property
    def mean(self):
        return torch.where(self.alpha > 1, self.alpha * self.scale / (self.alpha - 1), torch.inf)

    @property
    def variance(self):
        v = self.scale**2 * self.alpha / ((self.alpha - 1) ** 2 * (self.alpha - 2))
        return torch.where(self.alpha > 2, v, torch.inf)


def von_mises_centered(concentration, generator=None):
    """Draws of a von Mises centred at 0, one per entry of ``concentration``:
    Best and Fisher's (1979) rejection sampler, rounds of proposals until
    every entry has accepted one (the JAX package's form)."""
    s_cutoff = 1.2e-9 if concentration.dtype == torch.float64 else 1.8e-4
    r = 1.0 + torch.sqrt(1.0 + 4.0 * concentration**2)
    rho = (r - torch.sqrt(2.0 * r)) / (2.0 * concentration)
    s = torch.where(concentration > s_cutoff, (1.0 + rho**2) / (2.0 * rho), 1.0 / concentration.clamp(min=1e-10))
    done = torch.zeros(concentration.shape, dtype=torch.bool, device=concentration.device)
    u, w = torch.zeros_like(concentration), torch.zeros_like(concentration)
    while not bool(done.all()):
        u1, u2, u3 = (_uniform(concentration.shape, concentration, generator) for _ in range(3))
        z = torch.cos(math.pi * u1)
        w_prop = (1.0 + s * z) / (s + z)
        y = concentration * (s - w_prop)
        accept = ((y * (2.0 - y) >= u2) | (torch.log(y / u2) + 1.0 >= y)) & ~done
        w = torch.where(accept, w_prop, w)
        u = torch.where(accept, torch.where(u3 < 0.5, -1.0, 1.0), u)
        done = done | accept
    return u * torch.acos(w.clamp(-1.0, 1.0))


class VonMises(_Univariate):
    arg_constraints = {"loc": constraints.real, "concentration": constraints.positive}
    support = constraints.interval(-math.pi, math.pi)

    def __init__(self, loc, concentration):
        shape, (self.loc, self.concentration) = _params(loc, concentration)
        super().__init__(shape)

    def sample(self, generator=None, sample_shape=()):
        with torch.no_grad():
            centered = von_mises_centered(self.concentration.expand(self.shape(sample_shape)), generator)
            return (centered + self.loc + math.pi) % (2 * math.pi) - math.pi

    def log_prob(self, value):
        return self.concentration * torch.cos(value - self.loc) - math.log(2 * math.pi) - log_i0(self.concentration)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return 1 - torch.exp(log_i1(self.concentration) - log_i0(self.concentration))


class SoftLaplace(_Univariate):
    """A smooth Laplace: density 2 / (pi scale (e^z + e^-z)), z = (x - loc) / scale."""

    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc, scale):
        shape, (self.loc, self.scale) = _params(loc, scale)
        super().__init__(shape)

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return math.log(2 / math.pi) - torch.log(self.scale) - torch.logaddexp(z, -z)

    def rsample(self, generator=None, sample_shape=()):
        return self.icdf(_uniform(self.shape(sample_shape), self.loc, generator))

    def cdf(self, value):
        return torch.atan(torch.exp((value - self.loc) / self.scale)) * (2 / math.pi)

    def icdf(self, value):
        return torch.log(torch.tan(value * (math.pi / 2))) * self.scale + self.loc

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return (math.pi / 2 * self.scale) ** 2


class AsymmetricLaplace(_Univariate):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive, "asymmetry": constraints.positive}
    support = constraints.real
    has_rsample = True

    def __init__(self, loc, scale, asymmetry):
        shape, (self.loc, self.scale, self.asymmetry) = _params(loc, scale, asymmetry)
        super().__init__(shape)

    @property
    def left_scale(self):
        return self.scale * self.asymmetry

    @property
    def right_scale(self):
        return self.scale / self.asymmetry

    def log_prob(self, value):
        z = value - self.loc
        z = -z.abs() / torch.where(z < 0, self.left_scale, self.right_scale)
        return z - torch.log(self.left_scale + self.right_scale)

    def rsample(self, generator=None, sample_shape=()):
        shape = self.shape(sample_shape)
        u = _exponential(shape, self.loc, generator)
        v = _exponential(shape, self.loc, generator)
        return self.loc - self.left_scale * u + self.right_scale * v

    @property
    def mean(self):
        return self.loc + self.right_scale - self.left_scale

    @property
    def variance(self):
        # the draws' variance, loc - left E1 + right E2 (the JAX package adds
        # left * right)
        return self.left_scale**2 + self.right_scale**2


class Kumaraswamy(TransformedDistribution):
    """(1 - U^(1/concentration0))^(1/concentration1) for U uniform on (0, 1)."""

    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive}
    support = constraints.unit_interval

    def __init__(self, concentration1, concentration0):
        shape, (self.concentration1, self.concentration0) = _params(concentration1, concentration0)
        zeros = self.concentration1.new_zeros(shape)
        transforms = [PowerTransform(1.0 / self.concentration0), AffineTransform(1.0, -1.0),
                      PowerTransform(1.0 / self.concentration1)]
        super().__init__(Uniform(zeros, zeros + 1), transforms)

    def expand(self, batch_shape, _instance=None):
        batch_shape = tuple(batch_shape)
        return Kumaraswamy(self.concentration1.expand(batch_shape), self.concentration0.expand(batch_shape))

    def _moment(self, k):
        a, b = self.concentration1, self.concentration0
        return b * torch.exp(log_beta(1 + k / a, b))

    @property
    def mean(self):
        return self._moment(1)

    @property
    def variance(self):
        return self._moment(2) - self._moment(1) ** 2
