"""Bijective transforms and the ``biject_to``/``transform_to`` registries
(the part of ``pyro_tpu/distributions/transforms.py`` this package uses).
The param store keeps unconstrained values and maps them through
``transform_to(constraint)`` on access; autoguides and
``TransformedDistribution`` push draws through them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints
from .util import broadcast_shape, clamp_probs, sum_rightmost


class Transform:
    domain: constraints.Constraint = constraints.real
    codomain: constraints.Constraint = constraints.real

    @property
    def inv(self) -> "Transform":
        return _InverseTransform(self)

    @property
    def event_dim(self) -> int:
        """The event dim that domain and codomain share."""
        if self.domain.event_dim == self.codomain.event_dim:
            return self.domain.event_dim
        raise ValueError("Please use either .domain.event_dim or .codomain.event_dim")

    def __call__(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    def with_cache(self, cache_size=1):
        """A view that remembers its last ``(x, y)``, so a value it produced
        is inverted by lookup (a flow scored at its own draw needs no
        inverse pass)."""
        return self if cache_size == 0 else _CachedTransform(self)

    def __repr__(self):
        return self.__class__.__name__ + "()"


class _CachedTransform(Transform):
    """``base`` with the last ``(x, y)`` pair remembered by identity: the
    inverse of the very ``y`` it returned is the ``x`` it was given."""

    def __init__(self, base: Transform):
        self._base = base
        self._cached_x_y = None

    @property
    def domain(self):  # type: ignore[override]
        return self._base.domain

    @property
    def codomain(self):  # type: ignore[override]
        return self._base.codomain

    def __call__(self, x):
        cached = self._cached_x_y
        if cached is not None and cached[0] is x:
            return cached[1]
        y = self._base(x)
        self._cached_x_y = (x, y)
        return y

    def _inverse(self, y):
        cached = self._cached_x_y
        if cached is not None and cached[1] is y:
            return cached[0]
        x = self._base._inverse(y)
        self._cached_x_y = (x, y)
        return x

    def log_abs_det_jacobian(self, x, y):
        return self._base.log_abs_det_jacobian(x, y)

    def forward_shape(self, shape):
        return self._base.forward_shape(shape)

    def inverse_shape(self, shape):
        return self._base.inverse_shape(shape)

    def __repr__(self):
        return f"Cached({self._base!r})"


class _InverseTransform(Transform):
    def __init__(self, transform: Transform):
        self._base = transform

    @property
    def domain(self):  # type: ignore[override]
        return self._base.codomain

    @property
    def codomain(self):  # type: ignore[override]
        return self._base.domain

    @property
    def inv(self):  # type: ignore[override]
        return self._base

    def __call__(self, x):
        return self._base._inverse(x)

    def _inverse(self, y):
        return self._base(y)

    def log_abs_det_jacobian(self, x, y):
        return -self._base.log_abs_det_jacobian(y, x)

    def forward_shape(self, shape):
        return self._base.inverse_shape(shape)

    def inverse_shape(self, shape):
        return self._base.forward_shape(shape)


class IndependentTransform(Transform):
    def __init__(self, base_transform: Transform, reinterpreted_batch_ndims: int):
        self.base_transform = base_transform
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def domain(self):  # type: ignore[override]
        return constraints.independent(self.base_transform.domain, self.reinterpreted_batch_ndims)

    @property
    def codomain(self):  # type: ignore[override]
        return constraints.independent(self.base_transform.codomain, self.reinterpreted_batch_ndims)

    def __call__(self, x):
        return self.base_transform(x)

    def _inverse(self, y):
        return self.base_transform._inverse(y)

    def log_abs_det_jacobian(self, x, y):
        return sum_rightmost(self.base_transform.log_abs_det_jacobian(x, y), self.reinterpreted_batch_ndims)

    def forward_shape(self, shape):
        return self.base_transform.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base_transform.inverse_shape(shape)


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def _inverse(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


identity_transform = IdentityTransform()


class ExpTransform(Transform):
    codomain = constraints.positive

    def __call__(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y):
        return x


class AbsTransform(Transform):
    """|x|: not a bijection, so it has no Jacobian; ``FoldedDistribution``
    scores its values itself."""

    codomain = constraints.positive

    def __call__(self, x):
        return x.abs()

    def _inverse(self, y):
        return y


class AffineTransform(Transform):
    """``loc + scale * x``; with ``event_dim`` its Jacobian is summed over
    that many rightmost dims."""

    def __init__(self, loc, scale, event_dim: int = 0):
        self.loc, self.scale, self._event_dim = loc, scale, event_dim

    @property
    def domain(self):  # type: ignore[override]
        return constraints.independent(constraints.real, self._event_dim) if self._event_dim else constraints.real

    codomain = domain

    def __call__(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y):
        if isinstance(self.scale, (int, float)):
            result = torch.full(x.shape, math.log(abs(self.scale)), dtype=x.dtype, device=x.device)
        else:
            result = torch.log(self.scale.abs()).expand(x.shape)
        return sum_rightmost(result, self._event_dim)

    def forward_shape(self, shape):
        return broadcast_shape(shape, *(getattr(p, "shape", ()) for p in (self.loc, self.scale)))

    inverse_shape = forward_shape


class PowerTransform(Transform):
    """``x ** exponent`` on the positive reals."""

    domain = constraints.positive
    codomain = constraints.positive

    def __init__(self, exponent):
        self.exponent = exponent

    def __call__(self, x):
        return x.pow(self.exponent)

    def _inverse(self, y):
        return y.pow(1.0 / self.exponent)

    def log_abs_det_jacobian(self, x, y):
        return torch.log((self.exponent * y / x).abs()).expand(x.shape)


class _BoundTransform(Transform):
    """The reals -> (bound, inf) by ``bound + exp(x)`` (``sign`` +1) or ->
    (-inf, bound) by ``bound - exp(x)`` (``sign`` -1): the JAX package's
    composition of the exp and an affine map with scale +-1."""

    def __init__(self, bound, sign):
        self.bound, self.sign = bound, sign
        self.codomain = constraints.greater_than(bound) if sign > 0 else constraints.less_than(bound)

    def __call__(self, x):
        return self.bound + self.sign * torch.exp(x)

    def _inverse(self, y):
        return torch.log(self.sign * (y - self.bound))

    def log_abs_det_jacobian(self, x, y):
        return x


class SoftplusTransform(Transform):
    codomain = constraints.softplus_positive

    def __call__(self, x):
        return F.softplus(x)

    def _inverse(self, y):
        return y + torch.log(-torch.expm1(-y))  # log(exp(y) - 1)

    def log_abs_det_jacobian(self, x, y):
        return -F.softplus(-x)


class LowerCholeskyTransform(Transform):
    """Unconstrained matrices to lower Cholesky factors: the strict lower
    triangle kept, the diagonal through exp."""

    domain = constraints.independent(constraints.real, 2)
    codomain = constraints.lower_cholesky

    def _diag(self, d):
        return torch.exp(d)

    def _diag_inverse(self, d):
        return torch.log(d)

    def __call__(self, x):
        return x.tril(-1) + torch.diag_embed(self._diag(x.diagonal(dim1=-2, dim2=-1)))

    def _inverse(self, y):
        return y.tril(-1) + torch.diag_embed(self._diag_inverse(y.diagonal(dim1=-2, dim2=-1)))

    def log_abs_det_jacobian(self, x, y):
        return x.diagonal(dim1=-2, dim2=-1).sum(-1)


class SoftplusLowerCholeskyTransform(LowerCholeskyTransform):
    """As ``LowerCholeskyTransform``, the diagonal through softplus."""

    codomain = constraints.softplus_lower_cholesky

    def _diag(self, d):
        return F.softplus(d)

    def _diag_inverse(self, d):
        return d + torch.log(-torch.expm1(-d))

    def log_abs_det_jacobian(self, x, y):
        return -F.softplus(-x.diagonal(dim1=-2, dim2=-1)).sum(-1)


class SigmoidTransform(Transform):
    codomain = constraints.unit_interval

    def __call__(self, x):
        return clamp_probs(torch.sigmoid(x))

    def _inverse(self, y):
        y = clamp_probs(y)
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        return -F.softplus(-x) - F.softplus(x)


class IntervalTransform(Transform):
    """The reals -> (low, high): low + (high - low) sigmoid(x), the JAX
    package's composition of the sigmoid and an affine map."""

    def __init__(self, low, high):
        super().__init__()
        self.low, self.high = low, high
        self.codomain = constraints.interval(low, high)

    def __call__(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def _inverse(self, y):
        u = clamp_probs((y - self.low) / (self.high - self.low))
        return torch.log(u) - torch.log1p(-u)

    def log_abs_det_jacobian(self, x, y):
        return torch.log(torch.as_tensor(self.high - self.low)).expand(x.shape) - F.softplus(-x) - F.softplus(x)


def _offset(x):
    """K - k for k = 0 .. K-1 along the last dim of ``x`` (K = x.shape[-1])."""
    return x.shape[-1] + 1 - torch.cumsum(torch.ones_like(x), dim=-1)


class StickBreakingTransform(Transform):
    """Unconstrained R^{K-1} -> K-simplex."""

    domain = constraints.real_vector
    codomain = constraints.simplex

    def __call__(self, x):
        z = clamp_probs(torch.sigmoid(x - torch.log(_offset(x))))
        z_cumprod = torch.cumprod(1 - z, dim=-1)
        ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        z_padded = torch.cat([z, ones], dim=-1)
        z_cumprod_shifted = torch.cat([ones, z_cumprod], dim=-1)
        return z_padded * z_cumprod_shifted

    def _inverse(self, y):
        y_crop = y[..., :-1]
        offset = y_crop.shape[-1] - torch.cumsum(torch.ones_like(y_crop), dim=-1) + 1
        # remaining stick after each step
        sf = (1.0 - torch.cumsum(y_crop, dim=-1)).clamp(min=torch.finfo(y.dtype).tiny)
        return torch.log(y_crop) - torch.log(sf) + torch.log(offset)

    def log_abs_det_jacobian(self, x, y):
        z = clamp_probs(torch.sigmoid(x - torch.log(_offset(x))))
        return (torch.log1p(-z) + torch.log(clamp_probs(y[..., :-1]))).sum(-1)

    def forward_shape(self, shape):
        return shape[:-1] + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return shape[:-1] + (shape[-1] - 1,)


class SoftmaxTransform(Transform):
    domain = constraints.real_vector
    codomain = constraints.simplex

    def __call__(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(clamp_probs(y))


class ConstraintRegistry:
    """Maps constraint types to transform factories."""

    def __init__(self):
        self._registry = {}

    def register(self, constraint, factory=None):
        if factory is None:
            return lambda f: self.register(constraint, f)
        if isinstance(constraint, constraints.Constraint):
            constraint = type(constraint)
        self._registry[constraint] = factory
        return factory

    def __call__(self, constraint) -> Transform:
        try:
            factory = self._registry[type(constraint)]
        except KeyError:
            raise NotImplementedError(f"Cannot transform {type(constraint).__name__} constraints") from None
        return factory(constraint)


biject_to = ConstraintRegistry()
transform_to = ConstraintRegistry()


@biject_to.register(constraints.real)
@transform_to.register(constraints.real)
def _transform_to_real(constraint):
    return identity_transform


@biject_to.register(constraints.independent)
@transform_to.register(constraints.independent)
def _biject_to_independent(constraint):
    # both registries take the bijection of the base, as the JAX package does
    return IndependentTransform(biject_to(constraint.base_constraint), constraint.reinterpreted_batch_ndims)


@biject_to.register(constraints.positive)
@biject_to.register(constraints.nonnegative)
@transform_to.register(constraints.positive)
@transform_to.register(constraints.nonnegative)
def _transform_to_greater_than(constraint):
    # positive is greater_than(0): the exp, which the bound form equals there
    if isinstance(constraint.lower_bound, (int, float)) and constraint.lower_bound == 0:
        return ExpTransform()
    return _BoundTransform(constraint.lower_bound, 1)


@biject_to.register(constraints.less_than)
@transform_to.register(constraints.less_than)
def _transform_to_less_than(constraint):
    return _BoundTransform(constraint.upper_bound, -1)


@biject_to.register(constraints.softplus_positive)
@transform_to.register(constraints.softplus_positive)
def _transform_to_softplus_positive(constraint):
    return SoftplusTransform()


@biject_to.register(constraints.lower_cholesky)
@transform_to.register(constraints.lower_cholesky)
def _transform_to_lower_cholesky(constraint):
    return LowerCholeskyTransform()


@biject_to.register(constraints.softplus_lower_cholesky)
@transform_to.register(constraints.softplus_lower_cholesky)
def _transform_to_softplus_lower_cholesky(constraint):
    return SoftplusLowerCholeskyTransform()


@biject_to.register(constraints.interval)
@biject_to.register(constraints.open_interval)
@transform_to.register(constraints.interval)
@transform_to.register(constraints.open_interval)
def _transform_to_interval(constraint):
    low, high = constraint.lower_bound, constraint.upper_bound
    if isinstance(low, (int, float)) and isinstance(high, (int, float)) and (low, high) == (0, 1):
        return SigmoidTransform()
    return IntervalTransform(low, high)


@biject_to.register(constraints.simplex)
def _biject_to_simplex(constraint):
    return StickBreakingTransform()


@transform_to.register(constraints.simplex)
def _transform_to_simplex(constraint):
    return SoftmaxTransform()
