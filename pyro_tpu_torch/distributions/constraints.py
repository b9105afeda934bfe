"""Constraints on distribution parameters and supports (the part of
``pyro_tpu/distributions/constraints.py`` this package uses; the matrix
constraints come with their first distribution).  A constraint
knows its ``event_dim`` and can ``check`` values; ``biject_to`` and
``transform_to`` in ``transforms.py`` map constraints to transforms."""

from __future__ import annotations


class Constraint:
    is_discrete = False
    event_dim = 0

    def check(self, value):
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.__class__.__name__[1:].replace("_", "") + "()"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self) -> int:
        return hash((type(self), tuple(sorted(self.__dict__.items()))))


class _Dependent(Constraint):
    def check(self, value):
        raise ValueError("cannot check a dependent constraint")


class _IndependentConstraint(Constraint):
    """Reinterpret batch dims of a base constraint as event dims."""

    def __init__(self, base_constraint: Constraint, reinterpreted_batch_ndims: int):
        self.base_constraint = base_constraint
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def is_discrete(self):  # type: ignore[override]
        return self.base_constraint.is_discrete

    @property
    def event_dim(self):  # type: ignore[override]
        return self.base_constraint.event_dim + self.reinterpreted_batch_ndims

    def check(self, value):
        result = self.base_constraint.check(value)
        if self.reinterpreted_batch_ndims:
            result = result.reshape(result.shape[: result.ndim - self.reinterpreted_batch_ndims] + (-1,)).all(-1)
        return result

    def __repr__(self) -> str:
        return f"independent({self.base_constraint}, {self.reinterpreted_batch_ndims})"


class _Boolean(Constraint):
    is_discrete = True

    def check(self, value):
        return (value == 0) | (value == 1)


class _Real(Constraint):
    def check(self, value):
        return value == value  # not NaN


class _GreaterThan(Constraint):
    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def check(self, value):
        return value > self.lower_bound


class _GreaterThanEq(Constraint):
    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def check(self, value):
        return value >= self.lower_bound


class _LessThan(Constraint):
    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def check(self, value):
        return value < self.upper_bound


class _Interval(Constraint):
    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def check(self, value):
        return (value >= self.lower_bound) & (value <= self.upper_bound)


class _OpenInterval(_Interval):
    def check(self, value):
        return (value > self.lower_bound) & (value < self.upper_bound)


class _IntegerInterval(Constraint):
    is_discrete = True

    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def check(self, value):
        return (value % 1 == 0) & (value >= self.lower_bound) & (value <= self.upper_bound)


class _IntegerGreaterThan(Constraint):
    is_discrete = True

    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def check(self, value):
        return (value % 1 == 0) & (value >= self.lower_bound)


class _Multinomial(Constraint):
    """Count vectors whose total is at most ``upper_bound``."""

    is_discrete = True
    event_dim = 1

    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def check(self, value):
        return (value >= 0).all(-1) & (value.sum(-1) <= self.upper_bound)


class _LowerCholesky(Constraint):
    """Lower-triangular matrices with a positive diagonal."""

    event_dim = 2

    def check(self, value):
        lower = (value.tril() == value).flatten(-2).all(-1)
        return lower & (value.diagonal(dim1=-2, dim2=-1) > 0).all(-1)


class _SoftplusPositive(_GreaterThan):
    """``positive``, reached from the reals by softplus rather than exp."""

    def __init__(self):
        super().__init__(0.0)


class _SoftplusLowerCholesky(_LowerCholesky):
    """``lower_cholesky``, with a softplus diagonal."""


class _Simplex(Constraint):
    event_dim = 1

    def check(self, value):
        return (value >= 0).all(-1) & ((value.sum(-1) - 1.0).abs() < 1e-6)


dependent = _Dependent()
boolean = _Boolean()
real = _Real()
real_vector = _IndependentConstraint(_Real(), 1)
positive = _GreaterThan(0.0)
nonnegative = _GreaterThanEq(0.0)
negative = _LessThan(0.0)
unit_interval = _Interval(0.0, 1.0)
interval = _Interval
open_interval = _OpenInterval
greater_than = _GreaterThan
greater_than_eq = _GreaterThanEq
less_than = _LessThan
integer_interval = _IntegerInterval
integer_greater_than = _IntegerGreaterThan
nonnegative_integer = _IntegerGreaterThan(0)
positive_integer = _IntegerGreaterThan(1)
multinomial = _Multinomial
simplex = _Simplex()
lower_cholesky = _LowerCholesky()
softplus_positive = _SoftplusPositive()
softplus_lower_cholesky = _SoftplusLowerCholesky()
independent = _IndependentConstraint

__all__ = [
    "Constraint",
    "boolean",
    "dependent",
    "greater_than",
    "greater_than_eq",
    "independent",
    "integer_greater_than",
    "integer_interval",
    "interval",
    "less_than",
    "lower_cholesky",
    "multinomial",
    "negative",
    "nonnegative",
    "nonnegative_integer",
    "open_interval",
    "positive",
    "positive_integer",
    "real",
    "real_vector",
    "simplex",
    "softplus_lower_cholesky",
    "softplus_positive",
    "unit_interval",
]
