"""Extended-support distributions (counterpart of
``pyro_tpu/distributions/extended.py``): like their bases, but the log
density is -inf outside the support instead of a value of the formula, as
the epidemiology models need when they enumerate flows that may be
negative or exceed their source."""

from __future__ import annotations

import torch

from . import constraints
from .conjugate import BetaBinomial
from .discrete import Binomial


def _outside_is_neg_inf(base_log_prob, value, total_count):
    """``base_log_prob`` at ``value`` where it is an integer in [0,
    total_count], else -inf.  The formula is evaluated at 0 outside, so its
    unused branch stays finite and passes no NaN into a gradient."""
    inside = (value >= 0) & (value <= total_count) & (value % 1 == 0)
    safe = torch.where(inside, value, 0.0)
    return torch.where(inside, base_log_prob(safe), -torch.inf)


class ExtendedBinomial(Binomial):
    support = constraints.integer_greater_than(-1 - 10**10)  # effectively the integers

    def log_prob(self, value):
        return _outside_is_neg_inf(super().log_prob, value, self.total_count)


class ExtendedBetaBinomial(BetaBinomial):
    support = constraints.integer_greater_than(-1 - 10**10)

    def log_prob(self, value):
        return _outside_is_neg_inf(super().log_prob, value, self.total_count)
