"""ScoreParts: the surrogate-gradient decomposition of a log-prob
(counterpart of ``pyro_tpu/distributions/score_parts.py``).

``log_prob`` is the density; ``score_function`` the REINFORCE term (nonzero
only for non-reparameterised sites); ``entropy_term`` the part
differentiated pathwise.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from .util import is_identically_zero, scale_and_mask


class ScoreParts(NamedTuple):
    log_prob: Any
    score_function: Any
    entropy_term: Any

    def scale_and_mask(self, scale=1.0, mask=None) -> "ScoreParts":
        """Scale and mask all three parts; the score function is masked but
        deliberately not scaled (the scale enters once, in the cost)."""
        log_prob = scale_and_mask(self.log_prob, scale, mask)
        score_function = self.score_function
        if mask is not None and not is_identically_zero(score_function):
            score_function = scale_and_mask(score_function, 1.0, mask)
        entropy_term = scale_and_mask(self.entropy_term, scale, mask)
        return ScoreParts(log_prob, score_function, entropy_term)

