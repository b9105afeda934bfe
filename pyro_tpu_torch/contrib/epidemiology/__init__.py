"""Epidemiological modeling (counterpart of
``pyro_tpu/contrib/epidemiology``): the distribution helpers, the
``CompartmentalModel`` base with relaxed SVI, relaxed and quantized NUTS
and prediction, and the example models.

The JAX package also re-exports ``bio_phylo_to_times`` from
``distributions/coalescent.py``, which is not ported yet (ROADMAP Queue 1
item 7); it is left out here.
"""

from .compartmental import CompartmentalModel
from .distributions import (
    beta_binomial_dist,
    binomial_dist,
    infection_dist,
    negative_binomial_dist,
    poisson_dist,
    set_approx_log_prob_tol,
    set_approx_sample_thresh,
    set_relaxed_distributions,
)
from .models import (
    HeterogeneousRegionalSIRModel,
    HeterogeneousSIRModel,
    OverdispersedSEIRModel,
    OverdispersedSIRModel,
    RegionalSIRModel,
    SimpleSEIRDModel,
    SimpleSEIRModel,
    SimpleSIRModel,
    SparseSIRModel,
    SuperspreadingSEIRModel,
    SuperspreadingSIRModel,
    UnknownStartSIRModel,
)

__all__ = [
    "CompartmentalModel",
    "HeterogeneousRegionalSIRModel",
    "HeterogeneousSIRModel",
    "OverdispersedSEIRModel",
    "OverdispersedSIRModel",
    "RegionalSIRModel",
    "SimpleSEIRDModel",
    "SimpleSEIRModel",
    "SimpleSIRModel",
    "SparseSIRModel",
    "SuperspreadingSEIRModel",
    "SuperspreadingSIRModel",
    "UnknownStartSIRModel",
    "beta_binomial_dist",
    "binomial_dist",
    "infection_dist",
    "negative_binomial_dist",
    "poisson_dist",
    "set_approx_log_prob_tol",
    "set_approx_sample_thresh",
    "set_relaxed_distributions",
]
