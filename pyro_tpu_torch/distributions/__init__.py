from . import constraints
from .continuous import Beta, HalfCauchy, Normal
from .delta import Delta, Unit
from .discrete import Bernoulli, Categorical
from .distribution import Distribution, ExpandedDistribution, Independent, MaskedDistribution
from .hmm import DiscreteHMM, GaussianHMM
from .multivariate import Dirichlet, MultivariateNormal
from .transforms import StickBreakingTransform, biject_to, transform_to

__all__ = [
    "Bernoulli",
    "Beta",
    "Categorical",
    "Delta",
    "Dirichlet",
    "DiscreteHMM",
    "GaussianHMM",
    "Distribution",
    "ExpandedDistribution",
    "HalfCauchy",
    "Independent",
    "MaskedDistribution",
    "MultivariateNormal",
    "Normal",
    "StickBreakingTransform",
    "Unit",
    "biject_to",
    "constraints",
    "transform_to",
]
