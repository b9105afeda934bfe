from . import constraints, flows, transforms
from .continuous import Beta, Gamma, HalfCauchy, Normal, Uniform
from .delta import Delta, Unit
from .discrete import Bernoulli, Categorical
from .distribution import Distribution, ExpandedDistribution, Independent, MaskedDistribution, TransformedDistribution
from .hmm import DiscreteHMM, GammaGaussianHMM, GaussianHMM, GaussianMRF, IndependentHMM
from .multivariate import Dirichlet, LowRankMultivariateNormal, MultivariateNormal
from .neural_markov import NormalMarkovChain
from .transforms import StickBreakingTransform, biject_to, transform_to

__all__ = [
    "Bernoulli",
    "Beta",
    "Categorical",
    "Delta",
    "Dirichlet",
    "DiscreteHMM",
    "Gamma",
    "GammaGaussianHMM",
    "GaussianHMM",
    "GaussianMRF",
    "Distribution",
    "ExpandedDistribution",
    "HalfCauchy",
    "Independent",
    "IndependentHMM",
    "LowRankMultivariateNormal",
    "MaskedDistribution",
    "MultivariateNormal",
    "Normal",
    "NormalMarkovChain",
    "StickBreakingTransform",
    "TransformedDistribution",
    "Uniform",
    "Unit",
    "biject_to",
    "constraints",
    "flows",
    "transform_to",
    "transforms",
]
