from .guides import (
    AutoCallable,
    AutoContinuous,
    AutoDelta,
    AutoDiagonalNormal,
    AutoGuide,
    AutoGuideList,
    AutoIAFNormal,
    AutoLowRankMultivariateNormal,
    AutoMultivariateNormal,
    AutoNormal,
    AutoNormalizingFlow,
)
from .initialization import init_to_feasible, init_to_median, init_to_uniform, init_to_value

__all__ = [
    "AutoCallable",
    "AutoContinuous",
    "AutoDelta",
    "AutoDiagonalNormal",
    "AutoGuide",
    "AutoGuideList",
    "AutoIAFNormal",
    "AutoLowRankMultivariateNormal",
    "AutoMultivariateNormal",
    "AutoNormal",
    "AutoNormalizingFlow",
    "init_to_feasible",
    "init_to_median",
    "init_to_uniform",
    "init_to_value",
]
