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
from .initialization import init_to_feasible, init_to_median

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
]
