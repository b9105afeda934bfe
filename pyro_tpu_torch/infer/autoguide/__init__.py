from .guides import AutoDelta, AutoGuide
from .initialization import init_to_feasible, init_to_median

__all__ = ["AutoDelta", "AutoGuide", "init_to_feasible", "init_to_median"]
