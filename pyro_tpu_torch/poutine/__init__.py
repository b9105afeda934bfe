from .enum_messenger import EnumMessenger
from .handlers import (
    EscapeMessenger,
    UnconditionMessenger,
    block,
    condition,
    infer_config,
    mask,
    replay,
    scale,
    seed,
    trace,
    uncondition,
)
from .messenger import Messenger
from .reparam_messenger import ReparamMessenger, reparam
from .runtime import NonlocalExit, am_i_wrapped, apply_stack
from .trace_struct import Trace

__all__ = [
    "EnumMessenger",
    "EscapeMessenger",
    "Messenger",
    "NonlocalExit",
    "ReparamMessenger",
    "Trace",
    "UnconditionMessenger",
    "am_i_wrapped",
    "apply_stack",
    "block",
    "condition",
    "infer_config",
    "mask",
    "reparam",
    "replay",
    "scale",
    "seed",
    "trace",
    "uncondition",
]
