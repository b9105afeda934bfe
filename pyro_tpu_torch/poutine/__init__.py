from .enum_messenger import EnumMessenger
from .handlers import block, condition, mask, replay, scale, seed, trace
from .messenger import Messenger
from .runtime import am_i_wrapped, apply_stack
from .trace_struct import Trace

__all__ = [
    "EnumMessenger",
    "Messenger",
    "Trace",
    "am_i_wrapped",
    "apply_stack",
    "block",
    "condition",
    "mask",
    "replay",
    "scale",
    "seed",
    "trace",
]
