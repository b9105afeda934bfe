"""Conditioner networks (counterpart of ``pyro_tpu/nn``).  The flax bridge
(``module.py``) has no counterpart: ``pyro_tpu_torch.module`` registers a
``torch.nn.Module``'s parameters in the param store."""

from .auto_reg_nn import AutoRegressiveNN, ConditionalAutoRegressiveNN
from .dense_nn import ConditionalDenseNN, DenseNN, MaskedLinear
from .recurrent import RNN, GRUCell

__all__ = [
    "RNN",
    "GRUCell",
    "MaskedLinear",
    "AutoRegressiveNN",
    "ConditionalAutoRegressiveNN",
    "ConditionalDenseNN",
    "DenseNN",
]
