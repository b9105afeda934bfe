from .optim import (
    SGD,
    Adadelta,
    Adagrad,
    AdagradRMSProp,
    Adam,
    Adamax,
    AdamW,
    ClippedAdam,
    NAdam,
    PyroOptim,
    RAdam,
    RMSprop,
)

__all__ = [
    "Adadelta",
    "Adagrad",
    "AdagradRMSProp",
    "Adam",
    "AdamW",
    "Adamax",
    "ClippedAdam",
    "NAdam",
    "PyroOptim",
    "RAdam",
    "RMSprop",
    "SGD",
]
