from .optim import Adam, PyroOptim

__all__ = ["Adam", "PyroOptim"]
