from .elbo import ELBO, Trace_ELBO
from .svi import SVI

__all__ = ["ELBO", "SVI", "Trace_ELBO"]
