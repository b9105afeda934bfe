from .elbo import ELBO, Trace_ELBO
from .svi import SVI
from .traceenum_elbo import TraceEnum_ELBO

__all__ = ["ELBO", "SVI", "TraceEnum_ELBO", "Trace_ELBO"]
