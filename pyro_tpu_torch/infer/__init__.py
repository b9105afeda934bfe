from .elbo import ELBO, Trace_ELBO
from .mcmc import HMC, MCMC, NUTS
from .svi import SVI
from .traceenum_elbo import TraceEnum_ELBO

__all__ = ["ELBO", "HMC", "MCMC", "NUTS", "SVI", "TraceEnum_ELBO", "Trace_ELBO"]
