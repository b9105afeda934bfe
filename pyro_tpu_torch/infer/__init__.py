from .discrete import infer_discrete
from .elbo import ELBO, Trace_ELBO
from .enum import config_enumerate
from .mcmc import HMC, MCMC, NUTS
from .svi import SVI
from .traceenum_elbo import TraceEnum_ELBO

__all__ = [
    "ELBO",
    "HMC",
    "MCMC",
    "NUTS",
    "SVI",
    "TraceEnum_ELBO",
    "Trace_ELBO",
    "config_enumerate",
    "infer_discrete",
]
