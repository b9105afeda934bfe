from .discrete import infer_discrete
from .elbo import ELBO, Trace_ELBO
from .enum import config_enumerate
from .mcmc import HMC, MCMC, NUTS
from .predictive import MHResampler, Predictive, WeighedPredictive, WeighedPredictiveResults
from .svi import SVI
from .traceenum_elbo import TraceEnum_ELBO

__all__ = [
    "ELBO",
    "HMC",
    "MCMC",
    "MHResampler",
    "NUTS",
    "Predictive",
    "SVI",
    "TraceEnum_ELBO",
    "Trace_ELBO",
    "WeighedPredictive",
    "WeighedPredictiveResults",
    "config_enumerate",
    "infer_discrete",
]
