from .api import MCMC
from .hmc import HMC
from .mcmc_kernel import MCMCKernel
from .nuts import NUTS
from .util import initialize_model

__all__ = ["HMC", "MCMC", "MCMCKernel", "NUTS", "initialize_model"]
