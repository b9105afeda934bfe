from .api import MCMC
from .hmc import HMC
from .mass import ArrowheadMassMatrix, BlockMassMatrix
from .mcmc_kernel import MCMCKernel
from .nuts import NUTS
from .rwkernel import RandomWalkKernel
from .streaming import StreamingMCMC
from .util import initialize_model

__all__ = [
    "ArrowheadMassMatrix",
    "BlockMassMatrix",
    "HMC",
    "MCMC",
    "MCMCKernel",
    "NUTS",
    "RandomWalkKernel",
    "StreamingMCMC",
    "initialize_model",
]
