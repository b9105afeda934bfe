"""pyro_tpu_torch: the PyTorch and CUDA port of pyro_tpu.

Same primitives, handlers, distributions and inference as the JAX package,
slice by slice.  Tensors live on the CUDA device unless the caller asks for
the CPU with ``set_default_device("cpu")``; the hot ops (the discrete
HMM's log-matmul-exp, the Markov-chain scan, the Gaussian HMM's halving
levels) run as hand-written CUDA kernels there.
"""

from . import distributions, infer, optim, poutine
from .params.param_store import clear_param_store, get_param_store
from .primitives import deterministic, factor, markov, module, param, plate, sample, vectorized_markov
from .settings import get_default_device, set_default_device

__version__ = "0.1.0"

__all__ = [
    "clear_param_store",
    "deterministic",
    "distributions",
    "factor",
    "get_default_device",
    "get_param_store",
    "infer",
    "markov",
    "module",
    "optim",
    "param",
    "plate",
    "poutine",
    "sample",
    "set_default_device",
    "vectorized_markov",
]
