"""Package-wide settings: the device that entry points place tensors on.

The default is ``"cuda"``: the port runs on the card unless the caller asks
for the CPU with ``set_default_device("cpu")``.  With no card and no such
request, ``get_default_device`` raises; it never falls back to the CPU.
"""

from __future__ import annotations

import torch

_DEFAULT_DEVICE = "cuda"


def set_default_device(device) -> None:
    """Set the device for tensors the package creates (``"cuda"`` or ``"cpu"``)."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = str(torch.device(device))


def get_default_device() -> torch.device:
    device = torch.device(_DEFAULT_DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyro_tpu_torch runs on a CUDA device by default and none is available; "
            "call pyro_tpu_torch.set_default_device('cpu') to run on the CPU"
        )
    return device
