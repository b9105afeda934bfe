"""The BART ridership data set (counterpart of
``pyro_tpu/contrib/examples/bart.py``): the real counts need a download,
so ``load_bart_od`` raises; ``load_fake_od`` makes the JAX package's
synthetic counts from the same numpy draws."""

from __future__ import annotations

import numpy as np
import torch

from ...settings import get_default_device


def load_bart_od():
    raise RuntimeError(
        "load_bart_od requires downloading BART origin-destination data, which needs network access. "
        "Provide the cached .pkl.bz2 under $DATA_DIR manually."
    )


def load_fake_od():
    """Synthetic origin-destination counts of the real set's schema: 744
    hours of 2 x 2 Poisson(10) counts from numpy's RandomState(0)."""
    counts = np.random.RandomState(0).poisson(10.0, size=(744, 2, 2)).astype(np.float32)
    return {"stations": ["12TH", "16TH"], "start_date": "2011-01-01",
            "counts": torch.tensor(counts, device=get_default_device())}
