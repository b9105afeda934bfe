"""The chain models of the JAX package's vectorized-Markov tests
(``tests/test_vectorized_markov.py``, after Pyro's
``tests/contrib/funsor/test_vectorized_markov.py``), each written once and
run either unrolled under ``pyro.markov`` or vectorized under
``pyro.vectorized_markov``; ``TraceEnum_ELBO`` must give the same loss both
ways.  Their chains take every route of ``ops/markov_product.py``:

* ``model_0``-``model_2``: one first-order chain with a homogeneous
  transition, the scan (K2);
* ``model_6``: a transition per step, the general body (K2g);
* ``model_3``, ``model_4``, ``model_7`` (two chain variables) and
  ``model_5`` (history 2): the pairwise fallback (K1 in rounds).

Params are ``pyro.param`` sites with no guide; their initial values are
drawn with numpy from fixed seeds (``probs``).  ``CASES`` lists the test's
ten (model, data shape, history) cases; ``make_data`` builds their data.
"""

from __future__ import annotations

import numpy as np
import torch

import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as dist
from pyro_tpu_torch.ops.indexing import Vindex


def probs(seed, *shape):
    """Normalised probabilities of the given shape, from numpy seed ``seed``."""
    p = np.random.default_rng(seed).uniform(size=shape) + 0.1
    p = p / p.sum(-1, keepdims=True)
    return lambda: torch.tensor(p, dtype=torch.get_default_dtype(), device=pyro.get_default_device())


def markov_loop(vectorized, size, history=1):
    if vectorized:
        return pyro.vectorized_markov(name="time", size=size, dim=-2, history=history)
    return pyro.markov(range(size), history=history)


def enum():
    # a fresh dict per site: the runtime keeps per-site bookkeeping in infer
    return {"enumerate": "parallel"}


def _locs():
    return lambda: torch.tensor([-1.0, 0.0, 1.0], device=pyro.get_default_device())


#     x[t-1] --> x[t] --> x[t+1]        (with an outer sequences plate)
def model_0(data, history, vectorized):
    x_dim = 3
    init = pyro.param("init", probs(0, x_dim))
    trans = pyro.param("trans", probs(1, x_dim, x_dim))
    locs = pyro.param("locs", _locs())
    tones = pyro.plate("tones", data.shape[2], dim=-1)
    with pyro.plate("sequences", data.shape[0], dim=-3) as sequences:
        sequences = sequences[:, None]
        x_prev = None
        for i in markov_loop(vectorized, data.shape[1], history):
            x_curr = pyro.sample(
                f"x_{i}", dist.Categorical(init if isinstance(i, int) and i < 1 else trans[x_prev]), infer=enum()
            )
            with tones:
                pyro.sample(f"y_{i}", dist.Normal(Vindex(locs)[..., x_curr], 1.0), obs=Vindex(data)[sequences, i])
            x_prev = x_curr


#     x[t-1] --> x[t] --> x[t+1]
def model_1(data, history, vectorized):
    x_dim = 3
    init = pyro.param("init", probs(0, x_dim))
    trans = pyro.param("trans", probs(1, x_dim, x_dim))
    locs = pyro.param("locs", _locs())
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    x_prev = None
    for i in markov_loop(vectorized, len(data), history):
        x_curr = pyro.sample(
            f"x_{i}", dist.Categorical(init if isinstance(i, int) and i < 1 else trans[x_prev]), infer=enum()
        )
        with tones:
            pyro.sample(f"y_{i}", dist.Normal(Vindex(locs)[..., x_curr], 1.0), obs=data[i])
        x_prev = x_curr


#     x[t-1] --> x[t];  y[t-1] --> y[t]  (y an observed Markov chain)
def model_2(data, history, vectorized):
    x_dim, y_dim = 3, 2
    x_init = pyro.param("x_init", probs(0, x_dim))
    x_trans = pyro.param("x_trans", probs(1, x_dim, x_dim))
    y_init = pyro.param("y_init", probs(2, x_dim, y_dim))
    y_trans = pyro.param("y_trans", probs(3, x_dim, y_dim, y_dim))
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    x_prev = y_prev = None
    for i in markov_loop(vectorized, len(data), history):
        x_curr = pyro.sample(
            f"x_{i}", dist.Categorical(x_init if isinstance(i, int) and i < 1 else x_trans[x_prev]), infer=enum()
        )
        with tones:
            y_curr = pyro.sample(
                f"y_{i}",
                dist.Categorical(
                    y_init[x_curr] if isinstance(i, int) and i < 1 else Vindex(y_trans)[x_curr, y_prev]
                ),
                obs=data[i],
            )
        x_prev, y_prev = x_curr, y_curr


#     two independent chains w and x, a joint emission y
def model_3(data, history, vectorized):
    w_dim, x_dim, y_dim = 2, 3, 2
    w_init = pyro.param("w_init", probs(0, w_dim))
    w_trans = pyro.param("w_trans", probs(1, w_dim, w_dim))
    x_init = pyro.param("x_init", probs(2, x_dim))
    x_trans = pyro.param("x_trans", probs(3, x_dim, x_dim))
    y_probs = pyro.param("y_probs", probs(4, w_dim, x_dim, y_dim))
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    w_prev = x_prev = None
    for i in markov_loop(vectorized, len(data), history):
        first = isinstance(i, int) and i < 1
        w_curr = pyro.sample(f"w_{i}", dist.Categorical(w_init if first else w_trans[w_prev]), infer=enum())
        x_curr = pyro.sample(f"x_{i}", dist.Categorical(x_init if first else x_trans[x_prev]), infer=enum())
        with tones:
            pyro.sample(f"y_{i}", dist.Categorical(Vindex(y_probs)[w_curr, x_curr]), obs=data[i])
        x_prev, w_prev = x_curr, w_curr


#     coupled chains: x[t] depends on w[t] and x[t-1]
def model_4(data, history, vectorized):
    w_dim, x_dim, y_dim = 2, 3, 2
    w_init = pyro.param("w_init", probs(0, w_dim))
    w_trans = pyro.param("w_trans", probs(1, w_dim, w_dim))
    x_init = pyro.param("x_init", probs(2, w_dim, x_dim))
    x_trans = pyro.param("x_trans", probs(3, w_dim, x_dim, x_dim))
    y_probs = pyro.param("y_probs", probs(4, w_dim, x_dim, y_dim))
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    w_prev = x_prev = None
    for i in markov_loop(vectorized, len(data), history):
        first = isinstance(i, int) and i < 1
        w_curr = pyro.sample(f"w_{i}", dist.Categorical(w_init if first else w_trans[w_prev]), infer=enum())
        x_curr = pyro.sample(
            f"x_{i}", dist.Categorical(x_init[w_curr] if first else Vindex(x_trans)[w_curr, x_prev]), infer=enum()
        )
        with tones:
            pyro.sample(f"y_{i}", dist.Categorical(Vindex(y_probs)[w_curr, x_curr]), obs=data[i])
        x_prev, w_prev = x_curr, w_curr


#     second-order chain: x[t] depends on x[t-1] and x[t-2]
def model_5(data, history, vectorized, x_dim=3, y_dim=2):
    x_init = pyro.param("x_init", probs(0, x_dim))
    x_init_2 = pyro.param("x_init_2", probs(1, x_dim, x_dim))
    x_trans = pyro.param("x_trans", probs(2, x_dim, x_dim, x_dim))
    y_probs = pyro.param("y_probs", probs(3, x_dim, y_dim))
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    x_prev = x_prev_2 = None
    for i in markov_loop(vectorized, len(data), history):
        if isinstance(i, int) and i == 0:
            x_probs = x_init
        elif isinstance(i, int) and i == 1:
            x_probs = Vindex(x_init_2)[x_prev]
        else:
            x_probs = Vindex(x_trans)[x_prev_2, x_prev]
        x_curr = pyro.sample(f"x_{i}", dist.Categorical(x_probs), infer=enum())
        with tones:
            pyro.sample(f"y_{i}", dist.Categorical(Vindex(y_probs)[x_curr]), obs=data[i])
        x_prev_2, x_prev = x_prev, x_curr


#     a transition matrix per step
def model_6(data, history, vectorized):
    x_dim = 3
    x_init = pyro.param("x_init", probs(0, x_dim))
    x_trans = pyro.param("x_trans", probs(1, len(data) - 1, x_dim, x_dim))
    locs = pyro.param("locs", _locs())
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    x_prev = None
    for i in markov_loop(vectorized, len(data), history):
        if isinstance(i, int) and i < 1:
            x_probs = x_init
        elif isinstance(i, int):
            x_probs = x_trans[i - 1, x_prev]
        else:
            x_probs = Vindex(x_trans)[(i - 1)[:, None], x_prev]
        x_curr = pyro.sample(f"x_{i}", dist.Categorical(x_probs), infer=enum())
        with tones:
            pyro.sample(f"y_{i}", dist.Normal(Vindex(locs)[..., x_curr], 1.0), obs=data[i])
        x_prev = x_curr


#     cross-coupled chains: w[t] <- x[t-1], x[t] <- w[t-1]
def model_7(data, history, vectorized):
    w_dim, x_dim, y_dim = 2, 3, 2
    w_init = pyro.param("w_init", probs(0, w_dim))
    w_trans = pyro.param("w_trans", probs(1, x_dim, w_dim))
    x_init = pyro.param("x_init", probs(2, x_dim))
    x_trans = pyro.param("x_trans", probs(3, w_dim, x_dim))
    y_probs = pyro.param("y_probs", probs(4, w_dim, x_dim, y_dim))
    tones = pyro.plate("tones", data.shape[-1], dim=-1)
    w_prev = x_prev = None
    for i in markov_loop(vectorized, len(data), history):
        first = isinstance(i, int) and i < 1
        w_curr = pyro.sample(f"w_{i}", dist.Categorical(w_init if first else w_trans[x_prev]), infer=enum())
        x_curr = pyro.sample(f"x_{i}", dist.Categorical(x_init if first else x_trans[w_prev]), infer=enum())
        with tones:
            pyro.sample(f"y_{i}", dist.Categorical(Vindex(y_probs)[w_curr, x_curr]), obs=data[i])
        x_prev, w_prev = x_curr, w_curr


# (model, data kind, data shape, history); "real" data is normal, "int"
# data all ones, as in the JAX test's CASES
CASES = [
    (model_0, "real", (3, 5, 4), 1),
    (model_1, "real", (5, 4), 1),
    (model_2, "int", (5, 4), 1),
    (model_3, "int", (5, 4), 1),
    (model_4, "int", (5, 4), 1),
    (model_5, "int", (5, 4), 2),
    (model_6, "real", (5, 4), 1),
    (model_6, "real", (31, 4), 1),
    (model_7, "int", (5, 4), 1),
    (model_7, "int", (23, 4), 1),
]
# the route of ops/markov_product.py each model's chain takes
ROUTES = {model_0: "scan", model_1: "scan", model_2: "scan", model_3: "pairwise", model_4: "pairwise",
          model_5: "pairwise", model_6: "general", model_7: "pairwise"}


def make_data(kind, shape, seed=99):
    """Normal draws (numpy ``seed``) or all-ones ints, on the package's device."""
    device = pyro.get_default_device()
    if kind == "int":
        return torch.ones(shape, dtype=torch.long, device=device)
    return torch.tensor(np.random.default_rng(seed).normal(size=shape), dtype=torch.get_default_dtype(), device=device)


def no_guide(*args, **kwargs):
    return None
