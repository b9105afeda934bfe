"""The port's conditioner networks, affine flows, ``NormalMarkovChain`` and
optimisers against the JAX package, on the CPU.

Inputs and weights are drawn with numpy from a seed at small sizes and
go through both packages (weights carried across under the JAX names).
Tolerances: RNN outputs and final states atol 1e-5, their gradients
against ``jax.grad`` rtol 1e-4 with atol 1e-5; MADE masks bit for bit; the
flows' forward, inverse and log-determinant atol 1e-5;
``NormalMarkovChain.log_prob`` rtol 1e-5 and its draws at shared noise
atol 1e-5; each optimiser's parameters after every step rtol 1e-5 with
atol 1e-6.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu.distributions as jdist
import pyro_tpu.optim as joptim
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
import pyro_tpu_torch.optim as toptim
from pyro_tpu.distributions import flows as jflows
from pyro_tpu.nn import auto_reg_nn as jarn
from pyro_tpu.nn import dense_nn as jdense
from pyro_tpu.nn import recurrent as jrec
from pyro_tpu_torch.distributions import flows as tflows
from pyro_tpu_torch.nn import RNN, AutoRegressiveNN, ConditionalDenseNN, DenseNN, GRUCell
from pyro_tpu_torch.nn.auto_reg_nn import create_mask


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    yield
    pyro.clear_param_store()


def _close(actual, expected, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(np.asarray(actual.detach()), np.asarray(expected), rtol=rtol, atol=atol)


def _load(module, named):
    """Copy numpy arrays into a torch module's parameters by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.tensor(named[name]))
    return module


# -- RNN ----------------------------------------------------------------------------

B, T, I, H = 3, 6, 4, 5
GATES = {"relu": 1, "tanh": 1, "gru": 3, "lstm": 4}
# (num_layers, reverse, mask, h0)
RNN_CONFIGS = [(1, False, False, False), (2, True, True, True), (1, True, False, True), (2, False, True, False)]


def _rnn_inputs(cell, layers, with_mask, with_h0):
    rng = np.random.default_rng(zlib.crc32(repr((cell, layers, with_mask, with_h0)).encode()))
    G, k = GATES[cell], 1 / np.sqrt(H)
    params = {}
    for l in range(layers):
        width = I if l == 0 else H
        for name, shape in (("w_ih", (G * H, width)), ("w_hh", (G * H, H)), ("b_ih", (G * H,)), ("b_hh", (G * H,))):
            params[f"{name}_l{l}"] = rng.uniform(-k, k, shape).astype(np.float32)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    mask = rng.random((B, T)) < 0.7 if with_mask else None
    h0 = None
    if with_h0:
        h0 = rng.standard_normal((layers, B, H)).astype(np.float32) * 0.5
        if cell == "lstm":
            h0 = (h0, rng.standard_normal((layers, B, H)).astype(np.float32) * 0.5)
    cot = rng.standard_normal((B, T, H)).astype(np.float32), rng.standard_normal((2, layers, B, H)).astype(np.float32)
    return params, x, mask, h0, cot


def _jax_rnn(cell, layers, reverse):
    module = jrec.RNN(features=H, cell=cell, num_layers=layers, reverse=reverse)

    def run(params, x, h0, mask):
        return module.apply({"params": params}, x, h0, mask)

    return run


def _port_rnn(cell, layers, reverse, params):
    return _load(RNN(I, H, cell, layers, reverse), params)


def _finals(final):
    return final if isinstance(final, tuple) else (final,)


def _loss(out, final, cot):
    """A scalar that weighs every output and final state."""
    total = (out * cot[0]).sum()
    for i, f in enumerate(_finals(final)):
        total = total + (f * cot[1][i]).sum()
    return total


@pytest.mark.parametrize("config", RNN_CONFIGS, ids=lambda c: "L{}-{}-{}-{}".format(
    c[0], "rev" if c[1] else "fwd", "mask" if c[2] else "nomask", "h0" if c[3] else "zeros"))
@pytest.mark.parametrize("cell", list(GATES))
def test_rnn_matches_jax(cell, config):
    layers, reverse, with_mask, with_h0 = config
    params, x, mask, h0, _ = _rnn_inputs(cell, layers, with_mask, with_h0)
    j_out, j_final = jax.jit(_jax_rnn(cell, layers, reverse))(params, x, h0, mask)
    t_h0 = None if h0 is None else (tuple(map(torch.tensor, h0)) if cell == "lstm" else torch.tensor(h0))
    t_out, t_final = _port_rnn(cell, layers, reverse, params)(
        torch.tensor(x), t_h0, None if mask is None else torch.tensor(mask))
    assert t_out.shape == (B, T, H)
    _close(t_out, j_out)
    for t, j in zip(_finals(t_final), _finals(j_final), strict=True):
        assert t.shape == (layers, B, H)
        _close(t, j)


@pytest.mark.parametrize("cell", list(GATES))
def test_rnn_gradients_match_jax(cell):
    layers, reverse, with_mask, with_h0 = 2, True, True, True
    params, x, mask, h0, cot = _rnn_inputs(cell, layers, with_mask, with_h0)
    run = _jax_rnn(cell, layers, reverse)

    def jloss(p, x, h0):
        return _loss(*run(p, x, h0, mask), cot)

    j_grads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, x, h0)
    rnn = _port_rnn(cell, layers, reverse, params)
    tx = torch.tensor(x, requires_grad=True)
    th0 = tuple(torch.tensor(h, requires_grad=True) for h in h0) if cell == "lstm" else (torch.tensor(h0, requires_grad=True),)
    _loss(*rnn(tx, th0 if cell == "lstm" else th0[0], torch.tensor(mask)), tuple(map(torch.tensor, cot))).backward()
    for name, p in rnn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[0][name], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), j_grads[1], rtol=1e-4, atol=1e-5)
    for t, j in zip(th0, j_grads[2] if cell == "lstm" else (j_grads[2],), strict=True):
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4, atol=1e-5)


def test_rnn_masked_step_carries_the_state():
    params, x, _, _, _ = _rnn_inputs("gru", 1, False, False)
    rnn = _port_rnn("gru", 1, False, params)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[:, 3:] = False
    out, final = rnn(torch.tensor(x), mask=mask)
    assert torch.equal(out[:, 3:], out[:, 2:3].expand(B, T - 3, H))
    assert torch.equal(final[0], out[:, 2])


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(3)
    k = 1 / np.sqrt(H)
    params = {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in
              (("w_ih", (3 * H, I)), ("w_hh", (3 * H, H)), ("b_ih", (3 * H,)), ("b_hh", (3 * H,)))}
    h, x = rng.standard_normal((B, H)).astype(np.float32), rng.standard_normal((B, I)).astype(np.float32)
    expected = jax.jit(lambda p, h, x: jrec.GRUCell(features=H).apply({"params": p}, h, x))(params, h, x)
    _close(_load(GRUCell(I, H), params)(torch.tensor(h), torch.tensor(x)), expected)


# -- MADE, DenseNN and the affine flows ------------------------------------------------

D, HID = 5, (11, 7)


@pytest.mark.parametrize("context_dim", [0, 2])
@pytest.mark.parametrize("permutation", [None, (3, 0, 4, 1, 2)])
@pytest.mark.parametrize("multiplier", [1, 2, 3])
def test_made_masks_match_jax(context_dim, permutation, multiplier):
    perm = np.arange(D) if permutation is None else np.asarray(permutation)
    j_masks, j_out = jarn.create_mask(D, context_dim, HID, perm, multiplier)
    t_masks, t_out = create_mask(D, context_dim, HID, perm, multiplier)
    for t, j in zip(t_masks + [t_out], j_masks + [j_out], strict=True):
        assert t.dtype == j.dtype and np.array_equal(t, j)
    net = AutoRegressiveNN(D, HID, (1,) * multiplier, permutation, context_dim=context_dim)
    layers = list(net.hidden_layers) + [net.output_layer]
    for layer, j in zip(layers, j_masks + [j_out], strict=True):
        assert np.array_equal(layer.mask.numpy(), j)


def _arn_params(rng, hidden, out_width, in_width=D):
    """flax params of a MADE: ``hidden_layers_{i}`` and ``output_layer``."""
    widths = [in_width, *hidden]
    params = {f"hidden_layers_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a),
                                     "bias": rng.standard_normal(b).astype(np.float32) * 0.1}
              for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}
    params["output_layer"] = {"kernel": rng.standard_normal((widths[-1], out_width)).astype(np.float32) * 0.3,
                              "bias": rng.standard_normal(out_width).astype(np.float32) * 0.1}
    return params


def _dense_params(rng, widths):
    return {f"Dense_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a),
                           "bias": rng.standard_normal(b).astype(np.float32) * 0.1}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}


def _port_from_flax(module, flax_params, rename):
    """Load flax params into a torch module: ``rename`` maps a flax layer
    name to the torch one; a kernel (in, out) becomes a weight (out, in)."""
    named = {}
    for layer, leaves in flax_params.items():
        named[f"{rename(layer)}.weight"] = leaves["kernel"].T
        named[f"{rename(layer)}.bias"] = leaves["bias"]
    return _load(module, named)


def _made(rng, param_dims=(1, 1), context_dim=0, hidden=(9,)):
    flax = _arn_params(rng, hidden, D * sum(param_dims), D + context_dim)
    jnet = jarn.AutoRegressiveNN(D, hidden, param_dims, context_dim=context_dim)
    tnet = _port_from_flax(AutoRegressiveNN(D, hidden, param_dims, context_dim=context_dim), flax,
                           lambda n: n.replace("hidden_layers_", "hidden_layers."))
    return (lambda *a: jnet.apply({"params": flax}, *a)), tnet


def test_made_params_are_named_as_the_jax_module():
    variables = jax.jit(jarn.AutoRegressiveNN(D, HID).init)(jax.random.key(0), jnp.zeros((1, D)))
    expected = {f"{layer.replace('hidden_layers_', 'hidden_layers.')}.{'weight' if kind == 'kernel' else kind}":
                tuple(reversed(leaf.shape)) for layer, leaves in variables["params"].items() for kind, leaf in leaves.items()}
    assert {n: tuple(p.shape) for n, p in AutoRegressiveNN(D, HID).named_parameters()} == expected


@pytest.mark.parametrize("param_dims,context_dim", [((1, 1), 0), ((2, 1), 0), ((1,), 0), ((1, 1), 3)])
def test_made_outputs_match_jax(param_dims, context_dim):
    rng = np.random.default_rng(11)
    jnet, tnet = _made(rng, param_dims, context_dim, hidden=HID)
    x = rng.standard_normal((4, D)).astype(np.float32)
    args = (x,) if not context_dim else (x, rng.standard_normal((4, context_dim)).astype(np.float32))
    expected = jax.jit(jnet)(*args)
    actual = tnet(*map(torch.tensor, args))
    for t, j in zip(actual if isinstance(actual, tuple) else (actual,),
                    expected if isinstance(expected, tuple) else (expected,), strict=True):
        assert t.shape == j.shape
        _close(t, j)


def test_dense_nns_match_jax():
    rng = np.random.default_rng(12)
    x, ctx = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal((4, 2)).astype(np.float32)
    flax = _dense_params(rng, [3, 8, 6, 5])
    expected = jdense.DenseNN(3, (8, 6), (2, 3)).apply({"params": flax}, x)
    actual = _port_from_flax(DenseNN(3, (8, 6), (2, 3)), flax, lambda n: n.replace("Dense_", "layers."))(torch.tensor(x))
    for t, j in zip(actual, expected, strict=True):
        _close(t, j)
    flax = _dense_params(rng, [5, 8, 4])
    expected = jdense.ConditionalDenseNN(3, 2, (8,), (4,)).apply({"params": flax}, x, ctx)
    tnet = _port_from_flax(ConditionalDenseNN(3, 2, (8,), (4,)), flax, lambda n: n.replace("Dense_", "layers."))
    _close(tnet(torch.tensor(x), torch.tensor(ctx)), expected)


def _flow_pair(kind, rng):
    if kind == "autoregressive":
        jnet, tnet = _made(rng)
        return jflows.AffineAutoregressive(jnet), tflows.AffineAutoregressive(tnet)
    split = 2
    flax = _dense_params(rng, [split, 9, 2 * (D - split)])
    jnet = jdense.DenseNN(split, (9,), (D - split, D - split))
    tnet = _port_from_flax(DenseNN(split, (9,), (D - split, D - split)), flax, lambda n: n.replace("Dense_", "layers."))
    return jflows.AffineCoupling(split, lambda x: jnet.apply({"params": flax}, x)), tflows.AffineCoupling(split, tnet)


@pytest.mark.parametrize("kind", ["autoregressive", "coupling"])
def test_affine_flows_match_jax(kind):
    rng = np.random.default_rng(13)
    jtr, ttr = _flow_pair(kind, rng)
    x = rng.standard_normal((6, D)).astype(np.float32)
    y_j = jax.jit(jtr.__call__)(x)
    y_t = ttr(torch.tensor(x))
    _close(y_t, y_j)
    _close(ttr.inv(torch.tensor(np.asarray(y_j))), jax.jit(jtr.inv.__call__)(y_j))
    _close(ttr.inv(y_t), x)
    _close(ttr.log_abs_det_jacobian(torch.tensor(x), y_t), jax.jit(jtr.log_abs_det_jacobian)(x, y_j))
    assert ttr.event_dim == jtr.event_dim == 1


def test_transform_event_dim_follows_domain_and_codomain():
    assert tdist.transforms.ExpTransform().event_dim == 0
    assert tdist.transforms.StickBreakingTransform().event_dim == 1
    assert tdist.transforms.IndependentTransform(tdist.transforms.ExpTransform(), 2).event_dim == 2


def test_flow_helpers_register_their_networks():
    tr = tflows.affine_autoregressive("iaf", D, hidden_dims=[9])
    coupling = tflows.affine_coupling("coupling", D)
    store = pyro.get_param_store()
    assert {n for n in store.get_all_unconstrained() if n.startswith("iaf$$$")} == {
        "iaf$$$hidden_layers.0.weight", "iaf$$$hidden_layers.0.bias", "iaf$$$output_layer.weight",
        "iaf$$$output_layer.bias"}
    assert coupling.split_dim == D // 2 and "coupling$$$layers.1.weight" in store
    # a second helper call takes the stored weights
    x = torch.randn(3, D, generator=torch.Generator().manual_seed(0))
    again = tflows.affine_autoregressive("iaf", D, hidden_dims=[9])
    assert torch.equal(tr(x), again(x))


# -- NormalMarkovChain ----------------------------------------------------------------

NB, NT, NZ, NK = 3, 5, D, 3


def _cond(lib, w, with_xs):
    """(z_prev, x_t) -> (loc, scale), broadcasting over leading dims."""
    tanh = jnp.tanh if lib is jnp else torch.tanh
    softplus = jax.nn.softplus if lib is jnp else torch.nn.functional.softplus

    def cond(z, x):
        pre = z @ w["W"] + w["b"]
        if with_xs:
            pre = pre + x @ w["V"]
        return tanh(pre), softplus(z @ w["U"]) + 0.1

    return cond


def _chains(with_xs, num_iafs):
    rng = np.random.default_rng(17 + num_iafs)
    w = {"W": rng.standard_normal((NZ, NZ)) * 0.5, "U": rng.standard_normal((NZ, NZ)) * 0.3,
         "V": rng.standard_normal((NK, NZ)) * 0.5, "b": rng.standard_normal(NZ) * 0.1}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    z_init = rng.standard_normal((NB, NZ)).astype(np.float32)
    xs = rng.standard_normal((NB, NT, NK)).astype(np.float32) if with_xs else None
    pairs = [_made(rng) for _ in range(num_iafs)]
    jchain = jdist.NormalMarkovChain(
        _cond(jnp, {k: jnp.asarray(v) for k, v in w.items()}, with_xs), jnp.asarray(z_init), length=NT,
        xs=None if xs is None else jnp.asarray(xs), transforms=[jflows.AffineAutoregressive(j) for j, _ in pairs])
    tchain = tdist.NormalMarkovChain(
        _cond(torch, {k: torch.tensor(v) for k, v in w.items()}, with_xs), torch.tensor(z_init), length=NT,
        xs=None if xs is None else torch.tensor(xs), transforms=[tflows.AffineAutoregressive(t) for _, t in pairs])
    return jchain, tchain, rng


@pytest.mark.parametrize("num_iafs", [0, 1, 2])
@pytest.mark.parametrize("with_xs", [False, True])
def test_normal_markov_chain_log_prob_matches_jax(with_xs, num_iafs):
    jchain, tchain, rng = _chains(with_xs, num_iafs)
    assert tchain.batch_shape == jchain.batch_shape and tchain.event_shape == jchain.event_shape
    value = rng.standard_normal((2, NB, NT, NZ)).astype(np.float32)
    expected = jax.jit(jchain.log_prob)(value)
    np.testing.assert_allclose(tchain.log_prob(torch.tensor(value)).detach().numpy(), expected, rtol=1e-5)


def _fixed_draw(value):
    def jdraw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        assert tuple(shape) == value.shape, (shape, value.shape)
        return jnp.asarray(value, dtype)

    def tdraw(*shape, generator=None, dtype=None, device=None, **kwargs):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        assert shape == value.shape, (shape, value.shape)
        return torch.tensor(value, dtype=dtype, device=device)

    return jdraw, tdraw


@pytest.mark.parametrize("num_iafs", [0, 2])
@pytest.mark.parametrize("with_xs", [False, True])
def test_normal_markov_chain_rsample_matches_jax_at_shared_noise(with_xs, num_iafs, monkeypatch):
    jchain, tchain, rng = _chains(with_xs, num_iafs)
    eps = rng.standard_normal((2, NB, NT, NZ)).astype(np.float32)
    jdraw, tdraw = _fixed_draw(eps)
    monkeypatch.setattr(jax.random, "normal", jdraw)
    monkeypatch.setattr(torch, "randn", tdraw)
    expected = jchain.rsample(jax.random.key(0), (2,))
    actual = tchain.rsample(None, (2,))
    assert actual.shape == (2, NB, NT, NZ)
    _close(actual, expected)


def test_normal_markov_chain_needs_a_length():
    with pytest.raises(ValueError, match="length"):
        tdist.NormalMarkovChain(lambda z, x: (z, z), torch.zeros(2, 3))


# -- optimisers ---------------------------------------------------------------------

OPTIMISERS = [
    ("Adam", {"lr": 0.01}),
    ("Adam", {"lr": 0.01, "weight_decay": 0.1}),
    ("AdamW", {"lr": 0.01}),
    ("SGD", {"lr": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("RMSprop", {"lr": 0.01}),
    ("RMSprop", {"lr": 0.01, "momentum": 0.5, "centered": True}),
    ("Adagrad", {"lr": 0.1}),
    ("ClippedAdam", {"lr": 0.01, "clip_norm": 1.0, "lrd": 0.9, "weight_decay": 0.01}),
    ("AdagradRMSProp", {"eta": 0.5}),
    ("Adadelta", {"lr": 1.0}),
    ("Adamax", {"lr": 0.01}),
    ("NAdam", {"lr": 0.01}),
    ("RAdam", {"lr": 0.01}),
]
CLIPS = {"no clip": None, "clip_norm": {"clip_norm": 1.5}, "clip_value": {"clip_value": 0.5}}
SHAPES = {"a": (3, 4), "m$$$w": (5,)}
OPT_STEPS = 3


def _trajectories(name, args, clip, steps, tmp_path, save_at=2):
    rng = np.random.default_rng(23)
    params0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (2.0 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    jopt = getattr(joptim, name)(args, clip_args=clip)
    jparams, expected = {k: jnp.asarray(v) for k, v in params0.items()}, []
    for g in grads:
        jparams = jopt(jparams, {k: jnp.asarray(v) for k, v in g.items()})
        expected.append({k: np.asarray(v) for k, v in jparams.items()})
    topt = getattr(toptim, name)(args, clip_args=clip)
    tparams, actual = {k: torch.tensor(v, requires_grad=True) for k, v in params0.items()}, []
    for i, g in enumerate(grads):
        if i == save_at:  # a new optimiser from the saved state takes over
            topt.save(tmp_path / "optim.pt")
            topt = getattr(toptim, name)(args, clip_args=clip)
            topt.load(tmp_path / "optim.pt")
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        topt(tparams)
        assert all(p.grad is None for p in tparams.values())
        actual.append({k: p.detach().numpy().copy() for k, p in tparams.items()})
    return actual, expected


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("case", OPTIMISERS, ids=lambda c: c[0] + "-" + "-".join(sorted(set(c[1]) - {"lr"})))
def test_optimiser_steps_match_jax(case, clip, tmp_path):
    actual, expected = _trajectories(*case, CLIPS[clip], OPT_STEPS, tmp_path)
    for a, e in zip(actual, expected, strict=True):
        for k in SHAPES:
            np.testing.assert_allclose(a[k], e[k], rtol=1e-5, atol=1e-6)


def test_radam_rectified_steps_match_jax(tmp_path):
    # the variance's length ro passes optax's threshold of 5 at the sixth step
    actual, expected = _trajectories("RAdam", {"lr": 0.01}, None, 8, tmp_path, save_at=5)
    for a, e in zip(actual, expected, strict=True):
        for k in SHAPES:
            np.testing.assert_allclose(a[k], e[k], rtol=1e-5, atol=1e-6)


def test_optimiser_args_per_parameter():
    """A callable ``optim_args`` gives each parameter its own arguments."""
    args = lambda module, param: {"lr": 0.1 if module == "m" else 0.01}  # noqa: E731
    opt = toptim.Adam(args)
    params = {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt(params)
    np.testing.assert_allclose(params["a"].detach().numpy(), -0.01, rtol=1e-5)
    np.testing.assert_allclose(params["m$$$w"].detach().numpy(), -0.1, rtol=1e-5)
    state = opt.get_state()
    assert set(state["states"]) == set(SHAPES)
    # the state is a copy: later steps leave it as it was
    mu = state["states"]["a"][0]["mu"].clone()
    params["a"].grad = torch.full(SHAPES["a"], 3.0)
    opt(params)
    assert torch.equal(state["states"]["a"][0]["mu"], mu) and opt.get_state()["states"]["a"][0]["count"] == 2


def test_optimiser_takes_list_arguments():
    """Arguments need not be hashable: ``betas`` as a list."""
    opt = toptim.Adam({"lr": 0.1, "betas": [0.5, 0.9]})
    params = {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt(params)
    for p in params.values():
        np.testing.assert_allclose(p.detach().numpy(), -0.1, rtol=1e-5)
