"""The port's Normal-family autoguides, with the transforms and
distributions they stand on, against the JAX package on the CPU.

Inputs are drawn with numpy from a seed at small sizes.  What is compared,
and within what:

(a) ``SoftplusTransform``, ``LowerCholeskyTransform``,
    ``SoftplusLowerCholeskyTransform`` and ``SigmoidTransform``: forward,
    inverse and log|det J| within 1e-5 * max + 1e-6; ``with_cache`` inverts
    its own output by lookup; ``TransformedDistribution.log_prob``,
    ``Normal.cdf``/``icdf`` and ``LowRankMultivariateNormal.log_prob`` (also
    against the dense MVN) rtol 1e-5, cdf(icdf(q)) within 1e-6 of q; the
    new constraints' bijections;
(b) each of ``AutoNormal``, ``AutoDiagonalNormal``,
    ``AutoMultivariateNormal``, ``AutoLowRankMultivariateNormal`` and
    ``AutoIAFNormal`` on a small hierarchical model (a real, a positive
    vector and a plated latent; 6 latent dims), with the JAX guide's
    parameters carried across: the loss rtol 1e-5 and the gradient of every
    parameter within 1e-4 * its max|grad| + 1e-6 at one fixed latent value
    (the guide's latent sites conditioned, the model conditioned on what the
    guide then gives: log q(z) - log p(data, z), as the JAX package's
    replay refuses a conditioned guide site); ``median`` and ``quantiles``
    within 1e-5 * max + 1e-6 (a flow's raise as the JAX one's);
(c) ``AutoGuideList`` of an ``AutoNormal`` and a plain callable
    (``AutoCallable``): the loss and gradients as in (b), its ``median``;
    ``create_plates`` in place of the recorded plates.

The JAX side runs under ``jax.jit`` where it is more than a few ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro_tpu as jpyro
import pyro_tpu.distributions as jdist
import pyro_tpu_torch as pyro
import pyro_tpu_torch.distributions as tdist
from pyro_tpu import poutine as jpoutine
from pyro_tpu.distributions import constraints as jconstraints
from pyro_tpu.distributions import transforms as jtransforms
from pyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from pyro_tpu.infer import autoguide as jag
from pyro_tpu.infer.svi import ParamsMessenger
from pyro_tpu_torch import poutine
from pyro_tpu_torch.distributions import constraints
from pyro_tpu_torch.distributions import transforms as ttransforms
from pyro_tpu_torch.infer import Trace_ELBO
from pyro_tpu_torch.infer import autoguide as tag
from pyro_tpu_torch.params import param_store_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyro.set_default_device("cpu")
    pyro.clear_param_store()
    jpyro.clear_param_store()
    yield
    pyro.clear_param_store()
    jpyro.clear_param_store()


def _near(actual, expected, scale=1e-5, atol=1e-6):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=scale * np.abs(expected).max() + atol)


RNG = np.random.default_rng(23)


# -- (a) transforms and distributions -------------------------------------------------

TRANSFORMS = {
    "softplus": (lambda m: m.SoftplusTransform(), (3, 4)),
    "lower_cholesky": (lambda m: m.LowerCholeskyTransform(), (2, 4, 4)),
    "softplus_lower_cholesky": (lambda m: m.SoftplusLowerCholeskyTransform(), (2, 4, 4)),
    "sigmoid": (lambda m: m.SigmoidTransform(), (3, 4)),
}


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_transform_matches_jax(kind):
    make, shape = TRANSFORMS[kind]
    x = RNG.standard_normal(shape).astype(np.float32)
    tt, jt = make(ttransforms), make(jtransforms)
    y_t, y_j = tt(torch.tensor(x)), jt(jnp.asarray(x))
    _near(y_t.numpy(), y_j)
    _near(tt.inv(y_t).numpy(), jt.inv(y_j))
    _near(tt.log_abs_det_jacobian(torch.tensor(x), y_t).numpy(), jt.log_abs_det_jacobian(jnp.asarray(x), y_j))
    assert tt.domain.event_dim == jt.domain.event_dim and tt.codomain.event_dim == jt.codomain.event_dim
    assert bool(tt.codomain.check(y_t).all())


def test_cached_transform_inverts_its_output_by_lookup():
    class ForwardOnly(ttransforms.ExpTransform):
        def _inverse(self, y):
            raise AssertionError("inverted without the cache")

    t = ForwardOnly().with_cache()
    x = torch.randn(3)
    y = t(x)
    assert t.inv(y) is x and t(x) is y
    with pytest.raises(AssertionError):
        t.inv(y.clone())
    assert ForwardOnly().with_cache(0).__class__ is ForwardOnly


def test_new_constraints_have_their_bijections():
    for c, t in ((constraints.softplus_positive, ttransforms.SoftplusTransform),
                 (constraints.lower_cholesky, ttransforms.LowerCholeskyTransform),
                 (constraints.softplus_lower_cholesky, ttransforms.SoftplusLowerCholeskyTransform)):
        assert type(ttransforms.biject_to(c)) is t and type(ttransforms.transform_to(c)) is t
    L = torch.tensor([[1.0, 0.0], [0.5, 2.0]])
    assert bool(constraints.lower_cholesky.check(L)) and not bool(constraints.lower_cholesky.check(L.T))
    assert not bool(constraints.lower_cholesky.check(-L))


@pytest.mark.parametrize("chain", ["independent", "list"])
def test_transformed_distribution_matches_jax(chain):
    loc = RNG.standard_normal((2, 3)).astype(np.float32)
    scale = np.exp(0.3 * RNG.standard_normal((2, 3))).astype(np.float32)
    value = np.exp(RNG.standard_normal((2, 3))).astype(np.float32) + 0.1

    def build(dist, tr, cons, arr):
        base = dist.Normal(arr(loc), arr(scale)).to_event(1)
        if chain == "independent":
            return dist.TransformedDistribution(base, tr.biject_to(cons.independent(cons.positive, 1)))
        return dist.TransformedDistribution(base, [tr.ExpTransform(), tr.SoftplusTransform()])

    td = build(tdist, ttransforms, constraints, torch.tensor)
    jd = build(jdist, jtransforms, jconstraints, jnp.asarray)
    assert td.batch_shape == jd.batch_shape == (2,) and td.event_shape == jd.event_shape == (3,)
    np.testing.assert_allclose(td.log_prob(torch.tensor(value)).numpy(), np.asarray(jd.log_prob(jnp.asarray(value))),
                               rtol=1e-5)
    assert td.support.event_dim == 1
    draw = td.rsample(torch.Generator().manual_seed(0), (5,))
    assert draw.shape == (5, 2, 3) and bool((draw > 0).all())
    assert td.expand((4, 2)).batch_shape == (4, 2)


def test_normal_cdf_and_icdf_match_jax():
    loc, scale = np.float32(0.4), np.float32(1.7)
    q = np.array([1e-4, 0.025, 0.5, 0.9, 0.9999], np.float32)
    td, jd = tdist.Normal(torch.tensor(loc), torch.tensor(scale)), jdist.Normal(loc, scale)
    x = td.icdf(torch.tensor(q))
    np.testing.assert_allclose(x.numpy(), np.asarray(jd.icdf(jnp.asarray(q))), rtol=1e-5)
    np.testing.assert_allclose(td.cdf(x).numpy(), np.asarray(jd.cdf(jnp.asarray(x.numpy()))), rtol=1e-5)
    np.testing.assert_allclose(td.cdf(x).numpy(), q, rtol=0, atol=1e-6)


def test_low_rank_mvn_matches_jax_and_the_dense_mvn():
    n, r = 5, 2
    loc = RNG.standard_normal((3, n)).astype(np.float32)
    W = RNG.standard_normal((n, r)).astype(np.float32)
    D = np.exp(RNG.standard_normal(n)).astype(np.float32)
    value = RNG.standard_normal((4, 3, n)).astype(np.float32)
    td = tdist.LowRankMultivariateNormal(torch.tensor(loc), torch.tensor(W), torch.tensor(D))
    jd = jdist.LowRankMultivariateNormal(jnp.asarray(loc), jnp.asarray(W), jnp.asarray(D))
    got = td.log_prob(torch.tensor(value))
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.log_prob(jnp.asarray(value))), rtol=1e-5)
    dense = tdist.MultivariateNormal(torch.tensor(loc), covariance_matrix=td.covariance_matrix)
    np.testing.assert_allclose(got.numpy(), dense.log_prob(torch.tensor(value)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(td.variance.numpy(), np.asarray(jd.variance), rtol=1e-6)
    assert td.batch_shape == (3,) and td.rsample(torch.Generator().manual_seed(0), (2,)).shape == (2, 3, n)
    assert td.expand((2, 3)).batch_shape == (2, 3)


# -- (b) the autoguides against the JAX package ----------------------------------------

DATA = np.array([0.7, -0.4, 1.9], np.float32)
GUIDES = ["AutoNormal", "AutoDiagonalNormal", "AutoMultivariateNormal", "AutoLowRankMultivariateNormal",
          "AutoIAFNormal"]
# the model's latent sites at one fixed value, and the same packed
SITE_VALUES = {"loc": np.float32(0.3), "scale": np.array([0.8, 1.3], np.float32),
               "z": np.array([0.5, -0.2, 1.1], np.float32)}
LATENT = np.array([0.3, 0.1, -0.4, 0.2, 0.5, -0.2], np.float32)  # sorted sites: loc, scale, z; unconstrained


def _model(lib, dist, arr):
    def model(data):
        loc = lib.sample("loc", dist.Normal(arr(0.0), arr(1.0)))
        scale = lib.sample("scale", dist.Gamma(arr(np.full(2, 2.0, np.float32)), arr(np.full(2, 2.0, np.float32)))
                           .to_event(1))
        with lib.plate("groups", 3):
            z = lib.sample("z", dist.Normal(loc, scale[0]))
            lib.sample("obs", dist.Normal(z, scale[1]), obs=data)

    return model


def _cond(name):
    return SITE_VALUES if name == "AutoNormal" else {f"_{name}_latent": LATENT}


def _port_name(name):
    """The port's name of a JAX store name: a MADE's flax leaf
    ``flow$$$['params']['hidden_layers_0']['kernel']`` becomes
    ``flow$$$hidden_layers.0.weight``."""
    if "$$$" not in name:
        return name
    module, path = name.split("$$$")
    _, layer, kind = [p.strip("'") for p in path.strip("[]").split("][")]
    return f"{module}$$${layer.replace('hidden_layers_', 'hidden_layers.')}.{'weight' if kind == 'kernel' else kind}"


def _carry(jstore):
    """Load the JAX store into the port's (registered) store."""
    store = pyro.get_param_store()
    plain = {k: np.asarray(v) for k, v in jstore.items() if "$$$" not in k}
    param_store_from_jax(plain)
    with torch.no_grad():
        for k in jstore.keys():
            if "$$$" in k:
                value = np.asarray(jstore[k])
                store.get_unconstrained(_port_name(k)).copy_(torch.tensor(value.T if k.endswith("['kernel']") else value))


QUANTILES = [0.1, 0.5, 0.9]


def _summaries(guide, data):
    """The guide's median and quantiles, each None where the guide raises
    NotImplementedError."""
    out = {}
    for what, call in (("median", lambda: guide.median(data)), ("quantiles", lambda: guide.quantiles(QUANTILES, data))):
        try:
            out[what] = {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for k, v in call().items()}
        except NotImplementedError:
            out[what] = None
    return out


def _loss_at(poutine_mod, model, guide, cond, data):
    """-ELBO at one latent value: log q(z) - log p(data, z), the guide run
    with its sites ``cond`` conditioned and the model conditioned on the
    values the guide's sites then take (the single-draw Trace_ELBO loss at
    that draw)."""
    guide_trace = poutine_mod.trace(poutine_mod.condition(guide, data=cond)).get_trace(data)
    values = {name: site["value"] for name, site in guide_trace.nodes.items()
              if site["type"] == "sample" and not site["infer"].get("is_auxiliary")}
    model_trace = poutine_mod.trace(poutine_mod.condition(model, data=values)).get_trace(data)
    return guide_trace.log_prob_sum() - model_trace.log_prob_sum()


def _jax_case(make_guide, cond):
    """JAX: the guide's params (registered by one loss), the loss and the
    gradients at the latent value ``cond``, the median and quantiles."""
    model = _model(jpyro, jdist, jnp.asarray)
    guide = make_guide(model)
    data = jnp.asarray(DATA)
    JTrace_ELBO().loss(model, guide, data, rng_key=jax.random.key(0))
    store = jpyro.get_param_store()
    cond = {k: jnp.asarray(v) for k, v in cond.items()}

    def loss_fn(p):
        with ParamsMessenger(p):
            return _loss_at(jpoutine, model, guide, cond, data)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(store.get_all_unconstrained())
    return {"store": store, "loss": float(loss), "grads": {k: np.asarray(v) for k, v in grads.items()},
            **_summaries(guide, data)}


def _check_port_case(make_guide, cond, expected):
    model = _model(pyro, tdist, torch.tensor)
    guide = make_guide(model)
    data = torch.tensor(DATA)
    Trace_ELBO().loss(model, guide, data)  # registers the params
    _carry(expected["store"])
    with poutine.trace(param_only=True) as capture:
        loss = _loss_at(poutine, model, guide, {k: torch.tensor(v) for k, v in cond.items()}, data)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(expected["loss"], rel=1e-5)
    store = pyro.get_param_store()
    assert sorted(capture.trace.param_nodes()) == sorted(_port_name(k) for k in expected["grads"])
    for k, g in expected["grads"].items():
        grad = store.get_unconstrained(_port_name(k)).grad.numpy()
        _near(grad, g.T if k.endswith("['kernel']") else g, scale=1e-4)
    with torch.no_grad():
        got = _summaries(guide, data)
    for what in ("median", "quantiles"):
        if expected[what] is None:
            assert got[what] is None, f"{what} ran where the JAX guide's raises"
            continue
        assert sorted(got[what]) == sorted(expected[what])
        for k, v in expected[what].items():
            _near(got[what][k], v)


@pytest.mark.parametrize("name", GUIDES)
def test_autoguide_matches_jax_at_a_fixed_latent(name):
    cond = SITE_VALUES if name == "AutoNormal" else {f"_{name}_latent": LATENT}
    expected = _jax_case(getattr(jag, name), cond)
    _check_port_case(getattr(tag, name), cond, expected)


# -- (c) AutoGuideList with AutoCallable ------------------------------------------------


def _guide_list(lib, dist, ag, arr):
    def make(model):
        guide = ag.AutoGuideList(model)
        guide.append(ag.AutoNormal(lib.poutine.block(model, hide_fn=lambda msg: msg["name"] == "loc")))

        def loc_guide(data):
            lib.sample("loc", dist.Delta(lib.param("loc_map", arr(0.2))))

        guide.append(loc_guide)
        return guide

    return make


def test_auto_guide_list_matches_jax():
    cond = {k: v for k, v in SITE_VALUES.items() if k != "loc"}  # loc's Delta stays at its param
    expected = _jax_case(_guide_list(jpyro, jdist, jag, jnp.asarray), cond)
    assert isinstance(_guide_list(pyro, tdist, tag, torch.tensor)(None)._guides[1], tag.AutoCallable)
    _check_port_case(_guide_list(pyro, tdist, tag, torch.tensor), cond, expected)
    assert sorted(expected["median"]) == ["scale", "z"]


def test_create_plates_replaces_the_recorded_plates():
    """A guide given ``create_plates`` enters those plates: its plated site
    carries the plate the callable made, of the size it gave."""
    made = []

    def create_plates(data):
        made.append(pyro.plate("groups", data.shape[0]))
        return made[-1]

    model = _model(pyro, tdist, torch.tensor)
    guide = tag.AutoNormal(model, create_plates=create_plates)
    data = torch.tensor(DATA)
    trace = poutine.trace(guide).get_trace(data)
    frames = [f for f in trace.nodes["z"]["cond_indep_stack"] if f.name == "groups"]
    assert len(made) == 1 and len(frames) == 1 and frames[0].size == 3
    assert trace.nodes["z"]["value"].shape == (3,)
