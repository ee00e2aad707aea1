"""Port parity, module by module: coordinate math, distributions, ELBO
sites, the activation registry and the fc nets of ``pyroved_tpu_torch``
against the JAX package on the same numpy inputs and weights."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyroved_tpu.infer import dists as jd
from pyroved_tpu.infer import elbo as jelbo
from pyroved_tpu.nets import fc as jfc
from pyroved_tpu.utils import coord as jcoord
from pyroved_tpu.utils import nn as jnn
from pyroved_tpu_torch.infer import dists as td
from pyroved_tpu_torch.infer import elbo as telbo
from pyroved_tpu_torch.nets import fc as tfc
from pyroved_tpu_torch.utils import coord as tcoord
from pyroved_tpu_torch.utils import nn as tnn
from pyroved_tpu_torch.weights import from_jax_params

# elementwise f32 math on the CPU in both packages
ATOL = 1e-6
# the nets sum products over ~150 inputs per layer in another order
NET_ATOL = 1e-5


def _np(x):
    return tnn.as_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# coord
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [(5, 7), (9,)])
def test_generate_grid_matches_jax(dim):
    np.testing.assert_allclose(_np(tcoord.generate_grid(dim)),
                               np.asarray(jcoord.generate_grid(dim)), atol=ATOL)


def test_transform_coordinates_matches_jax():
    rng = _rng(1)
    grid = _f32(rng.uniform(-1, 1, (3, 20, 2)))
    phi, sc = _f32(rng.normal(size=3)), _f32(1 + 0.1 * rng.normal(size=3))
    dx = _f32(rng.normal(size=(3, 1, 2)) * 0.1)
    ours = tcoord.transform_coordinates(torch.from_numpy(grid),
                                        torch.from_numpy(phi),
                                        torch.from_numpy(dx),
                                        torch.from_numpy(sc))
    ref = jcoord.transform_coordinates(jnp.asarray(grid), jnp.asarray(phi),
                                       jnp.asarray(dx), jnp.asarray(sc))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=ATOL)
    g1 = _f32(rng.uniform(-1, 1, (2, 9, 1)))
    np.testing.assert_allclose(
        _np(tcoord.transform_coordinates(torch.from_numpy(g1), 0.4, 0.3)),
        np.asarray(jcoord.transform_coordinates(jnp.asarray(g1), 0.4, 0.3)),
        atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"z_coord": [-2.0, 2.0, -1.5, 1.0]}])
def test_generate_latent_grid_matches_jax(kw):
    ours, (ox, oy) = tcoord.generate_latent_grid(6, **kw)
    ref, (rx, ry) = jcoord.generate_latent_grid(6, **kw)
    assert ours.dtype == torch.float32 and ours.shape == (36, 2)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(_np(ox), np.asarray(rx), atol=ATOL)
    np.testing.assert_allclose(_np(oy), np.asarray(ry), atol=ATOL)


# ---------------------------------------------------------------------------
# activations, dists, elbo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tanh", "relu", "lrelu", "softplus", "gelu"])
def test_activation_registry_matches_jax(name):
    x = _f32(np.linspace(-6, 6, 241))
    np.testing.assert_allclose(
        _np(tnn.get_activation(name)(torch.from_numpy(x))),
        np.asarray(jnn.get_activation(name)(jnp.asarray(x))), atol=ATOL)


def test_normal_densities_match_jax():
    rng = _rng(2)
    x, loc = _f32(rng.normal(size=50)), _f32(rng.normal(size=50))
    scale = _f32(rng.uniform(0.2, 2.0, 50))
    t = [torch.from_numpy(a) for a in (x, loc, scale)]
    j = [jnp.asarray(a) for a in (x, loc, scale)]
    np.testing.assert_allclose(_np(td.normal_log_prob(*t)),
                               np.asarray(jd.normal_log_prob(*j)), atol=ATOL)
    np.testing.assert_allclose(_np(td.std_normal_log_prob(t[0])),
                               np.asarray(jd.std_normal_log_prob(j[0])), atol=ATOL)
    np.testing.assert_allclose(_np(td.normal_kl(t[1], t[2])),
                               np.asarray(jd.normal_kl(j[1], j[2])), atol=ATOL)


@pytest.mark.parametrize("sampler", ["bernoulli", "continuous_bernoulli",
                                     "gaussian"])
def test_observation_log_probs_match_jax(sampler):
    rng = _rng(3)
    x = _f32(rng.uniform(0, 1, 200))
    # saturated probabilities and the continuous Bernoulli's Taylor window
    p = _f32(np.concatenate([rng.uniform(0, 1, 190), [0.0, 1.0, 0.5, 0.5004,
                                                      0.4997, 1e-9, 1 - 1e-8,
                                                      0.25, 0.75, 0.999]]))
    x[190:192] = [0.0, 1.0]
    kw = {"decoder_sig": 0.3} if sampler == "gaussian" else {}
    ours = td.get_sampler(sampler, **kw).log_prob(torch.from_numpy(x),
                                                  torch.from_numpy(p))
    ref = jd.get_sampler(sampler, **kw).log_prob(jnp.asarray(x), jnp.asarray(p))
    assert np.isfinite(_np(ours)).all()
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=ATOL, rtol=1e-6)


def test_get_sampler_names_the_choices():
    with pytest.raises(KeyError, match="bernoulli.*continuous_bernoulli.*gaussian"):
        td.get_sampler("poisson")


def test_samplers_take_a_generator():
    loc = torch.full((1000,), 0.3)
    for name in ("bernoulli", "continuous_bernoulli", "gaussian"):
        s = td.get_sampler(name)
        a = s.sample(loc, tnn.set_deterministic_mode(5))
        b = s.sample(loc, tnn.set_deterministic_mode(5))
        assert torch.equal(a, b) and a.shape == loc.shape
    draws = td.get_sampler("bernoulli").sample(loc, tnn.set_deterministic_mode(1))
    assert abs(draws.mean().item() - 0.3) < 0.05


@pytest.mark.parametrize("kl", ["mc", "analytic"])
def test_normal_latent_site_matches_jax_with_injected_eps(kl):
    rng = _rng(4)
    loc = _f32(rng.normal(size=(6, 3)))
    scale = _f32(rng.uniform(0.1, 1.5, (6, 3)))
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, loc.shape))  # what JAX draws
    jz, jterm = jelbo.normal_latent_site(key, jnp.asarray(loc),
                                         jnp.asarray(scale), 0.7, kl)
    tz, tterm = telbo.normal_latent_site(torch.from_numpy(loc),
                                         torch.from_numpy(scale), 0.7, kl,
                                         eps=torch.from_numpy(eps))
    np.testing.assert_allclose(_np(tz), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(_np(tterm), np.asarray(jterm), atol=ATOL)


def test_obs_site_matches_jax():
    rng = _rng(5)
    x, p = _f32(rng.uniform(0, 1, (4, 30))), _f32(rng.uniform(0, 1, (4, 30)))
    ours = telbo.obs_site(td.get_sampler("bernoulli"), torch.from_numpy(x),
                          torch.from_numpy(p))
    ref = jelbo.obs_site(jd.get_sampler("bernoulli"), jnp.asarray(x),
                         jnp.asarray(p))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# fc nets, loaded from JAX weights
# ---------------------------------------------------------------------------

def _load(module, jparams):
    """Port module with the JAX weights; asserts the names line up."""
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    module.load_state_dict(state, strict=True)
    return module


def test_fc_encoder_matches_jax():
    rng = _rng(6)
    x = _f32(rng.uniform(0, 1, (5, 8, 8)))
    y = _f32(rng.normal(size=(5, 2)))
    jnet = jfc.fcEncoderNet((8, 8), latent_dim=3, c_dim=2, hidden_dim=(32, 24))
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)),
                       jnp.zeros((1, 2)))["params"]
    tnet = _load(tfc.fcEncoderNet((8, 8), 3, 2, (32, 24)), params)
    jmu, jsig = jnet.apply({"params": params}, jnp.asarray(x.reshape(5, 64)),
                           jnp.asarray(y))
    with torch.no_grad():
        tmu, tsig = tnet(torch.from_numpy(x.reshape(5, 64)), torch.from_numpy(y))
    np.testing.assert_allclose(_np(tmu), np.asarray(jmu), atol=NET_ATOL)
    np.testing.assert_allclose(_np(tsig), np.asarray(jsig), atol=NET_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_sdecoder_matches_jax(channels):
    rng = _rng(7)
    coords = _f32(rng.uniform(-1, 1, (4, 30, 2)))
    z = _f32(rng.normal(size=(4, 3)))
    jnet = jfc.sDecoderNet((5, 6), (64, 64), "gelu", sigmoid_out=True,
                           channels=channels)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(coords),
                       jnp.asarray(z))["params"]
    tnet = _load(tfc.sDecoderNet(2, 3, (64, 64), "gelu", True, channels),
                 params)
    ref = jnet.apply({"params": params}, jnp.asarray(coords), jnp.asarray(z))
    with torch.no_grad():
        ours = tnet(torch.from_numpy(coords), torch.from_numpy(z))
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=NET_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_fc_decoder_matches_jax(channels):
    rng = _rng(8)
    z = _f32(rng.normal(size=(4, 2)))
    out_dim = (6, 5) + ((channels,) if channels > 1 else ())
    jnet = jfc.fcDecoderNet(out_dim, (32, 32), "softplus", sigmoid_out=False)
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(z))["params"]
    tnet = _load(tfc.fcDecoderNet(2, out_dim, (32, 32), "softplus", False),
                 params)
    with torch.no_grad():
        ours = tnet(torch.from_numpy(z))
    np.testing.assert_allclose(_np(ours), np.asarray(
        jnet.apply({"params": params}, jnp.asarray(z))), atol=NET_ATOL)


def test_dense_init_is_torch_default_and_seeded():
    a = tfc.init_from(tfc.sDecoderNet(2, 3, (128, 128)),
                      tnn.set_deterministic_mode(3))
    b = tfc.init_from(tfc.sDecoderNet(2, 3, (128, 128)),
                      tnn.set_deterministic_mode(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.MLP_0.Dense_0.weight
    bound = 1 / np.sqrt(128)
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound
