"""Custom networks in the port (``set_encoder`` / ``set_decoder``,
``pyroved_tpu_torch/models/base.py``) and the layer factories
(``pyroved_tpu_torch/utils/nn.py``) against the JAX package's, on the CPU.

The same user-defined encoder and decoder, written once in flax and once
in torch with the flax names (``Dense_0``, ...), go into a JAX model and
the port's; with the JAX weights carried across (``load_jax_params``),
encode, decode and the per-example loss agree. After ``set_decoder`` the
port never routes a decode to the kernels (``apply_fused_sdecoder`` and
``apply_fused_recon_loss`` are never called), while after ``set_encoder``
alone it still does. The factories (``get_conv``, ``get_maxpool``,
``get_bnorm``, ``concat_features``, ``Concat``) compute what the JAX
package's compute, in torch's channels-first layout."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import pyroved_tpu.models as jmodels
from pyroved_tpu.utils import nn as jnn
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.models import base as tbase
from pyroved_tpu_torch.models import ivae as tivae
from pyroved_tpu_torch.nets.conv import BatchNorm
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils import nn as tnn
from pyroved_tpu_torch.utils.nn import as_numpy

# The port's f32 tolerances for outputs and per-example losses.
ATOL = 1e-5
RTOL = 1e-5
H = 24
DATA = (8, 8)
B = 5


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU path
    computes them, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


# ---------------------------------------------------------------------------
# The user's networks, in flax and in torch
# ---------------------------------------------------------------------------

class JEncoder(fnn.Module):
    """q(z|x): one tanh layer, a (loc, scale) head. The JAX iVAE calls its
    encoder with the labels always, None without them."""
    z_dim: int

    @fnn.compact
    def __call__(self, x, y=None):
        h = jnp.tanh(fnn.Dense(H)(x))
        out = fnn.Dense(2 * self.z_dim)(h)
        return out[:, :self.z_dim], jax.nn.softplus(out[:, self.z_dim:])


class JCondEncoder(JEncoder):
    """q(z|x,y): the labels joined to x (a conditional encoder takes
    both, which is how the JAX package's set_encoder tells it apart)."""

    def __call__(self, x, y):
        return super().__call__(jnp.concatenate([x, y], -1))


class TEncoder(nn.Module):
    def __init__(self, in_dim, z_dim):
        super().__init__()
        self.z_dim = z_dim
        self.Dense_0 = nn.Linear(in_dim, H)
        self.Dense_1 = nn.Linear(H, 2 * z_dim)

    def forward(self, x):
        out = self.Dense_1(torch.tanh(self.Dense_0(x)))
        return out[:, :self.z_dim], F.softplus(out[:, self.z_dim:])


class TCondEncoder(TEncoder):
    def forward(self, x, y):
        return super().forward(torch.cat([x, y], -1))


class JSpatialDecoder(fnn.Module):
    """p(x|z) over warped coordinates: h = softplus(coords Wc + z Wz),
    a sigmoid head per pixel."""

    @fnn.compact
    def __call__(self, coords, z):
        h = fnn.Dense(H)(coords) + fnn.Dense(H, use_bias=False)(z)[..., None, :]
        return jax.nn.sigmoid(fnn.Dense(1)(jax.nn.softplus(h)))[..., 0]


class TSpatialDecoder(nn.Module):
    def __init__(self, zc_dim):
        super().__init__()
        self.Dense_0 = nn.Linear(2, H)
        self.Dense_1 = nn.Linear(zc_dim, H, bias=False)
        self.Dense_2 = nn.Linear(H, 1)

    def forward(self, coords, z):
        h = self.Dense_0(coords) + self.Dense_1(z)[..., None, :]
        return torch.sigmoid(self.Dense_2(F.softplus(h)))[..., 0]


class JPlainDecoder(fnn.Module):
    @fnn.compact
    def __call__(self, z):
        h = jnp.tanh(fnn.Dense(H)(z))
        return jax.nn.sigmoid(fnn.Dense(int(np.prod(DATA)))(h))


class TPlainDecoder(nn.Module):
    def __init__(self, zc_dim):
        super().__init__()
        self.Dense_0 = nn.Linear(zc_dim, H)
        self.Dense_1 = nn.Linear(H, int(np.prod(DATA)))

    def forward(self, z):
        return torch.sigmoid(self.Dense_1(torch.tanh(self.Dense_0(z))))


# name: (model, keywords, label width of the encoder, spatial decoder)
CASES = {
    "ivae_r": ("iVAE", dict(latent_dim=2, invariances=["r"]), 0, True),
    "ivae_rts": ("iVAE", dict(latent_dim=2, invariances=["r", "t", "s"]), 0,
                 True),
    "cvae": ("iVAE", dict(latent_dim=2, c_dim=3), 3, False),
    "ssivae_r": ("ssiVAE", dict(latent_dim=2, num_classes=3,
                                invariances=["r"]), 3, True),
}


def _x(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n,) + DATA).astype(np.float32)


def _injected(name, decoder=True):
    """A JAX model and the port's with the same custom nets, the JAX
    weights carried across."""
    model, kw, c, spatial = CASES[name]
    jm = getattr(jmodels, model)(DATA, seed=2, hidden_dim_e=(16,),
                                 hidden_dim_d=(16,), **kw)
    tm = getattr(tmodels, model)(DATA, device="cpu", hidden_dim_e=(16,),
                                 hidden_dim_d=(16,), **kw)
    jm.set_encoder((JCondEncoder if c else JEncoder)(jm.z_dim))
    tm.set_encoder((TCondEncoder if c else TEncoder)(int(np.prod(DATA)) + c,
                                                     tm.z_dim))
    if decoder:
        zc = tm.latent_dim + c
        jm.set_decoder(JSpatialDecoder() if spatial else JPlainDecoder())
        tm.set_decoder(TSpatialDecoder(zc) if spatial else TPlainDecoder(zc))
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm, c


def _labels(c, seed=1, n=B):
    if c == 0:
        return None
    return np.eye(c, dtype=np.float32)[np.random.default_rng(seed).integers(
        0, c, n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_custom_nets_match_jax(name):
    """encode, a posed decode and the per-example loss (labeled for the
    semi-supervised model, conditioned for the cVAE) with the same custom
    nets and weights, and the model's noise drawn as JAX draws it."""
    jm, tm, c = _injected(name)
    assert jm._fused is False and tm._fused is False
    x, y = _x(), _labels(c)
    enc = tm.encode(x, y) if c else tm.encode(x)
    jenc = jm.encode(x, y) if c else jm.encode(x)
    for a, b in zip(enc, jenc):
        np.testing.assert_allclose(as_numpy(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    z = np.random.default_rng(3).normal(size=(4, tm.latent_dim)).astype(
        np.float32)
    yz = _labels(c, seed=4, n=4)
    pose = dict(angle=0.4, shift=0.1) if CASES[name][3] else {}
    if name == "ssivae_r":
        dec, jdec = tm.decode(z, yz, **pose), jm.decode(z, yz, **pose)
    elif c:
        dec, jdec = tm.decode(z, yz), jm.decode(z, yz)
    else:
        dec, jdec = tm.decode(z, **pose), jm.decode(z, **pose)
    np.testing.assert_allclose(as_numpy(dec), np.asarray(jdec), atol=ATOL,
                               rtol=RTOL)

    key = jax.random.PRNGKey(5)
    (shape,) = tm.noise_shapes(B, labeled=True)
    eps = np.array(jax.random.normal(key, shape))
    batch = (jnp.asarray(x),) + (() if y is None else (jnp.asarray(y),))
    ref = jm.loss_fn(jm.params, key, batch, jnp.float32(0.7))
    ours = tm.loss_fn(x, y, beta=0.7, eps=eps)
    np.testing.assert_allclose(as_numpy(ours), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _count_kernel_routes(monkeypatch):
    """Counts of the calls routed to the kernels' wrappers from the models."""
    calls = {"sdecoder": 0, "recon_loss": 0}

    def wrap(module, name, key):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)

    wrap(tbase, "apply_fused_sdecoder", "sdecoder")
    wrap(tivae, "apply_fused_recon_loss", "recon_loss")
    return calls


def test_set_decoder_never_routes_to_the_kernels(monkeypatch):
    """After ``set_decoder`` a decode, a loss, a one-pass training step and
    a fit epoch run the new decoder as a module: no call reaches the
    kernels' wrappers. With ``set_encoder`` alone the same calls do."""
    calls = _count_kernel_routes(monkeypatch)
    for decoder in (False, True):
        _, tm, _ = _injected("ivae_r", decoder=decoder)
        tm.one_pass_train = True
        x = _x()
        tm.decode(np.zeros((3, 2), np.float32), angle=0.3)
        tm.loss_fn(x)
        tm.weighted_loss_fn(x, None, torch.ones(B))
        trainer = tm.fit(x, epochs=1, batch_size=B)
        assert np.isfinite(trainer.loss_history["training_loss"][-1])
        if decoder:
            assert calls == {"sdecoder": 0, "recon_loss": 0}, calls
        else:  # decode, loss_fn; the one-pass loss and step
            assert calls == {"sdecoder": 2, "recon_loss": 2}, calls
            calls.update(sdecoder=0, recon_loss=0)


def test_injected_nets_are_drawn_from_the_model_generator():
    """The injected layers are redrawn from the model's generator (the
    same seed gives the same weights, another seed others), on the model's
    device, and torch's global generator is left as it was; lazy layers
    are built by the first call."""
    def weights(seed):
        m = tmodels.iVAE(DATA, 2, ["r"], seed=seed, device="cpu",
                         hidden_dim_e=(16,), hidden_dim_d=(16,))
        enc = TEncoder(int(np.prod(DATA)), m.z_dim)
        state = torch.random.get_rng_state()
        m.set_encoder(enc)
        assert torch.equal(state, torch.random.get_rng_state())
        return m.nets["encoder_z"].Dense_0.weight.detach().clone()

    assert torch.equal(weights(3), weights(3))
    assert not torch.equal(weights(3), weights(4))

    class LazyEncoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tnn.get_conv(2)(4)
            self.head = nn.LazyLinear(4)

        def forward(self, x):
            h = self.conv(x.movedim(-1, 1)).flatten(1)
            out = self.head(h)
            return out[:, :2], F.softplus(out[:, 2:])

    ved = tmodels.VED(DATA, (16,), device="cpu", hidden_dim_e=((4,), (8,)),
                      hidden_dim_d=((8,), (4,)))
    ved.set_encoder(LazyEncoder())
    assert ved.encoder_net.head.weight.shape == (4, 4 * 64)
    loc, scale = ved.encode(_x())
    assert loc.shape == (B, 2) and bool((scale > 0).all())


# ---------------------------------------------------------------------------
# The layer factories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,size,kernel,stride", [
    (1, (9,), 3, 1), (1, (10,), 3, 2), (2, (8, 9), 3, 1), (2, (8, 8), 3, 2),
    (2, (7, 10), 5, 2), (3, (5, 6, 4), 3, 2)])
def test_get_conv_matches_jax(dim, size, kernel, stride):
    """``get_conv(dim)(features, kernel_size, stride)`` with XLA's
    ``"SAME"`` padding: the flax conv's output on the same input and
    weights, channels-first."""
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(2,) + size + (3,)).astype(np.float32)
    jconv = jnn.get_conv(dim)(5, kernel, stride)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = tnn.get_conv(dim)(5, kernel, stride)
    out = conv(torch.from_numpy(x).movedim(-1, 1))  # builds the lazy conv
    k = np.asarray(params["params"]["kernel"])  # [*K, I, O]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            k.transpose((dim + 1, dim) + tuple(range(dim))))))
        conv.bias.copy_(torch.from_numpy(np.asarray(
            params["params"]["bias"])))
        out = conv(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(as_numpy(out.movedim(1, -1)), ref, atol=ATOL,
                               rtol=RTOL)


def test_get_conv_valid_and_explicit_padding():
    x = torch.zeros(1, 2, 9, 9)
    assert tnn.get_conv(2)(4, padding="VALID")(x).shape == (1, 4, 7, 7)
    assert tnn.get_conv(2)(4, 3, 1, 1)(x).shape == (1, 4, 9, 9)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_get_maxpool_and_bnorm_match_jax(dim):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(2,) + (4,) * dim + (3,)).astype(np.float32)
    ref = np.asarray(jnn.get_maxpool(dim)(jnp.asarray(x)))
    out = tnn.get_maxpool(dim)(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_array_equal(as_numpy(out.movedim(1, -1)), ref)

    jbn = jnn.get_bnorm(dim)(use_running_average=False)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, _ = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tnn.get_bnorm(dim)(3)
    assert isinstance(bn, BatchNorm)
    out = bn(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(as_numpy(out.movedim(1, -1)), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("factory", ["get_bnorm", "get_conv", "get_maxpool"])
def test_factories_reject_other_dims(factory):
    for dim in (0, 4):
        with pytest.raises(KeyError):
            getattr(jnn, factory)(dim)
        with pytest.raises(KeyError):
            getattr(tnn, factory)(dim)


def test_concat_features_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 2)).astype(np.float32)
    b = rng.normal(size=(1, 4)).astype(np.float32)
    img = rng.normal(size=(3, 1, 2, 2)).astype(np.float32)
    for args in ([a, b], [a, img], [b[None], a[None]]):
        ref = np.asarray(jnn.concat_features([jnp.asarray(v) for v in args]))
        got = tnn.concat_features([torch.from_numpy(v) for v in args])
        np.testing.assert_array_equal(as_numpy(got), ref)
        got = tnn.Concat()([torch.from_numpy(v) for v in args])
        np.testing.assert_array_equal(as_numpy(got), ref)
    t = torch.from_numpy(a)
    assert tnn.concat_features(t) is t
