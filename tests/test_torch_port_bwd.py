"""Port of the fused spatial-decoder backward (K2) and the one-pass
Bernoulli train kernel (K3): the plain PyTorch versions against the JAX
package's Pallas ``_bwd_kernel`` in interpret mode (``_bwd`` and
``_train_call``, called directly), against autograd of the eager
composites, and the autograd Functions against the module path. The CUDA
kernel is held against the plain versions on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.models import iVAE
from pyroved_tpu_torch.nets.fc import init_from, sDecoderNet
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import set_deterministic_mode

# The JAX package's own gradient tolerance (tests/test_ops_fused.py):
# f32 on both sides, sums over up to B*N = 1500 pixels in another order.
ATOL, RTOL = 1e-4, 1e-3
GRADS = ("phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb", "wout", "bout")


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX side here, for the
    whole module (before any module-scoped fixture computes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


@pytest.fixture
def k2_interpret(monkeypatch):
    """Run JAX's _bwd_kernel in interpret mode with f32 matmuls."""
    monkeypatch.setattr(sd, "INTERPRET", True)
    monkeypatch.setattr(sd, "BF16_MATMUL", False)
    monkeypatch.setattr(sd, "ACT_DTYPE", jnp.float32)


def _inputs(D, C, B=5, N=300, hidden=(128, 128), L=4, seed=0):
    """Decoder inputs from numpy, hidden widths zero-padded to the kernel
    width as the models pad them."""
    rng = np.random.default_rng(seed)
    H = -(-max(hidden) // 128) * 128
    widths = (hidden[0],) + tuple(hidden)

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    def f32(a):
        return np.asarray(a, np.float32)

    return dict(
        grid=f32(rng.uniform(-1, 1, (N, D))),
        phi=f32(rng.normal(size=(B,))),
        dx=f32(rng.normal(size=(B, D)) * 0.1),
        sc=f32(1 + 0.1 * rng.normal(size=(B,))),
        z=f32(rng.normal(size=(B, L))),
        Wc=pad(rng.normal(size=(D, hidden[0])) * 0.5, (D, H)),
        bc=pad(rng.normal(size=(hidden[0],)) * 0.1, (H,)),
        Wz=pad(rng.normal(size=(L, hidden[0])) * 0.5, (L, H)),
        hw=np.stack([pad(rng.normal(size=(widths[i], widths[i + 1]))
                         * 1.2 / widths[i] ** 0.5, (H, H))
                     for i in range(len(hidden))]),
        hb=np.stack([pad(rng.normal(size=(widths[i + 1],)) * 0.1, (H,))
                     for i in range(len(hidden))]),
        wout=pad(rng.normal(size=(hidden[-1], C)) / hidden[-1] ** 0.5, (H, C)),
        bout=f32(rng.normal(size=(C,)) * 0.1))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _close(ours, ref, names=GRADS):
    assert len(ours) == len(ref) == len(names)
    for name, o, r in zip(names, ours, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL, err_msg=name)


# (act, D, C): every activation, both coordinate dims, one and three channels
K2_CASES = [("tanh", 2, 1), ("relu", 1, 3), ("lrelu", 2, 3),
            ("softplus", 1, 1), ("gelu", 2, 1), ("tanh_approx", 1, 3)]
# every activation for K3 (one channel), both coordinate dims
K3_CASES = [("tanh", 1), ("relu", 2), ("lrelu", 1), ("softplus", 2),
            ("gelu", 1), ("tanh_approx", 2)]


@pytest.mark.parametrize("act,D,C", K2_CASES)
def test_k2_plain_matches_jax_bwd(k2_interpret, act, D, C):
    a = _inputs(D=D, C=C, seed=len(act))
    g = np.random.default_rng(1).normal(
        size=(5, 300) if C == 1 else (5, 300, C)).astype(np.float32)
    ours = tsd.fused_spatial_decoder_backward(**_torch(a), g=torch.from_numpy(g),
                                              act=act)
    res = tuple(jnp.asarray(a[k]) for k in ("grid",) + GRADS)
    ref = sd._bwd(act, True, res, jnp.asarray(g))
    assert ref[0] is None  # the grid gets no gradient
    _close([o.numpy() for o in ours], ref[1:])


def test_k2_plain_matches_jax_ragged_padded_width_linear_head(k2_interpret):
    # ragged B and N, hidden (96, 160) padded to H = 256, softplus (whose
    # padded lanes carry log 2), no sigmoid
    a = _inputs(D=2, C=3, B=3, N=77, hidden=(96, 160), seed=3)
    g = np.random.default_rng(2).normal(size=(3, 77, 3)).astype(np.float32)
    ours = tsd.spatial_decoder_bwd_plain(**_torch(a), g=torch.from_numpy(g),
                                         act="softplus", sigmoid_out=False)
    res = tuple(jnp.asarray(a[k]) for k in ("grid",) + GRADS)
    _close([o.numpy() for o in ours],
           sd._bwd("softplus", False, res, jnp.asarray(g))[1:])


def _xw(B, N, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, N)).astype(np.float32)
    w = np.ones(B, np.float32)
    w[-1] = 0.0  # a padded row: weight 0
    w[0] = 0.5
    return x, w


@pytest.mark.parametrize("act,D", K3_CASES)
def test_k3_plain_matches_jax_train_call(k2_interpret, act, D):
    a = _inputs(D=D, C=1, seed=10 + len(act))
    x, w = _xw(5, 300)
    t = _torch(a)
    loss, grads = tsd.fused_bernoulli_recon_loss_kernel(
        t["grid"], t["phi"], t["dx"], t["sc"], t["z"], torch.from_numpy(x),
        torch.from_numpy(w), *(t[k] for k in GRADS[4:]), act=act)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref_loss, ref = sd._train_call(
        j["grid"], j["phi"], j["dx"], j["sc"], j["z"], jnp.asarray(x),
        jnp.asarray(w), *(j[k] for k in GRADS[4:]), act)
    assert loss.shape == () and grads[-1].shape == (1,)  # dbout like bout
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    _close([o.numpy() for o in grads[:-1]], ref[:-1], GRADS[:-1])
    np.testing.assert_allclose(grads[-1].numpy(),
                               np.asarray(ref[-1]).reshape(1),
                               atol=ATOL, rtol=RTOL)


def _requiring_grad(a):
    t = {k: torch.from_numpy(v).requires_grad_(k != "grid") for k, v in a.items()}
    return t, [t[k] for k in GRADS]


@pytest.mark.parametrize("act", tsd.KERNEL_ACTS)
def test_k3_plain_matches_autograd_of_eager_composite(act):
    """The plain forward plus the Bernoulli log-prob, differentiated by
    torch.autograd: the same loss and grads (the exact activations, whose
    autograd derivative is the kernel's)."""
    a = _inputs(D=2, C=1, B=4, N=120, seed=5)
    x, w = (torch.from_numpy(v) for v in _xw(4, 120))
    t, params = _requiring_grad(a)
    logit = tsd.spatial_decoder_plain(**t, act=act, sigmoid_out=False)
    ref_loss = -(w[:, None] * (x * logit - torch.nn.functional.softplus(logit))
                 ).sum()
    ref = torch.autograd.grad(ref_loss, params)
    with torch.no_grad():
        loss, grads = tsd.recon_loss_plain(
            t["grid"], *(t[k] for k in GRADS[:4]), x, w,
            *(t[k] for k in GRADS[4:]), act=act)
    np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-5)
    _close([o.numpy() for o in grads], [r.numpy() for r in ref])


@pytest.mark.parametrize("act,D,C", [("softplus", 2, 3), ("relu", 1, 1)])
def test_k2_plain_matches_autograd_of_plain_forward(act, D, C):
    a = _inputs(D=D, C=C, B=4, N=100, seed=6)
    t, params = _requiring_grad(a)
    out = tsd.spatial_decoder_plain(**t, act=act)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, params, g, allow_unused=True)
    ref = [torch.zeros_like(p) if r is None else r for p, r in zip(params, ref)]
    with torch.no_grad():
        ours = tsd.spatial_decoder_bwd_plain(**t, g=g, act=act)
    _close([o.numpy() for o in ours], [r.numpy() for r in ref])


@pytest.mark.parametrize("hidden,act", [((128, 128), "tanh"),
                                        ((96, 160), "softplus"),
                                        ((128, 256), "gelu")])
def test_fused_decoder_autograd_reaches_every_module_parameter(hidden, act):
    """FusedSpatialDecoder on the CPU: grads of every sDecoderNet parameter
    equal autograd of the module on the transformed grid, padded widths
    included (their padded entries' grads are dropped exactly)."""
    dec = init_from(sDecoderNet(2, 3, hidden, act, channels=2),
                    set_deterministic_mode(0))
    rng = np.random.default_rng(1)
    grid = torch.from_numpy(rng.uniform(-1, 1, (60, 2)).astype(np.float32))
    phi, sc = torch.tensor([0.3, -0.7, 1.1]), torch.tensor([1.1, 0.9, 1.0])
    dx = torch.tensor([[0.1, -0.05], [0.0, 0.2], [-0.1, 0.0]])
    z = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 60, 2)).astype(np.float32))
    lat = [t.clone().requires_grad_() for t in (phi, dx, sc, z)]

    out = tsd.apply_fused_sdecoder(dec, grid, *lat, act)
    (out * g).sum().backward()
    fused = {n: p.grad.clone() for n, p in dec.named_parameters()}
    fused_lat = [t.grad.clone() for t in lat]

    dec.zero_grad()
    lat = [t.detach().clone().requires_grad_() for t in lat]
    c, s = torch.cos(lat[0])[:, None], torch.sin(lat[0])[:, None]
    gx, gy = grid[:, 0], grid[:, 1]
    coords = torch.stack([(gx * c - gy * s) * lat[2][:, None] + lat[1][:, :1],
                          (gx * s + gy * c) * lat[2][:, None] + lat[1][:, 1:]],
                         -1)
    (dec(coords, lat[3]) * g).sum().backward()
    for n, p in dec.named_parameters():
        assert fused[n].shape == p.shape
        np.testing.assert_allclose(fused[n].numpy(), p.grad.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=n)
    for o, t in zip(fused_lat, lat):
        np.testing.assert_allclose(o.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_backward_layer_limit_routes_deep_decoders_to_the_module_path(
        monkeypatch):
    """The backward keeps every layer of a tile in shared memory: at most
    5 hidden layers (2 with gelu). A deeper decoder is routed to the
    sDecoderNet module by its configuration, when the model is built."""
    assert tsd.bwd_max_layers("tanh") == 5 and tsd.bwd_max_layers("gelu") == 2
    ok = tsd.sdecoder_supports_fusion
    assert ok((128,) * 5, "relu", True, 1, 1, "cpu")
    assert not ok((128,) * 6, "relu", True, 1, 1, "cpu")
    assert ok((128, 128), "gelu", True, 1, 1, "cpu")
    assert not ok((128,) * 3, "gelu", True, 1, 1, "cpu")
    deep = iVAE((8, 8), invariances=["r"], hidden_dim_d=(128,) * 3,
                activation="gelu", device="cpu")
    assert not deep._fused
    calls = []
    monkeypatch.setattr(tsd, "fused_spatial_decoder_forward",
                        lambda *a, **k: calls.append(a))
    x = np.random.default_rng(0).uniform(0, 1, (2, 8, 8)).astype(np.float32)
    assert torch.isfinite(deep.loss_fn(x)).all()
    assert calls == []  # the module path, not the fused wrapper
    assert iVAE((8, 8), invariances=["r"], hidden_dim_d=(128, 128),
                activation="gelu", device="cpu")._fused


def test_wrappers_run_plain_versions_on_cpu_without_launching():
    t = _torch(_inputs(D=2, C=1, B=3, N=40))
    g = torch.ones(3, 40)
    x, w = torch.full((3, 40), 0.5), torch.ones(3)
    k2 = dict(tsd.fused_spatial_decoder_backward.launches)
    k3 = dict(tsd.fused_bernoulli_recon_loss_kernel.launches)
    grads = tsd.fused_spatial_decoder_backward(**t, g=g)
    for o, r in zip(grads, tsd.spatial_decoder_bwd_plain(**t, g=g)):
        assert torch.equal(o, r)
    args = (t["grid"], *(t[k] for k in GRADS[:4]), x, w,
            *(t[k] for k in GRADS[4:]))
    loss, grads = tsd.fused_bernoulli_recon_loss_kernel(*args)
    ref_loss, ref = tsd.recon_loss_plain(*args)
    assert torch.equal(loss, ref_loss)
    for o, r in zip(grads, ref):
        assert torch.equal(o, r)
    assert tsd.fused_spatial_decoder_backward.launches == k2
    assert tsd.fused_bernoulli_recon_loss_kernel.launches == k3
