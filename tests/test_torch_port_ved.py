"""Port parity for VED (``pyroved_tpu_torch/models/ved.py``): the
per-example loss and its grads, encode, decode, predict and manifold2d,
three ``SVItrainer`` epochs with a held-out set, and the bf16 conv towers,
against the JAX package's VED on the same weights (``load_jax_params``),
pairs and noise, on the CPU; the golden VED band on the port alone; and the
``plot`` default of every family. The conv modules themselves are held
against flax in ``test_torch_port_conv.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

# The port's f32 tolerances (PERF.md section 2).
ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
# Per-epoch losses after 3 epochs of Adam steps (12 steps), each step's
# grads within the tolerance above: the trajectories part by ~1e-6.
EPOCH_RTOL = 1e-5
# bf16 towers against the JAX package's bf16 towers: both round the same
# activations to bf16, but an f32 sum before a rounding runs in another
# order, so a value within an f32 rounding of a bf16 boundary rounds to
# either neighbour (2^-8 relative), and the flips propagate through the
# towers (and batchnorm, over a batch of 8, amplifies them). Measured on
# the cases below, against JAX's bf16 / against JAX's f32:
#   without batchnorm: per-example losses 2.7e-6 / 6.2e-5 relative, encode
#     4.0e-4 / 5.0e-3 of the largest entry, decode 2.1e-5 / 6.4e-5;
#   with batchnorm: losses 2.1e-4 / 8.4e-4, encode 8.3e-3 / 1.2e-2;
#   grads up to 3.3e-2 of the model's largest grad entry either way (the
#     flips are as large as the rounding itself, so grads hold the port to
#     bf16's size only).
# The bounds sit between the two columns: the port's bf16 passes them
# against JAX's bf16 and misses them against JAX's f32.
BF16_TOL = {False: dict(loss=2e-5, out=2e-3, grad=5e-2),
            True: dict(loss=5e-4, out=2e-2, grad=5e-2)}

SMALL = dict(hidden_dim_e=((4,), (8,)), hidden_dim_d=((8,), (4,)))
B = 4
PAIRS = [((16, 16), (32,)), ((32,), (16, 16)), ((16, 16), (16, 16)),
         ((32,), (32,))]


def _pair(in_dim, out_dim, seed=3, **kw):
    """A JAX VED and the port's, holding the same weights."""
    jm = jmodels.VED(in_dim, out_dim, latent_dim=2, seed=seed, **SMALL, **kw)
    tm = tmodels.VED(in_dim, out_dim, latent_dim=2, device="cpu", **SMALL,
                     **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _xy(in_dim, out_dim, n=B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n,) + in_dim).astype(np.float32),
            rng.uniform(0, 1, (n,) + out_dim).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_loss_grads(jm, x, y, key, beta, w):
    batch = (jnp.asarray(x), jnp.asarray(y))
    per = jax.jit(lambda p: jm.loss_fn(p, key, batch, beta))
    ref = per(jm.params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(per(p) * w)))(jm.params)
    return ref, from_jax_params(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_grads(tm, x, y, eps, beta, w):
    tm.nets.zero_grad(set_to_none=True)
    per = tm.loss_fn(x, y, beta, eps=eps)
    torch.sum(per * _t(w)).backward()
    return per, {n: p.grad for n, p in tm.nets.named_parameters()}


W = np.array([1.0, 1.0, 0.5, 0.0], np.float32)


@pytest.mark.parametrize("in_dim,out_dim,kw", [
    *[(i, o, {}) for i, o in PAIRS],
    ((16, 16), (32,), dict(batchnorm=True, pool="stride", conv_first=True)),
    ((32,), (16, 16), dict(batchnorm=True, pool="avg",
                           sampler_d="gaussian", decoder_sig=0.3))],
    ids=["im2spec", "spec2im", "im2im", "spec2spec", "im2spec_bn_stride",
         "spec2im_bn_avg_gaussian"])
def test_ved_loss_and_grads_match_jax(in_dim, out_dim, kw):
    """Two particles and the analytic KL: noise [2, B, 2], the decoder on
    2B rows (its batchnorm over all of them)."""
    jm, tm = _pair(in_dim, out_dim, num_particles=2, kl="analytic", **kw)
    x, y = _xy(in_dim, out_dim)
    key = jax.random.PRNGKey(5)
    ref, ref_grads = _ref_loss_grads(jm, x, y, key, jnp.float32(0.7), W)
    (shape,) = tm.noise_shapes(B)
    assert shape == (2, B, 2)
    per, grads = _port_loss_grads(tm, x, y, _t(jax.random.normal(key, shape)),
                                  0.7, W)
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref), rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(ref_grads)
    for name, r in ref_grads.items():
        np.testing.assert_allclose(as_numpy(grads[name]), r.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    # the trainer's scalar is the weighted sum
    wl = tm.weighted_loss_fn(x, y, _t(W), 0.7, eps=_t(jax.random.normal(
        key, shape)))
    np.testing.assert_allclose(wl.item(), float(np.sum(np.asarray(ref) * W)),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("bn", [False, True], ids=["plain", "batchnorm"])
def test_ved_encode_decode_predict_manifold_match_jax(bn):
    """Channel-less inputs get a singleton channel; single-channel outputs
    lose it. ``predict`` decodes S*B rows in one call, with the JAX draw
    injected; ``batch_size`` chunks encode and decode (each chunk its own
    batchnorm statistics, on both sides)."""
    jm, tm = _pair((16, 16), (32,), batchnorm=bn)
    x, _ = _xy((16, 16), (32,), n=6, seed=1)
    for o, r in zip(tm.encode(x), jm.encode(x)):
        np.testing.assert_allclose(as_numpy(o), np.asarray(r), atol=ATOL)
    for o, r in zip(tm.encode(x[..., None], batch_size=4),
                    jm.encode(x[..., None], batch_size=4)):
        np.testing.assert_allclose(as_numpy(o), np.asarray(r), atol=ATOL)
    z = np.random.default_rng(2).normal(size=(5, 2)).astype(np.float32)
    out = tm.decode(z)
    assert out.shape == (5, 32)
    np.testing.assert_allclose(as_numpy(out), np.asarray(jm.decode(z)),
                               atol=ATOL)
    np.testing.assert_allclose(as_numpy(tm.decode(z, batch_size=2)),
                               np.asarray(jm.decode(z, batch_size=2)),
                               atol=ATOL)
    key = jax.random.PRNGKey(11)
    jm.next_rng = lambda: key
    mean, std = tm.predict(x, num_samples=7,
                           eps=_t(jax.random.normal(key, (7, 6, 2))))
    ref_mean, ref_std = jm.predict(x, num_samples=7)
    assert mean.shape == std.shape == (6, 32)
    np.testing.assert_allclose(as_numpy(mean), np.asarray(ref_mean),
                               atol=ATOL)
    np.testing.assert_allclose(as_numpy(std), np.asarray(ref_std), atol=ATOL)
    np.testing.assert_allclose(
        as_numpy(tm.manifold2d(3, plot=False)),
        np.asarray(jm.manifold2d(3, plot=False)), atol=ATOL)


def test_ved_manifold_plane_and_multichannel_match_jax():
    """``which_dims``/``z_fixed`` and ``z_coord`` on a 3-D latent; two
    input and two output channels keep their trailing channel axis."""
    kw = dict(latent_dim=3, input_channels=2, output_channels=2, seed=4,
              **SMALL)
    jm = jmodels.VED((32,), (16,), **kw)
    tm = tmodels.VED((32,), (16,), device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    opts = dict(which_dims=(0, 2), z_fixed=[0.0, 0.5, 0.0],
                z_coord=[-1.0, 1.0, -2.0, 2.0])
    out = tm.manifold2d(3, plot=False, **opts)
    assert out.shape == (9, 16, 2)
    np.testing.assert_allclose(as_numpy(out), np.asarray(
        jm.manifold2d(3, plot=False, **opts)), atol=ATOL)
    x = np.random.default_rng(3).uniform(0, 1, (3, 32, 2)).astype(np.float32)
    for o, r in zip(tm.encode(x), jm.encode(x)):
        np.testing.assert_allclose(as_numpy(o), np.asarray(r), atol=ATOL)


class _InjectedSVItrainer(SVItrainer):
    """The port's trainer drawing the JAX trainer's noise: per epoch one
    split of the key for the training steps and one for the evaluation,
    and fold_in(epoch key, step) for each step."""

    def __init__(self, model, seed, steps, test_steps, **kw):
        super().__init__(model, **kw)
        key, self._queue = jax.random.PRNGKey(seed), []
        self._shape = model.noise_shapes(0)[0][:-2]
        self._plan = []
        for _ in range(8):
            for n in (steps, test_steps):
                key, ek = jax.random.split(key)
                self._plan.append((ek, n))

    def _noise(self, batch_size: int):
        if not self._queue:
            ek, n = self._plan.pop(0)
            shape = self._shape + (batch_size, self.model.z_dim)
            self._queue = [_t(jax.random.normal(jax.random.fold_in(ek, i),
                                                shape)) for i in range(n)]
        return self._queue.pop(0)


def test_ved_trainer_epochs_with_test_pairs_match_jax():
    """Three epochs at ``scale_factor=4`` with a held-out set of pairs
    (each epoch 4 steps, the last batch padded, then 2 evaluation steps),
    the JAX trainer's noise injected: per-epoch training and test losses,
    and the trained parameters."""
    jm, tm = _pair((16, 16), (32,), seed=6)
    x, y = _xy((16, 16), (32,), n=56, seed=4)
    xt, yt = _xy((16, 16), (32,), n=24, seed=5)
    jtrainer = JSVItrainer(jm, seed=9)
    jl = jinit_dataloader(x, y, batch_size=16, seed=3)
    jt = jinit_dataloader(xt, yt, batch_size=16, seed=3)
    for _ in range(3):
        jtrainer.step(jl, jt, scale_factor=4.0)
    trainer = _InjectedSVItrainer(tm, 9, 4, 2)
    loader = init_dataloader(x, y, batch_size=16, seed=3, device="cpu")
    test_loader = init_dataloader(xt, yt, batch_size=16, seed=3,
                                  device="cpu")
    losses = trainer.run(loader, 3, scale_factor=4.0, test_loader=test_loader)
    ref = jtrainer.loss_history
    np.testing.assert_allclose(losses, ref["training_loss"], rtol=EPOCH_RTOL)
    np.testing.assert_allclose(trainer.loss_history["test_loss"],
                               ref["test_loss"], rtol=EPOCH_RTOL)
    assert losses[-1] < losses[0]
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), params[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)


def _bf16_misses(tm, jref, x, y, key, bn):
    """The port's bf16 outputs and grads beyond the bf16 bounds, against
    the JAX model ``jref``."""
    tol = BF16_TOL[bn]
    w = np.ones(x.shape[0], np.float32)
    eps = _t(jax.random.normal(key, (x.shape[0], 2)))
    per, grads = _port_loss_grads(tm, x, y, eps, 1.0, w)
    ref, ref_grads = _ref_loss_grads(jref, x, y, key, jnp.float32(1.0), w)
    misses = []
    rel = np.max(np.abs(as_numpy(per) - np.asarray(ref))
                 / np.abs(np.asarray(ref)))
    if rel > tol["loss"]:
        misses.append(("loss", rel))
    z = np.random.default_rng(1).normal(size=(16, 2)).astype(np.float32)
    for what, o, r in (*zip(("z_loc", "z_scale"), tm.encode(x),
                            jref.encode(x)),
                       ("decode", tm.decode(z), jref.decode(z))):
        err = np.abs(as_numpy(o) - np.asarray(r)).max()
        if err > tol["out"] * np.abs(np.asarray(r)).max():
            misses.append((what, err))
    gmax = max(np.abs(r.numpy()).max() for r in ref_grads.values())
    for name, r in ref_grads.items():
        err = np.abs(as_numpy(grads[name]) - r.numpy()).max()
        if err > tol["grad"] * gmax:
            misses.append((name, err / gmax))
    return misses


@pytest.mark.parametrize("in_dim,out_dim,bn", [
    ((16, 16), (32,), False), ((32,), (32,), False), ((32,), (16, 16), True)],
    ids=["im2spec", "spec2spec", "spec2im_bn"])
def test_ved_bf16_towers_match_jax_bf16(in_dim, out_dim, bn):
    """``compute_dtype="bfloat16"``: the conv towers in bf16, the heads in
    f32, on both sides; held to the bf16 bounds, which the port's bf16
    misses against the JAX package's f32."""
    jm, tm = _pair(in_dim, out_dim, compute_dtype="bfloat16", batchnorm=bn)
    j32 = jmodels.VED(in_dim, out_dim, latent_dim=2, seed=3, batchnorm=bn,
                      **SMALL)
    x, y = _xy(in_dim, out_dim, n=8, seed=6)
    key = jax.random.PRNGKey(7)
    assert _bf16_misses(tm, jm, x, y, key, bn) == []
    assert _bf16_misses(tm, j32, x, y, key, bn) != []
    out = tm.decode(np.zeros((2, 2), np.float32))
    assert out.dtype == torch.float32  # the observation head stays f32


def test_golden_ved_band_on_the_port():
    """The JAX package's golden VED configuration (12x12 images to 16-long
    spectra, default filters, 192 pairs, batch 64, 5 epochs) trained with
    the port's own weights and noise lands in the same 7-11 band."""
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, 192)
    xr = (xx[None] * np.cos(th)[:, None, None]
          - yy[None] * np.sin(th)[:, None, None])
    X = np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(np.float32)
    spec = np.stack([np.exp(-(np.linspace(-1, 1, 16) - (a / np.pi - 1)) ** 2
                            / 0.1) for a in th]).astype(np.float32)
    m = tmodels.VED((12, 12), (16,), latent_dim=2, seed=1, device="cpu")
    t = SVItrainer(m, seed=1)
    losses = t.run(init_dataloader(X, spec, batch_size=64, seed=1,
                                   device="cpu"), 5)
    assert 7.0 < losses[-1] < 11.0, losses
    assert losses[0] > losses[-1]


def test_ved_fit_and_keywords():
    """``fit`` on pairs with held-out pairs; bad keywords raise."""
    m = tmodels.VED((16, 16), (32,), device="cpu", **SMALL)
    x, y = _xy((16, 16), (32,), n=16)
    tr = m.fit(x, y, epochs=2, batch_size=8, test_data=(x[:8], y[:8]))
    assert len(tr.loss_history["training_loss"]) == 2
    assert len(tr.loss_history["test_loss"]) == 2
    with pytest.raises(ValueError, match="compute_dtype"):
        tmodels.VED((16, 16), (32,), device="cpu", compute_dtype="fp8")
    with pytest.raises(ValueError, match="pool"):
        tmodels.VED((16, 16), (32,), device="cpu", pool="min")
    with pytest.raises(TypeError, match="bogus"):
        tmodels.VED((16, 16), (32,), device="cpu", bogus=1)
    with pytest.raises(NotImplementedError, match="upsampling mode"):
        tmodels.VED((16, 16), (32,), device="cpu").nets["decoder"].__class__(
            (32,), upsampling_mode="cubic")


@pytest.mark.parametrize("family", ["iVAE", "jiVAE", "ssiVAE", "ss_reg_iVAE",
                                    "VED"])
def test_plot_default_raises_naming_viz(family, monkeypatch):
    """``plot`` defaults to True, as in the JAX package: a default call
    plots (it once raised naming 'viz', before the plots were ported; the
    arguments of each plot are held against the JAX package's in
    tests/test_torch_port_viz.py), and ``plot=False`` decodes without a
    figure."""
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda: None)
    plt.close("all")
    args = {"iVAE": ((12, 12),), "jiVAE": ((12, 12), 2, 3),
            "ssiVAE": ((12, 12), 2, 3), "ss_reg_iVAE": ((12, 12), 2, 1),
            "VED": ((16, 16), (32,))}[family]
    kw = {} if family == "VED" else dict(invariances=["r"])
    m = getattr(tmodels, family)(*args, device="cpu", **kw)
    call = ((lambda **k: m.manifold2d(3, np.zeros(1, np.float32), **k))
            if family == "ss_reg_iVAE" else (lambda **k: m.manifold2d(3, **k)))
    assert call(plot=False).shape[0] == 9
    assert not plt.get_fignums()
    assert call().shape[0] == 9
    assert len(plt.get_fignums()) == 1
    if hasattr(m, "manifold_traversal"):
        assert m.manifold_traversal(3, 0).shape[0] == 9
        assert len(plt.get_fignums()) == 2
    plt.close("all")
