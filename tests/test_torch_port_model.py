"""Port parity at the model and serving level: ``pyroved_tpu_torch``'s
iVAE and ServedModel against the JAX package's on the same weights and
inputs, on the CPU (where the port's fused decode runs its plain
version)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.serving as jserving
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.serving as tserving
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import as_numpy

from torch_port_ranks import one_rank_mesh

# outputs: f32 on the CPU, sums in another order; per-example losses sum
# hundreds of pixel terms, so they are compared relatively
ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU module
    path computes them, for the whole module (before any module-scoped
    fixture computes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield

CONFIGS = {
    "rot": dict(data_dim=(12, 12), invariances=["r"]),
    "rts_cond": dict(data_dim=(12, 12), invariances=["r", "t", "s"], c_dim=2),
    "1d_t": dict(data_dim=(40,), invariances=["t"]),
    "plain": dict(data_dim=(12, 12), invariances=None),
}


def _pair(cfg, seed=3, **kw):
    """A JAX iVAE and the port's iVAE holding the same weights."""
    jm = jmodels.iVAE(seed=seed, **cfg, **kw)
    tm = tmodels.iVAE(device="cpu", **cfg, **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _data(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B,) + cfg["data_dim"]).astype(np.float32)
    c = cfg.get("c_dim", 0)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, B)] if c else None
    return x, y


def _close(ours, ref, atol=ATOL):
    ours, ref = as_numpy(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=atol)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    return (cfg,) + _pair(cfg)


def test_encode_matches_jax(pair):
    cfg, jm, tm = pair
    x, y = _data(cfg, 7)
    for o, r in zip(tm.encode(x, y), jm.encode(x, y)):
        _close(o, r)
    # chunked encode gives the same rows
    for o, r in zip(tm.encode(x, y, batch_size=3), jm.encode(x, y)):
        _close(o, r)


def test_posed_decode_matches_jax(pair):
    cfg, jm, tm = pair
    rng = np.random.default_rng(1)
    z = rng.normal(size=(5, 2)).astype(np.float32)
    _, y = _data(cfg, 5)
    for pose in ({}, {"angle": 0.7}, {"shift": 0.2},
                 {"angle": 0.3, "shift": (0.1, -0.05), "scale": 1.1}):
        if cfg["data_dim"] == (40,) and isinstance(pose.get("shift"), tuple):
            pose = dict(pose, shift=0.1)
        _close(tm.decode(z, y, **pose), jm.decode(z, y, **pose))
    _close(tm.decode(z, y, angle=0.5, batch_size=2), jm.decode(z, y, angle=0.5))


def test_reconstruct_and_manifold_match_jax(pair):
    cfg, jm, tm = pair
    x, y = _data(cfg, 6)
    _close(tm.reconstruct(x, y), jm.reconstruct(x, y))
    yc = None if y is None else y[0]
    _close(tm.manifold2d(4, y=yc, plot=False),
           jm.manifold2d(4, y=yc, plot=False))


def test_loss_fn_matches_jax(pair):
    cfg, jm, tm = pair
    x, y = _data(cfg, 8)
    rng = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(rng, (8, jm.z_dim)))  # what JAX draws
    batch = (jnp.asarray(x),) if y is None else (jnp.asarray(x), jnp.asarray(y))
    ref = jm.loss_fn(jm.params, rng, batch, jnp.float32(0.5))
    ours = tm.loss_fn(x, y, beta=0.5, eps=eps)
    assert ours.shape == (8,)
    np.testing.assert_allclose(as_numpy(ours), np.asarray(ref), rtol=LOSS_RTOL)


def test_loss_fn_particles_and_analytic_kl_match_jax():
    cfg = CONFIGS["rot"]
    jm, tm = _pair(cfg, num_particles=3, kl="analytic")
    x, _ = _data(cfg, 4)
    rng = jax.random.PRNGKey(2)
    eps = np.array(jax.random.normal(rng, (3, 4, jm.z_dim)))
    ref = jm.loss_fn(jm.params, rng, (jnp.asarray(x),), jnp.float32(1.0))
    np.testing.assert_allclose(as_numpy(tm.loss_fn(x, eps=eps)),
                               np.asarray(ref), rtol=LOSS_RTOL)


def test_padded_width_gelu_gaussian_model_matches_jax():
    """hidden (192, 256) pads to the kernel width 256; latent_dim 3 sweeps
    the manifold over chosen dims."""
    cfg = dict(data_dim=(10, 10), invariances=["r", "s"], latent_dim=3,
               hidden_dim_d=(192, 256), activation="gelu",
               sampler_d="gaussian", decoder_sig=0.3, sigmoid_d=False)
    jm, tm = _pair(cfg)
    assert tm._fused
    x, _ = _data(cfg, 5)
    rng = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(rng, (5, jm.z_dim)))
    ref = jm.loss_fn(jm.params, rng, (jnp.asarray(x),), jnp.float32(1.0))
    np.testing.assert_allclose(as_numpy(tm.loss_fn(x, eps=eps)),
                               np.asarray(ref), rtol=LOSS_RTOL)
    kw = dict(which_dims=(2, 0), z_fixed=[0.3, -0.2, 0.1])
    _close(tm.manifold2d(3, plot=False, **kw),
           jm.manifold2d(3, plot=False, **kw))
    z = np.random.default_rng(6).normal(size=(4, 3)).astype(np.float32)
    _close(tm.decode(z, angle=-0.4, scale=0.9), jm.decode(z, angle=-0.4,
                                                          scale=0.9))


@pytest.mark.parametrize("hidden", [(96, 160), (128, 256)])
def test_decoder_padded_to_256_runs_fused_and_matches_jax(hidden):
    """Decoders whose widths pad to 256 take the fused path whatever the
    padding costs, and match the JAX package (which decodes through XLA)."""
    cfg = dict(data_dim=(12, 12), invariances=["r"], hidden_dim_d=hidden)
    jm, tm = _pair(cfg)
    assert tm._fused
    x, _ = _data(cfg, 5)
    z = np.random.default_rng(7).normal(size=(4, 2)).astype(np.float32)
    _close(tm.decode(z, angle=0.4, shift=(0.1, 0.0), scale=1.2),
           jm.decode(z, angle=0.4, shift=(0.1, 0.0), scale=1.2))
    _close(tm.reconstruct(x), jm.reconstruct(x))
    rng = jax.random.PRNGKey(9)
    eps = np.array(jax.random.normal(rng, (5, jm.z_dim)))
    ref = jm.loss_fn(jm.params, rng, (jnp.asarray(x),), jnp.float32(1.0))
    np.testing.assert_allclose(as_numpy(tm.loss_fn(x, eps=eps)),
                               np.asarray(ref), rtol=LOSS_RTOL)


def test_spatial_decodes_go_through_the_fused_wrapper(monkeypatch):
    """Every spatial decode of the serving path calls the kernel's wrapper
    (on the CPU, its plain version): the requests at their power-of-two
    buckets (3 and 5 rows at 8, manifold2d's 9 at 16), the loss at its
    batch's rows."""
    calls = []
    real = tsd.fused_spatial_decoder_forward

    def spy(*a, **k):
        calls.append(a[4].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tsd, "fused_spatial_decoder_forward", spy)
    cfg = CONFIGS["rot"]
    _, tm = _pair(cfg)
    assert tm._fused
    x, _ = _data(cfg, 5)
    tm.decode(np.zeros((3, 2), np.float32))
    tm.reconstruct(x)
    tm.manifold2d(3, plot=False)
    tm.loss_fn(x)
    assert calls == [8, 8, 16, 5]


def test_device_rule_and_later_slices(tmp_path, monkeypatch):
    """The device rule; the features of the later slices run (int8
    export, the default plot, ``pixel_chunks``; each held against the JAX
    package in tests/test_torch_port_quant.py, _viz.py and
    _pixel_chunks.py); ``fit(mesh=...)`` takes a DeviceMesh (held against
    the JAX mesh in tests/test_torch_port_parallel.py): anything else is a
    TypeError naming it, and a one-rank mesh reaches the trainer."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    import matplotlib.pyplot as plt
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.iVAE((12, 12), invariances=["r"])
    tm = tmodels.iVAE((12, 12), invariances=["r"], device="cpu")
    path = str(tmp_path / "m.npz")
    tserving.export_model(tm, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.ServedModel(path)
    tserving.export_model(tm, path, quantize="int8")
    assert tserving.ServedModel(path, device="cpu").quantize == "int8"
    # patience is ported: it needs held-out data to watch
    with pytest.raises(ValueError, match="test_data"):
        tm.fit(np.zeros((4, 12, 12), np.float32), patience=2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.fit(np.zeros((4, 12, 12), np.float32), mesh=object())
    with one_rank_mesh() as mesh:
        tr = tm.fit(np.zeros((4, 12, 12), np.float32), epochs=1,
                    batch_size=4, mesh=mesh)
        assert tr.mesh is mesh and tr.current_epoch == 1
    monkeypatch.setattr(plt, "show", lambda: None)
    assert tm.manifold2d(3, plot=True).shape == (9, 12, 12)
    assert plt.get_fignums()
    plt.close("all")
    chunked = tmodels.iVAE((12, 12), invariances=["r"], device="cpu",
                           pixel_chunks=4)
    assert chunked._pixel_mode() == "chunk"
    with pytest.raises(ValueError, match="spatial decoder"):
        tmodels.iVAE((12, 12), device="cpu", pixel_chunks=4)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    cfg = CONFIGS["rot"]
    jm, tm = _pair(cfg, seed=5)
    d = tmp_path_factory.mktemp("serve")
    out = {}
    for bs in (None, 8):
        jpath, tpath = str(d / f"j{bs}.pvtx"), str(d / f"t{bs}.npz")
        jserving.export_model(jm, jpath, batch_size=bs)
        tserving.export_model(tm, tpath, batch_size=bs)
        out[bs] = (jserving.ServedModel(jpath),
                   tserving.ServedModel(tpath, device="cpu"), tpath)
    return out


@pytest.mark.parametrize("bs", [None, 8])
def test_served_encode_matches_jax_on_ragged_requests(served_pair, bs):
    js, ts, _ = served_pair[bs]
    x = np.random.default_rng(2).uniform(0, 1, (1100, 12, 12)).astype(np.float32)
    for n in ((1, 13, 1100) if bs is None else (1, 13)):
        for o, r in zip(ts.encode(x[:n]), js.encode(x[:n])):
            _close(o, r)


@pytest.mark.parametrize("bs", [None, 8])
def test_served_posed_decode_matches_jax(served_pair, bs):
    js, ts, _ = served_pair[bs]
    z = np.random.default_rng(3).normal(size=(13, 2)).astype(np.float32)
    for pose in ({}, {"angle": 0.3, "shift": (0.1, -0.05), "scale": 1.1}):
        _close(ts.decode(z, **pose), js.decode(z, **pose))


def test_served_ragged_decode_chunks_at_max_bucket(served_pair, monkeypatch):
    js, ts, _ = served_pair[None]
    calls = []
    real = tsd.fused_spatial_decoder_forward

    def spy(*a, **k):
        calls.append(a[4].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tsd, "fused_spatial_decoder_forward", spy)
    z = np.random.default_rng(4).normal(size=(1100, 2)).astype(np.float32)
    _close(ts.decode(z, angle=0.2), js.decode(z, angle=0.2))
    assert calls == [1024, 128]  # the 76-row remainder in its bucket
    calls.clear()
    served8 = served_pair[8][1]
    served8.decode(z[:13])
    assert calls == [8, 8]  # fixed-size archive: chunks padded to 8


def test_port_archive_is_pickle_free(served_pair):
    _, _, path = served_pair[None]
    with np.load(path, allow_pickle=False) as archive:
        arrays = {k: archive[k] for k in archive.files}
    assert "manifest" in arrays
    assert all(a.dtype in (np.float32, np.uint8) for a in arrays.values())
