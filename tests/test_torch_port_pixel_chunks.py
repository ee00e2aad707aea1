"""The port's pixel-partitioned training (``pixel_chunks=k``: the
reconstruction term over k grid tiles, a pixel count that k does not
divide padded and masked) against the JAX package's chunked loss on the
same weights, noise and batches, and against the port's own full-grid
loss, for iVAE, jiVAE, ssiVAE and ss_reg_iVAE, on the kernels' path (the
wrappers' plain versions on the CPU) and on the module path; then through
the trainers: a ``fit`` trajectory, ``remat``, a flip of ``pixel_chunks``
after a step, ``grad_accum`` with a streaming loader, checkpoints and
``resume``, and ``auxSVItrainer``.

Both sides compute in f32: the port's ``BF16_MATMUL`` is cleared. On the
CPU the JAX package routes its tiles to XLA; one test forces them through
its Pallas kernel in interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseSVI
from torch_port_ranks import one_rank_mesh

# f32 on both sides, sums over pixels, tiles and the batch in another
# order: losses relative, grads and trained parameters as the JAX
# package's own gradient tolerance
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
DATA = (8, 8)  # 64 pixels: k = 3 tiles of 22 with a padded tail of 2
K = 3
B = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these small models run faster
    so, and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _x(shape=(B,) + DATA, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _pair(cls, *args, fused=True, data=DATA, **kw):
    """The JAX model and the port's (its kernels' path or its module path),
    both with ``pixel_chunks=K`` unless ``kw`` says otherwise, holding the
    same weights."""
    kw.setdefault("pixel_chunks", K)
    jm = getattr(jmodels, cls)(data, *args, seed=0, **kw)
    tm = getattr(tmodels, cls)(data, *args, device="cpu", fused=fused, **kw)
    assert tm._fused == fused
    assert tm._pixel_mode() == ("chunk" if kw["pixel_chunks"] > 1 else None)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _check_grads(tm, ref_tree):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree))
    for name, p in tm.nets.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else as_numpy(
            p.grad)
        np.testing.assert_allclose(got, ref[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def _check(jm, tm, batch, eps, beta=1.0, key=jax.random.PRNGKey(7)):
    """The port's chunked per-example loss and grads against the JAX
    package's chunked ones; then the port's chunked loss against its own
    full-grid loss on the same noise."""
    jbeta = (jm.prep_beta(beta) if hasattr(jm, "prep_beta")
             else jnp.asarray(beta, jnp.float32))
    jbatch = tuple(jnp.asarray(b) for b in batch)
    def total(p):
        per = jm.loss_fn(p, key, jbatch, jbeta)
        return jnp.sum(per), per

    ref_grads, ref = jax.grad(total, has_aux=True)(jm.params)
    tm.nets.zero_grad(set_to_none=True)
    y = _t(batch[1]) if len(batch) > 1 else None
    per = tm.loss_fn(_t(batch[0]), y, beta, eps=eps)
    torch.sum(per).backward()
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref),
                               rtol=LOSS_RTOL)
    _check_grads(tm, ref_grads)
    k, tm.pixel_chunks = tm.pixel_chunks, 0
    with torch.no_grad():
        full = tm.loss_fn(_t(batch[0]), y, beta, eps=eps)
    tm.pixel_chunks = k
    np.testing.assert_allclose(as_numpy(per), as_numpy(full),
                               rtol=LOSS_RTOL)


def _noise(key, shape):
    return _t(jax.random.normal(key, shape))


PATHS = [True, False]
PATH_IDS = ["kernels", "module"]


@pytest.mark.parametrize("fused", PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("invariances", [["r"], ["r", "t", "s"], None],
                         ids=["r", "rts", "none"])
def test_ivae_pixel_chunks_loss_and_grads_match_jax(invariances, fused):
    if invariances is None:  # no grid, no pixel axis
        with pytest.raises(ValueError, match="spatial decoder"):
            jmodels.iVAE(DATA, 2, None, pixel_chunks=K, seed=0)
        with pytest.raises(ValueError, match="spatial decoder"):
            tmodels.iVAE(DATA, 2, None, device="cpu", fused=fused,
                         pixel_chunks=K)
        return
    jm, tm = _pair("iVAE", 2, invariances, fused=fused)
    key = jax.random.PRNGKey(7)
    _check(jm, tm, (_x(),), _noise(key, (B, jm.z_dim)), key=key)


def test_ivae_pixel_chunks_jax_tiles_through_pallas(monkeypatch):
    """The JAX package's tiles through its Pallas kernel (interpret mode,
    its gate opened) against the port's through the kernels' wrappers."""
    for name, value in (("INTERPRET", True), ("BF16_MATMUL", False),
                        ("ACT_DTYPE", jnp.float32)):
        monkeypatch.setattr(sd, name, value)
    monkeypatch.setattr(sd, "fused_profitable", lambda *a: True)
    monkeypatch.setattr(sd, "_forward", lambda *a: sd._fwd(*a))
    jm, tm = _pair("iVAE", 2, ["r"])
    jm._fused = True
    key = jax.random.PRNGKey(3)
    _check(jm, tm, (_x(seed=3),), _noise(key, (B, jm.z_dim)), key=key)


def test_ivae_pixel_chunks_1d():
    """24 points in 1-D with a translation, 5 tiles of 5 (one padded)."""
    jm, tm = _pair("iVAE", 2, ["t"], data=(24,), pixel_chunks=5)
    key = jax.random.PRNGKey(1)
    _check(jm, tm, (_x((B, 24), seed=1),), _noise(key, (B, jm.z_dim)),
           key=key)


def test_ivae_pixel_chunks_particles_and_conditional():
    jm, tm = _pair("iVAE", 2, ["r"], c_dim=3, num_particles=3)
    key = jax.random.PRNGKey(2)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1]]
    _check(jm, tm, (_x(seed=2), y), _noise(key, (3, B, jm.z_dim)), key=key)


def test_ivae_pixel_chunks_multichannel():
    jm, tm = _pair("iVAE", 2, ["r"], channels=3)
    key = jax.random.PRNGKey(4)
    _check(jm, tm, (_x((B,) + DATA + (3,), seed=4),),
           _noise(key, (B, jm.z_dim)), key=key)


@pytest.mark.parametrize("fused", PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("topk", [0, 2], ids=["exact", "topk"])
def test_jivae_pixel_chunks_match_jax(topk, fused):
    """The enumerated branches ride as a leading batch dim of every tile:
    4 classes exactly, or the top 2 of 5."""
    ncls = 5 if topk else 4
    jm, tm = _pair("jiVAE", 2, ncls, ["r"], fused=fused, enum_topk=topk)
    key = jax.random.PRNGKey(5)
    _check(jm, tm, (_x(seed=5),), _noise(key, (B, jm.z_dim)),
           beta=[1.0, 0.5], key=key)


@pytest.mark.parametrize("labeled", [False, True],
                         ids=["unlabeled", "labeled"])
def test_ssivae_pixel_chunks_match_jax(labeled):
    jm, tm = _pair("ssiVAE", 2, 3, ["r"])
    key = jax.random.PRNGKey(6)
    batch = (_x(seed=6),)
    if labeled:
        batch += (np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1]],)
    (shape,) = tm.noise_shapes(B, labeled)
    _check(jm, tm, batch, _noise(key, shape), beta=0.8, key=key)


@pytest.mark.parametrize("labeled", [False, True],
                         ids=["unlabeled", "labeled"])
def test_ss_reg_pixel_chunks_match_jax(labeled):
    jm, tm = _pair("ss_reg_iVAE", 2, 2, ["r"])
    key = jax.random.PRNGKey(8)
    batch = (_x(seed=8),)
    if labeled:
        batch += (np.random.default_rng(9).normal(size=(B, 2)).astype(
            np.float32),)
    key_y, key_z = jax.random.split(key)
    shape_y, shape_z = tm.noise_shapes(B, labeled)
    eps = (None if labeled else _noise(key_y, shape_y),
           _noise(key_z, shape_z))
    _check(jm, tm, batch, eps, beta=0.9, key=key)


# ---------------------------------------------------------------------------
# Through the trainers
# ---------------------------------------------------------------------------

def _count_wrappers(monkeypatch):
    """Calls of the K1 and K2 wrappers (their plain versions on the CPU)."""
    calls = {"K1": 0, "K2": 0}
    for k, name in (("K1", "fused_spatial_decoder_forward"),
                    ("K2", "fused_spatial_decoder_backward")):
        fn = getattr(tsd, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tsd, name, counted)
    return calls


def _params(model):
    return [p.detach().clone() for p in model.nets.parameters()]


def _bitwise(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def _check_params(tm, jm):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), ref[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_pixel_chunks_fit_trajectory_matches_jax():
    """Three epochs of ``fit``-sized training (the JAX package's test:
    40 rows, batch 10, ``['r', 't']``, 4 tiles) through both trainers on
    the same noise: per-epoch losses and the trained parameters."""
    X = _x((40,) + DATA, seed=10)
    jm, tm = _pair("iVAE", 2, ["r", "t"], pixel_chunks=4)
    jt, tt = JSVItrainer(jm, seed=2), JaxNoiseSVI(tm, 2)
    ref = jt.run(jinit_dataloader(X, batch_size=10, seed=1), 3)
    got = tt.run(init_dataloader(X, batch_size=10, seed=1, device="cpu"), 3)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    _check_params(tm, jm)


def test_pixel_chunks_compose_with_remat(monkeypatch):
    """On the kernels' path each tile is one K1 forward and one K2
    backward, with no checkpoint of its own: k K1 + k K2 a step. Under
    ``SVItrainer(remat=True)`` the whole loss is recomputed around the
    tiles: 2k K1 + k K2 a step, and the run is bitwise the same."""
    calls = _count_wrappers(monkeypatch)
    X = _x((20,) + DATA, seed=11)
    out = {}
    for remat in (False, True):
        calls.update(K1=0, K2=0)
        m = tmodels.iVAE(DATA, 2, ["r"], device="cpu", pixel_chunks=K)
        t = SVItrainer(m, seed=4, remat=remat)
        losses = t.run(init_dataloader(X, batch_size=10, seed=1,
                                       device="cpu"), 1)
        out[remat] = (losses, _params(m), dict(calls))
    assert out[True][0] == out[False][0]
    _bitwise(out[True][1], out[False][1])
    assert out[False][2] == {"K1": 2 * K, "K2": 2 * K}
    assert out[True][2] == {"K1": 4 * K, "K2": 2 * K}


def test_module_path_rematerializes_each_tile():
    """On the module path each tile runs under a checkpoint when autograd
    is on: its decoder runs again in the backward (2k decoder calls a
    step), so the backward holds one tile's activations at a time; under
    ``torch.no_grad()`` (ELBO scoring) nothing is checkpointed (k)."""
    m = tmodels.iVAE(DATA, 2, ["r"], device="cpu", fused=False,
                     pixel_chunks=K)
    n = [0]
    m.decoder_net.register_forward_hook(lambda *a: n.__setitem__(0, n[0] + 1))
    x, eps = _x(), torch.randn(B, m.z_dim)
    m.loss_fn(x, eps=eps).sum().backward()
    assert n[0] == 2 * K
    n[0] = 0
    with torch.no_grad():
        m.loss_fn(x, eps=eps)
    assert n[0] == K


def test_pixel_chunks_flip_after_a_step_takes_effect():
    """``model.pixel_chunks = 4`` set after the trainers have stepped takes
    effect at the next step in both packages (the JAX trainers rebuild
    their compiled step for it; the port's eager step reads it each time):
    the second epoch's loss agrees, and only it went through the tiles."""
    X = _x((30,) + DATA, seed=12)
    jm, tm = _pair("iVAE", 2, ["r"], pixel_chunks=0)
    tiles = []
    chunked = tm._recon_pixel_chunked
    tm._recon_pixel_chunked = lambda *a: (tiles.append(1), chunked(*a))[1]
    jt, tt = JSVItrainer(jm, seed=1), JaxNoiseSVI(tm, 1)
    jl = jinit_dataloader(X, batch_size=10, seed=1)
    tl = init_dataloader(X, batch_size=10, seed=1, device="cpu")
    ref, got = jt.run(jl, 1), tt.run(tl, 1)
    assert not tiles
    jm.pixel_chunks = tm.pixel_chunks = 4
    ref += jt.run(jl, 1)
    got += tt.run(tl, 1)
    assert len(tiles) == 3 and jt._built_gate[1][0] == "chunk"
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    _check_params(tm, jm)


def test_pixel_chunks_with_grad_accum_streaming_and_resume(tmp_path):
    """A streaming loader at ``grad_accum=2``: the chunked run agrees with
    the full-grid run, and a checkpoint after the first epoch, resumed by
    a fresh model and trainer, gives the uninterrupted run bitwise."""
    X = _x((30,) + DATA, seed=13)

    def run(k, epochs, trainer=None, epoch=0):
        if trainer is None:
            m = tmodels.iVAE(DATA, 2, ["r"], device="cpu", pixel_chunks=k)
            trainer = SVItrainer(m, seed=5, grad_accum=2)
        loader = init_dataloader(X, batch_size=10, seed=1, device="cpu",
                                 device_resident=False)
        loader.set_epoch(epoch)
        return trainer, trainer.run(loader, epochs)

    full, full_losses = run(0, 2)
    whole, losses = run(K, 2)
    np.testing.assert_allclose(losses, full_losses, rtol=LOSS_RTOL)
    first, _ = run(K, 1)
    path = str(tmp_path / "ckpt.npz")
    from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(path, first.model, first)
    m = tmodels.iVAE(DATA, 2, ["r"], device="cpu", pixel_chunks=K, seed=9)
    resumed = SVItrainer(m, seed=7, grad_accum=2)
    assert resumed.resume(path) == 1
    run(K, 1, resumed, epoch=1)
    assert resumed.loss_history == whole.loss_history
    _bitwise(_params(m), _params(whole.model))


def test_pixel_chunks_in_the_aux_trainer():
    """ssiVAE through ``auxSVItrainer`` (unlabeled batches enumerated,
    labeled ones observed) for two epochs: chunked against full grid on
    the same noise; ``mesh=`` takes a DeviceMesh: anything else is a
    TypeError naming it, and a one-rank mesh reaches the trainer."""
    X, Xl = _x((20,) + DATA, seed=14), _x((10,) + DATA, seed=15)
    yl = np.eye(3, dtype=np.float32)[np.arange(10) % 3]
    hist = {}
    for k in (0, K):
        m = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", pixel_chunks=k)
        t = auxSVItrainer(m, seed=3)
        t.run(init_dataloader(X, batch_size=10, seed=1, device="cpu"),
              init_dataloader(Xl, yl, batch_size=5, seed=2, device="cpu"), 2)
        hist[k] = t.history
    np.testing.assert_allclose(hist[K]["training_loss"],
                               hist[0]["training_loss"], rtol=LOSS_RTOL)
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.fit(X, (Xl, yl), epochs=1, batch_size=10, mesh=object())
    with one_rank_mesh() as mesh:
        tr = m.fit(X, (Xl, yl), epochs=1, batch_size=10, mesh=mesh)
        assert tr.mesh is mesh
