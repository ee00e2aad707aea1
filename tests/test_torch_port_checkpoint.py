"""Checkpoints and weights of the port (``pyroved_tpu_torch/utils/
checkpoint.py``, the trainers' ``checkpoint_path`` / ``resume``, and
``save_weights`` / ``load_weights``), on the CPU.

A resumed run is bitwise equal to an uninterrupted one: 4 epochs in one go
against 2 epochs, a save, a load into a fresh model and trainer (other
seeds, so nothing carries over by accident), a loader built afresh at the
saved epoch, and 2 more epochs; for ``SVItrainer`` with iVAE and VED and
for ``auxSVItrainer`` with ssiVAE. The files the JAX package writes, and
the formats the port does not have, are refused whole.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.utils.checkpoint as ckpt
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.serving import export_model
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import (init_dataloader,
                                          init_ssvae_dataloaders)

DATA = (12, 12)
SMALL = dict(hidden_dim_e=((4,), (8,)), hidden_dim_d=((8,), (4,)))


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32 for the whole module, as every
    port test with a JAX side pins them (the resume itself holds under
    either flag)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _params(model):
    return {n: p.detach().clone() for n, p in model.nets.named_parameters()}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# SVItrainer
# ---------------------------------------------------------------------------

def _ivae(seed):
    return tmodels.iVAE(DATA, invariances=["r"], seed=seed, device="cpu")


def _ved(seed):
    return tmodels.VED((16, 16), (32,), seed=seed, batchnorm=True,
                       device="cpu", **SMALL)


def _svi_data(family):
    if family == "ivae":
        return (_images(40),), _ivae
    rng = np.random.default_rng(1)
    return ((rng.uniform(0, 1, (40, 16, 16)).astype(np.float32),
             rng.uniform(0, 1, (40, 32)).astype(np.float32)), _ved)


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("family", ["ivae", "ved"])
def test_svi_resume_is_bitwise_equal_to_an_uninterrupted_run(
        family, async_write, tmp_path):
    arrays, make = _svi_data(family)
    whole = SVItrainer(make(3), seed=5)
    whole.run(init_dataloader(*arrays, batch_size=16, seed=2, device="cpu"),
              4, scale_factor=2.0)

    path = str(tmp_path / "ckpt.npz")
    first = SVItrainer(make(3), seed=5)
    first.run(init_dataloader(*arrays, batch_size=16, seed=2, device="cpu"),
              2, scale_factor=2.0)
    ckpt.save_checkpoint(path, first.model, first, async_write=async_write)
    model = make(11)  # other weights and seeds: all must come from the file
    second = SVItrainer(model, seed=99)
    second.checkpoint_path = path
    assert second.resume() == 2
    loader = init_dataloader(*arrays, batch_size=16, seed=2, device="cpu")
    loader.set_epoch(second.current_epoch)
    second.run(loader, 2, scale_factor=2.0)
    assert second.loss_history == whole.loss_history
    _assert_bitwise(_params(second.model), _params(whole.model))


def test_checkpoint_every_saves_at_its_epochs(tmp_path, monkeypatch):
    """Saved after every ``checkpoint_every``-th epoch of ``step`` and of
    ``run``, with the history materialized; ``fit`` passes the keywords
    on."""
    saved = []
    real = ckpt.save_checkpoint

    def spy(path, model, trainer=None, **kw):
        real(path, model, trainer, **kw)
        saved.append((trainer.current_epoch,
                      list(trainer.loss_history["training_loss"])))

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    path = str(tmp_path / "c.npz")
    trainer = SVItrainer(_ivae(1), checkpoint_path=path, checkpoint_every=2)
    loader = init_dataloader(_images(16), batch_size=8, device="cpu")
    trainer.run(loader, 5)
    trainer.step(loader)
    assert [e for e, _ in saved] == [2, 4, 6]
    assert all(len(h) == e and all(isinstance(v, float) for v in h)
               for e, h in saved)
    m = _ivae(1)
    tr = m.fit(_images(16), epochs=3, batch_size=8, checkpoint_path=path,
               checkpoint_every=3)
    assert saved[-1][0] == 3 and tr.checkpoint_every == 3
    assert SVItrainer(_ivae(2)).resume(path) == 3


# ---------------------------------------------------------------------------
# auxSVItrainer
# ---------------------------------------------------------------------------

def _ss_loaders():
    x = _images(48, seed=4)
    y = np.eye(3, dtype=np.float32)[np.arange(48) % 3]
    return init_ssvae_dataloaders(x, (x[:16], y[:16]), (x[16:32], y[16:32]),
                                  batch_size=8, seed=1, device="cpu")


def _ssivae(seed):
    return tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], seed=seed,
                          device="cpu")


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_aux_resume_is_bitwise_equal_to_an_uninterrupted_run(async_write,
                                                             tmp_path):
    """Both optimizers (the basic one and the auxiliary one over
    ``encoder_y``), the generator, the epoch and ``history`` (losses and
    accuracies) come back; the resumed run's loaders are built afresh."""
    whole = auxSVItrainer(_ssivae(3), seed=5)
    whole.run(*_ss_loaders()[:2], 4, loader_val=_ss_loaders()[2])

    path = str(tmp_path / "aux.npz")
    first = auxSVItrainer(_ssivae(3), seed=5, checkpoint_path=path,
                          checkpoint_every=2)
    lu, ls, lv = _ss_loaders()
    first.run(lu, ls, 2, loader_val=lv)
    if async_write:  # the trainer saved at epoch 2; save again, async
        ckpt.save_checkpoint(path, first.model, first, async_write=True)
    second = auxSVItrainer(_ssivae(12), seed=77)
    assert second.resume(path) == 2
    lu, ls, lv = _ss_loaders()
    for loader in (lu, ls, lv):
        loader.set_epoch(2)
    second.run(lu, ls, 2, loader_val=lv)
    assert second.history == whole.history
    _assert_bitwise(_params(second.model), _params(whole.model))
    for name in ("optimizer", "aux_optimizer"):
        a = getattr(second, name).state_dict()["state"]
        b = getattr(whole, name).state_dict()["state"]
        assert sorted(a) == sorted(b)
        for i in a:
            for key in a[i]:
                assert torch.equal(a[i][key], b[i][key]), (name, i, key)


def test_async_saves_from_many_threads_land_whole(tmp_path):
    """Async saves of two models to two paths from more threads than cores,
    with a short switch interval: every save returns, no write fails, no
    writer is left pending, and each path holds a whole archive of one of
    its models."""
    models = [_ved(1), _ved(2)]
    trainers = [SVItrainer(m) for m in models]
    paths = [str(tmp_path / f"p{i}.npz") for i in range(2)]
    errors = []

    def saver(i):
        try:
            for _ in range(3):
                ckpt.save_checkpoint(paths[i % 2], models[i % 2],
                                     trainers[i % 2], async_write=True)
        except BaseException as e:  # surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saver, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        ckpt.wait_for_checkpoints()
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and ckpt._pending_threads == {}
    for i in range(2):
        restored = _ved(9)
        ckpt.load_checkpoint(paths[i], restored, SVItrainer(restored))
        _assert_bitwise(_params(restored), _params(models[i]))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["ivae", "ved"])
def test_save_and_load_weights_round_trip(family, tmp_path):
    """A ``.pvt`` archive of named f32 arrays, pickle-free: a model of
    other weights loads them bitwise, with the model's generator state."""
    make = _ivae if family == "ivae" else _ved
    src = make(3)
    src.generator.manual_seed(1234)
    src.save_weights(str(tmp_path / "w"))
    with np.load(str(tmp_path / "w.pvt"), allow_pickle=False) as archive:
        assert all(archive[k].dtype in (np.float32, np.uint8)
                   for k in archive.files)
    dst = make(8)
    dst.load_weights(str(tmp_path / "w.pvt"))
    _assert_bitwise(_params(dst), _params(src))
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    other = tmodels.iVAE(DATA, invariances=["r"], hidden_dim_d=[64, 64],
                         device="cpu")
    before = _params(other)
    with pytest.raises(ValueError, match="shape" if family == "ivae"
                       else "missing"):
        other.load_weights(str(tmp_path / "w"))
    _assert_bitwise(_params(other), before)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refuses_other_backends_and_the_jax_packages_files(tmp_path):
    model = _ivae(1)
    trainer = SVItrainer(model)
    for backend, what in (("orbax", "no orbax"), ("pickle", "pickle"),
                          ("zarr", "Unknown")):
        with pytest.raises(ValueError, match=what):
            ckpt.save_checkpoint(str(tmp_path / "x"), model, trainer,
                                 backend=backend)
        with pytest.raises(ValueError, match=what):
            ckpt.load_checkpoint(str(tmp_path / "x"), model, trainer,
                                 backend=backend)

    # the JAX package's checkpoint and weights, refused before any read
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=2)
    jt = JSVItrainer(jm, seed=1)
    jt.step(jinit_dataloader(_images(16), batch_size=8))
    jsave_checkpoint(str(tmp_path / "jax.ckpt"), jm, jt)
    jm.save_weights(str(tmp_path / "jaxw"))
    before = _params(model)
    with pytest.raises(ValueError, match="written by the JAX package"):
        ckpt.load_checkpoint(str(tmp_path / "jax.ckpt"), model, trainer)
    with pytest.raises(ValueError, match="load_jax_params"):
        model.load_weights(str(tmp_path / "jaxw"))
    _assert_bitwise(_params(model), before)
    assert trainer.current_epoch == 0
    # the way across
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))

    # a checkpoint of another model changes nothing
    ckpt.save_checkpoint(str(tmp_path / "ved.npz"), _ved(1))
    before = _params(model)
    with pytest.raises(ValueError, match="missing"):
        ckpt.load_checkpoint(str(tmp_path / "ved.npz"), model)
    _assert_bitwise(_params(model), before)
    with pytest.raises(ValueError, match="no trainer state"):
        ckpt.load_checkpoint(str(tmp_path / "ved.npz"), _ved(1),
                             SVItrainer(_ved(1)))


def test_export_model_refuses_a_ved(tmp_path):
    with pytest.raises(NotImplementedError, match="JAX package's export"):
        export_model(_ved(1), str(tmp_path / "ved.npz"))
