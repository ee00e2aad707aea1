"""The port's segmented runs (``pyroved_tpu_torch/trainers/_segmented.py``)
against the JAX package's: segment boundaries, the ``on_segment`` record
lists, the JSONL log, the checkpoint epochs and early stopping
(``patience``, ``min_delta``), for ``SVItrainer`` and ``auxSVItrainer``
(whose patience watches the validation accuracy), on the CPU with the JAX
trainers' noise injected into the port's, so that the losses agree too."""
import json

import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
import pyroved_tpu.utils.checkpoint as jckpt
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import DataLoader as JDataLoader
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.utils.checkpoint as tckpt
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import DataLoader, init_dataloader

# Per-epoch losses: the JAX trainer's compiled scans against the port's
# eager steps on the same weights, noise and batches, f32 on both sides.
LOSS_RTOL = 1e-5
# Accuracies: the JAX trainer's run divides the hit count in float32, its
# step in float64 (as the port does)
ACC_RTOL = 1e-6
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))


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
    """The port's hidden products in f32, as the JAX package's CPU path
    computes them, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


class JaxNoiseSVI(SVItrainer):
    """The port's SVItrainer drawing the JAX trainer's noise: each epoch of
    training or evaluation takes the next key of ``split`` chains of
    ``PRNGKey(seed)``, each step ``fold_in(key, step)``."""

    def __init__(self, model, seed, **kw):
        super().__init__(model, **kw)
        self._key, self._ek, self._step = jax.random.PRNGKey(seed), None, 0

    def _epoch(self, loader, scale_factor, train):
        self._key, self._ek = jax.random.split(self._key)
        self._step = 0
        return super()._epoch(loader, scale_factor, train)

    def _noise(self, batch_size):
        key = jax.random.fold_in(self._ek, self._step)
        self._step += 1
        (shape,) = self.model.noise_shapes(batch_size)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))


class JaxNoiseAux(auxSVItrainer):
    """The port's auxSVItrainer drawing the JAX trainer's noise: a key per
    epoch, ``fold_in(key, 2i)`` for unlabeled step i and ``2i + 1`` for the
    labeled step after it."""

    def __init__(self, model, seed, **kw):
        super().__init__(model, **kw)
        self._key, self._ek, self._i = jax.random.PRNGKey(seed), None, -1

    def train(self, *a, **k):
        self._key, self._ek = jax.random.split(self._key)
        self._i = -1
        return super().train(*a, **k)

    def draw_noise(self, batch_size, labeled):
        self._i += 0 if labeled else 1
        key = jax.random.fold_in(self._ek, 2 * self._i + int(labeled))
        (shape,) = self.model.noise_shapes(batch_size, labeled)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def _images(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, n)[:, None, None]
    xr = xx[None] * np.cos(th) - yy[None] * np.sin(th)
    return np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(
        np.float32)


def _ivae_pair(seed=3):
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=seed, **SMALL)
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _saves(monkeypatch):
    """The epochs at which each package saves a checkpoint: (jax, port)."""
    jsaved, tsaved = [], []
    jsave, tsave = jckpt.save_checkpoint, tckpt.save_checkpoint

    def jrec(path, model, trainer=None, **kw):
        jsaved.append(trainer.current_epoch)
        return jsave(path, model, trainer, **kw)

    def trec(path, model, trainer=None, **kw):
        tsaved.append(trainer.current_epoch)
        return tsave(path, model, trainer, **kw)

    monkeypatch.setattr(jckpt, "save_checkpoint", jrec)
    monkeypatch.setattr(tckpt, "save_checkpoint", trec)
    return jsaved, tsaved


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


# (epochs, trainer keywords, run keywords, streaming): pipelined segments
# with checkpoints and a log, the log's 10-epoch cadence alone, blocking
# segments under patience, and a streaming loader's blocking segments
CONFIGS = {
    "log_checkpoint_callback": (9, dict(log=True, checkpoint_every=4),
                                dict(test=True, on_segment=True), False),
    "log_only": (12, dict(log=True), dict(), False),
    "patience_callback": (12, dict(log=True),
                          dict(test=True, on_segment=True, patience=3,
                               min_delta=0.5), False),
    "streaming_callback": (12, dict(checkpoint_every=5),
                           dict(on_segment=True), True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_segments_records_and_checkpoints_match_jax(name, tmp_path,
                                                    monkeypatch):
    """The same run through both trainers: the on_segment record lists
    (their grouping is the segment boundaries), the JSONL log's keys and
    epochs, the checkpoint epochs, the early stop, and the losses."""
    epochs, tkw, rkw, streaming = CONFIGS[name]
    jsaved, tsaved = _saves(monkeypatch)
    x, xt = _images(48, 0), _images(32, 1)
    out = {}
    for pkg in ("jax", "port"):
        jm, tm = _ivae_pair()
        kw = {}
        if tkw.get("log"):
            kw["log_file"] = str(tmp_path / f"{pkg}.jsonl")
        if "checkpoint_every" in tkw:
            kw.update(checkpoint_path=str(tmp_path / f"{pkg}.ckpt"),
                      checkpoint_every=tkw["checkpoint_every"])
        segs = []
        run = {}
        if rkw.get("on_segment"):
            run["on_segment"] = segs.append
        for k in ("patience", "min_delta"):
            if k in rkw:
                run[k] = rkw[k]
        if pkg == "jax":
            trainer = JSVItrainer(jm, seed=9, **kw)
            make = (lambda a: JDataLoader(a, batch_size=16, seed=3,
                                          device_resident=False)
                    ) if streaming else (
                lambda a: jinit_dataloader(a, batch_size=16, seed=3))
        else:
            trainer = JaxNoiseSVI(tm, 9, **kw)
            make = lambda a: DataLoader(  # noqa: E731
                a, batch_size=16, seed=3, device_resident=not streaming,
                device="cpu")
        if rkw.get("test"):
            run["test_loader"] = make(xt)
        losses = trainer.run(make(x), epochs, **run)
        out[pkg] = dict(trainer=trainer, losses=losses, segs=segs,
                        log=_jsonl(kw["log_file"]) if "log_file" in kw
                        else None)
    j, t = out["jax"], out["port"]
    assert [[r["epoch"] for r in s] for s in t["segs"]] == [
        [r["epoch"] for r in s] for s in j["segs"]]
    assert [sorted(r) for s in t["segs"] for r in s] == [
        sorted(r) for s in j["segs"] for r in s]
    assert tsaved == jsaved
    if j["log"] is not None:
        assert [sorted(r) for r in t["log"]] == [sorted(r) for r in j["log"]]
        assert [r["epoch"] for r in t["log"]] == list(
            range(1, t["trainer"].current_epoch + 1))
        assert [r["training_loss"] for r in t["log"]] == t["losses"]
    for attr in ("current_epoch", "stopped_early", "best_epoch"):
        assert getattr(t["trainer"], attr) == getattr(j["trainer"], attr)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
    for key, ref in j["trainer"].loss_history.items():
        np.testing.assert_allclose(t["trainer"].loss_history[key], ref,
                                   rtol=LOSS_RTOL)
    flat = [r for s in t["segs"] for r in s]
    assert [r["training_loss"] for r in flat] == t["losses"][:len(flat)]


def test_early_stop_on_a_plateau_matches_jax():
    """A held-out loss that falls, then plateaus against ``min_delta``:
    the stop epoch, ``best_epoch``, ``best_metric`` and ``stopped_early``
    equal the JAX trainer's (segments of min(10, patience) epochs)."""
    x, xt = _images(48, 2), _images(32, 3)
    jm, tm = _ivae_pair(seed=5)
    jt = JSVItrainer(jm, seed=4)
    jt.run(jinit_dataloader(x, batch_size=16, seed=1), 30,
           test_loader=jinit_dataloader(xt, batch_size=16, seed=2),
           patience=4, min_delta=2.0)
    tt = JaxNoiseSVI(tm, 4)
    tt.run(init_dataloader(x, batch_size=16, seed=1, device="cpu"), 30,
           test_loader=init_dataloader(xt, batch_size=16, seed=2,
                                       device="cpu"),
           patience=4, min_delta=2.0)
    assert jt.stopped_early and 8 <= jt.current_epoch < 30
    assert (tt.stopped_early, tt.current_epoch, tt.best_epoch) == (
        jt.stopped_early, jt.current_epoch, jt.best_epoch)
    np.testing.assert_allclose(tt.best_metric, jt.best_metric,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.loss_history["test_loss"],
                               jt.loss_history["test_loss"], rtol=LOSS_RTOL)


def _ss_data(n_u=48, n_l=16, seed=0):
    rng = np.random.default_rng(seed)
    x = _images(n_u + n_l, seed + 7)
    y = (np.arange(n_u + n_l) % 3).astype(np.int64)
    x = x * (1.0 + 0.5 * y[:, None, None]) / 2.0  # brightness by class
    rng.shuffle(x)
    return x[:n_u], x[n_u:], y[n_u:]


def test_aux_patience_on_accuracy_matches_jax():
    """auxSVItrainer's patience watches the validation accuracy (higher is
    better): with ``min_delta`` no accuracy gain counts, so the run stops
    ``patience`` epochs after its first, checked at segment ends; the
    port stops where the JAX trainer does, with the same best accuracy,
    and its losses agree."""
    xu, xl, yl = _ss_data()
    jm = jmodels.ssiVAE(DATA, 2, 3, invariances=["r"], seed=4, **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    y1h = np.eye(3, dtype=np.float32)[yl]
    jt = JauxSVItrainer(jm, seed=2)
    jl = (jinit_dataloader(xu, batch_size=16, seed=1),
          jinit_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True),
          jinit_dataloader(xl, y1h, batch_size=8, seed=3))
    jt.run(jl[0], jl[1], 12, loader_val=jl[2], patience=3, min_delta=0.5)
    tt = JaxNoiseAux(tm, 2)
    tl = (init_dataloader(xu, batch_size=16, seed=1, device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True,
                          device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=3, device="cpu"))
    tt.run(tl[0], tl[1], 12, loader_val=tl[2], patience=3, min_delta=0.5)
    assert jt.stopped_early and jt.current_epoch == 6
    assert (tt.stopped_early, tt.current_epoch, tt.best_epoch) == (
        jt.stopped_early, jt.current_epoch, jt.best_epoch)
    np.testing.assert_allclose(tt.best_metric, jt.best_metric, rtol=ACC_RTOL)
    # the JAX trainer's run reads the accuracy as a float32 share
    np.testing.assert_allclose(tt.history["test"], jt.history["test"],
                               rtol=ACC_RTOL)
    np.testing.assert_allclose(tt.history["training_loss"],
                               jt.history["training_loss"], rtol=LOSS_RTOL)


def test_step_jsonl_records_match_jax(tmp_path):
    """``step`` writes one record per epoch; under ``sync=False`` the
    records wait for ``sync_history``: the same keys and epochs as the JAX
    trainer's, the losses those of the history."""
    x, xt = _images(32, 4), _images(16, 5)
    jm, tm = _ivae_pair()
    logs = {}
    for pkg, trainer, make in (
            ("jax", JSVItrainer(jm, seed=9, log_file=str(tmp_path / "j")),
             lambda a: jinit_dataloader(a, batch_size=16)),
            ("port", JaxNoiseSVI(tm, 9, log_file=str(tmp_path / "t")),
             lambda a: init_dataloader(a, batch_size=16, device="cpu"))):
        ld, tl = make(x), make(xt)
        trainer.step(ld, tl)
        trainer.step(ld, sync=False)
        trainer.step(ld, tl, sync=False)
        path = str(tmp_path / ("j" if pkg == "jax" else "t"))
        before = len(_jsonl(path))
        trainer.sync_history()
        logs[pkg] = (before, _jsonl(path), trainer.loss_history)
    (jb, jlog, jh), (tb, tlog, th) = logs["jax"], logs["port"]
    assert (tb, [sorted(r) for r in tlog], [r["epoch"] for r in tlog]) == (
        jb, [sorted(r) for r in jlog], [r["epoch"] for r in jlog])
    assert [r["training_loss"] for r in tlog] == th["training_loss"]
    np.testing.assert_allclose(th["training_loss"], jh["training_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(th["test_loss"], jh["test_loss"],
                               rtol=LOSS_RTOL)


def test_fit_forwards_and_the_verbose_loop_agrees():
    """``fit`` forwards ``patience``, ``min_delta`` and ``on_segment`` to
    ``run``; with ``verbose`` its per-epoch loop stops at the same epoch
    (checking every epoch, so at or before the segmented run's) and sends
    one record per epoch, as the JAX package's."""
    x, xt = _images(48, 6), _images(32, 7)
    stops = {}
    for verbose in (False, True):
        for pkg in ("jax", "port"):
            jm, tm = _ivae_pair(seed=8)
            m = jm if pkg == "jax" else tm
            recs = []
            tr = m.fit(x, epochs=12, batch_size=16, test_data=xt,
                       patience=2, min_delta=5.0, on_segment=recs.append,
                       verbose=verbose)
            stops[verbose, pkg] = (tr.stopped_early, tr.current_epoch,
                                   tr.best_epoch,
                                   [[r["epoch"] for r in s] for s in recs])
    assert stops[False, "port"] == stops[False, "jax"]
    assert stops[True, "port"] == stops[True, "jax"]
    assert stops[True, "port"][1] <= stops[False, "port"][1]


def test_segment_keywords_raise_as_jax():
    """``patience`` without a held-out loader, a ``scale_schedule`` of the
    wrong length, and ``fit``'s ``patience`` without test data raise
    ``ValueError`` in both packages."""
    x = _images(16, 8)
    jm, tm = _ivae_pair()
    for trainer, ld in ((JSVItrainer(jm), jinit_dataloader(x, batch_size=8)),
                        (SVItrainer(tm), init_dataloader(x, batch_size=8,
                                                         device="cpu"))):
        with pytest.raises(ValueError, match="test_loader"):
            trainer.run(ld, 2, patience=1)
        with pytest.raises(ValueError, match="scale_schedule"):
            trainer.run(ld, 2, scale_schedule=[1.0])
        assert trainer.run(ld, 0) == []
    for m in (jm, tm):
        with pytest.raises(ValueError, match="test_data"):
            m.fit(x, epochs=1, batch_size=8, patience=1)
    ssm = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu",
                         **SMALL)
    xu, xl, yl = _ss_data(16, 8)
    lds = [init_dataloader(a, batch_size=8, device="cpu")
           for a in (xu,)] + [init_dataloader(xl, np.eye(3, dtype=np.float32)
                                              [yl], batch_size=8,
                                              device="cpu")]
    with pytest.raises(ValueError, match="loader_val"):
        auxSVItrainer(ssm).run(lds[0], lds[1], 2, patience=1)
