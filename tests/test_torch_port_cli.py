"""The port's job runner (``python -m pyroved_tpu_torch.train``) against the
JAX package's (``python -m pyroved_tpu.train``), and the port's profiling
helpers (``pyroved_tpu_torch/utils/profiling.py``) against the JAX
package's, on the CPU.

The same job dicts run through both ``run_job``s, the port's with the JAX
model's weights carried across and the JAX trainers' noise injected
(``JaxNoiseSVI`` / ``JaxNoiseAux`` of ``test_torch_port_segmented.py``):
the summaries have the same keys and the losses and metrics agree; every
job the JAX runner rejects, the port's rejects with the same error; the
checkpoint the port writes resumes, and ``main`` runs a job file."""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax

from pyroved_tpu import config as jconfig
from pyroved_tpu import train as jtrain
from pyroved_tpu.utils import profiling as jprofiling
from pyroved_tpu_torch import config as tconfig
from pyroved_tpu_torch import train as ttrain
from pyroved_tpu_torch.models import iVAE
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.serving import ServedModel
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils import profiling
from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# Losses and metrics: the JAX trainer's compiled scans against the port's
# eager steps on the same weights, noise and batches, f32 on both sides.
RTOL = 1e-5


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


def _save(d, name, arr):
    p = str(d / name)
    np.save(p, arr)
    return p + ".npy"


def _ivae_job(d, epochs=2):
    rng = np.random.default_rng(0)
    return {
        "model": "iVAE",
        "model_config": {"data_dim": [8, 8], "latent_dim": 2,
                         "invariances": ["r"], "hidden_dim_e": [32],
                         "hidden_dim_d": [32]},
        "train": {"epochs": epochs, "batch_size": 16},
        "data": _save(d, "X", rng.uniform(0, 1, (48, 8, 8)).astype(
            np.float32)),
        "test_data": _save(d, "Xt", rng.uniform(0, 1, (16, 8, 8)).astype(
            np.float32)),
    }


def _ssivae_job(d, epochs=2):
    rng = np.random.default_rng(0)
    Xu = rng.uniform(0, 1, (24, 8, 8)).astype(np.float32)
    Xs = rng.uniform(0, 1, (8, 8, 8)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    return {
        "model": "ssiVAE",
        "model_config": {"data_dim": [8, 8], "latent_dim": 2,
                         "num_classes": 3},
        "train": {"epochs": epochs, "batch_size": 8},
        "unsup_data": _save(d, "Xu", Xu),
        "sup_data": [_save(d, "Xs", Xs), _save(d, "ys", ys)],
        "val_data": [_save(d, "Xv", Xs), _save(d, "yv", ys)],
    }


@pytest.fixture
def carried(monkeypatch):
    """The port's run_job with the JAX model's initial weights (built from
    the same config) and the JAX trainers' noise."""
    for name in ("iVAEConfig", "jiVAEConfig", "ssiVAEConfig",
                 "ssRegiVAEConfig", "VEDConfig"):
        tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)

        def build(self, device=None, _orig=tcls.build, _jcls=jcls):
            tm = _orig(self, device=device)
            jm = _jcls(**dataclasses.asdict(self)).build()
            tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
            return tm

        monkeypatch.setattr(tcls, "build", build)
    monkeypatch.setattr(
        ttrain.trainers, "SVItrainer",
        lambda model, seed=1, **kw: JaxNoiseSVI(model, seed, **kw))
    monkeypatch.setattr(
        ttrain.trainers, "auxSVItrainer",
        lambda model, seed=1, **kw: JaxNoiseAux(model, seed, **kw))


def _both(job, tmp_path):
    """The job through JAX's run_job and the port's (on the CPU), each
    writing its files into a directory of its own."""
    out = {}
    for pkg, run in (("jax", jtrain.run_job),
                     ("port", lambda j: ttrain.run_job(j, device="cpu"))):
        d = tmp_path / pkg
        d.mkdir()
        j = dict(job)
        for key, name in (("log_file", "log.jsonl"),
                          ("checkpoint_path", "ck.npz"),
                          ("save_weights", "w"), ("export_path", "m.npz")):
            if key in j:
                j[key] = str(d / name)
        out[pkg] = run(j)
    return out["jax"], out["port"]


def _close(a, b):
    return abs(a - b) <= RTOL * abs(b)


def test_ivae_job_matches_jax(tmp_path, carried):
    """The unsupervised job with a held-out set, a JSONL log, a checkpoint,
    weights and an export: the same summary keys, the training and test
    losses within 1e-5, the logs' epochs and losses alike."""
    job = _ivae_job(tmp_path)
    job.update(log_file="", checkpoint_path="", save_weights="",
               export_path="")
    j, t = _both(job, tmp_path)
    assert sorted(t) == sorted(j)
    assert t["epochs"] == j["epochs"] == 2
    assert _close(t["training_loss"], j["training_loss"]), (t, j)
    assert _close(t["test_loss"], j["test_loss"]), (t, j)
    jlog = [json.loads(x) for x in open(tmp_path / "jax" / "log.jsonl")]
    tlog = [json.loads(x) for x in open(tmp_path / "port" / "log.jsonl")]
    assert [r["epoch"] for r in tlog] == [r["epoch"] for r in jlog] == [1, 2]
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    for a, b in zip(tlog, jlog):
        assert _close(a["training_loss"], b["training_loss"])
        assert _close(a["test_loss"], b["test_loss"])
    for key in ("checkpoint", "weights", "export"):
        assert os.path.exists(t[key])
    served = ServedModel(t["export"], device="cpu")
    assert served.encode(np.load(job["data"])[:4])[0].shape == (4, 3)


def test_ssivae_job_matches_jax(tmp_path, carried):
    """The semi-supervised job (auxSVItrainer, the validation accuracy as
    the metric): the same summary keys, losses and metric within 1e-5."""
    j, t = _both(_ssivae_job(tmp_path), tmp_path)
    assert sorted(t) == sorted(j)
    assert _close(t["training_loss"], j["training_loss"]), (t, j)
    assert _close(t["val_metric"], j["val_metric"]), (t, j)
    assert 0.0 <= t["val_metric"] <= 1.0


def test_patience_jobs_match_jax(tmp_path, carried):
    """Early stopping through the job's train section, both runners: the
    stop, the best epoch and the losses."""
    (tmp_path / "data").mkdir()
    job = _ivae_job(tmp_path / "data", epochs=12)
    job["train"].update(patience=2, min_delta=1000.0)
    j, t = _both(job, tmp_path)
    assert sorted(t) == sorted(j)
    assert t["stopped_early"] is j["stopped_early"] is True
    assert t["best_epoch"] == j["best_epoch"]
    assert _close(t["test_loss"], j["test_loss"])


def _rejections(d):
    ivae = _ivae_job(d, epochs=1)
    semi = _ssivae_job(d, epochs=1)
    labeled = dict(ivae, model_config={"data_dim": [8, 8], "latent_dim": 2,
                                       "c_dim": 4},
                   labels=_save(d, "y", np.random.default_rng(1).uniform(
                       0, 1, (48, 4)).astype(np.float32)))
    labeled.pop("test_data")
    return {
        "unknown_job_key": (dict(ivae, export="typo.npz"),
                            r"Unknown job keys.*'export'"),
        "unknown_train_key": (dict(ivae, train={"epoch": 5, "batch_size": 8}),
                              r"Unknown train keys.*'epoch'"),
        "unknown_model": ({"model": "GAN"}, "model must be one of"),
        "semi_test_data": (dict(semi, test_data=ivae["test_data"]),
                           "val_data"),
        "labels_without_test_labels": (
            dict(labeled, test_data=ivae["test_data"]), "test_labels"),
        "test_labels_without_test_data": (
            dict(ivae, test_labels=labeled["labels"], test_data=""),
            "test_labels"),
        "patience_without_test_data": (
            dict(labeled, model_config={"data_dim": [8, 8]}, labels="",
                 train={"epochs": 1, "batch_size": 8, "patience": 2}),
            "patience"),
        "bad_config": (dict(ivae, model_config={"data_dim": [8, 8],
                                                "activation": "swish"}),
                       "activation must be one of"),
    }


REJECTIONS = ("unknown_job_key", "unknown_train_key", "unknown_model",
              "semi_test_data", "labels_without_test_labels",
              "test_labels_without_test_data", "patience_without_test_data",
              "bad_config")


@pytest.mark.parametrize("name", REJECTIONS)
def test_rejections_match_jax(name, tmp_path):
    job, pattern = _rejections(tmp_path)[name]
    with pytest.raises(ValueError, match=pattern) as jerr:
        jtrain.run_job(job)
    with pytest.raises(ValueError, match=pattern) as terr:
        ttrain.run_job(job, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_checkpoint_resumes_and_main_runs(tmp_path, capsys):
    """``main([path, "--device", "cpu"])`` runs a job file and prints its
    summary; the final checkpoint it leaves (2 epochs, under the default
    cadence of 10) resumes in a fresh trainer; usage errors return 2;
    without the device argument the job needs a card."""
    job = _ivae_job(tmp_path)
    job.update(checkpoint_path=str(tmp_path / "ck.npz"),
               log_file=str(tmp_path / "log.jsonl"))
    path = tmp_path / "job.json"
    path.write_text(json.dumps(job))
    assert ttrain.main([str(path), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "iVAE" and out["epochs"] == 2
    assert out["checkpoint"] == job["checkpoint_path"]
    assert len(open(job["log_file"]).readlines()) == 2
    m = iVAE((8, 8), latent_dim=2, invariances=["r"], hidden_dim_e=[32],
             hidden_dim_d=[32], device="cpu")
    t = SVItrainer(m, checkpoint_path=job["checkpoint_path"])
    assert t.resume() == 2
    assert t.loss_history["training_loss"][-1] == out["training_loss"]
    assert ttrain.main([]) == 2
    assert ttrain.main([str(path), "--gpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main([str(path)])


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------

def _fake_clock(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.25) ** 1.5)
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def test_timer_matches_jax(monkeypatch):
    """The same sequence of timed blocks, on the same clock, gives the same
    totals, counts, means and summary in both packages' Timers."""
    def drive(timer):
        for name in ("step", "eval", "step", "step", "io"):
            with timer.time(name):
                pass
        try:
            with timer.time("eval"):
                raise KeyError("a failing block is timed too")
        except KeyError:
            pass
        return (timer.totals, timer.counts, timer.summary(),
                timer.mean("step"), timer.mean("never"))

    _fake_clock(monkeypatch)
    want = drive(jprofiling.Timer())
    _fake_clock(monkeypatch)
    assert drive(profiling.Timer()) == want


def test_trace_writes_a_trace_file(tmp_path):
    """``trace`` writes a Chrome-trace JSON into the directory, naming the
    ops run inside the block."""
    logdir = tmp_path / "trace"
    m = iVAE((8, 8), latent_dim=2, invariances=["r"], hidden_dim_e=[16],
             hidden_dim_d=[16], device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (4, 8, 8)).astype(np.float32)
    with profiling.trace(str(logdir)):
        m.encode(x)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.load(open(logdir / files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::addmm" for e in events)


def test_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    """``enable_compilation_cache(path)`` builds and loads the kernel
    libraries in ``path``; the library's name still hashes the source and
    the command; the default lies in the temporary directory, outside the
    package."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    _, lib = _build._target("spatial_decoder_fwd")
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert profiling.enable_compilation_cache(str(tmp_path)) == str(tmp_path)
    _, moved = _build._target("spatial_decoder_fwd")
    assert moved == os.path.join(str(tmp_path), os.path.basename(lib))
    default = profiling.enable_compilation_cache()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
    assert not default.startswith(pkg)
    import tempfile
    assert default.startswith(os.path.abspath(tempfile.gettempdir()))
