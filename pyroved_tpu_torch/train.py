"""Config-driven training from a job file:

    python -m pyroved_tpu_torch.train job.json [--device cpu]

The counterpart of ``python -m pyroved_tpu.train job.json``: the same job
file runs in both packages unchanged. It trains on the card; ``--device
cpu`` (or ``run_job(job, device="cpu")``) trains on the CPU, and nothing
falls back to the CPU when no card is found.

``job.json``::

    {
      "model": "iVAE",                      # iVAE|jiVAE|ssiVAE|ss_reg_iVAE|VED
      "model_config": {"data_dim": [28, 28], "latent_dim": 2,
                        "invariances": ["r"]},
      "train": {"epochs": 100, "batch_size": 200, "lr": 1e-3,
                 "scale_factor": 1.0, "seed": 1, "grad_accum": 1},
      "data": "X.npy",                      # [N, *data_dim]
      "labels": "y.npy",                    # optional (cVAE / VED targets)
      "test_data": "Xtest.npy",             # optional held-out set, evaluated
                                            # every epoch (enables "patience"
                                            # early stopping); labeled jobs
                                            # add "test_labels"
      "unsup_data": "...", "sup_data": [...], "val_data": [...],
                                            # semi-supervised alternative
      "checkpoint_path": "ckpt.npz",        # optional auto-checkpoint
      "log_file": "train.jsonl",            # optional per-epoch JSONL
      "save_weights": "model",              # optional .pvt weight dump
      "export_path": "model.npz"            # optional serving export
    }

``model_config`` holds the fields of the model's config
(:mod:`pyroved_tpu_torch.config`), with ``extra`` for further model
keywords (``{"one_pass_train": true}``, ``{"pixel_chunks": 16}``, ...).
Every run goes through the trainer's ``run``: with a log file or a
checkpoint path it runs in segments with that work between them. The
files written are the port's own formats (checkpoint, ``.pvt`` weights and
serving archive).
"""
import json
import sys

import numpy as np

from . import config as cfgmod
from . import models, serving, trainers
from .utils import init_dataloader, init_ssvae_dataloaders

_CONFIGS = {
    "iVAE": cfgmod.iVAEConfig,
    "jiVAE": cfgmod.jiVAEConfig,
    "ssiVAE": cfgmod.ssiVAEConfig,
    "ss_reg_iVAE": cfgmod.ssRegiVAEConfig,
    "VED": cfgmod.VEDConfig,
}


def _tupled(d: dict) -> dict:
    """JSON lists -> tuples for the frozen dataclass fields."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


_JOB_KEYS = {"model", "model_config", "train", "data", "labels",
             "test_data", "test_labels", "unsup_data", "sup_data",
             "val_data", "checkpoint_path", "checkpoint_every", "log_file",
             "save_weights", "export_path"}
_TRAIN_KEYS = {"lr", "epochs", "batch_size", "scale_factor", "seed",
               "grad_accum", "patience", "min_delta", "enum_schedule"}


def run_job(job: dict, device=None) -> dict:
    """Execute one training job dict (see the module docstring) on
    ``device`` (None means ``"cuda"``); returns a summary dict (final
    losses or metric, paths written). Unknown keys are rejected: a typo
    must not silently train with defaults."""
    unknown = set(job) - _JOB_KEYS
    if unknown:
        raise ValueError(f"Unknown job keys {sorted(unknown)}; "
                         f"valid keys: {sorted(_JOB_KEYS)}")
    name = job["model"]
    if name not in _CONFIGS:
        raise ValueError(f"model must be one of {sorted(_CONFIGS)}, got {name!r}")
    model = _CONFIGS[name](**_tupled(job.get("model_config", {}))).build(
        device=device)
    tr = job.get("train", {})
    unknown = set(tr) - _TRAIN_KEYS
    if unknown:
        raise ValueError(f"Unknown train keys {sorted(unknown)}; "
                         f"valid keys: {sorted(_TRAIN_KEYS)}")
    tc = cfgmod.TrainConfig(**tr)

    summary = {"model": name}
    semi = isinstance(model, (models.ssiVAE, models.ss_reg_iVAE))
    if semi and (job.get("test_data") or job.get("test_labels")):
        raise ValueError("semi-supervised jobs monitor val_data (the labeled "
                         "validation loader); test_data does not apply")
    if semi:
        loaders = init_ssvae_dataloaders(
            np.load(job["unsup_data"]),
            tuple(np.load(p) for p in job["sup_data"]),
            tuple(np.load(p) for p in job["val_data"]),
            batch_size=tc.batch_size, device=model.device)
        trainer = trainers.auxSVItrainer(
            model, lr=tc.lr, seed=tc.seed, grad_accum=tc.grad_accum,
            checkpoint_path=job.get("checkpoint_path"),
            checkpoint_every=job.get("checkpoint_every", 10),
            log_file=job.get("log_file"))
        run_kw = {"scale_factor": tc.scale_factor, "loader_val": loaders[2]}
        if tc.patience is not None:  # monitors the val metric
            run_kw.update(patience=tc.patience, min_delta=tc.min_delta)
        if tc.enum_schedule is not None:
            run_kw.update(enum_schedule=tc.enum_schedule)
        trainer.run(loaders[0], loaders[1], tc.epochs, **run_kw)
        summary["training_loss"] = trainer.history["training_loss"][-1]
        summary["val_metric"] = trainer.history["test"][-1]
        if tc.patience is not None:
            summary["stopped_early"] = trainer.stopped_early
            summary["best_epoch"] = trainer.best_epoch
    else:
        arrays = (np.load(job["data"]),)
        if job.get("labels"):
            arrays = arrays + (np.load(job["labels"]),)
        loader = init_dataloader(*arrays, batch_size=tc.batch_size,
                                 device=model.device)
        trainer = trainers.SVItrainer(
            model, lr=tc.lr, seed=tc.seed, grad_accum=tc.grad_accum,
            checkpoint_path=job.get("checkpoint_path"),
            checkpoint_every=job.get("checkpoint_every", 10),
            log_file=job.get("log_file"))
        run_kw = {"scale_factor": tc.scale_factor}
        if job.get("test_data"):
            # the held-out tuple mirrors the train tuple: labeled jobs (VED
            # targets, conditional y) need test_labels too
            if job.get("labels") and not job.get("test_labels"):
                raise ValueError('jobs with "labels" need "test_labels" '
                                 'alongside "test_data"')
            test_arrays = (np.load(job["test_data"]),)
            if job.get("test_labels"):
                test_arrays = test_arrays + (np.load(job["test_labels"]),)
            run_kw["test_loader"] = init_dataloader(
                *test_arrays, batch_size=tc.batch_size, shuffle=False,
                device=model.device)
        elif job.get("test_labels"):
            raise ValueError('"test_labels" given without "test_data"')
        if tc.patience is not None:
            if "test_loader" not in run_kw:
                raise ValueError('"patience" needs "test_data" (the early '
                                 "stop monitors the held-out loss)")
            run_kw.update(patience=tc.patience, min_delta=tc.min_delta)
        if tc.enum_schedule is not None:
            run_kw.update(enum_schedule=tc.enum_schedule)
        trainer.run(loader, tc.epochs, **run_kw)
        summary["training_loss"] = trainer.loss_history["training_loss"][-1]
        if job.get("test_data"):
            summary["test_loss"] = trainer.loss_history["test_loss"][-1]
        if tc.patience is not None:
            summary["stopped_early"] = trainer.stopped_early
            summary["best_epoch"] = trainer.best_epoch

    if job.get("checkpoint_path"):
        # always leave a final checkpoint, whatever the epoch cadence
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(job["checkpoint_path"], model, trainer)
        summary["checkpoint"] = job["checkpoint_path"]

    if job.get("save_weights"):
        model.save_weights(job["save_weights"])
        summary["weights"] = job["save_weights"] + ".pvt"
    if job.get("export_path"):
        serving.export_model(model, job["export_path"],
                             batch_size=tc.batch_size)
        summary["export"] = job["export_path"]
    summary["epochs"] = tc.epochs
    return summary


def main(argv=None) -> int:
    """``main([job_path])`` or ``main([job_path, "--device", device])``:
    run the job and print its summary as one JSON line; 2 (and the usage)
    on other arguments."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = None
    if len(argv) == 3 and argv[1] == "--device":
        argv, device = argv[:1], argv[2]
    if len(argv) != 1:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        job = json.load(f)
    summary = run_job(job, device=device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
