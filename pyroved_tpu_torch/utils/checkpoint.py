"""Full-training-state checkpoints, and the archive format of saved weights.

Counterpart of ``pyroved_tpu/utils/checkpoint.py``. A checkpoint holds the
model's parameters and generator, and with a trainer its optimizer state
(and ``auxSVItrainer``'s auxiliary optimizer), the state of its noise
generator, ``current_epoch`` and the loss history, so that training resumes
bit-exactly: 2 epochs, a save, a load into a fresh model and trainer and 2
more epochs give the same losses and parameters, bit for bit, as 4 epochs
in one go (on the same device, with the data loader at the same epoch:
``DataLoader.set_epoch``).

The port has one format, and it is pickle-free: an ``np.savez`` archive of
named arrays plus a JSON manifest (the layout of the port's exports), so
loading an untrusted file cannot run code. The archive holds:

- ``model.<name>``: the model's ``state_dict``;
- ``model_generator``: the model's ``torch.Generator`` state (uint8);
- ``<optimizer>.<parameter name>.<key>``: each optimizer's per-parameter
  state (``exp_avg``, ``exp_avg_sq``, ``step`` for Adam), for
  ``optimizer`` and ``aux_optimizer``; their hyperparameters sit in the
  manifest;
- ``accum.<parameter name>``: under ``grad_accum``, the running mean of
  the window's gradients; the manifest holds ``k`` and the micro-step, so
  that a resume in the middle of a window is bitwise equal to an
  uninterrupted run;
- ``generator``: the trainer's ``torch.Generator`` state (uint8);
- ``manifest``: the format tag, ``current_epoch``, the loss history (the
  trainer's ``loss_history``, or ``history`` for ``auxSVItrainer``).

A tensor-parallel model's files hold the whole model: every rank joins
the gather of its split layers' rows (parameters, Adam moments, the
``grad_accum`` window) and global rank 0 writes. Loading cuts the whole
arrays to the rows of a split model's rank; ``load_checkpoint(...,
mesh=)`` first splits a whole model over the mesh's ``'model'`` axis, as
the JAX package's restores the saved shardings onto a live mesh.

The JAX package's archives (a flax msgpack ``payload``, or an orbax
directory) are refused whole, before anything is read into the model.
"""
import json
import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch

CHECKPOINT_FORMAT = "pyroved_tpu_torch.checkpoint"
WEIGHTS_FORMAT = "pyroved_tpu_torch.weights"
_OPTIMIZERS = ("optimizer", "aux_optimizer")
#: optimizer settings a load keeps from the live optimizer: where its state
#: lives and which kernels step it (a CUDA trainer's capturable Adam keeps
#: its step count on the device whatever optimizer saved the file)
_IMPLEMENTATION = ("capturable", "foreach", "fused", "differentiable")


# ---------------------------------------------------------------------------
# The archive: named arrays and a JSON manifest
# ---------------------------------------------------------------------------

def write_archive(path: str, arrays: Dict[str, np.ndarray],
                  manifest: dict) -> None:
    """Write ``arrays`` and ``manifest`` to ``path`` atomically (a temp file
    in the target's directory, then ``os.replace``): a crash mid-write
    leaves the previous file whole."""
    arrays = dict(arrays)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode("utf-8"),
                                       np.uint8)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp",
        dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_archive(path: str, fmt: str):
    """(manifest, arrays) of a port archive of format ``fmt``. An archive
    the JAX package wrote raises ``ValueError`` saying so."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the port reads only its own np.savez archives")
    with np.load(path, allow_pickle=False) as archive:
        files = set(archive.files)
        if "manifest" not in files:
            raise ValueError(_jax_archive_message(path, files, fmt))
        manifest = json.loads(archive["manifest"].tobytes().decode("utf-8"))
        found = manifest.get("format") if isinstance(manifest, dict) else None
        if found != fmt:
            raise ValueError(f"{path} is not a {fmt} archive (its manifest "
                             f"names {found!r})")
        arrays = {k: archive[k] for k in files if k != "manifest"}
    return manifest, arrays


def _jax_archive_message(path: str, files, fmt: str) -> str:
    if fmt == WEIGHTS_FORMAT and "params" in files:
        return (f"{path} was written by the JAX package's save_weights (flax "
                "msgpack bytes), which the port does not read; load the JAX "
                "model's parameter tree with load_jax_params instead")
    if "payload" in files:
        return (f"{path} is a checkpoint written by the JAX package (a flax "
                "msgpack payload), which the port does not read; carry the "
                "parameters across with load_jax_params and train on")
    return f"{path} is not a {fmt} archive (it has no manifest)"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def check_state(module_state: Dict[str, torch.Tensor],
                arrays: Dict[str, np.ndarray], what: str) -> None:
    """Raise ``ValueError`` unless ``arrays`` holds exactly the keys and
    shapes of ``module_state``."""
    missing = sorted(set(module_state) - set(arrays))
    extra = sorted(set(arrays) - set(module_state))
    if missing or extra:
        raise ValueError(f"{what}: missing {missing}, unexpected {extra}")
    for k, v in module_state.items():
        if tuple(arrays[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k} has shape {arrays[k].shape}, "
                             f"the model {tuple(v.shape)}")


# ---------------------------------------------------------------------------
# Optimizer state, flattened by parameter name
# ---------------------------------------------------------------------------

def _param_names(model, optimizer) -> list:
    """The name of each of ``optimizer``'s parameters, in the order of its
    ``state_dict`` indices."""
    names = {id(p): n for n, p in model.nets.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _whole(model, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` (keyed by parameter name) with a tensor-parallel model's
    split rows gathered whole (every rank of the model axis joins)."""
    from ..parallel.mesh import whole_tensors
    return whole_tensors(model.nets, named)


def _local(model, named: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``named`` whole arrays cut to this rank's rows of a tensor-parallel
    model's split layers."""
    from ..parallel.mesh import local_tensors
    return local_tensors(model.nets, named)


def _optimizer_payload(model, optimizer, prefix: str):
    """(arrays, JSON description) of ``optimizer``'s state, whole."""
    sd = optimizer.state_dict()
    names = _param_names(model, optimizer)
    arrays = {}
    for i, state in sd["state"].items():
        for key, val in state.items():
            if val is None:
                continue
            if torch.is_tensor(val) and val.dim() >= 1:
                val = _whole(model, {names[i]: val})[names[i]]
            arrays[f"{prefix}.{names[i]}.{key}"] = (
                _to_numpy(val) if torch.is_tensor(val)
                else np.asarray(val))
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in sd["param_groups"]]
    return arrays, {"groups": groups, "params": names}


def _optimizer_state(model, optimizer, desc, arrays, prefix: str) -> dict:
    """The ``state_dict`` to load into ``optimizer`` from its saved state,
    checked against its parameters."""
    names = _param_names(model, optimizer)
    if sorted(names) != sorted(desc["params"]):
        raise ValueError(f"{prefix}: the checkpoint's parameters "
                         f"{desc['params']} are not the optimizer's {names}")
    current = optimizer.state_dict()
    if len(current["param_groups"]) != len(desc["groups"]):
        raise ValueError(f"{prefix}: {len(desc['groups'])} parameter groups "
                         f"saved, the optimizer has "
                         f"{len(current['param_groups'])}")
    state = {}
    for i, name in enumerate(names):
        head = f"{prefix}.{name}."
        entry = {k[len(head):]: torch.from_numpy(np.array(
                     _local(model, {name: v})[name] if v.ndim >= 1 else v))
                 for k, v in arrays.items() if k.startswith(head)}
        if entry:
            state[i] = entry
    groups = []
    for cur, saved in zip(current["param_groups"], desc["groups"]):
        g = dict(cur)
        for k, v in saved.items():  # JSON turns tuples into lists
            if k in _IMPLEMENTATION and k in cur:
                continue  # how the optimizer steps, not what it computes
            g[k] = tuple(v) if isinstance(cur.get(k), tuple) else v
        groups.append(g)
    return {"state": state, "param_groups": groups}


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _history(trainer):
    hist = getattr(trainer, "loss_history", None)
    kind = "loss_history" if hist is not None else "history"
    hist = hist if hist is not None else trainer.history
    return kind, {k: [float(x) for x in v] for k, v in hist.items()}


def _snapshot(model, trainer):
    """(arrays, manifest) of the whole state, copied to host memory (a
    tensor-parallel model's layers gathered whole: every rank joins)."""
    arrays = {f"model.{k}": _to_numpy(v)
              for k, v in _whole(model, model.nets.state_dict()).items()}
    gen = getattr(model, "generator", None)
    if gen is not None:
        arrays["model_generator"] = _to_numpy(gen.get_state())
    manifest = {"format": CHECKPOINT_FORMAT, "version": 1,
                "trainer": trainer is not None}
    if trainer is not None:
        if hasattr(trainer, "sync_history"):
            trainer.sync_history()  # pending losses become floats
        kind, hist = _history(trainer)
        manifest.update(current_epoch=int(trainer.current_epoch),
                        history_kind=kind, history=hist, optimizers={})
        for name in _OPTIMIZERS:
            opt = getattr(trainer, name, None)
            if opt is not None:
                arr, desc = _optimizer_payload(model, opt, name)
                arrays.update(arr)
                manifest["optimizers"][name] = desc
        accum = getattr(trainer, "grad_accumulator", None)
        if accum is not None:
            names = _param_names(model, accum.optimizer)
            arrays.update({f"accum.{n}": _to_numpy(a) for n, a in _whole(
                model, dict(zip(names, accum.acc))).items()})
            manifest["accum"] = {"k": accum.k, "mini_step": accum.mini_step}
        arrays["generator"] = _to_numpy(trainer.generator.get_state())
    return arrays, manifest


def _split_onto(model, trainer, mesh) -> bool:
    """Split a whole ``model`` over ``mesh``'s ``'model'`` axis (nothing
    when it is split already or the axis has one rank) and point
    ``trainer``'s optimizers and ``grad_accum`` window at the split
    parameters (their state is restored from the file next). Returns
    whether it split."""
    from ..parallel.collectives import Axis
    from ..parallel.mesh import tensor_parallel, tensor_parallel_params
    if tensor_parallel(model.nets) or Axis(mesh, "model").size == 1:
        return False
    names = {id(p): n for n, p in model.nets.named_parameters()}
    tensor_parallel_params(model, mesh)
    params = dict(model.nets.named_parameters())
    for name in _OPTIMIZERS:
        opt = getattr(trainer, name, None)
        if opt is None:
            continue
        for group in opt.param_groups:
            group["params"] = [params[names[id(p)]] for p in group["params"]]
        opt.state.clear()
    accum = getattr(trainer, "grad_accumulator", None)
    if accum is not None:
        accum.acc = [torch.zeros_like(p) for p in accum.params()]
    return True


# One registry of async writes per process, as in the JAX package: saves to
# the same path from any trainer join the previous write first, so they
# land in order, and a load waits for the path's write in flight.
_pending_lock = threading.Lock()
_pending_threads: dict = {}   # abspath -> writer thread
_pending_errors: dict = {}    # abspath -> first exception


def wait_for_checkpoints(path: Optional[str] = None) -> None:
    """Block until the ``save_checkpoint(async_write=True)`` writes in
    flight have finished (all of them, or those to ``path``); re-raises the
    error of a failed write."""
    key = None if path is None else os.path.abspath(path)
    with _pending_lock:
        items = [(p, t) for p, t in _pending_threads.items()
                 if key is None or p == key]
    for p, t in items:
        t.join()
        with _pending_lock:
            if _pending_threads.get(p) is t:
                del _pending_threads[p]
    with _pending_lock:
        if key is not None:
            err = _pending_errors.pop(key, None)
        else:
            errs = list(_pending_errors.values())
            _pending_errors.clear()
            err = errs[0] if errs else None
    if err is not None:
        raise err


def _check_backend(backend: str) -> None:
    if backend == "pickle":
        raise ValueError(
            "The 'pickle' checkpoint backend was removed (loading pickles "
            "can execute arbitrary code); checkpoints are pickle-free "
            "np.savez archives (backend='msgpack', the default)")
    if backend == "orbax":
        raise ValueError(
            "backend='orbax' is the JAX package's orbax directory format; "
            "the port has one pickle-free np.savez format and no orbax "
            "(backend='msgpack', the default)")
    if backend != "msgpack":
        raise ValueError(f"Unknown checkpoint backend {backend!r}; the port "
                         "has one: 'msgpack'")


def save_checkpoint(path: str, model, trainer=None, backend: str = "msgpack",
                    async_write: bool = False) -> None:
    """Write the full training state to ``path`` (see the module
    docstring). ``backend`` names the format as the JAX package's does; the
    port has one, ``"msgpack"``, and its archive holds no msgpack bytes.

    ``async_write=True`` returns once the state is copied to host memory;
    the file is written on a thread. Writes to the same path stay in order
    (each waits for that path's previous write), and
    :func:`load_checkpoint` waits for the path's pending write before it
    reads. The thread is not a daemon, so a normal exit finishes the write.

    Across ranks every rank calls it: each takes the snapshot (a
    tensor-parallel model's layers are gathered whole) and only global
    rank 0 writes the file.
    """
    from ..parallel.collectives import is_writer
    _check_backend(backend)
    key = os.path.abspath(path)
    wait_for_checkpoints(path)  # same-path writes in order; surface errors
    arrays, manifest = _snapshot(model, trainer)
    if not is_writer():
        return
    if not async_write:
        write_archive(path, arrays, manifest)
        return

    def writer(prev):
        if prev is not None:  # the path's earlier write lands first
            prev.join()
        try:
            write_archive(path, arrays, manifest)
        except BaseException as e:  # raised by wait_for_checkpoints
            with _pending_lock:
                _pending_errors[key] = e

    # registered and started under the lock: a waiter sees only started
    # threads, and the newest write of a path waits for the one before
    with _pending_lock:
        t = threading.Thread(target=writer, args=(_pending_threads.get(key),),
                             name="pvt-torch-ckpt-write")
        _pending_threads[key] = t
        t.start()


def _accum_state(model, trainer, manifest, arrays, path):
    """(the window's mean gradients, micro-step) to restore into the
    trainer's ``grad_accumulator``, checked; None when neither has one."""
    saved = manifest.get("accum")
    accum = getattr(trainer, "grad_accumulator", None)
    if saved is None and accum is None:
        return None
    if saved is None or accum is None or int(saved["k"]) != accum.k:
        raise ValueError(
            f"{path} was saved with grad_accum="
            f"{1 if saved is None else saved['k']}, the trainer has "
            f"grad_accum={1 if accum is None else accum.k}")
    names = _param_names(model, accum.optimizer)
    acc = []
    for name, a in zip(names, accum.acc):
        v = arrays.get(f"accum.{name}")
        if v is not None:
            v = _local(model, {name: v})[name]
        if v is None or tuple(v.shape) != tuple(a.shape):
            raise ValueError(f"{path}: the grad_accum window of {name} is "
                             "missing or of another shape")
        acc.append(torch.from_numpy(np.array(v)))
    return acc, int(saved["mini_step"])


def _checked(path, manifest, arrays, model, trainer):
    """(model arrays, optimizer states, grad_accum window, history
    attribute) of the file for ``model`` and ``trainer`` as they are now
    (a split model's rows), every shape and name checked; raises
    ``ValueError`` on the first that does not fit."""
    model_arrays = {k[len("model."):]: v for k, v in arrays.items()
                    if k.startswith("model.")}
    model_arrays = _local(model, model_arrays)
    check_state(model.nets.state_dict(), model_arrays, "checkpoint")
    opt_states, accum, hist_attr = {}, None, None
    if trainer is not None:
        if not manifest.get("trainer"):
            raise ValueError(f"{path} holds no trainer state")
        for name, desc in manifest["optimizers"].items():
            opt = getattr(trainer, name, None)
            if opt is None:
                raise ValueError(f"{path} holds a state for {name}, which "
                                 f"{type(trainer).__name__} does not have")
            opt_states[name] = _optimizer_state(model, opt, desc, arrays,
                                                name)
        accum = _accum_state(model, trainer, manifest, arrays, path)
        hist_attr = ("loss_history" if manifest["history_kind"]
                     == "loss_history" and hasattr(trainer, "loss_history")
                     else "history")
    return model_arrays, opt_states, accum, hist_attr


def load_checkpoint(path: str, model, trainer=None,
                    backend: str = "msgpack", mesh=None) -> None:
    """Restore the state :func:`save_checkpoint` wrote into ``model`` (and
    ``trainer``) in place. Everything is read and checked before anything
    is restored, so a file that does not fit raises and changes nothing.

    The file holds the whole model. A tensor-parallel model takes its
    rank's rows of each split layer (and of their optimizer state). With
    ``mesh`` (a ``DeviceMesh`` with a ``'model'`` axis), a whole model is
    first split over it (``tensor_parallel_params``), and ``trainer``'s
    optimizers and ``grad_accum`` window move onto the split parameters,
    as the JAX package's ``load_checkpoint(..., mesh=)`` restores the saved
    shardings onto a live mesh."""
    _check_backend(backend)
    wait_for_checkpoints(path)  # not mid-write by an async save
    manifest, arrays = read_archive(path, CHECKPOINT_FORMAT)
    # the whole file against the model as it is, before a split changes it
    state = _checked(path, manifest, arrays, model, trainer)
    if mesh is not None and _split_onto(model, trainer, mesh):
        state = _checked(path, manifest, arrays, model, trainer)
    model_arrays, opt_states, accum, hist_attr = state
    # restore
    model.nets.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in model_arrays.items()},
        strict=True)
    gen = getattr(model, "generator", None)
    if gen is not None and "model_generator" in arrays:
        gen.set_state(torch.from_numpy(np.array(arrays["model_generator"])))
    model._weights_replaced()  # the trainers' captured epochs made again
    if trainer is None:
        return
    for name, sd in opt_states.items():
        getattr(trainer, name).load_state_dict(sd)
    if accum is not None:
        acc, mini_step = accum
        for a, v in zip(trainer.grad_accumulator.acc, acc):
            a.copy_(v)
        trainer.grad_accumulator.mini_step = mini_step
    trainer.generator.set_state(torch.from_numpy(np.array(
        arrays["generator"])))
    trainer.current_epoch = int(manifest["current_epoch"])
    setattr(trainer, hist_attr, {k: list(v) for k, v in
                                 manifest["history"].items()})
