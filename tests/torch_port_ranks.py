"""Rank bodies of the port's multi-rank tests, and the launcher that runs
them: one process per rank on the CPU, joined over gloo. This module
imports only torch, numpy and the port, so that the ranks start quickly
and run nothing of JAX; the tests build every input (weights, batches,
the JAX trainers' noise) in their own process and hand it over in a file.

A rank runs as ``python torch_port_ranks.py SPEC RANK WORLD RENDEZVOUS
OUT``: it reads the spec (a list of ``(key, body, arguments)``), joins the group
through a ``file://`` rendezvous (no port, so parallel test workers never
collide) with one torch thread, runs each body (an exception becomes that
body's result, as its traceback), writes the results and destroys the
group. :class:`Ranks` starts the ranks and kills them all if they
outlast its timeout."""
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.parallel import (create_mesh, data_parallel_mesh,
                                        initialize_multihost,
                                        make_spmd_train_step,
                                        pixel_sharded_decode,
                                        replicate_params, shard_pixels,
                                        tensor_parallel_params)
from pyroved_tpu_torch.nets.conv import batch_stats_over
from pyroved_tpu_torch.parallel.mesh import (ColumnParallel,
                                             ColumnParallelLinear,
                                             split_parameters, tensor_parallel,
                                             whole_tensors)
from pyroved_tpu_torch.serving import export_model
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                wait_for_checkpoints)
from pyroved_tpu_torch.utils.data import init_dataloader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Launcher (runs in the test process)
# ---------------------------------------------------------------------------

class Ranks:
    """``world`` ranks started at once on ``bodies`` (``[(key, body,
    kwargs), ...]``), running while the caller computes its references;
    :meth:`get` waits for them. A rank that exits non-zero, or a group that
    outlasts ``timeout`` seconds from its start (every rank then killed),
    fails with the ranks' output."""

    def __init__(self, tmp_path, world: int, bodies, timeout: float = 240.0):
        self.tmp = tempfile.mkdtemp(dir=str(tmp_path))
        spec = os.path.join(self.tmp, "spec.pt")
        torch.save(list(bodies), spec)
        rdv = os.path.join(self.tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        self.world, self.timeout = world, timeout
        self.outs = [os.path.join(self.tmp, f"rank{r}.pt")
                     for r in range(world)]
        self.logs = [open(os.path.join(self.tmp, f"rank{r}.log"), "w+")
                     for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(r),
             str(world), rdv, self.outs[r]], env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        self._results = None

    def _wait(self) -> list:
        hung = []
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [p for p in self.procs if p.poll() is None]
            for p in hung:
                p.kill()
            for p in hung:
                p.wait()
        text = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {self.procs[r].returncode}) "
                        "---\n" + f.read()[-6000:])
            f.close()
        if hung:
            raise AssertionError(
                f"{len(hung)} of {self.world} ranks outlasted "
                f"{self.timeout} s and were killed\n" + "".join(text))
        if any(p.returncode != 0 for p in self.procs):
            raise AssertionError("a rank failed\n" + "".join(text))
        return [torch.load(o, weights_only=False) for o in self.outs]

    def get(self, key: str, rank: int = 0):
        """One body's result on one rank (waiting for the ranks the first
        time); a body that raised fails here with its traceback."""
        if self._results is None:
            try:
                self._results = self._wait()
            except AssertionError as e:
                self._results = e
        if isinstance(self._results, AssertionError):
            raise self._results
        out = self._results[rank][key]
        if isinstance(out, str):
            raise AssertionError(f"{key} failed on rank {rank}:\n{out}")
        return out

    def all(self, key: str) -> list:
        return [self.get(key, r) for r in range(self.world)]


@contextlib.contextmanager
def one_rank_mesh(axes=None):
    """A one-rank world in this process (its own in-memory store) and a
    mesh over it; the group is destroyed on the way out."""
    initialize_multihost(device="cpu")
    try:
        yield create_mesh(axes)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Helpers of the bodies
# ---------------------------------------------------------------------------

class FedNoiseSVI(SVItrainer):
    """SVItrainer whose noise is a given table ``[epochs, steps, ...]``,
    consumed one epoch (of training or evaluation) per row, as the JAX
    trainers' key chain gives it."""

    def __init__(self, model, noise, **kw):
        super().__init__(model, **kw)
        self._table, self._e, self._s = noise, -1, 0

    def _epoch(self, loader, scale_factor, train):
        self._e, self._s = self._e + 1, 0
        return super()._epoch(loader, scale_factor, train)

    def _noise(self, batch_size):
        eps = torch.from_numpy(np.array(self._table[self._e][self._s]))
        self._s += 1
        return eps.to(self.device)


class FedNoiseAux(auxSVItrainer):
    """auxSVItrainer drawing from given tables: unlabeled step i of epoch e
    takes ``unl[e, i]``, the labeled step after it ``lab[e, i]``."""

    def __init__(self, model, unl, lab, **kw):
        super().__init__(model, **kw)
        self._unl, self._lab, self._e, self._i = unl, lab, -1, -1

    def train(self, *a, **k):
        self._e, self._i = self._e + 1, -1
        return super().train(*a, **k)

    def draw_noise(self, batch_size, labeled):
        self._i += 0 if labeled else 1
        table = self._lab if labeled else self._unl
        return torch.from_numpy(np.array(table[self._e][self._i]))


def build(cls, args, kw, state):
    """A port model on the CPU holding ``state`` (a state_dict of numpy
    arrays)."""
    m = getattr(tmodels, cls)(*args, device="cpu", **kw)
    m.nets.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return m


def params(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.nets.state_dict().items()}


def grads(model) -> dict:
    return {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.detach().numpy().copy())
            for n, p in model.nets.named_parameters()}


def counted(calls):
    """Count the kernel wrappers' calls (their plain versions here)."""
    for k, name in (("K1", "fused_spatial_decoder_forward"),
                    ("K2", "fused_spatial_decoder_backward"),
                    ("K3", "fused_bernoulli_recon_loss_kernel")):
        fn = getattr(tsd, name)

        def wrapper(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        setattr(tsd, name, wrapper)


def flag(bf16: bool):
    tsd.BF16_MATMUL = bool(bf16)


def tensors(batch):
    return tuple(torch.from_numpy(np.array(b)) for b in batch)


# ---------------------------------------------------------------------------
# Bodies: each takes (rank, world, **kwargs) and returns a dict
# ---------------------------------------------------------------------------

def body_world(rank, world):
    mesh = data_parallel_mesh()
    return {"world": WORLD, "rank": dist.get_rank(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "local": mesh.get_local_rank("data")}


def body_mesh_shapes(rank, world):
    out = {}
    for key, axes in (("dp_tp", {"data": 2, "model": 2}),
                      ("absorb", {"data": -1, "model": 2})):
        m = create_mesh(axes)
        out[key] = dict(zip(m.mesh_dim_names, m.mesh.shape))
        out[key + "_coord"] = m.get_coordinate()
    try:
        create_mesh({"data": 3})
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


def body_train(rank, world, cls, args, kw, state, x, batch_size, seed,
               noise, epochs=1, how="train", axes=None, bf16=False,
               trainer_kw=None, ckpt=None, pixels=None):
    """Train a model held by ``state`` on ``x`` with a mesh (``axes``,
    default ``{'data': world}``) and the given noise: ``epochs`` calls of
    ``train``, or one ``run`` (``how="run"``), or under ``how="resume"``
    half the epochs, a checkpoint, a fresh model and trainer resumed from
    it and the rest. ``pixels`` shards the grid over that axis."""
    flag(bf16)
    mesh = create_mesh(axes)
    calls = {"K1": 0, "K2": 0, "K3": 0}
    counted(calls)

    def make(st):
        m = build(cls, args, kw, st)
        if pixels:
            shard_pixels(m, mesh, pixels)
        return m, FedNoiseSVI(m, noise, mesh=mesh, **(trainer_kw or {}))

    def loader():
        return init_dataloader(*tensors(x), batch_size=batch_size, seed=seed,
                               device="cpu")

    m, t = make(state)
    if how == "train":
        ld = loader()
        losses = [t.train(ld) for _ in range(epochs)]
    elif how == "run":
        losses = t.run(loader(), epochs)
    else:  # resume
        half = epochs // 2
        t.checkpoint_path, t.checkpoint_every = ckpt, half
        t.run(loader(), half)
        m2, t2 = make({k: np.zeros_like(v) for k, v in state.items()})
        t2._e = -1 + half  # the fed noise resumes at the saved epoch
        assert t2.resume(ckpt) == half
        ld = loader()
        ld.set_epoch(half)
        t2.run(ld, epochs - half)
        m, t, losses = m2, t2, t2.loss_history["training_loss"]
    return {"losses": [float(v) for v in losses], "params": params(m),
            "calls": dict(calls), "fused": m._fused}


def body_surface(rank, world, state, x, xt, noise, batch_size, epochs, log,
                 jstate, jnoise):
    """The trainer surface under a 'data' axis: ``run`` with a held-out
    loader, ``patience``, ``on_segment``, a JSONL log (rank 0 writes it)
    and ``remat``, then ``evaluate``, ``step`` and ``print_statistics``
    (rank 0 prints); and jiVAE's ``run(enum_schedule=1)``."""
    flag(False)
    mesh = create_mesh()
    return surface_run(mesh, state, x, xt, noise, batch_size, epochs, log,
                       jstate, jnoise)


def surface_run(mesh, state, x, xt, noise, batch_size, epochs, log, jstate,
                jnoise):
    """:func:`body_surface`'s work, with ``mesh`` (None: one process)."""
    small = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
    m = build("iVAE", ((8, 8), 2, ["r"]), small, state)
    t = FedNoiseSVI(m, noise, mesh=mesh, remat=True, log_file=log)
    ld = init_dataloader(*tensors((x,)), batch_size=batch_size, seed=1,
                         device="cpu")
    lt = init_dataloader(*tensors((xt,)), batch_size=batch_size, seed=2,
                         device="cpu")
    records = []
    t.run(ld, epochs, test_loader=lt, patience=2, on_segment=records.extend)
    out = {"evaluate": t.evaluate(lt)}
    t.step(ld, lt)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t.print_statistics()
    out.update(history=t.loss_history, records=records,
               printed=buf.getvalue(), params=params(m),
               epoch=t.current_epoch)
    j = build("jiVAE", ((8, 8), 2, 3, ["r"]), dict(small, enum_topk=2),
              jstate)
    jt = FedNoiseSVI(j, jnoise, mesh=mesh)
    out["enum"] = jt.run(init_dataloader(*tensors((x,)),
                                         batch_size=batch_size, seed=3,
                                         device="cpu"), 2, enum_schedule=1)
    out["enum_params"] = params(j)
    return out


def body_aux(rank, world, args, kw, state, xu, xl, yl, batch_size, unl, lab,
             epochs, grad_accum=1):
    flag(False)
    mesh = create_mesh()
    m = build("ssiVAE", args, kw, state)
    t = FedNoiseAux(m, unl, lab, mesh=mesh, seed=3, grad_accum=grad_accum)
    lu = init_dataloader(*tensors((xu,)), batch_size=batch_size, seed=1,
                         device="cpu")
    ls = init_dataloader(*tensors((xl, yl)), batch_size=batch_size // 2,
                         seed=2, device="cpu")
    losses = t.run(lu, ls, epochs)
    return {"losses": [float(v) for v in losses], "params": params(m)}


def body_tp(rank, world, state, x, noise, batch_size, seed):
    """DP x TP: the layers split over 'model', the batch over 'data'."""
    flag(False)
    mesh = create_mesh({"data": 2, "model": 2})
    calls = {"K1": 0, "K2": 0, "K3": 0}
    counted(calls)
    m = build("iVAE", ((8, 8), 2, ["r"]), {}, state)
    fused_before = m._fused
    tensor_parallel_params(m, mesh)
    dec = m.nets["decoder"]
    t = FedNoiseSVI(m, noise, mesh=mesh)
    ld = init_dataloader(*tensors((x,)), batch_size=batch_size, seed=seed,
                         device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = t.train(ld)
    return {"loss": float(loss), "params": params(m),
            "coord": mesh.get_coordinate(), "calls": dict(calls),
            "fused_before": fused_before, "fused_after": m._fused,
            "warnings": [str(w.message) for w in caught],
            "dense0": (type(dec.MLP_0.Dense_0).__name__,
                       tuple(dec.MLP_0.Dense_0.weight.shape)),
            "out": (type(dec.out).__name__, tuple(dec.out.weight.shape)),
            "split": sorted(n for n, mod in m.nets.named_modules()
                            if isinstance(mod, ColumnParallelLinear))}


def body_spmd(rank, world, state, x, w, eps, steps):
    """make_spmd_train_step with the JAX step's folded noise (``eps[k]``:
    this rank's rows' noise of step k), then with its own generator."""
    flag(False)
    mesh = create_mesh()
    out = {}
    for tag, fed in (("fed", True), ("own", False)):
        m = build("iVAE", ((8, 8), 2, ["r"]), {}, state)
        opt = torch.optim.Adam(m.nets.parameters(), lr=1e-3)
        step = make_spmd_train_step(m, opt, mesh)
        losses, after1 = [], None
        for k in range(steps):
            e = torch.from_numpy(np.array(eps[k][rank])) if fed else None
            losses.append(float(step(tensors((x,)), torch.from_numpy(w),
                                     eps=e)))
            if k == 0:
                after1 = params(m)
        out[tag] = {"losses": losses, "after1": after1, "params": params(m)}
    try:
        step(tensors((x[:3],)), torch.from_numpy(w[:3]))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def body_decode(rank, world, cases):
    """pixel_sharded_decode against the model's own decode."""
    flag(False)
    mesh = create_mesh()
    out = {}
    for name, (data, state, z, fused) in cases.items():
        m = build("iVAE", (data, 2, ["r"]), {"fused": fused}, state)
        zt = torch.from_numpy(z)
        sharded = pixel_sharded_decode(m, zt, mesh)
        local = m.decode(zt).reshape(zt.shape[0], -1)
        out[name] = {"sharded": sharded.numpy(), "local": local.numpy()}
    try:
        pixel_sharded_decode(tmodels.iVAE((8, 8), 2, device="cpu"),
                             torch.zeros(2, 2), mesh)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


def body_replicate(rank, world):
    """replicate_params gives every rank rank 0's weights."""
    mesh = create_mesh()
    m = tmodels.iVAE((8, 8), 2, ["r"], device="cpu", seed=10 + rank)
    before = params(m)
    replicate_params(m, mesh)
    return {"before": before, "after": params(m)}


def body_shard_loss(rank, world, cases, axes=None):
    """Per-example losses and every grad under ``shard_pixels`` over
    'pixels' (each rank's own: all must be whole)."""
    flag(False)
    mesh = create_mesh(axes or {"pixels": world})
    calls = {"K1": 0, "K2": 0, "K3": 0}
    counted(calls)
    out = {}
    for name, c in cases.items():
        m = build(c["cls"], c["args"], c["kw"], c["state"])
        shard_pixels(m, mesh)
        assert m._pixel_mode() == "shard"
        batch = tensors(c["batch"])
        eps = c["eps"]
        eps = (tuple(None if e is None else torch.from_numpy(np.array(e))
                     for e in eps) if isinstance(eps, tuple)
               else torch.from_numpy(np.array(eps)))
        for k in calls:
            calls[k] = 0
        m.nets.zero_grad(set_to_none=True)
        per = m.loss_fn(batch[0], batch[1] if len(batch) > 1 else None,
                        c["beta"], eps=eps)
        per.sum().backward()
        out[name] = {"loss": per.detach().numpy(), "grads": grads(m),
                     "calls": dict(calls)}
    return out


def body_shard_flip(rank, world, state, x, noise, batch_size, seed):
    """One epoch with the grid sharded over 'pixels', then
    ``shard_pixels(model, None)`` and one on the full grid."""
    flag(False)
    mesh = create_mesh({"pixels": world})
    m = build("iVAE", ((9, 9), 2, ["r"]), {}, state)
    shard_pixels(m, mesh)
    t = FedNoiseSVI(m, noise, seed=1)
    ld = init_dataloader(*tensors((x,)), batch_size=batch_size, seed=seed,
                         device="cpu")
    losses = [t.train(ld)]
    shard_pixels(m, None)
    modes = [m._pixel_mode()]
    losses.append(t.train(ld))
    return {"losses": losses, "params": params(m), "modes": modes}


def whole(model) -> dict:
    """The parameters with every split layer gathered whole (every rank of
    its axis joins)."""
    return {k: v.detach().numpy().copy() for k, v in
            whole_tensors(model.nets, model.nets.state_dict()).items()}


def body_tp_split(rank, world, cases):
    """Each case's model whole and split over 'model': the per-example
    losses of one weighted loss, every grad gathered whole, and what was
    split."""
    flag(False)
    mesh = create_mesh({"model": world})
    out = {}
    for name, c in cases.items():
        res = {}
        for split in (False, True):
            m = build(c["cls"], c["args"], c["kw"], c["state"])
            if split:  # no trainer: the loss right after the split
                tensor_parallel_params(m, mesh)
            batch = tensors(c["batch"])
            per = m.loss_fn(batch[0], batch[1] if len(batch) > 1 else None,
                            c["beta"], eps=torch.from_numpy(c["eps"]))
            (per * torch.from_numpy(c["w"])).sum().backward()
            g = {n: p.grad for n, p in m.nets.named_parameters()}
            res["split" if split else "whole"] = {
                "loss": per.detach().numpy(),
                "grads": {k: v.numpy() for k, v in
                          whole_tensors(m.nets, g).items()}}
        res["layers"] = sorted(
            (n, type(mod).__name__) for n, mod in m.nets.named_modules()
            if isinstance(mod, ColumnParallel))
        res["split_params"] = sorted(split_parameters(m.nets))
        out[name] = res
    return out


def body_tp_checkpoint(rank, world, state, x, batch_size, tmp):
    """A model split over 'model': 4 epochs in one go; 2 epochs with a
    checkpoint, the weights and an export written at epoch 2; the
    checkpoint loaded into a whole model with ``mesh=`` and resumed, and
    loaded with the trainer built on the whole model; replicate_params."""
    flag(False)
    mesh = create_mesh({"model": world})
    args, kw = ((8, 8), 2, ["r"]), dict(hidden_dim_e=(32,),
                                        hidden_dim_d=(32,))

    def loader():
        return init_dataloader(*tensors((x,)), batch_size=batch_size, seed=4,
                               device="cpu")

    def split_model():
        return tensor_parallel_params(build("iVAE", args, kw, state), mesh)

    u = split_model()
    tu = SVItrainer(u, mesh=mesh, seed=5)
    tu.run(loader(), 4)
    ck = os.path.join(tmp, "tp.npz")
    i = split_model()
    ti = SVItrainer(i, mesh=mesh, seed=5, checkpoint_path=ck,
                    checkpoint_every=2)
    ti.run(loader(), 2)
    i.save_weights(os.path.join(tmp, "tp_weights"))
    export_model(i, os.path.join(tmp, "tp_export.npz"))
    for mode in (False, True):  # every rank gathers, rank 0 alone writes
        save_checkpoint(os.path.join(tmp, f"writer{rank}_{int(mode)}.npz"),
                        i, ti, async_write=mode)
    wait_for_checkpoints()
    out = {"split": sorted(split_parameters(i.nets)), "saved": params(i),
           "saved_whole": whole(i), "history": tu.loss_history,
           "uninterrupted": whole(u)}
    r = build("iVAE", args, kw, state)
    load_checkpoint(ck, r, mesh=mesh)
    out["loaded"] = params(r)
    tr = SVItrainer(r, mesh=mesh, seed=5)
    ld = loader()
    ld.set_epoch(tr.resume(ck))
    tr.run(ld, 2)
    out.update(resumed=whole(r), resumed_history=tr.loss_history)
    r2 = build("iVAE", args, kw, state)
    tr2 = SVItrainer(r2, mesh=mesh, seed=5)
    load_checkpoint(ck, r2, tr2, mesh=mesh)
    ld = loader()
    ld.set_epoch(tr2.current_epoch)
    tr2.run(ld, 2)
    out["resumed_whole_trainer"] = whole(r2)
    refused = {}
    for what in ("grad_accum", "width"):  # a file that does not fit
        kw3 = kw if what == "grad_accum" else dict(hidden_dim_e=(16,),
                                                   hidden_dim_d=(16,))
        r3 = tmodels.iVAE(*args, device="cpu", seed=0, **kw3)
        t3 = SVItrainer(r3, mesh=mesh, seed=5,
                        grad_accum=2 if what == "grad_accum" else 1)
        before = params(r3)
        try:
            load_checkpoint(ck, r3, t3, mesh=mesh)
            raised = False
        except ValueError:
            raised = True
        live = {id(p) for p in r3.nets.parameters()}
        refused[what] = dict(
            raised=raised, split=tensor_parallel(r3.nets),
            unchanged=all(np.array_equal(v, before[k])
                          for k, v in params(r3).items()),
            optimizer_on_model=all(id(p) in live
                                   for g in t3.optimizer.param_groups
                                   for p in g["params"]))
    out["refused"] = refused
    rep = split_model()
    with torch.no_grad():
        for p in rep.nets.parameters():
            p.add_(float(rank))
    replicate_params(rep, mesh)
    out["replicated"] = whole(rep)
    return out


def body_bn_dp(rank, world, cls, args, kw, state, first, x, noise,
               batch_size, epochs):
    """A batchnorm model over 'data': the first step's loss and grads
    (no update), then ``epochs`` epochs of the trainer."""
    flag(False)
    mesh = create_mesh({"data": world})
    m = build(cls, args, kw, state)
    t = FedNoiseSVI(m, noise, mesh=mesh)
    xb, yb, w, eps = first
    batch, wl, e = t.data_axis.local(tensors((xb, yb)), torch.from_numpy(w),
                                     torch.from_numpy(eps))
    with batch_stats_over(m.nets, t.data_axis):
        loss = m.weighted_loss_fn(batch[0], batch[1], wl, 1.0, eps=e)
        loss.backward()
    loss = t.data_axis.reduce_grads(t.optimizer, loss)
    out = {"first_loss": float(loss), "first_grads": grads(m)}
    m.nets.zero_grad(set_to_none=True)
    ld = init_dataloader(*tensors(x), batch_size=batch_size, seed=3,
                         device="cpu")
    out["losses"] = [float(t.train(ld)) for _ in range(epochs)]
    out["params"] = params(m)
    return out


BODIES = {k[len("body_"):]: v for k, v in dict(globals()).items()
          if k.startswith("body_")}
WORLD = None  # initialize_multihost's return in this rank


def main(argv) -> int:
    global WORLD
    spec, rank, world, rdv, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    bodies = torch.load(spec, weights_only=False)
    WORLD = initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    results = {}
    try:
        for key, name, kwargs in bodies:
            try:
                results[key] = BODIES[name](rank, world, **kwargs)
            except Exception:
                results[key] = traceback.format_exc()
        torch.save(results, out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
