"""Stochastic variational inference trainer.

Counterpart of ``pyroved_tpu/trainers/svi.py`` with the same surface:
``train`` / ``evaluate`` / ``step`` / ``run`` / ``print_statistics`` /
``loss_history``, each step minimizing the weighted SUM of per-example
negative ELBOs and each epoch's loss normalized by the dataset size.

The JAX trainer runs an epoch as one compiled ``lax.scan``, and a chunked
streaming epoch as one scan a chunk. Here, on a CUDA model over a
device-resident :class:`~pyroved_tpu_torch.utils.data.DataLoader`, the
training and the evaluation epoch are each captured once as a CUDA graph
and replayed, one graph launch an epoch; over a streaming DataLoader with
``stream_chunks=c > 1`` each chunk of c batches is, its rows copied into
the program's tables while the previous chunk replays (:mod:`._graph`: the
first run of each program is eager, the capture's warm-up, and the graph
gives the eager loop's trajectory bit for bit; ``grad_accum`` included).
Every other configuration runs an epoch as a Python loop over batches: CPU
models, a streaming loader of one batch at a time (staged from the host)
or any iterable of batches (a short final batch padded with zero weights),
a ``mesh``, ``pixel_chunks`` and an optimizer the graph cannot take
(:func:`._graph.route`). Either way the per-step losses stay on the device
and the host reads them only at ``float()``, ``sync_history`` and the
segment ends of ``run``. Optimization is ``torch.optim.Adam(lr=1e-3)``
(betas 0.9/0.999, eps 1e-8, as ``optax.adam``), on CUDA with
``capturable=True``, its step count and bias corrections on the device,
on the captured path and the eager loop alike. The latent noise comes from
a ``torch.Generator`` on the model's device seeded from ``seed``, in the
shapes the model states (``noise_shapes``), one draw per step in the order
of the steps whatever the loader; it cannot reproduce JAX's random bits, so
:meth:`SVItrainer.train_step` also takes injected noise. A model with
``prep_beta`` (jiVAE) takes the KL scale as a ``[beta_cont, beta_disc]``
pair.

``grad_accum=k`` averages the gradients of k consecutive steps and updates
once (``optax.MultiSteps``); ``remat=True`` recomputes each step's forward
in its backward (``torch.utils.checkpoint``). ``log_file`` appends one
JSONL record per epoch; ``checkpoint_path`` saves the full training state
(:mod:`~pyroved_tpu_torch.utils.checkpoint`) after every
``checkpoint_every``-th epoch (default 10) of ``step`` and ``run``, and
:meth:`SVItrainer.resume` restores it. ``run`` takes ``patience``,
``on_segment`` and ``enum_schedule`` (:mod:`._segmented`).

``mesh`` (a ``DeviceMesh``, :mod:`pyroved_tpu_torch.parallel`) trains data
parallel over its ``'data'`` axis, one rank per device, each rank running
this trainer on the same loader, seed and model: every rank gathers the
whole batch and draws the whole batch's noise, keeps its contiguous rows,
and after the backward one ``all_reduce`` sums every grad and the loss, so
that the same optimizer step on every rank gives the single-device
trajectory. Under ``grad_accum`` each micro-step's grads are summed before
they enter the window. The kernels' gate is checked again at every
``train`` and ``evaluate`` (``sync_fusion_gate``: a tensor-parallel decoder
turns them off). Checkpoints, JSONL records and ``print_statistics`` are
written by global rank 0 alone, every rank waiting after each checkpoint;
``resume`` loads on every rank.
"""
import time
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _remat

from ..parallel.collectives import DataAxis, barrier, distributed, is_writer
from ..nets.conv import batch_stats_over
from ..utils.data import DataLoader, StaticTables
from . import _graph
from ._segmented import SegmentedRunsMixin

Tensor = torch.Tensor


def draw_noise(model, generator: torch.Generator, batch_size: int,
               labeled: bool = False):
    """Standard-normal noise of one batch of ``batch_size`` rows from
    ``generator``, in the shapes ``model.noise_shapes`` states: one tensor,
    or a tuple when the model needs several (None where it needs none)."""
    eps = tuple(None if s is None else
                torch.randn(s, generator=generator, device=generator.device)
                for s in model.noise_shapes(batch_size, labeled))
    return eps[0] if len(eps) == 1 else eps


def fill_zero_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero grad for every parameter that got none, so that the step
    moves it by its momentum and advances its count, as ``optax.adam``
    updates every leaf at every step (``torch.optim.Adam`` skips a
    parameter whose grad is None). The zeros are made once per parameter
    and kept on the optimizer (nothing writes them), so a captured step
    allocates none."""
    zeros = optimizer.__dict__.setdefault("_zero_grads", {})
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                z = zeros.get(p)
                if z is None or z.shape != p.shape or z.device != p.device:
                    z = zeros[p] = torch.zeros_like(p)
                p.grad = z


class GradAccumulator:
    """``optax.MultiSteps(optimizer, every_k_schedule=k)`` over a torch
    optimizer: :meth:`step` folds the parameters' grads into their running
    mean (``acc + (g - acc) / (n + 1)``, n the micro-step in the window)
    and steps the optimizer on every k-th call only, with the mean as the
    grad; between updates the optimizer does not step at all, so its
    step counts advance once per update. ``acc`` and ``mini_step`` are the
    window's state (saved by checkpoints). A captured program freezes
    each micro-step's divisor and whether it updates, so the window's
    position at its start is part of its variant, and ``mini_step`` is set
    after each run (:meth:`._graph.GraphCache.run`)."""

    def __init__(self, optimizer: torch.optim.Optimizer, k: int):
        self.optimizer = optimizer
        self.k = int(k)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params()]

    def params(self) -> list:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def step(self) -> None:
        params = self.params()
        grads = [p.grad for p in params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return
        for p, a in zip(params, self.acc):
            p.grad = a.clone()
        self.optimizer.step()
        torch._foreach_zero_(self.acc)
        self.mini_step = 0


def apply_update(optimizer: torch.optim.Optimizer,
                 accumulator: Optional[GradAccumulator]) -> None:
    """Step ``optimizer`` on its parameters' grads (every parameter gets
    one), through ``accumulator`` when it has one."""
    fill_zero_grads(optimizer)
    if accumulator is None:
        optimizer.step()
    else:
        accumulator.step()


def save_state(trainer, async_write: bool = False) -> None:
    """Save ``trainer``'s checkpoint at its ``checkpoint_path``: every rank
    takes the snapshot (a tensor-parallel model's layers are gathered
    whole), global rank 0 writes it, and then, across ranks, every rank
    waits for the file (written at once there; ``async_write`` holds only
    in one process)."""
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(trainer.checkpoint_path, trainer.model, trainer,
                    async_write=async_write and not distributed())
    barrier()


def save_if_due(trainer) -> None:
    """Save ``trainer``'s checkpoint when it has a ``checkpoint_path`` and
    its ``current_epoch`` is a multiple of ``checkpoint_every``."""
    if (trainer.checkpoint_path
            and trainer.current_epoch % trainer.checkpoint_every == 0):
        save_state(trainer)


def sync_gate(model) -> None:
    """The model's kernels' gate, checked again (``sync_fusion_gate``)."""
    gate = getattr(model, "sync_fusion_gate", None)
    if gate is not None:
        gate()


def streamed_batches(loader, device):
    """``(batch, weights, rows)`` of each batch of an iterable of batches
    (tuples of arrays or tensors, or bare arrays), on ``device``; a batch
    shorter than the first is padded with zero rows of weight 0, a longer
    one raises ``ValueError``."""
    bs = None
    for i, batch in enumerate(loader):
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        batch = tuple(to_device(b, device) for b in batch)
        n = batch[0].shape[0]
        bs = bs or n
        if n > bs:
            raise ValueError(
                f"Streaming batch {i} has {n} examples, larger than the "
                f"first batch ({bs}); yield batches of a fixed size (a "
                "short FINAL batch is fine — it is padded).")
        yield pad_batch(batch, bs) + (n,)


def to_device(b, device) -> Tensor:
    """An array or tensor on ``device``; floats become float32."""
    t = b if isinstance(b, Tensor) else torch.as_tensor(np.asarray(b))
    t = t.to(device)
    return t.to(torch.float32) if t.is_floating_point() else t


def pad_batch(batch, batch_size: int):
    """(batch padded to ``batch_size`` rows with zeros, weights: 1 for the
    real rows, 0 for the padding)."""
    n = batch[0].shape[0]
    w = torch.ones(batch_size, device=batch[0].device)
    if n == batch_size:
        return batch, w
    w[n:] = 0.0
    return tuple(torch.cat([b, b.new_zeros((batch_size - n,) + b.shape[1:])])
                 for b in batch), w


class _PendingLoss:
    """A queued epoch loss from ``step(sync=False)``: the 0-d device total
    and the host normalizer. ``float()`` waits for the device and divides
    on the host in float64, exactly as the synchronous path does."""
    __slots__ = ("total", "norm")

    def __init__(self, total: Tensor, norm):
        self.total, self.norm = total, norm

    def __float__(self) -> float:
        return float(self.total) / self.norm

    def __repr__(self) -> str:
        return f"_PendingLoss(norm={self.norm})"


class SVItrainer(SegmentedRunsMixin):
    """Epoch-level SVI trainer for one-encoder/one-decoder models.

    Args:
        model: a port model with ``nets``, ``device`` and
            ``weighted_loss_fn(x, y, weights, beta, eps=None)``.
        optimizer: a ``torch.optim.Optimizer`` over ``model.nets``'
            parameters (default ``Adam(lr)``, ``capturable`` on CUDA:
            :func:`._graph.default_optimizer`).
        loss: a :class:`~pyroved_tpu_torch.infer.elbo.TraceELBO` whose
            settings are applied to the model.
        enumerate_parallel: accepted for the JAX package's signature.
        seed: seed of the latent noise.
        lr: learning rate of the default optimizer (1e-3).
        grad_accum: update once every ``grad_accum`` steps on the mean of
            their gradients (the window carries across epochs).
        remat: recompute each step's forward in its backward.
        log_file: append one JSONL record per epoch.
        checkpoint_path: where to save the training state, after every
            ``checkpoint_every``-th epoch (default 10).
        mesh: a ``DeviceMesh``; its ``'data'`` axis splits each batch's
            rows over the ranks (module docstring).
    """

    def __init__(self, model, optimizer: Optional[torch.optim.Optimizer] = None,
                 loss=None, enumerate_parallel: bool = False, seed: int = 1,
                 **kwargs):
        del enumerate_parallel  # enumeration lives in the models' loss_fn
        self.mesh = kwargs.pop("mesh", None)
        self.data_axis = DataAxis(self.mesh)
        lr = float(kwargs.pop("lr", 1e-3))
        self.grad_accum = int(kwargs.pop("grad_accum", 1) or 1)
        self.remat = bool(kwargs.pop("remat", False))
        self.log_file = kwargs.pop("log_file", None)
        self.checkpoint_path = kwargs.pop("checkpoint_path", None)
        self.checkpoint_every = int(kwargs.pop("checkpoint_every", 10))
        if kwargs:
            raise TypeError(f"SVItrainer got unexpected keywords {sorted(kwargs)}")
        if loss is not None:
            loss.configure(model)
        self.model = model
        self.device = model.device
        self.optimizer = (optimizer if optimizer is not None
                          else _graph.default_optimizer(
                              model.nets.parameters(), lr, self.device))
        self.grad_accumulator = (GradAccumulator(self.optimizer,
                                                 self.grad_accum)
                                 if self.grad_accum > 1 else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.loss_history = {"training_loss": [], "test_loss": []}
        self.epoch_times = []
        self.current_epoch = 0
        self.stopped_early = False
        self.best_epoch = None  # set by patience= runs
        self.best_metric = None
        self._deferred_records = []
        self._graphs = _graph.GraphCache()

    # ------------------------------------------------------------------
    def _noise(self, batch_size: int):
        """The latent noise of one batch (``model.noise_shapes``)."""
        return draw_noise(self.model, self.generator, batch_size)

    def _prep_beta(self, scale_factor):
        """The KL scale as the model takes it (a pair for jiVAE)."""
        prep = getattr(self.model, "prep_beta", None)
        return scale_factor if prep is None else prep(scale_factor)

    def _loss(self, x, y, weights, beta, eps) -> Tensor:
        """The step's weighted loss; under ``remat`` its forward runs again
        in the backward, on the same noise."""
        fn = self.model.weighted_loss_fn
        if not self.remat:
            return fn(x, y, weights, beta, eps=eps)
        # the forward draws nothing (its noise is eps), so the RNG state
        # needs no saving, which a capture would refuse
        return _remat(lambda x_, y_, w_, e_: fn(x_, y_, w_, beta, eps=e_),
                      x, y, weights, eps, use_reentrant=False,
                      preserve_rng_state=False)

    def train_step(self, batch, weights: Tensor, beta=1.0,
                   eps: Optional[Tensor] = None) -> Tensor:
        """One step on ``sum_b weights_b * (-ELBO_b)`` of ``batch``
        (``(x,)`` or ``(x, y)``, tensors on the model's device): an Adam
        update, or under ``grad_accum`` a micro-step of one. ``eps`` is the
        latent noise; it is drawn from the trainer's generator when not
        given. Under a mesh, ``batch``, ``weights`` and ``eps`` are the
        whole batch's; the rank trains on its rows and returns the whole
        batch's loss. Returns the loss as a 0-d device tensor, without
        waiting."""
        if eps is None:
            eps = self._noise(batch[0].shape[0])
        batch, weights, eps = self.data_axis.local(batch, weights, eps)
        x = batch[0]
        y = batch[1] if len(batch) > 1 else None
        self.optimizer.zero_grad(set_to_none=True)
        with batch_stats_over(self.model.nets, self.data_axis):
            loss = self._loss(x, y, weights, beta, eps)
            loss.backward()
        loss = self.data_axis.reduce_grads(self.optimizer, loss)
        apply_update(self.optimizer, self.grad_accumulator)
        return loss

    def _batch_loss(self, batch, w: Tensor, beta, train: bool) -> Tensor:
        """One batch's loss: a training step, or under a mesh this rank's
        rows' share of an evaluation (summed over the ranks per epoch)."""
        if train:
            return self.train_step(batch, w, beta)
        eps = self._noise(batch[0].shape[0])
        batch, w, eps = self.data_axis.local(batch, w, eps)
        y = batch[1] if len(batch) > 1 else None
        with torch.no_grad(), batch_stats_over(self.model.nets,
                                               self.data_axis):
            return self.model.weighted_loss_fn(batch[0], y, w, beta, eps=eps)

    def _epoch(self, loader, scale_factor, train: bool):
        """(sum of the epoch's batch losses as a 0-d device tensor, the
        rows it covered) over a DataLoader, resident or streaming, or an
        iterable of batches; captured where :func:`._graph.route` says."""
        if isinstance(loader, DataLoader) and _graph.route(self, (loader,)):
            if loader.device_resident:
                return self._captured_epoch(loader, scale_factor, train)
            return self._chunked_epoch(loader, scale_factor, train)
        beta = self._prep_beta(scale_factor)
        losses = []
        if isinstance(loader, DataLoader):
            idx, w = loader.epoch_indices()
            w = torch.as_tensor(w, device=self.device)
            for i, batch in enumerate(loader.padded_batches(idx)):
                losses.append(self._batch_loss(batch, w[i], beta, train))
            norm = loader.dataset_size
        else:
            norm = 0
            for batch, w, n in streamed_batches(loader, self.device):
                losses.append(self._batch_loss(batch, w, beta, train))
                norm += n
        if not losses:
            return torch.zeros((), device=self.device), 1
        total = torch.stack(losses).sum()
        if not train:  # the ranks' rows' shares
            total = self.data_axis.all_reduce(total)
        return total, max(norm, 1)

    def _captured_epoch(self, loader: DataLoader, scale_factor, train: bool):
        """:meth:`_epoch` over a resident DataLoader as a captured program
        (:mod:`._graph`): each step gathers its rows at its row of a static
        index table, weighs them by its row of a static weights table and
        takes the KL scale from a device scalar (a pair for jiVAE), so that
        ``scale_schedule`` changes it without a new capture; the steps'
        losses go into a static buffer, summed at the end."""
        beta = self._prep_beta(scale_factor)
        shape = tuple(torch.as_tensor(beta).shape)
        nb, bs = loader.num_batches, loader.batch_size

        def make():
            t = StaticTables(self.device, idx=((nb, bs), torch.int32),
                             w=((nb, bs), torch.float32),
                             beta=(shape, torch.float32),
                             losses=((nb,), torch.float32))

            def step(i):
                batch = loader.gather(t.idx[i])
                t.losses[i].copy_(self._batch_loss(batch, t.w[i], t.beta,
                                                   train))

            return _graph.Program(self.device, nb, step,
                                  lambda: (t.losses.sum(),), t,
                                  self.generator)

        idx, w = loader.epoch_indices()
        micro = nb if train else 0
        (total,) = self._graphs.run(
            self, ("svi", train), (_graph.loader_key(loader), shape), make,
            lambda t: t.fill(idx=idx, w=w, beta=beta), micro=micro,
            keep=_graph.variants(self, [((), micro)]))
        return total, loader.dataset_size

    def _chunked_epoch(self, loader: DataLoader, scale_factor, train: bool):
        """:meth:`_epoch` over a streaming DataLoader, each chunk of
        ``stream_chunks`` batches a captured program (:mod:`._graph`; the
        full chunk and the short last one are two): step i casts batch i
        of the chunk rows' tables (the kind's, shared), weighs it by row i
        of a ``[c, bs]`` weights table and takes the KL scale from a
        device scalar. The chunks' per-step losses are summed on the
        device at the end, as the eager loop sums them."""
        beta = self._prep_beta(scale_factor)
        shape = tuple(torch.as_tensor(beta).shape)
        bs = loader.batch_size
        kind = ("svi", train)
        idx, w = loader.epoch_indices()
        spans = loader.chunk_spans(idx.shape[0])
        keep = _graph.variants(
            self, [((c,), c if train else 0) for _, c in spans])

        def make(c):
            t = StaticTables(self.device, w=((c, bs), torch.float32),
                             beta=(shape, torch.float32),
                             losses=((c,), torch.float32))
            t.rows = self._graphs.shared(
                kind, lambda: loader.chunk_tables(spans[0][1]))

            def step(i):
                batch = loader.chunk_batch(t.rows, i)
                t.losses[i].copy_(self._batch_loss(batch, t.w[i], t.beta,
                                                   train))

            return _graph.Program(self.device, c, step,
                                  lambda: (t.losses.clone(),), t,
                                  self.generator)

        key = (loader.chunk_key(), shape)
        losses = []
        for start, c, put in loader.chunk_feed(idx):
            def fill(t, start=start, c=c, put=put):
                put(t.rows)
                t.fill(w=w[start:start + c], beta=beta)

            losses += self._graphs.run(
                self, kind, key, lambda c=c: make(c), fill, variant=(c,),
                micro=c if train else 0, keep=keep)
        return torch.cat(losses).sum(), loader.dataset_size

    def train(self, train_loader, **kwargs):
        """One training epoch; returns loss / dataset_size.

        ``scale_factor`` is the KL scale beta (default 1). ``sync=False``
        returns a pending loss handle without waiting for the device; call
        :meth:`sync_history` or ``float()`` on it."""
        sync_gate(self.model)
        total, norm = self._epoch(train_loader,
                                  kwargs.get("scale_factor", 1.0), True)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, norm)
        return float(total) / norm

    def evaluate(self, test_loader, **kwargs):
        """Loss over a held-out set, with no parameter update; keywords as
        :meth:`train`."""
        sync_gate(self.model)
        total, norm = self._epoch(test_loader,
                                  kwargs.get("scale_factor", 1.0), False)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, norm)
        return float(total) / norm

    def _seg_epoch(self, loaders, scale_factor, kwargs) -> None:
        """One epoch queued (and its evaluation), appended to
        ``loss_history`` as pending losses."""
        hist = self.loss_history
        hist["training_loss"].append(self.train(
            loaders[0], scale_factor=scale_factor, sync=False))
        test_loader = kwargs.get("test_loader")
        if test_loader is not None:
            hist["test_loss"].append(self.evaluate(
                test_loader, scale_factor=scale_factor, sync=False))
        self.current_epoch += 1

    def step(self, train_loader, test_loader=None, **kwargs) -> None:
        """One epoch of training (and evaluation), appended to
        ``loss_history``; with a ``log_file`` its JSONL record. With
        ``sync=False`` the history holds pending handles (and the record
        waits) until :meth:`sync_history`, and ``epoch_times`` measures
        the host's dispatch time."""
        sync = kwargs.get("sync", True)
        t0 = time.perf_counter()
        self._seg_epoch((train_loader,), kwargs.get("scale_factor", 1.0),
                        dict(kwargs, test_loader=test_loader))
        if sync:
            self.sync_history()
        self.epoch_times.append(time.perf_counter() - t0)
        self._record_step(test_loader is not None, sync)
        save_if_due(self)

    def run(self, train_loader, epochs: int, **kwargs) -> list:
        """Train ``epochs`` epochs; returns the per-epoch losses, also
        appended to ``loss_history``. The same as ``epochs`` calls of
        :meth:`step`, queued (``sync=False``) and read at segment ends.

        Keyword Args:
            scale_factor: KL scale beta of every epoch.
            scale_schedule: per-epoch betas (length ``epochs``).
            test_loader: held-out loader evaluated after every epoch.
            patience: stop once the held-out loss has not improved by
                more than ``min_delta`` (default 0) for ``patience``
                epochs, checked at segment ends; ``stopped_early``,
                ``best_epoch`` and ``best_metric`` tell the outcome.
            on_segment: called at each segment end with the list of its
                epochs' records (``epoch``, ``training_loss`` and
                ``test_loss``).
            enum_schedule: ``E`` exact epochs, then the model's
                ``enum_topk``; or ``"auto"`` / ``("auto", threshold)``.
        """
        enum_schedule = kwargs.pop("enum_schedule", None)
        if enum_schedule is not None:
            return self._run_enum_schedule((train_loader,), int(epochs),
                                           enum_schedule, kwargs)
        return self._run_segmented((train_loader,), int(epochs), kwargs)

    # SegmentedRunsMixin hooks
    def _seg_metric_key(self):
        return "test_loss"

    def _seg_history(self):
        return self.loss_history

    def _seg_has_metric(self, kwargs):
        return kwargs.get("test_loader") is not None

    def _seg_monitor_kwarg(self):
        return "test_loader"

    def _seg_monitor_sign(self):
        return 1.0  # held-out loss: lower is better

    def _seg_resident(self, loaders, kwargs):
        return all(isinstance(ld, DataLoader) and ld.device_resident
                   for ld in (loaders[0], kwargs.get("test_loader"))
                   if ld is not None)

    def _seg_sub_run(self, loaders, n, kwargs):
        return self.run(loaders[0], n, **kwargs)

    def sync_history(self) -> None:
        """Materialize every pending ``step(sync=False)`` loss and write
        the JSONL records that waited for them."""
        for hist in self.loss_history.values():
            for i, v in enumerate(hist):
                if not isinstance(v, float):
                    hist[i] = float(v)
        self._flush_deferred()

    def resume(self, checkpoint_path: Optional[str] = None) -> int:
        """Restore the model, optimizer (and ``grad_accum`` window), noise
        generator, epoch and loss history from a checkpoint
        (``checkpoint_path``, else the trainer's own); returns the epoch
        to continue from. A loader built afresh takes it through
        ``set_epoch`` to visit the rows in the order of the uninterrupted
        run."""
        from ..utils.checkpoint import load_checkpoint
        load_checkpoint(checkpoint_path or self.checkpoint_path, self.model,
                        self)
        return self.current_epoch

    def print_statistics(self) -> None:
        """Prints the current epoch's losses (global rank 0 alone)."""
        self.sync_history()
        if not is_writer():
            return
        e = self.current_epoch
        if len(self.loss_history["test_loss"]) > 0:
            print("Epoch: {} Training loss: {:.4f}, Test loss: {:.4f}".format(
                e, self.loss_history["training_loss"][-1],
                self.loss_history["test_loss"][-1]))
        else:
            print("Epoch: {} Training loss: {:.4f}".format(
                e, self.loss_history["training_loss"][-1]))
