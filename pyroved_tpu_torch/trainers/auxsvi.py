"""SVI trainer with an auxiliary supervised objective (semi-supervised
models).

Counterpart of ``pyroved_tpu/trainers/auxsvi.py``: an epoch walks the
unlabeled batches and, after every p-th of them, takes one labeled batch
(``p = (n_sup + n_unsup) // n_sup``, at ``i % p == 1``; every step when
p == 1). A labeled step is two updates: the basic Adam over every network
on the labeled ELBO, then a second Adam, of its own, over ``encoder_y``
alone on the auxiliary loss, evaluated after the first update. The reported
epoch loss is the unlabeled losses' sum over the unlabeled count. Accuracy
(classification) or MSE (regression) on a validation loader, and
stochastic weight averaging of a sub-network.

Loaders are :class:`~pyroved_tpu_torch.utils.data.DataLoader`\\ s, resident
or streaming, or any iterables of batches. On a CUDA model whose loaders
are all resident, an epoch (its unlabeled and labeled steps, both
optimizers' updates) and the metric on ``loader_val`` are each captured
once as a CUDA graph and replayed, one graph launch each, as
``SVItrainer``'s are (:mod:`._graph`; the same eager-only
configurations, ``grad_accum`` captured too). With a streaming unlabeled
loader of ``stream_chunks=c > 1`` and a resident labeled one, each chunk
of c unlabeled batches and the labeled steps among them is a captured
program, as the JAX package's ``_train_chunked_stream`` scans a chunk:
the labeled steps' places (``mask[start:start + c]``) are part of its
variant, their rows and weights a table filled each chunk. With two
DataLoaders the labeled batch of each step comes from the labeled
loader's epoch permutation, cycled (the schedule of
the JAX package's resident and chunked paths), so a streamed epoch is
bitwise equal to a resident one.
With an iterable the loaders are iterated, the labeled one afresh whenever
it runs out, and ``sup_period`` gives p when they have no length.

Adam follows ``optax.adam``: every parameter steps at every update, by its
momentum where the loss does not reach it (a labeled batch's basic loss
does not reach ``encoder_y``), so that the step counts stay equal.
``grad_accum=k`` averages the basic objective's gradients over k basic
micro-steps (unlabeled steps and the basic half of labeled ones) per
update; the auxiliary Adam keeps its cadence. The noise comes from a
``torch.Generator`` on the model's device in the shapes the model states
(``noise_shapes``); :meth:`auxSVItrainer.draw_noise` is where a test
injects the JAX package's. ``run`` takes ``patience`` (on the validation
metric), ``on_segment`` and ``enum_schedule`` (:mod:`._segmented`).

``mesh`` trains data parallel over its ``'data'`` axis as ``SVItrainer``
does: each basic and auxiliary step keeps the rank's rows of the whole
batch and its noise, and sums its grads and loss over the ranks before its
update. The validation metric is every rank's own, on the whole loader.
"""
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.collectives import DataAxis, is_writer
from ..utils.data import DataLoader, StaticTables
from ..utils.nn import average_weights
from . import _graph
from ._segmented import SegmentedRunsMixin
from .svi import (GradAccumulator, _PendingLoss, apply_update,
                  draw_noise, pad_batch, save_if_due, streamed_batches,
                  sync_gate, to_device)

Tensor = torch.Tensor


class auxSVItrainer(SegmentedRunsMixin):
    """Trainer of ssiVAE and ss_reg_iVAE (the task comes from the model;
    ``task=`` overrides it).

    Args:
        model: a port model with ``nets`` (``encoder_y`` among them),
            ``weighted_loss_fn``, ``aux_loss_fn`` and ``noise_shapes``.
        optimizer: a ``torch.optim.Optimizer`` over ``model.nets``'
            parameters (default ``Adam(lr)``, ``capturable`` on CUDA:
            :func:`._graph.default_optimizer`); the auxiliary optimizer is
            one of its type and defaults over ``encoder_y``'s.
        seed: seed of the noise.
        lr: learning rate of the default optimizers (5e-4).
        grad_accum: update the basic objective once every ``grad_accum``
            basic micro-steps on the mean of their gradients.
        log_file: append one JSONL record per epoch.
        checkpoint_path: where to save the training state (both optimizers
            included), after every ``checkpoint_every``-th epoch (default
            10); :meth:`resume` restores it.
        mesh: a ``DeviceMesh``; its ``'data'`` axis splits each batch's
            rows over the ranks (module docstring).
    """

    def __init__(self, model, task: Optional[str] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 seed: int = 1, **kwargs):
        task = task or getattr(model, "task", "classification")
        if task not in ("classification", "regression"):
            raise ValueError(
                "Choose between 'classification' and 'regression' tasks")
        self.mesh = kwargs.pop("mesh", None)
        self.data_axis = DataAxis(self.mesh)
        lr = float(kwargs.pop("lr", 5e-4))
        self.grad_accum = int(kwargs.pop("grad_accum", 1) or 1)
        self.log_file = kwargs.pop("log_file", None)
        self.checkpoint_path = kwargs.pop("checkpoint_path", None)
        self.checkpoint_every = int(kwargs.pop("checkpoint_every", 10))
        if kwargs:
            raise TypeError(
                f"auxSVItrainer got unexpected keywords {sorted(kwargs)}")
        self.task = task
        self.model = model
        self.device = model.device
        aux_params = model.nets["encoder_y"].parameters()
        if optimizer is None:
            self.optimizer = _graph.default_optimizer(
                model.nets.parameters(), lr, self.device)
            self.aux_optimizer = _graph.default_optimizer(aux_params, lr,
                                                          self.device)
        else:  # the same rule, with a state of its own
            self.optimizer = optimizer
            self.aux_optimizer = type(optimizer)(aux_params,
                                                 **optimizer.defaults)
        self.grad_accumulator = (GradAccumulator(self.optimizer,
                                                 self.grad_accum)
                                 if self.grad_accum > 1 else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.history = {"training_loss": [], "test": []}
        self.epoch_times = []
        self.current_epoch = 0
        self.stopped_early = False
        self.best_epoch = None  # set by patience= runs
        self.best_metric = None
        self._deferred_records = []
        self.running_weights: Dict[int, Dict[str, Tensor]] = {}
        self._graphs = _graph.GraphCache()

    # ------------------------------------------------------------------
    def draw_noise(self, batch_size: int, labeled: bool):
        """The noise of one unlabeled or labeled batch from the trainer's
        generator (``model.noise_shapes``)."""
        return draw_noise(self.model, self.generator, batch_size, labeled)

    def unsup_step(self, x: Tensor, weights: Tensor, beta=1.0,
                   eps=None) -> Tensor:
        """One basic step on an unlabeled batch (an Adam update, or a
        micro-step of one under ``grad_accum``); returns its weighted loss
        (0-d, on the device, without waiting). Under a mesh the arguments
        are the whole batch's and the rank trains on its rows."""
        if eps is None:
            eps = self.draw_noise(x.shape[0], False)
        (x,), weights, eps = self.data_axis.local((x,), weights, eps)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.weighted_loss_fn(x, None, weights, beta, eps=eps)
        loss.backward()
        loss = self.data_axis.reduce_grads(self.optimizer, loss)
        apply_update(self.optimizer, self.grad_accumulator)
        return loss

    def sup_step(self, x: Tensor, y: Tensor, weights: Tensor, beta=1.0,
                 aux_loss_multiplier=20.0, eps=None) -> Tensor:
        """A labeled step: the basic step on the labeled ELBO, then the
        auxiliary Adam step on ``encoder_y``; returns the sum of the two
        weighted losses."""
        if eps is None:
            eps = self.draw_noise(x.shape[0], True)
        (x, y), weights, eps = self.data_axis.local((x, y), weights, eps)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.weighted_loss_fn(x, y, weights, beta, eps=eps)
        loss.backward()
        loss = self.data_axis.reduce_grads(self.optimizer, loss)
        apply_update(self.optimizer, self.grad_accumulator)
        self.aux_optimizer.zero_grad(set_to_none=True)
        aux = torch.sum(self.model.aux_loss_fn(x, y, aux_loss_multiplier)
                        * weights)
        aux.backward()
        aux = self.data_axis.reduce_grads(self.aux_optimizer, aux)
        apply_update(self.aux_optimizer, None)
        return loss + aux

    @staticmethod
    def _period(loader_unsup, loader_sup, sup_period=None) -> int:
        """The labeled-step cadence p: ``sup_period``, else
        ``(n_sup + n_unsup) // n_sup`` from the loaders' lengths."""
        if sup_period is not None:
            return max(int(sup_period), 1)
        try:
            n_u, n_s = len(loader_unsup), len(loader_sup)
        except TypeError:
            raise TypeError(
                "Streaming loaders without __len__ need an explicit "
                "sup_period= (labeled step every p-th unlabeled batch)")
        return max((n_s + n_u) // max(n_s, 1), 1)

    @classmethod
    def _schedule(cls, loader_unsup, loader_sup, nb: int, n_sup_rows: int,
                  sup_period=None):
        """The epoch's interleave: (mask [nb] bool, the labeled batch of
        each step [nb] int32). One labeled step every p unlabeled ones at
        ``i % p == 1``; with p == 1 every step is labeled (the reference's
        cadence would never fire)."""
        p = cls._period(loader_unsup, loader_sup, sup_period)
        sup_mask = np.asarray([p == 1 or i % p == 1 for i in range(nb)], bool)
        sup_j = np.zeros(nb, np.int32)
        sup_j[sup_mask] = np.arange(int(sup_mask.sum())) % n_sup_rows
        return sup_mask, sup_j

    def _epoch_indexed(self, loader_unsup: DataLoader,
                       loader_sup: DataLoader, beta, aux_mult, sup_period):
        """An epoch over two DataLoaders (either resident or streaming):
        (sum of the unlabeled losses, the unlabeled count); captured where
        :func:`._graph.route` says."""
        if _graph.route(self, (loader_unsup, loader_sup)):
            run = (self._captured_epoch if loader_unsup.device_resident
                   else self._chunked_epoch)
            return run(loader_unsup, loader_sup, beta, aux_mult, sup_period)
        idx_u, w_u = loader_unsup.epoch_indices()
        idx_s, w_s = loader_sup.epoch_indices()
        mask, sup_j = self._schedule(loader_unsup, loader_sup,
                                     idx_u.shape[0], idx_s.shape[0],
                                     sup_period)
        wu = torch.as_tensor(w_u, device=self.device)
        ws = torch.as_tensor(w_s, device=self.device)
        sup_rows = (torch.as_tensor(idx_s, device=loader_sup.device)
                    if loader_sup.device_resident else idx_s)
        losses = []
        for i, (x,) in enumerate(loader_unsup.padded_batches(idx_u)):
            losses.append(self.unsup_step(x, wu[i], beta))
            if mask[i]:
                j = int(sup_j[i])
                xs, ys = loader_sup.batch_at(sup_rows[j])
                self.sup_step(xs, ys, ws[j], beta, aux_mult)
        return torch.stack(losses).sum(), max(float(w_u.sum()), 1.0)

    def _captured_epoch(self, loader_unsup: DataLoader,
                        loader_sup: DataLoader, beta, aux_mult, sup_period):
        """:meth:`_epoch_indexed` over resident loaders as one captured
        program (:mod:`._graph`): both loaders' index and weight tables and
        the KL scale are static device tensors filled once an epoch; the
        interleave, which the loaders' lengths fix, and the auxiliary
        loss's multiplier are part of the program's key."""
        idx_u, w_u = loader_unsup.epoch_indices()
        idx_s, w_s = loader_sup.epoch_indices()
        nb, bs = idx_u.shape
        ns, bss = idx_s.shape
        mask, sup_j = self._schedule(loader_unsup, loader_sup, nb, ns,
                                     sup_period)
        shape = tuple(torch.as_tensor(beta).shape)

        def make():
            t = StaticTables(self.device, iu=((nb, bs), torch.int32),
                             wu=((nb, bs), torch.float32),
                             is_=((ns, bss), torch.int32),
                             ws=((ns, bss), torch.float32),
                             beta=(shape, torch.float32),
                             losses=((nb,), torch.float32))

            def step(i):
                (x,) = loader_unsup.gather(t.iu[i])
                t.losses[i].copy_(self.unsup_step(x, t.wu[i], t.beta))
                if mask[i]:
                    j = int(sup_j[i])
                    xs, ys = loader_sup.gather(t.is_[j])
                    self.sup_step(xs, ys, t.ws[j], t.beta, aux_mult)

            return _graph.Program(self.device, nb, step,
                                  lambda: (t.losses.sum(),), t,
                                  self.generator)

        key = (_graph.loader_key(loader_unsup),
               _graph.loader_key(loader_sup), shape, float(aux_mult),
               mask.tobytes())
        micro = nb + int(mask.sum())
        (total,) = self._graphs.run(
            self, ("aux",), key, make,
            lambda t: t.fill(iu=idx_u, wu=w_u, is_=idx_s, ws=w_s, beta=beta),
            micro=micro, keep=_graph.variants(self, [((), micro)]))
        return total, max(float(w_u.sum()), 1.0)

    def _chunked_epoch(self, loader_unsup: DataLoader,
                       loader_sup: DataLoader, beta, aux_mult, sup_period):
        """:meth:`_epoch_indexed` over a streaming unlabeled DataLoader and
        a resident labeled one, each chunk of ``stream_chunks`` unlabeled
        batches a captured program (:mod:`._graph`): the unlabeled rows
        cast from the chunk rows' tables (the kind's, shared), the q-th
        labeled step of the chunk gathered at row q of a labeled index
        table filled each chunk; the chunk's length and its labeled steps'
        places are the program's variant, so an epoch takes at most one
        program a chunk, and p / gcd(c, p) full chunks' patterns at a
        cadence p."""
        idx_u, w_u = loader_unsup.epoch_indices()
        idx_s, w_s = loader_sup.epoch_indices()
        nb, bs = idx_u.shape
        bss = idx_s.shape[1]
        mask, sup_j = self._schedule(loader_unsup, loader_sup, nb,
                                     idx_s.shape[0], sup_period)
        shape = tuple(torch.as_tensor(beta).shape)
        spans = [(start, c, tuple(int(i) for i in np.flatnonzero(
            mask[start:start + c])))
            for start, c in loader_unsup.chunk_spans(nb)]
        keep = _graph.variants(
            self, [((c, labeled), c + len(labeled))
                   for _, c, labeled in spans])

        def make(c, labeled):
            nl = len(labeled)
            t = StaticTables(self.device, wu=((c, bs), torch.float32),
                             is_=((nl, bss), torch.int32),
                             ws=((nl, bss), torch.float32),
                             beta=(shape, torch.float32),
                             losses=((c,), torch.float32))
            t.rows = self._graphs.shared(
                ("aux",), lambda: loader_unsup.chunk_tables(spans[0][1]))
            place = {i: q for q, i in enumerate(labeled)}

            def step(i):
                (x,) = loader_unsup.chunk_batch(t.rows, i)
                t.losses[i].copy_(self.unsup_step(x, t.wu[i], t.beta))
                if i in place:
                    q = place[i]
                    xs, ys = loader_sup.gather(t.is_[q])
                    self.sup_step(xs, ys, t.ws[q], t.beta, aux_mult)

            return _graph.Program(self.device, c, step,
                                  lambda: (t.losses.clone(),), t,
                                  self.generator)

        key = (loader_unsup.chunk_key(), _graph.loader_key(loader_sup),
               shape, float(aux_mult))
        losses = []
        feed = loader_unsup.chunk_feed(idx_u)
        for (start, c, put), (_, _, labeled) in zip(feed, spans):
            js = sup_j[start:start + c][list(labeled)]

            def fill(t, start=start, c=c, put=put, js=js):
                put(t.rows)
                t.fill(wu=w_u[start:start + c], beta=beta)
                if len(js):
                    t.fill(is_=idx_s[js], ws=w_s[js])

            losses += self._graphs.run(
                self, ("aux",), key,
                lambda c=c, labeled=labeled: make(c, labeled), fill,
                variant=(c, labeled), micro=c + len(labeled),
                keep=keep)
        return torch.cat(losses).sum(), max(float(w_u.sum()), 1.0)

    def _epoch_streamed(self, loader_unsup, loader_sup, beta, aux_mult,
                        sup_period):
        """An epoch over iterables of batches: the unlabeled batches in
        order, a labeled one (from ``loader_sup``, iterated afresh when it
        runs out) after every p-th; short batches padded."""
        p = self._period(loader_unsup, loader_sup, sup_period)
        sup_iter = iter(loader_sup)
        labeled = None
        losses, count = [], 0
        for i, ((x,), w, n) in enumerate(streamed_batches(
                ((b[0] if isinstance(b, (tuple, list)) else b,)
                 for b in loader_unsup), self.device)):
            count += n
            losses.append(self.unsup_step(x, w, beta))
            if not (p == 1 or i % p == 1):
                continue
            try:
                sup_batch = next(sup_iter)
            except StopIteration:  # cycle the (smaller) labeled loader
                sup_iter = iter(loader_sup)
                sup_batch = next(sup_iter)
            sup_batch = tuple(to_device(b, self.device) for b in sup_batch)
            if labeled is None:
                labeled = sup_batch[0].shape[0]
            if sup_batch[0].shape[0] > labeled:
                raise ValueError(
                    f"Labeled streaming batch has {sup_batch[0].shape[0]} "
                    f"examples, larger than the first labeled batch "
                    f"({labeled}); use a fixed batch size.")
            (xs, ys), sw = pad_batch(sup_batch, labeled)
            self.sup_step(xs, ys, sw, beta, aux_mult)
        if not losses:
            return torch.zeros((), device=self.device), 1.0
        return torch.stack(losses).sum(), max(count, 1)

    def train(self, loader_unsup, loader_sup, **kwargs):
        """One epoch over the unlabeled loader, interleaving labeled batches;
        returns the unlabeled losses' sum over the unlabeled count.

        Keyword Args:
            scale_factor: KL scale beta (default 1).
            aux_loss_multiplier: weight of the auxiliary loss (default 20).
            sup_period: the labeled-step cadence p.
            sync: ``False`` returns a pending loss without waiting.
        """
        sync_gate(self.model)
        beta = kwargs.get("scale_factor", 1.0)
        aux_mult = float(kwargs.get("aux_loss_multiplier", 20))
        sup_period = kwargs.get("sup_period")
        if isinstance(loader_unsup, DataLoader) and isinstance(loader_sup,
                                                               DataLoader):
            total, norm = self._epoch_indexed(loader_unsup, loader_sup, beta,
                                              aux_mult, sup_period)
        else:
            total, norm = self._epoch_streamed(loader_unsup, loader_sup,
                                               beta, aux_mult, sup_period)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, norm)
        return float(total) / norm

    # ------------------------------------------------------------------
    def evaluate(self, loader_val) -> float:
        """Accuracy (classification) or mean squared error (regression) of
        the ``encoder_y`` head on a labeled loader."""
        return float(self._metric(loader_val,
                                  self.task == "classification"))

    def evaluate_cls(self, loader_val) -> float:
        """Share of the rows whose predicted class is the label's."""
        return float(self._metric(loader_val, True))

    def evaluate_reg(self, loader_val) -> float:
        """Mean over batches of each batch's mean squared error."""
        return float(self._metric(loader_val, False))

    @torch.no_grad()
    def _metric(self, loader_val, classification: bool) -> _PendingLoss:
        """The metric of :meth:`evaluate_cls` or :meth:`evaluate_reg`,
        without waiting for the device; over a resident DataLoader on the
        captured path a captured program (:mod:`._graph`) whose static
        table holds the pass's row order."""
        if (isinstance(loader_val, DataLoader)
                and _graph.route(self, (loader_val,), chunked=False)):
            return self._captured_metric(loader_val, classification)
        return self._metric_sums(loader_val, classification)

    def _head(self, data):
        """The model's head on a batch: the body of its ``classifier`` or
        ``regressor`` request, called directly, so that inside the
        captured metric no request starts a capture of its own."""
        model = self.model
        x = model._as_f32(data)
        return model._predict_head(x.reshape(x.shape[0], -1))

    def _metric_sums(self, batches, classification: bool) -> _PendingLoss:
        """Over ``(data, labels)`` batches: the hits and the row count
        (classification), or the batches' mean squared errors summed and
        their count (regression)."""
        if classification:
            correct, total = 0, 0
            for data, labels in batches:
                predicted = self._head(data)
                correct = correct + (predicted == labels.argmax(1)).sum()
                total += data.shape[0]
            return _PendingLoss(correct, total)
        total, count = 0.0, 0
        for data, gt in batches:
            predicted = self._head(data)
            total = total + torch.mean((predicted - gt.reshape(
                predicted.shape)) ** 2)
            count += 1
        return _PendingLoss(total, max(count, 1))

    def _captured_metric(self, loader: DataLoader,
                         classification: bool) -> _PendingLoss:
        """:meth:`_metric` as a captured program of one step: the pass's
        batches gathered at slices of a static order table."""
        n, bs = loader.dataset_size, loader.batch_size
        order = loader.epoch_order()

        def make():
            t = StaticTables(self.device, order=((n,), torch.int32))
            out = []

            def step(_):
                out[:] = [self._metric_sums(
                    (loader.gather(t.order[lo:lo + bs])
                     for lo in range(0, n, bs)), classification).total]

            return _graph.Program(self.device, 1, step, lambda: tuple(out),
                                  t, self.generator)

        (value,) = self._graphs.run(
            self, ("metric",), (classification, _graph.loader_key(loader)),
            make, lambda t: t.fill(order=order))
        return _PendingLoss(value, n if classification else -(-n // bs))

    def _seg_epoch(self, loaders, scale_factor, kwargs) -> None:
        """One epoch queued (and the metric on ``loader_val``), appended to
        ``history`` as pending values."""
        step_kwargs = {k: kwargs[k] for k in ("aux_loss_multiplier",
                                              "sup_period") if k in kwargs}
        self.history["training_loss"].append(self.train(
            loaders[0], loaders[1], scale_factor=scale_factor, sync=False,
            **step_kwargs))
        loader_val = kwargs.get("loader_val")
        if loader_val is not None:
            self.history["test"].append(self._metric(
                loader_val, self.task == "classification"))
        self.current_epoch += 1

    def step(self, loader_unsup, loader_sup, loader_val=None,
             **kwargs) -> None:
        """One training epoch (and the metric on ``loader_val``), appended
        to ``history``; with a ``log_file`` its JSONL record. Keywords as
        :meth:`train`; with ``sync=False`` the values stay pending until
        :meth:`sync_history`."""
        sync = kwargs.get("sync", True)
        t0 = time.perf_counter()
        self._seg_epoch((loader_unsup, loader_sup),
                        kwargs.get("scale_factor", 1.0),
                        dict(kwargs, loader_val=loader_val))
        if sync:
            self.sync_history()
        self.epoch_times.append(time.perf_counter() - t0)
        self._record_step(loader_val is not None, sync)
        save_if_due(self)

    def run(self, loader_unsup, loader_sup, epochs: int, **kwargs) -> list:
        """Train ``epochs`` epochs; returns the per-epoch losses, also
        appended to ``history`` (and the metric on ``loader_val`` after
        every epoch to ``history["test"]``). The same as ``epochs`` calls of
        :meth:`step`, queued (``sync=False``) and read at segment ends.

        Keyword Args:
            scale_factor: KL scale beta of every epoch.
            scale_schedule: per-epoch betas (length ``epochs``).
            aux_loss_multiplier, sup_period: as :meth:`train`.
            loader_val: labeled loader evaluated after every epoch.
            patience: stop once the metric on ``loader_val`` (accuracy:
                higher is better; MSE: lower) has not improved by more
                than ``min_delta`` for ``patience`` epochs.
            on_segment: called at each segment end with its epochs'
                records (``epoch``, ``training_loss`` and ``test``).
            enum_schedule: ``E`` exact epochs, then the model's
                ``enum_topk``; or ``"auto"`` / ``("auto", threshold)``.
        """
        enum_schedule = kwargs.pop("enum_schedule", None)
        if enum_schedule is not None:
            return self._run_enum_schedule((loader_unsup, loader_sup),
                                           int(epochs), enum_schedule, kwargs)
        return self._run_segmented((loader_unsup, loader_sup), int(epochs),
                                   kwargs)

    # SegmentedRunsMixin hooks
    def _seg_metric_key(self):
        return "test"  # history["test"]: accuracy or validation MSE

    def _seg_history(self):
        return self.history

    def _seg_has_metric(self, kwargs):
        return kwargs.get("loader_val") is not None

    def _seg_monitor_kwarg(self):
        return "loader_val"

    def _seg_monitor_sign(self):
        # classification monitors accuracy (higher is better)
        return -1.0 if self.task == "classification" else 1.0

    def _seg_resident(self, loaders, kwargs):
        return all(isinstance(ld, DataLoader) and ld.device_resident
                   for ld in (*loaders, kwargs.get("loader_val"))
                   if ld is not None)

    def _seg_sub_run(self, loaders, n, kwargs):
        return self.run(loaders[0], loaders[1], n, **kwargs)

    def sync_history(self) -> None:
        """Materialize every pending ``step(sync=False)`` value and write
        the JSONL records that waited for them."""
        for hist in self.history.values():
            for i, v in enumerate(hist):
                if not isinstance(v, float):
                    hist[i] = float(v)
        self._flush_deferred()

    def resume(self, checkpoint_path: Optional[str] = None) -> int:
        """Restore the model, both optimizers (and the ``grad_accum``
        window), the noise generator, epoch and history from a checkpoint
        (``checkpoint_path``, else the trainer's own); returns the epoch to
        continue from. Loaders built afresh take it through
        ``set_epoch``."""
        from ..utils.checkpoint import load_checkpoint
        load_checkpoint(checkpoint_path or self.checkpoint_path, self.model,
                        self)
        return self.current_epoch

    # ------------------------------------------------------------------
    def save_running_weights(self, net: str = "encoder_y") -> None:
        """Snapshot a sub-network's weights for stochastic weight averaging,
        keyed by the current epoch."""
        self.running_weights[self.current_epoch] = {
            k: v.detach().clone()
            for k, v in self.model.nets[net].state_dict().items()}

    def average_weights(self, net: str = "encoder_y") -> None:
        """Load the average of the snapshots into the sub-network."""
        self.model.nets[net].load_state_dict(
            average_weights(self.running_weights))

    def print_statistics(self) -> None:
        """Prints the current epoch's loss and metric (global rank 0
        alone)."""
        self.sync_history()
        if not is_writer():
            return
        e = self.current_epoch
        if len(self.history["test"]) > 0:
            metric = "accuracy" if self.task == "classification" else "MSE"
            print("Epoch: {} Training loss: {:.4f}, Test {}: {:.4f}".format(
                e, self.history["training_loss"][-1], metric,
                self.history["test"][-1]))
        else:
            print("Epoch: {} Training loss: {:.4f}".format(
                e, self.history["training_loss"][-1]))
