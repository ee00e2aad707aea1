"""Segmented runs, shared by both trainers: early stopping (``patience``,
``min_delta``), ``on_segment`` callbacks, JSONL records and checkpoints
between segments, and the enumeration schedule (``enum_schedule``).

Counterpart of ``pyroved_tpu/trainers/_segmented.py``
(``SegmentedRunsMixin``). The JAX package dispatches compiled multi-epoch
scans, blocking or pipelined; the port queues each epoch without waiting
(``sync=False``: on the captured path one graph replay an epoch, and one
for its held-out loss or labeled-set metric; else its eager steps) and has
one runner whose segments, records, checkpoint epochs and callback
arguments are those of the JAX package's two runners:

- a segment ends on every ``checkpoint_every`` boundary and, with a
  ``log_file``, on every 10-epoch boundary;
- with ``patience`` (or a streaming loader) it is at most
  ``min(10, patience)`` epochs, else at most the pipelined runner's cap
  (5 epochs, or up to ``checkpoint_every`` and at most 25 with
  checkpoints); under ``on_segment`` at most 10.

The host reads a segment's losses only when it must: at once where a stop
decision or a checkpoint needs them, else one segment late, after the next
segment's steps are queued. Across ranks the JSONL records and checkpoints
are written by global rank 0 alone (every rank waits after a checkpoint);
the losses, stop decisions and callbacks are every rank's, and equal.

A trainer provides ``_seg_metric_key``, ``_seg_history``,
``_seg_has_metric(kwargs)``, ``_seg_monitor_kwarg``,
``_seg_monitor_sign``, ``_seg_resident(loaders, kwargs)``,
``_seg_epoch(loaders, scale_factor, kwargs)`` (queue one epoch, append its
pending history entries, advance ``current_epoch``) and
``_seg_sub_run(loaders, n, kwargs)`` (its ``run``).
"""
import json
import time

import numpy as np

from ..parallel.collectives import is_writer

# epochs per segment of the JAX package's pipelined runner
PIPELINE_SEGMENT = 5


def materialize(hist: list, lo: int, hi: int) -> list:
    """``hist[lo:hi]`` as floats, written back (pending losses wait for the
    device here)."""
    for i in range(lo, hi):
        if not isinstance(hist[i], float):
            hist[i] = float(hist[i])
    return hist[lo:hi]


class SegmentedRunsMixin:
    """Segmented runs and the enumeration schedule (module docstring)."""

    #: exact epochs between the guide-concentration probes of
    #: ``enum_schedule="auto"``
    ENUM_AUTO_PROBE_EVERY = 5
    #: epochs into the last ``"auto"`` run at which the trainer switched to
    #: ``enum_topk`` (None: no such run yet, or the guide never concentrated)
    enum_switch_epoch = None
    _es_carry = None

    # ------------------------------------------------------------------
    # segment sizing
    # ------------------------------------------------------------------
    def _next_segment_epochs(self, remaining: int) -> int:
        """Epochs until the next host-work boundary: the next multiple of
        ``checkpoint_every`` and, with a ``log_file``, of 10."""
        cands = [remaining]
        if self.checkpoint_path:
            ce = max(1, int(self.checkpoint_every))
            cands.append(ce - self.current_epoch % ce)
        if self.log_file:
            cands.append(10 - self.current_epoch % 10)
        return max(1, min(cands))

    def _pipeline_cap(self) -> int:
        """The JAX package's pipelined segment length."""
        if self.checkpoint_path:
            return max(PIPELINE_SEGMENT,
                       min(int(self.checkpoint_every), 5 * PIPELINE_SEGMENT))
        return PIPELINE_SEGMENT

    def _segment_epochs(self, remaining: int, patience, on_segment,
                        resident: bool) -> int:
        n = self._next_segment_epochs(remaining)
        if patience is None and resident:
            n = min(n, self._pipeline_cap())
        elif patience is not None:
            n = min(n, max(1, min(10, int(patience))))
        if on_segment is not None:
            n = min(n, 10)
        return n

    # ------------------------------------------------------------------
    # records
    # ------------------------------------------------------------------
    def _seg_records(self, end_epoch: int, per, te) -> list:
        key = self._seg_metric_key()
        n = len(per)
        return [dict({"epoch": end_epoch - n + j + 1,
                      "training_loss": per[j]},
                     **({} if te is None else {key: te[j]}))
                for j in range(n)]

    def _seg_write_jsonl(self, records, dt: float) -> None:
        if not is_writer():
            return
        with open(self.log_file, "a") as f:
            for record in records:
                record = dict(record, epoch_seconds=dt / len(records))
                f.write(json.dumps(record) + "\n")

    def _flush_deferred(self) -> None:
        """Write the JSONL records ``step(sync=False)`` deferred, now that
        their losses are floats."""
        if not self._deferred_records:
            return
        records, self._deferred_records = self._deferred_records, []
        if not self.log_file or not is_writer():
            return
        history, key = self._seg_history(), self._seg_metric_key()
        with open(self.log_file, "a") as f:
            for epoch, ti, si, secs in records:
                rec = {"epoch": epoch,
                       "training_loss": history["training_loss"][ti],
                       "epoch_seconds": secs}
                if si is not None:
                    rec[key] = history[key][si]
                f.write(json.dumps(rec) + "\n")

    def _record_step(self, has_metric: bool, sync: bool) -> None:
        """``step``'s JSONL record of the epoch just taken, written once
        its losses are floats."""
        if not self.log_file:
            return
        history = self._seg_history()
        ti = len(history["training_loss"]) - 1
        si = len(history[self._seg_metric_key()]) - 1 if has_metric else None
        self._deferred_records.append((self.current_epoch, ti, si,
                                       self.epoch_times[-1]))
        if sync:
            self.sync_history()

    # ------------------------------------------------------------------
    # the runner
    # ------------------------------------------------------------------
    def _run_segmented(self, loaders, epochs: int, kwargs) -> list:
        """``run``'s body: check the segment-level keywords, then queue
        ``epochs`` epochs in segments with the host work between them.
        Returns the per-epoch training losses."""
        patience = kwargs.pop("patience", None)
        min_delta = float(kwargs.pop("min_delta", 0.0))
        on_segment = kwargs.pop("on_segment", None)
        has_metric = self._seg_has_metric(kwargs)
        if patience is not None and not has_metric:
            raise ValueError(
                "patience= (early stopping) requires "
                f"{self._seg_monitor_kwarg()}= to monitor")
        self.stopped_early = False
        epochs = int(epochs)
        schedule = kwargs.get("scale_schedule")
        if schedule is not None and len(schedule) != epochs:
            raise ValueError(f"scale_schedule has {len(schedule)} entries for "
                             f"{epochs} epochs")
        if epochs <= 0:
            return []
        history = self._seg_history()
        metric_hist = history[self._seg_metric_key()]
        sign = self._seg_monitor_sign()
        segmented = bool(self.checkpoint_path or self.log_file
                         or patience is not None or on_segment is not None)
        resident = self._seg_resident(loaders, kwargs)
        # carried by the probe sub-runs of enum_schedule="auto", so that
        # patience spans the whole exact phase
        es = self._es_carry
        if es is None:
            es = {"best": float("inf"), "best_epoch": self.current_epoch}
        start = len(history["training_loss"])
        waiting = []  # queued segments not yet read: (epochs, first, end)
        last = time.perf_counter()

        def finish():
            """Read the waiting segments: times, JSONL, callbacks."""
            nonlocal last
            for n, lo, end in waiting:
                per = materialize(history["training_loss"], lo, lo + n)
                te = (materialize(metric_hist, lo, lo + n) if has_metric
                      else None)
                now = time.perf_counter()
                dt, last = now - last, now
                self.epoch_times.extend([dt / n] * n)
                records = self._seg_records(end, per, te)
                if self.log_file:
                    self._seg_write_jsonl(records, dt)
                if on_segment is not None:
                    on_segment(records)
            waiting.clear()

        def stop_now(n: int) -> bool:
            """Fold the segment's metric values into the best so far;
            True once ``patience`` epochs passed without an improvement
            larger than ``min_delta``."""
            for j, v in enumerate(metric_hist[-n:]):
                if sign * v < es["best"] - min_delta:
                    es["best"] = sign * v
                    es["best_epoch"] = self.current_epoch - n + j + 1
            self.best_epoch = es["best_epoch"]
            self.best_metric = sign * es["best"]
            if self.current_epoch - es["best_epoch"] >= int(patience):
                self.stopped_early = True
                return True
            return False

        done = 0
        while done < epochs:
            n = (self._segment_epochs(epochs - done, patience, on_segment,
                                      resident)
                 if segmented else epochs - done)
            lo = len(history["training_loss"])
            for e in range(done, done + n):
                sf = (schedule[e] if schedule is not None
                      else kwargs.get("scale_factor", 1.0))
                self._seg_epoch(loaders, sf, kwargs)
            done += n
            due = (self.checkpoint_path
                   and self.current_epoch % self.checkpoint_every == 0)
            if due:
                from .svi import save_state
                save_state(self, async_write=True)
            if patience is not None or due:
                waiting.append((n, lo, self.current_epoch))
                finish()
            else:  # read the previous segment, this one stays queued
                finish()
                waiting.append((n, lo, self.current_epoch))
            if patience is not None and stop_now(n):
                break
        finish()
        if self.checkpoint_path:
            from ..utils.checkpoint import wait_for_checkpoints
            wait_for_checkpoints(self.checkpoint_path)
        return history["training_loss"][start:]

    # ------------------------------------------------------------------
    # enumeration schedule: exact early, enum_topk late
    # ------------------------------------------------------------------
    def _run_enum_schedule(self, loaders, epochs: int, exact, kwargs) -> list:
        """``run(..., enum_schedule=E)``: the first ``E`` epochs with exact
        enumeration, the rest with the model's ``enum_topk``; two sub-runs,
        ``patience`` applying within each. ``"auto"`` or ``("auto", thr)``
        picks the switch from the guide (:meth:`_run_enum_schedule_auto`).
        ``model.enum_topk`` is restored however the run ends."""
        model = self.model
        # a stale True from an earlier early-stopped run would skip a phase
        self.stopped_early = False
        saved = int(getattr(model, "enum_topk", 0) or 0)
        if not saved:  # nothing to schedule: the model enumerates exactly
            return self._seg_sub_run(loaders, epochs, dict(kwargs))
        if exact == "auto" or (isinstance(exact, (tuple, list))
                               and tuple(exact[:1]) == ("auto",)):
            thr = (float(exact[1]) if isinstance(exact, (tuple, list))
                   else 0.95)
            return self._run_enum_schedule_auto(loaders, epochs, thr, saved,
                                                kwargs)
        E = max(0, min(int(exact), epochs))
        out = []
        if E:
            model.enum_topk = 0
            try:
                out += self._enum_phase(loaders, kwargs, E, 0)
            finally:
                model.enum_topk = saved
        if epochs > E and not self.stopped_early:
            out += self._enum_phase(loaders, kwargs, epochs - E, E)
        return out

    def _enum_phase(self, loaders, kwargs, n: int, lo: int) -> list:
        sub = dict(kwargs)
        schedule = kwargs.get("scale_schedule")
        if schedule is not None:
            sub["scale_schedule"] = list(schedule)[lo:lo + n]
        return self._seg_sub_run(loaders, n, sub)

    def _run_enum_schedule_auto(self, loaders, epochs: int, threshold: float,
                                saved: int, kwargs) -> list:
        """``enum_schedule="auto"``: exact enumeration until the guide's
        mean top-``enum_topk`` mass on the first 512 training rows (after
        the loader's ``scale``) reaches ``threshold``, probed every
        :attr:`ENUM_AUTO_PROBE_EVERY` epochs; then ``enum_topk``. Records
        ``enum_probe_history`` ((epoch, mass) per probe) and
        ``enum_switch_epoch``."""
        from ..utils.data import apply_batch_scale
        model = self.model
        if not hasattr(model, "guide_probs"):
            raise ValueError(
                'enum_schedule="auto" needs a model with guide_probs() '
                f"(jiVAE/ssiVAE); {type(model).__name__} has none")
        if not 0.0 < threshold <= 1.0:
            raise ValueError(
                f"auto threshold must be in (0, 1], got {threshold}")
        if not getattr(loaders[0], "device_resident", False):
            raise ValueError(
                'enum_schedule="auto" needs a device-resident training '
                "loader (the probe reads from its arrays)")
        arrays = loaders[0].device_arrays
        probe = apply_batch_scale((arrays[0][:512],), loaders[0].scale)[0]
        out, done, flipped = [], 0, False
        self.enum_probe_history = []
        model.enum_topk = 0
        # patience spans the exact phase's probe sub-runs; its baseline
        # restarts at the switch (the truncated ELBO is another objective)
        self._es_carry = {"best": float("inf"),
                          "best_epoch": self.current_epoch}
        try:
            while done < epochs and not self.stopped_early:
                n = min(self.ENUM_AUTO_PROBE_EVERY, epochs - done)
                out += self._enum_phase(loaders, kwargs, n, done)
                done += n
                if done >= epochs or self.stopped_early:
                    break
                probs = model.guide_probs(probe).cpu().numpy()
                topk = np.sort(probs, axis=-1)[:, -saved:]
                mass = float(topk.sum(axis=-1).mean())
                self.enum_probe_history.append((done, mass))
                if mass >= threshold:
                    flipped = True
                    break
        finally:
            self._es_carry = None
            model.enum_topk = saved
        self.enum_switch_epoch = done if flipped else None
        if done < epochs and not self.stopped_early:
            out += self._enum_phase(loaders, kwargs, epochs - done, done)
        return out
