"""Input pipeline: device-resident or streamed datasets with seeded
shuffling.

Counterpart of ``pyroved_tpu/utils/data.py``. Each epoch is a permutation
of row indices, computed on the host and keyed by (seed, epoch) exactly as
the JAX package keys it (the splitmix64 Fisher-Yates of
``native/pvt_native.cpp``), so both packages visit the rows in the same
order. The trailing partial batch is padded with index 0 and weight 0, so
every step has the same shape and the padding adds nothing to the loss.

By default the whole dataset is copied to the device once; trainers upload
the epoch's ``[num_batches, batch_size]`` indices and gather each batch on
the device with ``index_select`` (a captured epoch reads the indices and
weights from :class:`StaticTables`, filled once an epoch from pinned
memory). With ``device_resident=False`` the arrays
stay where they are on the host (a memmap is never read whole): the rows
of ``stream_chunks`` batches at a time (one batch by default) are gathered
into a pinned host buffer and copied on a copy stream into a device
landing buffer (two of each, an event each), from which the eager loop
casts each batch; the next chunk is gathered only
after the current one's work is queued, so that the host's gather and the
copy run under it. A trainer's captured chunk (``trainers._graph``) reads
its rows from static tables that :meth:`DataLoader.chunk_feed` copies each
chunk into before its launch, and casts them inside the graph. The same
rows in the same order reach the model either way, so a streamed epoch is
bitwise equal to a resident one.

``scale=`` keeps an array in its stored dtype (a uint8 image stack stays
uint8 on the device or on the wire) and casts each batch to float32 times
the scale on the device. ``store_dtype="bfloat16"`` or ``"float16"``
narrows a float array once on the host, rounding to nearest even as the
JAX package's ``ml_dtypes`` cast does; bfloat16 rides as its 16 bits.
"""
import warnings
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..native import gather_rows, shuffle_indices
from .nn import as_numpy, resolve_device

Tensor = torch.Tensor

# rows narrowed per host pass under store_dtype (bounds the float32 copy)
_NARROW_ROWS = 1 << 16


def apply_batch_scale(batch, scales):
    """Cast the entries of a batch whose loader carries a ``scale`` to
    float32 and multiply (on the batch's device); identity for
    ``scales=None``. A bfloat16 entry (see ``store_dtype``) casts the same
    way."""
    if scales is None:
        return batch
    return tuple(b if s is None else b.to(torch.float32) * s
                 for b, s in zip(batch, scales))


def _resolve_narrow_dtype(d):
    """A ``store_dtype`` entry as ``torch.bfloat16`` or a numpy float
    dtype; other dtypes raise ``ValueError``."""
    if str(d) in ("bfloat16", "bf16", "torch.bfloat16"):
        return torch.bfloat16
    dt = np.dtype(d)
    if dt.kind != "f":
        raise ValueError(
            f"store_dtype must be a floating dtype, got {dt} — integer "
            "sources already ride scale= narrow")
    return dt


def _narrow(a: np.ndarray, dt) -> np.ndarray:
    """``a`` rounded to the narrow dtype ``dt`` on the host, a slab of rows
    at a time. bfloat16 rounds through float32 to nearest even, as
    ``ml_dtypes`` does, and is returned as its bits (int16)."""
    if dt is not torch.bfloat16:
        return a if a.dtype == dt else np.asarray(a, dt)
    out = np.empty(a.shape, np.int16)
    for lo in range(0, a.shape[0], _NARROW_ROWS):
        rows = np.array(a[lo:lo + _NARROW_ROWS], np.float32)
        out[lo:lo + rows.shape[0]] = torch.from_numpy(rows).to(
            torch.bfloat16).view(torch.int16).numpy()
    return out


def _apply_store_dtype(host, scale, store_dtype):
    """(host arrays, scales, bfloat16 flags) under ``store_dtype``: each
    named float array narrowed, with a scale of 1.0 where it had none, so
    every path casts it to float32 on the device. A scalar narrows the
    first (signal) array only, as a scalar ``scale`` does."""
    if isinstance(store_dtype, (tuple, list)):
        if len(store_dtype) != len(host):
            raise ValueError(
                f"store_dtype has {len(store_dtype)} entries for "
                f"{len(host)} arrays")
        entries = tuple(store_dtype)
    else:
        if not np.issubdtype(host[0].dtype, np.floating):
            raise ValueError(
                f"store_dtype={store_dtype!r} targets the first (signal) "
                f"array, but its dtype is {host[0].dtype} — integer "
                "sources already ride scale= narrow; use the per-array "
                "tuple form to narrow a different array")
        entries = (store_dtype,) + (None,) * (len(host) - 1)
    out, bf16 = [], []
    scales = list(scale) if scale is not None else [None] * len(host)
    for i, (a, d) in enumerate(zip(host, entries)):
        if d is None:
            out.append(a)
            bf16.append(False)
            continue
        dt = _resolve_narrow_dtype(d)
        out.append(_narrow(a, dt))
        bf16.append(dt is torch.bfloat16)
        if scales[i] is None:
            scales[i] = 1.0
    return out, tuple(scales), tuple(bf16)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    """The torch dtype of a host array's stored dtype."""
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


_copy_streams = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The copy stream of ``device``, one for every stager: the landing
    buffers are allocated on it, so an epoch's stager takes the blocks of
    the one before from the allocator's cache for that stream."""
    if device not in _copy_streams:
        _copy_streams[device] = torch.cuda.Stream(device)
    return _copy_streams[device]


class _Stager:
    """Chunks of a streaming loader's rows on their way to the device.

    :meth:`stage` gathers the rows into one of two slots, each a pinned
    host buffer and a device landing buffer, and starts their copy on a
    copy stream, recording an event after it. A slot is gathered into
    again only once the event of its last copy has passed, and its landing
    buffer written again only after the event :meth:`release` recorded on
    the compute stream once that stream's reads of it were queued; with
    two slots, one chunk's copy runs under the work on the one before.
    :meth:`take` makes the compute stream wait for the copy. The landing
    buffers are allocated on the device's copy stream (:func:`_copy_stream`)
    and their reads on the compute stream recorded (``record_stream``), so
    a stager dropped with a copy in flight frees no block another stream
    could take before the copy has landed. On the CPU the rows are
    gathered in place."""

    def __init__(self, loader: "DataLoader", rows: int):
        self.loader, self.rows = loader, rows
        self.cuda = loader.device.type == "cuda"
        if self.cuda:
            self.stream = _copy_stream(loader.device)
            self.bufs = [None, None]
            self.events = [None, None]
            self.released = [None, None]
            self.slot = 0

    def _buffers(self, slot: int):
        if self.bufs[slot] is None:
            host = tuple(torch.empty((self.rows,) + a.shape[1:],
                                     dtype=_torch_dtype(a), pin_memory=True)
                         for a in self.loader._host)
            with torch.cuda.stream(self.stream):
                dev = tuple(torch.empty(h.shape, dtype=h.dtype,
                                        device=self.loader.device)
                            for h in host)
            self.bufs[slot] = host, dev
        return self.bufs[slot]

    def stage(self, rows: np.ndarray):
        """Start moving ``rows`` (flat host indices) to the device."""
        ld = self.loader
        if not self.cuda:
            return tuple(torch.from_numpy(gather_rows(a, rows))
                         for a in ld._host), None, None
        slot, self.slot = self.slot, 1 - self.slot
        if self.events[slot] is not None:  # its last copy has landed
            self.events[slot].synchronize()
        n = rows.shape[0]
        host, landing = self._buffers(slot)
        for a, b in zip(ld._host, host):
            gather_rows(a, rows, out=b.numpy()[:n])
        with torch.cuda.stream(self.stream):
            if self.released[slot] is not None:
                self.stream.wait_event(self.released[slot])
            dev = tuple(d[:n].copy_(b[:n], non_blocking=True)
                        for d, b in zip(landing, host))
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        ld.host_to_device_bytes += sum(t.numel() * t.element_size()
                                       for t in dev)
        return dev, event, slot

    def take(self, staged) -> Tuple[Tensor, ...]:
        """The staged rows in their stored dtypes, usable on the current
        stream until :meth:`release`."""
        dev, event, _ = staged
        if event is not None:
            current = torch.cuda.current_stream(self.loader.device)
            current.wait_event(event)
            for t in dev:
                t.record_stream(current)
        return dev

    def release(self, staged) -> None:
        """The current stream's work queued so far is the last to read the
        staged rows: their slot may be written once it has run."""
        _, event, slot = staged
        if event is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.loader.device))
            self.released[slot] = done


class DataLoader:
    """Mini-batch loader over arrays that live on ``device`` (None means
    "cuda"; without CUDA pass ``device="cpu"``), or, with
    ``device_resident=False``, on the host, streamed to ``device`` in
    chunks of ``stream_chunks`` batches.

    Iterating yields tuples of device tensors (the final batch may be
    short). Trainers use the padded path: :meth:`epoch_indices` with
    :meth:`gather` (resident) or :meth:`padded_batches`. ``scale=s`` keeps
    the first array in its stored dtype and casts each batch to float32
    times ``s`` on the device; a tuple gives one entry per array (None
    leaves it alone). ``store_dtype`` narrows float arrays on the host
    (see the module docstring). ``host_to_device_bytes`` counts the bytes
    a streaming loader has copied to the device."""

    def __init__(self, *arrays, batch_size: int = 100, shuffle: bool = True,
                 seed: int = 0, device_resident: bool = True,
                 stream_chunks: int = 0, scale=None, store_dtype=None,
                 device=None):
        if not arrays:
            raise ValueError("At least one data array is required")
        host = [as_numpy(a) for a in arrays]
        n = host[0].shape[0]
        if any(a.shape[0] != n for a in host):
            raise ValueError("All arrays must share the leading dimension")
        if isinstance(scale, (tuple, list)):
            if len(scale) != len(host):
                raise ValueError(
                    f"scale has {len(scale)} entries for {len(host)} arrays")
            scale = tuple(None if s is None else float(s) for s in scale)
        elif scale is not None:
            scale = (float(scale),) + (None,) * (len(host) - 1)
        bf16 = (False,) * len(host)
        if store_dtype is not None:
            host, scale, bf16 = _apply_store_dtype(host, scale, store_dtype)
        self.device = resolve_device(device)
        self.scale = scale
        self.dataset_size = n
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.device_resident = bool(device_resident)
        self.stream_chunks = int(stream_chunks)
        self.host_to_device_bytes = 0
        self._host = host
        self._bf16 = bf16
        self._epoch = 0
        self.device_arrays: Optional[Tuple[Tensor, ...]] = None
        if self.device_resident:
            scales = scale or (None,) * len(host)
            # scaled arrays keep their stored dtype; other floats become f32
            self.device_arrays = tuple(
                self._bits(self._resident(
                    a if s is not None or a.dtype.kind != "f"
                    else a.astype(np.float32, copy=False)), b)
                for a, s, b in zip(host, scales, bf16))

    def _resident(self, a: np.ndarray) -> Tensor:
        """``a`` on the device. A read-only array (a memmap opened with
        mode "r") is copied on the CPU, and read through on a card."""
        if self.device.type == "cpu":
            return torch.as_tensor(a if a.flags.writeable else np.array(a))
        with warnings.catch_warnings():  # the copy to the card is a copy
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable")
            return torch.as_tensor(a, device=self.device)

    @staticmethod
    def _bits(t: Tensor, bf16: bool) -> Tensor:
        return t.view(torch.bfloat16) if bf16 else t

    @property
    def num_batches(self) -> int:
        return -(-self.dataset_size // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Set the loader's epoch counter, which keys the next epoch's
        permutation: a loader built afresh for a resumed run takes the
        trainer's ``current_epoch`` to visit the rows as the uninterrupted
        run would have."""
        self._epoch = int(epoch)

    def epoch_indices(self, epoch=None) -> Tuple[np.ndarray, np.ndarray]:
        """Permuted, padded row indices ``[num_batches, batch_size]``
        (int32) and weights of the same shape (float32, 0 marks padding)
        for one epoch; without ``epoch`` the loader's own counter is used
        and advanced."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self.shuffle:
            perm = shuffle_indices(self.dataset_size, self.seed, epoch)
        else:
            perm = np.arange(self.dataset_size, dtype=np.int32)
        pad = self.num_batches * self.batch_size - self.dataset_size
        weights = np.ones(self.dataset_size, np.float32)
        if pad:
            perm = np.concatenate([perm, np.zeros(pad, perm.dtype)])
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        idx = perm.reshape(self.num_batches, self.batch_size).astype(np.int32)
        return idx, weights.reshape(self.num_batches, self.batch_size)

    def _cast(self, batch) -> Tuple[Tensor, ...]:
        """Device tensors of the stored dtypes to what the model takes:
        bfloat16 bits reinterpreted, ``scale`` entries cast to float32 and
        scaled, other floats cast to float32."""
        batch = tuple(self._bits(t, b) for t, b in zip(batch, self._bf16))
        scales = self.scale or (None,) * len(batch)
        return tuple(
            t.to(torch.float32) * s if s is not None
            else t.to(torch.float32) if t.is_floating_point() else t
            for t, s in zip(batch, scales))

    def gather(self, rows: Tensor) -> Tuple[Tensor, ...]:
        """The batch at device indices ``rows`` of a resident loader, with
        ``scale`` applied (an on-device float32 cast and multiply)."""
        batch = tuple(a.index_select(0, rows) for a in self.device_arrays)
        return apply_batch_scale(batch, self.scale)

    def gather_chunk(self, flat_idx: np.ndarray) -> Tuple[np.ndarray, ...]:
        """The host rows at ``flat_idx`` of each array, in its stored
        dtype (bfloat16 as int16 bits)."""
        return tuple(gather_rows(a, flat_idx) for a in self._host)

    def put_batch(self, host_arrays) -> Tuple[Tensor, ...]:
        """Copy host arrays (as :meth:`gather_chunk` returns them) to the
        device in their stored dtype, through pinned memory, on the
        current stream; then cast them there (:meth:`_cast`)."""
        out = []
        for a in host_arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
                self.host_to_device_bytes += t.numel() * t.element_size()
            out.append(t)
        return self._cast(out)

    def batch_at(self, rows) -> Tuple[Tensor, ...]:
        """One batch at ``rows``: device indices for a resident loader,
        host indices (int32) for a streaming one."""
        if self.device_resident:
            return self.gather(rows)
        return self.put_batch(self.gather_chunk(rows))

    def padded_batches(self, idx: np.ndarray) -> Iterator[Tuple[Tensor, ...]]:
        """The batches at the rows ``idx [nb, batch_size]`` (as
        :meth:`epoch_indices` gives them), in order, on the device:
        gathered there for a resident loader; for a streaming one cast
        from its landing buffers ``stream_chunks`` batches at a time
        (:meth:`_chunks`), the next chunk's gather and copy started once
        the current one's batches are handed out. A streamed batch that
        needs no cast is a view of a landing buffer, written again once
        the next chunk's batches are asked for: queue its work before."""
        if self.device_resident:
            rows = torch.as_tensor(idx, device=self.device)
            for i in range(idx.shape[0]):
                yield self.gather(rows[i])
            return
        for _, c, rows in self._chunks(idx):
            for i in range(c):
                yield self.chunk_batch(rows, i)

    def chunk_spans(self, nb: int) -> list:
        """``(start, c)`` of each chunk of a streamed epoch of ``nb``
        batches: ``stream_chunks`` batches each (at least one), the last
        one short where they do not divide ``nb``."""
        cb = max(1, min(self.stream_chunks, nb))
        return [(s, min(cb, nb - s)) for s in range(0, nb, cb)]

    def chunk_key(self) -> tuple:
        """What a program over :meth:`chunk_tables` depends on: the batch
        size, the full chunk's batches, the scales and the arrays' row
        shapes and stored dtypes (bfloat16 bits among them). Not the host
        arrays, whose rows are copied in: a fresh loader over rows of the
        same shapes takes the same programs."""
        return (self.batch_size, self.chunk_spans(self.num_batches)[0][1],
                self.scale, self._bf16,
                tuple((a.shape[1:], a.dtype.str) for a in self._host))

    def chunk_tables(self, c: int) -> Tuple[Tensor, ...]:
        """Device tables of the rows of ``c`` batches, one for each array in
        its stored dtype (bfloat16 as int16 bits), which :meth:`chunk_feed`'s
        copies fill and :meth:`chunk_batch` reads."""
        return tuple(torch.empty((c * self.batch_size,) + a.shape[1:],
                                 dtype=_torch_dtype(a), device=self.device)
                     for a in self._host)

    def chunk_batch(self, tables: Tuple[Tensor, ...], i: int
                    ) -> Tuple[Tensor, ...]:
        """Batch ``i`` of a chunk's rows (:meth:`chunk_tables`' tables or
        a landing buffer), cast as the model takes it (:meth:`_cast`)."""
        bs = self.batch_size
        return self._cast(tuple(t[i * bs:(i + 1) * bs] for t in tables))

    def _chunks(self, idx: np.ndarray) -> Iterator[tuple]:
        """``(start, c, rows)`` for each chunk of a streaming loader's epoch
        at the rows ``idx [nb, batch_size]`` (:meth:`chunk_spans`):
        ``rows`` its device rows in their stored dtypes, for the current
        stream until the consumer asks for the next chunk. Only then is
        the next chunk gathered on the host and its copy started, after
        the consumer has queued its work on this one."""
        bs = idx.shape[1]
        spans = self.chunk_spans(idx.shape[0])
        if not spans:
            return
        stager = _Stager(self, spans[0][1] * bs)
        for j, (start, c) in enumerate(spans):
            if j == 0:
                staged = stager.stage(idx[:c].reshape(-1))
            yield start, c, stager.take(staged)
            stager.release(staged)
            if j + 1 < len(spans):
                s, n = spans[j + 1]
                staged = stager.stage(idx[s:s + n].reshape(-1))

    def chunk_feed(self, idx: np.ndarray) -> Iterator[tuple]:
        """The chunks of a streaming loader's epoch at the rows ``idx [nb,
        batch_size]``: ``(start, c, put)`` for each chunk of ``c`` batches
        from batch ``start`` on (:meth:`chunk_spans`), where
        ``put(tables)`` copies its rows into the first rows of
        :meth:`chunk_tables`' tables on the current stream. The next
        chunk is gathered and its copy started when the consumer asks for
        it, after it has queued the current one's work (a captured
        program's launch)."""
        for start, c, rows in self._chunks(idx):
            def put(tables, rows=rows):
                for dst, src in zip(tables, rows):
                    dst[:src.shape[0]].copy_(src)
            yield start, c, put

    def epoch_order(self) -> np.ndarray:
        """The row order of the next pass over the loader (its permutation,
        or the rows in order without ``shuffle``), advancing the epoch
        counter when it shuffles, as iterating does."""
        if not self.shuffle:
            return np.arange(self.dataset_size, dtype=np.int32)
        order = shuffle_indices(self.dataset_size, self.seed, self._epoch)
        self._epoch += 1
        return order

    def __iter__(self) -> Iterator[Tuple[Tensor, ...]]:
        order = self.epoch_order()
        if self.device_resident:
            order = torch.as_tensor(order, device=self.device)
        for start in range(0, self.dataset_size, self.batch_size):
            yield self.batch_at(order[start:start + self.batch_size])

    def __len__(self) -> int:
        return self.num_batches


class StaticTables:
    """Device tensors at fixed addresses, the inputs of a captured epoch
    (``trainers._graph``): ``StaticTables(device, name=(shape, dtype),
    ...)`` makes each, zeroed, as an attribute. :meth:`fill` copies new
    values in on the current stream, a host array through pinned memory
    without waiting: the caching host allocator keeps a pinned block from
    reuse until the copy that reads it has run."""

    def __init__(self, device, **specs):
        for name, (shape, dtype) in specs.items():
            setattr(self, name, torch.zeros(shape, dtype=dtype, device=device))

    def fill(self, **values) -> None:
        """Copy each value (an array-like, or a tensor) into the table of
        its name, cast to the table's dtype."""
        for name, v in values.items():
            dst = getattr(self, name)
            if isinstance(v, Tensor):
                dst.copy_(v.reshape(dst.shape))
                continue
            src = torch.from_numpy(np.array(v).reshape(dst.shape)).to(
                dst.dtype)
            if dst.device.type == "cuda":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=dst.device.type == "cuda")


def prefetch(loader, size: int = 2):
    """Iterate ``loader`` with a producer thread keeping ``size`` batches
    in flight, so that the host's gather and copy of the next batches
    overlap the consumer's steps (meant for streaming loaders). An error
    in the producer is raised here; stopping early stops the producer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in loader:
                if not put((None, item)):
                    return
        except BaseException as e:  # handed to the consumer
            put((e, None))
            return
        put((None, end))

    t = threading.Thread(target=producer, name="pvt-torch-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is end:
                break
            yield item
    finally:
        stop.set()
        t.join()


def init_dataloader(*args, random_sampler: bool = False, shuffle: bool = True,
                    **kwargs) -> DataLoader:
    """Counterpart of the JAX package's ``init_dataloader``:
    ``random_sampler`` maps to shuffling; every other keyword
    (``batch_size``, ``seed``, ``device_resident``, ``stream_chunks``,
    ``scale``, ``store_dtype``, ``device``) goes to :class:`DataLoader`."""
    return DataLoader(*args, shuffle=shuffle or random_sampler, **kwargs)


def init_ssvae_dataloaders(data_unsup, data_sup: Sequence, data_val: Sequence,
                           **kwargs) -> Tuple[DataLoader, DataLoader,
                                              DataLoader]:
    """Unlabeled, labeled and validation loaders of a semi-supervised model,
    as the JAX package builds them: the labeled loader always shuffles, and
    ``scale=(x_scale, y_scale)`` is refitted to each loader (the unlabeled
    one holds X only). Other keywords (``batch_size``, ``seed``,
    ``device``) go to every loader."""
    scale = kwargs.pop("scale", None)
    if isinstance(scale, (tuple, list)):
        x_scale = scale[0]
        y_scale = scale[1] if len(scale) > 1 else None
    else:
        x_scale, y_scale = scale, None
    pair_scale = (None if x_scale is None and y_scale is None
                  else (x_scale, y_scale))
    loader_unsup = init_dataloader(data_unsup, scale=x_scale, **kwargs)
    loader_sup = init_dataloader(*data_sup, random_sampler=True,
                                 scale=pair_scale, **kwargs)
    loader_val = init_dataloader(*data_val, scale=pair_scale, **kwargs)
    return loader_unsup, loader_sup, loader_val
