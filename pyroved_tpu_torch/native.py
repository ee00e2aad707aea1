"""Host-side batch assembly: seeded permutations, row gathers, uint8
normalization and a background batch producer.

Counterpart of ``pyroved_tpu/native.py`` with the same interface
(``shuffle_indices``, ``gather_rows``, ``u8_to_f32``, :class:`BatchPipeline`),
in numpy and one Python thread. :func:`shuffle_indices` is the JAX
package's splitmix64 Fisher-Yates (``native/pvt_native.cpp``), so a
pipeline, and :class:`~pyroved_tpu_torch.utils.data.DataLoader`, visit the
rows of every epoch in the JAX package's order. The JAX package's
``num_threads`` arguments size its C++ worker pool; here they are accepted
and change nothing, results included.
"""
import queue
import threading
from typing import Optional

import numpy as np

# how long a blocked producer or consumer sleeps before it looks at the
# pipeline's closed flag again (seconds)
_POLL = 0.05
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def shuffle_indices(n: int, seed: int, epoch: int) -> np.ndarray:
    """Permutation of [0, n) keyed by (seed, epoch): the Fisher-Yates
    shuffle driven by splitmix64 of ``native/pvt_native.cpp``
    (``pvt_shuffle_indices``), as int32. The random draws are computed
    vectorized (splitmix64's state advances by a constant); the swaps run
    in a Python loop, about 0.5 us per row."""
    out = np.arange(n, dtype=np.int32)
    if n < 2:
        return out
    state0 = (int(seed) * _GOLDEN + int(epoch) + 1) & _MASK64
    steps = np.arange(1, n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        zz = np.uint64(state0) + steps * np.uint64(_GOLDEN)
        zz = (zz ^ (zz >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        zz = (zz ^ (zz >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        zz = zz ^ (zz >> np.uint64(31))
    bound = np.arange(n, 1, -1, dtype=np.uint64)  # i + 1 for i = n-1 .. 1
    swaps = (zz % bound).tolist()
    perm = out.tolist()
    for i, r in zip(range(n - 1, 0, -1), swaps):
        perm[i], perm[r] = perm[r], perm[i]
    return np.asarray(perm, np.int32)


def gather_rows(src: np.ndarray, idx: np.ndarray, num_threads: int = 0, *,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """``dst[i] = src[idx[i]]`` over leading rows, in ``src``'s dtype. A
    memmap is read row by row, never whole. ``num_threads`` is the JAX
    package's worker count and has no effect. ``out`` (``[len(idx),
    *row]``, of ``src``'s dtype) receives the rows in place, e.g. a pinned
    staging buffer."""
    del num_threads  # one numpy gather
    idx = np.ascontiguousarray(idx, np.int32)
    if out is None:
        return src[idx]
    # mode="clip" writes straight into ``out`` (the default, "raise",
    # buffers the result first); the indices are in range by construction
    np.take(src, idx, axis=0, out=out, mode="clip")
    return out


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0,
              num_threads: int = 0) -> np.ndarray:
    """uint8 to float32, times ``scale`` (rounded to float32 first), each
    element one float32 product as in the JAX package's C++ loop.
    ``num_threads`` is the JAX package's worker count and has no effect."""
    del num_threads  # one numpy pass
    src = np.ascontiguousarray(src, np.uint8)
    return src.astype(np.float32) * np.float32(scale)


class BatchPipeline:
    """A producer thread that shuffles each epoch (the permutation of
    :func:`shuffle_indices` keyed by
    ``(seed, epoch)``) and gathers the coming batches of ``src`` into a
    ring of ``depth`` host buffers ahead of the consumer.

    Float32 sources only, as the JAX package's. :meth:`next` returns the
    next batch (the last of an epoch may be short); :meth:`close` stops the
    producer and may be called more than once; :meth:`next` after it
    raises ``RuntimeError``. An error in the producer is raised by the next
    :meth:`next`."""

    def __init__(self, src: np.ndarray, batch_size: int, seed: int = 0,
                 depth: int = 3, num_threads: int = 0):
        del num_threads  # one producer thread
        self._src = np.ascontiguousarray(src, np.float32)
        self.n_rows = int(self._src.shape[0])
        self.row_shape = self._src.shape[1:]
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.num_batches = -(-self.n_rows // self.batch_size)
        depth = max(int(depth), 1)
        self._ring = [np.empty((self.batch_size,) + self.row_shape, np.float32)
                      for _ in range(depth)]
        self._free: "queue.Queue" = queue.Queue()
        for slot in range(depth):
            self._free.put(slot)
        self._ready: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self._held = None  # the slot behind the last zero-copy view
        self._thread = threading.Thread(target=self._produce,
                                        name="pvt-torch-batch-pipeline",
                                        daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        epoch = 0
        try:
            while not self._closed.is_set():
                perm = shuffle_indices(self.n_rows, self.seed, epoch)
                for start in range(0, self.n_rows, self.batch_size):
                    slot = self._wait(self._free)
                    if slot is None:
                        return
                    rows = perm[start:start + self.batch_size]
                    gather_rows(self._src, rows,
                                out=self._ring[slot][:rows.shape[0]])
                    self._ready.put((slot, rows.shape[0]))
                epoch += 1
        except BaseException as e:  # handed to the consumer
            self._ready.put((None, e))

    def _wait(self, q: "queue.Queue"):
        """The next item of ``q``, or None once the pipeline is closed."""
        while not self._closed.is_set():
            try:
                return q.get(timeout=_POLL)
            except queue.Empty:
                continue
        return None

    def next(self, copy: bool = True) -> np.ndarray:
        """The next batch ``[rows, *row_shape]``. With ``copy=False`` it is
        a view into the ring, valid until the next call of :meth:`next` or
        :meth:`close`."""
        if self._closed.is_set():
            raise RuntimeError("BatchPipeline is closed")
        if self._held is not None:  # the previous view's slot goes back
            self._free.put(self._held)
            self._held = None
        item = self._wait(self._ready)
        if item is None:
            raise RuntimeError("BatchPipeline is closed")
        slot, rows = item
        if slot is None:
            self.close()
            raise rows
        view = self._ring[slot][:rows]
        if copy:
            out = view.copy()
            self._free.put(slot)
            return out
        self._held = slot
        return view

    def epoch_batches(self):
        """One epoch's batches, as 1-tuples (the DataLoader convention)."""
        for _ in range(self.num_batches):
            yield (self.next(),)

    def close(self) -> None:
        """Stop the producer and wait for it."""
        self._closed.set()
        if self._thread.is_alive() and threading.current_thread() is not \
                self._thread:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        closed = getattr(self, "_closed", None)
        if closed is not None:
            closed.set()
