"""Bucketed requests: the runner that ``ServedModel`` and the models' own
requests (``encode``, ``decode``, ``reconstruct``, ``manifold2d``, the
heads, ``guide_probs``, ``VED.predict``) share.

The JAX package compiles every request into one executable a shape: a
``ServedModel`` one a power-of-two bucket, a model one a jitted function
and exact shape (``_chunked`` pads every chunk of ``batch_size`` rows, so a
function compiles once a size). Here a request is cut into chunks, each
chunk is padded with zero rows to its bucket, and each chunk runs the
function's body at that bucket (:meth:`Requests.plan`):

- without a batch size, chunks of ``max_bucket`` rows, each padded to the
  power of two at or above it, ``min(max_bucket, max(8, 2^ceil(log2 m)))``;
- with a batch size ``b`` (a ``ServedModel`` archive's fixed one, or a
  model request's ``batch_size=``), chunks of ``b`` rows, each padded to
  ``b``, JAX's ``_chunked`` rule;
- a body whose rows are coupled (a batchnorm that normalizes by the
  batch's own statistics) runs exact rows, padded only as far as the JAX
  package pads them: the whole request in one chunk, or chunks of ``b``
  with the last one padded to ``b`` when the request has more rows.

On CUDA, while the caller's route holds (``_graph.CAPTURE`` set, among its
conditions), each function at each bucket is a
:class:`~pyroved_tpu_torch.trainers._graph.Program` over static inputs
allocated outside the graphs: one buffer a batched input, of the largest
bucket's rows, whose first rows a bucket's program reads, and one buffer a
non-batched input (a decode's pose). A request fills them (its rows, then
zeros up to the bucket), runs the program (the first time eagerly on a
side stream, the second captured and replayed, then replays) and copies
the rows it asked for out of the outputs into tensors of its own, before
any other program of the runner runs. Elsewhere the same bodies run
eagerly on the zero-padded chunks and give the same bits. A capture or
replay that fails raises; nothing falls back to the eager bodies.

A runner's programs share one memory pool (``_graph.Pool``), captured
without the trainers' tidy-up (``Program.body``). A program's slot is its
name (the function, then the Python arguments its body reads, such as
``logits`` or ``num_samples``) and its bucket; what every graph freezes
besides is the caller's settings tuple, whose change drops every program,
its graph and the pool with it. The programs are bounded a function (the
name's first entry): at most ``len(buckets())`` (8 at ``max_bucket``
1024) from the power-of-two rule and :data:`OTHERS` others (a batch size's,
an exact body's row counts), the least recently used freed beyond either.

Requests are serialized per runner, one lock around the fills, the runs
and the copies out, since the static buffers are shared; each is queued
on the caller's current stream, after the runner's previous request (an
event, when that ran on another stream).
"""
import threading
from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Sequence, Tuple

import torch

from . import _graph

Tensor = torch.Tensor

#: The largest bucket: a request of more rows is cut into chunks of it.
MAX_BUCKET = 1024
#: Programs a function keeps besides its power-of-two buckets: a batch
#: size's, an exact body's row counts.
OTHERS = 4
#: Bytes one static buffer of the largest bucket may take
#: (:func:`capped_bucket`).
BUCKET_BYTES = 256 << 20


def capped_bucket(row_bytes: int, top: int = MAX_BUCKET) -> int:
    """The largest bucket for rows of ``row_bytes``: ``top``, halved while
    a buffer of its rows would pass :data:`BUCKET_BYTES`, at least 8
    (1024 up to 256 KiB a row, the 128x128 grid's 64 KiB among them; 256
    at 512x512)."""
    b = int(top)
    while b > 8 and b * row_bytes > BUCKET_BYTES:
        b //= 2
    return b


def padded(rows: Tensor, bucket: int) -> Tensor:
    """``rows`` with zero rows appended up to ``bucket``."""
    m = rows.shape[0]
    if m == bucket:
        return rows
    return torch.cat([rows, rows.new_zeros((bucket - m,) + rows.shape[1:])])


def as_tuple(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


def _function(name: Hashable) -> Hashable:
    return name[0] if isinstance(name, tuple) else name


class Requests:
    """The bucketed request runner (module docstring) for ``device``;
    ``max_bucket`` and ``batch_size`` (a fixed batch, or None) as the
    class's unless given. ``programs`` maps each slot ``(name, bucket)``
    to its program, the one run last at the end; ``made`` counts the
    programs made."""

    #: Largest number of rows one call handles without a batch size;
    #: larger requests are chunked at this size.
    max_bucket = MAX_BUCKET
    #: A fixed batch size every chunk is cut at and padded to, or None.
    batch_size: Optional[int] = None

    def __init__(self, device, max_bucket: Optional[int] = None):
        self.device = torch.device(device)
        if max_bucket is not None:
            self.max_bucket = int(max_bucket)
        self._lock = threading.Lock()
        self._settings = None  # the settings the programs were made under
        self._pool = None  # the programs' memory pool
        self.programs = OrderedDict()  # (name, bucket) -> Program
        self._inputs = {}  # name -> its static input buffers
        self._signature = {}  # name -> the inputs' shapes and dtypes
        self._last = None  # (stream, event) after the last captured request
        self.made = 0

    # -- buckets ------------------------------------------------------------
    def bucket(self, m: int, batch_size: Optional[int] = None) -> int:
        """The rows a call of ``m`` rows runs at: the batch size, or the
        JAX package's bucket, ``min(max_bucket, max(8, the power of two at
        or above m))``."""
        size = batch_size or self.batch_size
        if size:
            return int(size)
        return min(self.max_bucket, max(8, 1 << max(m - 1, 0).bit_length()))

    def buckets(self) -> Tuple[int, ...]:
        """Every bucket a request without a batch size of its own can take:
        with a fixed batch size, it alone; else 8, 16, ... up to
        ``max_bucket``."""
        if self.batch_size:
            return (int(self.batch_size),)
        out, b = [], 8
        while b < self.max_bucket:
            out.append(b)
            b *= 2
        return tuple(out) + (self.max_bucket,)

    def chunks(self, n: int, batch_size: Optional[int] = None) -> list:
        """``(first row, rows)`` of each call a request of ``n`` rows makes:
        chunks of the batch size or of ``max_bucket`` (one call of no rows
        for an empty request)."""
        size = batch_size or self.batch_size or self.max_bucket
        return [(s, min(size, n - s)) for s in range(0, max(n, 1), size)]

    def plan(self, n: int, batch_size: Optional[int] = None,
             exact: bool = False) -> List[Tuple[int, int, int]]:
        """``(first row, rows, bucket)`` of each call of a request of ``n``
        rows; ``exact`` for a body whose rows are coupled: the whole
        request at its own rows, or chunks of a batch size when it has
        more rows, each padded to it (module docstring)."""
        size = batch_size or self.batch_size
        if exact and (not size or n <= size):
            return [(0, n, n)]
        return [(s, m, self.bucket(m, batch_size))
                for s, m in self.chunks(n, batch_size)]

    # -- requests -----------------------------------------------------------
    def request(self, name: Hashable, body: Callable,
                batched: Sequence[Tensor], extra: Sequence[Tensor] = (),
                captured: bool = False, settings: tuple = (),
                batch_size: Optional[int] = None, exact: bool = False):
        """``body`` over the rows of ``batched`` (device tensors of n rows)
        and the non-batched device tensors ``extra``, a call a chunk of
        :meth:`plan`, each padded to its bucket; with ``captured``, each
        call its bucket's program under ``settings`` (module docstring).
        Returns the n rows' outputs: a tensor or a tuple."""
        n = batched[0].shape[0]
        bucketed = not (exact or batch_size or self.batch_size)
        with self._lock:
            stream = None
            if captured and self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                if self._last is not None and self._last[0] != stream:
                    stream.wait_event(self._last[1])
            outs = None
            for start, m, bucket in self.plan(n, batch_size, exact):
                rows = [b[start:start + m] for b in batched]
                if captured:
                    res = self._program_run(name, bucket, body, rows, extra,
                                            settings, bucketed)
                else:
                    res = as_tuple(body(*(padded(r, bucket) for r in rows),
                                        *extra))
                if outs is None:
                    outs = tuple(r.new_empty((n,) + r.shape[1:]) for r in res)
                for o, r in zip(outs, res):
                    o[start:start + m].copy_(r[:m])
            if stream is not None:
                event = (torch.cuda.Event() if self._last is None
                         else self._last[1])
                event.record(stream)
                self._last = (stream, event)
        return outs if len(outs) > 1 else outs[0]

    def _static_inputs(self, name: Hashable, bucket: int, rows, extra,
                       bucketed: bool) -> list:
        """``name``'s static input buffers, made (and the name's programs
        dropped, which read the old ones) when the inputs' shapes or
        dtypes change or a bucket passes the buffers' rows: the largest
        bucket's rows, or for a batch size's and an exact body's programs
        the bucket's."""
        signature = (tuple((r.shape[1:], r.dtype) for r in rows),
                     tuple((e.shape, e.dtype) for e in extra))
        inputs = self._inputs.get(name)
        if (inputs is None or self._signature[name] != signature
                or (rows and inputs[0].shape[0] < bucket)):
            for slot in [s for s in self.programs if s[0] == name]:
                del self.programs[slot]  # its graph goes with it
            top = max(bucket, *self.buckets()) if bucketed else bucket
            inputs = self._inputs[name] = (
                [torch.zeros((top,) + r.shape[1:], dtype=r.dtype,
                             device=self.device) for r in rows]
                + [torch.empty_like(e) for e in extra])
            self._signature[name] = signature
        return inputs

    def _program_run(self, name: Hashable, bucket: int, body, rows, extra,
                     settings: tuple, bucketed: bool) -> tuple:
        """Fill ``name``'s static inputs with ``rows`` (zeros up to
        ``bucket``) and ``extra``, and run its program at ``bucket`` (made
        at its first call, the least recently used of its function's kind
        freed beyond the bound); returns the program's outputs, which the
        caller copies out before any other program runs."""
        if self._settings != settings:
            self.programs.clear()  # their graphs and pool go with them
            self._inputs.clear()
            self._signature.clear()
            self._settings, self._pool = settings, _graph.Pool()
        kind = "bucket" if bucketed else "other"
        inputs = self._static_inputs(name, bucket, rows, extra, bucketed)
        m = rows[0].shape[0]
        for buf, r in zip(inputs, rows):
            buf[:m].copy_(r)
            buf[m:bucket].zero_()
        for buf, e in zip(inputs[len(rows):], extra):
            buf.copy_(e)
        slot = (name, bucket)
        prog = self.programs.pop(slot, None)
        if prog is None:
            statics = ([buf[:bucket] for buf in inputs[:len(rows)]]
                       + inputs[len(rows):])
            prog = _graph.Program.body(
                self.device, lambda: as_tuple(body(*statics)), statics,
                self._pool)
            prog.kind = kind
            self.made += 1
        self.programs[slot] = prog
        fn = _function(name)
        limit = len(self.buckets()) if bucketed else OTHERS
        kin = [s for s, p in self.programs.items()
               if _function(s[0]) == fn and p.kind == kind]
        for s in kin[:max(len(kin) - limit, 0)]:
            del self.programs[s]
        return prog.run(clone=False)
