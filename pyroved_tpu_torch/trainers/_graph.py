"""Captured epochs: the trainers' counterpart of the JAX package's
one-dispatch epochs.

The JAX trainers run a whole epoch as one jitted ``lax.scan``
(``pyroved_tpu/trainers/svi.py``, ``auxsvi.py``), and a chunked streaming
epoch (``DataLoader(device_resident=False, stream_chunks=c)``,
``_train_chunked_stream``) as one scan a chunk of c batches. Here, on a
CUDA model, each such epoch of ``SVItrainer`` and ``auxSVItrainer``
(training, evaluation, and the labeled-set metric of
``auxSVItrainer.run``), or each chunk of it, is a :class:`Program`: a body
of steps that reads its batches' rows, weights and KL scale from static
device tables (:class:`~pyroved_tpu_torch.utils.data.StaticTables`; a
chunk's rows copied in by
:meth:`~pyroved_tpu_torch.utils.data.DataLoader.chunk_feed`), captured
once as a CUDA graph, its steps in a row, and then replayed: one graph
launch an epoch, or a chunk. Under ``grad_accum=k`` (``optax.MultiSteps``)
the accumulation window and its updates are inside the program too.

Routing (:func:`route`) is by configuration alone. The captured path takes
a CUDA device; loaders that are device-resident DataLoaders, except that
the epoch's first loader (the training loader, the held-out one, or
``auxSVItrainer``'s unlabeled one, not its labeled or validation loader)
may be a streaming DataLoader with ``stream_chunks > 1``; no ``mesh`` and
no ``shard_pixels``; and optimizers built with ``capturable=True`` (the
default on CUDA: ``torch.optim.Adam(capturable=True)``,
:func:`default_optimizer`). ``grad_accum``, ``remat`` and ``pixel_chunks``
take either path: the JAX trainers run a pixel-chunked loss (its
``lax.scan`` over grid tiles) inside their one-dispatch epoch, and here a
step's k tiles (k K1 and k K2 on the kernels' path, each tile checkpointed
without RNG state on the module path) are captured with it. Every other
configuration keeps the eager loop: CPU models, streaming loaders of one
batch at a time and iterables of batches (the JAX package dispatches those
once a batch too), meshes and pixel shards (their collectives: gloo's
cannot be captured, and NCCL takes one rank a device, so a captured
``all_reduce`` cannot be checked on one card) and other optimizers. So
does every epoch while :data:`CAPTURE` is cleared. A capture or replay
that fails raises; nothing falls back to the eager loop.

The same programs serve requests (``trainers/_requests.py``):
``ServedModel``'s and the models' own (encode, decode, reconstruct,
manifold2d, the heads, ``guide_probs``, ``VED.predict``), one a function
and bucket. What stays eager after them: per-batch streaming (and
iterables of batches), ``mesh=`` epochs, ``shard_pixels``, and the
requests of a model whose parameters a mesh splits (tensor parallelism, a
pixel grid under ``shard_pixels``), for the collectives above.

A trainer keeps its programs by kind of epoch (:class:`GraphCache`), each
with one graph. A kind holds several variants where the steps a graph
freezes differ from run to run: a streamed epoch's full chunk and its
short last one, ``auxSVItrainer``'s labeled steps within a chunk
(``mask[start:start + c]``, which moves with ``start`` mod the cadence),
and under ``grad_accum`` the window's position when the program starts
(each step's divisor and whether it updates are frozen). Which ones an
epoch's schedule takes follows from it (:func:`variants`: the chunks, the
cadence, the window and the batches an epoch), and the kind keeps those. They are captured one after another and replayed one at a time in
one stream's order, so they share one memory pool, and a streamed kind's
programs one table of chunk rows (:meth:`GraphCache.shared`): a variant
adds its graph, not its memory. A program's first run is eager on a side
stream: that is the warm-up PyTorch asks for before a capture (the
optimizer's state, the kernels' plans and cuBLAS's handles are made
there), and it is a real epoch, or chunk, so the trajectory does not
depend on when a capture happens. Its second run is captured (a capture
runs nothing) and replayed; every later run refills the tables and
replays. So a program that runs once only (a fresh DataLoader each epoch,
a learning rate written each epoch) costs that eager run and no capture.
The trainer's noise generator is registered with each graph, so a replay
draws what the eager steps would have drawn and advances the generator as
far; after each run the window's ``mini_step`` is where the eager loop
leaves it.

A graph holds every Python value its steps read. So a kind's programs are
made again, and those they replace freed with their graphs and pool, when
its key changes: the loaders' shapes, scales and array addresses (loaders
over the same device arrays share a program; a streaming loader's rows are
copied in, so :meth:`~pyroved_tpu_torch.utils.data.DataLoader.chunk_key`,
its chunk's shapes, dtypes and scales, keys it, not its arrays), the
loss's settings, or an optimizer's hyperparameters (:func:`settings`;
under a learning-rate scheduler that writes a float ``lr`` each epoch
every epoch runs eagerly, while a tensor ``lr`` changed in place is
replayed). A program is made again, too, when a tensor it reads in place
(the ``grad_accum`` window's among them) has been replaced since its first
run, and every program after ``set_encoder``, ``set_decoder``,
``load_weights``, ``load_checkpoint`` and ``resume``, which move the
model's ``_graph_generation``.

The kernel wrappers count their launches at each Python call, which a
capture makes once: a capture takes its counts back, and each replay adds
them, so the counters count the kernels the card ran.
"""
import gc
import math
import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import spatial_decoder as _sd

#: Capture the trainers' epochs, ``ServedModel``'s requests and the models'
#: own requests on CUDA (the default). Cleared, every epoch runs the eager
#: loop and every request its bucketed body eagerly, on the card too, for
#: A/B runs. Read at each epoch and each request.
CAPTURE = True

_COUNTED = (_sd.fused_spatial_decoder_forward,
            _sd.fused_spatial_decoder_backward,
            _sd.fused_bernoulli_recon_loss_kernel)


# ---------------------------------------------------------------------------
# The optimizer and the routing
# ---------------------------------------------------------------------------

def default_optimizer(params, lr: float, device) -> torch.optim.Optimizer:
    """The trainers' default optimizer: ``torch.optim.Adam(lr)``, built
    with ``capturable=True`` on CUDA (its count and bias corrections on the
    device, as a captured step needs), so that the captured epochs and the
    eager loop there step alike."""
    return torch.optim.Adam(params, lr=lr,
                            capturable=torch.device(device).type == "cuda")


def graph_optimizer(optimizer: torch.optim.Optimizer) -> bool:
    """True when a captured epoch can take ``optimizer``'s step: every
    group was built with ``capturable=True``."""
    return bool(optimizer.param_groups) and all(
        g.get("capturable", False) for g in optimizer.param_groups)


def _optimizers(trainer) -> list:
    return [o for o in (trainer.optimizer,
                        getattr(trainer, "aux_optimizer", None))
            if o is not None]


def route(trainer, loaders: Sequence, device_type: Optional[str] = None,
          chunked: bool = True) -> bool:
    """True when ``trainer``'s epochs over ``loaders`` (None entries
    left out) run as captured programs on a device of type
    ``device_type`` (default: the trainer's), by configuration alone
    (module docstring). With ``chunked`` the first loader may stream in
    chunks (``stream_chunks > 1``); every other one is resident. Eager
    still: per-batch streaming and iterables of batches, ``mesh=``,
    ``shard_pixels``, optimizers without ``capturable=True``; and, in the
    requests' route (``models.base.request_route``), models whose
    parameters a mesh splits."""
    from ..utils.data import DataLoader
    model = trainer.model

    def fits(i, ld):
        return isinstance(ld, DataLoader) and (
            ld.device_resident
            or (chunked and i == 0 and ld.stream_chunks > 1))

    return (CAPTURE and (device_type or trainer.device.type) == "cuda"
            and all(fits(i, ld) for i, ld in enumerate(loaders)
                    if ld is not None)
            and trainer.mesh is None
            and getattr(model, "_pixel_mesh", None) is None
            and all(graph_optimizer(o) for o in _optimizers(trainer)))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def settings(trainer) -> tuple:
    """The Python values a program's steps read besides its tables: the
    kernels' flag, the model's and trainer's switches of the loss's path
    (``enum_schedule`` changes ``enum_topk``; the pixel mode and
    ``pixel_chunks``, as the JAX package's ``_pixel_gate_key`` keys its
    trainers' rebuild) and, for each optimizer and group, every
    hyperparameter that is not a tensor (``lr``, ``betas``, ``eps``,
    ...)."""
    model = trainer.model
    hyper = tuple(
        tuple(sorted((k, v) for k, v in g.items()
                     if k != "params" and not torch.is_tensor(v)))
        for opt in _optimizers(trainer) for g in opt.param_groups)
    return (_sd.BF16_MATMUL, bool(getattr(model, "one_pass_train", False)),
            int(getattr(model, "enum_topk", 0) or 0),
            bool(getattr(trainer, "remat", False)),
            bool(getattr(model, "_fused", False)),
            getattr(model, "_dec_act", None),
            int(getattr(model, "num_particles", 1)),
            getattr(model, "kl_mode", None), model._pixel_mode(),
            int(model.pixel_chunks or 0), hyper)


def _addresses(trainer) -> tuple:
    """The addresses of the tensors a program reads in place: the model's
    parameters and buffers, the optimizers' states and their tensor
    hyperparameters."""
    nets = trainer.model.nets
    out = [t.data_ptr() for t in nets.parameters()]
    out += [t.data_ptr() for t in nets.buffers()]
    for opt in _optimizers(trainer):
        out += [v.data_ptr() for s in opt.state.values()
                for v in s.values() if torch.is_tensor(v)]
        out += [v.data_ptr() for g in opt.param_groups
                for k, v in g.items() if k != "params" and torch.is_tensor(v)]
    accum = getattr(trainer, "grad_accumulator", None)
    if accum is not None:
        out += [a.data_ptr() for a in accum.acc]
    return tuple(out)


def loader_key(loader) -> tuple:
    """A DataLoader's part of a key: its batching, its scales and the
    shapes, dtypes and addresses of the device arrays a captured gather
    reads."""
    return (loader.batch_size, loader.num_batches, loader.dataset_size,
            loader.scale, tuple((tuple(a.shape), a.dtype, a.data_ptr())
                                for a in loader.device_arrays))


def variants(trainer, runs: Sequence[tuple]) -> frozenset:
    """The variants a kind of epoch keeps for ``trainer``'s epochs of
    ``runs``, ``(variant, micro-steps)`` for each of its runs in order (a
    resident epoch one run, a streamed one a run a chunk): each run's
    variant, and under ``grad_accum=k`` with the window's position at its
    start appended (:meth:`GraphCache.run`), over the epochs from the
    window's position now until it comes round again to an epoch's start
    (k / gcd(micro-steps an epoch, k) of them). Each of these comes round
    once a cycle, and no other does."""
    accum = getattr(trainer, "grad_accumulator", None)
    k, m = (accum.k, accum.mini_step) if accum is not None else (1, 0)
    total = sum(micro for _, micro in runs)
    seen = set()
    for _ in range(k // math.gcd(total, k)):
        for variant, micro in runs:
            window = (m,) if micro and accum is not None else ()
            seen.add(tuple(variant) + window)
            m = (m + micro) % k
    return frozenset(seen)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

def _counts() -> list:
    return [dict(k.launches) for k in _COUNTED]


def _add_counts(counts: list, sign: int = 1) -> None:
    for k, c in zip(_COUNTED, counts):
        for source, n in c.items():
            k.launches[source] += sign * n


_side_streams = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class Pool:
    """A graph memory pool that programs captured one after another and
    replayed one at a time, in one stream's order, share; made at the
    first capture into it."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class Program:
    """One epoch's (or chunk's) body: ``step(i)`` for each of ``nb``
    steps, then ``finish()``, which returns the outputs as a tuple of
    tensors. :meth:`run` runs it: eagerly on the CPU; on CUDA eagerly on a
    side stream the first time, captured and replayed the second, replayed
    after that (module docstring). ``tables`` holds the static inputs the
    body reads; ``generator`` is registered with the graph, which is
    captured into ``pool`` where given (a :class:`Pool`; a kind's, from
    :class:`GraphCache`). With ``tidy`` a capture first collects the
    garbage, synchronizes and empties the allocator's cache (an epoch's
    capture is rare and large; :meth:`body`'s skip it). After the capture,
    ``capture_s`` is its host time, ``pool_bytes`` the memory the capture
    added to the reserve and ``counts`` the kernel launches a replay adds;
    ``replays`` counts the graph launches."""

    def __init__(self, device, nb: int, step: Callable, finish: Callable,
                 tables, generator: Optional[torch.Generator] = None,
                 pool: Optional[Pool] = None, tidy: bool = True):
        self.device = torch.device(device)
        self.nb, self.step, self.finish = int(nb), step, finish
        self.tables, self.generator = tables, generator
        self.pool, self.tidy = pool, tidy
        self.kind = None
        self.warm = False
        self.graph = None
        self.outputs = None
        self.addresses = None
        self.counts = None
        self.capture_s = None
        self.pool_bytes = None
        self.replays = 0

    @classmethod
    def body(cls, device, fn: Callable, tables, pool: Pool) -> "Program":
        """A program of one body, ``fn()``, which returns its outputs as a
        tuple of tensors and reads ``tables``, captured into ``pool``
        without the tidy-up (a served request's; ``serving.py``)."""
        return cls(device, 0, None, fn, tables, pool=pool, tidy=False)

    def _steps(self) -> None:
        for i in range(self.nb):
            self.step(i)

    def run(self, clone: bool = True):
        """The epoch's outputs, in tensors of their own; with ``clone``
        False, after a replay, the graph's static outputs themselves, which
        the caller copies before any program of the pool runs again."""
        if self.device.type != "cuda":
            self._steps()
            return self.finish()
        if not self.warm:
            current = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._steps()
                outputs = self.finish()
            current.wait_stream(side)
            for o in outputs:  # made on the side stream, read on this one
                if o.is_cuda:
                    o.record_stream(current)
            self.warm = True
            return outputs
        if self.graph is None:
            self._capture()
        self._launch()
        if not clone:
            return self.outputs
        return tuple(o.clone() for o in self.outputs)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        if self.tidy:
            # A graph freed mid-capture (a dead trainer's, by the cycle
            # collector) would end the capture: collect first (and hold
            # the collector until the capture is over, below).
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        pool = None if self.pool is None else self.pool.handle()
        before = _counts()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # on the side stream, which the replays need not wait for (a
            # capture runs nothing); other threads (a checkpoint writer, a
            # process group's watchdog) keep the runtime, and this thread
            # makes no call a capture refuses
            with torch.cuda.stream(_side_stream(self.device)):
                graph.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    self._steps()
                    self.outputs = self.finish()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.counts = [{s: n - b[s] for s, n in a.items()}
                       for a, b in zip(_counts(), before)]
        _add_counts(self.counts, -1)  # a capture launches nothing
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph

    def _launch(self) -> None:
        self.graph.replay()
        self.replays += 1
        _add_counts(self.counts)


class _Kind(Pool):
    """What the programs of one kind of epoch share: the key they were
    made under, one memory pool and the kind's tables
    (:meth:`GraphCache.shared`)."""

    def __init__(self, key):
        super().__init__()
        self.key = key
        self.tables = None


class GraphCache:
    """A trainer's programs, by kind of epoch and variant (module
    docstring). ``programs`` maps each program's slot (its kind, then its
    variant) to it, the one run last at the end; ``kinds`` maps each kind
    to what its programs share; ``made`` counts the programs made."""

    def __init__(self):
        self.programs = {}
        self.kinds = {}
        self.generation = None
        self.made = 0

    def run(self, trainer, kind: tuple, key, make: Callable[[], Program],
            fill: Callable, variant: tuple = (), micro: int = 0,
            keep: Optional[frozenset] = None) -> tuple:
        """Run the epoch (or chunk) of ``kind`` and ``variant``: its
        program, made by ``make()`` when there is none, when the kind's
        ``key`` (with :func:`settings`) differs, which drops every program
        of the kind, or when a tensor it reads in place has been replaced
        since its first run; its tables filled by ``fill(tables)``.
        ``micro`` counts the run's micro-steps of the trainer's
        ``grad_accum`` window: the window's position at the start is part
        of the variant, and its ``mini_step`` is advanced past them
        afterwards. The kind keeps the programs of the variants in
        ``keep`` (:func:`variants` of its schedule; by default this
        run's) and drops the others. Returns the outputs."""
        generation = getattr(trainer.model, "_graph_generation", 0)
        if generation != self.generation:
            self.programs.clear()
            self.kinds.clear()
            self.generation = generation
        accum = getattr(trainer, "grad_accumulator", None) if micro else None
        if accum is not None:
            variant = tuple(variant) + (accum.mini_step,)
        slot = kind + tuple(variant)
        keep = {tuple(variant)} if keep is None else keep
        key = (key, settings(trainer))
        state = self.kinds.get(kind)
        if state is None or state.key != key:
            for s in [s for s, p in self.programs.items() if p.kind == kind]:
                del self.programs[s]  # its graph goes with it
            state = self.kinds[kind] = _Kind(key)
        prog = self.programs.pop(slot, None)
        if prog is None or (prog.addresses is not None
                            and prog.addresses != _addresses(trainer)):
            prog = make()
            prog.kind, prog.pool = kind, state
            self.made += 1
        self.programs[slot] = prog
        for s in [s for s, p in self.programs.items()
                  if p.kind == kind and s[len(kind):] not in keep]:
            del self.programs[s]
        fill(prog.tables)
        start = None if accum is None else accum.mini_step
        outputs = prog.run()
        if accum is not None:  # a replay runs no Python
            accum.mini_step = (start + micro) % accum.k
        if prog.addresses is None:  # the optimizer's state made by now
            prog.addresses = _addresses(trainer)
        return outputs

    def shared(self, kind: tuple, build: Callable):
        """The tables the programs of ``kind`` share, made by ``build()``
        at the first one (from :meth:`run`'s ``make``): a streamed kind's
        chunk rows, which each run fills before its launch."""
        state = self.kinds[kind]
        if state.tables is None:
            state.tables = build()
        return state.tables

    def captured(self) -> list:
        """The programs that hold a graph."""
        return [p for p in self.programs.values() if p.graph is not None]
