"""Captured epochs: the trainers' counterpart of the JAX package's
one-dispatch epochs.

The JAX trainers run a whole epoch as one jitted ``lax.scan``
(``pyroved_tpu/trainers/svi.py``, ``auxsvi.py``). Here, on a CUDA model
whose loaders are device-resident ``DataLoader``\\ s, each epoch of
``SVItrainer`` and ``auxSVItrainer`` (training, evaluation, and the
labeled-set metric of ``auxSVItrainer.run``) is a :class:`Program`: a body
of steps that reads its batches' rows, weights and KL scale from static
device tables (:class:`~pyroved_tpu_torch.utils.data.StaticTables`),
captured once as a CUDA graph, its steps in a row, and then replayed: one
graph launch an epoch.

Routing (:func:`route`) is by configuration alone. The captured path takes
a CUDA device, loaders that are device-resident DataLoaders, no ``mesh``,
``grad_accum == 1``, no ``pixel_chunks`` or ``shard_pixels``, and
optimizers built with ``capturable=True`` (the default on CUDA:
``torch.optim.Adam(capturable=True)``, :func:`default_optimizer`). Every
other configuration keeps the eager loop: CPU models, streaming loaders
and iterables of batches, meshes (their collectives), gradient
accumulation, partitioned pixels and other optimizers. So does every epoch
while :data:`CAPTURE` is cleared. A capture or replay that fails raises;
nothing falls back to the eager loop.

A trainer keeps one program for each kind of epoch (:class:`GraphCache`),
and with it one graph and one memory pool. A program's first epoch runs
eagerly on a side stream: that is the warm-up PyTorch asks for before a
capture (the optimizer's state, the kernels' plans and cuBLAS's handles
are made there), and it is a real epoch, so the trajectory does not depend
on when a capture happens. Its second epoch is captured (a capture runs
nothing) and replayed; every later epoch refills the tables and replays.
So a program that serves one epoch only (a fresh DataLoader each epoch, a
learning rate written each epoch) costs that eager epoch and no capture.
The trainer's noise generator is registered with each graph, so a replay
draws what the eager steps would have drawn and advances the generator as
far.

A graph holds every Python value its steps read. So a program is made
again, and the one it replaces freed with its graph and pool, when its key
changes: the loaders' shapes, scales and array addresses (loaders over the
same device arrays share a program), the loss's settings, or an
optimizer's hyperparameters (:func:`settings`; under a learning-rate
scheduler that writes a float ``lr`` each epoch every epoch runs eagerly,
while a tensor ``lr`` changed in place is replayed). It is made again,
too, when a tensor it reads in place has been replaced since its first
epoch, and after ``set_encoder``, ``set_decoder``, ``load_weights``,
``load_checkpoint`` and ``resume``, which move the model's
``_graph_generation``.

The kernel wrappers count their launches at each Python call, which a
capture makes once: a capture takes its counts back, and each replay adds
them, so the counters count the kernels the card ran.
"""
import gc
import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import spatial_decoder as _sd

#: Capture the trainers' epochs on CUDA (the default). Cleared, every epoch
#: runs the eager loop, on the card too, for A/B runs. Read at each epoch.
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


def route(trainer, loaders: Sequence, device_type: Optional[str] = None
          ) -> bool:
    """True when ``trainer``'s epochs over ``loaders`` (None entries
    left out) run as captured programs on a device of type
    ``device_type`` (default: the trainer's), by configuration alone
    (module docstring)."""
    from ..utils.data import DataLoader
    model = trainer.model
    return (CAPTURE and (device_type or trainer.device.type) == "cuda"
            and all(isinstance(ld, DataLoader) and ld.device_resident
                    for ld in loaders if ld is not None)
            and trainer.mesh is None and trainer.grad_accum == 1
            and int(getattr(model, "pixel_chunks", 0) or 0) <= 1
            and getattr(model, "_pixel_mesh", None) is None
            and all(graph_optimizer(o) for o in _optimizers(trainer)))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def settings(trainer) -> tuple:
    """The Python values a program's steps read besides its tables: the
    kernels' flag, the model's and trainer's switches of the loss's path
    (``enum_schedule`` changes ``enum_topk``) and, for each optimizer and
    group, every hyperparameter that is not a tensor (``lr``, ``betas``,
    ``eps``, ...)."""
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
            getattr(model, "kl_mode", None), hyper)


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
    return tuple(out)


def loader_key(loader) -> tuple:
    """A DataLoader's part of a key: its batching, its scales and the
    shapes, dtypes and addresses of the device arrays a captured gather
    reads."""
    return (loader.batch_size, loader.num_batches, loader.dataset_size,
            loader.scale, tuple((tuple(a.shape), a.dtype, a.data_ptr())
                                for a in loader.device_arrays))


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


class Program:
    """One epoch's body: ``step(i)`` for each of ``nb`` steps, then
    ``finish()``, which returns the epoch's outputs as a tuple of tensors.
    :meth:`run` runs the epoch: eagerly on the CPU; on CUDA eagerly on a
    side stream the first time, captured and replayed the second, replayed
    after that (module docstring). ``tables`` holds the static inputs the
    body reads; ``generator`` is registered with the graph. After the
    capture,
    ``capture_s`` is its host time, ``pool_bytes`` the memory its pool
    reserved and ``counts`` the kernel launches a replay adds;
    ``replays`` counts the graph launches."""

    def __init__(self, device, nb: int, step: Callable, finish: Callable,
                 tables, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.nb, self.step, self.finish = int(nb), step, finish
        self.tables, self.generator = tables, generator
        self.key = None
        self.warm = False
        self.graph = None
        self.outputs = None
        self.addresses = None
        self.counts = None
        self.capture_s = None
        self.pool_bytes = None
        self.replays = 0

    def _steps(self) -> None:
        for i in range(self.nb):
            self.step(i)

    def run(self):
        """The epoch's outputs, in tensors of their own."""
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
            self.warm = True
            return outputs
        if self.graph is None:
            self._capture()
        self._launch()
        return tuple(o.clone() for o in self.outputs)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # A graph freed mid-capture (a dead trainer's, by the cycle
        # collector) would end the capture: collect first, then hold the
        # collector until the capture is over.
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _counts()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # other threads (a checkpoint writer, a process group's
            # watchdog) keep the runtime; this thread makes no call a
            # capture refuses
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._steps()
                self.outputs = self.finish()
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


class GraphCache:
    """A trainer's programs, one for each kind of epoch (module
    docstring)."""

    def __init__(self):
        self.programs = {}
        self.generation = None

    def run(self, trainer, kind, key, make: Callable[[], Program],
            fill: Callable) -> tuple:
        """Run the epoch of ``kind``: its program, made by ``make()`` when
        there is none, when its ``key`` (with :func:`settings`) differs, or
        when a tensor it reads in place has been replaced since its first
        epoch; its tables filled by ``fill(tables)``. Returns the epoch's
        outputs."""
        generation = getattr(trainer.model, "_graph_generation", 0)
        if generation != self.generation:
            self.programs.clear()
            self.generation = generation
        key = (key, settings(trainer))
        prog = self.programs.get(kind)
        if prog is None or prog.key != key or (
                prog.addresses is not None
                and prog.addresses != _addresses(trainer)):
            self.programs.pop(kind, None)  # its graph and pool go with it
            prog = self.programs[kind] = make()
            prog.key = key
        fill(prog.tables)
        outputs = prog.run()
        if prog.addresses is None:  # the optimizer's state made by now
            prog.addresses = _addresses(trainer)
        return outputs

    def captured(self) -> list:
        """The programs that hold a graph."""
        return [p for p in self.programs.values() if p.graph is not None]
