"""Profiling and timing.

Counterpart of ``pyroved_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of the host and, on a card, of its kernels into a
directory (a Chrome-trace JSON, which TensorBoard's profiler plugin and
``chrome://tracing`` read); ``Timer`` accumulates named wall-clock times;
``enable_compilation_cache`` keeps the built CUDA kernel libraries in a
directory that later processes reuse (it sets ``ops._build.BUILD_DIR``),
the port's counterpart of JAX's persistent compilation cache.
"""
import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Build the port's CUDA kernels into ``path`` and load them from there,
    so that a later process calling this with the same path skips ``nvcc``
    (a library's name hashes its source, headers and build command). The
    default is ``pyroved_tpu_torch_kernels`` in the temporary directory.
    Returns the directory."""
    from ..ops import _build
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "pyroved_tpu_torch_kernels")
    _build.BUILD_DIR = os.path.abspath(path)
    return _build.BUILD_DIR


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (host activity, and
    the card's kernels when CUDA is available) and write it into
    ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json`` when the block
    ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)):
        yield


class Timer:
    """Accumulating named wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.totals}
