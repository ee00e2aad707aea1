"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``. Nothing includes PyTorch's
headers, so a build takes seconds. Libraries go into
``pyroved_tpu_torch/_build/``, named by a hash of the source and the
command, and are built on first use in a process; a later process with the
same source reuses the file. The hash covers every ``csrc/*.cuh`` header the
source includes (``#include "..."``, followed into headers), so an edit to
a shared header never loads a stale library. A source may also be built
with preprocessor macros defined (``defines``), into a library of its own.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Hopper only: ``sm_90a`` keeps wgmma and setmaxnreg available to later
#: kernels; plain ``sm_90`` refuses them.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, else ``PATH``, else ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(source: str, output: str,
                 defines: Sequence[str] = ()) -> List[str]:
    """The command that compiles ``source`` into the shared library
    ``output``, with each macro of ``defines`` defined. ``-Xptxas=-v``
    reports registers, shared memory and spills into the build log."""
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", *(f"-D{d}" for d in defines),
            "-o", output, source]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _texts(path: str, seen: List[str]) -> List[bytes]:
    """The text of ``path`` and of every header in ``CSRC`` it includes
    with quotes, each once, in the order first reached."""
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    texts = [text]
    for inc in _INCLUDE.findall(text):
        header = os.path.join(CSRC, inc.decode())
        if header not in seen and os.path.isfile(header):
            texts += _texts(header, seen)
    return texts


def _target(name: str, defines: Tuple[str, ...] = ()) -> Tuple[str, str]:
    source = os.path.join(CSRC, name + ".cu")
    cmd = " ".join(nvcc_command(source, "OUT", defines)).encode()
    digest = hashlib.sha256(
        b"\0".join(_texts(source, []) + [cmd])).hexdigest()[:16]
    return source, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_log(name: str, defines: Sequence[str] = ()) -> str:
    """What ``nvcc`` printed when it built ``name`` (ptxas usage lines)."""
    _, lib = _target(name, tuple(defines))
    try:
        with open(lib + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def load_all(names: List[str],
             defines: Sequence[str] = ()) -> List[ctypes.CDLL]:
    """Build every ``csrc/<name>.cu`` that needs it (with the macros of
    ``defines``), one ``nvcc`` each, all started together, and return the
    loaded libraries in order."""
    defines = tuple(defines)
    with _lock:
        builds = []
        for name in names:
            source, lib = _target(name, defines)
            if (name, defines) in _loaded or os.path.exists(lib):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            proc = subprocess.Popen(nvcc_command(source, tmp, defines),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            builds.append((source, lib, tmp, proc))
        failures = []
        for source, lib, tmp, proc in builds:  # wait for every one
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failures.append(f"nvcc failed to build {source} "
                                f"(exit {proc.returncode}):\n{log}")
                continue
            with open(lib + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, lib)
        if failures:
            raise RuntimeError("\n".join(failures))
        for name in names:
            if (name, defines) not in _loaded:
                _loaded[name, defines] = ctypes.CDLL(_target(name, defines)[1])
        return [_loaded[name, defines] for name in names]


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (with the macros of ``defines``) if needed
    and return the loaded library."""
    return load_all([name], defines)[0]
