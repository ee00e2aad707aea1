"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``. Nothing includes PyTorch's
headers, so a build takes seconds. Libraries go into
``pyroved_tpu_torch/_build/``, named by a hash of the source and the
command, and are built on first use in a process; a later process with the
same source reuses the file.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Hopper only: ``sm_90a`` keeps wgmma and setmaxnreg available to later
#: kernels; plain ``sm_90`` refuses them.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, else ``PATH``, else ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(source: str, output: str) -> List[str]:
    """The command that compiles ``source`` into the shared library
    ``output``. ``-Xptxas=-v`` reports registers, shared memory and spills
    into the build log."""
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", output, source]


def _target(name: str) -> Tuple[str, str]:
    source = os.path.join(CSRC, name + ".cu")
    with open(source, "rb") as f:
        text = f.read()
    cmd = " ".join(nvcc_command(source, "OUT")).encode()
    digest = hashlib.sha256(text + b"\0" + cmd).hexdigest()[:16]
    return source, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``name`` (ptxas usage lines)."""
    _, lib = _target(name)
    try:
        with open(lib + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        source, lib = _target(name)
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            proc = subprocess.run(nvcc_command(source, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {source} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            with open(lib + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        _loaded[name] = ctypes.CDLL(lib)
        return _loaded[name]
