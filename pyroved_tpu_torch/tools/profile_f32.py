"""Profile the f32 kernels (``csrc/spatial_decoder_fwd.cu``, K1, and
``csrc/spatial_decoder_bwd.cu``, K2/K3) on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_f32 [--baseline DIR]

Builds both sources with ``PVT_PROFILE_PHASES`` defined, which compiles in
the ``PhaseClock`` marks of ``csrc/f32_core.cuh`` (thread 0 of block 0 adds
the cycles since its previous mark to the phase the mark closes), prints
each build's ptxas usage, then at the flagship decoder (H = 128, two tanh
layers, N = 784) the cycles per tile of block 0 by phase: K1 at B = 1024
and 200, K2 at B = 200. Then the CUDA-event time of the unprofiled kernels
at the same shapes (K3 too).

``--baseline DIR`` does the same, in the same process, for the f32 sources
in ``DIR`` (``spatial_decoder_fwd.cu`` and ``spatial_decoder_bwd.cu`` that
take the same arguments and define ``pvt_sdec_fwd_phase_cycles`` and
``pvt_sdec_bwd_phase_cycles``, such as the first f32 K1 with marks added),
so that two versions compare within one run. Prints one JSON line
per version at the end.
"""
import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import bf16_matmul, cuda_ms, random_case

DEFINES = ("PVT_PROFILE_PHASES",)
#: What each mark closes, in mark order (K1 counts block 0's tiles in 7).
K1_PHASES = ("(loop)", "weight staging", "transform, h0", "products",
             "activations", "head")
K2_PHASES = ("(loop)", "weight staging", "transform, h0", "forward products",
             "forward activations", "head, head grads, last d_pre",
             "weight-grad accumulation (dW, db)",
             "dh products, d_pre, tile sums")
K1_SHAPES = ((1024, 784), (200, 784))
K2_SHAPE = (200, 784)


def build(path, defines=()):
    """``path`` built as the port builds a source (``_build.nvcc_command``),
    into the build directory under a name of its own; the loaded library."""
    name = os.path.splitext(os.path.basename(path))[0]
    with open(path, "rb") as f:
        text = f.read()
    cmd = " ".join(_build.nvcc_command(path, "OUT", defines)).encode()
    digest = hashlib.sha256(text + b"\0" + cmd).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"ext-{name}-{digest}.so")
    if not os.path.exists(lib):
        res = subprocess.run(_build.nvcc_command(path, lib, defines),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{res.stdout}"
                               f"{res.stderr}")
        with open(lib + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
    with open(lib + ".log") as f:
        return ctypes.CDLL(lib), f.read()


def usage(log):
    """The registers and spill lines of a build's ptxas report."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def bound(fwd_lib, bwd_lib):
    """The two libraries bound as the f32 K1 and K2/K3 inside the block."""
    saved_f, saved_b = dict(sd._fwd_fns), dict(sd._bwd_fns)
    sd._fwd_fns[False] = sd._bind_fwd(fwd_lib, False)
    sd._bwd_fns[False] = sd._bind_bwd(bwd_lib, False)
    sd._bwd_plan.cache_clear()
    try:
        yield
    finally:
        for fns, saved in ((sd._fwd_fns, saved_f), (sd._bwd_fns, saved_b)):
            fns.clear()
            fns.update(saved)
        sd._bwd_plan.cache_clear()


def reader(lib, name):
    read = getattr(lib, name)
    read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    read.restype = ctypes.c_int
    return read


def marks(read, fn):
    """The 8 phase counters of one call of ``fn`` (after a warm call)."""
    cycles = (ctypes.c_longlong * 8)()
    fn()
    torch.cuda.synchronize()
    if read(cycles, 1) != 0:
        raise RuntimeError("resetting the phase cycles failed")
    fn()
    torch.cuda.synchronize()
    if read(cycles, 0) != 0:
        raise RuntimeError("reading the phase cycles failed")
    return list(cycles)


def per_tile(cycles, names, tiles):
    out = {name: round(cycles[k] / tiles, 1) for k, name in enumerate(names)}
    out["total"] = round(sum(cycles[:len(names)]) / tiles, 1)
    return out


def profile(label, fwd, bwd, prof, old_layout):
    """Phases (profiled builds) and times (plain builds) of one version.
    ``old_layout``: the version launches one K1 block per 64-pixel tile
    (the first f32 K1), else the persistent layout of ``f32_core.cuh``
    whose K1 counts block 0's tiles in counter 7. K2 strides the tiles
    over its blocks in both."""
    rng = np.random.default_rng(0)
    res = {"version": label, "k1": {}, "k2": {}}
    k1 = sd.fused_spatial_decoder_forward
    k2 = sd.fused_spatial_decoder_backward
    k3 = sd.fused_bernoulli_recon_loss_kernel
    with bf16_matmul(False), torch.no_grad():
        for B, N in K1_SHAPES:
            a = random_case(rng, "cuda", 2, 1, 128, B, N, 2, 2)
            with bound(*prof):
                c = marks(reader(prof[0], "pvt_sdec_fwd_phase_cycles"),
                          lambda: k1(**a))
            tiles = 1 if old_layout else c[7]
            with bound(fwd, bwd):
                ms = cuda_ms(lambda: k1(**a), reps=20)
            res["k1"][f"B={B} N={N}"] = {
                "cycles_per_tile": per_tile(c, K1_PHASES, tiles),
                "tiles_of_block0": tiles, "ms": round(ms, 4)}
        B, N = K2_SHAPE
        a = random_case(rng, "cuda", 2, 1, 128, B, N, 2, 2)
        g = torch.randn(B, N, device="cuda")
        x = torch.rand(B, N, device="cuda")
        w = torch.rand(B, device="cuda")
        args3 = (a["grid"], a["phi"], a["dx"], a["sc"], a["z"], x, w, a["Wc"],
                 a["bc"], a["Wz"], a["hw"], a["hb"], a["wout"], a["bout"])
        with bound(*prof):
            c = marks(reader(prof[1], "pvt_sdec_bwd_phase_cycles"),
                      lambda: k2(**a, g=g))
            _, blocks = sd.bwd_workspace(B, N, 2, 2, 128, 2, 1, bf16=False)
        total = B * -(-N // 64)
        tiles = -(-total // blocks)  # block 0's
        with bound(fwd, bwd):
            ms2 = cuda_ms(lambda: k2(**a, g=g), reps=20)
            ms3 = cuda_ms(lambda: k3(*args3), reps=20)
        res["k2"][f"B={B} N={N}"] = {
            "cycles_per_tile": per_tile(c, K2_PHASES, tiles),
            "tiles_of_block0": tiles, "blocks": blocks, "ms": round(ms2, 4),
            "k3_ms": round(ms3, 4)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory of earlier f32 sources "
                    "with phase marks, profiled beside the port's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_f32: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = [sd.FWD_SOURCES[False], sd.BWD_SOURCES[False]]
    plain = _build.load_all(names)
    prof = _build.load_all(names, DEFINES)
    for n in names:
        print(f"ptxas {n} (profiled): {usage(_build.build_log(n, DEFINES))}",
              flush=True)
    versions = []
    if args.baseline:
        paths = [os.path.join(args.baseline, n + ".cu") for n in names]
        base = [build(p)[0] for p in paths]
        base_prof = [build(p, DEFINES) for p in paths]
        for n, (_, log) in zip(names, base_prof):
            print(f"ptxas baseline {n} (profiled): {usage(log)}", flush=True)
        versions.append(("baseline", base, [lib for lib, _ in base_prof],
                         True))
    versions.append(("port", plain, prof, False))
    results = []
    for label, libs, plibs, old in versions:
        res = profile(label, libs[0], libs[1], tuple(plibs), old)
        res["card"] = smi
        results.append(res)
    for res in results:
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
