"""Profile the f32 kernels (``BF16_MATMUL = False``) on the card: K1
(``csrc/spatial_decoder_fwd.cu``) and K2/K3 (``csrc/spatial_decoder_bwd_x3.cu``,
three-limb bf16 products on the tensor cores).

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_f32 [--baseline DIR]

Builds both sources with ``PVT_PROFILE_PHASES`` defined, which compiles in
the phase marks (thread 0 of block 0 adds the cycles since its previous
mark to the phase the mark closes), prints each build's ptxas usage, then
at the flagship decoder (H = 128, two tanh layers, N = 784) the cycles per
tile of block 0 by phase: K1 at B = 1024 and 200, K2 at B = 200. Then the
CUDA-event time of the unprofiled kernels: K1 at those shapes, K2 at the
shapes of the paths (the flagship, the large grid, jiVAE's 2,000
enumerated rows, B = 50, the 600 rows of ``enum_topk=3``, a 512x512 tile
and a pixel rank of the 512x512 grid; random inputs), K3 at the first
four, and cuBLAS's f32 bare products (TF32 off) of the same hidden layers
at the first four.

``--baseline DIR`` does the same, in the same process, for the f32
sources in ``DIR``: ``spatial_decoder_fwd.cu`` and a K2/K3 source, either
``spatial_decoder_bwd_x3.cu`` or the first f32 K2/K3,
``spatial_decoder_bwd.cu`` (entry points ``pvt_sdec_bwd`` and
``pvt_sdec_bwd_phase_cycles``), with the headers they include; e.g. the
parent commit's ``pyroved_tpu_torch/csrc`` unpacked under ``_checkout/``,
which ``.gitignore`` lists. Each K2 time is then taken in turns, baseline,
port, port, baseline, so that two versions compare within one run and the
repeats show the spread. Where ``DIR`` also holds the bf16 K2/K3,
``spatial_decoder_bwd_tc.cu``, it is held against the port's the same way
(its time at the flagship and the 512x512 tile in turns), and the two
builds' machine code is compared function by function (``cuobjdump
-sass``, the anonymous namespace's hash left out). Prints one JSON line
per version at the end.
"""
import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
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
#: The marks of each K2/K3 source, by file name.
K2_PHASES = {
    "spatial_decoder_bwd": (
        "(loop)", "weight staging", "transform, h0", "forward products",
        "forward activations", "head, head grads, last d_pre",
        "weight-grad accumulation (dW, db)", "dh products, d_pre, tile sums"),
    "spatial_decoder_bwd_x3": (
        "(loop)", "per-sample transform, tile coordinates", "h0",
        "forward recompute", "head dots", "head: logits, cotangents, loss",
        "last layer", "hidden layers, last to first")}
#: The C entry points of each K2/K3 source, by file name.
K2_ENTRIES = {"spatial_decoder_bwd": "pvt_sdec_bwd",
              "spatial_decoder_bwd_x3": "pvt_sdec_bwd_x3"}
K1_SHAPES = ((1024, 784), (200, 784))
#: (name, B, N, L): K2's shapes; K3 and cuBLAS at the first four.
K2_SHAPES = (("flagship", 200, 784, 2), ("large grid", 64, 16384, 2),
             ("jiVAE B=2000", 2000, 784, 12), ("512x512 tile", 200, 16384, 2),
             ("B=50", 50, 784, 2), ("top-3 B=600", 600, 784, 12),
             ("pixel rank", 200, 131072, 2))
WITH_LIBRARY = 4


def build(path, defines=()):
    """``path`` built as the port builds a source (``_build.nvcc_command``),
    into the build directory under a name of its own; the loaded library
    and the build's log."""
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
def bound(fwd_lib, bwd_lib, bwd_name):
    """The two libraries bound as the f32 K1 and K2/K3 inside the block
    (``bwd_name`` the K2/K3 source's file name)."""
    saved_f, saved_b = dict(sd._fwd_fns), dict(sd._bwd_fns)
    sd._fwd_fns[False] = sd._bind_fwd(fwd_lib, False)
    sd._bwd_fns[False] = sd._bind_bwd(bwd_lib, K2_ENTRIES[bwd_name])
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


def k2_inputs(B, N, L, seed):
    """K2's and K3's random inputs at one shape: the decoder's inputs, a
    cotangent, observations and weights."""
    a = random_case(np.random.default_rng(seed), "cuda", 2, 1, 128, B, N, L,
                    2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(B, N, generator=gen, device="cuda")
    x = torch.rand(B, N, generator=gen, device="cuda")
    w = torch.rand(B, generator=gen, device="cuda")
    return a, g, x, w


def cublas_ms(B, N, chunks=1):
    """cuBLAS's f32 time (TF32 off) for the hidden products of one K2 call
    at the flagship's two 128-wide layers, as bare matrix products: h W,
    h^T d and d W^T a layer, over ``chunks`` row chunks."""
    rows = B * N // chunks
    h = torch.randn(rows, 128, device="cuda")
    d = torch.randn(rows, 128, device="cuda")
    w = torch.randn(2, 128, 128, device="cuda")

    def products():
        for i in range(2):
            torch.matmul(h, w[i])
            torch.matmul(h.T, d)
            torch.matmul(d, w[i].T)

    return chunks * cuda_ms(products, reps=5 if chunks > 1 else 20)


def phases(label, libs):
    """Block 0's cycles a tile by phase in the profiled builds ``libs``
    (K1's, K2's library and K2's source name). K1 counts block 0's tiles
    in counter 7."""
    fwd, bwd, bwd_name = libs
    res = {"version": label, "k2_source": bwd_name, "k1": {}}
    rng = np.random.default_rng(0)
    with bf16_matmul(False), torch.no_grad(), bound(fwd, bwd, bwd_name):
        for B, N in K1_SHAPES:
            a = random_case(rng, "cuda", 2, 1, 128, B, N, 2, 2)
            c = marks(reader(fwd, "pvt_sdec_fwd_phase_cycles"),
                      lambda: sd.fused_spatial_decoder_forward(**a))
            tiles = c[7]
            res["k1"][f"B={B} N={N}"] = {
                "cycles_per_tile": per_tile(c, K1_PHASES, tiles),
                "tiles_of_block0": tiles}
        a, g, _, _ = k2_inputs(200, 784, 2, 1)
        c = marks(reader(bwd, K2_ENTRIES[bwd_name] + "_phase_cycles"),
                  lambda: sd.fused_spatial_decoder_backward(**a, g=g))
        _, blocks = sd.bwd_workspace(200, 784, 2, 2, 128, 2, 1, bf16=False)
        tiles = -(-200 * -(-784 // 64) // blocks)  # block 0's, 64-pixel tiles
        res["k2"] = {"cycles_per_tile": per_tile(c, K2_PHASES[bwd_name],
                                                 tiles),
                     "tiles_of_block0": tiles, "blocks": blocks}
    return res


def times(versions):
    """Each version's unprofiled kernel times, ms. K1 per version; K2 (and
    K3) at each shape in turns over the versions, forward then backward
    (baseline, port, port, baseline): each version's two times."""
    res = {label: {"k1": {}, "k2": {}, "k3": {}} for label, *_ in versions}
    rng = np.random.default_rng(0)
    with bf16_matmul(False), torch.no_grad():
        for B, N in K1_SHAPES:
            a = random_case(rng, "cuda", 2, 1, 128, B, N, 2, 2)
            for label, fwd, bwd, name in versions:
                with bound(fwd, bwd, name):
                    res[label]["k1"][f"B={B} N={N}"] = round(cuda_ms(
                        lambda: sd.fused_spatial_decoder_forward(**a),
                        reps=20), 4)
        order = versions + versions[::-1]
        for i, (shape, B, N, L) in enumerate(K2_SHAPES):
            a, g, x, w = k2_inputs(B, N, L, 2 + i)
            big = B * N > 4_000_000
            for label, fwd, bwd, name in order:
                with bound(fwd, bwd, name):
                    ms = cuda_ms(
                        lambda: sd.fused_spatial_decoder_backward(**a, g=g),
                        reps=5 if big else 20)
                    res[label]["k2"].setdefault(shape, []).append(round(ms, 4))
                    if i < WITH_LIBRARY and not big:
                        ms3 = cuda_ms(
                            lambda: sd.fused_bernoulli_recon_loss_kernel(
                                **a, x=x, wgt=w), reps=20)
                        res[label]["k3"].setdefault(shape, []).append(
                            round(ms3, 4))
            torch.cuda.synchronize()
            del a, g, x, w
    library = {shape: round(cublas_ms(B, N, 8 if B * N > 4_000_000 else 1),
                            4) for shape, B, N, _ in K2_SHAPES[:WITH_LIBRARY]}
    return res, library


def sass(path):
    """{function: instructions} of ``path`` compiled to a cubin as the port
    builds it, the anonymous namespace's hash left out of the names."""
    cubin = os.path.join(_build.BUILD_DIR, "sass-" + hashlib.sha256(
        path.encode()).hexdigest()[:16] + ".cubin")
    cmd = [c for c in _build.nvcc_command(path, cubin)
           if c not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    subprocess.run(cmd + ["-cubin"], check=True, capture_output=True)
    dump = subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
         "-sass", cubin], check=True, capture_output=True, text=True).stdout
    out, cur = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "",
                         ln.split(":", 1)[1].strip())
            out[cur] = []
        elif cur is not None and ln.strip():
            out[cur].append(ln.strip())
    return out


def bf16_ab(base_dir):
    """The bf16 K2 of ``base_dir`` against the port's: the same machine
    code or not, the same grads or not, and K2's time at the flagship and
    the 512x512 tile, in turns (baseline, port, port, baseline)."""
    name = sd.BWD_SOURCES[True]
    path = os.path.join(base_dir, name + ".cu")
    old, new = sass(path), sass(os.path.join(_build.CSRC, name + ".cu"))
    same = sorted(old) == sorted(new) and all(old[k] == new[k] for k in old)
    libs = (("baseline", build(path)[0]), ("port", _build.load(name)))
    res = {"same_sass": same, "functions": len(old), "ms": {}}
    saved = dict(sd._bwd_fns)
    try:
        with bf16_matmul(True), torch.no_grad():
            for i, (shape, B, N, L) in enumerate(
                    (K2_SHAPES[0], K2_SHAPES[3])):
                a, g, _, _ = k2_inputs(B, N, L, 20 + i)
                grads = []
                for label, lib in libs:
                    sd._bwd_fns[True] = sd._bind_bwd(lib, sd.BWD_ENTRIES[True])
                    sd._bwd_plan.cache_clear()
                    grads.append(sd.fused_spatial_decoder_backward(**a, g=g))
                res[f"same_output {shape}"] = all(
                    torch.equal(x, y) for x, y in zip(*grads))
                for label, lib in libs + libs[::-1]:
                    sd._bwd_fns[True] = sd._bind_bwd(lib, sd.BWD_ENTRIES[True])
                    sd._bwd_plan.cache_clear()
                    res["ms"].setdefault(f"{shape} {label}", []).append(
                        round(cuda_ms(lambda: sd.fused_spatial_decoder_backward(
                            **a, g=g), reps=20), 4))
    finally:
        sd._bwd_fns.clear()
        sd._bwd_fns.update(saved)
        sd._bwd_plan.cache_clear()
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
    versions, profiled = [], []
    if args.baseline:
        bwd_name = next(n for n in ("spatial_decoder_bwd_x3",
                                    "spatial_decoder_bwd")
                        if os.path.exists(os.path.join(args.baseline,
                                                       n + ".cu")))
        paths = [os.path.join(args.baseline, n + ".cu")
                 for n in ("spatial_decoder_fwd", bwd_name)]
        base = [build(p)[0] for p in paths]
        base_prof = [build(p, DEFINES) for p in paths]
        for p, (_, log) in zip(paths, base_prof):
            print(f"ptxas baseline {os.path.basename(p)} (profiled): "
                  f"{usage(log)}", flush=True)
        versions.append(("baseline", base[0], base[1], bwd_name))
        profiled.append(("baseline", (base_prof[0][0], base_prof[1][0],
                                      bwd_name)))
    versions.append(("port", plain[0], plain[1], names[1]))
    profiled.append(("port", (prof[0], prof[1], names[1])))
    results = [phases(label, libs) for label, libs in profiled]
    ms, library = times(versions)
    for res in results:
        res["ms"] = ms[res["version"]]
        res["cublas_f32_ms"] = library
        res["card"] = smi
        print(json.dumps(res), flush=True)
    if args.baseline and os.path.exists(os.path.join(
            args.baseline, sd.BWD_SOURCES[True] + ".cu")):
        print(json.dumps({"bf16_k2": bf16_ab(args.baseline), "card": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
