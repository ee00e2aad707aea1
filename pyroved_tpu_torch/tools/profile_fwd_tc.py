"""Profile the tensor-core K1 (``csrc/spatial_decoder_fwd_tc.cu``) on the
card, and hold it against an earlier version of the same source.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_fwd_tc [--baseline DIR]
        [--same]

1. Builds the source as the port does and with ``PVT_PROFILE_PHASES`` (the
   phase marks of ``csrc/sm90_common.cuh``, one series per warpgroup), and
   the baseline, all together; prints each build's ptxas usage of the main
   kernels (registers, spills, wgmma notes) and counts of their SASS (MUFU
   and FFMA among them).
2. Per-warpgroup cycles a tile of block 0 by phase at :data:`MARK_SHAPES`.
3. K1 at :data:`SHAPES` (``PERF.md`` section 6's nine and H = 256) in
   turns over the versions (baseline, port, port, baseline): one call and
   20 back to back (CUDA events, medians); each version's outputs against
   the plain version (phase 2's bf16 bound) and a second launch (bitwise),
   and against each other; beside the SFU floor (:func:`measure.sfu_floor_ms`),
   the tensor-core bound and cuBLAS's bf16 products of the same layers.
4. Each version's wrapper: host time a call (a one-tile decode, calls
   queued without a synchronise), and the bare C entry's.

``--baseline DIR`` adds an earlier version: ``DIR/spatial_decoder_fwd_tc.cu``
with the headers beside it, e.g. the parent commit's ``pyroved_tpu_torch``
unpacked under ``_checkout/`` (which ``.gitignore`` lists) with ``DIR`` its
``csrc``, built as the port builds it. Where ``DIR/../ops/spatial_decoder.py``
exists the baseline runs through that wrapper (its host work included),
else through the port's. ``--same`` compiles every production build
(both K2/K3 sources, their K4 builds, both K1 sources) from ``DIR`` and
from the port and prints whether each has the same machine code, the bf16
K1 and K2/K3 without their H = 256 functions (:data:`H256_FUNCTIONS`),
with its SASS counts and, where a function differs, its first differing
lines; the tool then exits 1. Prints one JSON line at the end.
"""
import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import bwd_ablation as ab
from ..ops import spatial_decoder as sd
from .measure import (bf16_matmul, bound_fwd, bounds, card_info, card_peaks,
                      cublas_fwd_ms, cuda_ms, cuda_ms_queued, finish_build,
                      padded_case, per_tile, phase_cycles, random_case,
                      row_chunks,
                      same_machine_code, sass_counts, sfu_floor_ms,
                      start_build, usage, work_fwd)

NAME = "spatial_decoder_fwd_tc"
PROFILE = ("PVT_PROFILE_PHASES",)
#: What each mark of the profiled source closes, in mark order, then the
#: PHASE_TIMED counter of the cluster barriers' waits (H = 256; the H = 128
#: kernel times none).
PHASES = ("(loop)", "per-sample transform, coordinates (H = 256: and the "
          "level-0 barrier)", "h0",
          "products", "layer epilogues (C = 1: with the head's dots; "
          "H = 256: and the level barriers)",
          "head: dots (C > 1), folds, partials (H = 256: and the head "
          "barrier)", "logits out", "(no mark 7)", "in barriers",
          "in wgmma waits", "issuing products", "waiting on the cluster")
#: (name, B, N, L, H, hidden layers, hidden widths where padded to H):
#: PERF.md section 6's nine K1 shapes (two tanh layers, one channel), then
#: H = 256 at the flagship's training shape with two and five layers, and
#: a (128, 256) decoder padded to 256.
SHAPES = (("B=1024", 1024, 784, 2, 128, 2, None),
          ("B=200", 200, 784, 2, 128, 2, None),
          ("B=452", 452, 784, 2, 128, 2, None),
          ("large grid", 64, 16384, 2, 128, 2, None),
          ("2,000 rows", 2000, 784, 12, 128, 2, None),
          ("B=50", 50, 784, 2, 128, 2, None),
          ("600 rows", 600, 784, 12, 128, 2, None),
          ("512x512 tile", 200, 16384, 2, 128, 2, None),
          ("pixel rank", 200, 131072, 2, 128, 2, None),
          ("H=256 B=200", 200, 784, 2, 256, 2, None),
          ("H=256 B=200 5 layers", 200, 784, 2, 256, 5, None),
          ("(128, 256) B=200", 200, 784, 2, 256, 2, (128, 256)))
MARK_SHAPES = (SHAPES[0], SHAPES[1], SHAPES[9], SHAPES[10])
BIG = 4_000_000  # B N above which the plain version runs in 8 row chunks
# K1 against its plain version in bf16: chip_smoke.py's bound
# (BF16_ATOL + BF16_OUT_REL of the largest output; why there).
ATOL, OUT_REL = 3e-3, 2e-3


#: Shared memory a block of an H100 can opt into, bytes
#: (cudaDevAttrMaxSharedMemoryPerBlockOptin).
H100_OPTIN = 232_448
K1_MAX_C = 4


def warpgroups(H):
    """Warpgroups a block of the tensor-core K1 holds at two layers and
    one channel: four at H = 128; two at H = 256, a cluster's block, both
    on the cluster's tile."""
    return 4 if H == 128 else 2


def warpgroup_tiles(B, N, H, g, sms):
    """Tiles of block 0's warpgroup g at H = 128: the kernel's split of the
    flat tile list [g T / W, (g + 1) T / W) over W warpgroups, one block an
    SM."""
    wgs = warpgroups(H)
    total = B * -(-N // 64)
    w = min(-(-total // wgs), sms) * wgs
    return (g + 1) * total // w - g * total // w


# -- the H = 256 plan, as csrc/spatial_decoder_fwd_tc.cu works it out

def smem_128(nl, C, wgs):
    """Shared memory of a block of the H = 128 kernel (smem_bytes): every
    layer's bf16 weights, then a level, u, v, w, coordinates and head
    partials a warpgroup, biases and head weights once."""
    H, R = 128, 64
    return (nl * 2 * H * H + wgs * 2 * H * R
            + 4 * (nl * H + H * C + K1_MAX_C + wgs * (3 * H + 2 * R + 4 * R * C)))


def cluster_tile(cs):
    """Pixels of a tile of the H = 256 cluster kernel with ``cs`` blocks a
    cluster."""
    return 64 if cs == 2 else 32


def cluster_smem(cs, nl, C):
    """Shared memory of a block of the H = 256 cluster kernel
    (cluster_smem_bytes): its columns of every layer's bf16 weights, two
    levels, then biases, head weights, u, v, w, coordinates, head
    partials (per warp, and every block's, two slots) and four
    transaction barriers."""
    U, R = 256 // cs, cluster_tile(cs)
    floats = (nl * U + U * C + K1_MAX_C + 3 * U + 2 * R + 8 * R * C
              + 2 * cs * R * C + 8)
    return nl * 512 * U + 1024 * R + 4 * floats


def cluster_blocks(nl, C, optin=H100_OPTIN):
    """Blocks a cluster of the H = 256 K1: 2 where the weights of ``nl``
    layers fit, else 4, else 0 (no plan)."""
    for cs in (2, 4):
        if cluster_smem(cs, nl, C) <= optin:
            return cs
    return 0


def max_layers(H, C, optin=H100_OPTIN):
    """``pvt_sdec_fwd_tc_max_layers``: the most hidden layers K1 takes at
    width H with C channels."""
    nl = -1
    if H == 128:
        while smem_128(nl + 1, C, 1) <= optin:
            nl += 1
    else:
        while cluster_blocks(nl + 1, C, optin):
            nl += 1
    return nl


def cluster_plan(lib, nl, C, act=0):
    """The H = 256 plan that the library ``lib`` reports for one call on
    the current device (``pvt_sdec_fwd_tc_cluster_plan``): blocks a
    cluster, the tile's pixels, shared memory a block, and the clusters
    that fit on the card at once."""
    f = lib.pvt_sdec_fwd_tc_cluster_plan
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = f(nl, C, act, out)
    if err:
        raise RuntimeError(f"the H=256 K1 plan failed: CUDA error {err}")
    return dict(zip(("cluster", "R", "smem", "clusters"), out))


def cluster_tiles(B, N, cs, clusters):
    """Tiles of cluster 0 (each of its blocks and warpgroups runs them
    all): the first of min(clusters, tiles) contiguous runs of the flat
    tile list, [0, T / n)."""
    total = B * -(-N // cluster_tile(cs))
    return total // min(clusters, total)


def marks(lib, a):
    """Block 0's cycles a tile by phase, per warpgroup, in one K1 call of
    the profiled build ``lib``."""
    B, N, H = a["z"].shape[0], a["grid"].shape[0], a["Wc"].shape[1]
    nl, C = a["hw"].shape[0], a["wout"].shape[1]
    with bound_fwd(lib, True), bf16_matmul(True):
        cycles = phase_cycles(lib, "pvt_sdec_fwd_tc_phase_cycles",
                              lambda: sd.fused_spatial_decoder_forward(**a))
    if H == 256:
        plan = cluster_plan(lib, nl, C)
        tiles = [cluster_tiles(B, N, plan["cluster"], plan["clusters"])] * 2
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = [warpgroup_tiles(B, N, H, g, sms) for g in range(4)]
    return {f"warpgroup {g}": per_tile(cycles[g], PHASES, n)
            for g, n in enumerate(tiles)}


def baseline_module(csrc):
    """The K1 wrapper beside ``csrc`` (``csrc/../ops/spatial_decoder.py``),
    loaded inside the port's package so that its relative imports resolve
    to the port's modules, or None where there is none."""
    path = os.path.join(csrc, os.pardir, "ops", "spatial_decoder.py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location(
        "pyroved_tpu_torch.ops._baseline_spatial_decoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def bound(mod, lib):
    """``lib`` bound as the bf16 K1 of the wrapper module ``mod``."""
    saved = dict(mod._fwd_fns)
    mod._fwd_fns[True] = mod._bind_fwd(lib, True)
    try:
        yield mod.fused_spatial_decoder_forward
    finally:
        mod._fwd_fns.clear()
        mod._fwd_fns.update(saved)


def shape_case(rng, B, N, L, H, nl, hidden):
    """A shape's random inputs (2-D, one channel), padded where ``hidden``
    names the decoder's widths."""
    a = random_case(rng, "cuda", 2, 1, H, B, N, L, nl)
    return a if hidden is None else padded_case(a, hidden)


def plain(a, chunks):
    """K1's plain version (bf16 products) over ``chunks`` row chunks."""
    return torch.cat([sd.spatial_decoder_plain(**c, bf16=True)
                      for c in row_chunks(a, chunks)])


def compare(got, ref):
    """'bitwise', or the largest absolute difference."""
    return ("bitwise" if torch.equal(got, ref)
            else (got - ref).abs().max().item())


def times(versions, peaks):
    """Each version's K1 times at every shape in turns; its outputs against
    the plain version, a second launch and the port's; the floors, bounds
    and cuBLAS's products."""
    res = {"one_call": {}, "back_to_back": {}, "vs_plain": {},
           "vs_port": {}, "sfu_floor_ms": {}, "bound": {}, "cublas_bf16_ms": {}}
    order = versions + versions[::-1]
    rng = np.random.default_rng(0)
    with bf16_matmul(True), torch.no_grad():
        for shape, B, N, L, H, nl, hidden in SHAPES:
            a = shape_case(rng, B, N, L, H, nl, hidden)
            big = B * N > BIG
            ref = plain(a, 8 if big else 1)
            outs = {}
            for label, mod, lib in versions:
                with bound(mod, lib) as k1:
                    out, again = k1(**a), k1(**a)
                if not torch.equal(out, again):
                    raise AssertionError(f"{label} {shape}: two launches "
                                         f"differ")
                err = (out - ref).abs().max().item()
                if err > ATOL + OUT_REL * ref.abs().max().item():
                    raise AssertionError(f"{label} {shape}: {err:.3e} from "
                                         f"the plain version")
                res["vs_plain"].setdefault(label, {})[shape] = err
                outs[label] = out
            for label in outs:
                res["vs_port"].setdefault(label, {})[shape] = compare(
                    outs[label], outs["port"])
            del outs, ref, out, again
            for label, mod, lib in order:
                with bound(mod, lib) as k1:
                    fn = lambda: k1(**a)  # noqa: E731
                    res["one_call"].setdefault(label, {}).setdefault(
                        shape, []).append(round(cuda_ms(
                            fn, reps=5 if big else 25), 4))
                    res["back_to_back"].setdefault(label, {}).setdefault(
                        shape, []).append(round(cuda_ms_queued(fn), 4))
            res["sfu_floor_ms"][shape] = round(sfu_floor_ms(B, N, H, nl), 4)
            b = bounds(*work_fwd(a), peaks)
            res["bound"][shape] = [round(b[1], 4), b[3]]
            res["cublas_bf16_ms"][shape] = round(cublas_fwd_ms(
                B, N, H, nl, torch.bfloat16, 8 if big else 1), 4)
            print(json.dumps({shape: {k: {v: res[k][v][shape]
                                          for v in res[k]}
                                      for k in ("one_call", "back_to_back",
                                                "vs_plain", "vs_port")} | {
                k: res[k][shape] for k in ("sfu_floor_ms", "bound",
                                           "cublas_bf16_ms")}}), flush=True)
            del a
            torch.cuda.synchronize()
    return res


def host_us(fn, n=2000):
    """Host microseconds a call of ``fn``, ``n`` calls queued without a
    synchronise (the device keeps up at a one-tile decode)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return round(us, 3)


def host_times(versions):
    """Each version's wrapper host time a call at B = 1, N = 64 (one tile),
    and the bare C entry's (pointers and stream read once)."""
    a = random_case(np.random.default_rng(1), "cuda", 2, 1, 128, 1, 64, 2, 2)
    out = torch.empty(1, 64, device="cuda")
    ptrs = [a[k].data_ptr() for k in ("grid", "phi", "dx", "sc", "z", "Wc",
                                      "bc", "Wz", "hw", "hb", "wout", "bout")]
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    with bf16_matmul(True), torch.no_grad():
        for label, mod, lib in versions:
            with bound(mod, lib) as k1:
                res[f"{label} wrapper"] = host_us(lambda: k1(**a))
            entry = sd._bind_fwd(lib, True)
            res[f"{label} C entry"] = host_us(lambda: entry(
                *ptrs, out.data_ptr(), 1, 64, 2, 2, 128, 2, 1, 0, 1, 1,
                stream))
    return res


def changed(same):
    """The builds of a :func:`measure.same_machine_code` result whose
    machine code differs from the baseline's."""
    return [b for b, r in same.items() if not r["same"]]


def other_builds():
    """Every other production build: both K2/K3 sources, their K4 builds
    and the f32 K1, as ``(name, defines)``."""
    return ([(n, ()) for n in (*sd.BWD_SOURCES.values(), sd.FWD_SOURCES[False])]
            + [(n, ab.defines(m)) for n in sd.BWD_SOURCES.values()
               for m in ab.MODES])


#: The functions of the bf16 K1 and K2/K3 production builds that run at
#: H = 256 (the cluster kernels, their weight reduction, the instances of
#: width 256): ``--same`` holds every other function of those two builds
#: to the baseline's machine code.
H256_FUNCTIONS = r"_cluster_kernel|sdec_tc_weights_cl|ILi256E"


def same_builds():
    """What ``--same`` compares, as ``(builds, skip)`` for
    :func:`measure.same_machine_code`: every production build, the bf16 K1
    and K2/K3 without their H = 256 functions (:data:`H256_FUNCTIONS`)."""
    edited = [(sd.FWD_SOURCES[True], ()), (sd.BWD_SOURCES[True], ())]
    return (edited[:1] + other_builds(),
            {build: H256_FUNCTIONS for build in edited})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory holding an earlier "
                    "spatial_decoder_fwd_tc.cu and its headers")
    ap.add_argument("--same", action="store_true", help="compare every "
                    "production build's machine code (H = 256 functions "
                    "of the bf16 sources left out) with the baseline's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fwd_tc: CUDA is not available", file=sys.stderr)
        return 1
    if args.same and not args.baseline:
        ap.error("--same needs --baseline")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    print(card, flush=True)
    peaks = card_peaks(card)
    base = None
    if args.baseline:  # started first: the port's builds run beside it
        csrc = os.path.abspath(args.baseline)
        base = start_build(os.path.join(csrc, NAME + ".cu"))
    builds = {"port": (), "port, profiled": PROFILE}
    libs = dict(zip(builds, _build.load_targets(
        [(NAME, d) for d in builds.values()])))
    report = {"card": card, "ptxas": {}, "sass": {}, "marks": {}}
    for label, defines in builds.items():
        report["ptxas"][label] = usage(_build.build_log(NAME, defines))
        report["sass"][label] = sass_counts(_build._target(NAME, defines)[1])
    versions = [("port", sd, libs["port"])]
    if base:
        blib, blog = finish_build(*base)
        report["ptxas"]["baseline"] = usage(blog)
        report["sass"]["baseline"] = sass_counts(base[1])
        versions.insert(0, ("baseline", baseline_module(csrc) or sd, blib))
    for label, lines in report["ptxas"].items():
        print(f"ptxas {label}: {json.dumps(lines)}", flush=True)
    for label, counts in report["sass"].items():
        print(f"sass {label}: {json.dumps(counts)}", flush=True)
    rng = np.random.default_rng(1)
    for shape, B, N, L, H, nl, hidden in MARK_SHAPES:
        report["marks"][shape] = marks(libs["port, profiled"], shape_case(
            rng, B, N, L, H, nl, hidden))
        print(f"marks {shape}: {json.dumps(report['marks'][shape])}",
              flush=True)
    report.update(times(versions, peaks))
    report["host_us"] = host_times(versions)
    print(f"host us a call: {json.dumps(report['host_us'])}", flush=True)
    if args.same:
        report["same"] = same_machine_code(args.baseline, *same_builds())
        print(f"same machine code: {json.dumps(report['same'])}", flush=True)
    print(json.dumps(report), flush=True)
    differ = changed(report.get("same", {}))
    if differ:
        print(f"profile_fwd_tc: the machine code of {differ} differs from "
              f"the baseline's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
