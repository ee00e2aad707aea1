"""Profile the tensor-core K2/K3 (``csrc/spatial_decoder_bwd_tc.cu``) on the
card, and hold it against an earlier version of the same source.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_bwd_tc [--baseline DIR]

1. Builds the source as the port does and with ``PVT_PROFILE_PHASES`` (the
   phase marks of ``csrc/sm90_common.cuh``, one series per warpgroup),
   together, and prints each build's ptxas usage of the main kernels
   (registers, spills, and any note that ptxas serialised or fenced the
   wgmma pipeline) and counts of their SASS (calls, local-memory loads and
   stores, barriers, wgmma).
2. Per-warpgroup cycles a tile of block 0 by phase at the flagship (B=200,
   N=784, H=128, two tanh layers), at jiVAE's 2,000 enumerated rows and at
   H=256: each warpgroup's phases, and the part of them it spent waiting in
   a barrier, in a wgmma wait and issuing products (with streamed weights,
   their panel loads and waits too).
3. K2 and K3 times (CUDA events, medians of one call; K2 also back to
   back, 20 calls a chain, up to 4 M pixel rows) at the shapes of
   ``PERF.md`` section 6 (:data:`SHAPES`) and at H=256, in turns over the
   versions (baseline, port, port, baseline), so that two versions compare
   within one run and the repeats show the spread; each beside the bound
   (``measure.work_bwd``: tensor-core flops or bytes, whichever is larger)
   and cuBLAS's time for the bare bf16 products of the same hidden layers.
   The baseline's grads are held to the port's (bitwise or the largest
   difference over the largest entry).

``--baseline DIR`` adds an earlier version: ``DIR/spatial_decoder_bwd_tc.cu``
with the headers beside it, e.g. the parent commit's
``pyroved_tpu_torch/csrc`` unpacked under ``_checkout/`` (which
``.gitignore`` lists), built as the port builds it: its ptxas usage, SASS
counts and times (steps 1 and 3). Prints one JSON line at the end.
"""
import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import (bf16_matmul, bound_bwd, bounds, card_info, card_peaks,
                      cublas_ms, cuda_ms, cuda_ms_queued, finish_build,
                      k2_inputs, padded_case, per_tile, phase_cycles,
                      random_case, sass_counts, start_build, usage, work_bwd)

NAME = "spatial_decoder_bwd_tc"
ENTRY = "pvt_sdec_bwd_tc"
PROFILE = ("PVT_PROFILE_PHASES",)
#: What each mark closes, then the counters of sm90_common.cuh's
#: PHASE_TIMED slots.
PHASES = ("(loop)", "staging, h0", "first handoff and products",
          "forward, head dots", "head: logits, cotangents, loss",
          "last layer, first backward products",
          "hidden layers, last to first", "layer 0, tile sums, end",
          "in barriers", "in wgmma waits", "issuing products",
          "waiting on the cluster")
#: (name, B, N, L, H, hidden layers, hidden widths where padded to H):
#: PERF.md section 6's bf16 shapes, then H = 256 with two and five layers
#: and a (128, 256) decoder padded to 256.
SHAPES = (("flagship", 200, 784, 2, 128, 2, None),
          ("large grid", 64, 16384, 2, 128, 2, None),
          ("jiVAE B=2000", 2000, 784, 12, 128, 2, None),
          ("B=50", 50, 784, 2, 128, 2, None),
          ("top-3 B=600", 600, 784, 12, 128, 2, None),
          ("512x512 tile", 200, 16384, 2, 128, 2, None),
          ("pixel rank", 200, 131072, 2, 128, 2, None),
          ("H=256 flagship", 200, 784, 2, 256, 2, None),
          ("H=256 5 layers", 200, 784, 2, 256, 5, None),
          ("(128, 256) flagship", 200, 784, 2, 256, 2, (128, 256)))
MARK_SHAPES = (SHAPES[0], SHAPES[2], SHAPES[7], SHAPES[8])
BIG = 4_000_000  # B N above which timings take fewer calls


#: The fields of the plan that ``pvt_sdec_bwd_tc_plan`` reports, in order;
#: ``cluster`` is the blocks a cluster (1: none; an earlier library that
#: reports six fields reads 1).
PLAN_FIELDS = ("R", "resident", "smem", "passes", "per_pass", "n_tiles",
               "cluster")


def plan_info(lib, B, N, L, H, nl=2, C=1, D=2, act=0, loss_mode=0):
    """The plan (:data:`PLAN_FIELDS`) that the library ``lib``'s
    ``pvt_sdec_bwd_tc_plan`` reports for one call (``act`` an activation's
    code)."""
    info = (ctypes.c_int * len(PLAN_FIELDS))()
    info[-1] = 1
    plan, _ = sd._bind_bwd(lib, ENTRY)
    err = plan(B, N, D, L, H, nl, C, act, loss_mode, None, info)
    if err:
        raise RuntimeError(f"the bf16 K2/K3 plan failed: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, info))


# -- the H = 256 plan, as csrc/spatial_decoder_bwd_tc.cu works it out
#: Blocks a cluster, tile pixels and dW units a block of the H = 256 kernel.
CLUSTER, CLUSTER_R, PASS_UNITS = 4, 32, 4
H100_OPTIN = 232_448


def cluster_smem(nl, C, resident):
    """Shared memory of a block of the H = 256 cluster kernel
    (cl_smem_bytes): its two panels of every layer (resident) or one slot,
    the levels, its units' derivatives, then the small buffers and the 16
    transaction barriers (cl_small_floats, production build)."""
    H, R, U = 256, CLUSTER_R, 256 // CLUSTER
    stage = (4 * R + 1 + 3) // 4 * 4
    small = (6 * U + 4 * R + 2 * stage + 4 * R + R + 8 * R * C
             + 2 * CLUSTER * R * C + 6 * U + nl * H + H * C + C + 1
             + nl * H + H * C + 2 * 16 + 2)
    return ((nl * 2 * 128 * H if resident else 128 * H)
            + (nl + 1) * 2 * H * R + (nl + 1) * 4 * U * R + 4 * small)


def cluster_plan(B, N, nl, C, clusters, optin=H100_OPTIN):
    """The plan (:data:`PLAN_FIELDS`) of an H = 256 call when ``clusters``
    clusters fit on the card at once (the occupancy query's answer): R =
    32, the weights resident where they fit, 16 dW units (8 a layer) a
    pass, the clusters split over the passes."""
    resident = int(cluster_smem(nl, C, True) <= optin)
    passes = -(-nl * 8 // (PASS_UNITS * CLUSTER))
    n_tiles = -(-N // CLUSTER_R)
    fit = max(1, min(clusters // passes, B * n_tiles))
    return dict(zip(PLAN_FIELDS, (CLUSTER_R, resident,
                                  cluster_smem(nl, C, resident), passes,
                                  CLUSTER * fit, n_tiles, CLUSTER)))


def block0_tiles(B, info):
    """Tiles of block 0 (with a cluster, of its cluster): the pass's tile
    list dealt over its blocks (clusters) in turn."""
    return -(-B * info["n_tiles"] // (info["per_pass"] // info["cluster"]))


def shape_case(B, N, L, H, nl, hidden, seed):
    """K2's and K3's inputs at a shape of :data:`SHAPES`: ``k2_inputs``
    with ``nl`` layers, padded where ``hidden`` names the widths."""
    a, g, x, w = k2_inputs(B, N, L, seed, H)
    if nl != 2:
        a = random_case(np.random.default_rng(seed), "cuda", 2, 1, H, B, N,
                        L, nl)
    return (a if hidden is None else padded_case(a, hidden)), g, x, w


def marks(lib, a, g):
    """Block 0's cycles a tile by phase, per warpgroup, in one K2 call of
    the profiled build ``lib``."""
    B, N, L = a["z"].shape[0], a["grid"].shape[0], a["z"].shape[1]
    info = plan_info(lib, B, N, L, a["Wc"].shape[1], a["hw"].shape[0])
    with bound_bwd(lib, ENTRY, True), bf16_matmul(True):
        cycles = phase_cycles(lib, ENTRY + "_phase_cycles",
                              lambda: sd.fused_spatial_decoder_backward(
                                  **a, g=g))
    tiles = block0_tiles(B, info)
    res = {"tiles_of_block0": tiles, "plan": info}
    for w in range(2):
        res[f"warpgroup {w}"] = per_tile(cycles[w], PHASES, tiles)
    return res


def compare(got, ref):
    """'bitwise', or the largest difference over its grad's largest
    entry."""
    if all(torch.equal(x, y) for x, y in zip(got, ref)):
        return "bitwise"
    return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
               for x, y in zip(got, ref))


def times(versions, peaks):
    """Each version's K2 and K3 times at every shape, in turns; its grads
    against the port's; the bounds and cuBLAS's products."""
    res = {"k2": {}, "k2_chain": {}, "k3": {}, "same": {}, "bound": {},
           "cublas_bf16_ms": {}}
    order = versions + versions[::-1]
    with bf16_matmul(True), torch.no_grad():
        for i, (shape, B, N, L, H, nl, hidden) in enumerate(SHAPES):
            a, g, x, w = shape_case(B, N, L, H, nl, hidden, 30 + i)
            reps = 5 if B * N > BIG else 20
            k2 = lambda: sd.fused_spatial_decoder_backward(**a, g=g)  # noqa: E731
            k3 = lambda: sd.fused_bernoulli_recon_loss_kernel(  # noqa: E731
                **a, x=x, wgt=w)
            outs = {}
            for label, lib in versions:
                with bound_bwd(lib, ENTRY, True):
                    loss, grads = k3()
                    outs[label] = (k2(), (loss,) + tuple(grads))
            for label, (o2, o3) in outs.items():
                res["same"].setdefault(label, {})[shape] = {
                    "k2": compare(o2, outs["port"][0]),
                    "k3": compare(o3, outs["port"][1])}
            del outs
            for label, lib in order:
                with bound_bwd(lib, ENTRY, True):
                    res["k2"].setdefault(label, {}).setdefault(
                        shape, []).append(round(cuda_ms(k2, reps=reps), 4))
                    res["k3"].setdefault(label, {}).setdefault(
                        shape, []).append(round(cuda_ms(k3, reps=reps), 4))
                    if B * N <= BIG:  # back to back: the device's time
                        res["k2_chain"].setdefault(label, {}).setdefault(
                            shape, []).append(round(cuda_ms_queued(
                                k2, n=20, reps=5), 4))
            res["bound"][shape] = {
                k: [round(b[1], 4), b[3]] for k, b in (
                    ("k2", bounds(*work_bwd(a), peaks)),
                    ("k3", bounds(*work_bwd(a, loss_mode=True), peaks)))}
            res["cublas_bf16_ms"][shape] = round(cublas_ms(
                B, N, H, torch.bfloat16, 8 if B * N > BIG else 1, nl), 4)
            print(json.dumps({shape: {k: {v: res[k][v][shape] for v in res[k]
                                          if shape in res[k][v]}
                                      for k in ("k2", "k2_chain", "k3")},
                                  "same": {v: res["same"][v][shape]
                                           for v in res["same"]},
                                  "bound": res["bound"][shape],
                                  "cublas_bf16_ms":
                                      res["cublas_bf16_ms"][shape]}),
                  flush=True)
            del a, g, x, w
            torch.cuda.synchronize()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory holding an earlier "
                    "spatial_decoder_bwd_tc.cu and its headers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bwd_tc: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    print(card, flush=True)
    peaks = card_peaks(card)
    base = None
    if args.baseline:  # started first: the port's builds run beside them
        path = os.path.join(os.path.abspath(args.baseline), NAME + ".cu")
        base = start_build(path)
    builds = {"port": (), "port, profiled": PROFILE}
    port, prof = _build.load_targets([(NAME, d) for d in builds.values()])
    libs = {"port": port}
    report = {"card": card, "ptxas": {}, "marks": {}, "sass": {}}
    for label, defines in builds.items():
        report["ptxas"][label] = usage(_build.build_log(NAME, defines))
        report["sass"][label] = sass_counts(_build._target(NAME, defines)[1])
    if base:
        blib, blog = finish_build(*base)
        libs = {"baseline": blib, **libs}
        report["sass"]["baseline"] = sass_counts(base[1])
        report["ptxas"]["baseline"] = usage(blog)
    for label, lines in report["ptxas"].items():
        print(f"ptxas {label}: {json.dumps(lines)}", flush=True)
    for label, counts in report["sass"].items():
        print(f"sass {label}: {json.dumps(counts)}", flush=True)
    for shape, B, N, L, H, nl, hidden in MARK_SHAPES:
        a, g, _, _ = shape_case(B, N, L, H, nl, hidden, 1)
        report["marks"][shape] = marks(prof, a, g)
        print(f"marks {shape}: {json.dumps(report['marks'][shape])}",
              flush=True)
    report.update(times(list(libs.items()), peaks))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
