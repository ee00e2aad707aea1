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
repeats show the spread. Prints one JSON line per version at the end (the
bf16 K2/K3's A/B is ``tools/profile_bwd_tc.py``'s).
"""
import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import (bf16_matmul, bound_bwd, bound_fwd, build, card_info,
                      cublas_ms, cuda_ms, k2_inputs, per_tile, phase_cycles,
                      random_case, usage)

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


#: The main kernels of the two f32 sources, for ptxas's report.
KERNELS = r"sdec_(?:fwd|bwd_x3|bwd)_kernel"


@contextlib.contextmanager
def bound(fwd_lib, bwd_lib, bwd_name):
    """The two libraries bound as the f32 K1 and K2/K3 inside the block
    (``bwd_name`` the K2/K3 source's file name)."""
    with bound_fwd(fwd_lib, False), bound_bwd(bwd_lib, K2_ENTRIES[bwd_name],
                                              False):
        yield


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
            c = phase_cycles(fwd, "pvt_sdec_fwd_phase_cycles",
                             lambda: sd.fused_spatial_decoder_forward(**a))[0]
            tiles = c[7]
            res["k1"][f"B={B} N={N}"] = {
                "cycles_per_tile": per_tile(c, K1_PHASES, tiles),
                "tiles_of_block0": tiles}
        a, g, _, _ = k2_inputs(200, 784, 2, 1)
        c = phase_cycles(bwd, K2_ENTRIES[bwd_name] + "_phase_cycles",
                         lambda: sd.fused_spatial_decoder_backward(**a, g=g))[0]
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
    library = {shape: round(cublas_ms(B, N, chunks=8 if B * N > 4_000_000
                                      else 1), 4)
               for shape, B, N, _ in K2_SHAPES[:WITH_LIBRARY]}
    return res, library


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory of earlier f32 sources "
                    "with phase marks, profiled beside the port's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_f32: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_info()
    print(smi, flush=True)
    names = [sd.FWD_SOURCES[False], sd.BWD_SOURCES[False]]
    plain = _build.load_all(names)
    prof = _build.load_all(names, DEFINES)
    for n in names:
        print(f"ptxas {n} (profiled): "
              f"{usage(_build.build_log(n, DEFINES), KERNELS)}", flush=True)
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
                  f"{usage(log, KERNELS)}", flush=True)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
