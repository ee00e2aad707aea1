"""How far the f32 K2/K3 (``csrc/spatial_decoder_bwd_x3.cu``) is from f64,
by the length of the additions made inside the tensor cores.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.x3_accuracy [--baseline DIR]

The kernel forms each f32 product as six bf16 limb products on wgmma, whose
f32 accumulators add inside the MMA in the MMA's own precision. It bounds
those chains of additions in two places, each a macro of the source:

* ``PVT_X3_HI_CHUNK``: the k16 steps of hi hi (the largest limb product
  of the forward's h W and the backward's dh) that share an accumulator
  before it is added into the product's in f32 on the CUDA cores; 0 chains
  hi hi into the same accumulator as the other five (H / 16 steps);
* ``PVT_X3_FLUSH_TILES``: the tiles whose dW products share the
  accumulators before they are added into the block's slot in f32.

First, the additions themselves: ``csrc/mma_probe.cu`` runs wgmma
m64n16k16 steps on bf16 values, whose products are exact in f32, so its
distance from the exact sums is the MMA's own: one step of random values
(the error in units of the largest product's 2^-23, its largest and mean,
the mean signed toward zero), one step of 1 and fifteen copies of 2^-t
(how much of the small terms survives, t = 16 .. 30), and eight steps
chained in one accumulator or each in its own, added in f32 on the CUDA
cores.

Then each build below is bound in place of the kernel and run on ``chip_smoke``
phase 2's f32 cases at H = 128 and 256 (every activation, K2 and K3) and
at a 512x512 tile (B = 200, N = 16,384; plain versions over 8 row chunks),
against the plain version in f64 and in f32 (cuBLAS, TF32 off): for each
case the largest ratio, over the grads, of the kernel's error over the
grad's largest entry to max(4 x the f32 plain version's, 1e-6), which
phase 2 holds at 1 or below (for a case over it, each grad's errors and,
for relu and lrelu, how many of the pixels kept lie within ten times
chip_smoke's kink band); then phase 2's one-pixel case (B = N = 1, four
channels, one layer) drawn from 64 seeds, the share of them over the
bound and the median ratio, and the share over it with the f32 plain
version's error the larger of its evaluations on the card and on the
host, as chip_smoke holds it (and, once, the share for the plain version
with the limb products done exactly); and K2's time at the flagship and
the tile.
``--baseline DIR`` runs the same on the first f32 K2/K3 in ``DIR``
(``spatial_decoder_bwd.cu``, entry ``pvt_sdec_bwd``: the sources of a
commit before the f32 K2/K3 moved onto the tensor cores). Prints one JSON line per build.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import bf16_matmul, cuda_ms, random_case

SOURCE = "spatial_decoder_bwd_x3"
PROBE = "mma_probe"
#: (label, defines): the source as the port builds it first.
BUILDS = (("default", ()),
          ("hi hi chained (HI_CHUNK=0)", ("PVT_X3_HI_CHUNK=0",)),
          ("HI_CHUNK=4", ("PVT_X3_HI_CHUNK=4",)),
          ("HI_CHUNK=2", ("PVT_X3_HI_CHUNK=2",)),
          ("one dW chain a block", ("PVT_X3_FLUSH_TILES=1000000",)))
#: (D, act, H, B, N, L, n_layers), one channel (K2 and K3)
CASES = tuple((D, act, H, 37, 1000, 3, 2) for H in (128, 256)
              for D in (1, 2) for act in sd.KERNEL_ACTS_WITH_APPROX)
TILE = (2, "tanh", 128, 200, 16384, 2, 2)
SEEDS = 64  # of the one-pixel case
CHUNKS = 8
DEVICE = "cuda"
FACTOR, FLOOR = 4.0, 1e-6
KINK_BAND = 1e-5


def rel_errs(got, ref):
    return [((g.double() - r.double()).abs().max()
             / r.double().abs().max().clamp_min(1e-300)).item()
            for g, r in zip(got, ref)]


def ratio(got, ref32, ref64):
    """The largest, over the grads, of the kernel's error to the bound."""
    return max(k / max(FACTOR * p, FLOOR)
               for k, p in zip(rel_errs(got, ref64), rel_errs(ref32, ref64)))


def chunked(fn, a, per_sample, chunks):
    """``fn(chunk of a, chunk of each per-sample tensor)`` over row chunks
    of the batch: losses and weight grads summed, per-sample grads
    joined."""
    B = a["z"].shape[0]
    step = B // chunks
    parts = []
    for i in range(0, B, step):
        c = {k: (v[i:i + step] if k in ("phi", "dx", "sc", "z") else v)
             for k, v in a.items()}
        parts.append(fn(c, *(t[i:i + step] for t in per_sample)))
    if isinstance(parts[0][0], torch.Tensor) and parts[0][0].dim() == 0:
        loss = sum(p[0] for p in parts)
        grads = [p[1] for p in parts]
    else:
        loss, grads = None, parts
    joined = tuple(torch.cat(p) if j < 4 else sum(p)
                   for j, p in enumerate(zip(*grads)))
    return joined if loss is None else (loss, joined)


def f64(a):
    return {k: v.double() for k, v in a.items()}


def near_kink(a, act, band=KINK_BAND):
    """Pixels with a hidden pre-activation within ``band`` of relu's or
    lrelu's kink (f64); chip_smoke leaves those within KINK_BAND out."""
    if act not in ("relu", "lrelu"):
        return None
    d = f64(a)
    hs, _, _ = sd._folded_forward(d["grid"], d["phi"], d["dx"], d["sc"],
                                  d["z"], d["Wc"], d["bc"], d["Wz"], d["hw"],
                                  d["hb"], act)
    near = torch.zeros(hs[0].shape[:2], dtype=torch.bool, device=DEVICE)
    for i in range(d["hw"].shape[0]):
        near |= ((hs[i] @ d["hw"][i] + d["hb"][i]).abs() < band).any(-1)
    return near


def inputs():
    """Each case's inputs, made once for every build."""
    rng = np.random.default_rng(2)
    out = []
    for D, act, H, B, N, L, nl in CASES + (TILE,):
        a = random_case(rng, DEVICE, D, 1, H, B, N, L, nl)
        g = torch.as_tensor(rng.normal(size=(B, N)), dtype=torch.float32,
                            device=DEVICE)
        x = torch.as_tensor(rng.uniform(0, 1, (B, N)), dtype=torch.float32,
                            device=DEVICE)
        w = torch.as_tensor(rng.uniform(0, 1, B), dtype=torch.float32,
                            device=DEVICE)
        near = near_kink(a, act)
        # pixels kept whose pre-activation is within 10 KINK_BAND of the kink
        close = (None if near is None else
                 int((near_kink(a, act, 10 * KINK_BAND) & ~near).sum()))
        if near is not None:
            g[near] = 0.0
            x[near] = sd.spatial_decoder_plain(**a, act=act)[near]
        chunks = CHUNKS if B * N > 1_000_000 else 1
        fn2 = lambda c, gg, act=act: sd.spatial_decoder_bwd_plain(  # noqa: E731
            **c, g=gg, act=act)
        fn3 = lambda c, xx, ww, act=act: sd.recon_loss_plain(  # noqa: E731
            c["grid"], c["phi"], c["dx"], c["sc"], c["z"], xx, ww, c["Wc"],
            c["bc"], c["Wz"], c["hw"], c["hb"], c["wout"], c["bout"], act)
        refs = {"K2": (chunked(fn2, a, (g,), chunks),
                       chunked(fn2, f64(a), (g.double(),), chunks)),
                "K3": (chunked(fn3, a, (x, w), chunks)[1],
                       chunked(fn3, f64(a), (x.double(), w.double()),
                               chunks)[1])}
        out.append((f"D={D} act={act} H={H} B={B} N={N}", act, a, g, x, w,
                    refs, close))
    return out


def one_pixel_inputs():
    """Phase 2's one-pixel K2 case from SEEDS seeds, with its plain
    versions in f32 and f64, the f32 one also on the host."""
    out = []
    for seed in range(SEEDS):
        rng = np.random.default_rng(100 + seed)
        a = random_case(rng, DEVICE, 2, 4, 128, 1, 1, 1, 1)
        g = torch.as_tensor(rng.normal(size=(1, 1, 4)), dtype=torch.float32,
                            device=DEVICE)
        host = sd.spatial_decoder_bwd_plain(
            **{k: v.cpu() for k, v in a.items()}, g=g.cpu())
        out.append((a, g, (sd.spatial_decoder_bwd_plain(**a, g=g),
                           sd.spatial_decoder_bwd_plain(**f64(a),
                                                        g=g.double())),
                    tuple(t.to(DEVICE) for t in host)))
    return out


def one_pixel_limbs(one_pixel):
    """The one-pixel sweep for the plain version with the limb products
    done exactly (``limb_matmul``, summed by cuBLAS): how often the limb
    arithmetic alone, with no tensor core, is over the bound."""
    saved = sd._mm
    sd._mm = lambda a, b, bf16=None: sd.limb_matmul(a, b)
    try:
        r = [ratio(sd.spatial_decoder_bwd_plain(**a, g=g), *refs)
             for a, g, refs, _ in one_pixel]
    finally:
        sd._mm = saved
    return {"share_over_bound": sum(x > 1.0 for x in r) / len(r),
            "median": round(float(np.median(r)), 3)}


def measure(cases, one_pixel):
    """Each case's ratio under the kernel bound now, K2 and K3; the
    one-pixel case's over its seeds; K2's time at the flagship and at the
    tile."""
    ratios, over = {}, {}
    for label, act, a, g, x, w, refs, close in cases:
        got = {"K2": sd.fused_spatial_decoder_backward(**a, g=g, act=act),
               "K3": sd.fused_bernoulli_recon_loss_kernel(
                   **a, x=x, wgt=w, act=act)[1]}
        ratios[label] = {k: round(ratio(v, *refs[k]), 3)
                         for k, v in got.items()}
        for k, r in ratios[label].items():
            if r > 1.0:  # each grad's errors, and the pixels near a kink
                over[f"{label} {k}"] = {
                    "kernel": [float(f"{e:.2e}") for e in
                               rel_errs(got[k], refs[k][1])],
                    "plain": [float(f"{e:.2e}") for e in
                              rel_errs(refs[k][0], refs[k][1])],
                    "pixels_within_10_kink_bands": close}
    pixel, both = [], []
    for a, g, refs, host in one_pixel:
        got = sd.fused_spatial_decoder_backward(**a, g=g)
        pixel.append(ratio(got, *refs))
        both.append(max(k / max(FACTOR * max(p, q), FLOOR) for k, p, q in zip(
            rel_errs(got, refs[1]), rel_errs(refs[0], refs[1]),
            rel_errs(host, refs[1]))))
    ratios["one pixel, 64 seeds"] = {
        "share_over_bound": sum(r > 1.0 for r in pixel) / len(pixel),
        "median": round(float(np.median(pixel)), 3),
        "max": round(max(pixel), 3),
        "share_over_bound_card_or_host": sum(r > 1.0 for r in both) / len(both)}
    flag = random_case(np.random.default_rng(0), DEVICE, 2, 1, 128, 200, 784,
                       2, 2)
    gf = torch.randn(200, 784, device=DEVICE)
    tile, gt = cases[-1][2], cases[-1][3]
    ms = {"flagship": round(cuda_ms(lambda: sd.fused_spatial_decoder_backward(
              **flag, g=gf), reps=20), 4),
          "512x512 tile": round(cuda_ms(
              lambda: sd.fused_spatial_decoder_backward(**tile, g=gt),
              reps=10), 4)}
    return ratios, over, ms


def probe():
    """The MMA's additions against exact sums (``csrc/mma_probe.cu``)."""
    fn = _build.load(PROBE).pvt_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(A, B, fresh):
        a = A.to(torch.bfloat16).contiguous()
        b = B.to(torch.bfloat16).contiguous()
        d = torch.empty(64, 16, device=DEVICE)
        err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), A.shape[1] // 16,
                 int(fresh), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"mma probe launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        return d.double(), a.double() @ b.double().T, a.double(), b.double()

    def in_ulps(d, exact, a, b):
        """Errors in units of 2^-23 of each dot's largest product, and
        signed toward zero (negative: the sum shrank)."""
        big = (a[:, None, :] * b[None, :, :]).abs().amax(-1)
        unit = torch.exp2(torch.floor(torch.log2(big)) - 23)
        e = (d - exact) / unit
        return {"max_ulps": round(e.abs().max().item(), 3),
                "mean_ulps_toward_zero": round(
                    (e * torch.sign(exact)).mean().item(), 3)}

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    A = torch.randn(64, 16, generator=gen, device=DEVICE)
    B = torch.randn(16, 16, generator=gen, device=DEVICE)
    out["one step, random"] = in_ulps(*run(A, B, False))
    A = torch.randn(64, 16, generator=gen, device=DEVICE).abs()
    B = torch.randn(16, 16, generator=gen, device=DEVICE).abs()
    out["one step, random, all positive"] = in_ulps(*run(A, B, False))
    kept = {}
    for t in range(16, 31):
        A = torch.full((64, 16), 2.0 ** -t, device=DEVICE)
        A[:, 0] = 1.0
        d, exact, _, _ = run(A, torch.ones(16, 16, device=DEVICE), False)
        kept[t] = round(((d - 1.0) / (exact - 1.0)).mean().item(), 4)
    out["share of 15 x 2^-t kept beside 1"] = kept
    A = torch.randn(64, 128, generator=gen, device=DEVICE)
    B = torch.randn(16, 128, generator=gen, device=DEVICE)
    for fresh in (False, True):
        d, exact, a, b = run(A, B, fresh)
        scale = (a[:, None, :] * b[None, :, :]).abs().sum(-1)
        out[f"8 steps, {'fresh' if fresh else 'chained'}"] = {
            "max_err_over_sum_abs": float(f"{((d - exact).abs() / scale).max().item():.3e}"),
            "mean_err_toward_zero_over_sum_abs": float(
                f"{((d - exact) * torch.sign(exact) / scale).mean().item():.3e}")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory holding the first f32 "
                    "K2/K3, spatial_decoder_bwd.cu, run as one more build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("x3_accuracy: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"mma_probe": probe(), "card": smi}), flush=True)
    libs = [(label, lib, sd.BWD_ENTRIES[False]) for (label, _), lib in zip(
        BUILDS, _build.load_targets([(SOURCE, d) for _, d in BUILDS]))]
    if args.baseline:
        from .profile_f32 import build
        libs.append(("first f32 kernel (baseline)", build(os.path.join(
            args.baseline, "spatial_decoder_bwd.cu"))[0], "pvt_sdec_bwd"))
    with bf16_matmul(False), torch.no_grad():
        cases, one_pixel = inputs(), one_pixel_inputs()
        print(json.dumps({"one pixel, 64 seeds, plain with exact limb "
                          "products": one_pixel_limbs(one_pixel),
                          "card": smi}), flush=True)
        saved = dict(sd._bwd_fns)
        try:
            for label, lib, entry in libs:
                sd._bwd_fns[False] = sd._bind_bwd(lib, entry)
                sd._bwd_plan.cache_clear()
                ratios, over, ms = measure(cases, one_pixel)
                per_case = [v for k, r in ratios.items() if k in
                            {c[0] for c in cases} for v in r.values()]
                worst = max(per_case)
                failing = sum(v > 1.0 for v in per_case)
                print(json.dumps({"build": label, "card": smi,
                                  "worst_ratio": worst,
                                  "cases_over_bound": failing,
                                  "k2_ms": ms, "ratios": ratios,
                                  "over_bound": over}),
                      flush=True)
        finally:
            sd._bwd_fns.clear()
            sd._bwd_fns.update(saved)
            sd._bwd_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
