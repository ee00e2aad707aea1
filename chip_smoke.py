"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 chip_smoke.py

Phases, in order (any failure propagates and exits non-zero):

1. Device and build: prints the card's name and power limit
   (``nvidia-smi``), then builds the decoder kernel from
   ``pyroved_tpu_torch/csrc`` with nvcc and prints the build time and the
   ptxas report.
2. Kernel against plain: the fused spatial-decoder kernel against
   ``spatial_decoder_plain`` on the card, over D in {1, 2}, C in {1, 3},
   the six activations, hidden width 128 and 256, ragged B and N, and a
   few edge shapes (one pixel, one partial tile, 1 or 3 hidden layers);
   then a model whose decoder widths (96, 160) pad to 256, served through
   the kernel and held against its sDecoderNet module.
3. Serving at full width: the flagship iVAE (28x28, latent 2, rotation,
   hidden 128x128, tanh, Bernoulli) from seed 0 is exported and served;
   it answers encode, reconstruct, posed decode, manifold2d, a ragged
   request and ELBO scoring, each checked against a plain computation.
4. Large grid: a posed decode of 64 latents on the 128x128 model.
5. Times: the kernel and the plain version at each kernel shape of
   phases 3 and 4 (median of CUDA-event timings), beside the least time
   the card could take for the same work; each request's latency and the
   host time of building the padded decoder weights against reusing them
   (host clock, medians).

Float32 throughout, with TF32 turned off for the plain version's matrix
products and convolutions, so both sides compute in full f32.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, without CUDA.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pyroved_tpu_torch.models import iVAE
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.serving import ServedModel, export_model
from pyroved_tpu_torch.utils.coord import generate_latent_grid

KERNEL = sd.fused_spatial_decoder_forward
# Kernel vs plain, both f32 on the card: the sums run in another order
# (cuBLAS against the kernel's per-thread fma chains) and tanhf/erff differ
# from PyTorch's by a few ulp per layer.
ATOL = 1e-4
# Per-example negative ELBO sums ~800 pixel terms of size ~1: relative.
LOSS_RTOL = 1e-4

# Data-sheet peaks (dense) of the H100 SXM5, the part nvidia-smi names
# "NVIDIA H100 80GB HBM3": f32 on the CUDA cores, bf16 on the tensor cores,
# HBM bandwidth. Other cards have no row: their bounds would be wrong.
H100_SXM = "H100 80GB HBM3"
PEAKS = (67e12, 989e12, 3.35e12)  # (f32 flop/s, bf16 flop/s, bytes/s)


def log(*a):
    print(*a, flush=True)


def card_peaks(name):
    if H100_SXM not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}")
    return PEAKS


def blobs(n, dim, seed):
    """MNIST-like oriented Gaussian bumps (bench.py's data)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, dim[0]),
                         np.linspace(-1, 1, dim[1]), indexing="ij")
    cx = rng.uniform(-0.4, 0.4, n)[:, None, None]
    cy = rng.uniform(-0.4, 0.4, n)[:, None, None]
    s = rng.uniform(0.05, 0.2, n)[:, None, None]
    return np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / s).astype(np.float32)


def kernel_args(decoder, grid, z, angle=0.0, shift=(0.0, 0.0), scale=1.0):
    """The kernel's inputs for a posed decode of ``z`` (as posed_decode)."""
    B, dev = z.shape[0], z.device
    D = grid.shape[-1]
    Wc, bc, Wz, hw, hb, wout, bout = sd.padded_sdecoder_weights(decoder)
    return dict(grid=grid, phi=torch.full((B,), float(angle), device=dev),
                dx=torch.as_tensor(shift, dtype=torch.float32,
                                   device=dev).expand(B, D).contiguous(),
                sc=torch.full((B,), float(scale), device=dev),
                z=z.contiguous(), Wc=Wc, bc=bc, Wz=Wz, hw=hw, hb=hb,
                wout=wout, bout=bout)


def check_close(what, got, ref, atol=ATOL):
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - ref).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {atol:.0e}")
    return err


def work(a):
    """(flops, bytes) one call needs: every input read once, the output
    written once."""
    N, D = a["grid"].shape
    B = a["z"].shape[0]
    H = a["Wc"].shape[1]
    nl = a["hw"].shape[0]
    C = a["wout"].shape[1]
    flops = B * N * (2 * D * H + nl * 2 * H * H + 2 * C * H)
    nbytes = 4 * (sum(t.numel() for t in a.values()) + B * N * C)
    return flops, nbytes


def cuda_ms(fn, reps=25, warmup=3):
    """Median of per-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=10, warmup=2):
    """Median wall time of a whole request, ending in a synchronize."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_kernel_vs_plain(dev):
    """Phase 2: the kernel against the plain version across the matrix."""
    errs = []
    rng = np.random.default_rng(0)
    acts = sd.KERNEL_ACTS_WITH_APPROX
    # (D, C, act, H, B, N, L, n_layers); N = 1000 is no multiple of 64
    cases = [(D, C, act, H, 37, 1000, 3, 2) for H in (128, 256)
             for D in (1, 2) for C in (1, 3) for act in acts]
    cases += [(2, 4, "tanh", 128, 1, 1, 1, 1),      # one pixel, four channels
              (2, 2, "gelu", 256, 3, 63, 6, 3),     # one partial tile
              (1, 1, "softplus", 256, 5, 129, 4, 1)]
    for i, (D, C, act, H, B, N, L, nl) in enumerate(cases):
        sig = i % 2 == 0
        t = lambda *s, k=1.0: torch.as_tensor(  # noqa: E731
            rng.normal(size=s) * k, dtype=torch.float32, device=dev)
        a = dict(grid=torch.as_tensor(rng.uniform(-1, 1, (N, D)),
                                      dtype=torch.float32, device=dev),
                 phi=t(B), dx=t(B, D, k=0.1), sc=1 + t(B, k=0.1), z=t(B, L),
                 Wc=t(D, H, k=0.5), bc=t(H, k=0.1), Wz=t(L, H, k=0.5),
                 hw=t(nl, H, H, k=1.5 / H ** 0.5), hb=t(nl, H, k=0.1),
                 wout=t(H, C, k=1.0 / H ** 0.5), bout=t(C, k=0.1))
        out = KERNEL(**a, act=act, sigmoid_out=sig)
        torch.cuda.synchronize()
        ref = sd.spatial_decoder_plain(**a, act=act, sigmoid_out=sig)
        what = (f"D={D} C={C} H={H} act={act:<11} sigmoid={sig!s:<5} "
                f"B={B} N={N} L={L} layers={nl}")
        errs.append(check_close(f"K1 {what}", out, ref))
        log(f"  K1 vs plain {what}: max abs err {errs[-1]:.3e}")
    return max(errs)


def phase_padded_model():
    """Phase 2, model level: a decoder whose widths pad to 256 is routed to
    the kernel and matches the sDecoderNet module on the transformed grid."""
    m = iVAE((28, 28), latent_dim=2, invariances=["r"],
             hidden_dim_d=(96, 160), seed=0)
    if not m._fused:
        raise AssertionError("hidden (96, 160) is not routed to the kernel")
    z = torch.as_tensor(np.random.default_rng(1).normal(size=(256, 2)),
                        dtype=torch.float32)
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    before = KERNEL.launches
    out = m.decode(z, **pose)
    if KERNEL.launches != before + 1:
        raise AssertionError("hidden (96, 160) decode did not launch K1")
    m._fused = False  # the module path: plain torch on the card
    ref = m.decode(z, **pose)
    err = check_close("padded-width model decode", out, ref)
    log(f"  hidden (96, 160) -> H=256 model decode vs module: max abs err "
        f"{err:.3e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    peak_f32, peak_bf16, peak_bw = card_peaks(smi)
    t0 = time.perf_counter()
    _build.load("spatial_decoder_fwd")
    log(f"phase 1: built spatial_decoder_fwd in "
        f"{time.perf_counter() - t0:.1f} s")
    log(_build.build_log("spatial_decoder_fwd").strip())

    # -- 2. kernel vs plain ------------------------------------------------
    log("phase 2: kernel vs plain")
    max_err = max(phase_kernel_vs_plain(dev), phase_padded_model())

    # -- 3. serving at full width (flagship); 4. large grid ---------------
    log("phases 3 and 4: flagship iVAE served, large-grid decode")
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    if not model._fused:
        raise AssertionError("flagship decoder is not routed to the kernel")
    x = blobs(2500, (28, 28), seed=0)
    rng = np.random.default_rng(0)
    z_req = torch.as_tensor(rng.normal(size=(1024, 2)), dtype=torch.float32)
    z_rag = torch.as_tensor(rng.normal(size=(2500, 2)), dtype=torch.float32)
    eps = rng.normal(size=(200, model.z_dim)).astype(np.float32)
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    big = iVAE((128, 128), latent_dim=2, invariances=["r"], seed=0)
    z_big = torch.as_tensor(rng.normal(size=(64, 2)), dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/flagship.npz"
        export_model(model, path)
        served = ServedModel(path)
    requests = {  # phase 3, then phase 4 (the large grid)
        "encode_1000": lambda: served.encode(x[:1000]),
        "reconstruct_200": lambda: model.reconstruct(x[:200]),
        "posed_decode_1024": lambda: served.decode(z_req, **pose),
        "manifold2d_32": lambda: model.manifold2d(32),
        "ragged_decode_2500": lambda: served.decode(z_rag),
        "loss_fn_200": lambda: model.loss_fn(x[:200], eps=eps),
        "large_grid_decode_64": lambda: big.decode(z_big, **pose),
    }
    outputs, launches = {}, {}
    KERNEL.launches = 0  # the main path starts here
    for name, request in requests.items():
        before = KERNEL.launches
        outputs[name] = request()
        launches[name] = KERNEL.launches - before
    torch.cuda.synchronize()
    total_launches = KERNEL.launches  # the main path ends here
    log(f"  K1 launches on the main path: {total_launches} {launches}")
    if total_launches == 0 or launches["posed_decode_1024"] == 0:
        raise AssertionError("the main path never launched the kernel")

    # outputs: shapes, finiteness, agreement with plain computations
    z_loc, z_scale = outputs["encode_1000"]
    if z_loc.shape != (1000, 3) or not bool((z_scale > 0).all()):
        raise AssertionError("encode: bad shape or non-positive sigma")
    ref_loc, ref_scale = model.encode(x[:1000])
    check_close("encode loc", z_loc, ref_loc)
    check_close("encode scale", z_scale, ref_scale)
    with torch.no_grad():
        def plain(m, z, **p):
            return sd.spatial_decoder_plain(**kernel_args(m.decoder_net,
                                                          m.grid, z.cuda(),
                                                          **p))
        encoded = model.encode(x[:200])[0][:, 1:]
        checks = (  # request, rows, plain model, latents, pose
            ("reconstruct_200", 200, model, encoded, {}),
            ("posed_decode_1024", 1024, model, z_req, pose),
            ("manifold2d_32", 1024, model, generate_latent_grid(32)[0], {}),
            ("ragged_decode_2500", 2500, model, z_rag, {}),
            ("large_grid_decode_64", 64, big, z_big, pose))
        errs = [check_close(name, outputs[name].reshape(rows, -1),
                            plain(m, z, **p))
                for name, rows, m, z, p in checks]
        model._fused = False  # the module path: plain torch on the card
        loss_ref = model.loss_fn(x[:200], eps=eps)
        model._fused = True
    loss = outputs["loss_fn_200"]
    if loss.shape != (200,) or not torch.isfinite(loss).all():
        raise AssertionError("loss_fn: bad shape or non-finite values")
    rel = ((loss - loss_ref).abs() / loss_ref.abs()).max().item()
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"loss_fn: max rel err {rel:.3e} > {LOSS_RTOL}")
    log(f"  served outputs match plain: max abs err {max(errs):.3e}, "
        f"loss max rel err {rel:.3e}")
    max_err = max(max_err, *errs)

    # -- 5. times ----------------------------------------------------------
    log("phase 5: times")
    shapes = []
    with torch.no_grad():
        for name, m, z in (("flagship", model, z_req),
                           ("flagship", model, z_req[:200]),
                           ("flagship", model, z_rag[2048:]),
                           ("large grid", big, z_big)):
            a = kernel_args(m.decoder_net, m.grid, z.cuda(), **pose)
            label = f"{name} B={a['z'].shape[0]} N={a['grid'].shape[0]}"
            flops, nbytes = work(a)
            k_ms = cuda_ms(lambda: KERNEL(**a))
            p_ms = cuda_ms(lambda: sd.spatial_decoder_plain(**a), reps=20)
            b32 = 1e3 * max(flops / peak_f32, nbytes / peak_bw)
            b16 = 1e3 * max(flops / peak_bf16, nbytes / peak_bw)
            row = {"shape": label, "B": a["z"].shape[0],
                   "N": a["grid"].shape[0], "H": a["Wc"].shape[1],
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": b32,
                   "bound_ms_bf16": b16, "flops": flops, "bytes": nbytes,
                   "tflops": flops / k_ms / 1e9}
            shapes.append(row)
            log(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"bound f32 {b32:.4f} ms, bound bf16 {b16:.4f} ms, "
                f"{row['tflops']:.2f} TFLOP/s")
    request_ms = {name: host_ms(request, reps=30)
                  for name, request in requests.items()}
    log(f"  request latency, ms (host clock, median): {json.dumps(request_ms)}")
    # the host work one decode pays for its padded weights: built afresh,
    # or taken from the module's cache
    dec = model.decoder_net
    with torch.no_grad():
        weights_ms = {
            "build": host_ms(lambda: sd.padded_sdecoder_weights(dec), reps=30),
            "cached": host_ms(lambda: sd._kernel_weights(dec), reps=30)}
    log(f"  padded decoder weights, ms (host clock, median): "
        f"{json.dumps(weights_ms)}")
    head = shapes[0]
    flops0, bytes0 = head["flops"], head["bytes"]
    result = {"kernels": [{
        "name": "spatial_decoder_fwd",
        "route": "cuda",
        "source": "pyroved_tpu_torch/csrc/spatial_decoder_fwd.cu",
        "replaces": "pyroved_tpu/ops/spatial_decoder.py:422",
        "launches": total_launches,
        "launches_per_request": launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_ms_bf16": head["bound_ms_bf16"],
        "bound_by": ("operations" if flops0 / peak_f32 >= bytes0 / peak_bw
                     else "bytes"),
        "library_ms": None,
        "shapes": shapes,
        "request_ms": request_ms,
        "weights_ms": weights_ms,
    }]}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
