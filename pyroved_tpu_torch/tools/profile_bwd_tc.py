"""Profile the tensor-core K2 (``csrc/spatial_decoder_bwd_tc.cu``) on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_bwd_tc

1. Per-phase cycles of one tile: builds the source with
   ``PVT_PROFILE_PHASES`` defined, which compiles in a ``clock64()`` mark
   before each ``// --`` phase of the tile loop (block 0, thread 0; a few
   cycles each), binds it in place of the kernel and prints the cycles per
   tile of each phase at the flagship shape (B=200, N=784, H=128, two tanh
   layers).
2. Device time of each kernel of one K2 call (torch.profiler) and of the
   call (CUDA events), at the flagship shape with hidden width 128 (every
   layer's weights resident in shared memory) and 256 (64-unit weight
   panels streamed from L2 per product, four passes over the tiles at
   two layers).
3. Chaos of bf16 training: the flagship trains 3 epochs through ``fit``
   with the wrappers running their plain versions (the same numerics as
   the kernels), under each ``BF16_MATMUL``, from the seed-0 weights and
   from those weights scaled by 1 + 1e-6 noise; prints the per-epoch
   losses.
"""
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..models import iVAE
from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import bf16_matmul, blobs, cuda_ms, plain_versions, random_case

#: What each mark of the profiled source closes, in mark order: mark 0 the
#: loop's own overhead, mark k > 0 the k-th ``// --`` phase of the loop.
PHASES = ("(loop)", "per-sample transform, tile coordinates", "h0",
          "forward recompute", "head dots", "head: logits, cotangents, loss",
          "last layer", "hidden layers, last to first")
DEFINES = ("PVT_PROFILE_PHASES",)


def flagship_inputs(H):
    """K2's inputs at the flagship training shape (B=200, N=784, two
    layers) with hidden width H, and a cotangent."""
    a = random_case(np.random.default_rng(0), "cuda", 2, 1, H, 200, 784, 2, 2)
    return a, torch.randn(200, 784, device="cuda")


def phase_cycles(a, g):
    """{phase: cycles per tile of block 0} of one K2 call, from the
    profiled build bound in place of the kernel for the call."""
    lib = _build.load("spatial_decoder_bwd_tc", DEFINES)
    read = lib.pvt_sdec_bwd_tc_phase_cycles
    read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    read.restype = ctypes.c_int
    saved = dict(sd._bwd_fns)
    sd._bwd_fns[True] = sd._bind_bwd(lib, sd.BWD_ENTRIES[True])
    sd._bwd_plan.cache_clear()
    cycles = (ctypes.c_longlong * len(PHASES))()
    try:
        with bf16_matmul(True):
            sd.fused_spatial_decoder_backward(**a, g=g)  # warm
            torch.cuda.synchronize()
            if read(cycles, 1) != 0:
                raise RuntimeError("resetting the phase cycles failed")
            sd.fused_spatial_decoder_backward(**a, g=g)
            torch.cuda.synchronize()
            if read(cycles, 0) != 0:
                raise RuntimeError("reading the phase cycles failed")
            B, N = a["z"].shape[0], a["grid"].shape[0]
            _, blocks = sd.bwd_workspace(B, N, 2, a["z"].shape[1], 128,
                                         a["hw"].shape[0], 1)
    finally:
        sd._bwd_fns.clear()
        sd._bwd_fns.update(saved)
        sd._bwd_plan.cache_clear()
    # the flagship plan: 64-pixel tiles, one pass of `blocks` blocks
    tiles = -(-B * -(-N // 64) // blocks)
    return {name: cycles[k] / tiles for k, name in enumerate(PHASES)}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bwd_tc: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    a, g = flagship_inputs(128)

    # 1. per-phase cycles
    phases = phase_cycles(a, g)
    print(f"cycles per tile by phase, block 0: {phases}; total "
          f"{sum(phases.values()):.0f}", flush=True)

    # 2. each kernel of a K2 call, and the call, at H = 128 and 256
    k2 = sd.fused_spatial_decoder_backward
    for H in (128, 256):
        a, g = flagship_inputs(H)
        with bf16_matmul(True):
            call_ms = cuda_ms(lambda: k2(**a, g=g), reps=20)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(10):
                    k2(**a, g=g)
                torch.cuda.synchronize()
        kernels = {ev.key[:60]:
                   getattr(ev, "self_device_time_total", 0.0) / 1e4
                   for ev in prof.key_averages()
                   if getattr(ev, "self_device_time_total", 0.0) > 0}
        print(f"H={H}: K2 call {call_ms:.4f} ms (CUDA events); kernels, ms "
              f"per call: {kernels}", flush=True)

    # 3. chaos of bf16 training, plain versions
    X = blobs(10000, (28, 28), seed=1)
    for on in (True, False):
        for noise in (0.0, 1e-6):
            with bf16_matmul(on), plain_versions():
                m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
                gen = torch.Generator(device="cuda").manual_seed(7)
                with torch.no_grad():
                    for p in m.nets.parameters():
                        p.mul_(1 + noise * torch.randn(
                            p.shape, generator=gen, device="cuda"))
                hist = m.fit(X, epochs=3, batch_size=200).loss_history[
                    "training_loss"]
            print(f"BF16_MATMUL={on}, weights x (1 + {noise:g} noise): "
                  f"per-epoch losses {hist}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
