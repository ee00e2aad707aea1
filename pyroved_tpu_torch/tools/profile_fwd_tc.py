"""Profile the tensor-core K1 (``csrc/spatial_decoder_fwd_tc.cu``) on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.profile_fwd_tc

Builds the source as the port does, with ``PVT_PROFILE_PHASES`` defined
(a ``clock64()`` mark before each ``// --`` phase of the tile loop, read by
thread 0 of block 0, so of its first warpgroup), and prints its ptxas
report. Then, on random inputs of the flagship decoder (H=128, two tanh
layers) at B = 1024 and 200 with N = 784, prints the first warpgroup's
cycles per tile by phase.
"""
import contextlib
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd
from .measure import bf16_matmul, random_case

NAME = "spatial_decoder_fwd_tc"
#: What each mark of the profiled source closes, in mark order.
PHASES = ("(loop)", "per-sample transform", "h0", "products",
          "layer epilogues", "head dots", "logits out")
PROFILED = ("PVT_PROFILE_PHASES",)
SHAPES = ((1024, 784), (200, 784))


def first_warpgroup_tiles(B, N, wgs=4, tile=64):
    """Tiles of block 0's first warpgroup: the kernel's split of the flat
    tile list over one block of ``wgs`` warpgroups on each SM."""
    total = B * -(-N // tile)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = min(-(-total // wgs), sms)
    return total // (blocks * wgs)


def phase_cycles(lib, a):
    """{phase: cycles per tile of the first warpgroup} of one K1 call with
    the profiled library ``lib`` bound in place of the kernel."""
    read = lib.pvt_sdec_fwd_tc_phase_cycles
    read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    read.restype = ctypes.c_int
    cycles = (ctypes.c_longlong * len(PHASES))()
    with bound(lib):
        sd.fused_spatial_decoder_forward(**a)  # warm
        torch.cuda.synchronize()
        if read(cycles, 1) != 0:
            raise RuntimeError("resetting the phase cycles failed")
        sd.fused_spatial_decoder_forward(**a)
        torch.cuda.synchronize()
        if read(cycles, 0) != 0:
            raise RuntimeError("reading the phase cycles failed")
    tiles = first_warpgroup_tiles(a["z"].shape[0], a["grid"].shape[0])
    return {name: cycles[k] / tiles for k, name in enumerate(PHASES)}


@contextlib.contextmanager
def bound(lib):
    """The library ``lib`` bound as the tensor-core K1 inside the block."""
    saved = dict(sd._fwd_fns)
    sd._fwd_fns[True] = sd._bind_fwd(lib, True)
    try:
        yield
    finally:
        sd._fwd_fns.clear()
        sd._fwd_fns.update(saved)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fwd_tc: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib = _build.load(NAME, PROFILED)
    usage = [line.strip()
             for line in _build.build_log(NAME, PROFILED).splitlines()
             if "registers" in line or "spill" in line]
    print(f"ptxas (12 instances: H 128, 256 x six activations): {usage}",
          flush=True)
    rng = np.random.default_rng(0)
    with bf16_matmul(True), torch.no_grad():
        for B, N in SHAPES:
            phases = phase_cycles(lib, random_case(rng, "cuda", 2, 1, 128, B,
                                                   N, 2, 2))
            print(f"B={B} N={N}: cycles per tile of the first warpgroup by "
                  f"phase {phases}; total {sum(phases.values()):.0f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
