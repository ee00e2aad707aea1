"""What synchronising a thread-block cluster costs on the card: the
measurement behind the exchanges of the H = 256 kernels
(``csrc/spatial_decoder_fwd_tc.cu``, ``csrc/spatial_decoder_bwd_tc.cu``).

Run from the repository root on a machine with a Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.cluster_sync

Builds ``csrc/cluster_sync_probe.cu`` and, for clusters of 2 and 4 blocks
of 256 threads (120 blocks), prints the median and the largest of every
block's cycles a step (:data:`STEPS`): the cluster barrier alone, after one
and sixteen remote stores a thread, with the proxy fence a wgmma reader
needs, and the bulk-copy exchange of 4 and 16 KB a block that the
kernels use. One JSON line, with the card's name and power limit.
"""
import ctypes
import json
import sys

import torch

from ..ops import _build
from .measure import card_info

PROBE = "cluster_sync_probe"
#: (name, mode, n) of the probe's steps (``csrc/cluster_sync_probe.cu``).
STEPS = (("barrier", 0, 0), ("1 remote store, barrier", 1, 1),
         ("16 remote stores, barrier", 1, 16),
         ("1 remote store, proxy fence, barrier", 2, 1),
         ("16 remote stores, proxy fence, barrier", 2, 16),
         ("bulk exchange 4 KB", 3, 4), ("bulk exchange 16 KB", 3, 16))
BLOCKS, ITERS = 120, 200


def probe(lib, cs, mode, n):
    """(median, largest) of the blocks' cycles a step."""
    fn = lib.pvt_cluster_sync_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(BLOCKS, dtype=torch.int64, device="cuda")
    err = fn(out.data_ptr(), BLOCKS, cs, ITERS, mode, n,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the cluster probe's launch failed: CUDA error "
                           f"{err}")
    torch.cuda.synchronize()
    return out.median().item(), out.max().item()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("cluster_sync: CUDA is not available", file=sys.stderr)
        return 1
    lib = _build.load(PROBE)
    res = {"card": card_info()}
    for cs in (2, 4):
        res[f"clusters of {cs}"] = {
            name: dict(zip(("median", "max"), probe(lib, cs, mode, n)))
            for name, mode, n in STEPS}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
