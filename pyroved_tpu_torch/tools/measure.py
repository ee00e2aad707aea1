"""What the port's measurement scripts share (``chip_smoke.py`` and the
tools of :mod:`pyroved_tpu_torch.tools`): the flag and the plain versions
swapped in for a block, the training data, random kernel inputs, CUDA-event
timing, the card's name and its data-sheet peaks."""
import contextlib
import statistics
import subprocess

import numpy as np
import torch

from ..ops import spatial_decoder as sd

# Data-sheet peaks (dense) of the H100 SXM5, the part nvidia-smi names
# "NVIDIA H100 80GB HBM3": f32 on the CUDA cores, bf16 on the tensor cores,
# HBM bandwidth. Other cards have no row: their bounds would be wrong.
H100_SXM = "H100 80GB HBM3"
PEAKS = (67e12, 989e12, 3.35e12)  # (f32 flop/s, bf16 flop/s, bytes/s)


def card_peaks(name):
    """:data:`PEAKS` for a card ``nvidia-smi`` names ``name``, or raise."""
    if H100_SXM not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}")
    return PEAKS


def card_info():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def plain_versions():
    """The K1, K2 and K3 wrappers replaced by their plain versions inside
    the block, also on CUDA tensors: the kernels' yardstick, never the
    port's path."""
    names = {"fused_spatial_decoder_forward": sd.spatial_decoder_plain,
             "fused_spatial_decoder_backward": sd.spatial_decoder_bwd_plain,
             "fused_bernoulli_recon_loss_kernel": sd.recon_loss_plain}
    old = {n: getattr(sd, n) for n in names}
    for n, f in names.items():
        setattr(sd, n, f)
    try:
        yield
    finally:
        for n, f in old.items():
            setattr(sd, n, f)


@contextlib.contextmanager
def bf16_matmul(on):
    """The port's BF16_MATMUL flag set to ``on`` inside the block."""
    old = sd.BF16_MATMUL
    sd.BF16_MATMUL = on
    try:
        yield
    finally:
        sd.BF16_MATMUL = old


def blobs(n, dim, seed, centers=False):
    """MNIST-like oriented Gaussian bumps (bench.py's data); with
    ``centers``, also each bump's x centre in [-0.4, 0.4] (the labels of
    the semi-supervised runs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, dim[0]),
                         np.linspace(-1, 1, dim[1]), indexing="ij")
    cx = rng.uniform(-0.4, 0.4, n)[:, None, None]
    cy = rng.uniform(-0.4, 0.4, n)[:, None, None]
    s = rng.uniform(0.05, 0.2, n)[:, None, None]
    X = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / s).astype(np.float32)
    return (X, cx.ravel().astype(np.float32)) if centers else X


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


def cuda_ms_queued(fn, n=20, reps=5, warmup=3):
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls, over ``n``: the host queues launches ahead of the device, so a
    kernel longer than its wrapper's host work is timed alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def random_case(rng, dev, D, C, H, B, N, L, nl):
    """Random decoder inputs (shapes as ``spatial_decoder_plain``) from the
    numpy generator ``rng``, on ``dev``: D coordinate dims, C channels,
    width H, B samples, N pixels, L latents, nl hidden layers."""
    t = lambda *s, k=1.0: torch.as_tensor(  # noqa: E731
        rng.normal(size=s) * k, dtype=torch.float32, device=dev)
    return dict(grid=torch.as_tensor(rng.uniform(-1, 1, (N, D)),
                                     dtype=torch.float32, device=dev),
                phi=t(B), dx=t(B, D, k=0.1), sc=1 + t(B, k=0.1), z=t(B, L),
                Wc=t(D, H, k=0.5), bc=t(H, k=0.1), Wz=t(L, H, k=0.5),
                hw=t(nl, H, H, k=1.5 / H ** 0.5), hb=t(nl, H, k=0.1),
                wout=t(H, C, k=1.0 / H ** 0.5), bout=t(C, k=0.1))
