"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 chip_smoke.py

Phases, in order (any failure propagates and exits non-zero):

Each phase that runs a decoder kernel runs under the port's
``BF16_MATMUL`` flag: set (the default, as the JAX package's), hidden
products take bf16 operands and every kernel runs on the tensor cores (K1
``spatial_decoder_fwd_tc.cu``, K2/K3 ``spatial_decoder_bwd_tc.cu``);
clear, everything is f32 on the CUDA cores (``spatial_decoder_fwd.cu``,
``spatial_decoder_bwd.cu``). Launches are counted by source.

1. Device and build: prints the card's name and power limit
   (``nvidia-smi``), then builds the four decoder sources from
   ``pyroved_tpu_torch/csrc`` (one nvcc per source, started together) and
   prints the build time and the ptxas report.
2. Kernels against plain, under each flag: the fused forward K1 against
   ``spatial_decoder_plain`` over D in {1, 2}, C in {1, 3}, the six
   activations, hidden width 128 and 256, ragged B and N, 0 to 5 hidden
   layers for every activation at both widths, one pixel of one sample and
   the large grid, each launched twice to show bitwise-equal outputs; then
   the backward K2 against ``spatial_decoder_bwd_plain`` (random
   cotangent) and the one-pass Bernoulli kernel K3 against
   ``recon_loss_plain`` on K2's matrix (K3 with C = 1), each launched
   twice to show bitwise-equal grads. With the flag clear, a model whose
   decoder widths (96, 160) pad to 256 against its sDecoderNet module.
3. Serving at full width: the flagship iVAE (28x28, latent 2, rotation,
   hidden 128x128, tanh, Bernoulli) from seed 0 is exported and served; it
   answers encode, reconstruct, posed decode, manifold2d, a ragged request
   and ELBO scoring, each checked against a plain computation (default
   flag); then the same requests with the flag clear, counted only.
4. Large grid: a posed decode of 64 latents on the 128x128 model.
5. Training at full width, under each flag: the flagship from seed 0
   trains 3 epochs on 10,000 blob images at batch 200 through ``fit`` (K1
   and K2 once per step); the same init with ``fused=False`` (the module
   path, f32) is held against it, first step's grads and per-epoch
   losses; then a few steps with ``one_pass_train=True`` (K3 once per
   step, no K1 or K2). Then the large grid (128x128, batch 64) trains 32
   steps through ``fit`` under each flag.
6. Times: first K2 and K3 under each flag at the flagship training shape
   and the large grid (B=64, N=16384), on the trained models' inputs,
   against their plain versions and a second launch (bitwise); K1 under
   each flag at the four shapes of the paths, against its plain version
   and a second launch; then each kernel and its plain version at those
   shapes (median of CUDA-event timings of single calls, and for K1 also of
   20 calls back to back, which hides the wrapper's host work behind the
   device's), beside the least time the card
   could take for the same work and cuBLAS's time for the same hidden-layer
   products as bare matrix products (bf16 for the tensor-core kernels, f32
   with TF32 off for the f32 ones); request latencies and the
   padded-weight build (host clock); the training step and an epoch's
   steps/s for the kernel path and the module path, and a profiler
   breakdown of the step, under each flag; the large grid's step.
7. The discrete-latent and semi-supervised families, under each flag, at
   the width of ``benchmarks/enum_bench.py`` (28x28, latent 2, rotation,
   10 classes, hidden 128x128, tanh, Bernoulli, batch 200, seed 0), on
   2,000 blob images labelled by the bin of their x centre: jiVAE trains
   2 epochs through ``fit`` (each step K1 and K2 once on the enumerated
   decode, K*B = 2,000 rows at L = 12), held against the ``fused=False``
   module path (f32) with phase 5's tolerances, first step's grads and
   per-epoch losses; 5 steps with ``enum_topk=3`` (600 rows); it serves
   encode, posed decode and manifold2d, and its export encode and decode.
   ssiVAE (400 labeled images) trains 2 epochs through ``fit``, its
   accuracy in ``history["test"]``, held to the module path likewise; its
   export serves classify, the auto-labelled encode and decode. ss_reg_iVAE
   trains 2 trainer steps. Every path counts its launches alone: one K1
   and one K2 per training step, K1 once per decode, the flag's sources
   only. Then K1 and K2 at the enumerated shape join phase 6's table
   (against plain, a second launch, bound, plain time, cuBLAS), and the
   enumerated jiVAE step's wall time, alone and in epochs back to back,
   with its profiler breakdown, under each flag.

TF32 is off for the plain version's matrix products and convolutions, so
they compute in full f32 (on bf16-rounded operands under the flag).

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, without CUDA.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pyroved_tpu_torch.models import iVAE, jiVAE, ss_reg_iVAE, ssiVAE
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.serving import ServedModel, export_model
from pyroved_tpu_torch.tools.measure import (bf16_matmul, blobs, cuda_ms,
                                             cuda_ms_queued, plain_versions,
                                             random_case)
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.coord import generate_latent_grid
from pyroved_tpu_torch.utils.data import (init_dataloader,
                                          init_ssvae_dataloaders)
from pyroved_tpu_torch.utils.nn import to_onehot

K1 = sd.fused_spatial_decoder_forward
K2 = sd.fused_spatial_decoder_backward
K3 = sd.fused_bernoulli_recon_loss_kernel
KERNELS = (K1, K2, K3)
SOURCES = ("spatial_decoder_fwd", "spatial_decoder_fwd_tc",
           "spatial_decoder_bwd", "spatial_decoder_bwd_tc")
GRAD_NAMES = ("phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb", "wout",
              "bout")
PER_SAMPLE = 4  # the first four grads are per sample, the rest summed
# Kernel vs plain, both f32 on the card: the sums run in another order
# (cuBLAS against the kernel's per-thread fma chains) and tanhf/erff differ
# from PyTorch's by a few ulp per layer.
ATOL = 1e-4
# Grads: atol 1e-4 with rtol 1e-3 per element; a weight grad sums over
# every pixel of the batch (37,000 here), so its elements that nearly
# cancel are held to 1e-3 of the tensor's largest entry instead.
GRAD_RTOL = 1e-3
# Per-example negative ELBO sums ~800 pixel terms of size ~1: relative.
LOSS_RTOL = 1e-4
# Kernel path against the module path in training: the first step's grads
# as above; the per-epoch losses after 50-150 Adam steps, relative.
EPOCH_RTOL = 1e-3
# relu and lrelu: a pre-activation within rounding of 0 can fall on
# different sides of the kink in the kernel and in cuBLAS, and such a pixel
# moves the grads by its whole contribution. The cases take those pixels
# out of the comparison: their cotangent is 0 (K2) or their observation is
# the decoded value (K3, so w (sigmoid(logit) - x) is ~0). A pixel counts
# as near the kink when a hidden pre-activation, in f64, is within
# KINK_BAND of 0, ten times the f32 rounding of a 128-term sum of size ~1.
KINK_BAND = 1e-5
# Kernel against plain under BF16_MATMUL: both round the same operands to
# bf16, but an operand within an f32 rounding of a bf16 boundary rounds to
# either neighbour (2^-8 relative), since the f32 sums before it run in
# other orders. A decoded value moves by |wout| 2^-8 |h| per flipped hidden
# value (6.3e-4 measured at the flagship shape), a grad by up to 7e-4 of
# its tensor's largest entry (measured over the cases below). The flips a
# pixel collects grow with its hidden values, so the linear heads of the
# random cases (logits of size ~10) reach 3.2e-3 (measured). Decoded values
# within BF16_ATOL + BF16_OUT_REL of the largest output, every grad within
# ATOL + BF16_GRAD_REL of its tensor's largest entry. Losses as in f32
# (1.4e-7 measured).
BF16_ATOL = 3e-3
BF16_OUT_REL = 2e-3
BF16_GRAD_REL = 5e-3
# relu and lrelu under bf16: a flipped operand moves a pre-activation by
# up to |W| 2^-8 |h| ~ 4e-3, far beyond KINK_BAND, so a few pixels cross
# the kink in one version only, each moving a grad by its whole
# contribution: up to 6.3e-3 of the largest entry measured over the
# 37,000-pixel cases (smooth activations: 7.1e-4). Held at 2e-2.
BF16_KINK_GRAD_REL = 2e-2
# The bf16 kernel path against the f32 module path: the rounding itself.
# The reference bounds decoded values at 2e-2 (tests/test_ops_fused.py);
# on the CPU the flagship's first-step grads differ by 2.6e-3 of each
# tensor's largest entry and the per-example losses by 4.4e-5, relative.
# Training in bf16 is chaotic in the third epoch, where the loss falls
# fastest: on the card, scaling the initial weights by 1 + 1e-6 noise
# moves that epoch's loss by 2.2e-2 (bf16, plain versions; f32: 7.0e-5;
# pyroved_tpu_torch/tools/profile_bwd_tc.py), and kernel and module paths
# differed by up to 1.8e-2 there. Per-epoch losses are held to 5e-2 of
# the module path's. The trained model's grads are then
# held to the plain versions' on the card, in the same bf16 numerics
# (within BF16_GRAD_REL of each tensor's largest entry; 3.0e-6 measured).
BF16_MODULE_GRAD_REL = 2e-2
BF16_MODULE_LOSS_RTOL = 1e-3
BF16_EPOCH_RTOL = 5e-2

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


def train_args(model, x, eps):
    """K2/K3 inputs of one training step of ``model`` on images ``x`` with
    latent noise ``eps`` (detached weights, posterior sample as the model
    draws it)."""
    with torch.no_grad():
        xf = torch.as_tensor(x, device="cuda").reshape(x.shape[0], -1)
        mu, sig = model.encoder_net(xf)
        phi, dx, sc, zc = model.split_latent_full(mu + sig * eps)
        a = dict(grid=model.grid, phi=phi.contiguous(), dx=dx.contiguous(),
                 sc=sc.contiguous(), z=zc.contiguous())
        a.update(zip(("Wc", "bc", "Wz", "hw", "hb", "wout", "bout"),
                     (t.detach() for t in
                      sd.padded_sdecoder_weights(model.decoder_net))))
    return a, xf


def check_close(what, got, ref, atol=ATOL, rel=0.0):
    """Max abs error within ``atol`` + ``rel`` of the largest |ref|."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - ref).abs().max().item()
    tol = atol + rel * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {tol:.3e}")
    return err


@contextlib.contextmanager
def all_cases(what):
    """Yields ``case``, a context for one case of a phase: a failing case
    is logged and the phase goes on, then raises listing every failure."""
    failures = []

    @contextlib.contextmanager
    def case():
        try:
            yield
        except AssertionError as e:
            log(f"  FAILED: {e}")
            failures.append(str(e))

    yield case
    if failures:
        raise AssertionError(f"{what}: {len(failures)} cases failed:\n"
                             + "\n".join(failures))


def rel_to_max(got, ref):
    """The largest error of any grad over its tensor's largest entry."""
    return max(((g.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-30)).item()
               for g, r in zip(got, ref))


def check_grads(what, got, ref, names=GRAD_NAMES, per_sample=PER_SAMPLE,
                rel=GRAD_RTOL):
    """Each of the first ``per_sample`` grads within atol 1e-4 + rtol
    ``rel`` per element; the summed weight grads within 1e-4 + ``rel`` of
    their largest entry. Returns the largest absolute error."""
    worst = 0.0
    for i, (name, g, r) in enumerate(zip(names, got, ref)):
        g, r = g.float(), r.float()
        if g.shape != r.shape:
            raise AssertionError(f"{what} d{name}: shape {tuple(g.shape)} "
                                 f"!= {tuple(r.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} d{name}: non-finite grads")
        err = (g - r).abs()
        top = r.abs().max()
        scale = r.abs() if i < per_sample else top
        n_miss = int((err > ATOL + rel * scale).sum())
        if n_miss:
            raise AssertionError(f"{what} d{name}: max abs err "
                                 f"{err.max().item():.3e} (largest grad "
                                 f"{top.item():.3e}, {n_miss} elements "
                                 f"out of tolerance)")
        worst = max(worst, err.max().item())
    return worst


def work(a):
    """(flops, bytes) one K1 call needs: every input read once, the output
    written once."""
    N, D = a["grid"].shape
    B = a["z"].shape[0]
    H = a["Wc"].shape[1]
    nl = a["hw"].shape[0]
    C = a["wout"].shape[1]
    flops = B * N * (2 * D * H + nl * 2 * H * H + 2 * C * H)
    nbytes = 4 * (sum(t.numel() for t in a.values()) + B * N * C)
    return flops, nbytes


def work_bwd(a, loss_mode=False):
    """(flops, bytes) one K2 (or K3) call needs: per pixel the forward
    recompute (h0, nl H x H layers, head) and the backward (head, dW and dh
    of each layer, the du/dv/dw sums); every input read once (with the
    cotangent, or x and the weights), every grad written once."""
    N, D = a["grid"].shape
    B = a["z"].shape[0]
    H = a["Wc"].shape[1]
    nl = a["hw"].shape[0]
    C = a["wout"].shape[1]
    flops = B * N * (6 * nl * H * H + 2 * (D + 1) * H + 6 * C * H + 6 * H)
    inputs = sum(t.numel() for t in a.values())
    grads = inputs - a["grid"].numel()
    extra = B * N + B if loss_mode else B * N * C
    return flops, 4 * (inputs + grads + extra)


def bounds(flops, nbytes, peaks):
    """(f32 bound, bf16 bound, what bounds f32, what bounds bf16), ms."""
    peak_f32, peak_bf16, peak_bw = peaks
    by = lambda peak: ("operations" if flops / peak >= nbytes / peak_bw  # noqa: E731
                       else "bytes")
    return (1e3 * max(flops / peak_f32, nbytes / peak_bw),
            1e3 * max(flops / peak_bf16, nbytes / peak_bw),
            by(peak_f32), by(peak_bf16))


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


def k1_cases():
    """(D, C, act, H, B, N, L, n_layers) of K1's matrix: 51 cases over
    dims, channels, activations and widths (N = 1000 is no multiple of 64
    or 32), then 1 to 5 hidden layers for every activation at both widths
    (H = 256 streams its weights), no hidden layer at both widths, one
    pixel of one sample at H = 256, and the large grid: 85 cases."""
    acts = sd.KERNEL_ACTS_WITH_APPROX
    cases = [(D, C, act, H, 37, 1000, 3, 2) for H in (128, 256)
             for D in (1, 2) for C in (1, 3) for act in acts]
    cases += [(2, 4, "tanh", 128, 1, 1, 1, 1),      # one pixel, four channels
              (2, 2, "gelu", 256, 3, 63, 6, 3),     # one partial tile
              (1, 1, "softplus", 256, 5, 129, 4, 1)]
    cases += [(2, 2, act, 128, 3, 150, 2, nl) for act in acts
              for nl in (1, 3, 4, 5)]
    cases += [(1, 1, act, 256, 2, 90, 3, 5) for act in acts]
    cases += [(2, 1, "tanh", 128, 2, 70, 2, 0),     # no hidden layer
              (1, 1, "tanh", 256, 2, 70, 2, 0),     # no hidden layer, H=256
              (1, 3, "gelu", 256, 1, 1, 2, 2),      # one pixel, streamed
              (2, 1, "tanh", 128, 64, 16384, 2, 2)]  # the large grid
    return cases


def phase_k1_vs_plain(dev):
    """Phase 2: K1 against the plain version across the matrix, under the
    current flag, each case launched twice with bitwise-equal outputs."""
    atol, rel = (BF16_ATOL, BF16_OUT_REL) if sd.BF16_MATMUL else (ATOL, 0.0)
    errs = [0.0]
    rng = np.random.default_rng(0)
    with all_cases("K1 vs plain") as case:
        for i, (D, C, act, H, B, N, L, nl) in enumerate(k1_cases()):
            sig = i % 2 == 0
            a = random_case(rng, dev, D, C, H, B, N, L, nl)
            out = K1(**a, act=act, sigmoid_out=sig)
            again = K1(**a, act=act, sigmoid_out=sig)
            torch.cuda.synchronize()
            ref = sd.spatial_decoder_plain(**a, act=act, sigmoid_out=sig)
            what = (f"D={D} C={C} H={H} act={act:<11} sigmoid={sig!s:<5} "
                    f"B={B} N={N} L={L} layers={nl}")
            with case():
                if not torch.equal(out, again):
                    raise AssertionError(f"K1 {what}: two launches differ")
                errs.append(check_close(f"K1 {what}", out, ref, atol, rel))
                log(f"  K1 vs plain {what}: max abs err {errs[-1]:.3e} "
                    f"(largest output {ref.abs().max().item():.2e}), "
                    f"bitwise equal across launches")
    if sd.BF16_MATMUL:  # a decoder the tensor-core kernel does not take
        deep = sd.fwd_tc_max_layers(128, 1, dev) + 1
        a = random_case(rng, dev, 2, 1, 128, 2, 70, 2, deep)
        try:
            K1(**a)
        except ValueError as e:
            log(f"  K1 with {deep} layers at H=128 raises: {e}")
        else:
            raise AssertionError(f"K1 took {deep} layers at H=128")
    return max(errs)


def phase_padded_model():
    """Phase 2, model level: a decoder whose widths pad to 256 is routed to
    K1 and matches the same weights' sDecoderNet module (``fused=False``)."""
    kw = dict(latent_dim=2, invariances=["r"], hidden_dim_d=(96, 160), seed=0)
    m = iVAE((28, 28), **kw)
    module = iVAE((28, 28), fused=False, **kw)
    if not m._fused or module._fused:
        raise AssertionError("hidden (96, 160) is not routed as configured")
    z = torch.as_tensor(np.random.default_rng(1).normal(size=(256, 2)),
                        dtype=torch.float32)
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    source = sd.FWD_SOURCES[sd.BF16_MATMUL]
    before = K1.launches[source]
    out = m.decode(z, **pose)
    if K1.launches[source] != before + 1:
        raise AssertionError("hidden (96, 160) decode did not launch K1")
    ref = module.decode(z, **pose)
    if K1.launches[source] != before + 1:
        raise AssertionError("the fused=False model launched K1")
    err = check_close("padded-width model decode", out, ref)
    log(f"  hidden (96, 160) -> H=256 model decode vs module: max abs err "
        f"{err:.3e}")
    return err


def bwd_cases():
    """(D, C, act, H, B, N, L, n_layers) of K2's matrix: K1's, with edge
    shapes inside the backward's layer limit (5 layers, 2 with gelu)."""
    cases = [(D, C, act, H, 37, 1000, 3, 2) for H in (128, 256)
             for D in (1, 2) for C in (1, 3)
             for act in sd.KERNEL_ACTS_WITH_APPROX]
    cases += [(2, 4, "tanh", 128, 1, 1, 1, 1),       # one pixel, four channels
              (2, 2, "gelu", 256, 3, 63, 6, 2),      # one partial tile, gelu
              (2, 2, "tanh", 256, 3, 63, 6, 3),      # three layers
              (1, 1, "softplus", 256, 5, 129, 4, 1),
              (2, 1, "relu", 128, 4, 200, 2, 5)]     # the layer limit
    return cases


def near_kink(a, act):
    """[B, N] pixels with a hidden pre-activation within KINK_BAND of
    relu's or lrelu's kink (f64 plain forward, on bf16-rounded operands
    under the flag), or None for smooth activations."""
    if act not in ("relu", "lrelu"):
        return None
    d = {k: v.double() for k, v in a.items()}
    hs, _, _ = sd._folded_forward(d["grid"], d["phi"], d["dx"], d["sc"],
                                  d["z"], d["Wc"], d["bc"], d["Wz"], d["hw"],
                                  d["hb"], act)
    near = torch.zeros(hs[0].shape[:2], dtype=torch.bool, device=hs[0].device)
    for i in range(d["hw"].shape[0]):
        pre = sd._mm(hs[i], d["hw"][i]) + d["hb"][i]
        near |= (pre.abs() < KINK_BAND).any(-1)
    return near


def phase_k2_k3_vs_plain(dev):
    """Phase 2: K2 and K3 against their plain versions, and launched twice
    on the same inputs with bitwise-equal grads, under the current flag
    (the tensor-core kernel when it is set)."""
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    rng = np.random.default_rng(2)
    errs2, errs3 = [0.0], [0.0]
    per_sample = 0 if sd.BF16_MATMUL else PER_SAMPLE
    with all_cases(f"K2/K3 {tag} vs plain") as case:
        for i, (D, C, act, H, B, N, L, nl) in enumerate(bwd_cases()):
            sig = i % 2 == 0
            grad_rel = (GRAD_RTOL if not sd.BF16_MATMUL else
                        BF16_KINK_GRAD_REL if act in ("relu", "lrelu") else
                        BF16_GRAD_REL)
            a = random_case(rng, dev, D, C, H, B, N, L, nl)
            shape = (B, N) if C == 1 else (B, N, C)
            g = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                device=dev)
            near = near_kink(a, act)
            if near is not None:
                g[near] = 0.0
            what = (f"D={D} C={C} H={H} act={act:<11} sigmoid={sig!s:<5} "
                    f"B={B} N={N} L={L} layers={nl}"
                    + ("" if near is None else f" ({int(near.sum())} pixels "
                       f"near the kink left out)"))
            with case():
                got = K2(**a, g=g, act=act, sigmoid_out=sig)
                again = K2(**a, g=g, act=act, sigmoid_out=sig)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"K2 {what}: two launches differ")
                ref = sd.spatial_decoder_bwd_plain(**a, g=g, act=act,
                                                   sigmoid_out=sig)
                errs2.append(check_grads(f"K2 {tag} {what}", got, ref,
                                         per_sample=per_sample, rel=grad_rel))
                log(f"  K2 {tag} vs plain {what}: max abs err "
                    f"{errs2[-1]:.3e} ({rel_to_max(got, ref):.1e} of the "
                    f"largest entry), bitwise equal across launches")
            if C != 1 and (D, C, H) != (2, 3, 256):
                continue
            # K3 on the same inputs with one channel
            a["wout"], a["bout"] = a["wout"][:, :1].contiguous(), a["bout"][:1]
            x = torch.as_tensor(rng.uniform(0, 1, (B, N)), dtype=torch.float32,
                                device=dev)
            w = torch.as_tensor(rng.uniform(0, 1, B), dtype=torch.float32,
                                device=dev)
            if near is not None:
                x[near] = sd.spatial_decoder_plain(**a, act=act)[near]
            args = (a["grid"], a["phi"], a["dx"], a["sc"], a["z"], x, w,
                    a["Wc"], a["bc"], a["Wz"], a["hw"], a["hb"], a["wout"],
                    a["bout"])
            with case():
                loss, grads = K3(*args, act=act)
                loss2, grads2 = K3(*args, act=act)
                torch.cuda.synchronize()
                if not (torch.equal(loss, loss2) and all(
                        torch.equal(p, q) for p, q in zip(grads, grads2))):
                    raise AssertionError(f"K3 {what}: two launches differ")
                ref_loss, ref = sd.recon_loss_plain(*args, act=act)
                rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
                if not rel <= LOSS_RTOL:
                    raise AssertionError(f"K3 {what}: loss rel err {rel:.3e}")
                errs3.append(check_grads(f"K3 {tag} {what}", grads, ref,
                                         per_sample=per_sample, rel=grad_rel))
                log(f"  K3 {tag} vs plain D={D} C=1 H={H} act={act:<11} B={B} "
                    f"N={N} L={L} layers={nl}: loss rel err {rel:.3e}, grads "
                    f"max abs err {errs3[-1]:.3e} ({rel_to_max(grads, ref):.1e}"
                    f" of the largest entry), bitwise equal")
    return max(errs2), max(errs3)


def reset_counts():
    for k in KERNELS:
        for source in k.launches:
            k.launches[source] = 0


def counts():
    """Launches of each kernel since the last reset: K1, K2 and K3 are the
    f32 kernels, K1_bf16, K2_bf16 and K3_bf16 the tensor-core ones."""
    out = {}
    for name, k, sources in (("K1", K1, sd.FWD_SOURCES),
                             ("K2", K2, sd.BWD_SOURCES),
                             ("K3", K3, sd.BWD_SOURCES)):
        out[name] = k.launches[sources[False]]
        out[name + "_bf16"] = k.launches[sources[True]]
    return out


def only(launches, **expected):
    """True when ``launches`` (from :func:`counts`) holds the ``expected``
    counts and no other launch."""
    return launches == {**dict.fromkeys(launches, 0), **expected}


def first_step_grads(model, x, eps):
    """Every parameter grad of one weighted loss on batch ``x``."""
    model.nets.zero_grad(set_to_none=True)
    w = torch.ones(x.shape[0], device="cuda")
    loss = model.weighted_loss_fn(x, None, w, 1.0, eps=eps)
    loss.backward()
    grads = [p.grad.detach().clone() for p in model.nets.parameters()]
    model.nets.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_training(module_run=None):
    """Phase 5, under the current flag: the flagship trains 3 epochs
    through fit, against the module path (f32; trained once, then passed
    back in as ``module_run``); then one-pass training."""
    on = sd.BF16_MATMUL
    k1, k2, k3 = ("K1_bf16", "K2_bf16", "K3_bf16") if on else ("K1", "K2", "K3")
    tag = "bf16" if on else "f32"
    grad_rel = BF16_MODULE_GRAD_REL if on else GRAD_RTOL
    loss_rtol = BF16_MODULE_LOSS_RTOL if on else LOSS_RTOL
    epoch_rtol = BF16_EPOCH_RTOL if on else EPOCH_RTOL
    kw = dict(latent_dim=2, invariances=["r"], seed=0)
    X = blobs(10000, (28, 28), seed=1)
    model = iVAE((28, 28), **kw)
    module = iVAE((28, 28), fused=False, **kw)
    if not model._fused or module._fused:
        raise AssertionError("flagship training is not routed as configured")
    gen = torch.Generator(device="cuda").manual_seed(3)
    eps = torch.randn(200, model.z_dim, generator=gen, device="cuda")
    xb = torch.as_tensor(X[:200], device="cuda")
    loss_k, grads_k = first_step_grads(model, xb, eps)
    loss_m, grads_m = first_step_grads(module, xb, eps)
    names = [n for n, _ in model.nets.named_parameters()]
    step_err = check_grads(f"{tag} first step, kernel vs module path",
                           grads_k, grads_m, names, per_sample=0,
                           rel=grad_rel)
    if abs(loss_k - loss_m) > loss_rtol * abs(loss_m):
        raise AssertionError(f"first step loss {loss_k} vs {loss_m}")
    log(f"  {tag} first step, kernel path vs module path: loss "
        f"{loss_k:.4f} vs {loss_m:.4f}, grads max abs err {step_err:.3e} "
        f"({rel_to_max(grads_k, grads_m):.1e} of the largest entry)")

    reset_counts()  # the training path starts here
    t0 = time.perf_counter()
    trainer = model.fit(X, epochs=3, batch_size=200)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_counts = counts()  # the training path ends here
    steps = 3 * 50
    log(f"  {tag} fit(epochs=3, batch_size=200) on 10,000 images: "
        f"{fit_s:.2f} s, launches {train_counts}")
    if not only(train_counts, **{k1: steps, k2: steps}):
        raise AssertionError(f"expected {k1} and {k2} once per step: "
                             f"{train_counts}")
    hist = trainer.loss_history["training_loss"]
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"loss is not finite and falling: {hist}")
    if module_run is None:
        module_trainer = module.fit(X, epochs=3, batch_size=200)
        hist_m = module_trainer.loss_history["training_loss"]
    else:
        hist_m = module_run["module_loss_history"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist, hist_m))
    log(f"  {tag} per-epoch losses, kernel path {hist}, module path "
        f"{hist_m}: max rel diff {rel:.3e}")
    if not rel <= epoch_rtol:
        raise AssertionError(f"per-epoch losses differ by {rel:.3e}")
    if on:  # the trained model's grads against the plain versions'
        loss_t, grads_t = first_step_grads(model, xb, eps)
        with plain_versions():
            loss_p, grads_p = first_step_grads(model, xb, eps)
        trained_err = check_grads(f"{tag} trained model, kernel path vs plain "
                                  f"versions", grads_t, grads_p, names,
                                  per_sample=0, rel=BF16_GRAD_REL)
        if abs(loss_t - loss_p) > LOSS_RTOL * abs(loss_p):
            raise AssertionError(f"trained model loss {loss_t} vs {loss_p}")
        log(f"  {tag} trained model, kernel path vs plain versions on the "
            f"card: loss {loss_t:.4f} vs {loss_p:.4f}, grads max abs err "
            f"{trained_err:.3e} ({rel_to_max(grads_t, grads_p):.1e} of the "
            f"largest entry)")

    # one-pass training: K3 once per step, no K1 or K2
    one = iVAE((28, 28), one_pass_train=True, **kw)
    loss_1, grads_1 = first_step_grads(one, xb, eps)
    one_err = check_grads(f"{tag} first step, one-pass vs module path",
                          grads_1, grads_m, names, per_sample=0, rel=grad_rel)
    if abs(loss_1 - loss_m) > loss_rtol * abs(loss_m):
        raise AssertionError(f"one-pass first step loss {loss_1} vs {loss_m}")
    loader = init_dataloader(X[:2000], batch_size=200)
    one_trainer = SVItrainer(one)
    reset_counts()  # the one-pass path starts here
    one_loss = one_trainer.train(loader)
    torch.cuda.synchronize()
    one_counts = counts()  # the one-pass path ends here
    log(f"  {tag} one_pass_train: 10 steps, loss {one_loss:.4f}, launches "
        f"{one_counts}; first step vs module path: loss {loss_1:.4f}, grads "
        f"max abs err {one_err:.3e}")
    if not only(one_counts, **{k3: 10}) or not np.isfinite(one_loss):
        raise AssertionError(f"one-pass training: {one_counts}, {one_loss}")

    # times: the step (host clock) and an epoch's steps/s
    times = {}
    runs = (("kernel", model), ("one_pass", one))
    if module_run is None:
        runs += (("module", module),)
    for name, m in runs:
        tr = SVItrainer(m)
        ld = init_dataloader(X, batch_size=200)
        w = torch.ones(200, device="cuda")
        step = host_ms(lambda: tr.train_step((xb,), w), reps=30, warmup=5)
        tr.train(ld)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(ld)
        epoch_s = time.perf_counter() - t0
        times[name] = {"step_ms": step, "steps_per_s": 50 / epoch_s}
    if module_run is not None:
        times["module"] = module_run["times"]["module"]
    log(f"  {tag} training step (host clock, median of 30) and steps/s over "
        f"a 50-step epoch: {json.dumps(times)}")
    return {"fit_s": fit_s, "train_launches": train_counts,
            "one_pass_launches": one_counts, "loss_history": hist,
            "module_loss_history": hist_m, "times": times,
            "max_err": max(step_err, one_err), "model": model, "xb": xb,
            "eps": eps}


def phase_large_grid_training():
    """Phase 5, large grid, under the current flag: the 128x128 iVAE
    (bench.py's large-grid model) trains 32 steps at batch 64 through fit;
    under the default flag, its step time and the device's share of it."""
    on = sd.BF16_MATMUL
    k1, k2 = ("K1_bf16", "K2_bf16") if on else ("K1", "K2")
    tag = "bf16" if on else "f32"
    X = blobs(1024, (128, 128), seed=4)
    model = iVAE((128, 128), latent_dim=2, invariances=["r"], seed=0)
    if not model._fused:
        raise AssertionError("the large grid is not routed to the kernels")
    reset_counts()  # the large-grid training path starts here
    t0 = time.perf_counter()
    trainer = model.fit(X, epochs=2, batch_size=64)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counts()  # the large-grid training path ends here
    hist = trainer.loss_history["training_loss"]
    log(f"  {tag} large grid fit(epochs=2, batch_size=64) on 1,024 images: "
        f"{fit_s:.2f} s, launches {launches}, losses {hist}")
    if not only(launches, **{k1: 32, k2: 32}):
        raise AssertionError(f"expected {k1} and {k2} once per step: "
                             f"{launches}")
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"loss is not finite and falling: {hist}")
    if not on:
        return {"fit_s": fit_s, "launches": launches, "loss_history": hist}
    xb = torch.as_tensor(X[:64], device="cuda")
    tr = SVItrainer(model)
    w = torch.ones(64, device="cuda")
    step = host_ms(lambda: tr.train_step((xb,), w), reps=20, warmup=3)
    breakdown = step_breakdown(model, xb)
    log(f"  large grid training step: {step:.3f} ms (host clock, median of "
        f"20); breakdown (torch.profiler, 10 steps): {json.dumps(breakdown)}")
    return {"fit_s": fit_s, "launches": launches, "loss_history": hist,
            "step_ms": step, "step_breakdown": breakdown}


def step_breakdown(model, xb):
    """Device time of one training step by kernel family (K2: K2 or K3's
    kernels, f32 or tensor-core, with their prep and reductions), from a
    torch.profiler trace of 10 steps, against the step's wall time under
    the profiler (which slows the host: compare the device time with the
    unprofiled step time too)."""
    trainer = SVItrainer(model)
    w = torch.ones(xb.shape[0], device="cuda")
    for _ in range(5):
        trainer.train_step((xb,), w)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            trainer.train_step((xb,), w)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 10
    buckets = {"K1": 0.0, "K2": 0.0, "Adam": 0.0, "gemm": 0.0, "other": 0.0}
    launches = {k: 0 for k in buckets}
    top = []
    for ev in prof.key_averages():
        # kernels only: an operator's entry, or a range annotated on the
        # device ("Optimizer.step#Adam.step"), repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA or "#" in ev.key:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        top.append((t / 1e3 / 10, ev.count / 10, ev.key[:80]))
        name = ev.key.lower()
        key = ("K1" if "sdec_fwd" in name else
               "K2" if "sdec_bwd" in name or "sdec_tc" in name else
               "Adam" if "adam" in name or "multi_tensor" in name else
               "gemm" if "gemm" in name or "sm90" in name or "cutlass" in name
               else "other")
        buckets[key] += t / 1e3 / 10  # us -> ms per step
        launches[key] += ev.count / 10
    device_ms = sum(buckets.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms, "by_family_ms": buckets,
            "kernels_per_step": launches,
            "top_kernels_ms_per_step": sorted(top, reverse=True)[:12]}


def time_k1(name, a, peaks):
    """K1 under each flag at one shape of the paths: held against its plain
    version and a second launch, then timed beside the least time the card
    could take, its plain version and cuBLAS's bare products of the same
    hidden layers. Returns one row per flag, keyed by the flag."""
    B, N = a["z"].shape[0], a["grid"].shape[0]
    H, nl = a["Wc"].shape[1], a["hw"].shape[0]
    label = f"{name} B={B} N={N}"
    flops, nbytes = work(a)
    b32, b16, by32, by16 = bounds(flops, nbytes, peaks)
    h32 = torch.randn(B * N, H, device="cuda")
    w32 = a["hw"]
    lib = {}
    for dtype in (torch.float32, torch.bfloat16):
        hh, ww = h32.to(dtype), w32.to(dtype)
        # h_l W_l of every layer as bare products, in and out dtype
        lib[dtype] = cuda_ms(lambda: [torch.matmul(hh, ww[i])
                                      for i in range(nl)], reps=20)
        del hh, ww
    del h32
    rows = {}
    for on in (False, True):
        tag = "bf16" if on else "f32"
        with bf16_matmul(on):
            out, again = K1(**a), K1(**a)
            ref = sd.spatial_decoder_plain(**a)
            torch.cuda.synchronize()
            what = f"K1 {tag} {label}"
            if not torch.equal(out, again):
                raise AssertionError(f"{what}: two launches differ")
            err = check_close(what, out, ref,
                              *((BF16_ATOL, BF16_OUT_REL) if on
                                else (ATOL, 0.0)))
            del out, again, ref
            k_ms = cuda_ms(lambda: K1(**a))
            q_ms = cuda_ms_queued(lambda: K1(**a))
            p_ms = cuda_ms(lambda: sd.spatial_decoder_plain(**a), reps=20)
        lib_ms = lib[torch.bfloat16 if on else torch.float32]
        rows[on] = {
            "shape": label, "flag": tag, "ms": k_ms, "queued_ms": q_ms,
            "plain_ms": p_ms, "max_abs_err": err,
            "bound_ms": b16 if on else b32, "bound_by": by16 if on else by32,
            "bound_ms_f32": b32, "bound_ms_bf16": b16, "library_ms": lib_ms,
            "flops": flops, "bytes": nbytes, "tflops": flops / k_ms / 1e9}
        log(f"  {what}: kernel {k_ms:.4f} ms (back to back {q_ms:.4f} ms), "
            f"plain {p_ms:.4f} ms, bound f32 {b32:.4f} ms, bound bf16 "
            f"{b16:.4f} ms, cuBLAS {tag} hidden products {lib_ms:.4f} ms, "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s, max abs err vs plain "
            f"{err:.3e}, bitwise equal across launches")
    log(f"  K1 {label}: tensor-core kernel faster than the f32 one: "
        f"{rows[True]['ms'] < rows[False]['ms']}")
    return rows


def time_bwd(name, a, xf, gen, peaks, with_k3=True):
    """K2 (and K3 when ``with_k3``; ``xf`` its observations), f32 and
    tensor-core, at one training shape: held against their plain versions
    and a second launch, then timed beside the least time the card could
    take and cuBLAS's time for their hidden products (bf16, and f32 with
    TF32 off). Every grad is held to its tensor's largest entry. Returns
    one row per (kernel, flag)."""
    B, N = a["z"].shape[0], a["grid"].shape[0]
    L, H, nl = a["z"].shape[1], a["Wc"].shape[1], a["hw"].shape[0]
    label = f"{name} B={B} N={N} H={H}"
    g = torch.randn(B, N, generator=gen, device="cuda")
    w = torch.ones(B, device="cuda")
    args3 = (a["grid"], a["phi"], a["dx"], a["sc"], a["z"], xf, w, a["Wc"],
             a["bc"], a["Wz"], a["hw"], a["hb"], a["wout"], a["bout"])
    req = {k: v.clone().requires_grad_(k != "grid") for k, v in a.items()}
    lib = {}
    for on, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        hm = torch.randn(B * N, H, generator=gen, device="cuda").to(dtype)
        dm = torch.randn(B * N, H, generator=gen, device="cuda").to(dtype)
        wm = a["hw"].to(dtype)

        def cublas():  # h W, h^T d and d W^T of every layer, in and out
            for i in range(nl):  # the dtype
                torch.matmul(hm, wm[i])
                torch.matmul(hm.T, dm)
                torch.matmul(dm, wm[i].T)

        lib[on] = cuda_ms(cublas, reps=20)
        del hm, dm

    def autograd_plain():
        out = sd.spatial_decoder_plain(**req)
        return torch.autograd.grad(out, [req[k] for k in GRAD_NAMES], g)

    kernels = [("K2", lambda: K2(**a, g=g),
                lambda: sd.spatial_decoder_bwd_plain(**a, g=g), False)]
    if with_k3:
        kernels.append(("K3", lambda: K3(*args3),
                        lambda: sd.recon_loss_plain(*args3), True))
    rows = {}
    for on in (False, True):
        tag = "bf16" if on else "f32"
        with bf16_matmul(on):
            for kname, fn, plain_fn, loss_mode in kernels:
                got, again, ref = fn(), fn(), plain_fn()
                torch.cuda.synchronize()
                what = f"{kname} {tag} {label}"
                if loss_mode:
                    (loss, got), (loss2, again), (ref_loss, ref) = (
                        got, again, ref)
                    rel = abs(loss.item() - ref_loss.item()) / abs(
                        ref_loss.item())
                    if not (torch.equal(loss, loss2) and rel <= LOSS_RTOL):
                        raise AssertionError(f"{what}: loss {loss.item()} and "
                                             f"{loss2.item()} vs plain "
                                             f"{ref_loss.item()}")
                if not all(torch.equal(p, q) for p, q in zip(got, again)):
                    raise AssertionError(f"{what}: two launches differ")
                err = check_grads(what, got, ref, per_sample=0,
                                  rel=BF16_GRAD_REL if on else GRAD_RTOL)
                log(f"  {what} vs plain: grads max abs err {err:.3e} "
                    f"({rel_to_max(got, ref):.1e} of the largest entry)"
                    + (f", loss rel err {rel:.3e}" if loss_mode else "")
                    + ", bitwise equal across launches")
                del got, again, ref
                ws_bytes, blocks = sd.bwd_workspace(B, N, 2, L, H, nl, 1,
                                                    "tanh", loss_mode)
                flops, nbytes = work_bwd(a, loss_mode)
                k_ms = cuda_ms(fn, reps=20)
                p_ms = cuda_ms(plain_fn, reps=10)
                b32, b16, by32, by16 = bounds(flops, nbytes, peaks)
                row = {"shape": label, "flag": tag, "ms": k_ms,
                       "plain_ms": p_ms, "max_abs_err": err,
                       "bound_ms": b16 if on else b32,
                       "bound_by": by16 if on else by32,
                       "bound_ms_f32": b32, "bound_ms_bf16": b16,
                       "library_ms": lib[on], "flops": flops,
                       "bytes": nbytes, "tflops": flops / k_ms / 1e9,
                       "workspace_bytes": ws_bytes, "blocks": blocks}
                if not on and not loss_mode:
                    row["autograd_plain_ms"] = cuda_ms(autograd_plain,
                                                       reps=10)
                rows[kname, on] = row
                log(f"  {kname} {tag} {label}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms"
                    + ("" if "autograd_plain_ms" not in row else
                       f", autograd of the plain forward "
                       f"{row['autograd_plain_ms']:.4f} ms")
                    + f", bound f32 {b32:.4f} ms, bound bf16 {b16:.4f} ms"
                    f", cuBLAS {tag} hidden products {lib[on]:.4f} ms, "
                    f"{row['tflops']:.2f} TFLOP/s, {blocks} blocks, "
                    f"workspace {ws_bytes / 2 ** 20:.1f} MiB")
    return rows


# Phase 7: the discrete-latent and semi-supervised families at the width
# of benchmarks/enum_bench.py:31-35, 68-74: latent 2, rotation, 10 classes,
# hidden (128, 128), tanh, Bernoulli, batch 200.
FAMILY = dict(latent_dim=2, invariances=["r"], seed=0)
FAMILY_DIM = (28, 28)
N_CLASSES = 10


def family_data():
    """Phase 7's data: 2,000 blob images, each with the class of its x
    centre (ten equal bins) and the centre itself as a continuous label."""
    X, cx = blobs(2000, FAMILY_DIM, seed=6, centers=True)
    y = np.digitize(cx, np.linspace(-0.4, 0.4, N_CLASSES + 1)[1:-1])
    return X, y, cx


def run_path(fn):
    """``fn()`` as one path: the counts set to 0 just before it and read
    just after. Returns (its result, seconds, the path's launches)."""
    reset_counts()  # the path starts here
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, counts()  # the path ends here


def expect_steps(what, launches, steps):
    """One K1 and one K2 per training step, from the flag's sources only."""
    k1, k2 = ("K1_bf16", "K2_bf16") if sd.BF16_MATMUL else ("K1", "K2")
    if not only(launches, **{k1: steps, k2: steps}):
        raise AssertionError(f"{what}: expected {k1} and {k2} once per step "
                             f"({steps} steps): {launches}")
    log(f"  {what}: launches {launches}")


def first_step_vs_module(what, model, module, xb, eps):
    """One step's loss and grads, kernel path against the module path
    (f32), with phase 5's tolerances for the flag."""
    on = sd.BF16_MATMUL
    loss_k, grads_k = first_step_grads(model, xb, eps)
    loss_m, grads_m = first_step_grads(module, xb, eps)
    names = [n for n, _ in model.nets.named_parameters()]
    err = check_grads(f"{what} first step, kernel vs module path", grads_k,
                      grads_m, names, per_sample=0,
                      rel=BF16_MODULE_GRAD_REL if on else GRAD_RTOL)
    loss_rtol = BF16_MODULE_LOSS_RTOL if on else LOSS_RTOL
    if abs(loss_k - loss_m) > loss_rtol * abs(loss_m):
        raise AssertionError(f"{what} first step loss {loss_k} vs {loss_m}")
    log(f"  {what} first step, kernel path vs module path: loss "
        f"{loss_k:.4f} vs {loss_m:.4f}, grads max abs err {err:.3e} "
        f"({rel_to_max(grads_k, grads_m):.1e} of the largest entry)")
    return err


def check_epochs(what, hist, hist_m):
    """Per-epoch losses finite and falling, and within phase 5's tolerance
    for the flag of the module path's."""
    rtol = BF16_EPOCH_RTOL if sd.BF16_MATMUL else EPOCH_RTOL
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"{what}: loss is not finite and falling: {hist}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist, hist_m))
    log(f"  {what} per-epoch losses, kernel path {hist}, module path "
        f"{hist_m}: max rel diff {rel:.3e}")
    if not rel <= rtol:
        raise AssertionError(f"{what}: per-epoch losses differ by {rel:.3e}")


def check_decode(what, model, z, out, pose):
    """A posed decode of decoder inputs ``z`` against the plain version on
    the same inputs, with phase 2's tolerance for the flag."""
    atol, rel = (BF16_ATOL, BF16_OUT_REL) if sd.BF16_MATMUL else (ATOL, 0.0)
    with torch.no_grad():
        ref = sd.spatial_decoder_plain(**kernel_args(
            model.decoder_net, model.grid, z, **pose))
    return check_close(what, out.reshape(z.shape[0], -1), ref, atol, rel)


def served(model, name):
    """``model`` exported and served from the archive alone."""
    with tempfile.TemporaryDirectory() as tmp:
        export_model(model, f"{tmp}/{name}.npz")
        return ServedModel(f"{tmp}/{name}.npz")


def phase_families(data, module_runs):
    """Phase 7, under the current flag: jiVAE, ssiVAE and ss_reg_iVAE at
    full width train and serve, each path counted alone. ``module_runs``
    holds the module path's per-epoch losses (f32; trained on the first
    call, then reused)."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    k1 = "K1_bf16" if on else "K1"
    X, y, cx = data
    gen = torch.Generator(device="cuda").manual_seed(7)
    xb = torch.as_tensor(X[:200], device="cuda")
    xs = X[:1000]
    rng = np.random.default_rng(8)
    zc = torch.as_tensor(rng.normal(size=(1024, 2)), dtype=torch.float32,
                         device="cuda")
    y1h = to_onehot(rng.integers(0, N_CLASSES, 1024), N_CLASSES, "cuda")
    zy = torch.cat([zc, y1h], -1)
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    launches, fit_s, hists = {}, {}, {}
    # K1 against its plain version; first steps against the module path
    errs1, errs2 = [0.0], []

    # jiVAE: 2 epochs of 2,000 images at batch 200 through fit; each step
    # decodes K*B = 2,000 rows at L = 12
    kw = dict(FAMILY, discrete_dim=N_CLASSES)
    jm, jmod = jiVAE(FAMILY_DIM, **kw), jiVAE(FAMILY_DIM, fused=False, **kw)
    if not jm._fused or jmod._fused:
        raise AssertionError("jiVAE is not routed as configured")
    eps = torch.randn(200, jm.z_dim, generator=gen, device="cuda")
    errs2.append(first_step_vs_module(f"{tag} jiVAE", jm, jmod, xb, eps))
    tr, fit_s["jivae"], launches["jivae_training"] = run_path(
        lambda: jm.fit(X, epochs=2, batch_size=200))
    expect_steps(f"{tag} jiVAE fit(epochs=2, batch_size=200) on 2,000 "
                 f"images, {fit_s['jivae']:.2f} s", launches["jivae_training"],
                 20)
    if "jivae" not in module_runs:
        module_runs["jivae"] = jmod.fit(
            X, epochs=2, batch_size=200).loss_history["training_loss"]
    hists["jivae"] = tr.loss_history["training_loss"]
    check_epochs(f"{tag} jiVAE", hists["jivae"], module_runs["jivae"])

    # enum_topk=3: five steps of K*B = 600 rows
    top = jiVAE(FAMILY_DIM, enum_topk=3, **kw)
    topm = jiVAE(FAMILY_DIM, enum_topk=3, fused=False, **kw)
    errs2.append(first_step_vs_module(f"{tag} jiVAE enum_topk=3", top, topm,
                                     xb, eps))
    loader = init_dataloader(X[:1000], batch_size=200)
    loss, _, launches["jivae_topk_training"] = run_path(
        lambda: SVItrainer(top).train(loader))
    expect_steps(f"{tag} jiVAE enum_topk=3, 5 steps, loss {loss:.4f}",
                 launches["jivae_topk_training"], 5)
    if not np.isfinite(loss):
        raise AssertionError(f"enum_topk=3 loss {loss}")

    # jiVAE serving: the model's encode, posed decode and manifold2d, and
    # the export's encode and decode
    sj = served(jm, "jivae")
    out, _, launches["jivae_serving"] = run_path(lambda: {
        "encode": jm.encode(xs, logits=True),
        "decode": jm.decode(zc, y1h, **pose),
        "manifold2d": jm.manifold2d(10, disc_idx=3),
        "served_encode": sj.encode(xs),
        "served_decode": sj.decode(zy, **pose)})
    log(f"  {tag} jiVAE serving: launches {launches['jivae_serving']}")
    if not only(launches["jivae_serving"], **{k1: 3}):
        raise AssertionError("jiVAE serving: expected K1 once per decode")
    loc, scale, probs = out["encode"]
    if (loc.shape != (1000, 3) or probs.shape != (1000, N_CLASSES)
            or not bool((scale > 0).all())):
        raise AssertionError("jiVAE encode: bad shapes or non-positive sigma")
    for o, r in zip(out["served_encode"], out["encode"]):
        check_close(f"{tag} served jiVAE encode", o, r)
    errs1.append(check_decode(f"{tag} jiVAE decode", jm, zy, out["decode"],
                             pose))
    check_close(f"{tag} served jiVAE decode", out["served_decode"],
                out["decode"])
    man = out["manifold2d"]
    if man.shape != (100,) + FAMILY_DIM or not torch.isfinite(man).all():
        raise AssertionError("jiVAE manifold2d: bad shape or values")

    # ssiVAE: 2,000 unlabeled and 400 labeled images at batch 200 through
    # fit, its accuracy on the labeled set after each epoch; an unlabeled
    # step decodes [10, 200] rows, a labeled one 200
    kw = dict(FAMILY, num_classes=N_CLASSES)
    sm, smod = ssiVAE(FAMILY_DIM, **kw), ssiVAE(FAMILY_DIM, fused=False, **kw)
    (shape,) = sm.noise_shapes(200)
    eps_u = torch.randn(shape, generator=gen, device="cuda")
    errs2.append(first_step_vs_module(f"{tag} ssiVAE unlabeled", sm, smod, xb,
                                     eps_u))
    labeled = (X[:400], y[:400])
    tr, fit_s["ssivae"], launches["ssivae_training"] = run_path(
        lambda: sm.fit(X, labeled, epochs=2, batch_size=200))
    acc = tr.history["test"]
    expect_steps(f"{tag} ssiVAE fit(epochs=2, batch_size=200), "
                 f"{fit_s['ssivae']:.2f} s, accuracy {acc}",
                 launches["ssivae_training"], 24)
    if len(acc) != 2 or not all(0.0 <= a <= 1.0 for a in acc):
        raise AssertionError(f"ssiVAE accuracy {acc}")
    if "ssivae" not in module_runs:
        module_runs["ssivae"] = smod.fit(
            X, labeled, epochs=2, batch_size=200).history["training_loss"]
    hists["ssivae"] = tr.history["training_loss"]
    check_epochs(f"{tag} ssiVAE", hists["ssivae"], module_runs["ssivae"])

    # ssiVAE served: classify, the auto-labelled encode, posed decode
    ss = served(sm, "ssivae")
    out, _, launches["ssivae_serving"] = run_path(lambda: {
        "classify": ss.classify(xs), "encode": ss.encode(xs),
        "decode": ss.decode(zy, **pose),
        "model_decode": sm.decode(zc, y1h, **pose)})
    log(f"  {tag} ssiVAE serving: launches {launches['ssivae_serving']}")
    if not only(launches["ssivae_serving"], **{k1: 2}):
        raise AssertionError("ssiVAE serving: expected K1 once per decode")
    check_close(f"{tag} served ssiVAE classify", out["classify"],
                sm.guide_probs(xs))
    for o, r in zip(out["encode"], sm.encode(xs)):
        check_close(f"{tag} served ssiVAE encode", o, r)
    errs1.append(check_decode(f"{tag} ssiVAE decode", sm, zy, out["decode"],
                             pose))
    check_close(f"{tag} served ssiVAE decode", out["decode"],
                out["model_decode"])

    # ss_reg_iVAE: two trainer steps (epochs) of 600 unlabeled and 200
    # labeled images at batch 200, B = 200 rows at L = 3
    kw = dict(FAMILY, reg_dim=1)
    rm, rmod = ss_reg_iVAE(FAMILY_DIM, **kw), ss_reg_iVAE(
        FAMILY_DIM, fused=False, **kw)
    eps_r = tuple(torch.randn(s, generator=gen, device="cuda")
                  for s in rm.noise_shapes(200))
    errs2.append(first_step_vs_module(f"{tag} ss_reg_iVAE unlabeled", rm, rmod,
                                     xb, eps_r))
    loaders = init_ssvae_dataloaders(X[:600], (X[:200], cx[:200]),
                                     (X[200:400], cx[200:400]),
                                     batch_size=200)
    rt = auxSVItrainer(rm)

    def two_steps():
        for _ in range(2):
            rt.step(*loaders)

    _, fit_s["ss_reg"], launches["ss_reg_training"] = run_path(two_steps)
    mse = rt.history["test"]
    hists["ss_reg"] = rt.history["training_loss"]
    expect_steps(f"{tag} ss_reg_iVAE 2 steps, losses {hists['ss_reg']}, "
                 f"MSE {mse}", launches["ss_reg_training"], 8)
    if not all(np.isfinite(hists["ss_reg"] + mse)):
        raise AssertionError("ss_reg_iVAE: non-finite loss or MSE")
    return {"launches": launches, "fit_s": fit_s, "loss_history": hists,
            "ssivae_accuracy": acc, "ss_reg_mse": mse,
            "module_loss_history": dict(module_runs), "k1_err": max(errs1),
            "first_step_err": max(errs2),
            "jivae": jm, "xb": xb}


def enum_args(model, xb, eps):
    """K1/K2 inputs of a jiVAE training step's enumerated decode of images
    ``xb`` with latent noise ``eps``: every class's one-hot code beside the
    shared z, K*B rows (detached weights)."""
    with torch.no_grad():
        B, K = xb.shape[0], model.discrete_dim
        mu, sig, _ = model.encoder_net(xb.reshape(B, -1))
        phi, dx, sc, zc = model.split_latent_full(mu + sig * eps)
        codes = torch.eye(K, device=xb.device)[:, None, :].expand(K, B, K)
        z = torch.cat([zc.expand((K,) + zc.shape), codes], -1)
        a = dict(grid=model.grid, phi=phi.repeat(K), dx=dx.repeat(K, 1),
                 sc=sc.repeat(K), z=z.reshape(K * B, -1).contiguous())
        a.update(zip(("Wc", "bc", "Wz", "hw", "hb", "wout", "bout"),
                     (t.detach() for t in
                      sd.padded_sdecoder_weights(model.decoder_net))))
    return a


def step_report(model, X):
    """Training steps of ``model`` at batch 200 of images ``X``: one step
    alone (host clock from a synchronized start to the step's end, median
    of 20), the steps of 3 epochs back to back (the host queues a step
    while the device runs the last, as in ``fit``), the card's clock,
    power draw and temperature right after, the profiler's breakdown of 10
    steps, and the device's idle share of each."""
    xb = torch.as_tensor(X[:200], device="cuda")
    tr = SVItrainer(model)
    w = torch.ones(xb.shape[0], device="cuda")
    step = host_ms(lambda: tr.train_step((xb,), w), reps=20, warmup=3)
    loader = init_dataloader(X, batch_size=200)
    tr.train(loader)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        tr.train(loader)
    queued = 1e3 * (time.perf_counter() - t0) / (3 * len(loader))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    breakdown = step_breakdown(model, xb)
    device = breakdown["device_ms"]
    return {"step_ms": step, "epoch_step_ms": queued,
            "clocks_power_temp": smi, "idle_share": 1.0 - device / step,
            "epoch_idle_share": 1.0 - device / queued,
            "breakdown": breakdown}


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
    peaks = card_peaks(smi)
    t0 = time.perf_counter()
    _build.load_all(list(SOURCES))
    log(f"phase 1: built {', '.join(SOURCES)} (one nvcc each, together) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        log(_build.build_log(name).strip())

    # -- 2. kernels vs plain, under each flag ------------------------------
    log("phase 2: kernels vs plain")
    errs = {}
    for on in (False, True):
        with bf16_matmul(on):
            log(f"  BF16_MATMUL = {on}")
            k1 = phase_k1_vs_plain(dev)
            if not on:  # the module path is f32
                k1 = max(k1, phase_padded_model())
            k2, k3 = phase_k2_k3_vs_plain(dev)
            errs[on] = {"K1": k1, "K2": k2, "K3": k3}
    if not sd.BF16_MATMUL:
        raise AssertionError("the port's default is BF16_MATMUL = True")

    # -- 3. serving at full width (flagship); 4. large grid ---------------
    log("phases 3 and 4: flagship iVAE served, large-grid decode")
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    module = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0,
                  fused=False)
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

    def score():
        with torch.no_grad():
            return model.loss_fn(x[:200], eps=eps)

    requests = {  # phase 3, then phase 4 (the large grid)
        "encode_1000": lambda: served.encode(x[:1000]),
        "reconstruct_200": lambda: model.reconstruct(x[:200]),
        "posed_decode_1024": lambda: served.decode(z_req, **pose),
        "manifold2d_32": lambda: model.manifold2d(32),
        "ragged_decode_2500": lambda: served.decode(z_rag),
        "loss_fn_200": score,
        "large_grid_decode_64": lambda: big.decode(z_big, **pose),
    }
    def serve():
        """Every request once under the current flag: the outputs, K1's
        launches per request and the path's counts."""
        outputs, per_request = {}, {}
        reset_counts()  # the serving path starts here
        for name, request in requests.items():
            before = sum(K1.launches.values())
            outputs[name] = request()
            per_request[name] = sum(K1.launches.values()) - before
        torch.cuda.synchronize()
        return outputs, per_request, counts()  # the serving path ends here

    outputs, launches, serve_counts = serve()
    log(f"  launches on the serving path: {serve_counts} {launches}")
    if (not only(serve_counts, K1_bf16=serve_counts["K1_bf16"])
            or launches["posed_decode_1024"] == 0):
        raise AssertionError("the serving path did not launch the "
                             "tensor-core K1 alone")
    with bf16_matmul(False):
        _, launches32, serve_counts32 = serve()
    log(f"  f32 launches on the serving path: {serve_counts32} {launches32}")
    if (not only(serve_counts32, K1=serve_counts32["K1"])
            or launches32 != launches):
        raise AssertionError("with the flag clear the serving path did not "
                             "launch the f32 K1 alone")

    # outputs: shapes, finiteness, agreement with plain computations (bf16
    # like the kernel), the ELBO with the module path (f32)
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
        serve_errs = [check_close(name, outputs[name].reshape(rows, -1),
                                  plain(m, z, **p), BF16_ATOL)
                      for name, rows, m, z, p in checks]
        loss_ref = module.loss_fn(x[:200], eps=eps)  # the module path
    loss = outputs["loss_fn_200"]
    if loss.shape != (200,) or not torch.isfinite(loss).all():
        raise AssertionError("loss_fn: bad shape or non-finite values")
    rel = ((loss - loss_ref).abs() / loss_ref.abs()).max().item()
    if not rel <= BF16_MODULE_LOSS_RTOL:
        raise AssertionError(f"loss_fn: max rel err {rel:.3e} > "
                             f"{BF16_MODULE_LOSS_RTOL}")
    log(f"  served outputs match plain: max abs err {max(serve_errs):.3e}, "
        f"loss max rel err against the module path {rel:.3e}")

    # -- 5. training at full width, under each flag; the large grid --------
    log("phase 5: flagship training, large-grid training")
    with bf16_matmul(False):
        train32 = phase_training()
    train = phase_training(module_run=train32)
    large = phase_large_grid_training()
    with bf16_matmul(False):
        large32 = phase_large_grid_training()

    # -- 6. times ----------------------------------------------------------
    log("phase 6: times")
    k1_rows = {False: [], True: []}
    with torch.no_grad():
        for name, m, z in (("flagship", model, z_req),
                           ("flagship", model, z_req[:200]),
                           ("flagship", model, z_rag[2048:]),
                           ("large grid", big, z_big)):
            a = kernel_args(m.decoder_net, m.grid, z.cuda(), **pose)
            for on, row in time_k1(name, a, peaks).items():
                k1_rows[on].append(row)
    # K2 and K3, f32 and tensor-core, at the flagship training shape and
    # the large grid, on the trained models' inputs. A per-sample grad sums
    # up to 16,384 pixels here, so every grad is held to its tensor's
    # largest entry.
    rows = {(k, on): [] for k in ("K2", "K3") for on in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    xl = torch.as_tensor(blobs(64, (128, 128), seed=2), device="cuda")
    for name, m, xx in (("flagship", train["model"], train["xb"]),
                        ("large grid", big, xl)):
        e = torch.randn(xx.shape[0], m.z_dim, generator=gen, device="cuda")
        a, xf = train_args(m, xx, e)
        for key, row in time_bwd(name, a, xf, gen, peaks).items():
            rows[key].append(row)
    request_ms = {name: host_ms(request, reps=30)
                  for name, request in requests.items()}
    log(f"  request latency, ms (host clock, median): {json.dumps(request_ms)}")
    dec = model.decoder_net
    with torch.no_grad():
        weights_ms = {
            "build": host_ms(lambda: sd.padded_sdecoder_weights(dec), reps=30),
            "cached": host_ms(lambda: sd._kernel_weights(dec), reps=30)}
    log(f"  padded decoder weights, ms (host clock, median): "
        f"{json.dumps(weights_ms)}")
    breakdown = {"bf16": step_breakdown(train["model"], train["xb"])}
    with bf16_matmul(False):
        breakdown["f32"] = step_breakdown(train32["model"], train32["xb"])
    log(f"  flagship training step breakdown (torch.profiler, 10 steps): "
        f"{json.dumps(breakdown)}")

    # -- 7. the discrete-latent and semi-supervised families ---------------
    log("phase 7: jiVAE, ssiVAE and ss_reg_iVAE train and serve")
    t7 = time.perf_counter()
    fam_data = family_data()
    module_runs = {}
    with bf16_matmul(False):
        fam32 = phase_families(fam_data, module_runs)
    fam = phase_families(fam_data, module_runs)
    # K1 and K2 at the enumerated decode's shape (B = 2,000, L = 12), on
    # the trained jiVAE's inputs, added to phase 6's table
    e = torch.randn(200, fam["jivae"].z_dim, generator=gen, device="cuda")
    a = enum_args(fam["jivae"], fam["xb"], e)
    with torch.no_grad():
        for on, row in time_k1("jiVAE enumerated L=12", a, peaks).items():
            k1_rows[on].append(row)
    for key, row in time_bwd("jiVAE enumerated L=12", a, None, gen, peaks,
                             with_k3=False).items():
        rows[key].append(row)
    del a
    enum_step = {"bf16": step_report(fam["jivae"], fam_data[0])}
    with bf16_matmul(False):
        enum_step["f32"] = step_report(fam32["jivae"], fam_data[0])
    log(f"  jiVAE enumerated training step: alone and in epochs (host "
        f"clock), breakdown (torch.profiler, 10 steps): "
        f"{json.dumps(enum_step)}")
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s")

    def by_path(key):
        """Launches of one kernel on each path, each counted alone."""
        return {"serving_bf16": serve_counts[key],
                "serving_f32": serve_counts32[key],
                "training_bf16": train["train_launches"][key],
                "one_pass_training_bf16": train["one_pass_launches"][key],
                "training_f32": train32["train_launches"][key],
                "one_pass_training_f32": train32["one_pass_launches"][key],
                "large_grid_training_bf16": large["launches"][key],
                "large_grid_training_f32": large32["launches"][key],
                **{f"{path}_{tag}": n[key]
                   for tag, f in (("bf16", fam), ("f32", fam32))
                   for path, n in f["launches"].items()}}

    def entry(name, source, replaces, key, err, shapes, **more):
        head = shapes[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path(key).values()),
                "launches_by_path": by_path(key), "max_abs_err": err,
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"],
                "bound_ms_bf16": head["bound_ms_bf16"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shapes": shapes,
                **more}

    rows.update({("K1", on): k1_rows[on] for on in (False, True)})

    def shape_errs(kname, on):
        """Phase 6's errors of one kernel at the paths' shapes."""
        return [row["max_abs_err"] for row in rows[kname, bool(on)]]

    csrc = "pyroved_tpu_torch/csrc/"
    bwd, tc = csrc + "spatial_decoder_bwd.cu", csrc + "spatial_decoder_bwd_tc.cu"
    k1_at, k2_at, k3_at = ("pyroved_tpu/ops/spatial_decoder.py:422",
                           "pyroved_tpu/ops/spatial_decoder.py:531",
                           "pyroved_tpu/ops/spatial_decoder.py:1209")
    result = {"kernels": [
        entry("spatial_decoder_fwd", csrc + "spatial_decoder_fwd.cu", k1_at,
              "K1", max(errs[False]["K1"], fam32["k1_err"],
                        *shape_errs("K1", 0)),
              rows["K1", False], launches_per_request=launches32),
        entry("spatial_decoder_fwd_tc", csrc + "spatial_decoder_fwd_tc.cu",
              k1_at, "K1_bf16",
              max(errs[True]["K1"], *serve_errs, fam["k1_err"],
                  *shape_errs("K1", 1)),
              rows["K1", True], launches_per_request=launches,
              request_ms=request_ms, weights_ms=weights_ms),
        entry("spatial_decoder_bwd", bwd, k2_at, "K2",
              max(errs[False]["K2"], train32["max_err"],
                  *shape_errs("K2", 0)),
              rows["K2", False]),
        entry("spatial_decoder_bwd_tc", tc, k2_at, "K2_bf16",
              max(errs[True]["K2"], train["max_err"],
                  *shape_errs("K2", 1)),
              rows["K2", True]),
        entry("bernoulli_recon_loss", bwd, k3_at, "K3",
              max(errs[False]["K3"], *shape_errs("K3", 0)), rows["K3", False]),
        entry("bernoulli_recon_loss_tc", tc, k3_at, "K3_bf16",
              max(errs[True]["K3"], *shape_errs("K3", 1)), rows["K3", True]),
    ], "training": {tag: {k: t[k] for k in (
        "fit_s", "loss_history", "module_loss_history", "times")}
        for tag, t in (("bf16", train), ("f32", train32))},
        "large_grid_training": {"bf16": large, "f32": large32},
        "step_breakdown": breakdown,
        "families": {tag: {k: f[k] for k in (
            "fit_s", "loss_history", "module_loss_history",
            "ssivae_accuracy", "ss_reg_mse", "first_step_err")}
            for tag, f in (("bf16", fam), ("f32", fam32))},
        "enumerated_step": enum_step}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
