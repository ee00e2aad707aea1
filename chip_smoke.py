"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one Hopper GPU:

    python3 chip_smoke.py

Phases, in order (any failure propagates and exits non-zero):

Each phase that runs a decoder kernel runs under the port's
``BF16_MATMUL`` flag: set (the default, as the JAX package's), hidden
products take bf16 operands and every kernel runs on the tensor cores (K1
``spatial_decoder_fwd_tc.cu``, K2/K3 ``spatial_decoder_bwd_tc.cu``);
clear, everything is f32: K1 on the CUDA cores
(``spatial_decoder_fwd.cu``), K2/K3 on the tensor cores with three-limb
bf16 splits (``spatial_decoder_bwd_x3.cu``). Launches are counted by
source.

1. Device and build: prints the card's name and power limit
   (``nvidia-smi``), then builds the four decoder sources from
   ``pyroved_tpu_torch/csrc`` (one nvcc per source, started together) and
   prints the build time and the ptxas report; then starts a child process
   that builds phase 13's sixteen libraries (at low priority, while phases
   2-12 run).
2. Kernels against plain, under each flag: the fused forward K1 against
   ``spatial_decoder_plain`` over D in {1, 2}, C in {1, 3}, the six
   activations, hidden width 128 and 256, ragged B and N, 0 to 5 hidden
   layers for every activation at both widths, one pixel of one sample and
   the large grid, each launched twice to show bitwise-equal outputs; the
   tensor-core K1's tanh over every f32 input against f64 tanh
   (``phase_tanh_probe``); then
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
8. VED and checkpoints. The im2spec VED at the reference notebook's
   width (16x16 images to 2048-long spectra, default filters, lrelu,
   Bernoulli, sigmoid head, seed 0), with cuDNN's TF32 allowed as
   PyTorch's default has it: its first step on the card against the same
   model on the CPU (f32), 3 epochs of 2,000 pairs at batch 100 through
   ``fit`` (``scale_factor=4``), then encode, decode, predict (30
   samples) and manifold2d against the CPU model, and ``export_model``'s
   refusal. The stretch width (256x256 to 2048, batch 16): 8 steps each
   under f32, bf16 towers and f32 with batchnorm, median step time, peak
   memory and a profiler breakdown. Under each flag, a bit-exact resume: the flagship iVAE
   (``SVItrainer``) and ssiVAE at phase 7's width (``auxSVItrainer``)
   train 4 epochs, and again 2, a checkpoint, a fresh model and trainer
   that resume, 2 more: per-epoch history and parameters bitwise equal,
   the resumed epochs one K1 and one K2 per step of the flag's sources.
   Then ``save_weights`` / ``load_weights`` on the card.
9. The trainer surface, under each flag. Out of core
   (``examples/out_of_core_training.py``): 200,000 uniform 28x28 rows in a
   memmap (627 MB, in a temporary directory; 20,000 of them with the flag
   clear) and its uint8 copy; one epoch of the flagship (seed 1, batch
   200) each resident, streamed per batch, in chunks of 64 batches, from
   the uint8 copy (``scale=1/255``) resident and in chunks, and narrowed
   to bfloat16 in chunks: streamed parameters bitwise equal to resident
   ones, steps/s, host-to-device GB/s and the device's idle share. The
   flagship at batch 50 x ``grad_accum=4`` for 2 epochs of 4,000 rotated
   bars (``examples/large_effective_batch.py``): one K1 and one K2 a
   micro-step, against the module path (f32); with ``remat=True``
   bitwise equal, two K1 and one K2 a micro-step; the large grid's peak
   memory with and without ``remat``, on the kernel and the module path. The enumerated jiVAE (``enum_topk=3``)
   runs 3 epochs with ``enum_schedule=1`` (10 steps of K1 and K2 at 2,000
   rows, then 20 at 600), held against the module path, 10 epochs of
   ``("auto", 0.9)``, and ssiVAE's ``fit(enum_schedule=1)``. The flagship
   ``fit`` for up to 40 epochs with a held-out set, a JSONL log,
   checkpoints every 10 epochs, ``on_segment`` and ``patience=5``: the log
   against the history (bitwise), the checkpoint epochs, the stop against
   the rule, the callbacks' records against the log. Then K1, K2 and K3
   at B = 50 and K1 and K2 at the 600 enumerated rows join phase 6's
   table.
10. Pixel partitioning, int8 serving, the plots' GP, under each flag
   unless named. (a) ``benchmarks/pixel_chunk_scale.py:29-34``: the
   512x512 iVAE (N = 262,144, rotation, hidden 128x128, tanh, Bernoulli,
   seed 0) trains 3 epochs of 400 blob rows at batch 200 through ``fit``
   on the kernels over the full grid (one K1 and one K2 a step), on the
   kernels with ``pixel_chunks=16`` (16 and 16 a step) and, with the flag
   clear, on the module path with 16 tiles (each tile rematerialized),
   each held against the full grid (first step's loss and grads,
   per-epoch losses), with its fit time, a profiled step's wall and
   device time and its peak memory; the module path's full grid is not
   run (its activations alone: B*N*H*4 bytes each). (b) With the flag
   clear, the large grid's peak memory on the module path with 8 tiles
   against the full grid (at most a third), and on the kernel path. (c)
   jiVAE (exact and ``enum_topk=3``) and ssiVAE at phase 7's width train
   2 epochs on 4 tiles (4 K1 and 4 K2 a step) against the full grid. (d)
   The trained flagship and the large grid exported with
   ``quantize="int8"`` and served through K1: encode 1000, posed decode
   1024, large-grid decode 64, each counted alone, held against the
   float32 exports (rel 0.05) and against the same archive served on the
   CPU; archive sizes (the flagship's at most 0.35 of the f32 one) and
   request latencies. (e) Under the default flag, ``predict_on_latent``
   (d = 12, 5 GP steps, 1,000 blobs) at the flagship's width without
   invariances (the GP's inputs are the 2-D encoded latents) against the
   same weights on the CPU. (f) K1 and K2 against their plain versions
   and a second launch, timed, at a 512x512 tile (B = 200, N = 16,384),
   the whole 512x512 grid at B = 8, a large-grid tile (B = 64, N =
   2,048) and the flagship's padded last tile of 3 (262 rows), and K1 on
   the int8 archives' weights: rows of phase 6's table.

11. The job runner and the single-device remainder. (a) The flagship as
   a job file (iVAE 28x28, latent 2, rotation, default widths; batch 200,
   3 epochs, seed 1; 2,000 blob rows saved as .npy and 400 held out; a
   JSONL log, a checkpoint, .pvt weights and an export) run by ``python3
   -m pyroved_tpu_torch.train job.json`` in a child process on the card:
   exit 0, the summary's keys, 3 JSONL records (seconds per epoch
   printed), the checkpoint resumed by a fresh ``SVItrainer``, the .pvt
   loaded, the export served (one K1 a 200-row chunk, against the plain
   version). Under each flag: (b) the same job through ``run_job`` in this
   process, one K1 and one K2 a training step (30) and one K1 a held-out
   batch (6), its losses against the child's (bitwise expected, else
   within phase 5's f32 tolerance; which held is printed); (c) a jiVAE job
   with ``enum_schedule=1`` (10 steps at 2,000 rows, then 10 at the
   ``enum_topk=3`` rows, 600), an ssiVAE job at phase 7's width
   (``unsup_data``, ``sup_data``, ``val_data``, ``patience``; 24 steps)
   and the flagship with ``one_pass_train`` (one K3 a step, nothing
   else); (d) a reference-shaped torch iVAE at the flagship's widths
   loaded by ``load_torch_weights`` (from its state_dict and from a .pt
   file), 1,024 latents decoded by one K1 against the torch module (f32,
   TF32 off: phase 2's f32 tolerance; under the flag the JAX package's
   bf16 bound, 2e-2, and phase 2's bf16 tolerance against the plain
   version); (e) ``set_decoder`` with a user's module, one fit epoch with
   no kernel launch, and ``set_encoder`` alone, one K1 and one K2 a step;
   (f) ``profiling.trace`` around 3 steps, the trace naming K1's and K2's
   ``__global__`` functions 3 times each. Once: a reference-shaped
   batchnorm VED at im2spec widths (16x16 -> 2048) whose running
   statistics drifted, imported and held in eval against the torch
   module's ``eval()`` forward with phase 8's tolerance; and
   ``enable_compilation_cache`` in two child processes, the first building
   K1's f32 source into a fresh directory, the second loading it from
   there with nvcc refused; both times printed.

12. The parallel layer (``pyroved_tpu_torch.parallel``), under each flag.
   (a) One NCCL rank in this process (``initialize_multihost()`` alone,
   its own in-memory store): the flagship's ``fit(mesh=
   data_parallel_mesh())``, 3 epochs of 2,000 blob rows, bitwise the same
   fit without a mesh, one K1 and one K2 a step; the group destroyed.
   Then two gloo ranks in child processes sharing the card (``chip_smoke.py
   --rank``; NCCL takes one rank per card, gloo reduces CUDA tensors),
   each with a hard timeout, loading the kernels from this process's build
   directory (``enable_compilation_cache``), on data this process saved:
   (b) data parallel, the flagship: the first step's grads summed over the
   ranks (100 rows each) against one process's batch-200 step on the same
   weights and noise (phase 5's bounds), 2 epochs through ``fit`` (one K1
   and one K2 a step a rank at B = 100) against one process's per-epoch
   losses, the ranks' parameters bitwise equal (a checksum), a resume
   (1 epoch, a checkpoint rank 0 writes, a fresh model and trainer on each
   rank, 1 more) bitwise the uninterrupted run, and ``one_pass_train`` (5
   K3 a rank, nothing else); (c) ``shard_pixels`` on the 512x512 iVAE at
   full width (phase 10's configuration; 400 rows, batch 200, 2 epochs):
   one K1 and one K2 a step a rank at B = 200, N = 131,072, the first
   step's loss and grads against one process's full-grid step (phase 10's
   bounds), each rank's peak memory and a step's wall time; (d)
   ``{"model": 2}`` tensor parallelism: the gate's warning, no launch, the
   first step's loss and each rank's grads (its shards) against the f32
   module path; (e) 5 steps of ``make_spmd_train_step``: one K1 and one K2
   a step a rank at B = 100, a falling loss, the ranks bitwise equal; (f)
   ``pixel_sharded_decode`` of 64 latents on the 128x128 grid: one K1 a
   rank at N = 8,192, gathered, against one process's decode (phase 2's
   tolerance). After both flags, on the same ranks: (h) the flagship
   split over ``{"model": 2}`` trains 4 epochs in one go and 2 with a
   checkpoint (every rank gathers, rank 0 writes the whole model); a
   whole model loads it with ``load_checkpoint(mesh=)`` (its shards
   bitwise the saved ones) and resumes 2 epochs, bitwise the
   uninterrupted run; this process loads the file into a whole model and
   trains on; (i) the batchnorm im2spec VED over ``{"data": 2}``: the
   first step's loss and grads against one process's (grads within
   phase 8's bound or twice the one-process noise floor, the step on the
   batch's reversed rows), 2 epochs' losses (phase 5's bound), the
   ranks' parameters bitwise equal. Kernel calls are recorded by
   (kernel, B, N). (g) K1, K2
   (and K3 at B = 100) against their plain versions and a second launch,
   timed, at B = 100, N = 784 and B = 200, N = 131,072 (there the plain
   versions and cuBLAS's products run over 8 row chunks), rows of phase
   6's table. Two ranks on one card measure correctness and memory, not
   scaling.

13. K4, the backward in ablation modes (``ops/bwd_ablation.py``, the
   counterpart of ``benchmarks/bwd_ablation.py``): the eight modes built
   from each K2 source with ``-DPVT_ABLATE=<mode>`` (16 libraries), under
   each flag at three shapes with JAX's logical tiles (the flagship, B =
   200, N = 784 -> 896, tiles (40, 128); 2,000 enumerated rows, (40, 128);
   the large grid, B = 64, N = 16,384, (8, 640); H = 128, two layers, L =
   4, ``tools/bwd_ablation.py``'s inputs): each held against its plain
   version with phase 2's tolerances (every output to its tensor's largest
   entry) and a second launch (bitwise), ``full`` against the production
   K2 on the same arrays (dwout under the flag to the bound of bf16
   rounding, which K2 applies and ``full`` does not); then each mode's
   chain of launches (200 at the flagship, 50 at the others; ``z <- z +
   1e-9 dz``; CUDA events), the counted path, beside its bound, the plain
   version and cuBLAS's bare products of the mode, and the attribution of
   K2's time.

14. Captured epochs (``trainers/_graph.py``; run after 12, while 13's
   builds finish): every ``fit``, ``train``, ``evaluate``, ``step`` and
   ``run`` above on a CUDA model over resident loaders already took the
   captured path (the first epoch of each kind eager, as the capture's
   warm-up, the second captured and replayed; each launch check counts a
   replay's kernels). Here, under each
   flag, five models train 3 epochs captured and 3 on the eager loop
   (``CAPTURE`` cleared), through ``step``: the flagship (10,000 blob
   images at batch 200, with a 1,000-image held-out loss), the flagship
   with ``one_pass_train``, the enumerated jiVAE of
   ``benchmarks/enum_bench.py:31-46`` (2,000 uniform images, K = 10), the
   ssiVAE of phase 7 through ``auxSVItrainer`` (its labeled-set metric
   each epoch) and the large grid of ``bench.py:99-120`` (1,024 blobs at
   128x128, batch 64): parameters, buffers, every step's loss, the
   history, the optimizers' states and the noise generator's state bitwise
   equal, and one K1 and one K2 a decode (one K3 under one_pass_train)
   each way. Then each model's steady training epochs each way: steps/s,
   wall and device time a step, the idle share, a profiled replayed
   epoch's K1 or K2 kernels (as many as the counters say) and its CUDA API
   calls (at most one ``cudaGraphLaunch``), the capture's time, its pool's
   memory and the peak memory. Under each flag a resume after a captured
   epoch bitwise equal to the uninterrupted run. At the flagship (bf16),
   programs made again when their key changes: a fresh DataLoader each
   epoch, and the learning rate changed each epoch (as a scheduler writes
   it), each captured and eager bitwise equal, one program held (the
   replaced ones freed, their graphs and pools with them), each epoch
   timed; K2's workspaces during a capture found in the graph's private
   pool (``torch.cuda.memory_snapshot``);
   ``run(loader, 20)``, bench.py's window, at the
   flagship captured and eager (final losses bitwise equal, times); the
   im2spec VED 2 epochs captured and eager, bitwise equal under cuDNN's
   deterministic algorithms (with its default ones the gaps are printed).

TF32 is off for the plain version's matrix products and convolutions, so
they compute in full f32 (on bf16-rounded operands under the flag).

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, without CUDA.
"""
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pyroved_tpu_torch.models import VED, iVAE, jiVAE, ss_reg_iVAE, ssiVAE
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import bwd_ablation as ab
from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.serving import ServedModel, export_model
from pyroved_tpu_torch.tools import bwd_ablation as abt
from pyroved_tpu_torch.tools.profile_bwd_tc import plan_info
from pyroved_tpu_torch.tools.measure import (bf16_matmul, blobs, bounds,
                                             card_info, card_peaks,
                                             cublas_fwd_ms, cuda_ms,
                                             cuda_ms_queued, plain_versions,
                                             random_case, row_chunks,
                                             sfu_floor_ms,
                                             work_bwd, work_fwd)
from pyroved_tpu_torch.tools.measure import usage as ptxas_usage
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.coord import generate_latent_grid
from pyroved_tpu_torch.utils.data import (init_dataloader,
                                          init_ssvae_dataloaders)
from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
from pyroved_tpu_torch.utils.nn import to_onehot

K1 = sd.fused_spatial_decoder_forward
K2 = sd.fused_spatial_decoder_backward
K3 = sd.fused_bernoulli_recon_loss_kernel
KERNELS = (K1, K2, K3)
SOURCES = ("spatial_decoder_fwd", "spatial_decoder_fwd_tc",
           "spatial_decoder_bwd_x3", "spatial_decoder_bwd_tc")
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
# The f32 K2/K3 (three-limb bf16 products on the tensor cores) against
# the plain version in f64: each grad's error, over its tensor's largest
# entry, at most F64_FACTOR times the f32 plain version's own or
# F64_FLOOR, whichever is larger: the kernel computes f32's function to
# about f32's rounding, or this fails. The f32 plain version's error is
# the larger of its two evaluations, on the card (cuBLAS, TF32 off) and on
# the host (the CPU's BLAS, the CPU tests' numerics): where a grad is one
# cancelling sum (one pixel of one sample), one evaluation's error is
# luck. Against the card's alone the first f32 kernel was over this bound
# on 10 of 64 draws of phase 2's one-pixel case, and the limb products
# done exactly on 4 (tools/x3_accuracy.py; PERF.md section 6).
F64_FACTOR = 4.0
F64_FLOOR = 1e-6
# The f32 case at a 512x512 tile (phase 10's shape, B = 200, N = 16,384,
# H = 128, two tanh layers), where a block's weight grads sum the most
# tiles; its plain versions run over this many row chunks.
TILE_512 = (2, 1, "tanh", 128, 200, 16384, 2, 2)
TILE_512_CHUNKS = 8
# VED on the card against the same model on the CPU, both f32 (cuDNN's
# TF32 kept off by the port's convolutions): the port's f32 tolerances,
# outputs atol 1e-5, per-example losses rtol 1e-5; grads as above, each
# summed weight grad held to its tensor's largest entry.
VED_ATOL = 1e-5
VED_LOSS_RTOL = 1e-5
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

def log(*a):
    print(*a, flush=True)


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


def rel_errs(got, ref):
    """Each grad's largest error over its tensor's largest entry."""
    return [((g.double() - r.double()).abs().max()
             / r.double().abs().max().clamp_min(1e-300)).item()
            for g, r in zip(got, ref)]


def check_f64(what, got, refs32, ref64, names=GRAD_NAMES):
    """The kernel's grads ``got`` against the f64 plain version
    ``ref64``: each grad's error over its largest entry within F64_FACTOR
    times the f32 plain version's (the larger over its evaluations
    ``refs32``, on the card and on the host) or F64_FLOOR. Returns the
    worst (kernel, plain) pair of relative errors."""
    kern = rel_errs(got, ref64)
    plain = [max(e) for e in zip(*(rel_errs(r, ref64) for r in refs32))]
    bad = [f"d{n} {k:.2e} > max({F64_FACTOR} x {p:.2e}, {F64_FLOOR})"
           for n, k, p in zip(names, kern, plain)
           if not k <= max(F64_FACTOR * p, F64_FLOOR)]
    if bad:
        raise AssertionError(f"{what} against f64: {'; '.join(bad)}")
    return max(kern), max(plain)


def on_host(fn, *args, **kw):
    """``fn`` run on CPU copies of its tensor arguments (dicts of them
    too), its tensors brought back to the card: the plain version's f32
    evaluation on the host."""
    def cpu(v):
        if isinstance(v, dict):
            return {k: cpu(x) for k, x in v.items()}
        return v.cpu() if isinstance(v, torch.Tensor) else v

    def back(v):
        if isinstance(v, (tuple, list)):
            return type(v)(back(x) for x in v)
        return v.cuda() if isinstance(v, torch.Tensor) else v

    return back(fn(*(cpu(v) for v in args), **{k: cpu(v) for k, v in kw.items()}))


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
    pixel of one sample at H = 256, the large grid, and the flagship's
    shapes of phase 9 (B = 600 enumerated rows at L = 12, and B = 50 under
    grad_accum): 87 cases."""
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
              (2, 1, "tanh", 128, 64, 16384, 2, 2),  # the large grid
              (2, 1, "tanh", 128, 600, 784, 12, 2),  # enum_topk=3, phase 9
              (2, 1, "tanh", 128, 50, 784, 2, 2)]    # grad_accum, phase 9
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


# The tensor-core K1's tanh (csrc/sm90_common.cuh, tanh_exp2) against f64
# tanh: f32's resolution of the output range. Every value it feeds is
# rounded to bf16 (2^-8 relative) or summed in f32 into the head.
TANH_BOUND = 2.5e-7
TANH_CHUNK = 1 << 27  # bit patterns a probe launch takes


def phase_tanh_probe(dev):
    """Phase 2: the tensor-core K1's tanh over every f32 bit pattern (2^32
    inputs in chunks of TANH_CHUNK: every value of [-10, 10], every power
    of two down to the denormals, +-inf and every NaN) against f64 tanh:
    within TANH_BOUND, NaN exactly where the input is NaN, +-inf to +-1."""
    base = torch.arange(TANH_CHUNK, dtype=torch.int32, device=dev)
    worst = (-1.0, 0.0, 0.0)  # (error, x, tanh)
    for lo in range(-(1 << 31), 1 << 31, TANH_CHUNK):
        x = (base + lo).view(torch.float32)
        y = sd.fwd_tc_tanh(x)
        nan = torch.isnan(x)
        if not torch.equal(torch.isnan(y), nan):
            raise AssertionError(f"tanh probe: NaN not exactly where the "
                                 f"input is NaN in bit patterns {lo}..")
        err = torch.where(nan, 0.0, (y.double() - torch.tanh(x.double()))
                          .abs())
        i = int(err.argmax())
        if err[i].item() > worst[0]:
            worst = (err[i].item(), x[i].item(), y[i].item())
        del x, y, nan, err
    ends = sd.fwd_tc_tanh(torch.tensor([float("inf"), -float("inf")],
                                       device=dev)).tolist()
    if ends != [1.0, -1.0]:
        raise AssertionError(f"tanh probe: +-inf gave {ends}, not +-1")
    log(f"  tanh probe: max abs err {worst[0]:.4e} at x = {worst[1]!r} "
        f"(tanh {worst[2]!r}) over all {1 << 32} f32 inputs, bound "
        f"{TANH_BOUND}")
    if not worst[0] <= TANH_BOUND:
        raise AssertionError(f"tanh probe: {worst[0]:.4e} > {TANH_BOUND}")
    return {"inputs": 1 << 32, "max_abs_err": worst[0], "at": worst[1],
            "tanh": worst[2]}


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
              (2, 1, "relu", 128, 4, 200, 2, 5),     # the layer limit
              (2, 1, "tanh", 128, 600, 784, 12, 2),  # enum_topk=3, phase 9
              (2, 1, "tanh", 128, 50, 784, 2, 2),    # grad_accum, phase 9
              # every plan of the bf16 make_plan (BWD_TC_PLANS): resident
              # weights at three layers, streamed at four, the tightest
              # shared memory (four channels, twelve latents)
              (2, 1, "tanh", 128, 37, 1000, 3, 3),
              (2, 3, "lrelu", 128, 37, 1000, 3, 4),
              (1, 2, "softplus", 128, 37, 1000, 3, 1),
              (2, 4, "tanh", 128, 37, 1000, 12, 2),
              (2, 1, "tanh", 128, 200, 784, 2, 2),   # K3 at the flagship
              (2, 1, "tanh", 128, 64, 16384, 2, 2)]  # and the large grid
    return cases


# The plans the bf16 K2/K3 can choose (H, R, weights resident): H = 128
# at R = 64 (up to two layers) and R = 32 (three) with every weight
# resident, R = 32 streamed (four and five layers); H = 256 streamed at
# R = 32 (up to two layers) and 16. Phase 2 runs each of them (and a
# block's tiles are odd in number at B = 37, N = 1000: 592 tiles over 132
# blocks).
BWD_TC_PLANS = {(128, 64, 1), (128, 32, 1), (128, 32, 0), (256, 32, 0),
                (256, 16, 0)}


def bwd_tc_plan(B, N, D, L, H, nl, C, act):
    """(H, R, weights resident) of the bf16 K2/K3's plan for one call (as
    its pvt_sdec_bwd_tc_plan reports it)."""
    info = plan_info(_build.load(sd.BWD_SOURCES[True]), B, N, L, H, nl, C,
                     D=D, act=sd._ACT_CODE[act])
    return H, info["R"], info["resident"]


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
    plans = set()
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
            if sd.BF16_MATMUL:
                plan = bwd_tc_plan(B, N, D, L, H, nl, C, act)
                plans.add(plan)
                what += f" [plan R={plan[1]} resident={plan[2]}]"
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
                f64 = ""
                if not sd.BF16_MATMUL:
                    ref64 = sd.spatial_decoder_bwd_plain(
                        **f64_args(a), g=g.double(), act=act,
                        sigmoid_out=sig)
                    host = on_host(sd.spatial_decoder_bwd_plain, **a, g=g,
                                   act=act, sigmoid_out=sig)
                    ek, ep = check_f64(f"K2 {tag} {what}", got, (ref, host),
                                       ref64)
                    f64 = (f", against f64 {ek:.1e} (plain f32, card or "
                           f"host, {ep:.1e}) of the largest entry")
                log(f"  K2 {tag} vs plain {what}: max abs err "
                    f"{errs2[-1]:.3e} ({rel_to_max(got, ref):.1e} of the "
                    f"largest entry){f64}, bitwise equal across launches")
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
                f64 = ""
                if not sd.BF16_MATMUL:
                    _, ref64 = sd.recon_loss_plain(
                        *(t.double() for t in args), act=act)
                    _, host = on_host(sd.recon_loss_plain, *args, act=act)
                    ek, ep = check_f64(f"K3 {tag} {what}", grads,
                                       (ref, host), ref64)
                    f64 = (f", against f64 {ek:.1e} (plain f32, card or "
                           f"host, {ep:.1e}) of the largest entry")
                log(f"  K3 {tag} vs plain D={D} C=1 H={H} act={act:<11} B={B} "
                    f"N={N} L={L} layers={nl}: loss rel err {rel:.3e}, grads "
                    f"max abs err {errs3[-1]:.3e} ({rel_to_max(grads, ref):.1e}"
                    f" of the largest entry){f64}, bitwise equal")
        if not sd.BF16_MATMUL:
            with case():
                e2, e3 = tile_512_case(rng, dev)
                errs2.append(e2)
                errs3.append(e3)
        elif plans != BWD_TC_PLANS:
            with case():
                raise AssertionError(f"K2/K3 bf16: the cases ran the plans "
                                     f"{sorted(plans)}, not every plan of "
                                     f"{sorted(BWD_TC_PLANS)}")
    return max(errs2), max(errs3)


def f64_args(a):
    return {k: v.double() for k, v in a.items()}


def tile_512_case(rng, dev):
    """Phase 2, f32: K2 and K3 at a 512x512 tile (TILE_512) against their
    plain versions in f32 and f64, each over TILE_512_CHUNKS row chunks,
    and a second launch. Returns (K2's, K3's) largest absolute error."""
    D, C, act, H, B, N, L, nl = TILE_512
    a = random_case(rng, dev, D, C, H, B, N, L, nl)
    g = torch.as_tensor(rng.normal(size=(B, N)), dtype=torch.float32,
                        device=dev)
    what = f"D={D} C={C} H={H} act={act} B={B} N={N} L={L} layers={nl}"
    got, again = K2(**a, g=g), K2(**a, g=g)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"K2 f32 {what}: two launches differ")
    del again
    ref = plain_bwd(a, g, TILE_512_CHUNKS)
    e2 = check_grads(f"K2 f32 {what}", got, ref, per_sample=0)
    ref64 = plain_bwd(f64_args(a), g.double(), TILE_512_CHUNKS)
    host = on_host(plain_bwd, a, g, TILE_512_CHUNKS)
    ek, ep = check_f64(f"K2 f32 {what}", got, (ref, host), ref64)
    log(f"  K2 f32 vs plain {what}: max abs err {e2:.3e} "
        f"({rel_to_max(got, ref):.1e} of the largest entry), against f64 "
        f"{ek:.1e} (plain f32, card or host, {ep:.1e}) of the largest entry, "
        f"bitwise equal "
        f"across launches")
    del got, ref, ref64
    x = torch.as_tensor(rng.uniform(0, 1, (B, N)), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.uniform(0, 1, B), dtype=torch.float32, device=dev)
    (loss, got), (loss2, again) = K3(**a, x=x, wgt=w), K3(**a, x=x, wgt=w)
    torch.cuda.synchronize()
    if not (torch.equal(loss, loss2) and all(
            torch.equal(p, q) for p, q in zip(got, again))):
        raise AssertionError(f"K3 f32 {what}: two launches differ")
    del again
    ref_loss, ref = plain_loss(a, x, w, TILE_512_CHUNKS)
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"K3 f32 {what}: loss rel err {rel:.3e}")
    e3 = check_grads(f"K3 f32 {what}", got, ref, per_sample=0)
    _, ref64 = plain_loss(f64_args(a), x.double(), w.double(),
                          TILE_512_CHUNKS)
    _, host = on_host(plain_loss, a, x, w, TILE_512_CHUNKS)
    ek, ep = check_f64(f"K3 f32 {what}", got, (ref, host), ref64)
    log(f"  K3 f32 vs plain {what}: loss rel err {rel:.3e}, grads max abs "
        f"err {e3:.3e} ({rel_to_max(got, ref):.1e} of the largest entry), "
        f"against f64 {ek:.1e} (plain f32, card or host, {ep:.1e}) of the "
        f"largest entry, "
        f"bitwise equal")
    return e2, e3


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
        for _ in range(2):  # the warm-up, then the capture (CUDA graphs)
            tr.train(ld)
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


def step_breakdown(model, xb, y=None, warmup=5, steps=10):
    """Device time of one training step on batch ``xb`` (and targets
    ``y``) by kernel family (K2: K2 or K3's kernels, f32 or tensor-core,
    with their prep and reductions; "gemm" holds cuBLAS's and cuDNN's
    products and convolutions), from a torch.profiler trace of ``steps``
    steps after ``warmup``, against the step's wall time under the
    profiler (which slows the host: compare the device time with the
    unprofiled step time too)."""
    trainer = SVItrainer(model)
    batch = (xb,) if y is None else (xb, y)
    w = torch.ones(xb.shape[0], device="cuda")
    for _ in range(warmup):
        trainer.train_step(batch, w)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch, w)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
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
        top.append((t / 1e3 / steps, ev.count / steps, ev.key[:80]))
        name = ev.key.lower()
        key = ("K1" if "sdec_fwd" in name else
               "K2" if ("sdec_bwd" in name or "sdec_tc" in name
                        or "sdec_x3" in name) else
               "Adam" if "adam" in name or "multi_tensor" in name else
               "gemm" if "gemm" in name or "sm90" in name or "cutlass" in name
               else "other")
        buckets[key] += t / 1e3 / steps  # us -> ms per step
        launches[key] += ev.count / steps
    device_ms = sum(buckets.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms, "by_family_ms": buckets,
            "kernels_per_step": launches,
            "top_kernels_ms_per_step": sorted(top, reverse=True)[:12]}


def plain_fwd(a, chunks=1):
    """K1's plain version, over ``chunks`` row chunks of the batch."""
    return torch.cat([sd.spatial_decoder_plain(**c)
                      for c in row_chunks(a, chunks)])


def time_k1(name, a, peaks, chunks=1):
    """K1 under each flag at one shape of the paths: held against its plain
    version and a second launch, then timed beside the least time the card
    could take, its plain version and cuBLAS's bare products of the same
    hidden layers. With ``chunks`` the plain version and the products run
    over that many row chunks of the batch, one after the other (their
    [B*N, H] activations whole would not fit beside the kernel's), and
    every timing takes 5 calls after warm-up: a call then lasts 9 ms or
    more. Returns one row per flag, keyed by the flag."""
    few = chunks > 1
    B, N = a["z"].shape[0], a["grid"].shape[0]
    H, nl = a["Wc"].shape[1], a["hw"].shape[0]
    label = f"{name} B={B} N={N}"
    flops, nbytes = work_fwd(a)
    b32, b16, by32, by16 = bounds(flops, nbytes, peaks)
    # h_l W_l of every layer as bare products, in and out dtype
    lib = {dtype: cublas_fwd_ms(B, N, H, nl, dtype, chunks)
           for dtype in (torch.float32, torch.bfloat16)}
    rows = {}
    for on in (False, True):
        tag = "bf16" if on else "f32"
        with bf16_matmul(on):
            out, again = K1(**a), K1(**a)
            ref = plain_fwd(a, chunks)
            torch.cuda.synchronize()
            what = f"K1 {tag} {label}"
            if not torch.equal(out, again):
                raise AssertionError(f"{what}: two launches differ")
            err = check_close(what, out, ref,
                              *((BF16_ATOL, BF16_OUT_REL) if on
                                else (ATOL, 0.0)))
            del out, again, ref
            k_ms = cuda_ms(lambda: K1(**a), reps=5 if few else 25)
            q_ms = cuda_ms_queued(lambda: K1(**a),
                                  **(dict(n=5, reps=1) if few else {}))
            p_ms = cuda_ms(lambda: plain_fwd(a, chunks),
                           reps=5 if few else 20)
        lib_ms = lib[torch.bfloat16 if on else torch.float32]
        rows[on] = {
            "shape": label, "flag": tag, "ms": k_ms, "queued_ms": q_ms,
            "plain_ms": p_ms, "plain_row_chunks": chunks, "max_abs_err": err,
            "bound_ms": b16 if on else b32, "bound_by": by16 if on else by32,
            "bound_ms_f32": b32, "bound_ms_bf16": b16, "library_ms": lib_ms,
            "sfu_floor_ms": sfu_floor_ms(B, N, H, nl),
            "flops": flops, "bytes": nbytes, "tflops": flops / k_ms / 1e9}
        log(f"  {what}: kernel {k_ms:.4f} ms (back to back {q_ms:.4f} ms), "
            f"plain {p_ms:.4f} ms, bound f32 {b32:.4f} ms, bound bf16 "
            f"{b16:.4f} ms, SFU floor {sfu_floor_ms(B, N, H, nl):.4f} ms, "
            f"cuBLAS {tag} hidden products {lib_ms:.4f} ms, "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s, max abs err vs plain "
            f"{err:.3e}, bitwise equal across launches")
    log(f"  K1 {label}: tensor-core kernel faster than the f32 one: "
        f"{rows[True]['ms'] < rows[False]['ms']}")
    return rows


def plain_bwd(a, g, chunks=1):
    """K2's plain version over ``chunks`` row chunks of the batch: the
    per-sample grads joined, the weight grads summed."""
    step = a["z"].shape[0] // chunks
    parts = [sd.spatial_decoder_bwd_plain(**c, g=g[i * step:(i + 1) * step])
             for i, c in enumerate(row_chunks(a, chunks))]
    return tuple(torch.cat(p) if j < PER_SAMPLE else sum(p)
                 for j, p in enumerate(zip(*parts)))


def plain_loss(a, x, w, chunks=1):
    """K3's plain version over ``chunks`` row chunks of the batch: the
    losses and the weight grads summed, the per-sample grads joined."""
    step = a["z"].shape[0] // chunks
    parts = [sd.recon_loss_plain(
        c["grid"], c["phi"], c["dx"], c["sc"], c["z"],
        x[i * step:(i + 1) * step], w[i * step:(i + 1) * step], c["Wc"],
        c["bc"], c["Wz"], c["hw"], c["hb"], c["wout"], c["bout"])
        for i, c in enumerate(row_chunks(a, chunks))]
    grads = tuple(torch.cat(p) if j < PER_SAMPLE else sum(p)
                  for j, p in enumerate(zip(*(g for _, g in parts))))
    return sum(loss for loss, _ in parts), grads


def time_bwd(name, a, xf, gen, peaks, with_k3=True, chunks=1):
    """K2 (and K3 when ``with_k3``; ``xf`` its observations), f32 and
    tensor-core, at one training shape: held against their plain versions
    and a second launch, then timed beside the least time the card could
    take and cuBLAS's time for their hidden products (bf16, and f32 with
    TF32 off). Every grad is held to its tensor's largest entry. With
    ``chunks`` (K2 alone) the plain version and the products run over that
    many row chunks of the batch, and every timing takes 5 calls (3 of the
    plain version) after warm-up. Returns one row per (kernel, flag)."""
    few = chunks > 1
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
        rows_c = B * N // chunks
        hm = torch.randn(rows_c, H, generator=gen, device="cuda").to(dtype)
        dm = torch.randn(rows_c, H, generator=gen, device="cuda").to(dtype)
        wm = a["hw"].to(dtype)

        def cublas():  # h W, h^T d and d W^T of every layer, in and out
            for i in range(nl):  # the dtype
                torch.matmul(hm, wm[i])
                torch.matmul(hm.T, dm)
                torch.matmul(dm, wm[i].T)

        lib[on] = chunks * cuda_ms(cublas, reps=5 if few else 20)
        del hm, dm

    def autograd_plain():
        out = sd.spatial_decoder_plain(**req)
        return torch.autograd.grad(out, [req[k] for k in GRAD_NAMES], g)

    kernels = [("K2", lambda: K2(**a, g=g), lambda: plain_bwd(a, g, chunks),
                False)]
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
                k_ms = cuda_ms(fn, reps=5 if few else 20)
                p_ms = cuda_ms(plain_fn, reps=3 if few else 10)
                b32, b16, by32, by16 = bounds(flops, nbytes, peaks)
                # the f32 kernel makes each product as six bf16 products
                bx3, byx3 = bounds(6 * flops, nbytes, peaks)[1::2]
                row = {"shape": label, "flag": tag, "ms": k_ms,
                       "plain_ms": p_ms, "plain_row_chunks": chunks,
                       "max_abs_err": err,
                       "bound_ms": b16 if on else bx3,
                       "bound_by": by16 if on else byx3,
                       "bound_ms_f32": b32, "bound_ms_bf16": b16,
                       "bound_ms_x3": bx3,
                       "library_ms": lib[on], "flops": flops,
                       "bytes": nbytes, "tflops": flops / k_ms / 1e9,
                       "workspace_bytes": ws_bytes, "blocks": blocks}
                if not on and not loss_mode and chunks == 1:
                    row["autograd_plain_ms"] = cuda_ms(autograd_plain,
                                                       reps=10)
                rows[kname, on] = row
                log(f"  {kname} {tag} {label}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms"
                    + ("" if "autograd_plain_ms" not in row else
                       f", autograd of the plain forward "
                       f"{row['autograd_plain_ms']:.4f} ms")
                    + f", bound f32 {b32:.4f} ms, bound bf16 {b16:.4f} ms, "
                    f"six bf16 products {bx3:.4f} ms"
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


def expect_steps(what, launches, steps, tiles=1):
    """``tiles`` K1 and ``tiles`` K2 per training step (one each on the
    full grid), from the flag's sources only."""
    k1, k2 = ("K1_bf16", "K2_bf16") if sd.BF16_MATMUL else ("K1", "K2")
    n = steps * tiles
    if not only(launches, **{k1: n, k2: n}):
        raise AssertionError(f"{what}: expected {tiles} {k1} and {tiles} "
                             f"{k2} a step ({steps} steps): {launches}")
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


def check_epochs(what, hist, hist_m, ref="module path"):
    """Per-epoch losses finite and falling, and within phase 5's tolerance
    for the flag of the reference's (the module path's, or the full
    grid's); returns the largest relative difference."""
    rtol = BF16_EPOCH_RTOL if sd.BF16_MATMUL else EPOCH_RTOL
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"{what}: loss is not finite and falling: {hist}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist, hist_m))
    log(f"  {what} per-epoch losses {hist}, {ref} {hist_m}: max rel diff "
        f"{rel:.3e}")
    if not rel <= rtol:
        raise AssertionError(f"{what}: per-epoch losses differ from the "
                             f"{ref}'s by {rel:.3e}")
    return rel


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
        "manifold2d": jm.manifold2d(10, disc_idx=3, plot=False),
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


# -- phase 8: VED and the conv nets; checkpoints and weights ----------------

def im2spec_pairs(n, img=16, spec=2048, seed=0):
    """examples/im2spec_ved.py's pairs with ``spec``-long spectra: blobs
    whose width sets the paired spectrum's peak."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, img), np.linspace(-1, 1, img),
                         indexing="ij")
    t = np.linspace(0, 1, spec)
    w = rng.uniform(0.05, 0.3, n)
    imgs = np.exp(-(xx[None] ** 2 + yy[None] ** 2) / w[:, None, None])
    specs = np.exp(-((t[None] - w[:, None]) ** 2) / 0.005)
    return imgs.astype(np.float32), specs.astype(np.float32)


def ved_first_step(model, x, y, eps):
    """Per-example losses and every parameter grad of one weighted loss."""
    model.nets.zero_grad(set_to_none=True)
    per = model.loss_fn(x, y, 4.0, eps=eps)
    per.sum().backward()
    grads = [p.grad.detach().cpu().clone() for p in model.nets.parameters()]
    model.nets.zero_grad(set_to_none=True)
    return per.detach().cpu(), grads


def phase_ved_im2spec():
    """Phase 8, part 1, with cuDNN's TF32 allowed (PyTorch's default; this
    script turns it off everywhere else), so that the port's own scoping
    of TF32 is what keeps the VED's convolutions f32."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        return ved_im2spec()
    finally:
        torch.backends.cudnn.allow_tf32 = False


def ved_im2spec():
    """Phase 8, part 1: the im2spec VED at the reference notebook's width
    (16x16 -> 2048, default filters, lrelu, Bernoulli, sigmoid), with
    cuDNN's TF32 allowed as PyTorch's default has it: the first step on the
    card against the same model on the CPU at f32 tolerance, 3 epochs of
    2,000 pairs at batch 100 through fit (scale_factor 4), then encode,
    decode, predict, manifold2d and the export's refusal."""
    X, Y = im2spec_pairs(2000)
    kw = dict(latent_dim=2, seed=0)
    ved = VED((16, 16), (2048,), **kw)
    cpu = VED((16, 16), (2048,), device="cpu", **kw)
    cpu.nets.load_state_dict(ved.nets.state_dict())
    eps = torch.randn(100, 2, generator=torch.Generator().manual_seed(4))
    per, grads = ved_first_step(ved, X[:100], Y[:100], eps)
    if torch.backends.cudnn.allow_tf32 is not True:
        raise AssertionError("VED changed the caller's TF32 flag")
    per_c, grads_c = ved_first_step(cpu, X[:100], Y[:100], eps)
    rel = ((per - per_c).abs() / per_c.abs()).max().item()
    if not rel <= VED_LOSS_RTOL:
        raise AssertionError(f"VED first step losses, card vs CPU: {rel:.3e}")
    names = [n for n, _ in ved.nets.named_parameters()]
    err = check_grads("VED first step, card vs CPU", grads, grads_c, names,
                      per_sample=0, rel=GRAD_RTOL)
    log(f"  VED 16x16 -> 2048 first step (TF32 allowed), card vs CPU: losses "
        f"max rel err {rel:.3e}, grads max abs err {err:.3e} "
        f"({rel_to_max(grads, grads_c):.1e} of the largest entry)")
    t0 = time.perf_counter()
    trainer = ved.fit(X, Y, epochs=3, batch_size=100, scale_factor=4.0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    hist = trainer.loss_history["training_loss"]
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"VED loss is not finite and falling: {hist}")
    log(f"  VED fit(epochs=3, batch_size=100, scale_factor=4) on 2,000 "
        f"pairs: {fit_s:.2f} s, losses {hist}")
    # serving through the model's own methods, held to the CPU model
    cpu.nets.load_state_dict(ved.nets.state_dict())
    z_loc, z_scale = ved.encode(X[:500], batch_size=200)
    if z_loc.shape != (500, 2) or not bool((z_scale > 0).all()):
        raise AssertionError("VED encode: bad shape or non-positive sigma")
    for o, r in zip((z_loc, z_scale), cpu.encode(X[:500])):
        check_close("VED encode, card vs CPU", o.cpu(), r, VED_ATOL)
    z = torch.as_tensor(np.random.default_rng(5).normal(size=(64, 2)),
                        dtype=torch.float32)
    out = ved.decode(z)
    if out.shape != (64, 2048):
        raise AssertionError(f"VED decode shape {tuple(out.shape)}")
    dec_err = check_close("VED decode, card vs CPU", out.cpu(),
                          cpu.decode(z), VED_ATOL)
    e30 = torch.randn(30, 200, 2, generator=torch.Generator().manual_seed(6))
    mean, std = ved.predict(X[:200], num_samples=30, eps=e30)
    mean_c, std_c = cpu.predict(X[:200], num_samples=30, eps=e30)
    if mean.shape != (200, 2048) or not bool((std >= 0).all()):
        raise AssertionError("VED predict: bad shape or negative std")
    check_close("VED predict mean, card vs CPU", mean.cpu(), mean_c,
                VED_ATOL)
    check_close("VED predict std, card vs CPU", std.cpu(), std_c, VED_ATOL)
    man = ved.manifold2d(8, plot=False)
    if man.shape != (64, 2048) or not torch.isfinite(man).all():
        raise AssertionError("VED manifold2d: bad shape or values")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            export_model(ved, f"{tmp}/ved.npz")
    except NotImplementedError:
        pass
    else:
        raise AssertionError("export_model(VED) did not raise")
    log(f"  VED encode, decode, predict(30 samples) and manifold2d on the "
        f"card match the CPU model (decode max abs err {dec_err:.3e}); "
        f"export_model refuses a VED")
    return {"model": ved, "fit_s": fit_s, "loss_history": hist,
            "first_step_loss_rel": rel, "first_step_grad_err": err}


def phase_ved_stretch(smi):
    """Phase 8, part 2: the stretch width (256x256 -> 2048, batch 16, 256
    pairs), 8 steps each under f32, bf16 (pool="max") and f32 with
    batchnorm: median step time on the host clock and peak memory."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, (256, 256, 256)),
                        dtype=torch.float32, device="cuda")
    y = torch.as_tensor(rng.uniform(0, 1, (256, 2048)),
                        dtype=torch.float32, device="cuda")
    out = {}
    for tag, kw in (("f32", {}), ("bf16", dict(compute_dtype="bfloat16")),
                    ("f32_batchnorm", dict(batchnorm=True))):
        model = VED((256, 256), (2048,), latent_dim=2, seed=0, pool="max",
                    **kw)
        trainer = SVItrainer(model)
        w = torch.ones(16, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(8):
            t0 = time.perf_counter()
            loss = trainer.train_step((x[16 * i:16 * i + 16],
                                       y[16 * i:16 * i + 16]), w)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss.item())
        if not all(np.isfinite(losses)):
            raise AssertionError(f"VED stretch {tag}: losses {losses}")
        out[tag] = {"step_ms_median": statistics.median(times[1:]),
                    "first_step_ms": times[0],
                    "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                    "losses": losses,
                    "breakdown": step_breakdown(model, x[:16], y[:16])}
        del model, trainer
    log(f"  VED 256x256 -> 2048, batch 16, 8 steps (host clock, median of "
        f"steps 2-8), then a profile of 10 (torch.profiler), on {smi}: "
        f"{json.dumps(out)}")
    return out


def resumed_run(what, make, run, loaders, steps):
    """4 epochs in one go against 2, a checkpoint, a fresh model and trainer
    (other seeds) that resume, and 2 more: per-epoch history and final
    parameters bitwise equal. The resumed 2 epochs run as one path: one K1
    and one K2 per step, of the flag's sources. Returns their launches."""
    whole_model, whole = make(0)
    run(whole, loaders(0), 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        first_model, first = make(0)
        run(first, loaders(0), 2)
        save_checkpoint(path, first_model, first)
        model, trainer = make(1)
        if trainer.resume(path) != 2:
            raise AssertionError(f"{what}: resume() did not return 2")
    fresh = loaders(2)
    _, seconds, launches = run_path(lambda: run(trainer, fresh, 2))
    hist = getattr(trainer, "loss_history", None) or trainer.history
    ref = getattr(whole, "loss_history", None) or whole.history
    if hist != ref:
        raise AssertionError(f"{what}: resumed history {hist} != {ref}")
    for (n, p), q in zip(model.nets.named_parameters(),
                         whole_model.nets.parameters()):
        if not torch.equal(p, q):
            gap = (p - q).abs().max().item()
            raise AssertionError(f"{what}: {n} differs by {gap:.3e}")
    expect_steps(f"{what} resumed 2 epochs ({seconds:.2f} s), history and "
                 f"parameters bitwise equal to 4 epochs in one go", launches,
                 steps)
    return launches


def phase_resume(fam_data):
    """Phase 8, part 3, under the current flag: bit-exact resume of the
    flagship iVAE (SVItrainer, 2,000 blob images at batch 200) and of
    ssiVAE at phase 7's width (auxSVItrainer, 2,000 unlabeled and 400
    labeled images, its accuracy after every epoch)."""
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    X = blobs(2000, (28, 28), seed=1)

    def make_ivae(seed):
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=seed)
        return m, SVItrainer(m, seed=seed + 3)

    def ivae_loaders(epoch):
        loader = init_dataloader(X, batch_size=200, seed=2)
        loader.set_epoch(epoch)
        return loader

    launches = {"resume_ivae": resumed_run(
        f"{tag} iVAE", make_ivae,
        lambda t, ld, n: t.run(ld, n), ivae_loaders, 2 * 10)}
    Xf, y, _ = fam_data
    yl = to_onehot(y[:400], N_CLASSES)

    def make_ssivae(seed):
        m = ssiVAE(FAMILY_DIM, num_classes=N_CLASSES, latent_dim=2,
                   invariances=["r"], seed=seed)
        return m, auxSVItrainer(m, seed=seed + 3)

    def ss_loaders(epoch):
        lds = init_ssvae_dataloaders(Xf, (Xf[:400], yl), (Xf[:400], yl),
                                     batch_size=200)
        for ld in lds:
            ld.set_epoch(epoch)
        return lds

    launches["resume_ssivae"] = resumed_run(
        f"{tag} ssiVAE", make_ssivae,
        lambda t, lds, n: t.run(lds[0], lds[1], n, loader_val=lds[2]),
        ss_loaders, 2 * 12)
    return launches


def phase_weights(ved):
    """Phase 8, part 4: save_weights / load_weights on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        ved.save_weights(f"{tmp}/ved")
        other = VED((16, 16), (2048,), latent_dim=2, seed=9)
        other.load_weights(f"{tmp}/ved.pvt")
    for (n, p), q in zip(ved.nets.named_parameters(),
                         other.nets.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"load_weights: {n} differs")
    z = torch.zeros(4, 2)
    if not torch.equal(ved.decode(z), other.decode(z)):
        raise AssertionError("load_weights: decodes differ")
    log("  save_weights / load_weights on the card: parameters and "
        "decodes bitwise equal")


# -- phase 9: the trainer surface ------------------------------------------
# The out-of-core flagship of examples/out_of_core_training.py:35-60: 200,000
# uniform 28x28 rows in a memmap, iVAE((28, 28), latent_dim=2,
# invariances=['r'], seed=1) at batch 200.
OOC_ROWS = 200_000
OOC_ROWS_F32 = 20_000  # the cut under BF16_MATMUL = False
OOC_SLAB = 50_000


def write_memmaps(tmp, rows):
    """``rows`` uniform float32 28x28 images (seed 0, written in slabs as
    the example writes them) and their uint8 copy, as memmaps in ``tmp``,
    opened read-only."""
    f32 = np.lib.format.open_memmap(f"{tmp}/x.npy", mode="w+",
                                    dtype=np.float32, shape=(rows, 28, 28))
    u8 = np.lib.format.open_memmap(f"{tmp}/x8.npy", mode="w+",
                                   dtype=np.uint8, shape=(rows, 28, 28))
    rng = np.random.default_rng(0)
    for lo in range(0, rows, OOC_SLAB):
        hi = min(lo + OOC_SLAB, rows)
        f32[lo:hi] = rng.uniform(0, 1, (hi - lo, 28, 28)).astype(np.float32)
        u8[lo:hi] = np.rint(f32[lo:hi] * 255.0).astype(np.uint8)
    f32.flush()
    u8.flush()
    del f32, u8
    return (np.load(f"{tmp}/x.npy", mmap_mode="r"),
            np.load(f"{tmp}/x8.npy", mmap_mode="r"))


def device_busy_ms(fn):
    """Milliseconds the device was busy (the union of its kernels' and
    copies' intervals, torch.profiler) while ``fn()`` ran, and the wall
    milliseconds under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = [(ev.time_range.start, ev.time_range.end)
             for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and "#" not in ev.name]
    return busy_us(spans) / 1e3, wall


def busy_us(spans):
    """The length of the union of the (start, end) intervals ``spans``."""
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def ooc_variant(name, make_loader, rows, ref=None):
    """One epoch of the out-of-core flagship from the loader
    ``make_loader(rows)`` builds, counted alone as a path: steps/s,
    host-to-device GB/s, launches (one K1 and one K2 a step), and the
    device's idle share (its busy time per step from a profiled 20-step
    epoch of the same loader kind, against the unprofiled step). With
    ``ref`` (a variant's result), the parameters must equal its bitwise."""
    k1, k2 = ("K1_bf16", "K2_bf16") if sd.BF16_MATMUL else ("K1", "K2")
    t0 = time.perf_counter()
    loader = make_loader(rows)
    build_s = time.perf_counter() - t0
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=1)
    trainer = SVItrainer(model)
    loss, epoch_s, launches = run_path(lambda: trainer.train(loader))
    steps = len(loader)
    if not only(launches, **{k1: steps, k2: steps}) or not np.isfinite(loss):
        raise AssertionError(f"out-of-core {name}: loss {loss}, launches "
                             f"{launches}, expected {steps} of {k1} and {k2}")
    params = [p.detach().clone() for p in model.nets.parameters()]
    if ref is not None:
        for (n, p), q in zip(model.nets.named_parameters(), ref["params"]):
            if not torch.equal(p, q):
                raise AssertionError(
                    f"out-of-core {name}: {n} differs from {ref['name']} by "
                    f"{(p - q).abs().max().item():.3e}")
    small = make_loader(20 * 200)
    busy, prof_wall = device_busy_ms(lambda: SVItrainer(model).train(small))
    step_ms = 1e3 * epoch_s / steps
    out = {"name": name, "rows": rows, "loss": loss,
           "loader_build_s": build_s, "epoch_s": epoch_s,
           "steps_per_s": steps / epoch_s, "step_ms": step_ms,
           "h2d_bytes": loader.host_to_device_bytes,
           "h2d_gb_per_s": loader.host_to_device_bytes / epoch_s / 1e9,
           "device_busy_ms_per_step": busy / 20,
           "profiled_wall_ms_per_step": prof_wall / 20,
           "idle_share": 1.0 - busy / 20 / step_ms, "launches": launches,
           "bitwise_equal_to": None if ref is None else ref["name"],
           "params": params}
    log(f"  out-of-core {name}: {rows} rows, {steps} steps in {epoch_s:.2f} s "
        f"({out['steps_per_s']:.1f} steps/s, loader built in {build_s:.2f} "
        f"s), host to device {out['h2d_gb_per_s']:.3f} GB/s, device busy "
        f"{out['device_busy_ms_per_step']:.3f} of {step_ms:.3f} ms a step "
        f"(idle {out['idle_share']:.1%}), loss {loss:.4f}, launches "
        f"{launches}" + ("" if ref is None else
                         f", parameters bitwise equal to {ref['name']}"))
    return out


def phase_out_of_core():
    """Phase 9, part 1, under the current flag: one epoch of the
    out-of-core flagship each resident, streamed per batch, streamed in
    chunks of 64 batches, from the uint8 copy with scale=1/255 (resident
    and streamed) and narrowed to bfloat16 (streamed). Streamed parameters
    bitwise equal to the resident ones of the same data."""
    rows = OOC_ROWS if sd.BF16_MATMUL else OOC_ROWS_F32
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    if rows != OOC_ROWS:
        log(f"  {tag}: cut to the first {rows:,} of {OOC_ROWS:,} rows")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        x32, x8 = write_memmaps(tmp, OOC_ROWS)
        log(f"  wrote {OOC_ROWS:,} rows to a memmap ({x32.nbytes / 1e6:.0f} "
            f"MB) and its uint8 copy in {time.perf_counter() - t0:.1f} s")
        s8 = 1.0 / 255.0

        def loader(src, **kw):
            return lambda n: init_dataloader(src[:n], batch_size=200, seed=0,
                                             **kw)

        res = ooc_variant(f"{tag} resident", loader(x32), rows)
        out = [res,
               ooc_variant(f"{tag} streamed", loader(
                   x32, device_resident=False), rows, res),
               ooc_variant(f"{tag} stream_chunks=64", loader(
                   x32, device_resident=False, stream_chunks=64), rows, res)]
        res8 = ooc_variant(f"{tag} uint8 resident", loader(x8, scale=s8),
                           rows)
        out += [res8,
                ooc_variant(f"{tag} uint8 stream_chunks=64", loader(
                    x8, scale=s8, device_resident=False, stream_chunks=64),
                    rows, res8),
                ooc_variant(f"{tag} store_dtype=bfloat16 stream_chunks=64",
                            loader(x32, store_dtype="bfloat16",
                                   device_resident=False, stream_chunks=64),
                            rows)]
        del x32, x8
    for o in out:
        del o["params"]
    return out


@contextlib.contextmanager
def kernel_rows():
    """The rows (B) of every K1 and K2 launch inside the block, in order, as
    ("K1", B) and ("K2", B): the wrappers wrapped, their counts untouched.
    A call made while a graph is captured launches nothing: its rows are
    kept with the graph's program and added at each of its replays."""
    from pyroved_tpu_torch.trainers import _graph
    calls, captured, capturing = [], {}, []
    fwd, bwd = sd.fused_spatial_decoder_forward, sd.fused_spatial_decoder_backward
    capture, launch = _graph.Program._capture, _graph.Program._launch

    def record(kernel, rows):
        (capturing[-1] if capturing else calls).append((kernel, rows))

    def fwd_rows(grid, phi, dx, sc, z, *a, **k):
        record("K1", z.shape[0])
        return fwd(grid, phi, dx, sc, z, *a, **k)

    def bwd_rows(grid, phi, dx, sc, z, *a, **k):
        record("K2", z.shape[0])
        return bwd(grid, phi, dx, sc, z, *a, **k)

    def capture_rows(prog):
        capturing.append([])
        try:
            capture(prog)
        finally:
            captured[prog] = capturing.pop()

    def launch_rows(prog):
        launch(prog)
        calls.extend(captured.get(prog, ()))

    fwd_rows.launches, bwd_rows.launches = fwd.launches, bwd.launches
    sd.fused_spatial_decoder_forward = fwd_rows
    sd.fused_spatial_decoder_backward = bwd_rows
    _graph.Program._capture, _graph.Program._launch = capture_rows, launch_rows
    try:
        yield calls
    finally:
        sd.fused_spatial_decoder_forward = fwd
        sd.fused_spatial_decoder_backward = bwd
        _graph.Program._capture, _graph.Program._launch = capture, launch


def row_counts(calls):
    """{"K1 B=2000": n, ...} of :func:`kernel_rows`' calls."""
    out = {}
    for k, b in calls:
        out[f"{k} B={b}"] = out.get(f"{k} B={b}", 0) + 1
    return out


def bars(n, seed=0):
    """examples/large_effective_batch.py:35-41's rotated bars."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 28), np.linspace(-1, 1, 28),
                         indexing="ij")
    xr = (xx[None] * np.cos(th)[:, None, None]
          - yy[None] * np.sin(th)[:, None, None])
    return np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(
        np.float32)


def accum_run(X, fused=True, **kw):
    """examples/large_effective_batch.py:44-49 for 2 epochs: batch 50 and
    the trainer's keywords; returns (trainer, model)."""
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=4,
                 fused=fused)
    trainer = SVItrainer(model, seed=2, **kw)
    trainer.run(init_dataloader(X, batch_size=50, seed=0), 2)
    return trainer, model


def peak_mib(model, xb, remat):
    """Peak device memory (MiB) over 3 steps of ``model`` on batch ``xb``
    above what was allocated before them."""
    tr = SVItrainer(model, remat=remat)
    w = torch.ones(xb.shape[0], device="cuda")
    tr.train_step((xb,), w)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        tr.train_step((xb,), w)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_accum_remat(module_runs):
    """Phase 9, part 2, under the current flag: the flagship at batch 50 x
    grad_accum=4 trains 2 epochs of 4,000 rotated bars (80 micro-steps an
    epoch, one K1 and one K2 each), held against the module path (f32)
    with phase 5's tolerances; again with remat=True, bitwise equal, two
    K1 and one K2 a micro-step; the large grid's peak memory with and
    without remat, on the kernel and the module path."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    k1, k2 = ("K1_bf16", "K2_bf16") if on else ("K1", "K2")
    X = bars(4000)
    gen = torch.Generator(device="cuda").manual_seed(11)
    probe = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=4)
    module = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=4,
                  fused=False)
    xb = torch.as_tensor(X[:50], device="cuda")
    eps = torch.randn(50, probe.z_dim, generator=gen, device="cuda")
    err = first_step_vs_module(f"{tag} batch 50", probe, module, xb, eps)
    (tr, model), secs, launches = run_path(
        lambda: accum_run(X, grad_accum=4))
    micro = 2 * 80
    if not only(launches, **{k1: micro, k2: micro}):
        raise AssertionError(f"grad_accum: expected 4 {k1} and 4 {k2} per "
                             f"update ({micro} micro-steps): {launches}")
    if "accum" not in module_runs:
        module_runs["accum"] = accum_run(X, fused=False, grad_accum=4)[
            0].loss_history["training_loss"]
    hist = tr.loss_history["training_loss"]
    check_epochs(f"{tag} batch 50 x grad_accum=4", hist, module_runs["accum"])
    if tr.optimizer.state_dict()["state"][0]["step"].item() != micro // 4:
        raise AssertionError("grad_accum: Adam did not step once per update")
    (tr_r, model_r), secs_r, launches_r = run_path(
        lambda: accum_run(X, grad_accum=4, remat=True))
    if not only(launches_r, **{k1: 2 * micro, k2: micro}):
        raise AssertionError(f"remat: expected 2 {k1} and 1 {k2} per "
                             f"micro-step: {launches_r}")
    for (n, p), q in zip(model_r.nets.named_parameters(),
                         model.nets.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"remat: {n} differs by "
                                 f"{(p - q).abs().max().item():.3e}")
    if tr_r.loss_history != tr.loss_history:
        raise AssertionError("remat: the loss history differs")
    # the kernel path saves only the decoder's inputs already; the module
    # path saves every hidden layer's [64 * 16384, 128] activations
    xl = torch.as_tensor(blobs(64, (128, 128), seed=2), device="cuda")
    peaks = {}
    for path, fused in (("kernel", True), ("module", False)):
        big = iVAE((128, 128), latent_dim=2, invariances=["r"], seed=0,
                   fused=fused)
        peaks[path] = {"no_remat": peak_mib(big, xl, False),
                       "remat": peak_mib(big, xl, True)}
        del big
    log(f"  {tag} batch 50 x grad_accum=4, 2 epochs: {secs:.2f} s, "
        f"launches {launches}, losses {hist}; with remat: {secs_r:.2f} s, "
        f"launches {launches_r}, parameters and losses bitwise equal; large "
        f"grid batch 64 peak memory above the model (MiB), kernel and "
        f"module paths: {peaks}")
    return {"launches": {"grad_accum": launches, "grad_accum_remat":
                         launches_r},
            "seconds": {"grad_accum": secs, "grad_accum_remat": secs_r},
            "loss_history": hist, "module_loss_history": module_runs["accum"],
            "large_grid_peak_mib": peaks, "first_step_err": err,
            "model": model, "xb": xb}


def phase_enum_schedule(data, module_runs):
    """Phase 9, part 3, under the current flag: the enumerated jiVAE
    (enum_topk=3) runs 3 epochs with enum_schedule=1, its kernels at 2,000
    rows in the exact epoch and 600 after, held against the module path
    (f32); 10 epochs of ("auto", 0.9); ssiVAE with enum_schedule=1 through
    fit (auxSVItrainer)."""
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    X, y, _ = data
    kw = dict(FAMILY, discrete_dim=N_CLASSES, enum_topk=3)

    def scheduled(fused=True):
        m = jiVAE(FAMILY_DIM, fused=fused, **kw)
        t = SVItrainer(m)
        t.run(init_dataloader(X, batch_size=200), 3, enum_schedule=1)
        return t, m

    with kernel_rows() as calls:
        (tr, model), secs, launches = run_path(scheduled)
    rows = row_counts(calls)
    if rows != {"K1 B=2000": 10, "K2 B=2000": 10, "K1 B=600": 20,
                "K2 B=600": 20} or calls[:20] != [("K1", 2000), ("K2", 2000)] * 10:
        raise AssertionError(f"enum_schedule=1: kernel rows {rows}")
    expect_steps(f"{tag} jiVAE run(3, enum_schedule=1), {secs:.2f} s, rows "
                 f"{rows}", launches, 30)
    if model.enum_topk != 3:
        raise AssertionError("enum_schedule did not restore enum_topk")
    if "enum_schedule" not in module_runs:
        module_runs["enum_schedule"] = scheduled(fused=False)[
            0].loss_history["training_loss"]
    hist = tr.loss_history["training_loss"]
    check_epochs(f"{tag} jiVAE enum_schedule=1", hist,
                 module_runs["enum_schedule"])
    auto_model = jiVAE(FAMILY_DIM, **kw)
    auto = SVItrainer(auto_model)
    with kernel_rows() as auto_calls:
        _, auto_s, auto_launches = run_path(lambda: auto.run(
            init_dataloader(X, batch_size=200), 10,
            enum_schedule=("auto", 0.9)))
    expect_steps(f"{tag} jiVAE enum_schedule=('auto', 0.9), 10 epochs, "
                 f"{auto_s:.2f} s, probes {auto.enum_probe_history}, switch "
                 f"epoch {auto.enum_switch_epoch}, rows "
                 f"{row_counts(auto_calls)}", auto_launches, 100)
    sm = ssiVAE(FAMILY_DIM, **dict(FAMILY, num_classes=N_CLASSES,
                                   enum_topk=3))
    with kernel_rows() as ss_calls:
        ss, ss_s, ss_launches = run_path(lambda: sm.fit(
            X, (X[:400], y[:400]), epochs=2, batch_size=200,
            enum_schedule=1))
    ss_rows = row_counts(ss_calls)
    if ss_rows != {"K1 B=2000": 10, "K2 B=2000": 10, "K1 B=600": 10,
                   "K2 B=600": 10, "K1 B=200": 4, "K2 B=200": 4}:
        raise AssertionError(f"ssiVAE enum_schedule=1: kernel rows {ss_rows}")
    expect_steps(f"{tag} ssiVAE fit(epochs=2, enum_schedule=1), {ss_s:.2f} "
                 f"s, accuracy {ss.history['test']}, rows {ss_rows}",
                 ss_launches, 24)
    if not all(np.isfinite(ss.history["training_loss"])):
        raise AssertionError("ssiVAE enum_schedule: non-finite loss")
    return {"launches": {"jivae_enum_schedule": launches,
                         "jivae_enum_auto": auto_launches,
                         "ssivae_enum_schedule": ss_launches},
            "rows": {"jivae": rows, "jivae_auto": row_counts(auto_calls),
                     "ssivae": ss_rows},
            "loss_history": hist,
            "module_loss_history": module_runs["enum_schedule"],
            "auto_probe_history": auto.enum_probe_history,
            "auto_switch_epoch": auto.enum_switch_epoch,
            "ssivae_accuracy": ss.history["test"],
            "seconds": {"jivae": secs, "auto": auto_s, "ssivae": ss_s},
            "model": model}


def expected_stop(test_losses, start, patience, seg):
    """The epoch at which the JAX package's blocking runner stops on
    ``test_losses`` (epochs ``start + 1 ...``), checking at every ``seg``-th
    epoch: (stop epoch or None, best epoch)."""
    best, best_epoch = float("inf"), start
    for e, v in enumerate(test_losses, start + 1):
        if v < best:
            best, best_epoch = v, e
        if e % seg == 0 and e - best_epoch >= patience:
            return e, best_epoch
    return None, best_epoch


def phase_observability():
    """Phase 9, part 4, under the current flag: the flagship fit for up to
    40 epochs with a held-out set, a JSONL log, checkpoints every 10
    epochs, on_segment and patience=5; the log against loss_history
    (bitwise), the checkpoint epochs, the stop against the rule, the
    callbacks' records against the log."""
    import pyroved_tpu_torch.utils.checkpoint as ckpt_module
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    k1, k2 = ("K1_bf16", "K2_bf16") if sd.BF16_MATMUL else ("K1", "K2")
    X, X_val = blobs(2400, (28, 28), seed=9), blobs(600, (28, 28), seed=10)
    saved, records = [], []
    save = ckpt_module.save_checkpoint

    def recording_save(path, model, trainer=None, **kw):
        saved.append(trainer.current_epoch)
        return save(path, model, trainer, **kw)

    ckpt_module.save_checkpoint = recording_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
            tr, secs, launches = run_path(lambda: model.fit(
                X, epochs=40, batch_size=200, test_data=X_val,
                log_file=f"{tmp}/train.jsonl",
                checkpoint_path=f"{tmp}/state.npz", checkpoint_every=10,
                on_segment=records.extend, patience=5))
            log_records = [json.loads(line)
                           for line in open(f"{tmp}/train.jsonl")]
    finally:
        ckpt_module.save_checkpoint = save
    hist = tr.loss_history
    n = tr.current_epoch
    steps = n * 12 + n * 3  # 12 training steps, then 3 held-out decodes
    if launches != {**dict.fromkeys(launches, 0), k1: steps, k2: n * 12}:
        raise AssertionError(f"observability: launches {launches}")
    if [r["epoch"] for r in log_records] != list(range(1, n + 1)):
        raise AssertionError("JSONL epochs are not 1..current_epoch")
    if ([r["training_loss"] for r in log_records] != hist["training_loss"]
            or [r["test_loss"] for r in log_records] != hist["test_loss"]):
        raise AssertionError("JSONL losses are not the loss history")
    if saved != list(range(10, n + 1, 10)):
        raise AssertionError(f"checkpoints at epochs {saved}")
    stop, best = expected_stop(hist["test_loss"], 0, 5, 5)
    if (tr.stopped_early, tr.best_epoch) != (stop is not None, best) or (
            stop is not None and stop != n):
        raise AssertionError(f"early stop: stopped {tr.stopped_early} at "
                             f"{n}, best {tr.best_epoch}; the rule gives "
                             f"{stop}, best {best}")
    if tr.stopped_early and not 5 <= n - tr.best_epoch < 10:
        raise AssertionError(f"stopped {n - tr.best_epoch} epochs after the "
                             f"best")
    strip = [{k: v for k, v in r.items() if k != "epoch_seconds"}
             for r in log_records]
    if records != strip:
        raise AssertionError("on_segment records are not the log's")
    log(f"  {tag} observability: fit stopped early {tr.stopped_early} at "
        f"epoch {n} (best {tr.best_epoch}, {tr.best_metric:.4f}), "
        f"{secs:.2f} s, {len(log_records)} JSONL records equal to the "
        f"history, checkpoints at {saved}, on_segment records equal to the "
        f"log, launches {launches}")
    return {"epochs": n, "stopped_early": tr.stopped_early,
            "best_epoch": tr.best_epoch, "checkpoint_epochs": saved,
            "seconds": secs, "launches": launches,
            "training_loss": hist["training_loss"],
            "test_loss": hist["test_loss"]}


def surface_launches(surface):
    """Phase 9's launches under one flag, by path."""
    out = {f"out_of_core_{v['name'].split(' ', 1)[1]}": v["launches"]
           for v in surface["out_of_core"]}
    out.update(surface["accum"]["launches"])
    out.update(surface["enum"]["launches"])
    out["observability"] = surface["observability"]["launches"]
    return out


def phase_trainer_surface(fam_data, module_runs):
    """Phase 9 under the current flag: returns each part's results."""
    return {"out_of_core": phase_out_of_core(),
            "accum": phase_accum_remat(module_runs),
            "enum": phase_enum_schedule(fam_data, module_runs),
            "observability": phase_observability()}

# -- phase 10: pixel-partitioned training, int8 serving, plots and the GP ---

# benchmarks/pixel_chunk_scale.py:29-34: the 512x512 grid (N = 262,144),
# batch 200, hidden 128, 16 tiles, 400 rows, 3 epochs
PIXEL_DIM = (512, 512)
PIXEL_CHUNKS = 16
PIXEL = dict(latent_dim=2, invariances=["r"], seed=0)
# the large grid's module path: the full grid against 8 tiles
LARGE_CHUNKS = 8
# the families on 4 tiles of 196 pixels
FAMILY_CHUNKS = 4


def first_step_vs(what, got, ref, loss_rtol, grad_rel):
    """One step's (loss, grads) against another path's: the loss within
    ``loss_rtol``, every grad within 1e-4 + ``grad_rel`` of its tensor's
    largest entry."""
    (loss, grads), (loss_r, grads_r) = got, ref
    err = check_grads(f"{what} first step", grads, grads_r,
                      [str(i) for i in range(len(grads))], per_sample=0,
                      rel=grad_rel)
    rel = abs(loss - loss_r) / abs(loss_r)
    if not rel <= loss_rtol:
        raise AssertionError(f"{what} first step loss {loss} vs {loss_r}")
    log(f"  {what} first step: loss {loss:.6g} vs {loss_r:.6g} (rel "
        f"{rel:.2e}), grads max abs err {err:.3e} "
        f"({rel_to_max(grads, grads_r):.1e} of the largest entry)")
    return err


def pixel_way(X, xb, eps, fused, chunks):
    """Phase 10 (a), one way: the 512x512 iVAE (kernels or module path,
    ``chunks`` tiles or the full grid) from seed 0: its first step's loss
    and grads, 3 epochs through fit (6 steps) counted alone, the peak
    device memory of the fit above what was allocated before it, and 2
    profiled steps."""
    model = iVAE(PIXEL_DIM, fused=fused, pixel_chunks=chunks, **PIXEL)
    if model._fused != fused:
        raise AssertionError("the 512x512 model is not routed as configured")
    first = first_step_grads(model, xb, eps)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer, fit_s, launches = run_path(
        lambda: model.fit(X, epochs=3, batch_size=200))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    hist = trainer.loss_history["training_loss"]
    prof = step_breakdown(model, xb, warmup=1, steps=2)
    out = {"fit_s": fit_s, "fit_step_ms": 1e3 * fit_s / 6,
           "step_wall_ms": prof["wall_ms"], "step_device_ms": prof["device_ms"],
           "idle_share": prof["idle_share"], "peak_mib": peak,
           "launches": launches, "loss_history": hist,
           "by_family_ms": prof["by_family_ms"]}
    return model, first, out


def phase_pixel_512(smi):
    """Phase 10 (a) under the current flag: the 512x512 config through the
    kernels on the full grid (1 K1 + 1 K2 a step) and on 16 tiles (16 + 16
    a step), and with the flag clear through the module path on 16 tiles;
    each held against the full grid: the first step's loss and grads, the
    per-epoch losses. The module path is not run on the full grid: its
    [B, N, H] activations alone take B*N*H*4 bytes each."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    N = PIXEL_DIM[0] * PIXEL_DIM[1]
    X = blobs(400, PIXEL_DIM, seed=9)
    xb = torch.as_tensor(X[:200], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    eps = torch.randn(200, 3, generator=gen, device="cuda")
    loss_rtol = LOSS_RTOL if on else 1e-5
    grad_rel = BF16_GRAD_REL if on else GRAD_RTOL
    ways, firsts = {}, {}
    for name, fused, chunks in (("kernels_full", True, 0),
                                ("kernels_chunked", True, PIXEL_CHUNKS),
                                ("module_chunked", False, PIXEL_CHUNKS)):
        if name == "module_chunked" and on:
            continue  # the module path is f32
        model, firsts[name], ways[name] = pixel_way(X, xb, eps, fused,
                                                    chunks)
        w = ways[name]
        what = f"{tag} 512x512 {name}"
        if fused:
            expect_steps(f"{what} fit(epochs=3, batch_size=200), "
                         f"{w['fit_s']:.2f} s", w["launches"], 6,
                         chunks or 1)
        elif not only(w["launches"]):
            raise AssertionError(f"{what}: the module path launched "
                                 f"{w['launches']}")
        log(f"  {what}: {w['fit_step_ms']:.1f} ms a step in fit, "
            f"{w['step_wall_ms']:.1f} ms wall / {w['step_device_ms']:.1f} ms "
            f"device a profiled step (idle {w['idle_share']:.3f}), peak "
            f"{w['peak_mib']:.1f} MiB above the model, losses "
            f"{w['loss_history']} ({smi})")
        if name == "kernels_full":
            full = model
            if not (all(np.isfinite(w["loss_history"]))
                    and w["loss_history"][-1] < w["loss_history"][0]):
                raise AssertionError(f"{what}: loss is not finite and "
                                     f"falling: {w['loss_history']}")
            continue
        tol = ((loss_rtol, grad_rel) if fused
               else (LOSS_RTOL, GRAD_RTOL))  # kernels against the module
        w["first_step_err"] = first_step_vs(f"{what} vs kernels_full",
                                            firsts[name],
                                            firsts["kernels_full"], *tol)
        w["epoch_rel"] = check_epochs(what, w["loss_history"],
                                      ways["kernels_full"]["loss_history"],
                                      "full grid")
        del model
    predicted = 200 * N * 128 * 4
    log(f"  {tag} 512x512 module path on the full grid: not run; its "
        f"[200, {N}, 128] activations take {predicted / 1e9:.1f} GB each")
    a, _ = train_args(full, xb, eps)
    return {"ways": ways, "module_full_activation_bytes": predicted,
            "args": a}


def phase_pixel_large_grid():
    """Phase 10 (b), f32: the large grid's peak memory over training steps
    of the module path with 8 tiles against the full grid, and of the
    kernel path likewise (MiB above what was allocated before)."""
    xl = torch.as_tensor(blobs(64, (128, 128), seed=2), device="cuda")
    peaks = {}
    for path, fused in (("module", False), ("kernel", True)):
        for chunks in (0, LARGE_CHUNKS):
            m = iVAE((128, 128), latent_dim=2, invariances=["r"], seed=0,
                     fused=fused, pixel_chunks=chunks)
            peaks[f"{path}_{'chunked' if chunks else 'full'}"] = peak_mib(
                m, xl, False)
            del m
    ratio = peaks["module_chunked"] / peaks["module_full"]
    log(f"  f32 large grid batch 64, peak memory above the model (MiB), "
        f"full grid and {LARGE_CHUNKS} tiles: {json.dumps(peaks)}; module "
        f"path chunked / full {ratio:.3f}")
    if not ratio <= 1 / 3:
        raise AssertionError(f"the module path's peak with {LARGE_CHUNKS} "
                             f"tiles is {ratio:.3f} of the full grid's")
    return {"peak_mib": peaks, "module_ratio": ratio}


def phase_pixel_families(data):
    """Phase 10 (c) under the current flag: jiVAE (exact and enum_topk=3)
    and ssiVAE train 2 epochs through fit on 4 tiles (4 K1 + 4 K2 a step),
    each against the same run on the full grid."""
    X, y, _ = data
    labeled = (X[:400], y[:400])
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    runs = (("jivae", 20, lambda **k: jiVAE(
                FAMILY_DIM, discrete_dim=N_CLASSES, **FAMILY, **k),
             lambda m: m.fit(X, epochs=2, batch_size=200), "loss_history"),
            ("jivae_topk3", 20, lambda **k: jiVAE(
                FAMILY_DIM, discrete_dim=N_CLASSES, enum_topk=3, **FAMILY,
                **k),
             lambda m: m.fit(X, epochs=2, batch_size=200), "loss_history"),
            ("ssivae", 24, lambda **k: ssiVAE(
                FAMILY_DIM, num_classes=N_CLASSES, **FAMILY, **k),
             lambda m: m.fit(X, labeled, epochs=2, batch_size=200),
             "history"))
    launches, hists, rels = {}, {}, {}
    for name, steps, make, fit, key in runs:
        full = getattr(fit(make()), key)["training_loss"]
        tr, secs, launches[name] = run_path(
            lambda: fit(make(pixel_chunks=FAMILY_CHUNKS)))
        expect_steps(f"{tag} {name} on {FAMILY_CHUNKS} tiles, 2 epochs, "
                     f"{secs:.2f} s", launches[name], steps, FAMILY_CHUNKS)
        hists[name] = getattr(tr, key)["training_loss"]
        rels[name] = check_epochs(f"{tag} {name} on {FAMILY_CHUNKS} tiles",
                                  hists[name], full, "full grid")
    return {"launches": launches, "loss_history": hists, "epoch_rel": rels}


def phase_int8(flagship, big, x, z_req, z_big, pose):
    """Phase 10 (d) under the current flag: the trained flagship and the
    large grid exported with quantize="int8" and served on the card (encode
    1000, posed decode 1024; posed decode 64), each request counted alone;
    held against the float32 exports (rel 0.05) and the same int8 archive
    served on the CPU (K1's tolerance; the decodes' first 128 rows); the
    archive sizes; the latencies."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    k1 = "K1_bf16" if on else "K1"
    tol = (BF16_ATOL, BF16_OUT_REL) if on else (ATOL, 0.0)
    out = {"sizes": {}, "ms": {}, "rel_to_f32": {}, "err_to_cpu": {}}
    launches, served8 = {}, {}
    # each request on its first n rows (the CPU's reference takes fewer
    # rows: a row's output depends on that row alone)
    requests = {"flagship": {
                    "encode_1000": lambda s, n=1000: s.encode(x[:n])[0],
                    "posed_decode_1024":
                        lambda s, n=1024: s.decode(z_req[:n], **pose)},
                "large_grid": {"posed_decode_64":
                               lambda s, n=64: s.decode(z_big[:n], **pose)}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("flagship", flagship), ("large_grid", big)):
            p32, p8 = f"{tmp}/{name}_f32.npz", f"{tmp}/{name}_int8.npz"
            export_model(m, p32)
            export_model(m, p8, quantize="int8")
            out["sizes"][name] = {"f32": os.path.getsize(p32),
                                  "int8": os.path.getsize(p8)}
            s32, s8 = ServedModel(p32), ServedModel(p8)
            cpu8 = ServedModel(p8, device="cpu")
            if s8.quantize != "int8" or not s8._fused:
                raise AssertionError(f"{name}: the int8 archive is not "
                                     "served through K1")
            served8[name] = s8
            for req, fn in requests[name].items():
                got, _, launches[f"{name}_{req}"] = run_path(lambda: fn(s8))
                expect = 0 if req.startswith("encode") else 1
                ref32, ref_cpu = fn(s32), fn(cpu8, 128 if expect else 1000)
                if not only(launches[f"{name}_{req}"], **{k1: expect}):
                    raise AssertionError(f"int8 {name} {req}: launches "
                                         f"{launches[f'{name}_{req}']}")
                rel = ((got - ref32).abs().max()
                       / ref32.abs().max()).item()
                out["rel_to_f32"][f"{name}_{req}"] = rel
                if not rel < 0.05:
                    raise AssertionError(f"int8 {name} {req}: {rel:.3e} of "
                                         "the float32 export's largest value")
                out["err_to_cpu"][f"{name}_{req}"] = check_close(
                    f"{tag} int8 {name} {req}, card vs CPU",
                    got[:ref_cpu.shape[0]].cpu(), ref_cpu,
                    *(tol if expect else (ATOL, 0.0)))
                out["ms"][f"{name}_{req}"] = {
                    "int8": host_ms(lambda: fn(s8), reps=20),
                    "f32": host_ms(lambda: fn(s32), reps=20)}
    ratio = out["sizes"]["flagship"]["int8"] / out["sizes"]["flagship"]["f32"]
    out["flagship_size_ratio"] = ratio
    log(f"  {tag} int8 serving: archive bytes {json.dumps(out['sizes'])}, "
        f"outputs against the f32 exports (of the largest value) "
        f"{json.dumps(out['rel_to_f32'])}, card against the CPU's int8 "
        f"serving (max abs) {json.dumps(out['err_to_cpu'])}, request ms "
        f"(host clock, median of 20) {json.dumps(out['ms'])}, launches "
        f"{json.dumps(launches)}")
    if not ratio <= 0.35:
        raise AssertionError(f"the flagship's int8 archive is {ratio:.3f} of "
                             "the float32 one")
    out["launches"] = launches
    return out, served8


def phase_predict_on_latent():
    """Phase 10 (e): predict_on_latent at the flagship's width without
    invariances (examples/vae_gp.py: the GP's inputs are the encoded
    latents, which must be 2-D like the latent grid), 1,000 blobs labelled
    by their x centre, 5 GP steps, d = 12, on the card against the same
    weights on the CPU."""
    X, cx = blobs(1000, (28, 28), seed=10, centers=True)
    vae = iVAE((28, 28), latent_dim=2, invariances=None, seed=0)
    cpu = iVAE((28, 28), latent_dim=2, invariances=None, seed=0,
               device="cpu")
    cpu.nets.load_state_dict({k: v.cpu() for k, v in
                              vae.nets.state_dict().items()})
    t0 = time.perf_counter()
    (z, dec), pred = vae.predict_on_latent(X, cx, gp_iterations=5, d=12)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (zc, dec_c), pred_c = cpu.predict_on_latent(X, cx, gp_iterations=5, d=12)
    if pred.shape != (144,) or dec.shape != (144, 28, 28):
        raise AssertionError("predict_on_latent: bad shapes")
    err = check_close("predict_on_latent predictions, card vs CPU",
                      pred.cpu(), pred_c, 1e-4)
    dec_err = check_close("predict_on_latent decoded grid, card vs CPU",
                          dec.cpu(), dec_c)
    log(f"  predict_on_latent (d=12, 5 GP steps, 1,000 points): {secs:.2f} s "
        f"on the card; predictions within {err:.3e} of the CPU's (range "
        f"[{pred.min().item():.4f}, {pred.max().item():.4f}]), decoded grid "
        f"within {dec_err:.3e}")
    return {"seconds": secs, "max_abs_err": err, "decoded_err": dec_err}


def tile_args(a, rows, B=None):
    """Kernel inputs ``a`` cut to the grid rows ``rows`` (and the first
    ``B`` samples): one tile's K1/K2 call."""
    a = dict(a)
    a["grid"] = a["grid"][rows].contiguous()
    if B is not None:
        for k in ("phi", "dx", "sc", "z"):
            a[k] = a[k][:B].contiguous()
    return a


def phase_pixel(smi, fam_data, flagship, big, x, z_req, z_big, pose):
    """Phase 10 under the current flag; (b) and the module path of (a)
    with the flag clear only, (e) under the default flag only."""
    on = sd.BF16_MATMUL
    res = {"512": phase_pixel_512(smi)}
    if not on:
        res["large_grid"] = phase_pixel_large_grid()
    res["families"] = phase_pixel_families(fam_data)
    res["int8"], res["served_int8"] = phase_int8(flagship, big, x, z_req,
                                                 z_big, pose)
    if on:
        res["predict_on_latent"] = phase_predict_on_latent()
    return res


def pixel_launches(res):
    """Phase 10's launches under one flag, by path."""
    out = {f"pixel_512_{k}": w["launches"]
           for k, w in res["512"]["ways"].items()}
    out.update({f"pixel_{k}": n
                for k, n in res["families"]["launches"].items()})
    out.update({f"int8_{k}": n for k, n in res["int8"]["launches"].items()})
    return out


# -- phase 11: the job runner, reference weights, custom nets, profiling ---

ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_KEYS = {"model", "training_loss", "test_loss", "checkpoint", "weights",
            "export", "epochs"}
SEMI_KEYS = {"model", "training_loss", "val_metric", "stopped_early",
             "best_epoch", "epochs"}
# The __global__ function of K1 and K2 in each flag's source, as the
# profiler's trace names it
GLOBALS = {("K1", False): "sdec_fwd_kernel", ("K1", True): "sdec_fwd_tc_kernel",
           ("K2", False): "sdec_bwd_x3_kernel",
           ("K2", True): "sdec_bwd_tc_kernel"}
# K1 decoding imported weights against the reference torch module (f32, TF32
# off): with the flag clear phase 2's f32 tolerance; with it set the kernel
# rounds its hidden operands to bf16 and the module does not, so the JAX
# package's own bound for a bf16 decode against f32, atol 2e-2
# (tests/test_ops_fused.py), and phase 2's bf16 tolerance against the plain
# version in the same numerics.
BF16_REF_ATOL = 2e-2
# A fresh process builds K1's f32 source into a cache directory, a second
# one loads it from there without nvcc (its Popen is replaced by a raise).
CACHE_CHILD = r"""
import json, os, sys, time
t0 = time.perf_counter()
import torch
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.utils.profiling import enable_compilation_cache
path = enable_compilation_cache(sys.argv[1])
nvcc = []
if sys.argv[2] == "hit":
    def refuse(cmd, *a, **k):
        nvcc.append(cmd[0])
        raise AssertionError("nvcc started on a cache hit")
    _build.subprocess.Popen = refuse
sd.BF16_MATMUL = False
from pyroved_tpu_torch.models import iVAE
m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0, device=sys.argv[3])
t1 = time.perf_counter()
out = m.decode(torch.zeros(8, 2))
if out.is_cuda:
    torch.cuda.synchronize()
t2 = time.perf_counter()
print(json.dumps({"dir": path, "files": sorted(os.listdir(path)),
                  "first_decode_s": t2 - t1, "process_s": t2 - t0,
                  "launches": sd.fused_spatial_decoder_forward.launches,
                  "finite": bool(torch.isfinite(out).all()), "nvcc": nvcc}))
"""


def child_env():
    """The environment of a child process, the checkout on its path."""
    path = [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def start_cache_child(path, mode):
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", CACHE_CHILD, path, mode, "cuda"], cwd=ROOT,
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish_child(what, started):
    """The JSON last line of a child started with its start time, and its
    wall seconds; raises on a non-zero exit."""
    t0, proc = started
    out, err = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1]), secs


def save_npy(tmp, name, arr):
    path = os.path.join(tmp, name + ".npy")
    np.save(path, arr)
    return path


def flagship_job(tmp, tag, data, test=None, **model_extra):
    """The flagship as a job file's dict (bench.py:25-52: iVAE 28x28,
    latent 2, rotation; the default widths 128x128, tanh, Bernoulli),
    batch 200, 3 epochs, seed 1, writing its log, checkpoint, weights and
    export into ``tmp/tag``."""
    out = os.path.join(tmp, tag)
    os.makedirs(out)
    config = {"data_dim": [28, 28], "latent_dim": 2, "invariances": ["r"]}
    if model_extra:
        config["extra"] = model_extra
    job = {"model": "iVAE", "model_config": config,
           "train": {"epochs": 3, "batch_size": 200, "seed": 1},
           "data": data, "log_file": f"{out}/train.jsonl",
           "checkpoint_path": f"{out}/state.npz",
           "save_weights": f"{out}/weights",
           "export_path": f"{out}/export.npz"}
    if test:
        job["test_data"] = test
    return job


def run_cli(job):
    """``python3 -m pyroved_tpu_torch.train job.json`` in a child process
    on the card: (its summary, wall seconds)."""
    path = os.path.join(os.path.dirname(job["log_file"]), "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pyroved_tpu_torch.train", path], cwd=ROOT,
        env=child_env(), capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the job runner exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), secs


def check_cli_files(job, summary, smi):
    """Phase 11 (a), the child's files: 3 JSONL records ending at the
    summary's loss, the checkpoint resumed by a fresh SVItrainer (epoch 3,
    its history), the .pvt weights equal to the resumed ones, and the
    export served through K1, one launch per 200-row chunk, against the
    plain version on the resumed weights."""
    if set(summary) != CLI_KEYS or summary["epochs"] != 3:
        raise AssertionError(f"CLI summary {summary}")
    if not all(np.isfinite([summary["training_loss"],
                            summary["test_loss"]])):
        raise AssertionError(f"CLI losses {summary}")
    records = [json.loads(line) for line in open(job["log_file"])]
    if ([r["epoch"] for r in records] != [1, 2, 3]
            or records[-1]["training_loss"] != summary["training_loss"]
            or records[-1]["test_loss"] != summary["test_loss"]):
        raise AssertionError(f"CLI JSONL {records}")
    epoch_s = [r["epoch_seconds"] for r in records]
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=5)
    trainer = SVItrainer(model, checkpoint_path=job["checkpoint_path"])
    if (trainer.resume() != 3 or trainer.loss_history["training_loss"]
            != [r["training_loss"] for r in records]):
        raise AssertionError("the CLI checkpoint did not resume at epoch 3 "
                             "with its history")
    loaded = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=6)
    loaded.load_weights(summary["weights"])
    for k, v in model.state_dict().items():
        if not torch.equal(v, loaded.state_dict()[k]):
            raise AssertionError(f"CLI .pvt weights differ at {k}")
    served = ServedModel(summary["export"])
    z = torch.as_tensor(np.random.default_rng(14).normal(size=(1024, 2)),
                        dtype=torch.float32, device="cuda")
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    out, _, launches = run_path(lambda: served.decode(z, **pose))
    chunks = -(-1024 // 200)
    if not only(launches, K1_bf16=chunks):
        raise AssertionError(f"CLI export decode: {launches}, expected one "
                             f"K1 a {served.batch_size}-row chunk")
    err = check_decode("CLI export decode of 1,024", model, z, out, pose)
    log(f"  (a) JSONL epochs {[r['epoch'] for r in records]}, seconds per "
        f"epoch {epoch_s} ({smi}); checkpoint resumed at epoch 3; .pvt "
        f"equal; export decode of 1,024: launches {launches}, max abs err "
        f"{err:.3e} against plain")
    return {"epoch_seconds": epoch_s, "served_launches": launches,
            "served_err": err}


def job_inprocess(tmp, data, test, sub):
    """Phase 11 (b), under the current flag: the same job through run_job
    in this process: one K1 and one K2 a training step (30), and one K1 a
    held-out batch (2 an epoch); under the default flag its losses against
    the child's (bitwise expected, else within phase 5's LOSS_RTOL)."""
    from pyroved_tpu_torch.train import run_job
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    k1, k2 = ("K1_bf16", "K2_bf16") if on else ("K1", "K2")
    job = flagship_job(tmp, f"inprocess_{tag}", data, test)
    summary, secs, launches = run_path(lambda: run_job(job))
    if not only(launches, **{k1: 30 + 6, k2: 30}):
        raise AssertionError(f"(b) {tag} run_job launches {launches}: "
                             f"expected 36 {k1} and 30 {k2}")
    res = {"launches": launches, "seconds": secs, "summary": summary}
    if sub is None:
        log(f"  (b) {tag} run_job {secs:.2f} s, launches {launches}, loss "
            f"{summary['training_loss']:.6f}")
        return res
    keys = ("training_loss", "test_loss")
    same = all(summary[k] == sub[k] for k in keys)
    rel = max(abs(summary[k] - sub[k]) / abs(sub[k]) for k in keys)
    if not (same or rel <= LOSS_RTOL):
        raise AssertionError(f"(b) run_job {summary} against the child's "
                             f"{sub}: rel {rel:.3e}")
    log(f"  (b) {tag} run_job {secs:.2f} s, launches {launches}; losses "
        + ("bitwise equal to the child's" if same else
           f"within {rel:.3e} of the child's (not bitwise)"))
    res.update(bitwise=same, rel=rel)
    return res


def other_jobs(tmp, fam_paths, data):
    """Phase 11 (c), under the current flag: a jiVAE job with
    enum_schedule=1 (2 epochs: 10 steps at K*B = 2,000 rows, then 10 at the
    enum_topk=3 rows, 600), an ssiVAE job (2,000 unlabeled, 400 labeled,
    400 validation rows, patience 5; 24 steps) and the flagship with
    one_pass_train (K3 alone, one a step)."""
    from pyroved_tpu_torch.train import run_job
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    X, Xs, Ys, Xv, Yv = fam_paths
    fam = {"data_dim": [28, 28], "latent_dim": 2, "invariances": ["r"],
           "seed": 0}
    out = {}
    jjob = {"model": "jiVAE",
            "model_config": dict(fam, discrete_dim=N_CLASSES, enum_topk=3),
            "train": {"epochs": 2, "batch_size": 200, "enum_schedule": 1},
            "data": X}
    with kernel_rows() as calls:
        summary, secs, launches = run_path(lambda: run_job(jjob))
    rows = row_counts(calls)
    if (rows != {"K1 B=2000": 10, "K2 B=2000": 10, "K1 B=600": 10,
                 "K2 B=600": 10}
            or calls[:20] != [("K1", 2000), ("K2", 2000)] * 10):
        raise AssertionError(f"(c) jiVAE job rows {rows}")
    expect_steps(f"(c) {tag} jiVAE job, enum_schedule=1, {secs:.2f} s, "
                 f"rows {rows}, loss {summary['training_loss']:.4f}",
                 launches, 20)
    out["jivae_job"] = launches
    sjob = {"model": "ssiVAE",
            "model_config": dict(fam, num_classes=N_CLASSES),
            "train": {"epochs": 2, "batch_size": 200, "patience": 5},
            "unsup_data": X, "sup_data": [Xs, Ys], "val_data": [Xv, Yv]}
    summary, secs, launches = run_path(lambda: run_job(sjob))
    if (set(summary) != SEMI_KEYS or summary["stopped_early"]
            or not 0.0 <= summary["val_metric"] <= 1.0
            or not np.isfinite(summary["training_loss"])):
        raise AssertionError(f"(c) ssiVAE job summary {summary}")
    expect_steps(f"(c) {tag} ssiVAE job, {secs:.2f} s, accuracy "
                 f"{summary['val_metric']:.4f}", launches, 24)
    out["ssivae_job"] = launches
    ojob = flagship_job(tmp, f"one_pass_{tag}", data, one_pass_train=True)
    summary, secs, launches = run_path(lambda: run_job(ojob))
    k3 = "K3_bf16" if on else "K3"
    if not only(launches, **{k3: 30}):
        raise AssertionError(f"(c) one-pass job launches {launches}")
    log(f"  (c) {tag} one-pass flagship job, {secs:.2f} s, launches "
        f"{launches}, loss {summary['training_loss']:.4f}")
    out["one_pass_job"] = launches
    return out


class RefCoordLatent(torch.nn.Module):
    """The reference pyroVED's coord_latent block (nets/fc.py names)."""

    def __init__(self, latent_dim, h):
        super().__init__()
        self.fc_coord = torch.nn.Linear(2, h)
        self.fc_latent = torch.nn.Linear(latent_dim, h, bias=False)

    def forward(self, x_coord, z):
        return torch.tanh(self.fc_coord(x_coord)
                          + self.fc_latent(z).unsqueeze(1))


def ref_fc_layers(dims):
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.Tanh()]
    return torch.nn.Sequential(*layers)


class RefIVAE(torch.nn.Module):
    """A reference-shaped iVAE: encoder_z.fc_layers / fc11 / fc12 and
    decoder.coord_latent / fc_layers / out, as tests/test_interop.py."""

    def __init__(self, in_dim, z_out, latent_dim, hidden=(128, 128)):
        super().__init__()
        self.encoder_z = torch.nn.Module()
        self.encoder_z.fc_layers = ref_fc_layers([in_dim] + list(hidden))
        self.encoder_z.fc11 = torch.nn.Linear(hidden[-1], z_out)
        self.encoder_z.fc12 = torch.nn.Linear(hidden[-1], z_out)
        self.decoder = torch.nn.Module()
        self.decoder.coord_latent = RefCoordLatent(latent_dim, hidden[0])
        self.decoder.fc_layers = ref_fc_layers([hidden[0]] + list(hidden))
        self.decoder.out = torch.nn.Linear(hidden[-1], 1)

    def encode(self, x):
        h = self.encoder_z.fc_layers(x.reshape(x.shape[0], -1))
        return (self.encoder_z.fc11(h),
                torch.nn.functional.softplus(self.encoder_z.fc12(h)))

    def decode(self, grid, z):
        h = self.decoder.coord_latent(grid.expand(z.shape[0], -1, -1), z)
        return torch.sigmoid(self.decoder.out(self.decoder.fc_layers(h)))[
            ..., 0]


class RefUpBlock1d(torch.nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = torch.nn.Conv1d(ch, ch, 1, 1, 0)

    def forward(self, x):
        return self.conv(torch.nn.functional.interpolate(
            x, scale_factor=2, mode="nearest"))


class RefBNVED(torch.nn.Module):
    """A reference-shaped im2spec VED with batchnorm at the port's default
    filters: a 16x16 image -> ((32,), (64, 64), (128, 128)) convs, 2x2
    pools between blocks -> features2latent; latent2features -> 1-D
    ((128, 128), (64, 64), (32,)) convs, each block upsampled x2 -> 2048."""

    def __init__(self, latent_dim=2, out_len=2048):
        super().__init__()
        nn_ = torch.nn

        def conv(a, b, d):
            return [(nn_.Conv2d if d == 2 else nn_.Conv1d)(a, b, 3, 1, 1),
                    nn_.LeakyReLU(),
                    (nn_.BatchNorm2d if d == 2 else nn_.BatchNorm1d)(b)]

        self.encoder_z = nn_.Module()
        self.encoder_z.feature_extractor = nn_.Module()
        self.encoder_z.feature_extractor.layers = nn_.Sequential(
            *conv(1, 32, 2), nn_.MaxPool2d(2, 2), *conv(32, 64, 2),
            *conv(64, 64, 2), nn_.MaxPool2d(2, 2), *conv(64, 128, 2),
            *conv(128, 128, 2))
        self.encoder_z.features2latent = nn_.Module()
        self.encoder_z.features2latent.fc_latent = nn_.Linear(128 * 4 * 4,
                                                              2 * latent_dim)
        self.decoder = nn_.Module()
        self.decoder.latent2features = nn_.Module()
        self.decoder.latent2features.fc = nn_.Linear(latent_dim,
                                                     128 * (out_len // 8))
        self.decoder.upsampler = nn_.Module()
        self.decoder.upsampler.layers = nn_.Sequential(
            *conv(128, 128, 1), *conv(128, 128, 1), RefUpBlock1d(128),
            *conv(128, 64, 1), *conv(64, 64, 1), RefUpBlock1d(64),
            *conv(64, 32, 1), RefUpBlock1d(32), nn_.Conv1d(32, 1, 1, 1, 0))
        self.latent_dim, self.in_len = latent_dim, out_len // 8

    def encode(self, x):
        f = self.encoder_z.feature_extractor.layers(x[:, None])
        enc = self.encoder_z.features2latent.fc_latent(f.flatten(1))
        mu, sig = enc.split(self.latent_dim, 1)
        return mu, torch.nn.functional.softplus(sig)

    def decode(self, z):
        h = self.decoder.latent2features.fc(z).reshape(z.shape[0], 128,
                                                       self.in_len)
        return torch.sigmoid(self.decoder.upsampler.layers(h))[:, 0]


def reference_ivae(tmp):
    """Phase 11 (d), under the current flag: a reference-shaped iVAE at the
    flagship's widths, random from seed 12 on the card, loaded through
    load_torch_weights (the state_dict, and a .pt file: the same weights);
    its encode against the module's, 1,024 latents decoded through K1 (one
    launch) against the module's forward (f32, TF32 off) and, under the
    flag, against the plain version in bf16."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    torch.manual_seed(12)
    ref = RefIVAE(784, 3, 2).cuda()
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    model.load_torch_weights(ref.state_dict())
    path = os.path.join(tmp, f"reference_{tag}.pt")
    torch.save(ref.state_dict(), path)
    from_file = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=3)
    from_file.load_torch_weights(path)
    for k, v in model.state_dict().items():
        if not torch.equal(v, from_file.state_dict()[k]):
            raise AssertionError(f"(d) .pt load differs at {k}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    z = torch.randn(1024, 2, generator=gen, device="cuda")
    x = torch.as_tensor(blobs(1000, (28, 28), seed=15), device="cuda")
    with torch.no_grad():
        want_dec = ref.decode(model.grid, z)
        want_enc = ref.encode(x)
    enc = model.encode(x)
    enc_err = max(check_close(f"(d) {tag} imported encode", a, b)
                  for a, b in zip(enc, want_enc))
    out, _, launches = run_path(lambda: model.decode(z))
    k1 = "K1_bf16" if on else "K1"
    if not only(launches, **{k1: 1}):
        raise AssertionError(f"(d) imported decode launches {launches}")
    got = out.reshape(1024, -1)
    if on:
        err = check_close(f"(d) {tag} imported decode vs the torch module",
                          got, want_dec, BF16_REF_ATOL)
        plain_err = check_decode(f"(d) {tag} imported decode vs plain",
                                 model, z, out, {})
    else:
        err = check_close(f"(d) {tag} imported decode vs the torch module",
                          got, want_dec, ATOL)
        plain_err = None
    log(f"  (d) {tag} reference iVAE imported (state_dict and .pt equal): "
        f"encode max abs err {enc_err:.3e}; decode of 1,024, launches "
        f"{launches}, max abs err {err:.3e} against the torch module"
        + ("" if plain_err is None else
           f", {plain_err:.3e} against plain"))
    return {"launches": launches, "decode_err": err, "plain_err": plain_err,
            "encode_err": enc_err}


def reference_ved():
    """Phase 11 (d), the batchnorm VED at im2spec widths (VED((16, 16),
    (2048,)), default filters): a reference-shaped torch VED, random from
    seed 16, its running statistics moved by three train-mode forwards,
    then eval(); loaded through load_torch_weights (use_running_stats
    set), its encode and decode against the module's eval() forward with
    phase 8's VED tolerance. No kernel: cuDNN convolutions."""
    torch.manual_seed(16)
    ref = RefBNVED().cuda().train()
    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.no_grad():
        for _ in range(3):
            ref.encode(torch.rand(64, 16, 16, generator=gen, device="cuda"))
            ref.decode(torch.randn(64, 2, generator=gen, device="cuda"))
    ref.eval()
    ved = VED((16, 16), (2048,), batchnorm=True, seed=0)
    ved.load_torch_weights(ref.state_dict())
    if not ved.use_running_stats:
        raise AssertionError("(d) VED import did not set use_running_stats")
    x = torch.as_tensor(blobs(100, (16, 16), seed=18), device="cuda")
    z = torch.randn(100, 2, generator=gen, device="cuda")
    with torch.no_grad():
        want_enc, want_dec = ref.encode(x), ref.decode(z)
    enc_err = max(check_close("(d) imported VED encode", a, b, VED_ATOL)
                  for a, b in zip(ved.encode(x), want_enc))
    dec_err = check_close("(d) imported VED decode", ved.decode(z),
                          want_dec, VED_ATOL)
    log(f"  (d) reference batchnorm VED (16x16 -> 2048) imported with its "
        f"running statistics: encode max abs err {enc_err:.3e}, decode "
        f"{dec_err:.3e} against the module's eval()")
    return {"encode_err": enc_err, "decode_err": dec_err}


class UserEncoder(torch.nn.Module):
    """A user's encoder of plain torch layers: (loc, scale) of 3 latents."""

    def __init__(self):
        super().__init__()
        self.body = torch.nn.Sequential(
            torch.nn.Linear(784, 128), torch.nn.Tanh(),
            torch.nn.Linear(128, 128), torch.nn.Tanh())
        self.head = torch.nn.Linear(128, 6)

    def forward(self, x):
        out = self.head(self.body(x))
        return out[:, :3], torch.nn.functional.softplus(out[:, 3:])


class UserDecoder(torch.nn.Module):
    """A user's spatial decoder: softplus(coords Wc + z Wz) through two
    128-wide layers, a sigmoid per pixel."""

    def __init__(self):
        super().__init__()
        self.coord = torch.nn.Linear(2, 128)
        self.latent = torch.nn.Linear(2, 128, bias=False)
        self.body = torch.nn.Sequential(
            torch.nn.Softplus(), torch.nn.Linear(128, 128), torch.nn.Softplus(),
            torch.nn.Linear(128, 1))

    def forward(self, coords, z):
        h = self.coord(coords) + self.latent(z).unsqueeze(-2)
        return torch.sigmoid(self.body(h))[..., 0]


def custom_nets(X):
    """Phase 11 (e), under the current flag: the flagship with a user's
    decoder trains one fit epoch (10 steps) with no kernel launch; with a
    user's encoder, one K1 and one K2 a step."""
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    dec = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    dec.set_decoder(UserDecoder())
    tr, secs, launches = run_path(lambda: dec.fit(X, epochs=1,
                                                  batch_size=200))
    loss = tr.loss_history["training_loss"][-1]
    if not only(launches) or not np.isfinite(loss):
        raise AssertionError(f"(e) set_decoder fit: launches {launches}, "
                             f"loss {loss}")
    log(f"  (e) {tag} set_decoder: fit epoch {secs:.2f} s, loss {loss:.4f}, "
        f"launches {launches}")
    enc = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    enc.set_encoder(UserEncoder())
    tr, secs, enc_launches = run_path(lambda: enc.fit(X, epochs=1,
                                                      batch_size=200))
    expect_steps(f"(e) {tag} set_encoder: fit epoch {secs:.2f} s, loss "
                 f"{tr.loss_history['training_loss'][-1]:.4f}", enc_launches,
                 10)
    return {"custom_decoder_fit": launches, "custom_encoder_fit": enc_launches}


def traced_steps(tmp, X):
    """Phase 11 (f), under the current flag: profiling.trace around 3
    flagship training steps; the trace file names K1's and K2's
    ``__global__`` functions 3 times each, the launch counts agree."""
    from pyroved_tpu_torch.utils import profiling
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
    trainer = SVItrainer(model)
    xb = torch.as_tensor(X[:200], device="cuda")
    w = torch.ones(200, device="cuda")
    trainer.train_step((xb,), w)  # the first step's set-up stays out
    torch.cuda.synchronize()
    logdir = os.path.join(tmp, f"trace_{tag}")

    def steps():
        with profiling.trace(logdir):
            for _ in range(3):
                trainer.train_step((xb,), w)
            torch.cuda.synchronize()

    _, secs, launches = run_path(steps)
    expect_steps(f"(f) {tag} 3 traced steps, {secs:.2f} s", launches, 3)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"(f) trace files {files}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(GLOBALS[k, on] in n for n in names) for k in ("K1", "K2")}
    if found != {"K1": 3, "K2": 3}:
        raise AssertionError(f"(f) the trace names {found} of "
                             f"{[GLOBALS[k, on] for k in ('K1', 'K2')]}")
    log(f"  (f) {tag} trace {files[0]}: {len(names)} kernel events, "
        f"{GLOBALS['K1', on]} x{found['K1']}, {GLOBALS['K2', on]} "
        f"x{found['K2']}")
    return {"launches": launches, "kernel_events": len(names),
            "named": found}


def check_cache(miss, miss_s, hit, hit_s, cache_dir, smi):
    """Phase 11 (f): the first child built K1's f32 source into the cache
    directory, the second loaded it from there without nvcc; both decoded
    through it once."""
    libs = [f for f in miss["files"]
            if f.startswith("spatial_decoder_fwd-") and f.endswith(".so")]
    for what, res in (("miss", miss), ("hit", hit)):
        if (res["dir"] != os.path.abspath(cache_dir) or not res["finite"]
                or res["launches"] != {"spatial_decoder_fwd": 1,
                                       "spatial_decoder_fwd_tc": 0}):
            raise AssertionError(f"(f) cache {what}: {res}")
    if len(libs) != 1 or hit["files"] != miss["files"] or hit["nvcc"]:
        raise AssertionError(f"(f) cache: built {miss['files']}, then "
                             f"{hit['files']}, nvcc on the hit {hit['nvcc']}")
    log(f"  (f) enable_compilation_cache: the first process built {libs[0]} "
        f"(first decode {miss['first_decode_s']:.2f} s, process "
        f"{miss_s:.2f} s); the second loaded it without nvcc (first decode "
        f"{hit['first_decode_s']:.2f} s, process {hit_s:.2f} s) ({smi})")
    return {"miss_first_decode_s": miss["first_decode_s"],
            "miss_process_s": miss_s,
            "hit_first_decode_s": hit["first_decode_s"],
            "hit_process_s": hit_s}


def phase_jobs(smi, fam_data):
    """Phase 11: the job runner in a child process and in this one, the
    other jobs, reference weights, custom nets, the trace and the kernel
    cache (see the module docstring). Returns the results and each path's
    launches."""
    t0 = time.perf_counter()
    X, y, _ = fam_data
    res, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cache_dir = os.path.join(tmp, "kernel_cache")
        miss_child = start_cache_child(cache_dir, "miss")
        flag = blobs(2400, (28, 28), seed=11)
        data = save_npy(tmp, "X", flag[:2000])
        test = save_npy(tmp, "Xt", flag[2000:])
        onehot = np.eye(N_CLASSES, dtype=np.float32)
        fam_paths = (save_npy(tmp, "Xf", X), save_npy(tmp, "Xs", X[:400]),
                     save_npy(tmp, "Ys", onehot[y[:400]]),
                     save_npy(tmp, "Xv", X[400:800]),
                     save_npy(tmp, "Yv", onehot[y[400:800]]))
        # (a) the real entry point, in a child process (the default flag)
        cli = flagship_job(tmp, "cli", data, test)
        sub, cli_s = run_cli(cli)
        log(f"  (a) python3 -m pyroved_tpu_torch.train job.json: exit 0 in "
            f"{cli_s:.2f} s ({smi}), summary {json.dumps(sub)}")
        res["cli"] = {"seconds": cli_s, "summary": sub}
        for on in (False, True):
            with bf16_matmul(on):
                tag = "bf16" if on else "f32"
                r = res[tag] = {}
                r["inprocess"] = job_inprocess(tmp, data, test,
                                               sub if on else None)
                launches[f"cli_inprocess_{tag}"] = r["inprocess"]["launches"]
                for path, n in other_jobs(tmp, fam_paths, data).items():
                    launches[f"{path}_{tag}"] = n
                r["reference_ivae"] = reference_ivae(tmp)
                launches[f"imported_decode_{tag}"] = r["reference_ivae"][
                    "launches"]
                for path, n in custom_nets(flag[:2000]).items():
                    launches[f"{path}_{tag}"] = n
                r["trace"] = traced_steps(tmp, flag)
                launches[f"traced_steps_{tag}"] = r["trace"]["launches"]
        miss, miss_s = finish_child("cache miss child", miss_child)
        hit_child = start_cache_child(cache_dir, "hit")
        res["reference_ved"] = reference_ved()
        res["cli"].update(check_cli_files(cli, sub, smi))
        launches["cli_served_decode_bf16"] = res["cli"]["served_launches"]
        hit, hit_s = finish_child("cache hit child", hit_child)
        res["cache"] = check_cache(miss, miss_s, hit, hit_s, cache_dir, smi)
    res["seconds"] = time.perf_counter() - t0
    return res, launches


# -- phase 12: the parallel layer ------------------------------------------

# The flagship's data parallelism (b), the one-rank mesh (a): blob rows
PAR_ROWS = 2000
PAR_KW = dict(latent_dim=2, invariances=["r"], seed=0)
# A rank's hard limit: it starts, loads the cached kernels and runs every
# case of (b)-(f) under each flag
RANK_TIMEOUT = 420
# the 512x512 model's half grid, (c) and (g)
HALF = PIXEL_DIM[0] * PIXEL_DIM[1] // 2
# (g): the plain versions at B = 200, N = 131,072 run over row chunks of
# 25 (their [B*N, H] activations whole take 13.4 GB each)
HALF_CHUNKS = 8
# (h): the tensor-parallel flagship's rows (2 steps an epoch); (i): the
# batchnorm im2spec VED's rows (the last of 4 batches padded)
TP_ROWS = 400
BN_ROWS, BN_BATCH = 350, 100


@contextlib.contextmanager
def kernel_shapes():
    """(kernel, B, N) of every K1, K2 and K3 call inside the block, in
    order: the wrappers wrapped, their counts untouched."""
    calls = []
    names = {"K1": "fused_spatial_decoder_forward",
             "K2": "fused_spatial_decoder_backward",
             "K3": "fused_bernoulli_recon_loss_kernel"}
    old = {k: getattr(sd, n) for k, n in names.items()}

    def wrap(k, fn):
        def shaped(grid, phi, dx, sc, z, *a, **kw):
            calls.append((k, z.shape[0], grid.shape[0]))
            return fn(grid, phi, dx, sc, z, *a, **kw)
        shaped.launches = fn.launches
        return shaped

    for k, n in names.items():
        setattr(sd, n, wrap(k, old[k]))
    try:
        yield calls
    finally:
        for k, n in names.items():
            setattr(sd, n, old[k])


def shape_counts(calls):
    """{"K1 B=100 N=784": n, ...} of :func:`kernel_shapes`' calls."""
    out = {}
    for k, b, n in calls:
        key = f"{k} B={b} N={n}"
        out[key] = out.get(key, 0) + 1
    return out


def checksum(model):
    """A digest of every parameter's bytes: equal digests, equal bits."""
    import hashlib
    h = hashlib.sha256()
    for p in model.nets.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def named_grads(model):
    return {n: p.grad.detach().cpu().clone()
            for n, p in model.nets.named_parameters()}


def par_batch(X, rows=200, seed=3):
    """The first ``rows`` images on the card and a batch's noise from a
    generator of ``seed``: what the single-process references use too."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.as_tensor(X[:rows], device="cuda"),
            torch.randn(rows, 3, generator=gen, device="cuda"))


def rank_dp(mesh, X, tmp):
    """(b) on this rank: the flagship's first step (its 100 rows, the
    grads summed over the ranks), 2 epochs through fit, a resume, and
    one-pass steps."""
    from pyroved_tpu_torch.parallel import replicate_params
    out = {}
    m = replicate_params(iVAE((28, 28), **PAR_KW), mesh)
    t = SVItrainer(m, mesh=mesh)
    xb, eps = par_batch(X)
    (x,), w, e = t.data_axis.local((xb,), torch.ones(200, device="cuda"), eps)
    m.nets.zero_grad(set_to_none=True)
    loss = m.weighted_loss_fn(x, None, w, 1.0, eps=e)
    loss.backward()
    out["first_loss"] = t.data_axis.reduce_grads(t.optimizer, loss).item()
    out["first_grads"] = named_grads(m)
    m.nets.zero_grad(set_to_none=True)
    with kernel_shapes() as calls:
        tr, out["fit_s"], out["launches"] = run_path(
            lambda: m.fit(X, epochs=2, batch_size=200, mesh=mesh))
    out["shapes"] = shape_counts(calls)
    out["history"] = tr.loss_history["training_loss"]
    out["checksum"] = checksum(m)
    # resumed: 1 epoch, a checkpoint (rank 0 writes, both wait), a fresh
    # model and trainer on each rank, 1 more epoch
    ckpt = os.path.join(tmp, "dp_state.npz")
    m1 = iVAE((28, 28), **PAR_KW)
    m1.fit(X, epochs=1, batch_size=200, mesh=mesh, checkpoint_path=ckpt,
           checkpoint_every=1)
    m2 = iVAE((28, 28), **dict(PAR_KW, seed=5))
    t2 = SVItrainer(m2, mesh=mesh)
    if t2.resume(ckpt) != 1:
        raise AssertionError("resume did not restore epoch 1")
    loader = init_dataloader(X, batch_size=200)
    loader.set_epoch(1)
    t2.run(loader, 1)
    out["resumed_history"] = t2.loss_history["training_loss"]
    out["resumed_checksum"] = checksum(m2)
    one = iVAE((28, 28), one_pass_train=True, **PAR_KW)
    with kernel_shapes() as calls:
        loss1, _, out["one_pass_launches"] = run_path(
            lambda: SVItrainer(one, mesh=mesh).train(
                init_dataloader(X[:1000], batch_size=200)))
    out["one_pass_shapes"] = shape_counts(calls)
    out["one_pass_loss"] = loss1
    return out


def rank_pixels(mesh, X):
    """(c) on this rank: the 512x512 iVAE with its grid split over
    'pixels': the first step on the full batch, 2 epochs through fit, the
    peak memory above what was allocated before, a step's wall time."""
    from pyroved_tpu_torch.parallel import shard_pixels
    out = {}
    m = shard_pixels(iVAE(PIXEL_DIM, **PIXEL), mesh)
    xb, eps = par_batch(X, seed=13)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = first_step_grads(m, xb, eps)
    out["first"] = (loss, [g.cpu() for g in grads])
    with kernel_shapes() as calls:
        tr, out["fit_s"], out["launches"] = run_path(
            lambda: m.fit(X, epochs=2, batch_size=200))
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out["shapes"] = shape_counts(calls)
    out["history"] = tr.loss_history["training_loss"]
    w = torch.ones(200, device="cuda")
    out["step_ms"] = host_ms(lambda: tr.train_step((xb,), w), reps=3,
                             warmup=1)
    out["checksum"] = checksum(m)
    return out


def rank_tp(mesh, X):
    """(d) on this rank: the flagship with its layers split over 'model'
    (the gate turns the kernels off, with its warning): the first step's
    loss and this rank's grads, then an epoch of 5 steps."""
    import warnings
    from pyroved_tpu_torch.parallel import tensor_parallel_params
    m = tensor_parallel_params(iVAE((28, 28), **PAR_KW), mesh)
    xb, eps = par_batch(X)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused = m.sync_fusion_gate()
    out = {"fused": fused, "warnings": [str(c.message) for c in caught]}
    out["first_loss"], grads = first_step_grads(m, xb, eps)
    out["first_grads"] = {n: g.cpu() for (n, _), g in
                          zip(m.nets.named_parameters(), grads)}
    out["split"] = sorted(n for n, mod in m.nets.named_modules()
                          if type(mod).__name__ == "ColumnParallelLinear")
    loss, _, out["launches"] = run_path(lambda: SVItrainer(m, mesh=mesh).train(
        init_dataloader(X[:1000], batch_size=200)))
    out["loss"] = loss
    return out


def rank_spmd(mesh, X):
    """(e) on this rank: 5 explicit SPMD steps, each rank on its 100 rows
    with noise of its own."""
    from pyroved_tpu_torch.parallel import make_spmd_train_step
    m = iVAE((28, 28), **PAR_KW)
    opt = torch.optim.Adam(m.nets.parameters(), lr=1e-3)
    step = make_spmd_train_step(m, opt, mesh)
    xb, _ = par_batch(X)
    w = torch.ones(200, device="cuda")
    with kernel_shapes() as calls:
        losses, _, launches = run_path(
            lambda: [step((xb,), w).item() for _ in range(5)])
    return {"losses": losses, "launches": launches,
            "shapes": shape_counts(calls), "checksum": checksum(m)}


def rank_decode(mesh, big, z):
    """(f) on this rank: the large grid's 64 latents decoded with the grid
    split over the ranks."""
    from pyroved_tpu_torch.parallel import pixel_sharded_decode
    with kernel_shapes() as calls:
        out, _, launches = run_path(
            lambda: pixel_sharded_decode(big, z, mesh))
    return {"out": out.cpu(), "launches": launches,
            "shapes": shape_counts(calls)}


def rank_tp_checkpoint(mesh, X, tmp):
    """(h) on this rank: the flagship split over 'model' trains 4 epochs in
    one go, and 2 epochs with a checkpoint (every rank gathers, rank 0
    writes the whole model); a whole model loads it with ``mesh=`` (its
    shards bitwise the saved ones) and resumes 2 epochs."""
    from pyroved_tpu_torch.parallel import tensor_parallel_params
    from pyroved_tpu_torch.parallel.mesh import whole_tensors
    from pyroved_tpu_torch.utils.checkpoint import load_checkpoint

    def split():
        return tensor_parallel_params(iVAE((28, 28), **PAR_KW), mesh)

    def loader(epoch=0):
        ld = init_dataloader(X[:TP_ROWS], batch_size=200, seed=3)
        ld.set_epoch(epoch)
        return ld

    def whole_sum(m):
        return float(sum(v.double().sum().item() * (i + 1) for i, v in
                         enumerate(whole_tensors(m.nets,
                                                 m.nets.state_dict())
                                   .values())))

    ckpt = os.path.join(tmp, "tp_state.npz")
    u = split()
    tu = SVItrainer(u, mesh=mesh, seed=4)
    tu.run(loader(), 4)
    i = split()
    SVItrainer(i, mesh=mesh, seed=4, checkpoint_path=ckpt,
               checkpoint_every=2).run(loader(), 2)
    saved = {k: v.detach().clone() for k, v in i.nets.state_dict().items()}
    r = iVAE((28, 28), **dict(PAR_KW, seed=5))
    load_checkpoint(ckpt, r, mesh=mesh)
    loaded = r.nets.state_dict()
    shards_equal = all(torch.equal(loaded[k], v) for k, v in saved.items())
    t = SVItrainer(r, mesh=mesh, seed=4)
    t.run(loader(t.resume(ckpt)), 2)
    return {"shards_equal": shards_equal, "saved_sum": whole_sum(i),
            "uninterrupted": whole_sum(u), "resumed": whole_sum(r),
            "history": tu.loss_history["training_loss"],
            "resumed_history": t.loss_history["training_loss"],
            "ckpt": ckpt}


def rank_bn_ved(mesh, tmp):
    """(i) on this rank: the batchnorm im2spec VED over 'data': the first
    step's loss and grads (its rows, the statistics and grads summed over
    the ranks), then 2 epochs (the last batch padded)."""
    from pyroved_tpu_torch.nets.conv import batch_stats_over
    x, y = (np.load(os.path.join(tmp, f"bn_{k}.npy")) for k in "xy")
    first = torch.load(os.path.join(tmp, "bn_first.pt"))
    m = VED((16, 16), (2048,), batchnorm=True, seed=0)
    t = SVItrainer(m, mesh=mesh, seed=6)
    (xb, yb), w, e = t.data_axis.local(first["batch"], first["w"],
                                       first["eps"])
    with batch_stats_over(m.nets, t.data_axis):
        loss = m.weighted_loss_fn(xb, yb, w, 1.0, eps=e)
        loss.backward()
    out = {"first_loss": t.data_axis.reduce_grads(t.optimizer, loss).item(),
           "first_grads": named_grads(m)}
    m.nets.zero_grad(set_to_none=True)
    ld = init_dataloader(x, y, batch_size=BN_BATCH, seed=2)
    out["history"] = [float(t.train(ld)) for _ in range(2)]
    out["checksum"] = checksum(m)
    return out


def rank_main(argv) -> int:
    """A rank of phase 12: ``chip_smoke.py --rank RANK WORLD RENDEZVOUS
    DIR KERNELS``. It loads the kernels from the parent's build directory
    KERNELS (``enable_compilation_cache``: no nvcc), joins the gloo
    group (gloo reduces CUDA tensors; NCCL takes one rank per card), runs
    (b)-(f) under each flag on the data the parent saved in DIR, writes
    its results there and destroys the group."""
    import torch.distributed as dist
    from pyroved_tpu_torch.parallel import create_mesh, initialize_multihost
    from pyroved_tpu_torch.utils.profiling import enable_compilation_cache
    rank, world, rdv, tmp = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enable_compilation_cache(argv[4])
    _build.load_all(list(SOURCES))
    initialize_multihost(f"file://{rdv}", world, rank, backend="gloo")
    try:
        meshes = {a: create_mesh({a: world}) for a in ("data", "pixels",
                                                       "model")}
        X = np.load(os.path.join(tmp, "flagship.npy"))
        X512 = np.load(os.path.join(tmp, "pixel512.npy"), mmap_mode="r")
        big = iVAE((128, 128), **PAR_KW)
        z = torch.load(os.path.join(tmp, "z_big.pt")).cuda()
        res = {}
        for on in (False, True):
            with bf16_matmul(on):
                res[on] = {"dp": rank_dp(meshes["data"], X, tmp),
                           "pixels": rank_pixels(meshes["pixels"], X512),
                           "tp": rank_tp(meshes["model"], X),
                           "spmd": rank_spmd(meshes["data"], X),
                           "decode": rank_decode(meshes["data"], big, z)}
        res["h"] = rank_tp_checkpoint(meshes["model"], X, tmp)
        res["i"] = rank_bn_ved(meshes["data"], tmp)
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def phase_one_rank(X):
    """(a) under each flag: one NCCL rank in this process (its own
    in-memory store); the flagship's fit on data_parallel_mesh() bitwise
    equal to the same fit without a mesh, one K1 and one K2 a step."""
    import torch.distributed as dist
    from pyroved_tpu_torch.parallel import (data_parallel_mesh,
                                            initialize_multihost)
    if initialize_multihost() != 1 or dist.get_backend() != "nccl":
        raise AssertionError("initialize_multihost() is not one NCCL rank")
    out = {}
    try:
        mesh = data_parallel_mesh()
        for on in (False, True):
            with bf16_matmul(on):
                tag = "bf16" if on else "f32"
                ref_model = iVAE((28, 28), **PAR_KW)
                ref = ref_model.fit(X, epochs=3, batch_size=200)
                m = iVAE((28, 28), **PAR_KW)
                tr, secs, launches = run_path(
                    lambda: m.fit(X, epochs=3, batch_size=200, mesh=mesh))
                expect_steps(f"(a) {tag} one NCCL rank, fit(mesh="
                             f"data_parallel_mesh()), {secs:.2f} s",
                             launches, 30)
                if (tr.loss_history != ref.loss_history
                        or checksum(m) != checksum(ref_model)):
                    raise AssertionError(f"(a) {tag}: the one-rank mesh's fit "
                                         "is not bitwise the fit without one")
                out[tag] = {"history": tr.loss_history["training_loss"],
                            "fit_s": secs, "launches": launches}
                log(f"  (a) {tag}: losses {out[tag]['history']} bitwise the "
                    f"fit without a mesh, parameters bitwise equal")
    finally:
        dist.destroy_process_group()
    return out


def start_ranks(tmp, world=2):
    """The ranks of phase 12, each ``chip_smoke.py --rank`` in a child
    process with its output in ``tmp``."""
    rdv = os.path.join(tmp, "rendezvous")
    procs = []
    for r in range(world):
        f = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             str(world), rdv, tmp, _build.BUILD_DIR], cwd=ROOT,
            env=child_env(), stdout=f,
            stderr=subprocess.STDOUT), f))
    return procs


def finish_ranks(tmp, procs):
    """Wait for the ranks (each killed at RANK_TIMEOUT seconds from now);
    raises on a non-zero exit or a kill, with the ranks' output; returns
    each rank's results."""
    deadline = time.perf_counter() + RANK_TIMEOUT
    failed = []
    for r, (p, f) in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {r} outlasted {RANK_TIMEOUT} s")
        f.close()
    for r, (p, _) in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
        elif p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}")
    if failed:
        logs = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-4000:]
                       for r in range(len(procs)))
        raise AssertionError(f"phase 12: {', '.join(failed)}\n{logs}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def check_ranks(what, outs, key="checksum"):
    if len({o[key] for o in outs}) != 1:
        raise AssertionError(f"{what}: the ranks' parameters differ")


def expect_shapes(what, shapes, **expected):
    """The kernel calls by (kernel, B, N) of one rank's path, exactly."""
    if shapes != expected:
        raise AssertionError(f"{what}: kernel calls {shapes}, expected "
                             f"{expected}")


def check_parallel(on, outs, ref, res, launches, module_first,
                   module_names, smi):
    """Phase 12 (b)-(f) under one flag: the ranks' results ``outs``
    against the single-process references ``ref`` (and the module path's
    first step); adds the flag's entry to ``res`` and its paths to
    ``launches``."""
    tag = "bf16" if on else "f32"
    k1, k2, k3 = (("K1_bf16", "K2_bf16", "K3_bf16") if on
                  else ("K1", "K2", "K3"))
    r = res[tag] = {}
    grad_rel = BF16_MODULE_GRAD_REL if on else GRAD_RTOL
    # (b) data parallel, flagship at full width
    dp = [o[on]["dp"] for o in outs]
    for i, d in enumerate(dp):
        expect_steps(f"(b) {tag} rank {i} fit 2 epochs, "
                     f"{d['fit_s']:.2f} s", d["launches"], 20)
        expect_shapes(f"(b) {tag} rank {i}", d["shapes"],
                      **{"K1 B=100 N=784": 20, "K2 B=100 N=784": 20})
        if not only(d["one_pass_launches"], **{k3: 5}):
            raise AssertionError(f"(b) {tag} one_pass: "
                                 f"{d['one_pass_launches']}")
        expect_shapes(f"(b) {tag} rank {i} one_pass", d["one_pass_shapes"],
                      **{"K3 B=100 N=784": 5})
    check_ranks(f"(b) {tag}", dp)
    got = [dp[0]["first_grads"][n] for n in module_names]
    want = [g.cpu() for g in ref["first"][1]]
    err = check_grads(f"(b) {tag} first step, 2 ranks' summed grads vs "
                      f"one process", got, want, module_names,
                      per_sample=0, rel=grad_rel)
    err_rel = rel_to_max(got, want)
    loss_rel = abs(dp[0]["first_loss"] - ref["first"][0]) / abs(
        ref["first"][0])
    epoch_rel = check_epochs(f"(b) {tag} 2 ranks", dp[0]["history"],
                             ref["history"], "one process")
    if (dp[0]["resumed_history"] != dp[0]["history"]
            or any(d["resumed_checksum"] != d["checksum"] for d in dp)):
        raise AssertionError(f"(b) {tag}: the resumed run is not "
                             "bitwise the uninterrupted one")
    log(f"  (b) {tag}: 2 ranks x 100 rows, first step loss rel "
        f"{loss_rel:.2e}, grads max abs err {err:.3e} ({err_rel:.1e} of "
        f"the largest entry); losses "
        f"{dp[0]['history']} vs one process {ref['history']} (max rel "
        f"{epoch_rel:.2e}); ranks' parameters bitwise equal; resumed "
        f"run bitwise; one_pass 5 {k3} a rank, loss "
        f"{dp[0]['one_pass_loss']:.4f}")
    r["dp"] = {"history": dp[0]["history"], "fit_s": dp[0]["fit_s"],
               "first_step_err": err, "first_step_rel": err_rel,
               "first_loss_rel": loss_rel, "epoch_rel": epoch_rel}
    # (c) pixels: the 512x512 grid split over the two ranks
    px = [o[on]["pixels"] for o in outs]
    for i, p in enumerate(px):
        expect_steps(f"(c) {tag} rank {i} 512x512 fit 2 epochs, "
                     f"{p['fit_s']:.2f} s", p["launches"], 4)
        expect_shapes(f"(c) {tag} rank {i}", p["shapes"],
                      **{f"K1 B=200 N={HALF}": 4,
                         f"K2 B=200 N={HALF}": 4})
    check_ranks(f"(c) {tag}", px)
    loss_rtol = LOSS_RTOL if on else 1e-5
    ref_first = (ref["first512"][0], [g.cpu() for g in ref["first512"][1]])
    c_err = max(first_step_vs(f"(c) {tag} rank {i} 512x512 sharded vs "
                              "full grid", p["first"], ref_first,
                              loss_rtol, BF16_GRAD_REL if on
                              else GRAD_RTOL)
                for i, p in enumerate(px))
    log(f"  (c) {tag}: per rank peak {[round(p['peak_mib'], 1) for p in px]}"
        f" MiB above the model (the full grid on one rank: 2290.6 MiB, "
        f"PERF.md section 5), step {[round(p['step_ms'], 2) for p in px]} "
        f"ms wall, losses {px[0]['history']} ({smi}; two ranks share "
        "one card: no speed-up is claimed)")
    r["pixels"] = {k: [p[k] for p in px] for k in ("peak_mib", "step_ms",
                                                   "fit_s", "history")}
    r["pixels"]["first_step_err"] = c_err
    # (d) tensor parallel: no kernel, the module path's numbers
    tp = [o[on]["tp"] for o in outs]
    for i, d in enumerate(tp):
        if d["fused"] or not any("disabling the fused" in w
                                 for w in d["warnings"]):
            raise AssertionError(f"(d) {tag} rank {i}: the gate did not "
                                 f"turn the kernels off: {d['warnings']}")
        if not only(d["launches"]):
            raise AssertionError(f"(d) {tag} rank {i} launched "
                                 f"{d['launches']}")
        got, refg = [], []
        for n, g in zip(module_names, module_first[1]):
            g = g.cpu()
            if any(n.startswith(s + ".") for s in d["split"]):
                o = g.shape[0] // 2
                g = g[i * o:(i + 1) * o]
            got.append(d["first_grads"][n])
            refg.append(g)
        d_err = check_grads(f"(d) {tag} rank {i} first step vs module "
                            "path", got, refg, module_names,
                            per_sample=0, rel=GRAD_RTOL)
        d_rel = rel_to_max(got, refg)
        if abs(d["first_loss"] - module_first[0]) > LOSS_RTOL * abs(
                module_first[0]):
            raise AssertionError(f"(d) {tag}: first step loss "
                                 f"{d['first_loss']} vs {module_first[0]}")
    log(f"  (d) {tag}: {{'model': 2}} split {len(tp[0]['split'])} layers, "
        f"the gate warned and turned the kernels off, 0 launches; first "
        f"step loss {tp[0]['first_loss']:.4f} vs the module path "
        f"{module_first[0]:.4f}, grads max abs err {d_err:.3e} ({d_rel:.1e} "
        f"of the largest entry)")
    r["tp"] = {"first_loss": tp[0]["first_loss"], "grad_err": d_err,
               "grad_rel": d_rel}
    # (e) the explicit SPMD step
    sp = [o[on]["spmd"] for o in outs]
    for i, d in enumerate(sp):
        if not only(d["launches"], **{k1: 5, k2: 5}):
            raise AssertionError(f"(e) {tag} rank {i}: {d['launches']}")
        expect_shapes(f"(e) {tag} rank {i}", d["shapes"],
                      **{"K1 B=100 N=784": 5, "K2 B=100 N=784": 5})
    if not (all(np.isfinite(sp[0]["losses"]))
            and sp[0]["losses"][-1] < sp[0]["losses"][0]):
        raise AssertionError(f"(e) {tag}: loss not falling "
                             f"{sp[0]['losses']}")
    check_ranks(f"(e) {tag}", sp)
    log(f"  (e) {tag}: 5 SPMD steps, losses {sp[0]['losses']}, one {k1} "
        f"and one {k2} a step a rank, ranks' parameters bitwise equal")
    r["spmd"] = {"losses": sp[0]["losses"]}
    # (f) pixel_sharded_decode
    dec = [o[on]["decode"] for o in outs]
    for i, d in enumerate(dec):
        if not only(d["launches"], **{k1: 1}):
            raise AssertionError(f"(f) {tag} rank {i}: {d['launches']}")
        expect_shapes(f"(f) {tag} rank {i}", d["shapes"],
                      **{"K1 B=64 N=8192": 1})
        f_err = check_close(f"(f) {tag} rank {i} sharded decode vs one "
                            "process", d["out"], ref["decode"],
                            *((BF16_ATOL, BF16_OUT_REL) if on
                              else (ATOL, 0.0)))
    log(f"  (f) {tag}: 64 latents on the 128x128 grid, one {k1} a rank "
        f"at N = 8192, gathered: max abs err vs one process {f_err:.3e}")
    r["decode_err"] = f_err
    for i, o in enumerate(outs):
        for path in ("dp", "pixels", "tp", "spmd", "decode"):
            launches[f"parallel_{path}_rank{i}_{tag}"] = \
                o[on][path]["launches"]
        launches[f"parallel_dp_one_pass_rank{i}_{tag}"] = \
            o[on]["dp"]["one_pass_launches"]


def bn_first_step():
    """(i)'s first batch (100 pairs, the last 20 padded with weight 0) and
    its loss and grads in this process: the batchnorm VED whole; then the
    same with the batch's rows reversed (the same function, every sum in
    another order), whose distance from the first is the noise floor of
    the grads."""
    x, y = im2spec_pairs(BN_BATCH, seed=5)
    g = torch.Generator(device="cuda").manual_seed(8)
    w = torch.ones(BN_BATCH, device="cuda")
    w[-20:] = 0.0
    inputs = {"batch": (torch.as_tensor(x, device="cuda"),
                        torch.as_tensor(y, device="cuda")),
              "w": w, "eps": torch.randn(BN_BATCH, 2, generator=g,
                                         device="cuda")}
    out = {"inputs": inputs}
    reverse = torch.arange(BN_BATCH - 1, -1, -1, device="cuda")
    for key, rows in (("", torch.arange(BN_BATCH, device="cuda")),
                      ("reversed_", reverse)):
        m = VED((16, 16), (2048,), batchnorm=True, seed=0)
        loss = m.weighted_loss_fn(*(b[rows] for b in inputs["batch"]),
                                  w[rows], 1.0, eps=inputs["eps"][rows])
        loss.backward()
        out[key + "loss"], out[key + "grads"] = loss.item(), named_grads(m)
    return out


def check_tp_checkpoint(outs, X):
    """(h): the ranks' shards loaded bitwise, the resumed run bitwise the
    uninterrupted one; the file (the whole model) loads into a whole model
    here, which trains on."""
    from pyroved_tpu_torch.utils.checkpoint import load_checkpoint
    for i, o in enumerate(outs):
        if not o["shards_equal"]:
            raise AssertionError(f"(h) rank {i}: load_checkpoint(mesh=) did "
                                 "not restore its shards bitwise")
        if (o["resumed"] != o["uninterrupted"]
                or o["resumed_history"] != o["history"]):
            raise AssertionError(f"(h) rank {i}: the resumed run is not "
                                 "bitwise the uninterrupted one")
    m = iVAE((28, 28), **dict(PAR_KW, seed=5))
    t = SVItrainer(m, seed=4)
    epoch = t.resume(outs[0]["ckpt"])
    whole = float(sum(v.double().sum().item() * (i + 1) for i, v in
                      enumerate(dict(sorted(m.nets.state_dict().items()))
                                .values())))
    if whole != outs[0]["saved_sum"]:
        raise AssertionError(f"(h) the whole model's parameters from the "
                             f"file ({whole}) are not the gathered ones "
                             f"({outs[0]['saved_sum']})")
    ld = init_dataloader(X[:TP_ROWS], batch_size=200, seed=3)
    ld.set_epoch(epoch)
    more = t.train(ld)
    if not np.isfinite(more):
        raise AssertionError(f"(h) training on from the file: loss {more}")
    log(f"  (h) {{'model': 2}}: 4 epochs {outs[0]['history']}; resumed at "
        f"epoch 2 from the whole-model file bitwise equal on both ranks; "
        f"the file loads into a whole model (parameters equal to the "
        f"gathered ones) and trains on: loss {more:.4f}")
    return {"history": outs[0]["history"], "whole_epoch3_loss": more}


def check_bn_ved(outs, first, x, y):
    """(i): the batchnorm VED over 'data' on two ranks against one process:
    the first step's loss at phase 8's bound and its grads at phase 8's
    or within twice the one-process noise floor (the step on the batch's
    reversed rows; the conv before a batchnorm sums terms that cancel, so
    its weight grads move with the order of the sums), whichever is
    larger; 2 epochs' losses at phase 5's; the ranks' parameters bitwise
    equal."""
    check_ranks("(i)", outs)
    names = list(first["grads"])
    got = [outs[0]["first_grads"][n] for n in names]
    want = [first["grads"][n].cpu() for n in names]
    floor = rel_to_max([first["reversed_grads"][n].cpu() for n in names],
                       want)
    err = check_grads("(i) batchnorm VED, 2 ranks' first step vs one "
                      "process", got, want, names, per_sample=0,
                      rel=max(GRAD_RTOL, 2 * floor))
    loss_rel = abs(outs[0]["first_loss"] - first["loss"]) / abs(first["loss"])
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"(i) first step loss rel err {loss_rel:.3e}")
    m = VED((16, 16), (2048,), batchnorm=True, seed=0)
    t = SVItrainer(m, seed=6)
    ld = init_dataloader(x, y, batch_size=BN_BATCH, seed=2)
    ref = [float(t.train(ld)) for _ in range(2)]
    with bf16_matmul(False):
        epoch_rel = check_epochs("(i) batchnorm VED, 2 ranks",
                                 outs[0]["history"], ref, "one process")
    log(f"  (i) batchnorm VED on {{'data': 2}}: first step loss rel "
        f"{loss_rel:.2e}, grads max abs err {err:.3e} "
        f"({rel_to_max(got, want):.1e} of the largest entry; the one "
        f"process's on the reversed rows {floor:.1e}); losses "
        f"{outs[0]['history']} vs one process {ref} (max rel "
        f"{epoch_rel:.2e}); ranks' parameters bitwise equal")
    return {"first_loss_rel": loss_rel, "grad_err": err,
            "grad_rel": rel_to_max(got, want), "grad_floor": floor,
            "epoch_rel": epoch_rel, "history": outs[0]["history"]}


def phase_parallel(smi, peaks):
    """Phase 12: (a) in this process, (b)-(f) on two gloo ranks in child
    processes sharing the card, each against single-process references
    computed here first; then (g) K1 and K2 at the new shapes. Two ranks on
    one card measure correctness and each rank's memory, not scaling.
    Returns (results, launches by path, K1 rows, K2/K3 rows)."""
    t0 = time.perf_counter()
    X = blobs(PAR_ROWS, (28, 28), seed=21)
    X512 = blobs(400, PIXEL_DIM, seed=9)
    res = {"one_rank": phase_one_rank(X)}
    launches = {f"parallel_one_rank_{t}": r["launches"]
                for t, r in res["one_rank"].items()}
    big = iVAE((128, 128), **PAR_KW)
    z_big = torch.as_tensor(np.random.default_rng(12).normal(size=(64, 2)),
                            dtype=torch.float32)
    refs = {}
    for on in (False, True):  # the single-process references
        with bf16_matmul(on):
            m = iVAE((28, 28), **PAR_KW)
            xb, eps = par_batch(X)
            r = refs[on] = {"first": first_step_grads(m, xb, eps)}
            r["history"] = m.fit(X, epochs=2, batch_size=200).loss_history[
                "training_loss"]
            m512 = iVAE(PIXEL_DIM, **PIXEL)
            xb5, eps5 = par_batch(X512, seed=13)
            r["first512"] = first_step_grads(m512, xb5, eps5)
            with torch.no_grad():
                r["decode"] = big.decode(z_big).reshape(64, -1).cpu()
    module = iVAE((28, 28), fused=False, **PAR_KW)
    xb, eps = par_batch(X)
    module_first = first_step_grads(module, xb, eps)
    module_names = [n for n, _ in module.nets.named_parameters()]
    del m, m512, module
    torch.cuda.empty_cache()
    bn_x, bn_y = im2spec_pairs(BN_ROWS, seed=4)
    bn_first = bn_first_step()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "flagship.npy"), X)
        np.save(os.path.join(tmp, "pixel512.npy"), X512)
        torch.save(z_big, os.path.join(tmp, "z_big.pt"))
        np.save(os.path.join(tmp, "bn_x.npy"), bn_x)
        np.save(os.path.join(tmp, "bn_y.npy"), bn_y)
        torch.save(bn_first["inputs"], os.path.join(tmp, "bn_first.pt"))
        t_ranks = time.perf_counter()
        outs = finish_ranks(tmp, start_ranks(tmp))
        ranks_s = time.perf_counter() - t_ranks
        res["h"] = check_tp_checkpoint([o["h"] for o in outs], X)
    res["i"] = check_bn_ved([o["i"] for o in outs], bn_first, bn_x, bn_y)
    log(f"  two gloo ranks on the card ran (b)-(f) under each flag, (h) and "
        f"(i) in {ranks_s:.1f} s ({smi})")
    for on in (False, True):
        with bf16_matmul(on):
            check_parallel(on, outs, refs[on], res, launches, module_first,
                           module_names, smi)
    # (g) K1 and K2 at the new shapes
    k1_rows = {False: [], True: []}
    rows = {(k, on): [] for k in ("K2", "K3") for on in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(17)
    m = iVAE((28, 28), **PAR_KW)
    xb, eps = par_batch(X)
    a100, xf100 = train_args(m, xb[:100], eps[:100])
    m512 = iVAE(PIXEL_DIM, **PIXEL)
    xb5, eps5 = par_batch(X512, seed=13)
    a_half = tile_args(train_args(m512, xb5, eps5)[0], slice(0, HALF))
    for name, a, xf, chunks in (("data-parallel rank", a100, xf100, 1),
                                ("512x512 pixel rank", a_half, None,
                                 HALF_CHUNKS)):
        with torch.no_grad():
            for on, row in time_k1(name, a, peaks, chunks).items():
                k1_rows[on].append(row)
        for key, row in time_bwd(name, a, xf, gen, peaks,
                                 with_k3=xf is not None,
                                 chunks=chunks).items():
            rows[key].append(row)
    del a_half, m512
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["ranks_seconds"] = ranks_s
    return res, launches, k1_rows, rows


# Phase 13: K4, the backward in ablation modes (ops/bwd_ablation.py), at
# the three shapes whose logical tiles JAX's _select_tiles picks: the
# flagship (B = 200, N = 784 -> 896, tiles (40, 128)), the enumerated rows
# (B = 2,000, (40, 128)) and the large grid (B = 64, N = 16,384, (8, 640));
# H = 128, two layers, L = 4 (tools/bwd_ablation.py's inputs). Its chains
# of launches (CHAIN_LEN at the flagship, 50 at the others) are the path
# whose launches are counted.
ABL_SHAPES = (("flagship", 200, 784, 40, 128, abt.CHAIN_LEN),
              ("enumerated rows", 2000, 784, 40, 128, 50),
              ("large grid", 64, 16384, 8, 640, 50))
ABL_H, ABL_L, ABL_LAYERS = 128, 4, 2
K2_ARGS = ("grid", "phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb",
           "wout", "bout")


def start_ablation_build():
    """The sixteen ablation libraries (8 modes x 2 sources) built by a
    child process at low priority while phases 2-12 run, one nvcc each,
    all started together; phase 13 waits for it. Returns (process, start
    time)."""
    import atexit
    proc = subprocess.Popen(
        [sys.executable, "-c", "from pyroved_tpu_torch.ops import "
         "bwd_ablation as ab; ab.load_all()"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(10))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def check_full_vs_k2(what, got, ref, on):
    """``full`` against the production K2 on the same arrays, phase 2's
    tolerance (every grad to its tensor's largest entry). Under the flag K2
    rounds h_L and dl to bf16 for dwout where ``full`` keeps f32 (JAX's
    ablation kernel does), so dwout is left to :func:`dwout_rounding_bound`
    there. Returns the largest absolute error."""
    ref = [r.reshape(g.shape) for g, r in zip(got, ref)]
    keep = [i for i in range(11) if not (on and i == 9)]
    err = check_grads(what, [got[i] for i in keep], [ref[i] for i in keep],
                      names=[ab.OUTPUT_NAMES[i] for i in keep], per_sample=0,
                      rel=BF16_GRAD_REL if on else GRAD_RTOL)
    return err


def dwout_rounding_bound(a):
    """2^-8 of sum |h_L| |dl| per unit: how far rounding h_L and dl to
    bf16 can move dwout (f32 plain forward on the card)."""
    hs, _, _ = sd._folded_forward(*(a[k] for k in K2_ARGS[:10]), act="tanh")
    s = torch.sigmoid(hs[-1] @ a["wout"] + a["bout"])[..., 0]
    dl = a["g"] * s * (1 - s)
    bound = 2.0 ** -8 * (hs[-1].abs() * dl.abs()[..., None]).sum((0, 1))
    del hs
    return bound


def phase_ablation(smi, peaks, build):
    """Phase 13: every mode of both sources against its plain version at
    the three shapes (phase 2's tolerances, two launches bitwise equal),
    ``full`` against the production K2, then the timed chains (the counted
    path) and the attribution."""
    t13 = time.perf_counter()
    proc, t_build = build
    out = proc.communicate(timeout=900)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"the ablation builds failed:\n{out}")
    ab.load_all()
    log(f"  the 16 ablation libraries built in a child process started after "
        f"phase 1 ({time.perf_counter() - t_build:.1f} s since its start); "
        f"ptxas, registers and spills of each:")
    usage = {}
    for on in (True, False):
        for mode in ab.MODES:
            usage[f"{sd.BWD_SOURCES[on]} {mode}"] = ptxas_usage(
                _build.build_log(sd.BWD_SOURCES[on], ab.defines(mode)))
            log(f"    {sd.BWD_SOURCES[on]} {mode}: "
                f"{json.dumps(usage[f'{sd.BWD_SOURCES[on]} {mode}'])}")
    res = {"bf16" if on else "f32": {} for on in (True, False)}
    errs = {True: 0.0, False: 0.0}
    for on in (False, True):
        tag = "bf16" if on else "f32"
        with bf16_matmul(on):
            for name, B, N, b_t, n_t, _ in ABL_SHAPES:
                a = abt.inputs(B, N, ABL_H, ABL_L, ABL_LAYERS, b_t, n_t)
                kw = dict(n_layers=ABL_LAYERS, b_t=b_t, n_t=n_t)
                label = (f"K4 {tag} {name} B={a['g'].shape[0]} "
                         f"N={a['g'].shape[1]} tiles ({b_t}, {n_t})")
                rows = res[tag][name] = {}
                for mode in ab.MODES:
                    what = f"{label} {mode}"
                    got = ab.variant(mode, **a, **kw)
                    again = ab.variant(mode, **a, **kw)
                    ref = ab.variant_plain(mode, **a, **kw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(p, q) for p, q in zip(got, again)):
                        raise AssertionError(f"{what}: two launches differ")
                    err = check_grads(what, got, ref, names=ab.OUTPUT_NAMES,
                                      per_sample=0,
                                      rel=BF16_GRAD_REL if on else GRAD_RTOL)
                    rows[mode] = {"max_abs_err": err,
                                  "rel_to_max": rel_to_max(got, ref)}
                    if mode == "full":
                        k2 = K2(**{k: a[k] for k in K2_ARGS}, g=a["g"])
                        rows[mode]["k2_err"] = check_full_vs_k2(
                            f"{what} vs K2", got, k2, on)
                        if on:
                            gap = (got[9][0] - k2[9].reshape(-1)).abs()
                            bound = dwout_rounding_bound(a)
                            if not bool((gap <= bound + 1e-6).all()):
                                raise AssertionError(
                                    f"{what} vs K2: dwout beyond bf16 "
                                    f"rounding ({gap.max().item():.3e})")
                            rows[mode]["k2_dwout_gap_over_bound"] = (
                                gap / (bound + 1e-6)).max().item()
                        del k2
                    errs[on] = max(errs[on], err)
                    del got, again, ref
                    rows[mode]["plain_ms"] = cuda_ms(
                        lambda: ab.variant_plain(mode, **a, **kw), reps=3,
                        warmup=1)
                    rows[mode]["bound_ms"], rows[mode]["bound_by"] = (
                        abt.bound_ms(mode, a, on, peaks))
                    rows[mode]["library_ms"] = abt.library_ms(mode, a, on)
                log(f"  {label}: every mode against its plain version, "
                    f"max abs err {max(r['max_abs_err'] for r in rows.values()):.3e}"
                    f" (worst {max(r['rel_to_max'] for r in rows.values()):.1e} "
                    f"of the largest entry), bitwise equal across launches; "
                    f"full against K2: {rows['full']['k2_err']:.3e}")
                del a
    # the counted path: the timed chains (tools/bwd_ablation.py), counts
    # set to 0 just before and read just after
    for k in ab.variant.launches:
        ab.variant.launches[k] = 0
    attribution = {}
    for on in (False, True):
        tag = "bf16" if on else "f32"
        with bf16_matmul(on):
            for name, B, N, b_t, n_t, chain in ABL_SHAPES:
                a = abt.inputs(B, N, ABL_H, ABL_L, ABL_LAYERS, b_t, n_t)
                us = {}
                for mode in ab.MODES:
                    ms, host = abt.chain_ms(mode, a, ABL_LAYERS, b_t, n_t,
                                            chain)
                    res[tag][name][mode].update(ms=ms, host_ms=host,
                                                chain=chain)
                    if name == "flagship":  # where the host may set the pace
                        res[tag][name][mode]["busy_ms"] = abt.busy_ms(
                            mode, a, ABL_LAYERS, b_t, n_t)[0]
                    us[mode] = 1e3 * ms
                lines = abt.attribution(us)
                attribution[f"{tag} {name}"] = lines
                rows = res[tag][name]
                log(f"  K4 {tag} {name}, chains of {chain} (us a call; host "
                    f"time to enqueue one"
                    + (", device busy" if "busy_ms" in rows["full"] else "")
                    + "): " + ", ".join(
                        f"{m} {u:.1f} ({1e3 * rows[m]['host_ms']:.1f}"
                        + (f", {1e3 * rows[m]['busy_ms']:.1f}"
                           if "busy_ms" in rows[m] else "") + ")"
                        for m, u in us.items()) + f" ({smi})")
                for line in lines:
                    log("  " + line)
                del a
    launches = dict(ab.variant.launches)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"phase 13's chains did not launch {missing}")
    log(f"  launches on the chains: {json.dumps(launches)}")
    return {"modes": res, "attribution": attribution, "launches": launches,
            "errs": errs, "ptxas": usage, "seconds": time.perf_counter() - t13}


# -- phase 14: captured epochs ------------------------------------------------

CAP_EPOCHS = 3  # epochs of each trajectory, captured and eager
CAP_TIMED = 3   # epochs timed after them, each way


def cap_cases():
    """The captured phase's models: (name, make(), loaders(), training
    steps an epoch, K1 and K2 launches (K3 under one_pass_train) an
    epoch). Each ``make``
    draws the same weights and noise every time; each ``loaders`` the same
    rows in the same order."""
    flag = dict(latent_dim=2, invariances=["r"], seed=0)
    X = blobs(10000, (28, 28), seed=1)
    Xt = blobs(1000, (28, 28), seed=7)
    U = np.random.default_rng(0).uniform(0, 1, (2000, 28, 28)).astype(
        np.float32)  # benchmarks/enum_bench.py:31-46
    G = blobs(1024, (128, 128), seed=1)  # bench.py:99-120
    Xf, y, _ = family_data()
    labels = np.eye(N_CLASSES, dtype=np.float32)[y]

    def svi(m, **kw):
        return m, SVItrainer(m, **kw)

    def ss():
        m = ssiVAE(FAMILY_DIM, num_classes=N_CLASSES, **FAMILY)
        return m, auxSVItrainer(m)

    return (
        ("flagship", lambda: svi(iVAE((28, 28), **flag)),
         lambda: (init_dataloader(X, batch_size=200, seed=0),
                  init_dataloader(Xt, batch_size=200, seed=0)), 50, 50),
        ("flagship one_pass_train", lambda: svi(iVAE(
            (28, 28), one_pass_train=True, **flag)),
         lambda: (init_dataloader(X, batch_size=200, seed=0),), 50, 50),
        ("jiVAE enumerated", lambda: svi(jiVAE(
            (28, 28), latent_dim=2, discrete_dim=10, invariances=["r"],
            seed=1)),
         lambda: (init_dataloader(U, batch_size=200, seed=0),), 10, 10),
        # 10 unlabeled steps an epoch, a labeled one after the 2nd and the
        # 8th (phase 7's schedule), each decoding once
        ("ssiVAE", ss,
         lambda: init_ssvae_dataloaders(
             Xf, (Xf[:400], labels[:400]), (Xf[:400], labels[:400]),
             batch_size=200), 10, 12),
        ("large grid", lambda: svi(iVAE((128, 128), latent_dim=2,
                                        invariances=["r"], seed=1)),
         lambda: (init_dataloader(G, batch_size=64, seed=0),), 16, 16))


def cap_epoch(trainer, loaders):
    """One epoch queued through the trainer's ``step`` (training, and the
    held-out loss or the labeled-set metric when a third loader is
    given)."""
    if isinstance(trainer, auxSVItrainer):
        trainer.step(loaders[0], loaders[1],
                     loaders[2] if len(loaders) > 2 else None, sync=False)
    else:
        trainer.step(loaders[0], loaders[1] if len(loaders) > 1 else None,
                     sync=False)


def record_step_losses(trainer, captured):
    """A list that collects the training steps' losses of ``trainer``'s
    epochs, in order: on the captured path each training program's loss
    table after each of its runs (a chunk's, or an epoch's), read outside
    the graph; on the eager loop each training step's loss. Returns it and
    the (object, attribute) whose deletion stops the recording."""
    seen = []
    if captured:
        cache = trainer._graphs
        run = cache.run

        def recording(tr, kind, *a, **k):
            out = run(tr, kind, *a, **k)
            if kind in (("svi", True), ("aux",)):  # the one run last
                seen.append(next(reversed(
                    cache.programs.values())).tables.losses.clone())
            return out
        cache.run = recording
        return seen, (cache, "run")
    method = ("_batch_loss" if isinstance(trainer, SVItrainer)
              else "unsup_step")
    inner = getattr(trainer, method)

    def eager(*a, **k):
        out = inner(*a, **k)
        if method != "_batch_loss" or a[3]:  # training steps only
            seen.append(out.detach().clone().reshape(1))
        return out
    setattr(trainer, method, eager)
    return seen, (trainer, method)


def h2d_bytes(loaders):
    return sum(getattr(ld, "host_to_device_bytes", 0) for ld in loaders
               if ld is not None)


def trajectory(make, loaders, epochs, captured):
    """``epochs`` epochs of a fresh model through its trainer's ``step``,
    captured or with ``CAPTURE`` cleared, counted as one path: the model,
    its trainer, every training step's loss, each epoch's seconds (host
    clock to the device's end) and all of them, the launches, the bytes
    copied to the device and the device's peak memory above what was
    allocated before."""
    from pyroved_tpu_torch.trainers import _graph
    _graph.CAPTURE = captured
    try:
        model, trainer = make()
        lds = loaders()
        seen, recorder = record_step_losses(trainer, captured)
        epoch_s = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def go():
            for _ in range(epochs):
                t0 = time.perf_counter()
                cap_epoch(trainer, lds)
                torch.cuda.synchronize()
                epoch_s.append(time.perf_counter() - t0)
            trainer.sync_history()
        _, secs, launches = run_path(go)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        delattr(*recorder)
    finally:
        _graph.CAPTURE = True
    return {"model": model, "trainer": trainer, "loaders": lds,
            "losses": torch.cat(seen), "epoch_s": epoch_s, "seconds": secs,
            "launches": launches, "h2d_bytes": h2d_bytes(lds),
            "peak_mib": peak}


def cap_same(what, a, b):
    """Raise unless runs ``a`` and ``b`` are bitwise equal: parameters,
    buffers, per-step losses, history, optimizer states and the noise
    generator's state."""
    ta, tb = a["trainer"], b["trainer"]
    for (n, p), q in zip(a["model"].nets.state_dict().items(),
                         b["model"].nets.state_dict().values()):
        if not torch.equal(p, q):
            raise AssertionError(f"{what}: {n} differs by "
                                 f"{(p.float() - q.float()).abs().max():.3e}")
    if not torch.equal(a["losses"], b["losses"]):
        gap = (a["losses"] - b["losses"]).abs().max().item()
        raise AssertionError(f"{what}: the per-step losses differ by {gap}")
    hist = (lambda t: getattr(t, "loss_history", None) or t.history)
    if hist(ta) != hist(tb):
        raise AssertionError(f"{what}: history {hist(ta)} != {hist(tb)}")
    for name in ("optimizer", "aux_optimizer"):
        oa, ob = getattr(ta, name, None), getattr(tb, name, None)
        if oa is None:
            continue
        for sa, sb in zip(oa.state_dict()["state"].values(),
                          ob.state_dict()["state"].values()):
            if not all(torch.equal(sa[k], sb[k]) for k in sa):
                raise AssertionError(f"{what}: the {name}'s state differs")
    if not torch.equal(ta.generator.get_state(), tb.generator.get_state()):
        raise AssertionError(f"{what}: the noise generators' states differ")


def idle_gaps(spans, n=3):
    """The ``n`` longest stretches (ms) in which the device ran none of
    the (start, end) intervals ``spans`` (µs), between its first start and
    its last end."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((a - end) / 1e3)
        end = b if end is None else max(end, b)
    return sorted(gaps, reverse=True)[:n]


#: takes of a profiled epoch at most (:func:`profile_epoch`)
PROFILE_TAKES = 3


def profile_epoch(fn, host=True):
    """One epoch ``fn()`` under torch.profiler: the device's busy time (the
    union of its kernels' and copies' intervals), its kernels' alone and
    its host-to-device copies' alone (ms), its three longest idle gaps,
    K1's and K2's launches by their ``__global__`` names, and, with
    ``host``, the host's CUDA API calls by name (tracing the host's
    operators costs seconds an eager epoch); ``launched``, the K1 and K2
    launches the counters counted in it, by those names. The profiler
    now and then loses some of the device's records, on the eager loop
    and in graph replays alike (the parent tree's eager loop too): a
    profile that names fewer K1 or K2 launches than were counted is taken
    again, with another epoch and the host traced too, at most
    :data:`PROFILE_TAKES` times (``takes``); the callers' checks hold the
    last one. The window opens and closes 50 ms from the epoch's work."""
    names = {"K1": GLOBALS["K1", False], "K1_bf16": GLOBALS["K1", True],
             "K2": GLOBALS["K2", False], "K2_bf16": GLOBALS["K2", True],
             "K3": GLOBALS["K2", False], "K3_bf16": GLOBALS["K2", True]}
    for take in range(1, PROFILE_TAKES + 1):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host or take > 1:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        before = counts()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        launched = {}
        for k, n in counts().items():
            if n - before[k]:
                launched[names[k]] = launched.get(names[k], 0) + n - before[k]
        spans, kernel_spans, copy_spans, kernels, api = [], [], [], {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if "#" in ev.name:
                    continue
                span = (ev.time_range.start, ev.time_range.end)
                spans.append(span)
                if "Memcpy HtoD" in ev.name:
                    copy_spans.append(span)
                elif not ev.name.startswith("Memcpy") and not (
                        ev.name.startswith("Memset")):
                    kernel_spans.append(span)
                for g in GLOBALS.values():
                    if g + "<" in ev.name:
                        kernels[g] = kernels.get(g, 0) + 1
            elif ev.name.startswith("cu") and not ev.name.startswith("cudnn"):
                api[ev.name] = api.get(ev.name, 0) + 1
        if not any(kernels.get(g, 0) < n for g, n in launched.items()):
            break
        log(f"  a profiled epoch named {kernels} of the launches {launched}:"
            f" taken again ({take} of {PROFILE_TAKES})")
    return {"busy_ms": busy_us(spans) / 1e3,
            "kernels_ms": busy_us(kernel_spans) / 1e3 if kernel_spans
            else 0.0,
            "h2d_copy_ms": busy_us(copy_spans) / 1e3 if copy_spans else 0.0,
            "idle_gaps_ms": idle_gaps(spans), "kernels": kernels,
            "api": api, "takes": take, "launched": launched}


def cap_times(run, nb, captured):
    """Steady training epochs of a run that has taken its trajectory (no
    held-out loss or metric), captured or eager as it was: wall time and
    steps/s over ``CAP_TIMED`` epochs queued back to back, then one
    profiled epoch's device time a step, kernels and API calls."""
    from pyroved_tpu_torch.trainers import _graph
    trainer, lds = run["trainer"], run["loaders"]
    lds = lds[:2] if isinstance(trainer, auxSVItrainer) else lds[:1]
    _graph.CAPTURE = captured
    try:
        cap_epoch(trainer, lds)  # untimed: a program for training alone
        trainer.sync_history()
        t0 = time.perf_counter()
        for _ in range(CAP_TIMED):
            cap_epoch(trainer, lds)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (CAP_TIMED * nb)
        prof = profile_epoch(lambda: cap_epoch(trainer, lds))
        trainer.sync_history()
    finally:
        _graph.CAPTURE = True
    device = prof["busy_ms"] / nb
    return {"steps_per_s": 1e3 / wall, "wall_ms_per_step": wall,
            "device_ms_per_step": device, "idle_share": 1.0 - device / wall,
            "profiled_kernels_per_epoch": prof["kernels"],
            "api_calls_per_epoch": prof["api"]}


def cap_case(name, make, loaders, nb, decodes):
    """One model under the current flag: the trajectory captured and
    eager, bitwise equal, each launching one K1 and one K2 a step (one K3
    under one_pass_train); then their steady times."""
    on = sd.BF16_MATMUL
    tag = "bf16" if on else "f32"
    cap = trajectory(make, loaders, CAP_EPOCHS, True)
    eager = trajectory(make, loaders, CAP_EPOCHS, False)
    cap_same(f"{tag} {name}", cap, eager)
    suffix = "_bf16" if on else ""
    one = getattr(cap["model"], "one_pass_train", False)
    expected = ({"K3" + suffix: CAP_EPOCHS * decodes} if one else
                {"K1" + suffix: CAP_EPOCHS * decodes,
                 "K2" + suffix: CAP_EPOCHS * decodes})
    if isinstance(cap["trainer"], SVItrainer) and len(cap["loaders"]) > 1:
        # the held-out decodes
        expected["K1" + suffix] += CAP_EPOCHS * len(cap["loaders"][1])
    for run in (cap, eager):
        if not only(run["launches"], **expected):
            raise AssertionError(f"{tag} {name}: launches "
                                 f"{run['launches']}, expected {expected}")
    progs = cap["trainer"]._graphs.captured()
    replays = sum(p.replays for p in progs)
    times = {"captured": cap_times(cap, nb, True),
             "eager": cap_times(eager, nb, False)}
    k_name = GLOBALS["K2" if one else "K1", on]
    traced = times["captured"]["profiled_kernels_per_epoch"]
    if traced.get(k_name, 0) != decodes:
        raise AssertionError(f"{tag} {name}: the trace of a replayed "
                             f"epoch holds {traced} kernels, expected "
                             f"{decodes} of {k_name}")
    graphs = times["captured"]["api_calls_per_epoch"].get(
        "cudaGraphLaunch", 0)
    if graphs != 1 or times["eager"]["api_calls_per_epoch"].get(
            "cudaGraphLaunch", 0):
        raise AssertionError(f"{tag} {name}: {graphs} graph launches a "
                             f"captured epoch, {times['eager']} eager")
    out = {"steps_per_epoch": nb,
           "launches": cap["launches"], "replays": replays,
           "capture_s": [p.capture_s for p in progs],
           "pool_mib": [p.pool_bytes / 2 ** 20 for p in progs],
           "peak_mib": {"captured": cap["peak_mib"],
                        "eager": eager["peak_mib"]},
           "trajectory_s": {"captured": cap["seconds"],
                            "eager": eager["seconds"]},
           "losses": (cap["trainer"].loss_history["training_loss"]
                      if isinstance(cap["trainer"], SVItrainer)
                      else cap["trainer"].history["training_loss"]),
           "times": times}
    log(f"  {tag} {name}: {CAP_EPOCHS} epochs of {nb} steps "
        f"captured and eager bitwise equal (parameters, per-step losses, "
        f"optimizer state, generator), launches {cap['launches']}; "
        f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
    return out


def cap_rekeys(X):
    """Programs made again when their key changes, at the flagship under
    the current flag. A fresh DataLoader each of 3 epochs (over the same
    host array, so new device arrays): a program each epoch, none captured
    (each serves one epoch, its warm-up). The learning rate written into
    the optimizer's groups before each of 4 epochs (1e-3, 1e-3, 5e-4,
    5e-4, as a scheduler writes it): two programs, the second captured at
    its second epoch with the new rate. Each captured and eager:
    parameters, every epoch's loss and the generator bitwise equal; one
    program held at the end, the replaced ones freed (and their graphs and
    pools with them); each epoch timed (host clock to the loss's read)
    each way."""
    import weakref
    from pyroved_tpu_torch.trainers import _graph
    out = {}
    for what, epochs in (("fresh loader", 3), ("lr change", 4)):
        runs = {}
        for captured in (True, False):
            _graph.CAPTURE = captured
            try:
                m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
                tr = SVItrainer(m)
                ld = init_dataloader(X, batch_size=200, seed=0)
                secs, refs = [], []
                for e in range(epochs):
                    if what == "fresh loader":
                        ld = init_dataloader(X, batch_size=200, seed=0)
                        ld.set_epoch(e)
                    else:
                        for g in tr.optimizer.param_groups:
                            g["lr"] = 1e-3 / 2 ** (e // 2)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tr.train(ld)
                    secs.append(time.perf_counter() - t0)
                    if captured:
                        prog = tr._graphs.programs[("svi", True)]
                        if not refs or refs[-1]() is not prog:
                            refs.append(weakref.ref(prog))
                        del prog
            finally:
                _graph.CAPTURE = True
            runs[captured] = (m, tr, secs, refs)
        (cm, ct, csecs, refs), (em, et, esecs, _) = runs[True], runs[False]
        cap_same(f"{what}, captured against eager",
                 {"model": cm, "trainer": ct, "losses": torch.zeros(1)},
                 {"model": em, "trainer": et, "losses": torch.zeros(1)})
        live = [r() for r in refs]
        last = ct._graphs.programs[("svi", True)]
        made, replays = (3, 0) if what == "fresh loader" else (2, 1)
        if (len(refs) != made or len(ct._graphs.programs) != 1
                or live[-1] is not last or any(live[:-1])
                or last.replays != replays):
            raise AssertionError(f"{what}: {len(refs)} programs made, "
                                 f"{live} held, {last.replays} replays; "
                                 f"expected {made}, the last, {replays}")
        out[what] = {"captured_s": csecs, "eager_s": esecs,
                     "programs_made": len(refs),
                     "capture_s": last.capture_s,
                     "memory_reserved_mib":
                         torch.cuda.memory_reserved() / 2 ** 20}
        del live, last
    log(f"  {'bf16' if sd.BF16_MATMUL else 'f32'} flagship, programs made "
        f"again: a fresh loader each epoch and the lr changed, captured and "
        f"eager bitwise equal, the replaced programs freed; "
        f"{json.dumps(out)}")
    return out


def cap_workspace_in_pool(X):
    """K2's workspace (the ``torch.empty`` of ``_launch_bwd``) comes from
    the graph's private pool while a capture runs: the workspace pointers
    the K2 entry point receives during the flagship's capture all lie in
    segments of a private pool (``torch.cuda.memory_snapshot``'s
    ``segment_pool_id``), none in the default pool."""
    from pyroved_tpu_torch.trainers import _graph
    seen = []
    bind = sd._bwd_kernel

    def recording(bf16):
        plan, run = bind(bf16)

        def launch(*args):
            if torch.cuda.is_current_stream_capturing():
                seen.append(args[16])  # ws.data_ptr(), after 16 pointers
            return run(*args)
        return plan, launch

    sd._bwd_kernel = recording
    try:
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
        tr = SVItrainer(m)
        ld = init_dataloader(X, batch_size=200, seed=0)
        for _ in range(2):  # the warm-up, then the capture and a replay
            tr.train(ld)
    finally:
        sd._bwd_kernel = bind
    (prog,) = tr._graphs.captured()
    segments = [(seg["address"], seg["address"] + seg["total_size"],
                 tuple(seg.get("segment_pool_id", (None, None))))
                for seg in torch.cuda.memory_snapshot()]
    pools = []
    for ptr in seen:
        owner = [pool for lo, hi, pool in segments if lo <= ptr < hi]
        if len(owner) != 1 or owner[0] in ((0, 0), (None, None)):
            raise AssertionError(f"K2's workspace at {ptr:#x} during the "
                                 f"capture is not in a private pool: {owner}")
        pools.append(owner[0])
    if len(seen) != prog.nb or len(set(pools)) != 1:
        raise AssertionError(f"{len(seen)} workspaces captured in pools "
                             f"{set(pools)}, expected {prog.nb} in one")
    log(f"  K2's workspace during the flagship's capture: {len(seen)} "
        f"allocations, all in the graph's private pool {pools[0]}")
    return len(seen)


def cap_window(X):
    """bench.py's 20-epoch window at the flagship: ``run(loader, 20)``
    captured and eager, their final losses (bitwise equal) and times."""
    from pyroved_tpu_torch.trainers import _graph
    out = {}
    for captured in (True, False):
        _graph.CAPTURE = captured
        try:
            m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=0)
            tr = SVItrainer(m)
            ld = init_dataloader(X, batch_size=200, seed=0)
            _, secs, launches = run_path(lambda: tr.run(ld, 20))
        finally:
            _graph.CAPTURE = True
        out["captured" if captured else "eager"] = {
            "final_loss": tr.loss_history["training_loss"][-1],
            "seconds": secs, "steps_per_s": 20 * len(ld) / secs,
            "launches": launches, "checksum": checksum(m)}
    if (out["captured"]["final_loss"] != out["eager"]["final_loss"]
            or out["captured"]["checksum"] != out["eager"]["checksum"]):
        raise AssertionError(f"run(loader, 20): captured and eager differ: "
                             f"{out}")
    log(f"  run(loader, 20) at the flagship, {20 * len(ld)} steps: final loss "
        f"captured {out['captured']['final_loss']!r}, eager "
        f"{out['eager']['final_loss']!r}; {json.dumps(out)}")
    return out


def cap_resume(X):
    """Resume after captured epochs: 2 epochs through ``run`` (the first
    eager as the warm-up, the second captured and replayed), a checkpoint, a fresh
    model and trainer (other seeds) that resume, 2 more, against 4 in one
    go: history, parameters, optimizer state and generator bitwise."""
    def make(seed):
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=seed)
        return m, SVItrainer(m, seed=1 + seed)

    whole_model, whole = make(0)
    whole.run(init_dataloader(X, batch_size=200, seed=0), 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        first_model, first = make(0)
        first.run(init_dataloader(X, batch_size=200, seed=0), 2)
        if sum(p.replays for p in first._graphs.captured()) != 1:
            raise AssertionError("resume: the second epoch was not replayed")
        save_checkpoint(path, first_model, first)
        model, trainer = make(1)
        trainer.resume(path)
    loader = init_dataloader(X, batch_size=200, seed=0)
    loader.set_epoch(trainer.current_epoch)
    _, secs, launches = run_path(lambda: trainer.run(loader, 2))
    cap_same("resume after a captured epoch",
             {"model": model, "trainer": trainer, "losses": torch.zeros(1)},
             {"model": whole_model, "trainer": whole,
              "losses": torch.zeros(1)})
    expect_steps(f"resumed 2 epochs ({secs:.2f} s)", launches,
                 2 * len(loader))
    log(f"  {'bf16' if sd.BF16_MATMUL else 'f32'} resume after a captured "
        f"epoch: 2 epochs, a checkpoint, a fresh trainer's resume and 2 "
        f"more bitwise equal to 4 in one go (history, parameters, Adam's "
        f"state, generator); launches {launches}")
    return launches


def cap_ved():
    """The im2spec VED (phase 8's configuration, batch 100, 2,000 pairs,
    cuDNN's TF32 allowed), 2 epochs each: captured and eager with cuDNN's
    deterministic algorithms (bitwise equal), then with its default ones,
    captured and eager twice (the parameter gaps, printed)."""
    from pyroved_tpu_torch.trainers import _graph
    X, Y = im2spec_pairs(2000)
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)

    def go(captured, deterministic):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = deterministic
        _graph.CAPTURE = captured
        try:
            m = VED((16, 16), (2048,), latent_dim=2, seed=0)
            tr = SVItrainer(m)
            ld = init_dataloader(X, Y, batch_size=100, seed=0)
            losses, secs, _ = run_path(lambda: [tr.train(ld) for _ in range(2)])
        finally:
            _graph.CAPTURE = True
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic) = prev
        return m, losses, secs

    def gap(a, b):
        return max((p.float() - q.float()).abs().max().item() for p, q in zip(
            a[0].nets.state_dict().values(), b[0].nets.state_dict().values()))

    det_cap, det_eager = go(True, True), go(False, True)
    if gap(det_cap, det_eager) != 0.0 or det_cap[1] != det_eager[1]:
        raise AssertionError(f"VED, deterministic cuDNN: captured and eager "
                             f"differ by {gap(det_cap, det_eager)}")
    cap, eager, eager2 = go(True, False), go(False, False), go(False, False)
    out = {"deterministic_bitwise": True,
           "default_gap_captured_eager": gap(cap, eager),
           "default_gap_eager_eager": gap(eager, eager2),
           "losses": {"captured": cap[1], "eager": eager[1]},
           "seconds": {"captured": cap[2], "eager": eager[2]}}
    log(f"  VED im2spec 2 epochs, deterministic cuDNN: captured and eager "
        f"bitwise equal; default cuDNN: {json.dumps(out)}")
    return out


def phase_captured(smi):
    """Phase 14: the trainers' captured epochs (``trainers/_graph.py``)
    against the eager loop on the card."""
    t0 = time.perf_counter()
    out = {"cases": {}, "launches": {}}
    cases = cap_cases()
    for on in (False, True):
        with bf16_matmul(on):
            tag = "bf16" if on else "f32"
            for case in cases:
                name = case[0]
                res = cap_case(*case)
                out["cases"][f"{name} {tag}"] = res
                out["launches"][f"captured {name} {tag}"] = res["launches"]
            out["launches"][f"captured resume {tag}"] = cap_resume(
                blobs(2000, (28, 28), seed=1))
    out["rekeys"] = cap_rekeys(blobs(10000, (28, 28), seed=1))
    out["workspaces_in_pool"] = cap_workspace_in_pool(
        blobs(2000, (28, 28), seed=1))
    out["window"] = cap_window(blobs(10000, (28, 28), seed=1))
    out["ved"] = cap_ved()
    out["max_memory_allocated_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["seconds"] = time.perf_counter() - t0
    log(f"  ({smi}) max_memory_allocated {out['max_memory_allocated_mib']:.1f}"
        f" MiB; phase 14 took {out['seconds']:.1f} s")
    return out


# -- phase 15: captured chunked streaming and grad_accum ---------------------
# examples/out_of_core_training.py:35-60 streams the flagship in chunks of
# 64 batches of 200; examples/large_effective_batch.py:44-49 trains it at
# batch 50 x grad_accum=4 on 4,000 rotated bars.
STREAM_CHUNKS = 64


def stream_same(what, a, b):
    """:func:`cap_same`, and the ``grad_accum`` windows bitwise equal."""
    cap_same(what, a, b)
    wa, wb = a["trainer"].grad_accumulator, b["trainer"].grad_accumulator
    if (wa is None) != (wb is None):
        raise AssertionError(f"{what}: one run accumulates, one does not")
    if wa is not None and (wa.mini_step != wb.mini_step or not all(
            torch.equal(p, q) for p, q in zip(wa.acc, wb.acc))):
        raise AssertionError(f"{what}: the grad_accum windows differ "
                             f"(mini_step {wa.mini_step}, {wb.mini_step})")


@contextlib.contextmanager
def host_gather_seconds():
    """The host seconds spent in the streaming loaders' row gathers inside
    the block (``utils.data.gather_rows`` wrapped), as a one-entry list."""
    from pyroved_tpu_torch.utils import data as tdata
    gather, spent = tdata.gather_rows, [0.0]

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return gather(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0
    tdata.gather_rows = timed
    try:
        yield spent
    finally:
        tdata.gather_rows = gather


def stream_steady(run, captured, profile_loaders, decodes):
    """After a run's trajectory, captured or eager as it was: a steady
    epoch's time (steps/s, host-to-device GB/s; captured, one more epoch,
    all replays, with the host's gather time; eager, the trajectory's last
    epoch, as every eager epoch is alike), then one epoch over
    ``profile_loaders(loaders)`` profiled (device time, kernels, API calls
    and graph launches, copies). ``decodes`` is the profiled epoch's K1
    (and K2) launches. The eager profile traces the device alone, so its
    graph launches and API calls are not counted."""
    from pyroved_tpu_torch.trainers import _graph
    trainer, lds = run["trainer"], run["loaders"]
    profile_loaders = profile_loaders(lds)
    steps = len(lds[0])
    _graph.CAPTURE = captured
    try:
        wall = run["epoch_s"][-1]
        moved = run["h2d_bytes"] / len(run["epoch_s"])
        gathered = [None]
        if captured:
            before = h2d_bytes(lds)
            with host_gather_seconds() as gathered:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cap_epoch(trainer, lds)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            moved = h2d_bytes(lds) - before
        t1 = time.perf_counter()
        prof = profile_epoch(lambda: cap_epoch(trainer, profile_loaders),
                             host=captured)
        profile_s = time.perf_counter() - t1
        trainer.sync_history()
    finally:
        _graph.CAPTURE = True
    p_steps = len(profile_loaders[0])
    step_ms = 1e3 * wall / steps
    graphs = prof["api"].get("cudaGraphLaunch", 0)
    out = {"steps_per_s": steps / wall, "wall_ms_per_step": step_ms,
           "h2d_gb_per_s": moved / wall / 1e9, "h2d_bytes": moved,
           "host_gather_s": gathered[0],
           "device_ms_per_step": prof["busy_ms"] / p_steps,
           "kernels_ms_per_step": prof["kernels_ms"] / p_steps,
           "h2d_copy_ms_per_step": prof["h2d_copy_ms"] / p_steps,
           "idle_gaps_ms": prof["idle_gaps_ms"],
           "idle_share": 1.0 - prof["busy_ms"] / p_steps / step_ms,
           "profiled_steps": p_steps, "profile_s": profile_s,
           "profiled_kernels": prof["kernels"],
           "profile_takes": prof["takes"],
           "graph_launches": graphs,
           "api_calls_per_launch": (sum(prof["api"].values()) / graphs
                                    if graphs else None),
           "api_calls": prof["api"]}
    k1, k2 = (GLOBALS["K1", bool(sd.BF16_MATMUL)],
              GLOBALS["K2", bool(sd.BF16_MATMUL)])
    want = {k1: decodes, k2: decodes}
    if prof["launched"] != want:
        raise AssertionError(f"the profiled epoch launched "
                             f"{prof['launched']}, expected {want}")
    if set(prof["kernels"]) - set(want) or any(
            prof["kernels"].get(g, 0) > n for g, n in want.items()):
        raise AssertionError(f"the profiled epoch ran {prof['kernels']}, "
                             f"expected {decodes} of {k1} and of {k2}")
    # records the profiler lost (profile_epoch): every launch is counted
    # above; phase_captured_stream wants, under each flag, a captured
    # replay whose trace names them all
    out["records_lost"] = {g: n - prof["kernels"].get(g, 0)
                           for g, n in want.items()}
    return out


def stream_case(name, make, loaders, epochs, decodes, profile_loaders,
                p_decodes, chunks, programs):
    """One configuration under the current flag: ``epochs`` epochs captured
    and eager, bitwise equal (parameters, buffers, every training step's
    loss, the history, the optimizers' states, the generator, the
    ``grad_accum`` window), each launching one K1 and one K2 a micro-step
    (``decodes`` an epoch); the programs made (``programs``, as
    ``_graph.variants`` has them), captured, their capture seconds and
    their kind's pool, shared; then a steady epoch and a profiled one each
    way, the captured one with ``chunks`` graph launches (its chunks, or
    1)."""
    tag = "bf16" if sd.BF16_MATMUL else "f32"
    what = f"{tag} {name}"
    t0 = time.perf_counter()
    cap = trajectory(make, loaders, epochs, True)
    eager = trajectory(make, loaders, epochs, False)
    stream_same(what, cap, eager)
    suffix = "_bf16" if sd.BF16_MATMUL else ""
    expected = {"K1" + suffix: epochs * decodes,
                "K2" + suffix: epochs * decodes}
    for run in (cap, eager):
        if not only(run["launches"], **expected):
            raise AssertionError(f"{what}: launches {run['launches']}, "
                                 f"expected {expected}")
    cache = cap["trainer"]._graphs
    progs = cache.captured()
    if not cache.made == len(progs) == programs:
        raise AssertionError(f"{what}: {cache.made} programs made, "
                             f"{len(progs)} captured, expected {programs}")
    made = cache.made
    times = {"captured": stream_steady(cap, True, profile_loaders,
                                       p_decodes),
             "eager": stream_steady(eager, False, profile_loaders,
                                    p_decodes)}
    if (times["captured"]["graph_launches"] != chunks
            or times["eager"]["graph_launches"]):
        raise AssertionError(f"{what}: {times['captured']['graph_launches']}"
                             f" graph launches in the profiled captured "
                             f"epoch (expected {chunks}), "
                             f"{times['eager']['graph_launches']} eager")
    out = {"epochs": epochs, "micro_steps_per_epoch": decodes,
           "launches": cap["launches"],
           "epoch_s": {"captured": cap["epoch_s"], "eager": eager["epoch_s"]},
           "h2d_bytes": {"captured": cap["h2d_bytes"],
                         "eager": eager["h2d_bytes"]},
           "programs_made": made, "programs_captured": len(progs),
           "replays": sum(p.replays for p in progs),
           "capture_s": [p.capture_s for p in progs],
           "pool_mib": [p.pool_bytes / 2 ** 20 for p in progs],
           "pool_mib_total": sum(p.pool_bytes for p in progs) / 2 ** 20,
           "peak_mib": {"captured": cap["peak_mib"],
                        "eager": eager["peak_mib"]},
           "speedup": (times["captured"]["steps_per_s"]
                       / times["eager"]["steps_per_s"]),
           "times": times, "seconds": time.perf_counter() - t0}
    log(f"  {what}: {epochs} epochs of {decodes} micro-steps captured and "
        f"eager bitwise equal (parameters, every step's loss, history, "
        f"optimizers, generator, window), launches {cap['launches']}; "
        f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
    return out


def stream_resume(X):
    """A resume in the middle of a ``grad_accum=4`` window on the card: 82
    micro-steps an epoch (so the window sits at 2 after odd epochs), 3
    epochs (two eager warm-ups, a capture), a checkpoint, a fresh model and
    trainer (other seeds) that resume and take 4 more (two warm-ups, two
    captures), against 7 in one go: bitwise."""
    t0 = time.perf_counter()

    def make(seed):
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=4 + seed)
        return m, SVItrainer(m, seed=2 + seed, grad_accum=4)

    def loader(epoch):
        ld = init_dataloader(X, batch_size=50, seed=0)
        ld.set_epoch(epoch)
        return ld

    whole_model, whole = make(0)
    whole.run(loader(0), 7)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        first_model, first = make(0)
        first.run(loader(0), 3)
        if first.grad_accumulator.mini_step != 2 or not first._graphs.captured():
            raise AssertionError("resume: the first run did not end "
                                 "mid-window after a capture")
        save_checkpoint(path, first_model, first)
        model, trainer = make(1)
        trainer.resume(path)
    _, secs, launches = run_path(lambda: trainer.run(loader(3), 4))
    stream_same("resume mid-window",
                {"model": model, "trainer": trainer, "losses": torch.zeros(1)},
                {"model": whole_model, "trainer": whole,
                 "losses": torch.zeros(1)})
    if not trainer._graphs.captured():
        raise AssertionError("resume: nothing was captured after it")
    expect_steps(f"resumed 4 epochs mid-window ({secs:.2f} s)", launches,
                 4 * 82)
    log(f"  {'bf16' if sd.BF16_MATMUL else 'f32'} resume mid-window: 3 "
        f"epochs of 82 micro-steps at grad_accum=4, a checkpoint at "
        f"mini_step 2, a fresh trainer's resume and 4 more bitwise equal to "
        f"7 in one go; launches {launches} ({time.perf_counter() - t0:.1f}"
        f" s)")
    return launches


def feed_dropped_mid_copy(x32):
    """A streaming feed dropped with a chunk's copy in flight: its landing
    buffers lie in blocks of the copy stream (``torch.cuda.memory_snapshot``),
    and the compute stream's allocations of their size that follow take
    none of them, so no pending copy writes into a compute-stream tensor."""
    ld = init_dataloader(x32[:3 * STREAM_CHUNKS * 200], batch_size=200,
                         seed=0, device_resident=False,
                         stream_chunks=STREAM_CHUNKS)
    idx, _ = ld.epoch_indices()
    feed = ld._chunks(idx)
    rows = [next(feed)[2][0], next(feed)[2][0]]  # chunk 1's copy queued
    current = torch.cuda.current_stream().cuda_stream
    segs = {}
    for seg in torch.cuda.memory_snapshot():
        for t in rows:
            if seg["address"] <= t.data_ptr() < seg["address"] + seg[
                    "total_size"]:
                segs[t.data_ptr()] = seg["stream"]
    if len(segs) != 2 or current in segs.values():
        raise AssertionError(f"the landing buffers' streams {segs}, the "
                             f"compute stream {current}")
    nbytes = rows[0].numel() * rows[0].element_size()
    del rows
    feed.close()
    taken = [torch.empty(nbytes, dtype=torch.uint8, device="cuda")
             for _ in range(4)]
    hit = [t.data_ptr() for t in taken if t.data_ptr() in segs]
    del taken
    if hit:
        raise AssertionError(f"a compute-stream tensor took a landing "
                             f"buffer's block at {hit}")
    log(f"  a feed dropped mid-copy: its landing buffers on the copy "
        f"stream, none taken by the compute stream's next 4 allocations "
        f"of {nbytes / 2 ** 20:.1f} MiB")
    return {"landing_streams": sorted(set(segs.values())),
            "compute_stream": current}


def stream_vs_resident(x32):
    """The chunk's own cost: the flagship over the same 12,800 memmapped
    rows (64 batches) resident and streamed as one chunk of 64, each
    captured (a warm-up epoch, a capture) and then timed over 3 epochs, in
    turns (resident, streamed, streamed, resident): milliseconds a step,
    the host clock to the device's end."""
    rows = x32[:STREAM_CHUNKS * 200]
    runs = {}
    for kw in ({}, dict(device_resident=False, stream_chunks=STREAM_CHUNKS)):
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=1)
        tr = SVItrainer(m)
        ld = init_dataloader(rows, batch_size=200, seed=0, **kw)
        for _ in range(2):
            tr.train(ld)
        runs["resident" if not kw else "streamed"] = (tr, ld, [])
    for name in ("resident", "streamed", "streamed", "resident"):
        tr, ld, ms = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            tr.step(ld, sync=False)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / (3 * len(ld)))
    out = {name: ms for name, (_, _, ms) in runs.items()}
    log(f"  {'bf16' if sd.BF16_MATMUL else 'f32'} flagship over 12,800 "
        f"memmapped rows, captured, ms a step in turns: {json.dumps(out)}")
    return out


def stream_cases(x32, x8):
    """Phase 15's configurations under the current flag: (name, make,
    loaders, epochs, micro-steps an epoch, the profiled epoch's loaders
    (a function of the run's: a resident loader made afresh would hold new
    device arrays, and so take new programs) and micro-steps, its graph
    launches captured, the programs its trainer makes)."""
    rows = OOC_ROWS if sd.BF16_MATMUL else OOC_ROWS_F32
    prof_rows = 2 * STREAM_CHUNKS * 200  # two full chunks

    def flagship(seed=1, **kw):
        m = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=seed)
        return m, SVItrainer(m, **kw)

    def ooc(src, **kw):
        return lambda n: (init_dataloader(
            src[:n], batch_size=200, seed=0, device_resident=False,
            stream_chunks=STREAM_CHUNKS, **kw),)

    u8 = dict(scale=1.0 / 255.0)
    steps = -(-rows // 200)
    chunks = -(-steps // STREAM_CHUNKS)
    Xf, y, _ = family_data()
    labels = np.eye(N_CLASSES, dtype=np.float32)[y]

    def ss():
        m = ssiVAE(FAMILY_DIM, num_classes=N_CLASSES, **FAMILY)
        return m, auxSVItrainer(m)

    def ss_loaders():
        # 10 unlabeled batches in chunks of 4 (4, 4, 2), a labeled one
        # after the 2nd and the 8th: three programs
        return (init_dataloader(Xf, batch_size=200, seed=0,
                                device_resident=False, stream_chunks=4),
                init_dataloader(Xf[:400], labels[:400], batch_size=200,
                                seed=0, random_sampler=True))

    def ss_ratio():
        # the cadence of 300 unlabeled and 15 labeled batches, (15 + 300)
        # // 15 = 21, given as sup_period, so that a shorter unlabeled
        # loader keeps it
        m, tr = ss()
        tr.step = functools.partial(tr.step, sup_period=21)
        return m, tr

    def ss_ratio_loaders(batches=300):
        # unlabeled batches of the memmap in chunks of 64 (300: 4 x 64,
        # 44) and 15 labeled ones: a labeled step every 21st, at 1, 22,
        # ..., 295 (15 an epoch); 64 mod 21 = 1 moves the pattern a place
        # each chunk: a program a chunk, five
        return (init_dataloader(x32[:batches * 200], batch_size=200, seed=0,
                                device_resident=False,
                                stream_chunks=STREAM_CHUNKS),
                init_dataloader(np.tile(Xf, (2, 1, 1))[:3000],
                                np.tile(labels, (2, 1))[:3000],
                                batch_size=200, seed=0, random_sampler=True))

    def ss_ratio_profiled(lds):
        # the first two chunks (7 labeled steps): the first two programs
        return ss_ratio_loaders(2 * STREAM_CHUNKS)[:1] + lds[1:]

    bars4000, bars4100 = bars(4000), bars(4100)
    same = lambda lds: lds  # noqa: E731

    def accum(**kw):
        return lambda: flagship(seed=4, grad_accum=4, **kw)

    def batches(X, **kw):
        return lambda: (init_dataloader(X, batch_size=50, seed=0, **kw),)

    return (
        (f"out-of-core flagship f32 memmap ({rows:,} rows, {chunks} chunks)",
         flagship, lambda: ooc(x32)(rows), 2, steps,
         lambda lds: ooc(x32)(prof_rows), 2 * STREAM_CHUNKS, 2, 2),
        (f"out-of-core flagship uint8 scale=1/255 ({rows:,} rows)",
         flagship, lambda: ooc(x8, **u8)(rows), 2, steps,
         lambda lds: ooc(x8, **u8)(prof_rows), 2 * STREAM_CHUNKS, 2, 2),
        ("ssiVAE, chunked unlabeled (4, 4, 2), resident labeled", ss,
         ss_loaders, 3, 12, same, 12, 3, 3),
        ("ssiVAE, 300 memmapped unlabeled batches in chunks of 64, 15 "
         "labeled (p = 21)", ss_ratio, ss_ratio_loaders, 3, 315,
         ss_ratio_profiled, 2 * STREAM_CHUNKS + 7, 2, 5),
        ("flagship batch 50 x grad_accum=4, 4,000 bars (80 micro-steps)",
         accum(), batches(bars4000), 3, 80, same, 80, 1, 1),
        ("flagship batch 50 x grad_accum=4, 4,100 bars (82: nb % k = 2)",
         accum(), batches(bars4100), 6, 82, same, 82, 1, 2),
        ("flagship grad_accum=4 over chunks of 24 (24, 24, 24, 8)",
         accum(), batches(bars4000, device_resident=False, stream_chunks=24),
         3, 80, same, 80, 4, 2))


def phase_captured_stream(smi):
    """Phase 15: the captured chunked streaming and ``grad_accum``
    programs (``trainers/_graph.py``) against the eager loop on the card,
    under each flag."""
    t0 = time.perf_counter()
    out = {"cases": {}, "launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        x32, x8 = write_memmaps(tmp, OOC_ROWS)
        out["memmap_write_s"] = time.perf_counter() - t1
        for on in (False, True):
            with bf16_matmul(on):
                tag = "bf16" if on else "f32"
                named = []
                for case in stream_cases(x32, x8):
                    res = stream_case(*case)
                    out["cases"][f"{case[0]} {tag}"] = res
                    out["launches"][f"stream {case[0]} {tag}"] = res[
                        "launches"]
                    if not any(res["times"]["captured"][
                            "records_lost"].values()):
                        named.append(case[0])
                if not named:
                    raise AssertionError(f"{tag}: no captured replay's "
                                         f"trace named every K1 and K2")
                out[f"traces_naming_every_launch_{tag}"] = named
                out["launches"][f"stream resume mid-window {tag}"] = (
                    stream_resume(bars(4100)))
                out[f"chunk_vs_resident_{tag}"] = stream_vs_resident(x32)
        out["feed_dropped_mid_copy"] = feed_dropped_mid_copy(x32)
        del x32, x8
    out["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 20)
    out["seconds"] = time.perf_counter() - t0
    log(f"  ({smi}) phase 15 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    smi = card_info()
    log(smi)
    peaks = card_peaks(smi)
    t0 = time.perf_counter()
    _build.load_all(list(SOURCES))
    log(f"phase 1: built {', '.join(SOURCES)} (one nvcc each, together) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        log(_build.build_log(name).strip())
    ablation_build = start_ablation_build()  # waited for by phase 13

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
    tanh_probe = phase_tanh_probe(dev)
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
        "manifold2d_32": lambda: model.manifold2d(32, plot=False),
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

    # -- 8. VED and the conv nets; checkpoints and weights ------------------
    log("phase 8: VED trains and serves; bit-exact resume; weights")
    t8 = time.perf_counter()
    ved = phase_ved_im2spec()
    stretch = phase_ved_stretch(smi)
    resume = {}
    with bf16_matmul(False):
        resume[False] = phase_resume(fam_data)
    resume[True] = phase_resume(fam_data)
    phase_weights(ved.pop("model"))
    log(f"phase 8 took {time.perf_counter() - t8:.1f} s")

    # -- 9. the trainer surface -------------------------------------------
    log("phase 9: out-of-core training, grad_accum and remat, "
        "enum_schedule, segmented runs with logs and early stopping")
    t9 = time.perf_counter()
    surface_runs = {}  # the module path's losses (f32), computed once
    with bf16_matmul(False):
        surface32 = phase_trainer_surface(fam_data, surface_runs)
    surface = phase_trainer_surface(fam_data, surface_runs)
    # K1 and K2 (and K3) at the new shapes join phase 6's table: the
    # flagship at B = 50 (grad_accum) and the enumerated decode of
    # enum_topk=3, 600 rows at L = 12
    acc_model, acc_xb = surface["accum"].pop("model"), surface["accum"].pop(
        "xb")
    e = torch.randn(50, acc_model.z_dim, generator=gen, device="cuda")
    a, xf = train_args(acc_model, acc_xb, e)
    with torch.no_grad():
        for on, row in time_k1("flagship grad_accum", a, peaks).items():
            k1_rows[on].append(row)
    for key, row in time_bwd("flagship grad_accum", a, xf, gen,
                             peaks).items():
        rows[key].append(row)
    enum_model = surface["enum"].pop("model")
    e = torch.randn(200, enum_model.z_dim, generator=gen, device="cuda")
    a = enum_args(enum_model, fam["xb"], e)
    for k in ("phi", "dx", "sc", "z"):  # three classes of every example
        a[k] = a[k][:600].contiguous()
    with torch.no_grad():
        for on, row in time_k1("jiVAE enum_topk=3 L=12", a, peaks).items():
            k1_rows[on].append(row)
    for key, row in time_bwd("jiVAE enum_topk=3 L=12", a, None, gen, peaks,
                             with_k3=False).items():
        rows[key].append(row)
    del a, xf
    for k in ("model", "xb"):
        surface32["accum"].pop(k)
    surface32["enum"].pop("model")
    phase9_s = time.perf_counter() - t9
    log(f"phase 9 took {phase9_s:.1f} s")

    # -- 10. pixel-partitioned training, int8 serving, plots and the GP ----
    log("phase 10: pixel_chunks at 512x512, the large grid and the "
        "families; int8 serving; predict_on_latent; K1/K2 at the tiles")
    t10 = time.perf_counter()
    flagship = train["model"]
    with bf16_matmul(False):
        pix32 = phase_pixel(smi, fam_data, flagship, big, x, z_req, z_big,
                            pose)
    pix = phase_pixel(smi, fam_data, flagship, big, x, z_req, z_big, pose)
    # (f) K1 and K2 at the tiles' shapes join phase 6's table: a tile of
    # the 512x512 grid (B = 200, N = 16,384), the whole grid at B = 8, a
    # tile of the large grid (B = 64, N = 2,048) and the padded last tile
    # of the flagship on 3 tiles (262 rows, 2 of them padding); then K1 on
    # the int8 exports' dequantized weights at their requests' shapes
    a512 = pix["512"].pop("args")
    pix32["512"].pop("args")
    e = torch.randn(64, big.z_dim, generator=gen, device="cuda")
    a_large, _ = train_args(big, xl, e)
    e = torch.randn(200, flagship.z_dim, generator=gen, device="cuda")
    a_tail, _ = train_args(flagship, train["xb"], e)
    grid = a_tail["grid"]
    a_tail["grid"] = torch.cat([grid, grid.new_zeros(2, 2)])[524:].contiguous()
    for name, a in (("512x512 tile of 16", tile_args(a512, slice(0, 16384))),
                    ("512x512 whole grid", tile_args(a512, slice(None), B=8)),
                    ("large grid tile of 8", tile_args(a_large,
                                                       slice(0, 2048))),
                    ("flagship padded last tile of 3", a_tail)):
        with torch.no_grad():
            for on, row in time_k1(name, a, peaks).items():
                k1_rows[on].append(row)
        for key, row in time_bwd(name, a, None, gen, peaks,
                                 with_k3=False).items():
            rows[key].append(row)
    del a512, a_large, a_tail, a
    for name, z in (("flagship", z_req), ("large_grid", z_big)):
        s8 = pix["served_int8"][name]
        a = kernel_args(s8.decoder, s8.grid, z.cuda(), **pose)
        with torch.no_grad():
            for on, row in time_k1(f"int8 {name} served", a, peaks).items():
                k1_rows[on].append(row)
    del a, s8
    for res in (pix, pix32):
        res.pop("served_int8")
    phase10_s = time.perf_counter() - t10
    log(f"phase 10 took {phase10_s:.1f} s")

    # -- 11. the job runner, reference weights, custom nets, profiling -----
    log("phase 11: python -m pyroved_tpu_torch.train and run_job, the "
        "families' jobs, reference weights, custom nets, the trace and the "
        "kernel cache")
    jobs, job_launches = phase_jobs(smi, fam_data)
    log(f"phase 11 took {jobs['seconds']:.1f} s ({smi})")

    # -- 12. the parallel layer ------------------------------------------
    log("phase 12: one NCCL rank in process; two gloo ranks on the card: "
        "data, pixel and tensor parallelism, the SPMD step, the sharded "
        "decode; K1/K2 at the ranks' shapes")
    parallel, par_launches, par_k1, par_rows = phase_parallel(smi, peaks)
    for on in (False, True):
        k1_rows[on] += par_k1[on]
    for key, more in par_rows.items():
        rows[key] += more
    log(f"phase 12 took {parallel['seconds']:.1f} s ({smi})")

    # -- 14. the trainers' captured epochs (run before 13, whose builds
    # finish meanwhile) ---------------------------------------------------
    log("phase 14: captured epochs against the eager loop: trajectories, "
        "the 20-epoch window, resume, launches, times")
    captured = phase_captured(smi)

    # -- 15. captured chunked streaming and grad_accum (also before 13) ----
    log("phase 15: captured chunked streaming and grad_accum against the "
        "eager loop: the out-of-core flagship, ssiVAE, batch 50 x "
        "grad_accum=4, resume mid-window")
    stream = phase_captured_stream(smi)

    # -- 13. K4: the backward in ablation modes --------------------------
    log("phase 13: K4's eight modes of both K2 sources against their plain "
        "versions and K2, timed chains and the attribution of K2's time")
    abl = phase_ablation(smi, peaks, ablation_build)
    log(f"phase 13 took {abl['seconds']:.1f} s ({smi})")

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
                   for path, n in f["launches"].items()},
                **{f"{path}_{'bf16' if on else 'f32'}": n[key]
                   for on, paths in resume.items()
                   for path, n in paths.items()},
                **{f"{path}_{tag}": n[key]
                   for tag, f in (("bf16", surface), ("f32", surface32))
                   for path, n in surface_launches(f).items()},
                **{f"{path}_{tag}": n[key]
                   for tag, f in (("bf16", pix), ("f32", pix32))
                   for path, n in pixel_launches(f).items()},
                **{path: n[key] for path, n in job_launches.items()},
                **{path: n[key] for path, n in par_launches.items()},
                **{path: n[key]
                   for path, n in captured["launches"].items()},
                **{path: n[key]
                   for path, n in stream["launches"].items()}}

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

    def abl_entry(name, source, on):
        """K4's entry for one source: ``full`` at the flagship in the
        contract's keys, every mode at every shape under ``modes``."""
        tag = "bf16" if on else "f32"
        head = abl["modes"][tag]["flagship"]["full"]
        launches = {k: n for k, n in abl["launches"].items()
                    if k.startswith(sd.BWD_SOURCES[on] + ":")}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "benchmarks/bwd_ablation.py:55",
                "launches": sum(launches.values()),
                "launches_by_path": {"phase 13 chains, by mode": launches},
                "max_abs_err": abl["errs"][on], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "modes": abl["modes"][tag],
                "attribution": {k: v for k, v in abl["attribution"].items()
                                if k.startswith(tag)}}
    bwd, tc = (csrc + "spatial_decoder_bwd_x3.cu",
               csrc + "spatial_decoder_bwd_tc.cu")
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
              request_ms=request_ms, weights_ms=weights_ms,
              tanh_probe=tanh_probe),
        entry("spatial_decoder_bwd_x3", bwd, k2_at, "K2",
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
        abl_entry("bwd_ablation_x3", bwd, False),
        abl_entry("bwd_ablation_tc", tc, True),
    ], "training": {tag: {k: t[k] for k in (
        "fit_s", "loss_history", "module_loss_history", "times")}
        for tag, t in (("bf16", train), ("f32", train32))},
        "large_grid_training": {"bf16": large, "f32": large32},
        "step_breakdown": breakdown,
        "families": {tag: {k: f[k] for k in (
            "fit_s", "loss_history", "module_loss_history",
            "ssivae_accuracy", "ss_reg_mse", "first_step_err")}
            for tag, f in (("bf16", fam), ("f32", fam32))},
        "enumerated_step": enum_step,
        "ved": {"im2spec": ved, "stretch": stretch},
        "trainer_surface": {"bf16": surface, "f32": surface32,
                            "seconds": phase9_s},
        "pixel_int8_viz": {"bf16": pix, "f32": pix32,
                           "seconds": phase10_s},
        "jobs": jobs, "parallel": parallel, "captured_epochs": captured,
        "captured_streaming": stream}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"]
             else main())
