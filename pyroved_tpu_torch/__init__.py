"""pyroved_tpu_torch: the PyTorch/CUDA port of pyroved_tpu.

Trains and serves the invariant VAE (iVAE), the joint discrete-continuous
jiVAE, the semi-supervised ssiVAE and ss_reg_iVAE and the conv
encoder-decoder VED on an NVIDIA Hopper card: ``fit`` with ``SVItrainer``
or ``auxSVItrainer`` over device-resident or streamed ``DataLoader``s (or
any iterable of batches), with segmented runs (JSONL logs, early stopping,
``on_segment`` callbacks), ``enum_schedule``, ``grad_accum`` and
``remat``, ``pixel_chunks`` for large grids, checkpoints that resume
bit-exactly, and pickle-free weights; encode, classify/regress, posed
decode, latent manifolds (plotted by default), VED's predictions,
per-example ELBO scoring, a GP surrogate on the latents and float32 or
int8 serving archives; typed configs (``config``) and the job runner
``python -m pyroved_tpu_torch.train job.json``, custom encoder and decoder
networks (``set_encoder`` / ``set_decoder``), the reference pyroVED's
weights (``load_torch_weights``, ``interop``) and profiling
(``utils.profiling``); across devices, one rank each, data, tensor and
pixel parallelism and an explicit SPMD step (``parallel``). Every spatial
decode, the enumerated ones on K*B rows included, goes through
hand-written CUDA kernels
(``ops.spatial_decoder``): the fused forward, its backward, and the
one-pass Bernoulli train kernel. The JAX package ``pyroved_tpu`` stays the
reference; this package imports nothing of it and nothing of JAX.

Device rule: entry points take ``device=None``, which means ``"cuda"``.
Without CUDA they raise unless the caller passes ``device="cpu"``.
"""
from . import (config, infer, interop, models, nets, ops, parallel, serving,
               trainers, utils, weights)
from .__version__ import __version__

__all__ = ["config", "infer", "interop", "models", "nets", "ops", "parallel",
           "serving", "trainers", "utils", "weights", "__version__"]
