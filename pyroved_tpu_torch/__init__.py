"""pyroved_tpu_torch: the PyTorch/CUDA port of pyroved_tpu.

Trains and serves the invariant VAE (iVAE), the joint discrete-continuous
jiVAE and the semi-supervised ssiVAE and ss_reg_iVAE on an NVIDIA Hopper
card: ``fit`` with ``SVItrainer`` or ``auxSVItrainer`` and device-resident
``DataLoader``s; encode, classify/regress, posed decode, latent manifolds
and per-example ELBO scoring. Every spatial decode, the enumerated ones on
K*B rows included, goes through hand-written CUDA kernels
(``ops.spatial_decoder``): the fused forward, its backward, and the
one-pass Bernoulli train kernel. The JAX package ``pyroved_tpu`` stays the
reference; this package imports nothing of it and nothing of JAX.

Device rule: entry points take ``device=None``, which means ``"cuda"``.
Without CUDA they raise unless the caller passes ``device="cpu"``.
"""
from . import infer, models, nets, ops, serving, trainers, utils, weights
from .__version__ import __version__

__all__ = ["infer", "models", "nets", "ops", "serving", "trainers", "utils",
           "weights", "__version__"]
