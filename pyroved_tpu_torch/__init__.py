"""pyroved_tpu_torch: the PyTorch/CUDA port of pyroved_tpu.

Serves the invariant VAE (iVAE) on an NVIDIA Hopper card: encode, posed
decode, latent manifolds and per-example ELBO scoring. Every spatial decode
goes through a hand-written CUDA kernel (``ops.spatial_decoder``). The JAX
package ``pyroved_tpu`` stays the reference; this package imports nothing
of it and nothing of JAX.

Device rule: entry points take ``device=None``, which means ``"cuda"``.
Without CUDA they raise unless the caller passes ``device="cpu"``.
"""
from . import infer, models, nets, ops, serving, utils, weights
from .__version__ import __version__

__all__ = ["infer", "models", "nets", "ops", "serving", "utils", "weights",
           "__version__"]
