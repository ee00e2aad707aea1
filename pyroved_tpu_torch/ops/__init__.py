"""Kernels and their wrappers."""
from .spatial_decoder import (FusedBernoulliReconLoss, FusedSpatialDecoder,
                              apply_fused_recon_loss, apply_fused_sdecoder,
                              fused_bernoulli_recon_loss_kernel,
                              fused_spatial_decoder_backward,
                              fused_spatial_decoder_forward,
                              padded_sdecoder_weights, recon_loss_plain,
                              sdecoder_supports_fusion,
                              spatial_decoder_bwd_plain, spatial_decoder_plain)

__all__ = ["FusedBernoulliReconLoss", "FusedSpatialDecoder",
           "apply_fused_recon_loss", "apply_fused_sdecoder",
           "fused_bernoulli_recon_loss_kernel",
           "fused_spatial_decoder_backward", "fused_spatial_decoder_forward",
           "padded_sdecoder_weights", "recon_loss_plain",
           "sdecoder_supports_fusion", "spatial_decoder_bwd_plain",
           "spatial_decoder_plain"]
