"""Kernels and their wrappers."""
from .spatial_decoder import (apply_fused_sdecoder,
                              fused_spatial_decoder_forward,
                              padded_sdecoder_weights,
                              sdecoder_supports_fusion, spatial_decoder_plain)

__all__ = ["apply_fused_sdecoder", "fused_spatial_decoder_forward",
           "padded_sdecoder_weights", "sdecoder_supports_fusion",
           "spatial_decoder_plain"]
