"""Neural-net modules (torch.nn)."""
from .conv import (FeatureExtractor, UpsampleBlock, Upsampler,
                   convDecoderNet, convEncoderNet)
from .fc import (MLP, Dense, coord_latent, fcClassifierNet, fcDecoderNet,
                 fcEncoderNet, fcRegressorNet, jfcEncoderNet, sDecoderNet)

__all__ = ["Dense", "MLP", "fcEncoderNet", "jfcEncoderNet", "fcClassifierNet",
           "fcRegressorNet", "fcDecoderNet", "sDecoderNet", "coord_latent",
           "UpsampleBlock", "FeatureExtractor", "Upsampler", "convEncoderNet",
           "convDecoderNet"]
