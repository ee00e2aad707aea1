"""Variational encoder-decoder models."""
from .base import baseVAE
from .ivae import iVAE

__all__ = ["baseVAE", "iVAE"]
