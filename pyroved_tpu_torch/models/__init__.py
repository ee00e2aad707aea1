"""Variational encoder-decoder models."""
from .base import baseVAE
from .ivae import iVAE
from .jivae import jiVAE
from .ss_reg_ivae import ss_reg_iVAE
from .ssivae import ssiVAE
from .ved import VED

__all__ = ["baseVAE", "iVAE", "jiVAE", "ssiVAE", "ss_reg_iVAE", "VED"]
