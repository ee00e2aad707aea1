"""Variational encoder-decoder models."""
from .base import baseVAE
from .ivae import iVAE
from .jivae import jiVAE
from .ss_reg_ivae import ss_reg_iVAE
from .ssivae import ssiVAE

__all__ = ["baseVAE", "iVAE", "jiVAE", "ssiVAE", "ss_reg_iVAE"]
