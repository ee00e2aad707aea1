"""Neural-net modules (torch.nn)."""
from .fc import (MLP, Dense, fcClassifierNet, fcDecoderNet, fcEncoderNet,
                 fcRegressorNet, jfcEncoderNet, sDecoderNet)

__all__ = ["Dense", "MLP", "fcEncoderNet", "jfcEncoderNet", "fcClassifierNet",
           "fcRegressorNet", "fcDecoderNet", "sDecoderNet"]
