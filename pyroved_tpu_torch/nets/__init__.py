"""Neural-net modules (torch.nn)."""
from .fc import MLP, Dense, fcDecoderNet, fcEncoderNet, sDecoderNet

__all__ = ["Dense", "MLP", "fcEncoderNet", "fcDecoderNet", "sDecoderNet"]
