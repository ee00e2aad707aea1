"""Trainers."""
from .svi import SVItrainer

__all__ = ["SVItrainer"]
