"""Trainers."""
from .auxsvi import auxSVItrainer
from .svi import SVItrainer

__all__ = ["SVItrainer", "auxSVItrainer"]
