"""The port's models: CLIP vision tower, temporal decoder, detector, and the
CompInv adapter pretrainer."""

from .adapter import CompInvEncoder
from .detector import Detector

__all__ = ["Detector", "CompInvEncoder"]
