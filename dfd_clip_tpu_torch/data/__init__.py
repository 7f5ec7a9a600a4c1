"""The port's data side: video backends, the host loader and the evaluation
datasets (FFPP, CDF, DFDC)."""

from .datasets import CDF, DFDC, FFPP

__all__ = ["FFPP", "CDF", "DFDC"]
