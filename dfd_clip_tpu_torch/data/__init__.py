"""The port's data side: video backends, the host loader and the datasets
(FFPP, CDF, DFDC, RPPG)."""

from .datasets import CDF, DFDC, FFPP, RPPG

__all__ = ["FFPP", "CDF", "DFDC", "RPPG"]
