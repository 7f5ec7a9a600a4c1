"""Scoring service core (counterpart of serve.py's ``Scorer``).

A ``Scorer`` holds a detector's params on the card, serialises device use
with a lock and answers ``score_frames`` requests on decoded frames. The
encoder's kernel paths are the detector's (``Detector(...,
encoder_kernels=EncoderKernels(...))``, the JAX serve path's DFD_FUSED_BLOCK,
DFD_MEGAKERNEL and DFD_INT8_ATTN). The HTTP handler and video decoding are
not ported yet.
"""

from __future__ import annotations

import threading

import numpy as np

from .models.detector import Detector
from .scoring import score_frames


class Scorer:
    """Thread-safe single-flight scoring of decoded frame arrays."""

    def __init__(self, model: Detector, params, *, task: int = 0, batch_size: int = 16):
        self.model = model
        self.params = model.prepare_params(params)
        self.task = task
        self.batch_size = batch_size
        self._lock = threading.Lock()

    def predict(self, params, x, m):
        return self.model.predict(params, x, m)[0][self.task]

    def score_frames(self, frames: np.ndarray) -> float:
        """(N, H, W, 3) uint8 frames -> mean softmax P(fake) over windows."""
        return score_frames(frames, self.predict, self.params,
                            num_frames=self.model.num_frames,
                            batch_size=self.batch_size, lock=self._lock)
