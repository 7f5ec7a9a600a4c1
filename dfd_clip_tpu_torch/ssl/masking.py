"""iBOT block masking (the port's copy of dfd_clip_tpu/ssl/masking.py;
dinov2/data/masking.py:12-87 + collate.py:11-49): per-sample block-shaped
patch masks with a sampled masking ratio applied to a configurable fraction
of the batch. Host numpy: the same generator state gives the JAX package's
masks byte for byte."""

from __future__ import annotations

import numpy as np


class BlockMaskGenerator:
    def __init__(self, grid: int, min_ratio: float = 0.1, max_ratio: float = 0.5):
        self.grid = grid
        self.min_ratio = min_ratio
        self.max_ratio = max_ratio

    def sample_mask(self, rng: np.random.Generator) -> np.ndarray:
        g = self.grid
        target = int(rng.uniform(self.min_ratio, self.max_ratio) * g * g)
        mask = np.zeros((g, g), bool)
        budget = target
        for _ in range(10):
            if budget <= 0:
                break
            bw = int(rng.integers(1, max(g // 2, 2)))
            bh = int(rng.integers(1, max(g // 2, 2)))
            x = int(rng.integers(0, g - bw + 1))
            y = int(rng.integers(0, g - bh + 1))
            before = mask.sum()
            mask[y : y + bh, x : x + bw] = True
            budget -= int(mask.sum() - before)
        return mask.reshape(-1)

    def batch_masks(self, batch_size: int, mask_prob: float,
                    rng: np.random.Generator) -> np.ndarray:
        """(B, grid^2) bool; ~mask_prob of samples get a non-empty mask."""
        masks = np.zeros((batch_size, self.grid * self.grid), bool)
        n_masked = int(round(mask_prob * batch_size))
        for i in rng.choice(batch_size, n_masked, replace=False):
            masks[i] = self.sample_mask(rng)
        return masks
