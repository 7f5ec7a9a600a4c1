"""Seeded generator streams (counterpart of dfd_clip_tpu/runtime/prng.py's
KeySeq): one seed, a stream of independent ``torch.Generator``s."""

from __future__ import annotations

import numpy as np
import torch


class KeySeq:
    """A stateful stream of fresh generators derived from one seed: the n-th
    ``next()`` is seeded from (seed, n), ``fold_in(data)`` from (seed, n,
    data) without advancing the stream."""

    def __init__(self, seed: int = 0, device="cpu"):
        self._seed, self._count, self._device = int(seed), 0, device

    def _gen(self, *words: int) -> torch.Generator:
        state = int(np.random.SeedSequence([self._seed, *words]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=self._device).manual_seed(state)

    def next(self) -> torch.Generator:
        self._count += 1
        return self._gen(self._count)

    def __call__(self) -> torch.Generator:
        return self.next()

    def fold_in(self, data: int) -> torch.Generator:
        return self._gen(self._count, 1 << 32, int(data))
