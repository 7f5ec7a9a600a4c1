"""Index samplers for SSL streams (the port's copy of
dfd_clip_tpu/ssl/samplers.py; dinov2/data/samplers.py:18-230): epoch-based,
infinite, and sharded-infinite (rank-strided shuffled streams with
mid-stream resume via ``advance``). Host numpy: the same seeds give the JAX
package's index streams.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class EpochSampler:
    """size-per-epoch sampling of a dataset, reshuffled per epoch."""

    def __init__(self, size: int, dataset_len: int, shuffle: bool = True,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        self.size = size
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        count = (self.size + self.dataset_len - 1) // self.dataset_len
        tiled = np.tile(np.arange(self.dataset_len), count)[: self.size]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(tiled)
        yield from tiled[self.shard_index :: self.num_shards].tolist()

    def __len__(self) -> int:
        return (self.size - self.shard_index + self.num_shards - 1) // self.num_shards


class InfiniteSampler:
    """Endless shuffled index stream with resume-``advance``."""

    def __init__(self, dataset_len: int, shuffle: bool = True, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, advance: int = 0):
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.advance = advance

    def _stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            idx = np.arange(self.dataset_len)
            if self.shuffle:
                rng.shuffle(idx)
            yield from idx.tolist()

    def __iter__(self) -> Iterator[int]:
        it = self._stream()
        # rank-strided shard of the global stream
        for i, v in enumerate(it):
            if i < self.advance:
                continue
            if (i % self.num_shards) == self.shard_index:
                yield v


class ShardedInfiniteSampler:
    """Infinite stream where each epoch-slice is reshuffled with a per-epoch
    seed and sharded rank-strided — the reference's resumable variant
    (samplers.py:166-230)."""

    def __init__(self, dataset_len: int, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, advance: int = 0):
        self.dataset_len = dataset_len
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.advance = advance

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        emitted = 0
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            idx = np.arange(self.dataset_len)
            rng.shuffle(idx)
            shard = idx[self.shard_index :: self.num_shards]
            for v in shard.tolist():
                if emitted >= self.advance:
                    yield v
                emitted += 1
            epoch += 1
