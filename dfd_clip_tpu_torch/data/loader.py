"""Host-side data loader (the port's own copy of dfd_clip_tpu/data/loader.py).

A map-style dataset + collate, per-epoch seeded shuffling, and a thread-pool
prefetcher (cv2 releases the GIL during decode, so threads scale). With
``num_shards`` > 1 each process owns a rank-strided shard of the index
stream. The index stream, shuffle included, equals the JAX package's for the
same seed, epoch and shard.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional

import numpy as np


def default_collate(batch: List[Any]):
    """Stack tuple-of-arrays items (torch default_collate subset)."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return [default_collate([b[i] for b in batch]) for i in range(len(first))]
    if isinstance(first, np.ndarray):
        return np.stack(batch)
    # bool before int: Python bool IS an int subclass, so the int branch
    # would otherwise collate True/False to int64
    if isinstance(first, (bool, np.bool_)):
        return np.asarray(batch, bool)
    if isinstance(first, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(batch, np.float64)
    return batch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        collate_fn: Optional[Callable] = None,
        drop_last: bool = False,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._skip_batches = 0

    def set_position(self, epoch: int, batches_done: int) -> None:
        """Resume the deterministic stream mid-epoch: the next ``__iter__``
        uses ``epoch``'s shuffle (seed + epoch) and skips the first
        ``batches_done`` batches without touching the underlying dataset
        (no decode work for skipped items), so a restarted run continues
        the data stream where its checkpoint left off instead of replaying
        the epoch from the top."""
        self.epoch = int(epoch)
        self._skip_batches = int(batches_done)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index :: self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        # advertise the stream position: per-sample randomness is keyed on
        # (seed, epoch, idx) in the dataset (datasets._SampleRNGMixin), so a
        # set_position resume redraws the exact same speed/augment stream
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        indices = self._indices()
        self.epoch += 1
        n = len(indices)
        end = n - n % self.batch_size if self.drop_last else n
        batches = [
            indices[i : i + self.batch_size] for i in range(0, end, self.batch_size)
        ]
        if self._skip_batches:
            batches = batches[self._skip_batches:]
            self._skip_batches = 0
        if not batches:
            return iter(())

        if self.num_workers <= 0:
            def gen():
                for b in batches:
                    yield self.collate_fn([self.dataset[int(i)] for i in b])

            return gen()

        return self._prefetch_iter(batches)

    def _prefetch_iter(self, batches: List[np.ndarray]) -> Iterator[Any]:
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out: "queue.Queue" = queue.Queue(maxsize=max(2, self.num_workers))
        stop = threading.Event()

        def put(item) -> bool:
            """bounded put that aborts on stop — never leaves the producer
            blocked on a full queue after the consumer has gone away (a
            blocked daemon thread can die at interpreter exit mid-way
            through a native decode call)."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(self.dataset.__getitem__, [int(i) for i in b]))
                    if not put(("ok", self.collate_fn(items))):
                        break
            except Exception as e:  # surface worker errors to the consumer
                put(("err", e))
            finally:
                # Stop-aware bounded put, like the err path: a put_nowait here
                # drops the sentinel whenever the queue is momentarily full
                # (slow consumer at end of epoch — the normal case) and the
                # consumer then blocks forever on out.get().
                put(("done", None))

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()

        def gen():
            try:
                while True:
                    kind, value = out.get()
                    if kind == "ok":
                        yield value
                    elif kind == "err":
                        raise value
                    else:
                        return
            finally:
                stop.set()
                while True:  # drain so a blocked producer can observe stop
                    try:
                        out.get_nowait()
                    except queue.Empty:
                        break
                producer.join(timeout=5.0)
                pool.shutdown(wait=False, cancel_futures=True)

        return gen()
