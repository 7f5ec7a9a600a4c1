"""Console training telemetry (the port's copy of
dfd_clip_tpu/utils/logging.py): process-aware logging setup, smoothed
stats and ETA iteration logging.

Equivalents of the reference's MetricLogger/SmoothedValue
(dinov2/logging/helpers.py:21-195): windowed medians/means for loss values,
iter/data timing, ETA projection, and the card's peak allocated memory
(``torch.cuda.max_memory_allocated``) when a card is present. The port runs
one process (runtime.OneProcess), which is rank 0.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional


def setup_logging(output_dir: Optional[str] = None, level: int = logging.INFO,
                  rank: int = 0) -> None:
    """Process-aware logging setup (dinov2/logging/__init__.py:20-103
    semantics): every rank writes its own ``log.rank<k>.txt`` under
    ``output_dir``; only rank 0 also logs to stdout. Idempotent."""
    root = logging.getLogger()
    if getattr(root, "_dfd_configured", False):
        return
    root._dfd_configured = True  # type: ignore[attr-defined]
    for h in list(root.handlers):  # supersede any earlier basicConfig
        root.removeHandler(h)
    root.setLevel(level)
    fmt = logging.Formatter(
        "%(levelname).1s%(asctime)s %(name)s:%(lineno)d] %(message)s",
        datefmt="%Y%m%d %H:%M:%S",
    )
    if rank == 0:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        root.addHandler(h)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        f = logging.FileHandler(os.path.join(output_dir, f"log.rank{rank}.txt"))
        f.setFormatter(fmt)
        root.addHandler(f)


class SmoothedValue:
    """Track a series with a rolling window and global accumulators."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, num: int = 1) -> None:
        self.deque.append(value)
        self.count += num
        self.total += value * num

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


def _device_memory_mb() -> Optional[float]:
    """The card's peak allocated memory in MB, None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", output=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.output = output

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name: str) -> SmoothedValue:
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None) -> Iterator:
        """Yield from ``iterable`` printing smoothed timing + ETA lines."""
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None
        )
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (total is not None and i == total - 1):
                parts = [header, f"[{i}" + (f"/{total}]" if total else "]")]
                if total is not None:
                    eta = iter_time.global_avg * (total - i)
                    parts.append(f"eta: {datetime.timedelta(seconds=int(eta))}")
                parts.append(str(self))
                parts.append(f"time: {iter_time}")
                parts.append(f"data: {data_time}")
                mem = _device_memory_mb()
                if mem is not None:
                    parts.append(f"max mem: {mem:.0f}MB")
                self.output(self.delimiter.join(p for p in parts if p))
        elapsed = time.time() - start
        self.output(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")
