"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. The default is the card:
without one it raises rather than running on the CPU. Only an explicit
``device="cpu"`` (what the tests pass) runs there, and then every kernel
wrapper takes its plain PyTorch version.

Resolving the card also turns off cuBLAS's reduced-precision reductions of
bf16 products (a process-wide torch setting), so every bf16 ``torch.matmul``
of the port (``models/layers.linear``) accumulates in f32, as the
reference's XLA products do.

``prefetch_iter`` (the counterpart of dfd_clip_tpu/utils/device.py's) runs
the host-to-card copies of an input stream one item ahead on a background
thread.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def prefetch_iter(iterable, place_fn, lookahead: int = 1):
    """Iterate ``iterable`` with ``place_fn`` (e.g. a copy to the card)
    applied in a background thread ``lookahead`` items ahead, overlapping the
    copies with the consumer's compute. Leaving the loop early (a break or an
    exception) stops the thread: its puts give up once the consumer is
    gone, so it never stays blocked holding placed items."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=lookahead)
    stop = threading.Event()

    def put_stop_aware(msg) -> None:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.5)
                return
            except queue.Full:
                continue

    def produce():
        try:
            for item in iterable:
                put_stop_aware(("ok", place_fn(item)))
                if stop.is_set():
                    return
            put_stop_aware(("done", None))
        except Exception as e:
            put_stop_aware(("err", e))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            kind, value = q.get()
            if kind == "ok":
                yield value
            elif kind == "err":
                raise value
            else:
                return
    finally:
        stop.set()
        while True:  # drain so a blocked producer put() can observe stop
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
