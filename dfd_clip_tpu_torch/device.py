"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. The default is the card:
without one it raises rather than running on the CPU. Only an explicit
``device="cpu"`` (what the tests pass) runs there, and then every kernel
wrapper takes its plain PyTorch version.

Resolving the card also turns off cuBLAS's reduced-precision reductions of
bf16 products (a process-wide torch setting), so every bf16 ``torch.matmul``
of the port (``models/layers.linear``) accumulates in f32, as the
reference's XLA products do.
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
