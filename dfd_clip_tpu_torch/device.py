"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. The default is the card:
without one it raises rather than running on the CPU. Only an explicit
``device="cpu"`` (what the tests pass) runs there, and then every kernel
wrapper takes its plain PyTorch version.
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
    return dev
