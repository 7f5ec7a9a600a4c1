"""dfd_clip_tpu_torch: the PyTorch/CUDA port of dfd_clip_tpu for NVIDIA
Hopper (H100).

The module layout mirrors ``dfd_clip_tpu``; the JAX package is the reference
the port is tested against and is never imported here. Entry points take an
explicit ``device`` that defaults to the card (``"cuda"``) and raise without
one; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
