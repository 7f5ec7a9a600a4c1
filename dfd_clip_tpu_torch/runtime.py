"""The one-process runtime (counterpart of the part of
dfd_clip_tpu/runtime/mesh.py's MeshRuntime that the training CLI, the
engine, evaluation and the datasets use): one process drives one device and
holds the whole index stream, so the data-parallel width is 1 and
replication, the metric gathers and the string broadcast are identities.
``shard_batch`` places a host batch on the runtime's device. Multi-GPU
(``torch.distributed``) waits for its own slice."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class OneProcess:
    is_main_process = True
    num_processes = 1
    process_index = 0
    data_parallel = 1

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def replicate(self, tree):
        return tree

    def gather_ragged(self, arrays):
        return arrays

    def gather_for_metrics(self, tree: Any) -> Any:
        """Identity on one process: every array is already the global one."""
        return tree

    def broadcast_str(self, s: str) -> str:
        return s

    def shard_batch(self, tree: dict) -> dict:
        """A dict of host arrays as tensors on the runtime's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in tree.items()}

    @staticmethod
    def to_host(x) -> np.ndarray:
        """A tensor (on any device) or array as a host numpy array; bf16
        comes back as f32."""
        if torch.is_tensor(x):
            x = x.detach().to("cpu")
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    def print(self, *args, **kwargs):
        print(*args, **kwargs)
