"""The one-process runtime (counterpart of the part of
dfd_clip_tpu/runtime/mesh.py's MeshRuntime that evaluation and the datasets
use): one process holds the whole index stream, so replication and the
ragged gather are identities. ``torch.distributed`` waits for the
multi-GPU slice."""

from __future__ import annotations


class OneProcess:
    is_main_process = True
    num_processes = 1
    process_index = 0

    def replicate(self, tree):
        return tree

    def gather_ragged(self, arrays):
        return arrays

    def print(self, *args, **kwargs):
        print(*args, **kwargs)
