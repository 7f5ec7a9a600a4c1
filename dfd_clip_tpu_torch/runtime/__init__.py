"""The port's runtime (counterpart of dfd_clip_tpu/runtime/): the launch
(``launch``), the ranks' (data, seq) layout and its collectives
(``mesh.MeshRuntime``), and seeded generator streams (``prng.KeySeq``).

``OneProcess`` is the runtime that library callers build where no process
group is up (a Trainer from loaders, a dataset without a runtime, a test):
``MeshRuntime`` on one rank, so replication, the metric gathers and the
string broadcast are identities and its registration leaves model code on
the one-rank path. Its device is the card unless the caller names another,
and without a card it raises, as every entry point does.
"""

from __future__ import annotations

from .mesh import MeshRuntime, active_mesh, best_mesh_shape, current_mesh, set_current_mesh
from .prng import KeySeq


class OneProcess(MeshRuntime):
    def __init__(self, device="cuda"):
        super().__init__(device=device)


__all__ = ["MeshRuntime", "OneProcess", "KeySeq", "best_mesh_shape", "active_mesh",
           "current_mesh", "set_current_mesh"]
