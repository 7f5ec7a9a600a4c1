"""The multi-process runtime (counterpart of dfd_clip_tpu/runtime/mesh.py).

One process a rank over ``torch.distributed``, the ranks laid out as JAX
lays out its device mesh, ``np.asarray(devices).reshape(dp, sp)``
(mesh.py:96-98): rank r sits at data index r // sp and seq index r % sp.
The ranks of one seq row (one data index) share their clips and split
their frames, and with them the decoder's token stream; the ranks of one
data column (one seq index) hold different clips. Each row and each column
gets its own process group. With one rank (no process group started) every
method is the identity or a local placement, and nothing is registered
that model code would act on: the one-process path runs as it did.

Model code finds the layout through the process-wide registration
(``set_current_mesh`` / ``current_mesh`` / ``active_mesh``), as JAX's
ops/spmd.py finds its mesh: the CLIs own one runtime for their lifetime.

Collectives take the caller's backend: NCCL for one rank a card, Gloo on
the CPU and for ranks that share a card (NCCL refuses two ranks on one
device). Gloo takes tensors on a card as they are (all_reduce SUM and MAX,
broadcast and all_gather, probed on an H100 with torch 2.11); NCCL takes
only those, so a host tensor (a metric gather's numpy rows) is copied to
the card for the collective and back (``_staged``). Each rank counts the
bytes it hands to each kind of collective in ``traffic``.
"""

from __future__ import annotations

import logging
from collections import Counter
from contextlib import contextmanager
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_CURRENT: Optional["MeshRuntime"] = None


def set_current_mesh(layout: Optional["MeshRuntime"]) -> Optional["MeshRuntime"]:
    """Register ``layout`` as the process's runtime; returns the previous one
    so that callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = layout
    return prev


def current_mesh() -> Optional["MeshRuntime"]:
    return _CURRENT


@contextmanager
def active_mesh(layout: Optional["MeshRuntime"]):
    """Scope a registration: the previous one comes back on exit."""
    prev = set_current_mesh(layout)
    try:
        yield layout
    finally:
        set_current_mesh(prev)


def best_mesh_shape(n_ranks: int, seq_parallel: int = 1) -> tuple:
    """``n_ranks`` as (data, seq)."""
    if seq_parallel < 1 or n_ranks % seq_parallel:
        raise ValueError(f"seq_parallel={seq_parallel} must divide the {n_ranks} ranks")
    return n_ranks // seq_parallel, seq_parallel


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


_OPS = {"sum": "SUM", "max": "MAX"}


class MeshRuntime:
    """The ranks' (data, seq) layout, their process groups, the placement of
    batches and the gathers of results."""

    DATA_AXIS = "data"
    SEQ_AXIS = "seq"

    def __init__(self, seq_parallel: int = 1, device="cuda", backend: Optional[str] = None):
        """``device``: "cuda" is this host's card ``cuda:<LOCAL_RANK>``
        (raises when there is no such card), an explicit index or "cpu" as
        given. ``backend``: the collectives' backend, which must be the
        started process group's."""
        from ..device import resolve_device
        from .launch import local_device

        self.device = resolve_device(local_device(device))
        up = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if up else 1
        rank = dist.get_rank() if up else 0
        self.data_parallel, self.seq_parallel = best_mesh_shape(world, seq_parallel)
        self.num_processes, self.process_index = world, rank
        self.data_index, self.seq_index = divmod(rank, self.seq_parallel)
        self.backend = dist.get_backend() if up else None
        if up and backend is not None and backend != self.backend:
            raise ValueError(f"the process group runs {self.backend}, not {backend}")
        self.traffic: Counter = Counter()   # "<op> <axis>" -> bytes this rank handed over
        self._groups = {"world": None, "seq": None, "data": None}
        if world > 1:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            dp, sp = self.data_parallel, self.seq_parallel
            # every rank creates every group, in one order (new_group is collective)
            for d in range(dp):
                g = dist.new_group([d * sp + s for s in range(sp)]) if sp > 1 else None
                if d == self.data_index:
                    self._groups["seq"] = g
            for s in range(sp):
                g = dist.new_group([d * sp + s for d in range(dp)]) if dp > 1 else None
                if s == self.seq_index:
                    self._groups["data"] = g
        logger.info("MeshRuntime: rank %d of %d, (data=%d, seq=%d) at (%d, %d) on %s",
                    rank, world, self.data_parallel, self.seq_parallel, self.data_index,
                    self.seq_index, self.device)
        set_current_mesh(self)

    def deactivate(self) -> None:
        """Unregister this runtime if it still is the process's."""
        if current_mesh() is self:
            set_current_mesh(None)

    def __enter__(self) -> "MeshRuntime":
        set_current_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        self.deactivate()

    # -- process topology ----------------------------------------------------
    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    def print(self, *args: Any, **kwargs: Any) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    def axis_size(self, axis: str) -> int:
        return {"world": self.num_processes, "seq": self.seq_parallel,
                "data": self.data_parallel}[axis]

    # -- collectives ---------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective reads and writes: ``t`` itself, or a copy
        (written back by the caller) where ``t`` is not contiguous or NCCL
        gets a host tensor."""
        t = t.contiguous() if not t.is_contiguous() else t
        return t.to(self.device) if self.backend == "nccl" and not t.is_cuda else t

    def all_reduce_(self, t: torch.Tensor, op: str = "sum", axis: str = "world") -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` ("world", "seq" or "data") with
        ``op`` ("sum" or "max"); a one-rank axis leaves it as it is."""
        if self.axis_size(axis) == 1:
            return t
        h = self._staged(t)
        dist.all_reduce(h, op=getattr(dist.ReduceOp, _OPS[op]), group=self._groups[axis])
        self.traffic[f"all_reduce_{op} {axis}"] += h.numel() * h.element_size()
        if h is not t:
            t.copy_(h)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "world") -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all) over ``axis``, in rank order."""
        if self.axis_size(axis) == 1:
            return [t]
        h = self._staged(t)
        out = [torch.empty_like(h) for _ in range(self.axis_size(axis))]
        dist.all_gather(out, h, group=self._groups[axis])
        self.traffic[f"all_gather {axis}"] += h.numel() * h.element_size()
        return [o.to(t.device) for o in out] if h is not t else out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.num_processes == 1:
            return t
        h = self._staged(t)
        dist.broadcast(h, src=src)
        self.traffic["broadcast world"] += h.numel() * h.element_size()
        if h is not t:
            t.copy_(h)
        return t

    def barrier(self, name: str = "") -> None:
        """A barrier over every rank (every rank calls it): fences rank-0-only
        host work, such as a checkpoint write, off what follows."""
        if self.num_processes > 1:
            dist.barrier()

    # -- placement -------------------------------------------------------------
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (its data index's
        share; the ranks of a seq row hold the same rows)."""
        if n % self.data_parallel:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.data_parallel} data ranks")
        b = n // self.data_parallel
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def frames(self, t: int) -> slice:
        """This rank's frames of a clip of ``t`` (its seq index's share)."""
        if t % self.seq_parallel:
            raise ValueError(f"{t} frames do not split over {self.seq_parallel} seq ranks")
        f = t // self.seq_parallel
        return slice(self.seq_index * f, (self.seq_index + 1) * f)

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device)

    def shard_batch(self, tree: dict, frames=()) -> dict:
        """A dict of global host arrays as this rank's rows on its device;
        the keys in ``frames`` also keep only this rank's frames (axis 1).
        One rank: every array whole on the device."""
        out = {}
        for k, v in tree.items():
            v = np.asarray(v) if not torch.is_tensor(v) else v
            if self.num_processes > 1:
                v = v[self.rows(v.shape[0])]
                if k in frames:
                    v = v[:, self.frames(v.shape[1])]
            out[k] = self._place(v)
        return out

    def shard_local_batch(self, x, batch_axis: int = 0):
        """This rank's own rows (each rank passes its local slice, the
        per-rank sampler design) on its device."""
        return None if x is None else self._place(x)

    def replicate(self, tree):
        """Rank 0's value of every tensor leaf on every rank (its device)."""
        if self.num_processes == 1:
            return tree

        def one(x):
            if not torch.is_tensor(x):
                return x
            return self.broadcast_(x.detach().to(self.device).clone())

        return _tree_map(one, tree)

    def pad_batch_to_devices(self, n: int) -> int:
        """The smallest multiple of the data width that is >= n."""
        dp = self.data_parallel
        return ((n + dp - 1) // dp) * dp

    @staticmethod
    def to_host(x) -> np.ndarray:
        """A tensor (on any device) or array as a host numpy array; bf16
        comes back as f32. A tensor holds this rank's rows."""
        if torch.is_tensor(x):
            x = x.detach().to("cpu")
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    # -- gathers -------------------------------------------------------------
    def _gather_rows(self, x: np.ndarray, ranks=None) -> List[np.ndarray]:
        """Every rank's host array (one shape on all), in rank order; bool
        travels as uint8 (Gloo reduces no bool)."""
        t = torch.from_numpy(np.ascontiguousarray(x.astype(np.uint8) if x.dtype == bool else x))
        parts = [p.cpu().numpy() for p in self.all_gather(t)]
        return [p.astype(bool) for p in parts] if x.dtype == bool else parts

    def gather_for_metrics(self, tree: Any) -> Any:
        """Every data rank's rows of each host array, in data order, as
        numpy (the ranks of a seq row hold the same rows, so seq index 0
        speaks for its row); a 0-d leaf becomes one value a data rank. One
        rank: the tree as it is."""
        if self.num_processes == 1:
            return tree
        sp = self.seq_parallel

        def one(x):
            parts = self._gather_rows(np.asarray(x))[::sp]
            return np.stack(parts) if parts[0].ndim == 0 else np.concatenate(parts)

        return _tree_map(one, tree)

    def gather_ragged(self, tree: Any) -> Any:
        """Gather host arrays whose leading size differs across ranks (e.g.
        per-rank video shards of an unevenly split test set): padded to
        the all-rank maximum, gathered once, trimmed, concatenated in rank
        order. One rank: the tree as it is."""
        if self.num_processes == 1:
            return tree

        def one(x):
            x = np.asarray(x)
            counts = np.concatenate(self._gather_rows(np.asarray([x.shape[0]], np.int64)))
            cap = int(counts.max())
            if cap == 0:
                return x.reshape((0,) + x.shape[1:])
            padded = np.concatenate([x, np.zeros((cap - x.shape[0],) + x.shape[1:], x.dtype)])
            parts = self._gather_rows(padded)
            return np.concatenate([p[:c] for p, c in zip(parts, counts)])

        return _tree_map(one, tree)

    def broadcast_str(self, s: str, max_bytes: int = 1024) -> str:
        """Rank 0's string on every rank (run directories, timestamps)."""
        if self.num_processes == 1:
            return s
        buf = torch.zeros(max_bytes, dtype=torch.uint8)
        raw = s.encode()[:max_bytes]
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        out = self.broadcast_(buf).numpy()
        return bytes(out[out != 0]).decode()

    def materialize(self, tree: Any, sharded: Any = None) -> Any:
        """Host (numpy) copies of every leaf; the leaves that ``sharded`` (a
        tree of bools beside ``tree``) marks hold this rank's slice of
        their leading axis, and are all-gathered over the data axis first.
        A collective: every rank calls it."""
        if sharded is None:
            return _tree_map(lambda x: np.array(self.to_host(x)), tree)

        def walk(x, s):
            if isinstance(x, dict):
                return {k: walk(v, s[k]) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v, f) for v, f in zip(x, s))
            if s:
                x = torch.cat(self.all_gather(x.detach().contiguous(), "data"))
            return np.array(self.to_host(x))

        return walk(tree, sharded)
