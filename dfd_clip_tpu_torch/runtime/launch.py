"""Cluster launch (counterpart of dfd_clip_tpu/runtime/launch.py).

Reads the launcher's environment and starts ``torch.distributed``:
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
(``LOCAL_RANK`` picks the card, ``local_device``), or SLURM's
``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_JOB_NODELIST`` (the first
host of the node list, port ``DEFAULT_PORT``). Explicit arguments win over
both; ``init_method`` (e.g. ``file://<path>``) with ``world_size`` and
``rank`` needs no environment at all. The caller names the backend:
``"nccl"`` for one rank a card, ``"gloo"`` on the CPU and where ranks share
a card (NCCL refuses two ranks on one device). This module is the port's
one reader of the process environment: a launcher hands its ranks their
coordinates there and nowhere else.
"""

from __future__ import annotations

import logging
import os
import subprocess
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_PORT = 8476
TIMEOUT = timedelta(minutes=10)


def slurm_env() -> Optional[dict]:
    """{"init_method", "world_size", "rank"} from SLURM's variables, or None
    outside a SLURM job."""
    env = os.environ
    if "SLURM_PROCID" not in env or "SLURM_NTASKS" not in env:
        return None
    first = subprocess.check_output(["scontrol", "show", "hostnames",
                                     env["SLURM_JOB_NODELIST"]], text=True).splitlines()[0]
    return {"init_method": f"tcp://{first}:{DEFAULT_PORT}",
            "world_size": int(env["SLURM_NTASKS"]), "rank": int(env["SLURM_PROCID"])}


def torchrun_env() -> Optional[dict]:
    """{"init_method", "world_size", "rank"} from torchrun's variables, or
    None when they are not all set."""
    env = os.environ
    keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if not all(k in env for k in keys):
        return None
    return {"init_method": "env://", "world_size": int(env["WORLD_SIZE"]),
            "rank": int(env["RANK"])}


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK, SLURM's
    SLURM_LOCALID), 0 when neither is set."""
    env = os.environ
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))


def local_device(device="cuda") -> torch.device:
    """``device`` with its card index filled in: ``"cuda"`` without an index
    becomes ``cuda:<local rank>``; an explicit index stays. Raises when the
    index names no card of this host: a rank never lands on another rank's
    card or on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        from ..device import resolve_device

        return resolve_device(dev)   # raises: no card at all
    index = local_rank() if dev.index is None else dev.index
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"rank's card cuda:{index} does not exist: this host has {count} "
                           "card(s); launch at most one rank a card")
    return torch.device("cuda", index)


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Start the default process group on ``backend`` from the arguments, or
    torchrun's variables, or SLURM's. Returns False, starting nothing, when
    none of them names a cluster; True when the group is up (also when it
    already was)."""
    if dist.is_initialized():
        return True
    if init_method is None:
        found = torchrun_env() or slurm_env()
        if found is None:
            return False
        init_method = found["init_method"]
        world_size = found["world_size"] if world_size is None else world_size
        rank = found["rank"] if rank is None else rank   # rank 0 is falsy: test for None
    if world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    logger.info("torch.distributed up: rank %d of %d on %s via %s", rank, world_size,
                backend, init_method)
    return True


def shutdown() -> None:
    """Tear the default process group down, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
