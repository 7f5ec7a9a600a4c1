"""Optimizers and the OneCycle learning-rate schedule (counterpart of
dfd_clip_tpu/engine/optim.py, which builds them with optax).

SGD with momentum 0.95 or AdamW, weight decay on every trainable leaf except
BatchNorm running statistics, and the OneCycle schedule (cosine anneal,
pct_start 0.3, div_factor 25, final_div_factor 1e4). The optimizer holds no
schedule: the trainer sets the learning rate of step k to ``schedule(k)``
before each ``step()``, the step count optax's schedule reads.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch


def one_cycle_schedule(max_lr: float, total_steps: int) -> Callable[[int], float]:
    """The values of ``optax.cosine_onecycle_schedule(total_steps, max_lr)``
    as a plain function of the step: cosine from max_lr / 25 up to max_lr
    over the first int(0.3 total_steps) steps, then cosine down to
    max_lr / 25 / 1e4 at total_steps, constant after. (Where the warm-up is
    empty, total_steps < 4, optax's schedule is NaN; this one skips it.)"""
    if total_steps <= 0:
        raise ValueError("one_cycle_schedule: total_steps must be positive")
    bounds = (0, int(0.3 * total_steps), int(total_steps))
    values = (max_lr / 25.0, max_lr, max_lr / 25.0 / 1e4)

    def schedule(step: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= step < hi:
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * (step - lo) / (hi - lo)) + 1)
        return values[-1]

    return schedule


def named_leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, path + (i,))]
    return [(path, tree)]


def _decays(path: tuple) -> bool:
    """Weight decay applies to every trainable leaf except BatchNorm running
    statistics (an adapter's "bn" mean/var), which are state, not weights."""
    return not ("bn" in path and path[-1] in ("mean", "var"))


def build_optimizer(spec: Dict, schedule: Callable[[int], float],
                    params) -> torch.optim.Optimizer:
    """The optimizer of ``spec`` ({"name": "sgd" | "adamw", "weight_decay"})
    over the leaves of the ``params`` tree, at the learning rate of step 0.
    SGD couples the decay into the gradient before momentum (optax's
    add_decayed_weights + sgd); AdamW decouples it (optax.adamw)."""
    wd = spec.get("weight_decay", 0.0)
    leaves = named_leaves(params)
    groups = [{"params": [t for p, t in leaves if _decays(p)], "weight_decay": wd},
              {"params": [t for p, t in leaves if not _decays(p)], "weight_decay": 0.0}]
    groups = [g for g in groups if g["params"]]
    lr = schedule(0)
    if spec["name"] == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=0.95)
    if spec["name"] == "adamw":
        return torch.optim.AdamW(groups, lr=lr)
    raise NotImplementedError(f"Unknown optimizer: {spec['name']}")
