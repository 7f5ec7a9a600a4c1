"""Cosine schedules and the SSL optimizer (counterpart of
dfd_clip_tpu/ssl/schedules.py; dinov2/train/train.py:66-111 and
dinov2/utils/param_groups.py:14-96).

``SSLOptimizer`` is a hand-written counterpart of the JAX package's optax
chain (schedules.py:144-167), applied in this order to the student's
gradients:

1. clip by global norm (3.0);
2. Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments);
3. ``+ wd(count) * p`` on the leaves that decay;
4. the leaf's layerwise learning-rate multiplier;
5. ``* -lr(count)``, then added to the parameter.

This is not ``torch.optim.AdamW``: the weight decay is added to the Adam
update before the layerwise multiplier and the learning rate scale it. The
schedules read the optimizer's own step count ``count``, which a
checkpoint saves with the moments (``state_dict``).

Labels follow the JAX package's ``_leaf_label`` (schedules.py:68-80), which
it computes on its layer-stacked tree: a block leaf there has one more
axis than the port's per-layer leaf, so a block leaf's rank is counted with
that axis. Each leaf gets (depth, no_decay, patch_embed): depth 0 for the
embeddings, 1 for the blocks, 2 for ``ln_post`` and the heads; no decay for
LayerNorms, biases, LayerScales and every leaf of rank <= 1; patch_embed for
``conv1`` and the positional embedding. Multipliers: ``decay ** n_layers``
for the embeddings (times 0.2 for patch_embed), ``decay ** (n_layers - i)``
for block i, 1 for the rest.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..engine.optim import named_leaves


def cosine_with_warmup(base: float, final: float, total_steps: int, warmup_steps: int = 0,
                       start: float = 0.0, freeze_steps: int = 0) -> Callable[[int], float]:
    """Linear warmup from ``start`` to ``base``, then cosine to ``final`` at
    ``total_steps`` (constant after), 0 before ``freeze_steps``."""

    def schedule(step) -> float:
        step = float(step)
        if step < freeze_steps:
            return 0.0
        if step < warmup_steps:
            return start + (base - start) * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return final + 0.5 * (base - final) * (1 + math.cos(math.pi * progress))

    return schedule


def sqrt_lr_scaling(base_lr: float, global_batch: int) -> float:
    """The reference's square-root learning-rate rule (dinov2/utils/config.py:23-31)."""
    return base_lr * float(np.sqrt(global_batch / 1024.0))


def leaf_label(path: tuple, ndim: int) -> Tuple[int, bool, bool]:
    """(depth, no_decay, patch_embed) of the leaf at ``path`` of rank
    ``ndim`` (a block leaf's rank counted with the layer axis)."""
    names = [str(p) for p in path]
    depth = 0
    if "blocks" in names:
        depth = 1
    if any(n in names for n in ("ln_post", "head", "dino_head", "ibot_head")):
        depth = 2
    no_decay = ndim <= 1 or any(n.startswith("ln") or n in ("scale", "bias", "b", "ls1", "ls2")
                                for n in names)
    patch_embed = "conv1" in names or "positional_embedding" in names
    return depth, bool(no_decay), bool(patch_embed)


def param_labels(params) -> List[Tuple[tuple, Tuple[int, bool, bool]]]:
    """(path, label) of every leaf of the port's tree, in ``named_leaves``
    order."""
    return [(path, leaf_label(path, t.dim() + ("blocks" in path)))
            for path, t in named_leaves(params)]


def lr_multiplier(path: tuple, label: Tuple[int, bool, bool], n_layers: int,
                  layerwise_decay: float, patch_embed_lr_mult: float = 0.2) -> float:
    """The leaf's layerwise learning-rate multiplier (the JAX package's
    _layerwise_scale)."""
    depth, _, patch_embed = label
    mult = layerwise_decay ** n_layers if depth == 0 else 1.0
    if patch_embed:
        mult *= patch_embed_lr_mult
    if "blocks" in path:
        mult *= layerwise_decay ** (n_layers - path[path.index("blocks") + 1])
    return mult


class SSLOptimizer:
    """The optax chain of the module note over the leaves of ``params`` (the
    student tree, leaves f32 tensors). ``step(grads)`` updates the leaves in
    place from their gradients (a list in ``named_leaves`` order)."""

    def __init__(self, params, lr_schedule: Callable, wd_schedule: Callable, n_layers: int,
                 layerwise_decay: float = 0.9, patch_embed_lr_mult: float = 0.2,
                 betas=(0.9, 0.999), eps: float = 1e-8, clip_norm: float = 3.0):
        self.lr_schedule, self.wd_schedule = lr_schedule, wd_schedule
        self.betas, self.eps, self.clip_norm = betas, eps, clip_norm
        named = named_leaves(params)
        self.paths = [p for p, _ in named]
        self.params = [t for _, t in named]
        labels = [lab for _, lab in param_labels(params)]
        self.decays = [not lab[1] for lab in labels]
        self.mults = [lr_multiplier(p, lab, n_layers, layerwise_decay, patch_embed_lr_mult)
                      for p, lab in zip(self.paths, labels)]
        self.mu = [torch.zeros_like(t) for t in self.params]
        self.nu = [torch.zeros_like(t) for t in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], hold=(), norm=None) -> None:
        """One update of every leaf from ``grads``; the leaves whose paths
        are in ``hold`` get a zero update (their moments still move). Every
        stage is a multi-tensor (foreach) operation over all the leaves,
        rounding as the per-leaf chain does: a few launches a stage
        instead of one a leaf. The clip multiplies by clip / norm where
        optax divides by the norm, then multiplies (an ulp apart). ``norm``:
        the gradient's global norm when the leaves are slices of it (FSDP);
        by default the norm of ``grads``."""
        b1, b2 = self.betas
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        g = torch._foreach_mul(grads, factor)
        wd, lr = self.wd_schedule(self.count), self.lr_schedule(self.count)
        self.count += 1
        # optax's bias corrections, 1 - b ** count in f32 (1 - 0.999 ** 2
        # cancels: computed in float64 it differs from optax's by 3e-5)
        bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(self.count))
                    for b in (b1, b2))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        del g
        live = [i for i, p in enumerate(self.paths) if p not in hold]
        den = torch._foreach_div([self.nu[i] for i in live], bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div([self.mu[i] for i in live], bc1)
        torch._foreach_div_(u, den)
        del den
        decay = [k for k, i in enumerate(live) if self.decays[i]]
        torch._foreach_add_([u[k] for k in decay],
                            torch._foreach_mul([self.params[live[k]] for k in decay], wd))
        torch._foreach_mul_(u, [self.mults[i] for i in live])
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_([self.params[i] for i in live], u)

    def state_dict(self) -> Dict:
        """The moments (lists of tensors in leaf order) and the step count."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.mu = [torch.as_tensor(np.asarray(m)).to(t.device, t.dtype)
                   for m, t in zip(state["mu"], self.params)]
        self.nu = [torch.as_tensor(np.asarray(m)).to(t.device, t.dtype)
                   for m, t in zip(state["nu"], self.params)]
        self.count = int(state["count"])
