"""DINO projection head (counterpart of dfd_clip_tpu/ssl/dino_head.py): an
exact-GELU MLP to a bottleneck, L2-normalised, then the weight-normed
prototype layer (direction ``last_v`` normalised per prototype, scale
``last_g``). The heads run in f32, as the JAX package's do: the tower's
``cls`` / ``patch`` outputs arrive in f32."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import layers

Params = Dict[str, Any]


def init_dino_head(gen: torch.Generator, in_dim: int, out_dim: int, hidden_dim: int = 2048,
                   bottleneck_dim: int = 256, n_layers: int = 3) -> Params:
    """Random init with the JAX package's scales (f32, CPU)."""
    dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [bottleneck_dim]
    mlp = [layers.init_linear(gen, dims[i], dims[i + 1], std=0.02) for i in range(n_layers)]
    return {"mlp": mlp,
            "last_v": 0.02 * torch.randn(bottleneck_dim, out_dim, generator=gen),
            "last_g": torch.ones(out_dim)}


def apply_dino_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) -> prototype logits (N, out_dim)."""
    h = x
    n = len(params["mlp"])
    for i, lin in enumerate(params["mlp"]):
        h = layers.linear(lin, h)
        if i < n - 1:
            h = layers.gelu(h)
    h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-8)
    v = params["last_v"]
    v = v / (torch.linalg.vector_norm(v, dim=0, keepdim=True) + 1e-8)
    return (h @ v) * params["last_g"]
