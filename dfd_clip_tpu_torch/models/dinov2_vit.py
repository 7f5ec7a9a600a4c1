"""Frozen DINOv2 Vision Transformer with per-layer K/V export (counterpart of
dfd_clip_tpu/models/dinov2_vit.py).

A patch-14 ViT with a biased patch embedding, no ``ln_pre``, LayerScale
(``ls1``, ``ls2``), an exact-GELU MLP (giant2: the fused SwiGLU FFN,
``w12`` then silu(x1) * x2 then ``w3``) and a biased qkv projection; K and V
are captured from the qkv projection before attention. Params are plain
dicts of tensors in the layout of models/weights.py (``conv1.w`` OIHW,
``blocks`` a per-layer list). The blocks are the JAX package's composition
(dinov2_vit.py:281-293), run by clip_vit.composition_block with the
LayerScale factors and the FFN: ``linear`` on bf16 operands, LayerNorm
through the row kernel, and the attention on the q, k and v column blocks
of the packed qkv projection, read in place by ``encoder_self_attention``
(csrc/encoder_attention.cu, separate entry). The JAX package computes
both FFNs as XLA ops (dinov2_vit.py:65-91), so here they are torch ops.

Not ported yet: ``dinov2_forward`` with its iBOT masks and stochastic
depth, and ``_pos_embed_for`` (the positional embedding is used at its
stored grid).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import layers
from .clip_vit import ViTConfig, composition_block

Params = Dict[str, Any]

# The reference builds vit_base(patch=14) for the architecture string
# "ViT-B/16" (dinov2_vit.py:30-33); giant2 ships with the fused-SwiGLU FFN.
DINOV2_S14 = ViTConfig(input_resolution=224, patch_size=14, width=384, layers=12, heads=6,
                       output_dim=384)
DINOV2_B14 = ViTConfig(input_resolution=224, patch_size=14, width=768, layers=12, heads=12,
                       output_dim=768)
DINOV2_L14 = ViTConfig(input_resolution=224, patch_size=14, width=1024, layers=24, heads=16,
                       output_dim=1024)
DINOV2_G14 = ViTConfig(input_resolution=224, patch_size=14, width=1536, layers=40, heads=24,
                       output_dim=1536, ffn_layer="swiglufused")

ARCHITECTURES = {
    "ViT-B/16": DINOV2_B14,
    "ViT-S/14": DINOV2_S14,
    "ViT-B/14": DINOV2_B14,
    "ViT-L/14": DINOV2_L14,
    "ViT-g/14": DINOV2_G14,
    # tiny towers for tests (not DINOv2 releases)
    "ViT-Test": ViTConfig(input_resolution=28, patch_size=14, width=32, layers=2, heads=2,
                          output_dim=32),
    "ViT-Test-SwiGLU": ViTConfig(input_resolution=28, patch_size=14, width=32, layers=2,
                                 heads=2, output_dim=32, ffn_layer="swiglufused"),
}


def init_ffn(gen: torch.Generator, cfg: ViTConfig, std: float) -> Params:
    """The FFN's params for the configured family: ``mlp`` (c_fc, c_proj) or
    ``swiglufused`` (w12 (W, 2 hidden), w3 (hidden, W))."""
    w = cfg.width
    if cfg.ffn_layer == "swiglufused":
        hidden = cfg.swiglu_hidden
        return {"w12": layers.init_linear(gen, w, 2 * hidden, std=std),
                "w3": layers.init_linear(gen, hidden, w, std=std)}
    if cfg.ffn_layer != "mlp":
        raise NotImplementedError(f"ffn_layer: {cfg.ffn_layer}")
    return {"c_fc": layers.init_linear(gen, w, 4 * w, std=std),
            "c_proj": layers.init_linear(gen, 4 * w, w, std=std)}


def apply_ffn(mlp: Params, y: torch.Tensor) -> torch.Tensor:
    """The exact-GELU MLP or, keyed on ``w12``, the fused SwiGLU: silu(x1) *
    x2 of w12's two halves, then w3."""
    if "w12" in mlp:
        x1, x2 = layers.linear(mlp["w12"], y).chunk(2, dim=-1)
        return layers.linear(mlp["w3"], F.silu(x1) * x2)
    return layers.linear(mlp["c_proj"], layers.gelu(layers.linear(mlp["c_fc"], y)))


def init_dinov2(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random init with the JAX package's scales (f32, CPU)."""
    w, scale = cfg.width, 0.02

    def block() -> Params:
        return {
            "ln_1": layers.init_layer_norm(w),
            "attn": {"in_proj": layers.init_linear(gen, w, 3 * w, std=scale),
                     "out_proj": layers.init_linear(gen, w, w, std=scale)},
            "ls1": torch.ones(w),
            "ln_2": layers.init_layer_norm(w),
            "mlp": init_ffn(gen, cfg, std=scale),
            "ls2": torch.ones(w),
        }

    return {
        "conv1": {"w": scale * torch.randn(w, 3, cfg.patch_size, cfg.patch_size, generator=gen),
                  "b": torch.zeros(w)},
        "class_embedding": scale * torch.randn(w, generator=gen),
        "mask_token": torch.zeros(w),
        "positional_embedding": scale * torch.randn(cfg.num_tokens, w, generator=gen),
        "blocks": [block() for _ in range(cfg.layers)],
        "ln_post": layers.init_layer_norm(w),
    }


def embed(params: Params, x: torch.Tensor, cfg: ViTConfig,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, 3, H, W) normalized frames -> [CLS; patches + b] + pos, (N, T, W)."""
    x = F.conv2d(x.to(compute_dtype), params["conv1"]["w"].to(compute_dtype),
                 stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2) + params["conv1"]["b"].to(compute_dtype)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    return torch.cat([cls, x], dim=1) + params["positional_embedding"].to(compute_dtype)


def dinov2_kv(
    params: Params, x: torch.Tensor, cfg: ViTConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    keep_layers: Optional[tuple] = None, drop_cls: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the frozen tower, exporting the kept layers' head-split K and V:
    {"k", "v"}: (Lsel, N, T', H, D), T' = T - drop_cls (no pad rows). Blocks
    after the last kept layer are skipped, and the last kept layer runs LN1
    and the qkv projection only (dinov2_vit.py:336-355)."""
    h = embed(params, x, cfg, compute_dtype)
    n, t, w = h.shape
    keep = tuple(range(cfg.layers)) if keep_layers is None else tuple(keep_layers)
    last = max(keep)
    slot_of = {layer: s for s, layer in enumerate(keep)}
    lo = 1 if drop_cls else 0
    kacc = torch.empty((len(keep), n, t - lo, w), dtype=h.dtype, device=h.device)
    vacc = torch.empty_like(kacc)
    for i in range(last + 1):
        into = (kacc, vacc, slot_of[i], len(keep)) if i in keep else None
        h, _ = composition_block(params["blocks"][i], h, cfg, into, drop_cls, attend=i < last,
                                 ffn=apply_ffn, separate_qkv=True)
    shape = (len(keep), n, t - lo, cfg.heads, cfg.head_dim)
    return {"k": kacc.view(shape), "v": vacc.view(shape)}
