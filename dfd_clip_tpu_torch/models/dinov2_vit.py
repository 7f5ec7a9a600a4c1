"""Frozen DINOv2 Vision Transformer with per-layer K/V export (counterpart of
dfd_clip_tpu/models/dinov2_vit.py).

A patch-14 ViT with a biased patch embedding, no ``ln_pre``, LayerScale
(``ls1``, ``ls2``), an exact-GELU MLP and a biased qkv projection; K and V
are captured from the qkv projection before attention. Params are plain
dicts of tensors in the layout of models/weights.py (``conv1.w`` OIHW,
``blocks`` a per-layer list). The blocks are the JAX package's composition
(dinov2_vit.py:281-293), run by clip_vit.composition_block with the
LayerScale factors and the exact-GELU FFN: ``linear`` on bf16 operands,
LayerNorm through the row kernel, and the attention on the q, k and v
column blocks of the packed qkv projection, read in place by
``encoder_self_attention`` (csrc/encoder_attention.cu, separate entry).

Not ported yet: the fused SwiGLU FFN of giant2 (``ffn_layer
"swiglufused"``, which raises), ``dinov2_forward`` with its iBOT masks and
stochastic depth, and ``_pos_embed_for`` (the positional embedding is used
at its stored grid).
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
    # tiny tower for tests (not a DINOv2 release)
    "ViT-Test": ViTConfig(input_resolution=28, patch_size=14, width=32, layers=2, heads=2,
                          output_dim=32),
}


def init_ffn(gen: torch.Generator, cfg: ViTConfig, std: float) -> Params:
    if cfg.ffn_layer != "mlp":
        raise NotImplementedError(f"ffn_layer {cfg.ffn_layer!r} (giant2's fused SwiGLU) is "
                                  "not ported yet")
    w = cfg.width
    return {"c_fc": layers.init_linear(gen, w, 4 * w, std=std),
            "c_proj": layers.init_linear(gen, 4 * w, w, std=std)}


def apply_ffn(mlp: Params, y: torch.Tensor) -> torch.Tensor:
    """The exact-GELU MLP (the ``mlp`` FFN family)."""
    if "w12" in mlp:
        raise NotImplementedError("the fused SwiGLU FFN (giant2) is not ported yet")
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
