"""Frozen CLIP Vision Transformer with per-layer K/V export (counterpart of
dfd_clip_tpu/models/clip_vit.py).

Params are plain dicts of tensors: ``conv1.w`` in PyTorch's OIHW layout and
``blocks`` a list of per-layer dicts (models/weights.py converts the JAX
package's HWIO, layer-stacked form). The forward is the JAX package's fused,
stacked-export path: every block's attention half and MLP half go through
ops/encoder_block.py, the kept layers write their CLS-dropped K/V straight
into one (Lsel, N, T', W) buffer per K and V, blocks after the last kept
layer are skipped, and the last kept layer runs LN1 + the K/V projection
only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import layers
from ..ops.encoder_block import fused_encoder_attn_block, fused_encoder_mlp_block

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


VIT_B16 = ViTConfig()
VIT_L14 = ViTConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=768)

ARCHITECTURES = {
    "ViT-B/16": VIT_B16,
    "ViT-B/32": dataclasses.replace(VIT_B16, patch_size=32),
    "ViT-L/14": VIT_L14,
    "ViT-L/14@336px": dataclasses.replace(VIT_L14, input_resolution=336),
    # tiny towers for tests (not CLIP releases)
    "ViT-Test": ViTConfig(input_resolution=32, patch_size=16, width=64, layers=3,
                          heads=4, output_dim=32),
    "ViT-Test-Wide": ViTConfig(input_resolution=32, patch_size=16, width=256, layers=3,
                               heads=4, output_dim=32),
}


def init_clip_vision(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random init with CLIP-style scales (f32, CPU)."""
    w = cfg.width
    scale = w ** -0.5
    attn_std = (2 * w) ** -0.5

    def block() -> Params:
        return {
            "ln_1": layers.init_layer_norm(w),
            "attn": {
                "in_proj": layers.init_linear(gen, w, 3 * w, std=attn_std),
                "out_proj": layers.init_linear(gen, w, w, std=attn_std),
            },
            "ln_2": layers.init_layer_norm(w),
            "mlp": {
                "c_fc": layers.init_linear(gen, w, 4 * w, std=scale),
                "c_proj": layers.init_linear(gen, 4 * w, w, std=scale),
            },
        }

    return {
        "conv1": {"w": scale * torch.randn(w, 3, cfg.patch_size, cfg.patch_size, generator=gen)},
        "class_embedding": scale * torch.randn(w, generator=gen),
        "positional_embedding": scale * torch.randn(cfg.num_tokens, w, generator=gen),
        "ln_pre": layers.init_layer_norm(w),
        "blocks": [block() for _ in range(cfg.layers)],
    }


def embed_patches(params: Params, x: torch.Tensor, cfg: ViTConfig,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, 3, H, W) normalized frames -> ln_pre([CLS; patches] + pos), (N, T, W)."""
    x = F.conv2d(x.to(compute_dtype), params["conv1"]["w"].to(compute_dtype),
                 stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)                            # (N, grid^2, W)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].to(compute_dtype)
    return layers.layer_norm(params["ln_pre"], x)


def clip_vision_kv(
    params: Params, x: torch.Tensor, cfg: ViTConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    keep_layers: Optional[tuple] = None, kv_int8: bool = False, drop_cls: bool = False,
    compute_int8: bool = False, kv_int8_rows: bool = False, pad_tokens: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the frozen tower, exporting the kept layers' head-split K and V.

    Returns {"k", "v"}: (Lsel, N, T', H, D), T' = T - drop_cls, zero-padded
    up to a multiple of 8 rows with ``pad_tokens`` (196 -> 200 for CLIP-B)."""
    if kv_int8 or kv_int8_rows or compute_int8:
        raise NotImplementedError("int8 K/V and W8A8 compute are not ported yet")
    h = embed_patches(params, x, cfg, compute_dtype)
    n, t = h.shape[:2]
    w = cfg.width
    t_real = t - 1 if drop_cls else t
    kv_pad = (-t_real) % 8 if pad_tokens else 0
    keep = tuple(range(cfg.layers)) if keep_layers is None else tuple(keep_layers)
    last = max(keep)
    slot_of = {layer: s for s, layer in enumerate(keep)}
    nsel, t_out = len(keep), t_real + kv_pad
    kacc = torch.empty((nsel, n, t_out, w), dtype=h.dtype, device=h.device)
    vacc = torch.empty_like(kacc)
    for i in range(last + 1):
        bp = params["blocks"][i]
        into = (kacc, vacc, slot_of[i], nsel) if i in keep else None
        if i == last:
            fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads, cfg.head_dim,
                                     drop_cls=drop_cls, last_only=True, export_into=into,
                                     kv_pad=kv_pad)
            break
        if i in keep:
            h, _, _ = fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads,
                                               cfg.head_dim, export=True, drop_cls=drop_cls,
                                               export_into=into, kv_pad=kv_pad)
        else:
            h = fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads, cfg.head_dim)
        h = fused_encoder_mlp_block(h, bp["ln_2"], bp["mlp"])
    shape = (nsel, n, t_out, cfg.heads, cfg.head_dim)
    return {"k": kacc.view(shape), "v": vacc.view(shape)}
