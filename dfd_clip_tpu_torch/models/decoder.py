"""Temporal cross-attention decoder (counterpart of
dfd_clip_tpu/models/decoder.py).

A learned CLS query cross-attends each kept encoder layer's K/V stream.
Inference is the JAX package's per-device path: a chain of block boundaries
(ops/decoder_stack.py) around one fused attention call per block
(ops/fused_decoder_attention.py), which reads its slot of the stacked export
in place. Training (``train=True``) is the JAX package's training
composition: LayerNorms, linears, QuickGELU and dropout in plain torch under
autograd, and the attention through the trainable Function of
ops/decoder_attention_vjp.py (partials forward and backward kernels). The
8-row pad of the export is masked as keys through ``patch_valid``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers
from ..ops.decoder_attention import dual_activation_attention
from ..ops.decoder_stack import decoder_boundary
from ..ops.fused_decoder_attention import fused_decoder_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    width: int
    heads: int
    num_frames: int
    layer_indices: Tuple[int, ...]
    out_dims: Tuple[int, ...]
    dropout: float = 0.0
    temporal_position: bool = True
    attn_mode: Tuple[str, ...] = ()
    aug_query: bool = False
    global_prediction: bool = False
    concat_ref: bool = False

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def num_blocks(self) -> int:
        return len(self.layer_indices)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def init_decoder(gen: torch.Generator, cfg: DecoderConfig,
                 encoder_blocks: Optional[List[Params]] = None) -> Params:
    """Random decoder params; with ``encoder_blocks`` (the tower's per-layer
    list) block i copies ln_1, ln_2 and the MLP of encoder layer
    ``layer_indices[i]`` (with ``concat_ref`` the MLP of the layer before the
    next kept one)."""
    n, w = cfg.num_blocks, cfg.width
    scale = w ** -0.5
    blocks = []
    for i in range(n):
        blk = {
            "ln_1": layers.init_layer_norm(w),
            "attn": {"in_proj": layers.init_linear(gen, w, 2 * w),
                     "out_proj": layers.init_linear(gen, w, w)},
            "ln_2": layers.init_layer_norm(w),
            "mlp": {"c_fc": layers.init_linear(gen, w, 4 * w),
                    "c_proj": layers.init_linear(gen, 4 * w, w)},
        }
        if encoder_blocks is not None:
            ref = encoder_blocks[cfg.layer_indices[i]]
            blk["ln_1"], blk["ln_2"] = _clone(ref["ln_1"]), _clone(ref["ln_2"])
            mlp_ref = (encoder_blocks[cfg.layer_indices[i + 1] - 1]["mlp"]
                       if cfg.concat_ref and i < n - 1 else ref["mlp"])
            blk["mlp"] = _clone(mlp_ref)
        blocks.append(blk)
    params: Params = {
        "class_embedding": scale * torch.randn(w, generator=gen),
        "ln_pre": layers.init_layer_norm(w),
        "ln_post": layers.init_layer_norm(w),
        "blocks": blocks,
    }
    if cfg.temporal_position:
        params["positional_embedding"] = scale * torch.randn(
            cfg.num_frames, 1, cfg.heads, cfg.head_dim, generator=gen)
    n_mats = n if cfg.global_prediction else 1
    params["task_projections"] = [
        [scale * torch.randn(w, out_dim, generator=gen) for _ in range(n_mats)]
        for out_dim in cfg.out_dims
    ]
    return params


def token_mask(m: torch.Tensor, patches: int, patch_valid: Optional[int]) -> torch.Tensor:
    """(B, T) frame mask -> (B, T * P) key mask; patches >= patch_valid (the
    export's zero pad rows) are masked."""
    b, t = m.shape
    if patch_valid is not None and patch_valid < patches:
        pv = torch.arange(patches, device=m.device) < patch_valid
        return (m[:, :, None] & pv[None, None, :]).reshape(b, t * patches)
    return m.repeat_interleave(patches, dim=-1)


def apply_decoder(params: Params, kvs: Dict[str, torch.Tensor], m: torch.Tensor,
                  cfg: DecoderConfig, *, train: bool = False,
                  gen: Optional[torch.Generator] = None, patch_valid: Optional[int] = None
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Decode K/V {"k", "v"}: (Lsel, B, T, P, H, D) with the (B, T) bool frame
    mask into (task logits [(B, out_dim)], video feature). ``train`` runs the
    differentiable composition, with dropout drawn from ``gen``."""
    if cfg.attn_mode or cfg.aug_query:
        raise NotImplementedError("attn_mode and aug_query are not ported yet")
    k_all, v_all = kvs["k"], kvs["v"]
    nsel, b, t, p, h, d = k_all.shape
    if nsel != cfg.num_blocks:
        raise ValueError(f"{nsel} K/V slots for {cfg.num_blocks} decoder blocks")
    cd = k_all.dtype
    pos_tok = None
    if cfg.temporal_position:
        pos = params["positional_embedding"][:t]                  # (T, 1, H, D)
        pos_tok = pos.expand(t, p, h, d).reshape(t * p, h, d)
        if not train:   # training casts inside the Function: dpos stays f32
            pos_tok = pos_tok.to(cd).contiguous()
    k_all = k_all.reshape(nsel, b, t * p, h, d)
    v_all = v_all.reshape(nsel, b, t * p, h, d)
    mask = token_mask(m, p, patch_valid)

    x = layers.layer_norm(params["ln_pre"],
                          params["class_embedding"].to(cd).expand(b, cfg.width).contiguous())
    blocks = params["blocks"]
    results = []
    if train:
        x = layers.dropout(x, cfg.dropout, gen, train)
        for i, blk in enumerate(blocks):
            qrow = layers.linear(blk["attn"]["in_proj"], layers.layer_norm(blk["ln_1"], x))
            attn_out = dual_activation_attention(
                qrow[:, : cfg.width].reshape(b, 1, h, d), qrow[:, cfg.width:].reshape(b, 1, h, d),
                k_all, v_all, mask, temporal_pos=pos_tok, layer=i, differentiable=True)
            x = x + layers.linear(blk["attn"]["out_proj"], attn_out.reshape(b, cfg.width))
            y = layers.linear(blk["mlp"]["c_fc"], layers.layer_norm(blk["ln_2"], x))
            y = layers.dropout(layers.quick_gelu(y), cfg.dropout, gen, train)
            x = x + layers.linear(blk["mlp"]["c_proj"], y)
            results.append(x)
    else:
        def query(blk):
            return {"ln_1": blk["ln_1"], "in_proj": blk["attn"]["in_proj"]}

        _, qrow = decoder_boundary(x, None, None, query(blocks[0]))
        for i, blk in enumerate(blocks):
            q_smax = qrow[:, : cfg.width].reshape(b, 1, h, d)
            q_coda = qrow[:, cfg.width:].reshape(b, 1, h, d)
            attn_out = fused_decoder_attention(q_smax, q_coda, k_all, v_all, mask,
                                               pos_tok, layer=i)
            tail = {"attn_out_proj": blk["attn"]["out_proj"], "ln_2": blk["ln_2"],
                    "mlp": blk["mlp"]}
            nxt = query(blocks[i + 1]) if i + 1 < len(blocks) else None
            x, qrow = decoder_boundary(x, attn_out.reshape(b, cfg.width), tail, nxt)
            results.append(x)

    feats = torch.stack(results, dim=1)                           # (B, blocks, W)
    if not cfg.global_prediction:
        feats = feats[:, -1]
    feats = layers.layer_norm(params["ln_post"], feats)
    video_feature = layers.dropout(feats, cfg.dropout, gen, train).float()

    task_logits = []
    for mats in params["task_projections"]:
        if cfg.global_prediction:
            n = cfg.num_blocks
            denom = (1 + n) * n / 2.0      # depth-weighted average of the blocks
            task_logits.append(sum((video_feature[:, i] @ mats[i].float()) * ((i + 1) / denom)
                                   for i in range(n)))
        else:
            task_logits.append(video_feature @ mats[-1].float())
    return task_logits, video_feature
