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
8-row pad of the export is masked as keys through ``patch_valid``. With
int8_rows K/V ({"k_scale", "v_scale"} in the export) the decoder computes in
bf16; the inference kernel dequantises each token's row, training each slot
to bf16 first.

The op_mode options take the routes JAX's apply_decoder takes
(decoder.py:221-229): with ``aug_query`` (a learned (blocks - 1, W) offset
added to the residual stream after each block but the last) or a
factorised ``attn_mode``, inference leaves the boundary kernel for the
composition of the block interstitial; ``aug_query`` alone keeps the fused
attention kernel, ``attn_mode`` runs the attention's torch composition
(ops/decoder_attention.py) in inference and training.

On a multi-rank layout whose ranks hold a seq share of each clip's frames
(``seq_layout``, ops/spmd.py) each block's attention is the token-sharded
one: the rank's partials combined exactly over its seq row in inference,
the sharded trainable Function in training, the temporal embedding handed
over whole (the row's T x P tokens). Everything after the attention sees
the combined output, equal on every rank of the row. Dropout draws its
masks for the global batch and keeps the rank's rows (``spmd.data_rows``),
so the ranks of a data column draw from one stream as one process does.

K/V come as the stacked export (Lsel, B, T, P, H, D), whose slot i block i
reads in place (``layer=i``), or, after an adapter, as lists of per-layer
(B, T, P, H, D) tensors, each block reading its own (``layer`` None): with
live K/V each attention call's backward then hands back that layer's own
dK/dV.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers
from ..ops.decoder_attention import dual_activation_attention
# the module, not its function: ops.decoder_stack imports models.layers, so a
# process that imports it first meets this module half-built
from ..ops import decoder_stack, spmd
from ..ops.decoder_attention_vjp import spmd_decoder_attention_trainable
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
            # a SwiGLU tower (DINOv2 giant2) has no c_fc / c_proj to seed the
            # decoder's MLP with: it keeps its random init (decoder.py:105-110)
            if "c_fc" in mlp_ref:
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
    if cfg.aug_query:
        params["aug_query"] = torch.zeros(n - 1, w)
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
                  gen: Optional[torch.Generator] = None, patch_valid: Optional[int] = None,
                  seq_layout=None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Decode K/V {"k", "v"}: (Lsel, B, T, P, H, D), or lists of Lsel
    per-layer (B, T, P, H, D) tensors, with the (B, T) bool frame mask into
    (task logits [(B, out_dim)], video feature). ``train`` runs the
    differentiable composition, with dropout drawn from ``gen``. int8 K/V
    come stacked, with {"k_scale", "v_scale"}: (Lsel, B, T, P, 1) f32.
    ``seq_layout``: the multi-rank layout when K/V and ``m`` hold this rank's
    seq share of the frames (module note), else None."""
    k_all, v_all = kvs["k"], kvs["v"]
    ks_all, vs_all = kvs.get("k_scale"), kvs.get("v_scale")
    per_layer = isinstance(k_all, (list, tuple))
    nsel = len(k_all)
    b, t, p, h, d = k_all[0].shape
    if nsel != cfg.num_blocks:
        raise ValueError(f"{nsel} K/V slots for {cfg.num_blocks} decoder blocks")
    if per_layer and ks_all is not None:
        raise ValueError("int8_rows K/V come as the stacked export")
    # int8 K/V: queries, residual stream and output in bf16 (the JAX rule)
    cd = torch.bfloat16 if k_all[0].dtype == torch.int8 else k_all[0].dtype
    pos_tok = None
    if cfg.temporal_position:
        tw = t * seq_layout.seq_parallel if seq_layout is not None else t   # the row's frames
        pos = params["positional_embedding"][:tw]                 # (T, 1, H, D)
        pos_tok = pos.expand(tw, p, h, d).reshape(tw * p, h, d)
        if not train:   # training casts inside the Function: dpos stays f32
            pos_tok = pos_tok.to(cd).contiguous()
    if per_layer:   # block i reads its own tensor
        k_all = [f.reshape(b, t * p, h, d) for f in k_all]
        v_all = [f.reshape(b, t * p, h, d) for f in v_all]
    else:
        k_all = k_all.reshape(nsel, b, t * p, h, d)
        v_all = v_all.reshape(nsel, b, t * p, h, d)

    def slot(i):
        """Block i's K/V and the ``layer`` its attention reads them at."""
        return (k_all[i], v_all[i], None) if per_layer else (k_all, v_all, i)
    if ks_all is not None:
        ks_all = ks_all.reshape(nsel, b, t * p, 1)
        vs_all = vs_all.reshape(nsel, b, t * p, 1)
    mask = token_mask(m, p, patch_valid)
    rows = spmd.data_rows(b) if train else None

    def drop(y):
        return layers.dropout(y, cfg.dropout, gen, train, rows)

    def fused(q_smax, q_coda, k_i, v_i, layer):
        """The fused single-query attention, token-sharded on a layout."""
        if seq_layout is None:
            return fused_decoder_attention(q_smax, q_coda, k_i, v_i, mask, pos_tok, layer=layer,
                                           k_scale=ks_all, v_scale=vs_all)
        return spmd.spmd_decoder_attention(q_smax, q_coda, k_i, v_i, mask, pos_tok, layer,
                                           seq_layout, k_scale=ks_all, v_scale=vs_all)

    x = layers.layer_norm(params["ln_pre"],
                          params["class_embedding"].to(cd).expand(b, cfg.width).contiguous())
    blocks = params["blocks"]
    results = []
    if train or cfg.attn_mode or cfg.aug_query:
        x = drop(x)
        for i, blk in enumerate(blocks):
            qrow = layers.linear(blk["attn"]["in_proj"], layers.layer_norm(blk["ln_1"], x))
            q_smax = qrow[:, : cfg.width].reshape(b, 1, h, d)
            q_coda = qrow[:, cfg.width:].reshape(b, 1, h, d)
            k_i, v_i, layer = slot(i)
            if train and seq_layout is not None:
                attn_out = spmd_decoder_attention_trainable(q_smax, q_coda, k_i, v_i, mask,
                                                            pos_tok, layer, seq_layout)
            elif train or cfg.attn_mode:
                attn_out = dual_activation_attention(
                    q_smax, q_coda, k_i, v_i, mask, num_frames=t, attn_mode=cfg.attn_mode,
                    temporal_pos=pos_tok, layer=layer, differentiable=train,
                    k_scale=ks_all, v_scale=vs_all)
            else:   # aug_query's inference: the fused kernel, single query
                attn_out = fused(q_smax, q_coda, k_i, v_i, layer)
            x = x + layers.linear(blk["attn"]["out_proj"], attn_out.reshape(b, cfg.width))
            y = layers.linear(blk["mlp"]["c_fc"], layers.layer_norm(blk["ln_2"], x))
            y = drop(layers.quick_gelu(y))
            x = x + layers.linear(blk["mlp"]["c_proj"], y)
            results.append(x)
            if cfg.aug_query and i < cfg.num_blocks - 1:
                x = x + params["aug_query"][i].to(x.dtype)
    else:
        def query(blk):
            return {"ln_1": blk["ln_1"], "in_proj": blk["attn"]["in_proj"]}

        _, qrow = decoder_stack.decoder_boundary(x, None, None, query(blocks[0]))
        for i, blk in enumerate(blocks):
            q_smax = qrow[:, : cfg.width].reshape(b, 1, h, d)
            q_coda = qrow[:, cfg.width:].reshape(b, 1, h, d)
            k_i, v_i, layer = slot(i)
            attn_out = fused(q_smax, q_coda, k_i, v_i, layer)
            tail = {"attn_out_proj": blk["attn"]["out_proj"], "ln_2": blk["ln_2"],
                    "mlp": blk["mlp"]}
            nxt = query(blocks[i + 1]) if i + 1 < len(blocks) else None
            x, qrow = decoder_stack.decoder_boundary(x, attn_out.reshape(b, cfg.width),
                                                     tail, nxt)
            results.append(x)

    feats = torch.stack(results, dim=1)                           # (B, blocks, W)
    if not cfg.global_prediction:
        feats = feats[:, -1]
    feats = layers.layer_norm(params["ln_post"], feats)
    video_feature = drop(feats).float()

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
