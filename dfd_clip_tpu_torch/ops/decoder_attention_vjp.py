"""Trainable decoder attention (counterpart of
dfd_clip_tpu/ops/decoder_attention_vjp.py:fused_decoder_attention_trainable).

A ``torch.autograd.Function`` around the two decoder-attention kernels:

* forward: the fused kernel in its ``partials`` form
  (ops/fused_decoder_attention.py), then the small epilogue
  out = 0.5 (o_s / max(denom, 1e-30) + o_c) in the K/V dtype; the
  normalised softmax output o_s joins the saved tensors;
* backward: the backward kernel (ops/fused_decoder_attention_bwd.py), one
  launch, for dq_smax and dq_coda (written in the queries' dtype), the
  temporal embedding's dpos (f32) and, when K or V requires a gradient (an
  adapter between the export and the decoder), dK and dV in K/V's dtype from
  the same launch. On the frozen-encoder path K/V come from under no_grad
  and the kernel writes no dK/dV. Unstacked K/V (``layer`` None: the
  adapter's per-layer tensors) get their own dK/dV; a stacked buffer read at
  ``layer`` gets the slot's cotangents placed in a zero stack, which
  autograd sums across the decoder's per-block calls.

The temporal embedding arrives in its own dtype (the f32 parameter on the
training path) and is cast to the K/V dtype inside the Function, so dpos
goes back in f32 and accumulates into the f32 parameter.

``spmd_decoder_attention_trainable`` (counterpart of JAX's, spmd form,
decoder_attention_vjp.py:216-253) is the same pair of kernels on a
multi-rank layout, each rank on its token shard: the forward is
ops/spmd.py's partials and exact combine, which saves the seq row's
combined denominator, maximum and normalised output; the backward runs the
backward kernel on the rank's tokens with those combined statistics. What
JAX's GSPMD sums for itself is summed here by hand: dq_smax, dq_coda and
dpos are sums over tokens, so the backward packs them (dq in f32, dpos
placed at the rank's rows of the whole embedding) into one buffer and
all-reduces it (SUM) over the seq row. Every rank of a row then holds the
row's whole gradient of the queries and the embedding, and a mean of the
leaves' gradients over the world is the global batch's. dK/dV stay the
rank's own tokens'.

On CPU tensors both directions take the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import spmd
from .fused_decoder_attention import fused_decoder_attention
from .fused_decoder_attention_bwd import fused_decoder_attention_bwd


class _TrainableAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_smax, q_coda, k, v, mask, temporal_pos, layer):
        b, _, h, d = q_smax.shape
        cd = k.dtype
        pos = None if temporal_pos is None else temporal_pos.to(cd).contiguous()
        o_sc, st = fused_decoder_attention(q_smax, q_coda, k, v, mask, pos, layer,
                                           partials=True)
        denom, mx = st[:, 0], st[:, 1]                              # (B, H) f32
        o_s = o_sc[:, 0].reshape(b, h, d) / denom.clamp_min(1e-30)[..., None]
        o_c = o_sc[:, 1].reshape(b, h, d)
        ctx.save_for_backward(q_smax, q_coda, k, v, mask, pos, denom, mx, o_s)
        ctx.layer = layer
        ctx.pos_dtype = None if temporal_pos is None else temporal_pos.dtype
        return (0.5 * (o_s + o_c)).to(cd)[:, None]                  # (B, 1, H, D)

    @staticmethod
    def backward(ctx, ct):
        q_smax, q_coda, k, v, mask, pos, denom, mx, o_s = ctx.saved_tensors
        layer = ctx.layer
        live = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dqs, dqc, dpos, *dkv = fused_decoder_attention_bwd(
            q_smax, q_coda, k, v, mask, pos, layer, denom, mx, o_s, ct, q_smax.dtype,
            with_kv=live)
        dk = dv = None
        if live:
            dk, dv = dkv
            if layer is not None:   # the slot's cotangents in a zero stack
                full_k, full_v = torch.zeros_like(k), torch.zeros_like(v)
                full_k[layer], full_v[layer] = dk, dv
                dk, dv = full_k, full_v
        if dpos is not None:
            dpos = dpos.to(ctx.pos_dtype)
        return dqs, dqc, dk, dv, None, dpos, None


def fused_decoder_attention_trainable(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor] = None,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """((B,1,H,D) x2, K, V, (B,L) mask, (L,H,D) pos or None, layer) ->
    (B,1,H,D), differentiable in the queries, pos and K/V. K/V are
    (B, L, H, D), or the stacked (Lsel, B, L, H, D) export read at
    ``layer``. Semantics of dual_activation_attention with a single query."""
    return _TrainableAttention.apply(q_smax, q_coda, k, v, mask, temporal_pos, layer)


class _ShardedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_smax, q_coda, k, v, mask, temporal_pos, layer, layout):
        cd = k.dtype
        pos = None if temporal_pos is None else temporal_pos.to(cd).contiguous()
        out, den, gmax, o_s = spmd.spmd_decoder_attention(q_smax, q_coda, k, v, mask, pos,
                                                          layer, layout, return_stats=True)
        l_loc = (k[layer] if layer is not None else k).shape[1]
        pos_loc = spmd.local_pos(pos, l_loc, layout)
        ctx.save_for_backward(q_smax, q_coda, k, v, mask, pos_loc, den, gmax, o_s)
        ctx.layer, ctx.layout = layer, layout
        ctx.pos_shape = None if temporal_pos is None else temporal_pos.shape
        ctx.pos_dtype = None if temporal_pos is None else temporal_pos.dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        q_smax, q_coda, k, v, mask, pos_loc, den, gmax, o_s = ctx.saved_tensors
        layer, layout = ctx.layer, ctx.layout
        live = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dqs, dqc, dpos_loc, *dkv = fused_decoder_attention_bwd(
            q_smax, q_coda, k, v, mask, pos_loc, layer, den, gmax, o_s, ct, torch.float32,
            with_kv=live, shard=True)
        b = q_smax.shape[0]
        parts = [dqs.reshape(b, -1), dqc.reshape(b, -1)]
        if dpos_loc is not None:   # the rank's rows of the whole embedding's gradient
            dpos = dpos_loc.new_zeros(ctx.pos_shape)
            l_loc = dpos_loc.shape[0]
            dpos[layout.seq_index * l_loc:(layout.seq_index + 1) * l_loc] = dpos_loc
            parts.append(dpos.reshape(-1))
        packed = torch.cat([p.reshape(-1) for p in parts])
        layout.all_reduce_(packed, "sum", "seq")
        n = dqs.numel()
        dqs = packed[:n].reshape(q_smax.shape).to(q_smax.dtype)
        dqc = packed[n:2 * n].reshape(q_coda.shape).to(q_coda.dtype)
        dpos = None
        if dpos_loc is not None:
            dpos = packed[2 * n:].reshape(ctx.pos_shape).to(ctx.pos_dtype)
        dk = dv = None
        if live:
            dk, dv = dkv
            if layer is not None:   # the slot's cotangents in a zero stack
                full_k, full_v = torch.zeros_like(k), torch.zeros_like(v)
                full_k[layer], full_v[layer] = dk, dv
                dk, dv = full_k, full_v
        return dqs, dqc, dk, dv, None, dpos, None, None


def spmd_decoder_attention_trainable(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor], layer: Optional[int], layout,
) -> torch.Tensor:
    """The trainable attention on this rank's token shard (module note):
    (B,1,H,D) queries, the rank's K/V (B, l, H, D) or stacked (Lsel, B, l,
    H, D) at ``layer``, its (B, l) mask, the WHOLE (l * seq, H, D) temporal
    embedding or None -> the (B,1,H,D) output, equal on every rank of the
    seq row, differentiable in the queries, the embedding and K/V."""
    return _ShardedAttention.apply(q_smax, q_coda, k, v, mask, temporal_pos, layer, layout)
