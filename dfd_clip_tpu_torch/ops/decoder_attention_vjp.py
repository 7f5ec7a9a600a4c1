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

On CPU tensors both directions take the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

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
