"""Trainable decoder attention (counterpart of
dfd_clip_tpu/ops/decoder_attention_vjp.py:fused_decoder_attention_trainable).

A ``torch.autograd.Function`` around the two decoder-attention kernels:

* forward: the fused kernel in its ``partials`` form
  (ops/fused_decoder_attention.py), then the small epilogue
  out = 0.5 (o_s / max(denom, 1e-30) + o_c) in the K/V dtype; the
  normalised softmax output o_s joins the saved tensors;
* backward: the backward kernel (ops/fused_decoder_attention_bwd.py), one
  launch, for dq_smax and dq_coda (written in the queries' dtype) and the
  temporal embedding's dpos (f32). dK/dV come from the
  plain einsums (``_bwd_math``), and only when K or V requires a gradient:
  never on the frozen-encoder path, where K/V come from under no_grad.

The temporal embedding arrives in its own dtype (the f32 parameter on the
training path) and is cast to the K/V dtype inside the Function, so dpos
goes back in f32 and accumulates into the f32 parameter.

On CPU tensors both directions take the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_decoder_attention import fused_decoder_attention
from .fused_decoder_attention_bwd import _bwd_math, fused_decoder_attention_bwd


def _scatter_slot(dk, dv, k, v, layer):
    """Place the selected-slot cotangents into full-shape buffers (stacked
    (Lsel, B, L, H, D) form when ``layer`` is set; identity otherwise).
    Autograd sums them across the decoder's per-block calls."""
    if layer is None:
        return dk, dv
    full_k, full_v = torch.zeros_like(k), torch.zeros_like(v)
    full_k[layer] = dk
    full_v[layer] = dv
    return full_k, full_v


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
        dqs, dqc, dpos = fused_decoder_attention_bwd(q_smax, q_coda, k, v, mask, pos, layer,
                                                     denom, mx, o_s, ct, q_smax.dtype)
        dk = dv = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            *_, dk, dv = _bwd_math(layer, q_smax, q_coda, k, v, mask, pos, denom, mx, ct)
            dk, dv = _scatter_slot(dk, dv, k, v, layer)
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
