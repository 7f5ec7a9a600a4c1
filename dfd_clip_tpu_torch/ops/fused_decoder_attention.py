"""Fused single-query decoder attention (counterpart of
dfd_clip_tpu/ops/pallas_decoder_attention.py:fused_decoder_attention,
forward, without ``partials`` or int8 K/V scales).

On a CUDA tensor this launches csrc/decoder_attention.cu: one pass over slot
``layer`` of the stacked K/V export, the temporal positional embedding added
to K and V in-kernel, exact online softmax plus CoDA, fully masked rows 0.
On a CPU tensor it runs the plain version in ops/decoder_attention.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .decoder_attention import dual_activation_attention


def fused_decoder_attention(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor] = None,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """(B,1,H,D) x2, (B,L,H,D) x2 or stacked (Lsel,B,L,H,D) x2 with ``layer``,
    (B,L) bool mask, optional (L,H,D) temporal_pos -> (B,1,H,D)."""
    if _cuda.on_cpu("fused_decoder_attention", k):
        return fused_decoder_attention_plain(q_smax, q_coda, k, v, mask, temporal_pos, layer)
    kl, vl = (k[layer], v[layer]) if layer is not None else (k, v)
    b, q, h, d = q_smax.shape
    l = kl.shape[1]
    if q != 1 or d != 64 or kl.shape != (b, l, h, d) or vl.shape != kl.shape:
        raise ValueError(f"fused_decoder_attention: takes one query, head_dim 64 and "
                         f"matching K/V; got q {tuple(q_smax.shape)}, k {tuple(kl.shape)}")
    if not (kl.is_contiguous() and vl.is_contiguous()):
        raise ValueError("fused_decoder_attention: K/V must be contiguous")
    if q_coda.shape != q_smax.shape or q_coda.stride() != q_smax.stride() \
            or q_smax.stride()[2:] != (d, 1):
        raise ValueError("fused_decoder_attention: queries need contiguous (H, D) rows "
                         "and one shared sample stride")
    if mask.shape != (b, l) or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("fused_decoder_attention: mask must be contiguous bool (B, L)")
    _cuda.require_cuda("fused_decoder_attention", kl, vl)
    for t in (q_smax, q_coda):
        if t.device.type != "cuda" or t.dtype != kl.dtype:
            raise ValueError("fused_decoder_attention: queries must be bf16 on the card")
    if temporal_pos is not None:
        _cuda.require_cuda("fused_decoder_attention", temporal_pos)
        if temporal_pos.shape != (l, h, d) or not temporal_pos.is_contiguous():
            raise ValueError("fused_decoder_attention: temporal_pos must be contiguous (L, H, D)")
    out = torch.empty((b, 1, h, d), dtype=kl.dtype, device=kl.device)
    err = _cuda.library().dfd_decoder_attention(
        q_smax.data_ptr(), q_coda.data_ptr(), q_smax.stride(0), kl.data_ptr(),
        vl.data_ptr(), mask.data_ptr(),
        temporal_pos.data_ptr() if temporal_pos is not None else None,
        out.data_ptr(), b, l, h, d ** -0.5, _cuda.stream())
    _cuda.check_launch("fused_decoder_attention", err)
    _cuda.LAUNCHES["fused_decoder_attention"] += 1
    return out


def fused_decoder_attention_plain(q_smax, q_coda, k, v, mask, temporal_pos=None,
                                  layer=None) -> torch.Tensor:
    """Plain version: the f32 composition of ops/decoder_attention.py."""
    return dual_activation_attention(q_smax, q_coda, k, v, mask,
                                     temporal_pos=temporal_pos, layer=layer)
