"""Fused single-query decoder attention (counterpart of
dfd_clip_tpu/ops/pallas_decoder_attention.py:fused_decoder_attention,
forward, with and without ``partials``, and with int8_rows K/V and their
``k_scale``/``v_scale`` in both forms: the partials of int8_rows K/V feed
the token-sharded attention of ops/spmd.py).

On a CUDA tensor this launches csrc/decoder_attention.cu: one pass over slot
``layer`` of the stacked K/V export (and of the stacked scales), split over
chunks of L (``_cuda.decoder_split``), the temporal positional embedding
added to K and V in-kernel, exact softmax plus CoDA a chunk, then the
chunks' softmax states merged in chunk order (a second launch; its plain
version is ``merge_decoder_partials_plain``), fully masked rows 0. On a CPU
tensor it runs the plain versions in ops/decoder_attention.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .decoder_attention import decoder_attention_partials_plain, dual_activation_attention


def check_inputs(name: str, q_smax, q_coda, k, v, mask, temporal_pos, layer,
                 k_scale=None, v_scale=None):
    """Raise unless the arguments are what the decoder-attention kernels
    take on the card; returns (slot K, slot V, B, L, H, D), and with int8
    K/V also the slot's (B, L, 1) scales."""
    kl, vl = (k[layer], v[layer]) if layer is not None else (k, v)
    b, q, h, d = q_smax.shape
    l = kl.shape[1]
    if q != 1 or d != 64 or kl.shape != (b, l, h, d) or vl.shape != kl.shape:
        raise ValueError(f"{name}: takes one query, head_dim 64 and "
                         f"matching K/V; got q {tuple(q_smax.shape)}, k {tuple(kl.shape)}")
    if not (kl.is_contiguous() and vl.is_contiguous()):
        raise ValueError(f"{name}: K/V must be contiguous")
    if q_coda.shape != q_smax.shape or q_coda.stride() != q_smax.stride() \
            or q_smax.stride()[2:] != (d, 1):
        raise ValueError(f"{name}: queries need contiguous (H, D) rows "
                         "and one shared sample stride")
    if mask.shape != (b, l) or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be contiguous bool (B, L)")
    _cuda.require_cuda(name, kl, vl, dtype=torch.bfloat16 if k_scale is None else torch.int8)
    # a lane reads 8 dims of a query as one 16-byte word
    if q_smax.data_ptr() % 16 or q_coda.data_ptr() % 16 or (q_smax.stride(0) * 2) % 16:
        raise ValueError(f"{name}: queries need 16-byte aligned starts and sample stride")
    for t in (q_smax, q_coda, mask):
        if t.device != kl.device:
            raise ValueError(f"{name}: queries and mask must be on K/V's card")
    for t in (q_smax, q_coda):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: queries must be bf16")
    if temporal_pos is not None:
        _cuda.require_cuda(name, temporal_pos)
        if temporal_pos.shape != (l, h, d) or not temporal_pos.is_contiguous():
            raise ValueError(f"{name}: temporal_pos must be contiguous (L, H, D)")
    if k_scale is None:
        return kl, vl, b, l, h, d
    ksl, vsl = (k_scale[layer], v_scale[layer]) if layer is not None else (k_scale, v_scale)
    for t in (ksl, vsl):   # read one f32 a token: no alignment beyond the element's
        if t.device != kl.device or t.dtype != torch.float32 or t.shape != (b, l, 1) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: K/V scales must be contiguous f32 (B, L, 1) on K/V's "
                             f"card, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return kl, vl, b, l, h, d, ksl, vsl


def fused_decoder_attention(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor] = None,
    layer: Optional[int] = None, partials: bool = False,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
):
    """(B,1,H,D) x2, (B,L,H,D) x2 or stacked (Lsel,B,L,H,D) x2 with ``layer``,
    (B,L) bool mask, optional (L,H,D) temporal_pos -> (B,1,H,D).

    ``partials``: return the softmax state instead, ``(o_sc, st)`` with o_sc
    (B, 2, H*D) f32 [un-normalised numerator, CoDA output] and st (B, 2, H)
    f32 [denominator, maximum] (see decoder_attention_partials_plain).
    ``k_scale``/``v_scale``: int8_rows K/V with (B, L, 1) f32 scales (stacked
    (Lsel, B, L, 1), read at ``layer``); the normalised output is bf16 like
    the queries."""
    if _cuda.on_cpu("fused_decoder_attention", k):
        return fused_decoder_attention_plain(q_smax, q_coda, k, v, mask, temporal_pos, layer,
                                             partials=partials, k_scale=k_scale,
                                             v_scale=v_scale)
    kl, vl, b, l, h, d, *scales = check_inputs("fused_decoder_attention", q_smax, q_coda, k,
                                               v, mask, temporal_pos, layer, k_scale, v_scale)
    pos = temporal_pos.data_ptr() if temporal_pos is not None else None
    chunks = _cuda.decoder_split(l, h)["chunks"]
    ws = torch.empty((b, h, chunks, _cuda.DECODER_WS), dtype=torch.float32, device=kl.device)
    out = o_sc = st = None
    if partials:
        o_sc = torch.empty((b, 2, h * d), dtype=torch.float32, device=kl.device)
        st = torch.empty((b, 2, h), dtype=torch.float32, device=kl.device)
        result = (o_sc, st)
    else:
        out = result = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=kl.device)
    ks, vs = (s.data_ptr() for s in scales) if scales else (None, None)
    err = _cuda.library().dfd_decoder_attention(
        q_smax.data_ptr(), q_coda.data_ptr(), q_smax.stride(0), kl.data_ptr(), vl.data_ptr(),
        ks, vs, mask.data_ptr(), pos, ws.data_ptr(), chunks,
        *(t.data_ptr() if t is not None else None for t in (out, o_sc, st)), b, l, h,
        d ** -0.5, _cuda.stream())
    _cuda.check_launch("fused_decoder_attention", err)
    # the int8 K/V form is its own kernel (csrc/decoder_attention.cu, KV = int8_t)
    _cuda.LAUNCHES["fused_decoder_attention_int8" if scales else "fused_decoder_attention"] += 1
    return result


def fused_decoder_attention_plain(q_smax, q_coda, k, v, mask, temporal_pos=None,
                                  layer=None, partials: bool = False, k_scale=None,
                                  v_scale=None):
    """Plain version: the f32 compositions of ops/decoder_attention.py."""
    if partials:
        return decoder_attention_partials_plain(q_smax, q_coda, k, v, mask, temporal_pos, layer,
                                                k_scale, v_scale)
    return dual_activation_attention(q_smax, q_coda, k, v, mask, temporal_pos=temporal_pos,
                                     layer=layer, k_scale=k_scale, v_scale=v_scale)
