"""The encoder block's two halves (counterparts of ``fused_encoder_attn_block``
and ``fused_encoder_mlp_block`` in dfd_clip_tpu/ops/pallas_attention.py).

On a CUDA tensor each half is a short chain of this package's kernels:

  attention half: layer_norm_rows -> gemm (qkv, + K/V export)
                  -> encoder_attention -> gemm (out-proj, + residual)
  MLP half:       layer_norm_rows -> gemm (c_fc, + QuickGELU)
                  -> gemm (c_proj, + residual)

Unlike the TPU kernels, which keep the packed qkv stream and the (T, 4W) MLP
intermediate on chip, this first decomposition writes both to device memory
and reads them back (PERF.md counts the bytes); fusing them away is later
work. On a CPU tensor the plain versions below run instead; they keep the
kernels' rounding points (LayerNorm in f32, biases added in f32 before the
bf16 cast, QuickGELU in f32, the residual added in the activation dtype).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import layer_norm, linear_f32_bias
from . import _cuda
from .attention import plain_attention_qkv


def encoder_attention(qkv: torch.Tensor, frames: int, tokens: int, heads: int,
                      head_dim: int) -> torch.Tensor:
    """Kernel: self-attention over packed qkv rows (frames * tokens, 3W) ->
    (frames * tokens, W), bf16 on the card."""
    _cuda.require_cuda("encoder_attention", qkv)
    w = heads * head_dim
    if head_dim != 64 or tokens > 256 or qkv.shape != (frames * tokens, 3 * w) \
            or not qkv.is_contiguous():
        raise ValueError(f"encoder_attention: takes head_dim 64, <= 256 tokens and "
                         f"contiguous (frames*tokens, 3W); got {tuple(qkv.shape)}, "
                         f"head_dim {head_dim}")
    out = torch.empty((frames * tokens, w), dtype=qkv.dtype, device=qkv.device)
    err = _cuda.library().dfd_encoder_attention(
        qkv.data_ptr(), out.data_ptr(), frames, tokens, heads, head_dim ** -0.5,
        _cuda.stream())
    _cuda.check_launch("encoder_attention", err)
    _cuda.LAUNCHES["encoder_attention"] += 1
    return out


def _kv_slots(n: int, t_out: int, w: int, like: torch.Tensor, export_into):
    if export_into is not None:
        kacc, vacc, slot, _ = export_into
        return kacc[slot], vacc[slot]
    return (torch.empty((n, t_out, w), dtype=like.dtype, device=like.device),
            torch.empty((n, t_out, w), dtype=like.dtype, device=like.device))


def _kv_result(k, v, n, t_out, heads, head_dim, export_into):
    if export_into is not None:
        return export_into[0], export_into[1]   # (Lsel, N, T', W) buffers
    return k.reshape(n, t_out, heads, head_dim), v.reshape(n, t_out, heads, head_dim)


def fused_encoder_attn_block(
    h: torch.Tensor, ln: dict, attn: dict, heads: int, head_dim: int, *,
    export: bool = False, drop_cls: bool = False, last_only: bool = False,
    export_into: Optional[Tuple] = None, kv_pad: int = 0,
):
    """LN1 -> qkv -> attention -> out-proj -> +residual on h (N, T, W).

    Returns ``h_out``; ``(h_out, k, v)`` with ``export``; ``(k, v)`` with
    ``last_only`` (LN1 + the K/V columns of the qkv projection only). K/V are
    (N, T', H, D) with T' = T - drop_cls + kv_pad, the ``kv_pad`` rows zero;
    with ``export_into = (k_buf, v_buf, slot, n_slots)`` they are written into
    slot ``slot`` of the (n_slots, N, T', W) buffers, which are returned."""
    if _cuda.on_cpu("fused_encoder_attn_block", h):
        return fused_encoder_attn_block_plain(
            h, ln, attn, heads, head_dim, export=export, drop_cls=drop_cls,
            last_only=last_only, export_into=export_into, kv_pad=kv_pad)
    n, t, w = h.shape
    if w != heads * head_dim:
        raise ValueError("fused_encoder_attn_block: width != heads * head_dim")
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    dt = h.dtype
    w_qkv = attn["in_proj"]["w"].to(dt)
    b_qkv = attn["in_proj"]["b"].float()
    h2 = h.reshape(n * t, w)
    kv = None
    if export or last_only:
        k_slot, v_slot = _kv_slots(n, t_out, w, h, export_into)
        kv = (k_slot, v_slot, t, t_out, lo, w)
    y = _cuda.layer_norm_rows(h2, ln["scale"].float(), ln["bias"].float())
    if last_only:
        _cuda.gemm(y, w_qkv[:, w:], b_qkv[w:], store=False, export=kv, col_off=w)
        _cuda.LAUNCHES["fused_encoder_attn_block"] += 1
        return _kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into)
    qkv = _cuda.gemm(y, w_qkv, b_qkv, export=kv)
    att = encoder_attention(qkv, n, t, heads, head_dim)
    h_out = _cuda.gemm(att, attn["out_proj"]["w"].to(dt), attn["out_proj"]["b"].float(),
                       residual=h2).reshape(n, t, w)
    _cuda.LAUNCHES["fused_encoder_attn_block"] += 1
    if export:
        return (h_out, *_kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into))
    return h_out


def fused_encoder_attn_block_plain(
    h: torch.Tensor, ln: dict, attn: dict, heads: int, head_dim: int, *,
    export: bool = False, drop_cls: bool = False, last_only: bool = False,
    export_into: Optional[Tuple] = None, kv_pad: int = 0,
):
    """Plain version of fused_encoder_attn_block (same contract)."""
    n, t, w = h.shape
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    y = layer_norm(ln, h)
    qkv = linear_f32_bias(y, attn["in_proj"]["w"], attn["in_proj"]["b"])
    result = None
    if export or last_only:
        rows = qkv[:, lo:]
        k = F.pad(rows[..., w: 2 * w], (0, 0, 0, kv_pad))
        v = F.pad(rows[..., 2 * w:], (0, 0, 0, kv_pad))
        if export_into is not None:
            kacc, vacc, slot, _ = export_into
            kacc[slot].copy_(k)
            vacc[slot].copy_(v)
        result = _kv_result(k, v, n, t_out, heads, head_dim, export_into)
    if last_only:
        return result
    att = plain_attention_qkv(qkv, heads, head_dim)
    h_out = h + linear_f32_bias(att, attn["out_proj"]["w"], attn["out_proj"]["b"])
    return (h_out, *result) if export else h_out


def fused_encoder_mlp_block(h: torch.Tensor, ln: dict, mlp: dict) -> torch.Tensor:
    """LN2 -> c_fc -> QuickGELU (f32) -> c_proj -> +residual on h (N, T, W)."""
    if _cuda.on_cpu("fused_encoder_mlp_block", h):
        return fused_encoder_mlp_block_plain(h, ln, mlp)
    n, t, w = h.shape
    dt = h.dtype
    h2 = h.reshape(n * t, w)
    y = _cuda.layer_norm_rows(h2, ln["scale"].float(), ln["bias"].float())
    mid = _cuda.gemm(y, mlp["c_fc"]["w"].to(dt), mlp["c_fc"]["b"].float(), gelu=True)
    out = _cuda.gemm(mid, mlp["c_proj"]["w"].to(dt), mlp["c_proj"]["b"].float(),
                     residual=h2)
    _cuda.LAUNCHES["fused_encoder_mlp_block"] += 1
    return out.reshape(n, t, w)


def fused_encoder_mlp_block_plain(h: torch.Tensor, ln: dict, mlp: dict) -> torch.Tensor:
    """Plain version of fused_encoder_mlp_block."""
    y = layer_norm(ln, h)
    mid = y.float() @ mlp["c_fc"]["w"].to(h.dtype).float() + mlp["c_fc"]["b"].float()
    mid = (mid * torch.sigmoid(1.702 * mid)).to(h.dtype)
    return h + linear_f32_bias(mid, mlp["c_proj"]["w"], mlp["c_proj"]["b"])
