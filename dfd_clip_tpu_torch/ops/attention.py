"""Encoder self-attention (counterpart of dfd_clip_tpu/ops/attention.py and of
``fused_encoder_attention`` / ``fused_encoder_attention_qkv`` in
dfd_clip_tpu/ops/pallas_attention.py).

The two kernel wrappers launch csrc/encoder_attention.cu on a CUDA tensor
(its separate and its packed entry, head_dim 64 and at most 320 tokens) and
take their plain versions, ``plain_attention`` and ``plain_attention_qkv``,
for a CPU tensor. The dispatchers ``encoder_self_attention`` and
``encoder_self_attention_qkv`` are the entries the towers call, named as in
the JAX module; the port has no backend switch, so each is its kernel
wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, T, H, D) x3 -> (N, T, H, D): f32 logits and softmax, the
    probabilities rounded to v's dtype, f32 accumulate, output in
    ``out_dtype`` (default v's dtype)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float() * scale, k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v.float())
    return out.to(out_dtype or v.dtype)


def plain_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Self-attention over packed (N, T, 3W) [q | k | v] -> (N, T, W)."""
    n, t, w3 = qkv.shape
    w = heads * head_dim
    if w3 != 3 * w:
        raise ValueError(f"qkv width {w3} != 3 x {heads} x {head_dim}")
    q, k, v = (s.reshape(n, t, heads, head_dim) for s in qkv.split(w, dim=-1))
    return plain_attention(q, k, v, out_dtype).reshape(n, t, w)


def fused_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel: (N, T, H, D) x3 bf16 -> (N, T, H, D). q, k and v may be the
    column blocks of one packed qkv buffer (read in place) or contiguous."""
    if _cuda.on_cpu("fused_encoder_attention", q):
        return plain_attention(q, k, v)
    out = _cuda.encoder_attention_separate(q, k, v)
    _cuda.LAUNCHES["fused_encoder_attention"] += 1
    return out.reshape(q.shape)


def fused_encoder_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """Kernel: packed (N, T, 3HD) bf16 [q | k | v] -> (N, T, HD)."""
    if _cuda.on_cpu("fused_encoder_attention_qkv", qkv):
        return plain_attention_qkv(qkv, heads, head_dim)
    n, t, w3 = qkv.shape
    if w3 != 3 * heads * head_dim:
        raise ValueError(f"qkv width {w3} != 3 x {heads} x {head_dim}")
    out = _cuda.encoder_attention_packed(qkv.reshape(n * t, w3), n, t, heads, head_dim)
    _cuda.LAUNCHES["fused_encoder_attention_qkv"] += 1
    return out.reshape(n, t, heads * head_dim)


def encoder_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over separate q, k, v (N, T, H, D) (DINOv2 blocks)."""
    return fused_encoder_attention(q, k, v)


def encoder_self_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """Self-attention over the packed qkv projection (N, T, 3HD) -> (N, T, HD)
    (the wide CLIP towers' composition)."""
    return fused_encoder_attention_qkv(qkv, heads, head_dim)
