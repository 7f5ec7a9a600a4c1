"""Plain encoder self-attention (counterpart of the XLA composition in
dfd_clip_tpu/ops/attention.py). Used only by the plain versions of the
encoder kernels; on the card the port runs csrc/encoder_attention.cu.
"""

from __future__ import annotations

from typing import Optional

import torch


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
