"""Encoder self-attention (counterpart of dfd_clip_tpu/ops/attention.py and of
``fused_encoder_attention`` / ``fused_encoder_attention_qkv`` /
``_attn_int8_cols`` in dfd_clip_tpu/ops/pallas_attention.py).

The two kernel wrappers launch csrc/encoder_attention.cu on a CUDA tensor
(its separate and its packed entry, head_dim 64, one kernel at every token
count) and take their plain versions, ``plain_attention`` and
``plain_attention_qkv``, for a CPU tensor. Kernel and plain versions round
where the TPU kernels round (_exp_probs): the unnormalised exp is rounded
to bf16 before PV and the f32 output multiplied by 1 / sum after it, with
the row maximum subtracted first. The dispatchers ``encoder_self_attention`` and
``encoder_self_attention_qkv`` are the entries the towers call, named as in
the JAX module; the port has no backend switch, so each is its kernel
wrapper. ``encoder_attention_int8`` launches csrc/encoder_attention_s8.cu,
the int8 attention of the int8 whole block and tower (DFD_INT8_ATTN in the
JAX package; one TMA / int8 wgmma kernel at every token count),
with ``attn_int8_cols_plain`` as its plain version. Both plain versions go
in frame chunks of at most PLAIN_LOGITS_BYTES of f32 logits.

``trainable_encoder_attention`` is the separate entry under autograd (the
DINOv2 student's blocks, models/dinov2_vit.py:dinov2_forward): its forward
is ``fused_encoder_attention`` (the kernel on the card, ``plain_attention``
on the CPU), its backward ``encoder_attention_vjp``, the VJP of the JAX
package's ``_xla_attention`` (ops/attention.py:44-51) as torch products.
The JAX package has no backward kernel for this attention: its gradient is
XLA autodiff outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .int8 import _over, _quotient


# f32 logits a frame chunk of the plain versions may hold (the card's plain
# route at (320, 577, 16 heads) would otherwise hold 6.8 GB of them at once,
# and attn_int8_cols_plain twice that again in float64 integer sums)
PLAIN_LOGITS_BYTES = 2 ** 30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, T, H, D) x3 -> (N, T, H, D): f32 logits, p = exp(logits - row
    max) rounded to v's dtype unnormalised, f32 accumulate of p V, times
    1 / sum p (the f32 exps), output in ``out_dtype`` (default v's dtype).
    Frames go in chunks of at most PLAIN_LOGITS_BYTES of logits, which
    changes nothing computed."""
    n, t, h = q.shape[:3]
    step = max(1, PLAIN_LOGITS_BYTES // (4 * h * t * t))
    if n > step:
        return torch.cat([plain_attention(q[i: i + step], k[i: i + step], v[i: i + step],
                                          out_dtype) for i in range(0, n, step)])
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float() * scale, k.float())
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    rsum = (1.0 / p.sum(-1)).transpose(1, 2)[..., None]              # (N, T, H, 1)
    out = torch.einsum("nhqk,nkhd->nqhd", p.to(v.dtype).float(), v.float()) * rsum
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


def encoder_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          d_out: torch.Tensor) -> tuple:
    """(dq, dk, dv) of softmax(q k^T d^-1/2) v at the cotangent ``d_out``,
    all (N, T, H, D) in q's dtype: the f32 logits recomputed from q and k,
    P = softmax, dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(P dP)),
    dQ = dS K d^-1/2, dK = dS^T Q d^-1/2, with P and dP rounded to v's
    dtype where _xla_attention's VJP rounds them (its probabilities and
    their cotangent are in v's dtype). Frames go in chunks of at most
    PLAIN_LOGITS_BYTES of logits, which changes nothing computed."""
    n, t, h = q.shape[:3]
    step = max(1, PLAIN_LOGITS_BYTES // (4 * h * t * t))
    if n > step:
        parts = [encoder_attention_vjp(q[i: i + step], k[i: i + step], v[i: i + step],
                                       d_out[i: i + step]) for i in range(0, n, step)]
        return tuple(torch.cat(g) for g in zip(*parts))
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), d_out.float()
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q32 * scale, k32), dim=-1)
    dv = torch.einsum("nhqk,nqhd->nkhd", p.to(v.dtype).float(), do32)
    dp = torch.einsum("nqhd,nkhd->nhqk", do32, v32).to(v.dtype).float()
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k32) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _TrainableEncoderAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_encoder_attention(q, k, v)

    @staticmethod
    def backward(ctx, d_out):
        return encoder_attention_vjp(*ctx.saved_tensors, d_out)


def trainable_encoder_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """``fused_encoder_attention`` differentiable in q, k and v (N, T, H, D),
    which may be the column blocks of one packed qkv buffer: the kernel
    forward (a launch, counted under fused_encoder_attention) and the
    torch-product backward ``encoder_attention_vjp``."""
    return _TrainableEncoderAttention.apply(q, k, v)


def encoder_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over separate q, k, v (N, T, H, D) (DINOv2 blocks)."""
    return fused_encoder_attention(q, k, v)


def encoder_self_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """Self-attention over the packed qkv projection (N, T, 3HD) -> (N, T, HD)
    (the wide CLIP towers' composition)."""
    return fused_encoder_attention_qkv(qkv, heads, head_dim)


def _quant_rows_last(a: torch.Tensor, dim: int = -1):
    """_attn_int8_cols' qrows over ``dim``: s = max|a| + 1e-8, q =
    clip(round(a * (127 / s))), the quotient an IEEE division; q is left as
    exact integer values in f32."""
    s = a.abs().amax(dim, keepdim=True) + 1e-8
    return torch.clamp(torch.round(a * _quotient(127.0, s)), -127, 127), s


def attn_int8_cols_plain(qkv: torch.Tensor, frames: int, tokens: int, heads: int, head_dim: int,
                         qk_only: bool = False) -> torch.Tensor:
    """_attn_int8_cols over packed rows qkv (frames * tokens, 3W) -> f32
    (frames * tokens, W), with csrc/encoder_attention_s8.cu's softmax: the row
    maximum subtracted before the exp (the TPU kernel clamps the logits at 60
    instead). Q and K quantised per (row, head), the logits
    acc * (sq * d^-1/2 / 127^2) * sk; with ``qk_only`` PV = p rounded to
    qkv's dtype times V, times 1 / sum p; else P quantised per row and V per
    channel over the frame's tokens, PV = acc * (sp * (1 / sum p) / 127^2) *
    sv. The integer products are summed in float64, exact like the kernel's
    int32 sums. Frames go in chunks of at most PLAIN_LOGITS_BYTES of
    logits, which changes nothing computed."""
    step = max(1, PLAIN_LOGITS_BYTES // (4 * heads * tokens * tokens))
    if frames > step:
        return torch.cat([attn_int8_cols_plain(qkv[i * tokens: (i + step) * tokens],
                                               min(step, frames - i), tokens, heads, head_dim,
                                               qk_only) for i in range(0, frames, step)])
    w = heads * head_dim
    x = qkv.float().reshape(frames, tokens, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]                                # (N, H, T, D)
    qi, sq = _quant_rows_last(q)
    ki, sk = _quant_rows_last(k)
    acc = (qi.double() @ ki.double().transpose(-1, -2)).float()
    logits = acc * (sq * (head_dim ** -0.5 / (127.0 * 127.0))) * sk.transpose(-1, -2)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    rsum = _quotient(1.0, p.sum(-1, keepdim=True))
    if qk_only:
        out = (p.to(qkv.dtype).float() @ v) * rsum
    else:
        pi, sp = _quant_rows_last(p)
        vi, sv = _quant_rows_last(v, dim=-2)
        pv = (pi.double() @ vi.double()).float()
        out = pv * _over(sp * rsum, 127.0 * 127.0) * sv
    return out.permute(0, 2, 1, 3).reshape(frames * tokens, w)


def encoder_attention_int8(qkv: torch.Tensor, frames: int, tokens: int, heads: int,
                           head_dim: int, qk_only: bool = False) -> torch.Tensor:
    """Kernel: _attn_int8_cols over packed rows qkv (frames * tokens, 3W),
    bf16 on the card -> f32 (frames * tokens, W); ``qk_only`` is the "qk"
    mode (PV in bf16). One kernel at every token count
    (csrc/encoder_attention_s8.cu)."""
    if _cuda.on_cpu("encoder_attention_int8", qkv):
        return attn_int8_cols_plain(qkv, frames, tokens, heads, head_dim, qk_only)
    out = _cuda.encoder_attention_s8(qkv, frames, tokens, heads, head_dim, qk_only)
    _cuda.LAUNCHES["encoder_attention_int8"] += 1
    return out
