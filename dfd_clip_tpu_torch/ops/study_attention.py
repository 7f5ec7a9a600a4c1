"""The attention study kernels (counterpart of the Pallas variants of
tools/bench_attention.py: ``_frames_grid_call`` over its four kernel bodies,
``pair_packed`` and ``full_packed``).

``study_attention(q, k, v, mode)`` launches csrc/study_attention.cu on CUDA
tensors and takes ``study_attention_plain`` for CPU tensors. Both compute
softmax(q k^T d^-1/2) v per (frame, head) on bf16 (N, T, H, 64) -> (N, T, H,
64) bf16, in one of four numerics modes that keep their originals' rounding
points:

* ``"f32"``: make_multiframe_kernel (and its ``t_pad=256`` form
  ``pallas_pad256``, whose pad keys are masked), make_batched_dot_kernel and
  pair_packed. Q, K and V in f32, q scaled before the dot, the softmax
  normalised in f32 (p / sum), PV in f32, one rounding to bf16.
* ``"bf16"``: make_bf16_kernel and full_packed. bf16 operands, f32 logits
  times the scale after the dot, the normalised P rounded to bf16 before PV.
* ``"diet"`` / ``"diet_nomax"``: make_diet_kernel with and without the
  maximum. exp(l - max) (or exp(l)) rounded to bf16 and multiplied by V,
  then divided by the f32 sum of the unrounded p.

The TPU scheduling devices are not ported, since they change nothing in the
function computed: F frames per grid step, the 256-token pad, and the
block-diagonal head packing that fills the MXU's 128 lanes (pair_packed's
block-diagonal K and full_packed's K and V add only zero blocks, so they
compute their modes' function).
"""

from __future__ import annotations

import torch

from . import _cuda

MODES = tuple(_cuda.STUDY_MODES)


def study_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mode: str) -> torch.Tensor:
    """Plain version of study_attention (module note), in f32 on q, k, v's
    values; the result is rounded to bf16."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    if mode == "f32":
        logits = torch.einsum("nqhd,nkhd->nhqk", qf * scale, kf)
    else:
        logits = torch.einsum("nqhd,nkhd->nhqk", qf, kf) * scale
    if mode == "diet_nomax":
        p = torch.exp(logits)
    else:
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True)
    if mode == "f32":
        out = torch.einsum("nhqk,nkhd->nqhd", p / s, vf)
    elif mode == "bf16":
        out = torch.einsum("nhqk,nkhd->nqhd", (p / s).bfloat16().float(), vf)
    else:
        out = torch.einsum("nhqk,nkhd->nqhd", p.bfloat16().float(), vf) / s.transpose(1, 2)
    return out.bfloat16()


def study_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """Kernel: bf16 q, k, v (N, T, H, 64), contiguous, at most 256 tokens ->
    (N, T, H, 64) bf16 in numerics mode ``mode``."""
    if _cuda.on_cpu("study_attention", q):
        return study_attention_plain(q, k, v, mode)
    out = _cuda.study_attention(q, k, v, mode)
    _cuda.LAUNCHES["study_attention"] += 1
    return out
