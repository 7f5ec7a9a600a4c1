"""Decoder block boundary (counterpart of
dfd_clip_tpu/ops/pallas_decoder_stack.py:decoder_boundary).

One boundary on (B, W) rows: out-proj -> +x -> LN2 -> c_fc -> QuickGELU ->
c_proj -> +x (the "tail" of the block being closed), then the next block's
LN1 -> query in-proj to (B, 2W) (the "query" half). The first boundary is
query-only, the last tail-only. Numerics follow models/layers.py: LayerNorm
in f32 cast back, products rounded to bf16 before the bias is added in bf16,
QuickGELU in f32.

On a CUDA tensor the boundary is one cooperative launch
(csrc/decoder_boundary.cu, _cuda.decoder_boundary) in all three forms: the
weights stream into shared memory by TMA while the stages run, a grid
barrier between the stages, gemm's epilogues and layer_norm_rows's
arithmetic at each of those rounding points. Up to width 1024 each block's
weight slices stay resident in shared memory; wider rows (1536, DINOv2
ViT-g/14) take the streamed form, which passes them through a ring of
K-chunks (_cuda.boundary_geometry picks the form by width). On a CPU
tensor the plain version runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import layer_norm, linear
from . import _cuda


def decoder_boundary(x: torch.Tensor, attn_out: Optional[torch.Tensor],
                     tail_params: Optional[dict], query_params: Optional[dict]):
    """x (B, W) residual stream; attn_out (B, W) or None at the first
    boundary; tail_params {"attn_out_proj", "ln_2", "mlp"}; query_params
    {"ln_1", "in_proj"}. Returns (x_out, qrow) with the absent halves None."""
    if tail_params is None and query_params is None:
        raise ValueError("decoder_boundary: needs a tail or a query half")
    if _cuda.on_cpu("decoder_boundary", x):
        return decoder_boundary_plain(x, attn_out, tail_params, query_params)
    return _cuda.decoder_boundary(x, attn_out, tail_params, query_params)


def decoder_boundary_plain(x, attn_out, tail_params, query_params):
    """Plain version of decoder_boundary (same contract)."""
    x_out = qrow = None
    if tail_params is not None:
        mlp = tail_params["mlp"]
        x = x + linear(tail_params["attn_out_proj"], attn_out.to(x.dtype))
        mid = linear(mlp["c_fc"], layer_norm(tail_params["ln_2"], x)).float()
        mid = (mid * torch.sigmoid(1.702 * mid)).to(x.dtype)
        x = x_out = x + linear(mlp["c_proj"], mid)
    if query_params is not None:
        qrow = linear(query_params["in_proj"], layer_norm(query_params["ln_1"], x))
    return x_out, qrow
