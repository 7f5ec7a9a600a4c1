"""Decoder block boundary (counterpart of
dfd_clip_tpu/ops/pallas_decoder_stack.py:decoder_boundary).

One boundary on (B, W) rows: out-proj -> +x -> LN2 -> c_fc -> QuickGELU ->
c_proj -> +x (the "tail" of the block being closed), then the next block's
LN1 -> query in-proj to (B, 2W) (the "query" half). The first boundary is
query-only, the last tail-only. Numerics follow models/layers.py: LayerNorm
in f32 cast back, products rounded to bf16 before the bias is added in bf16,
QuickGELU in f32.

On a CUDA tensor the boundary runs as up to six launches of the shared
layer_norm_rows and gemm kernels at M = B rows, each keeping one of those
rounding points in its epilogue. At B = 16 the work is launch latency, not
bytes or FLOPs (PERF.md); capturing the decoder in a CUDA graph is later
work. On a CPU tensor the plain version runs.
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
    dt = x.dtype

    def lin(y, p, **kw):
        return _cuda.gemm(y, p["w"].to(dt), p["b"].float(), bias_after_cast=True, **kw)

    def ln(y, p):
        return _cuda.layer_norm_rows(y, p["scale"].float(), p["bias"].float())

    x_out = qrow = None
    if tail_params is not None:
        mlp = tail_params["mlp"]
        x1 = lin(attn_out.to(dt), tail_params["attn_out_proj"], residual=x)
        mid = lin(ln(x1, tail_params["ln_2"]), mlp["c_fc"], gelu=True)
        x = x_out = lin(mid, mlp["c_proj"], residual=x1)
    if query_params is not None:
        qrow = lin(ln(x, query_params["ln_1"]), query_params["in_proj"])
    _cuda.LAUNCHES["decoder_boundary"] += 1
    return x_out, qrow


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
