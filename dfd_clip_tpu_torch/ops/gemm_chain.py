"""The megakernel probe's chained product (counterpart of
tools/bench_megakernel_probe.py's ``per_layer_calls`` and ``megakernel``).

Both entries compute len(ws) chained products h = bf16(h @ W_l) over h (R,
W) bf16 with f32 accumulation and no bias, through csrc/gemm_chain.cu on
CUDA tensors, on the bf16 GEMM's persistent TMA / ``wgmma`` frame
(csrc/gemm_hopper.cuh: 128 x 256 tiles in clusters of two CTAs sharing the
weight's tile). ``gemm_chain_per_layer`` launches the frame's plain kernel
once a layer, h through device memory between the launches.
``gemm_chain_megakernel`` launches once: each cluster takes its pair of
128-row panels through every layer, a layer's output read back from L2 as
the next one's A, waiting only on its own panels' previous layer. Both run
the frame's consumers (wgmma m64n256k16, K in steps of 16 from 0, one bf16
rounding), so their results are bit-equal. On CPU tensors both take
``gemm_chain_plain``. ``ws`` is a contiguous (L, W, W) bf16 tensor (the
probe stacks its weights once, outside the timed calls).
"""

from __future__ import annotations

import torch

from . import _cuda


def gemm_chain_plain(h: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """h = (h @ W_l in f32) rounded to h's dtype, for each W_l of ws."""
    for w in ws:
        h = (h.float() @ w.float()).to(h.dtype)
    return h


def gemm_chain_per_layer(h: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Kernel, one launch a layer (per_layer_calls)."""
    if _cuda.on_cpu("gemm_chain_per_layer", h):
        return gemm_chain_plain(h, ws)
    for i in range(ws.shape[0]):
        h = _cuda.gemm_chain_layer(h, ws[i])
        _cuda.LAUNCHES["gemm_chain_per_layer"] += 1
    return h


def gemm_chain_megakernel(h: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Kernel, one launch for all layers (megakernel)."""
    if _cuda.on_cpu("gemm_chain_megakernel", h):
        return gemm_chain_plain(h, ws)
    out = _cuda.gemm_chain(h, ws)
    _cuda.LAUNCHES["gemm_chain_megakernel"] += 1
    return out
