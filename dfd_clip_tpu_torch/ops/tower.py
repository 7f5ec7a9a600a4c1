"""The whole-encoder tower (counterpart of ``fused_encoder_tower`` in
dfd_clip_tpu/ops/pallas_tower.py, with its ``_quantize_weight_stack`` and
``_stack_q``).

On a CUDA tensor ``fused_encoder_tower`` is one cooperative launch of
csrc/encoder_tower.cu: layers 0..max(keep) over the whole batch (in chunks
of at most 2^16 rows), the residual stream and every intermediate kept in
one chunk's scratch, the kept layers' K/V written into the stacked (Lsel,
N, T', W) buffers. Its stages run the per-layer kernels' bodies (the GEMM frame with
the same Op types and epilogue forms, the encoder attention's TMA / wgmma
body, the row and int8 attention bodies), so it equals the per-layer
kernel chain bit for bit. The JAX package stacks its weights per leaf
((L, ...) arrays) for the TPU kernel's per-layer windows; the port keeps
per-layer lists (models/clip_vit.py) and stacks pointers and tensor maps
instead: the wrapper packs 16 pointers and 4 weight tensor maps a layer
into one small device table per call (7.7 KB for 12 layers, one
host-to-device copy before the launch); no weight is copied. The int8
tower reads the weights ``prepare_int8_params`` quantised (weight_q
quantises any that are missing, as _stack_q does). On a CPU tensor the
plain version runs: the per-layer whole-block chain
(``fused_encoder_block_plain`` below max(keep), then the export-only
``fused_encoder_attn_block_plain(last_only=True)``), which is what the
tower computes. The export is unpadded, T' = T - drop_cls.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _cuda
from .encoder_block import (
    check_int8_attn,
    fused_encoder_attn_block_plain,
    fused_encoder_block_plain,
)
from .int8 import weight_q

LINEARS = (("attn", "in_proj"), ("attn", "out_proj"), ("mlp", "c_fc"), ("mlp", "c_proj"))


def _keep_range(keep: Sequence[int]) -> Tuple[int, int]:
    keep = tuple(keep)
    if not keep or keep != tuple(range(keep[0], keep[-1] + 1)):
        raise ValueError(f"the tower needs a contiguous, sorted keep range; got {keep!r}")
    return keep[0], keep[-1]


def _layer(bp: dict, dtype: torch.dtype, int8_gemm: bool) -> tuple:
    """(weights, scales, biases, norms) of one block for _cuda.encoder_tower."""
    weights, scales = [], []
    for a, b in LINEARS:
        p = bp[a][b]
        if int8_gemm:
            wq, ws = weight_q(p)
            weights.append(wq.contiguous())
            scales.append(ws.float().contiguous())
        else:
            weights.append(p["w"].to(dtype).contiguous())
            scales.append(None)
    biases = [bp[a][b]["b"].float().contiguous() for a, b in LINEARS]
    norms = [bp[ln][key].float().contiguous() for ln in ("ln_1", "ln_2")
             for key in ("scale", "bias")]
    return weights, scales, biases, norms


def fused_encoder_tower(h: torch.Tensor, blocks: list, heads: int, head_dim: int, *,
                        keep: Sequence[int], drop_cls: bool = False, int8_gemm: bool = False,
                        int8_attn: str = "0") -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel: encoder layers 0..max(keep) over h (N, T, W), the post-embed
    residual stream, in one launch. ``blocks``: the per-layer param dicts;
    ``keep`` a contiguous layer range; ``int8_gemm`` the W8A8 tower;
    ``int8_attn`` "1" or "qk" runs its attention int8 (ignored in bf16, as
    in the JAX tower). Returns (k, v): (Lsel, N, T', W) in h's dtype, T' = T
    - drop_cls."""
    check_int8_attn(int8_attn)
    first, last = _keep_range(keep)
    if _cuda.on_cpu("fused_encoder_tower", h):
        return fused_encoder_tower_plain(h, blocks, heads, head_dim, keep=keep,
                                         drop_cls=drop_cls, int8_gemm=int8_gemm,
                                         int8_attn=int8_attn)
    if head_dim != 64:
        raise ValueError(f"fused_encoder_tower: takes head_dim 64, got {head_dim}")
    layers = [_layer(bp, h.dtype, int8_gemm) for bp in blocks[: last + 1]]
    k, v = _cuda.encoder_tower(h.contiguous(), layers, heads, first=first,
                               lo=1 if drop_cls else 0, int8=int8_gemm,
                               attn=int8_attn if int8_gemm else "0")
    _cuda.LAUNCHES["fused_encoder_tower"] += 1
    return k, v


def fused_encoder_tower_plain(h: torch.Tensor, blocks: list, heads: int, head_dim: int, *,
                              keep: Sequence[int], drop_cls: bool = False,
                              int8_gemm: bool = False,
                              int8_attn: str = "0") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of fused_encoder_tower (same contract): the whole-block
    chain with the residual stream rounded to h's dtype between layers and
    hmid f32 inside each, the out-projection W8A8 on the int8 tower."""
    check_int8_attn(int8_attn)
    first, last = _keep_range(keep)
    n, t, w = h.shape
    nsel, t_out = last + 1 - first, t - (1 if drop_cls else 0)
    k = torch.empty((nsel, n, t_out, w), dtype=h.dtype, device=h.device)
    v = torch.empty_like(k)
    for i, bp in enumerate(blocks[:last]):
        into = (k, v, i - first, nsel) if i >= first else None
        out = fused_encoder_block_plain(h, bp["ln_1"], bp["attn"], bp["ln_2"], bp["mlp"], heads,
                                        head_dim, export=into is not None, drop_cls=drop_cls,
                                        export_into=into, int8_gemm=int8_gemm,
                                        int8_attn=int8_attn)
        h = out[0] if into is not None else out
    bp = blocks[last]
    fused_encoder_attn_block_plain(h, bp["ln_1"], bp["attn"], heads, head_dim,
                                   drop_cls=drop_cls, last_only=True,
                                   export_into=(k, v, nsel - 1, nsel), int8_gemm=int8_gemm)
    return k, v
