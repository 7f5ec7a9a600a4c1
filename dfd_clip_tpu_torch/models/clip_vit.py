"""Frozen CLIP Vision Transformer with per-layer K/V export (counterpart of
dfd_clip_tpu/models/clip_vit.py).

Params are plain dicts of tensors: ``conv1.w`` in PyTorch's OIHW layout and
``blocks`` a list of per-layer dicts (models/weights.py converts the JAX
package's HWIO, layer-stacked form). The kept layers write their CLS-dropped
K/V straight into one (Lsel, N, T', W) buffer per K and V, blocks after the
last kept layer are skipped, and the last kept layer runs LN1 + the K/V
projection only. The JAX package's gate picks the block form
(clip_vit.py:288-342); where it reads the environment (DFD_FUSED_BLOCK,
DFD_MEGAKERNEL, DFD_INT8_ATTN), the port takes explicit arguments
(``block``, ``tower``, ``int8_attn``):

* width <= 768 (ViT-B): the fused blocks of ops/encoder_block.py, the split
  attention/MLP pair in bf16, one whole ``fused_encoder_block`` a layer with
  ``compute_int8`` (W8A8); ``block="full"`` or ``"split"`` forces either
  form in bf16 or int8;
* width 1024 (ViT-L) with ``compute_int8``: the split pair in its int8
  forms, the whole int8 block with ``block="full"``;
* wider bf16 towers (ViT-L): the XLA composition (clip_vit.py:438-497) in
  torch ops, with ``linear`` on bf16 operands, LayerNorm through the row
  kernel and the attention through ``encoder_self_attention_qkv``
  (csrc/encoder_attention.cu, packed entry);
* width above 1024 with ``compute_int8`` (a CLIP-layout checkpoint whose
  conv1 is wider, e.g. 1280 at 20 heads of 64): the same composition with
  every block product W8A8 (``layers.linear_w8a8``: quant_rows' "linear"
  form and ``gemm_s8`` on the card), the out-projection included, as
  JAX's default DFD_INT8_WO does; ``tower=True`` and ``block="full"``
  raise there, whose kernels budget for width <= 1024;
* ``tower=True`` where JAX runs its megakernel (fused blocks, no int8_rows
  export, a contiguous keep range): ``fused_encoder_tower``
  (ops/tower.py), one launch for the whole encoder, with an unpadded
  export (T' = T - drop_cls even under ``pad_tokens``); elsewhere the
  per-layer forms above run, as in JAX;
* ``int8_attn`` "1" or "qk" runs the int8 whole block's or the tower's
  attention on int8 (``compute_int8`` only; the split pair has none).

With ``kv_int8_rows`` the export is int8 with per-row scales. With
``kv_int8`` (op_mode kv_dtype "int8") the usual export is quantised after
it, as the JAX package quantises its collected K/V on the XLA path: each
kept layer's K and V with one absmax scale a head over frames, tokens and
head lanes, so the scale spans the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import layers
from ..ops.attention import encoder_self_attention, encoder_self_attention_qkv
from ..ops.encoder_block import (
    check_int8_attn,
    export_kv,
    fused_encoder_attn_block,
    fused_encoder_block,
    fused_encoder_mlp_block,
)
from ..ops.int8 import quantize_weight
from ..ops.tower import fused_encoder_tower

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512
    # FFN family: "mlp" (CLIP, DINOv2 S/B/L) or "swiglufused" (DINOv2 giant2)
    ffn_layer: str = "mlp"

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def swiglu_hidden(self) -> int:
        """The fused SwiGLU FFN's hidden width: 2/3 of 4 W, rounded up to a
        multiple of 8 (4096 at W = 1536)."""
        return (int(4 * self.width * 2 / 3) + 7) // 8 * 8


VIT_B16 = ViTConfig()
VIT_L14 = ViTConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=768)

ARCHITECTURES = {
    "ViT-B/16": VIT_B16,
    "ViT-B/32": dataclasses.replace(VIT_B16, patch_size=32),
    "ViT-L/14": VIT_L14,
    "ViT-L/14@336px": dataclasses.replace(VIT_L14, input_resolution=336),
    # tiny towers for tests (not CLIP releases)
    "ViT-Test": ViTConfig(input_resolution=32, patch_size=16, width=64, layers=3,
                          heads=4, output_dim=32),
    "ViT-Test-Wide": ViTConfig(input_resolution=32, patch_size=16, width=256, layers=3,
                               heads=4, output_dim=32),
}


def init_clip_vision(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random init with CLIP-style scales (f32, CPU)."""
    w = cfg.width
    scale = w ** -0.5
    attn_std = (2 * w) ** -0.5

    def block() -> Params:
        return {
            "ln_1": layers.init_layer_norm(w),
            "attn": {
                "in_proj": layers.init_linear(gen, w, 3 * w, std=attn_std),
                "out_proj": layers.init_linear(gen, w, w, std=attn_std),
            },
            "ln_2": layers.init_layer_norm(w),
            "mlp": {
                "c_fc": layers.init_linear(gen, w, 4 * w, std=scale),
                "c_proj": layers.init_linear(gen, 4 * w, w, std=scale),
            },
        }

    return {
        "conv1": {"w": scale * torch.randn(w, 3, cfg.patch_size, cfg.patch_size, generator=gen)},
        "class_embedding": scale * torch.randn(w, generator=gen),
        "positional_embedding": scale * torch.randn(cfg.num_tokens, w, generator=gen),
        "ln_pre": layers.init_layer_norm(w),
        "blocks": [block() for _ in range(cfg.layers)],
    }


def embed_patches(params: Params, x: torch.Tensor, cfg: ViTConfig,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, 3, H, W) normalized frames -> ln_pre([CLS; patches] + pos), (N, T, W)."""
    x = F.conv2d(x.to(compute_dtype), params["conv1"]["w"].to(compute_dtype),
                 stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)                            # (N, grid^2, W)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].to(compute_dtype)
    return layers.layer_norm(params["ln_pre"], x)


def prepare_int8_params(params: Params) -> Params:
    """Pre-quantise the frozen tower's block GEMM weights for compute_int8
    inference: beside each ``w`` of ``in_proj``, ``out_proj``, ``c_fc`` and
    ``c_proj`` add ``wq`` int8, stored transposed (N, K) for the int8 GEMM,
    and ``ws`` (1, N) f32, quantised from ``w`` in f32 (call it before
    weights are cast to bf16)."""
    def aug(p: Params) -> Params:
        wq, ws = quantize_weight(p["w"])
        return {**p, "wq": wq, "ws": ws}

    blocks = [{**bp,
               "attn": {**bp["attn"], "in_proj": aug(bp["attn"]["in_proj"]),
                        "out_proj": aug(bp["attn"]["out_proj"])},
               "mlp": {**bp["mlp"], "c_fc": aug(bp["mlp"]["c_fc"]),
                       "c_proj": aug(bp["mlp"]["c_proj"])}}
              for bp in params["blocks"]]
    return {**params, "blocks": blocks}


def clip_mlp(mlp: Params, y: torch.Tensor, lin=layers.linear) -> torch.Tensor:
    """c_fc -> QuickGELU -> c_proj in y's dtype (the composition's MLP), each
    product through ``lin``."""
    return lin(mlp["c_proj"], layers.quick_gelu(lin(mlp["c_fc"], y)))


def clip_mlp_w8a8(mlp: Params, y: torch.Tensor) -> torch.Tensor:
    """clip_mlp with both products W8A8 (layers.linear_w8a8)."""
    return clip_mlp(mlp, y, layers.linear_w8a8)


def composition_block(bp: Params, h: torch.Tensor, cfg: ViTConfig, export_into: Optional[tuple],
                      drop_cls: bool, kv_pad: int = 0, kv_rows8: bool = False,
                      attend: bool = True, ffn=clip_mlp, separate_qkv: bool = False,
                      lin=layers.linear):
    """One block of the XLA composition (clip_vit.py:438-497, and DINOv2's
    dinov2_vit.py:281-293) on h (N, T, W): LN1, the packed qkv projection
    (product rounded to h's dtype, then the bias), the K/V export into
    ``export_into``'s slot when given, then, with ``attend``, attention,
    out-projection and residual, LN2, ``ffn`` and residual. The block's
    LayerScale factors ``ls1``/``ls2`` (DINOv2) scale the two branches when
    present. The attention reads the packed qkv (``encoder_self_attention_qkv``)
    or, with ``separate_qkv``, its q, k and v column blocks as strided views
    (``encoder_self_attention``). ``lin`` computes the qkv and out
    projections (layers.linear_w8a8 for the W8A8 composition, with
    ``ffn=clip_mlp_w8a8``). Returns (h, the kv_rows8 scales or ()); h is
    None without ``attend`` (the last kept layer)."""
    n, t, w = h.shape
    qkv = block_qkv(bp, h, lin)
    scales = ()
    if export_into is not None:
        scales = export_kv(qkv.reshape(n * t, 3 * w), n, t, w, 1 if drop_cls else 0, kv_pad,
                           kv_rows8, export_into)[2]
    if not attend:
        return None, scales
    return block_tail(bp, h, qkv, cfg, ffn, separate_qkv, lin), scales


def block_qkv(bp: Params, h: torch.Tensor, lin=layers.linear) -> torch.Tensor:
    """A block's LN1 and packed qkv projection on h (N, T, W): (N, T, 3W)."""
    return lin(bp["attn"]["in_proj"], layers.layer_norm_rows(bp["ln_1"], h))


def block_tail(bp: Params, h: torch.Tensor, qkv: torch.Tensor, cfg: ViTConfig, ffn=clip_mlp,
               separate_qkv: bool = False, lin=layers.linear) -> torch.Tensor:
    """The rest of the block from its ``block_qkv``: attention,
    out-projection (through ``lin``) and residual, LN2, ``ffn`` and
    residual, each branch scaled by its LayerScale factor when present."""
    n, t, w = h.shape
    if separate_qkv:
        q, k, v = (s.reshape(n, t, cfg.heads, cfg.head_dim) for s in qkv.split(w, dim=-1))
        att = encoder_self_attention(q, k, v).reshape(n, t, w)
    else:
        att = encoder_self_attention_qkv(qkv, cfg.heads, cfg.head_dim)
    h = h + _layer_scale(bp, "ls1", lin(bp["attn"]["out_proj"], att))
    y = ffn(bp["mlp"], layers.layer_norm_rows(bp["ln_2"], h))
    return h + _layer_scale(bp, "ls2", y)


def _layer_scale(bp: Params, key: str, y: torch.Tensor) -> torch.Tensor:
    return bp[key].to(y.dtype) * y if key in bp else y


def quantize_kv_heads(f: torch.Tensor, reduce_max=None) -> tuple:
    """(Lsel, N, T, H, D) K or V -> (int8 values, (Lsel, H) f32 scales): a
    layer's scale of head h is max |f| over its frames, tokens and lanes +
    1e-8, and q = clip(round(f / s * 127), -127, 127) (clip_vit.py:272-280);
    zero pad rows quantise to 0. ``reduce_max`` (in place, on the (Lsel, H)
    maxima) takes them over the other data ranks' frames too, so that the
    scale spans the global batch as JAX's does."""
    f32 = f.float()
    amax = f32.abs().amax(dim=(1, 2, 4))
    if reduce_max is not None:
        reduce_max(amax)
    scale = amax + 1e-8
    q = torch.round(f32 / scale[:, None, None, :, None] * 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


BLOCK_FORMS = ("auto", "full", "split")


def clip_vision_kv(
    params: Params, x: torch.Tensor, cfg: ViTConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    keep_layers: Optional[tuple] = None, kv_int8: bool = False, drop_cls: bool = False,
    compute_int8: bool = False, kv_int8_rows: bool = False, pad_tokens: bool = False,
    block: str = "auto", tower: bool = False, int8_attn: str = "0", kv_scale_reduce=None,
) -> Dict[str, torch.Tensor]:
    """Run the frozen tower, exporting the kept layers' head-split K and V.

    Returns {"k", "v"}: (Lsel, N, T', H, D), T' = T - drop_cls, zero-padded
    up to a multiple of 8 rows with ``pad_tokens`` (196 -> 200 for CLIP-B)
    except on the tower. ``compute_int8``: the W8A8 tower (the block GEMMs
    on int8 weights, see prepare_int8_params). ``kv_int8_rows``: K/V int8,
    quantised per row at the export, plus {"k_scale", "v_scale"}: (Lsel, N,
    T', 1) f32, dequant q * s, pad rows 0. ``block``, ``tower`` and
    ``int8_attn`` choose the encoder's kernels as DFD_FUSED_BLOCK,
    DFD_MEGAKERNEL and DFD_INT8_ATTN do in the JAX package (module note).
    ``kv_int8``: K/V int8 with per-(layer, head) scales, {"k_scale",
    "v_scale"}: (Lsel, H) f32, dequant q * s / 127 (quantize_kv_heads; not
    on the tower, as in JAX), its maxima reduced by ``kv_scale_reduce``."""
    if kv_int8 and kv_int8_rows:
        raise ValueError("pick one K/V quantisation: kv_int8 or kv_int8_rows")
    if block not in BLOCK_FORMS:
        raise ValueError(f"block must be one of {BLOCK_FORMS}, got {block!r}")
    check_int8_attn(int8_attn)
    fused = cfg.width <= 768 or (compute_int8 and cfg.width <= 1024)
    if compute_int8 and not fused and (tower or block == "full"):
        raise ValueError(f"a W8A8 tower of width {cfg.width} runs the XLA composition: the "
                         "whole-encoder tower and the whole int8 block budget for width <= "
                         "1024, as JAX's fused kernels do")
    if block == "auto":
        block = "full" if compute_int8 and cfg.width <= 768 else "split"
    whole_block = fused and block == "full"
    int8_attn = int8_attn if compute_int8 else "0"
    h = embed_patches(params, x, cfg, compute_dtype)
    n, t = h.shape[:2]
    w = cfg.width
    t_real = t - 1 if drop_cls else t
    keep = tuple(range(cfg.layers)) if keep_layers is None else tuple(keep_layers)
    last = max(keep)
    if tower and fused and not (kv_int8 or kv_int8_rows) \
            and keep == tuple(range(keep[0], last + 1)):
        k, v = fused_encoder_tower(h, params["blocks"], cfg.heads, cfg.head_dim, keep=keep,
                                   drop_cls=drop_cls, int8_gemm=compute_int8,
                                   int8_attn=int8_attn)
        shape = (len(keep), n, t_real, cfg.heads, cfg.head_dim)
        return {"k": k.view(shape), "v": v.view(shape)}
    kv_pad = (-t_real) % 8 if pad_tokens else 0
    slot_of = {layer: s for s, layer in enumerate(keep)}
    lin, ffn = (layers.linear_w8a8, clip_mlp_w8a8) if compute_int8 else (layers.linear, clip_mlp)
    nsel, t_out = len(keep), t_real + kv_pad
    kv_dt = torch.int8 if kv_int8_rows else h.dtype
    kacc = torch.empty((nsel, n, t_out, w), dtype=kv_dt, device=h.device)
    vacc = torch.empty_like(kacc)
    scales = {}
    for i in range(last + 1):
        bp = params["blocks"][i]
        into = (kacc, vacc, slot_of[i], nsel) if i in keep else None
        if not fused:
            h, scales[i] = composition_block(bp, h, cfg, into, drop_cls, kv_pad, kv_int8_rows,
                                             attend=i < last, ffn=ffn, lin=lin)
            continue
        if i == last:
            out = fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads, cfg.head_dim,
                                           drop_cls=drop_cls, last_only=True, export_into=into,
                                           kv_pad=kv_pad, int8_gemm=compute_int8,
                                           kv_rows8=kv_int8_rows)
            scales[i] = out[2:]
            break
        if whole_block:
            out = fused_encoder_block(h, bp["ln_1"], bp["attn"], bp["ln_2"], bp["mlp"],
                                      cfg.heads, cfg.head_dim, export=i in keep,
                                      drop_cls=drop_cls, export_into=into,
                                      int8_gemm=compute_int8, kv_rows8=kv_int8_rows,
                                      kv_pad=kv_pad, int8_attn=int8_attn)
        elif i in keep:
            out = fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads, cfg.head_dim,
                                           export=True, drop_cls=drop_cls, export_into=into,
                                           kv_pad=kv_pad, int8_gemm=compute_int8,
                                           kv_rows8=kv_int8_rows)
        else:
            out = fused_encoder_attn_block(h, bp["ln_1"], bp["attn"], cfg.heads, cfg.head_dim,
                                           int8_gemm=compute_int8)
        if i in keep:
            h, scales[i] = out[0], out[3:]
        else:
            h = out
        if not whole_block:
            h = fused_encoder_mlp_block(h, bp["ln_2"], bp["mlp"], int8_gemm=compute_int8)
    shape = (nsel, n, t_out, cfg.heads, cfg.head_dim)
    result = {"k": kacc.view(shape), "v": vacc.view(shape)}
    if kv_int8:
        (result["k"], result["k_scale"]), (result["v"], result["v_scale"]) = (
            quantize_kv_heads(result["k"], kv_scale_reduce),
            quantize_kv_heads(result["v"], kv_scale_reduce))
    if kv_int8_rows:
        result["k_scale"] = torch.stack([scales[i][0] for i in keep])
        result["v_scale"] = torch.stack([scales[i][1] for i in keep])
    return result
