"""Frozen DINOv2 Vision Transformer with per-layer K/V export (counterpart of
dfd_clip_tpu/models/dinov2_vit.py).

A patch-14 ViT with a biased patch embedding, no ``ln_pre``, LayerScale
(``ls1``, ``ls2``), an exact-GELU MLP (giant2: the fused SwiGLU FFN,
``w12`` then silu(x1) * x2 then ``w3``) and a biased qkv projection; K and V
are captured from the qkv projection before attention. Params are plain
dicts of tensors in the layout of models/weights.py (``conv1.w`` OIHW,
``blocks`` a per-layer list). The blocks are the JAX package's composition
(dinov2_vit.py:281-293), run by clip_vit.composition_block with the
LayerScale factors and the FFN: ``linear`` on bf16 operands, LayerNorm
through the row kernel, and the attention on the q, k and v column blocks
of the packed qkv projection, read in place by ``encoder_self_attention``
(csrc/encoder_attention.cu, separate entry). The JAX package computes
both FFNs as XLA ops (dinov2_vit.py:65-91), so here they are torch ops.

``dinov2_forward`` is the whole tower under autograd for SSL training and
evaluation (dinov2_vit.py:196-245): the iBOT mask token in place of masked
patch embeddings, the positional embedding resized to any token count
(``_pos_embed_for``), per-sample stochastic depth with keep masks drawn from
an explicit generator, each block optionally rematerialised in the
backward (torch.utils.checkpoint), and ``ln_post``. Its blocks (``_block``)
run LayerNorm as differentiable torch ops, as the JAX package's XLA
LayerNorm, and the attention through ``trainable_encoder_attention`` (the
same kernel under an autograd Function).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from . import layers
from .clip_vit import ViTConfig, composition_block
from .weights import _resize_weights
from ..ops.attention import trainable_encoder_attention

Params = Dict[str, Any]

# The reference builds vit_base(patch=14) for the architecture string
# "ViT-B/16" (dinov2_vit.py:30-33); giant2 ships with the fused-SwiGLU FFN.
DINOV2_S14 = ViTConfig(input_resolution=224, patch_size=14, width=384, layers=12, heads=6,
                       output_dim=384)
DINOV2_B14 = ViTConfig(input_resolution=224, patch_size=14, width=768, layers=12, heads=12,
                       output_dim=768)
DINOV2_L14 = ViTConfig(input_resolution=224, patch_size=14, width=1024, layers=24, heads=16,
                       output_dim=1024)
DINOV2_G14 = ViTConfig(input_resolution=224, patch_size=14, width=1536, layers=40, heads=24,
                       output_dim=1536, ffn_layer="swiglufused")

ARCHITECTURES = {
    "ViT-B/16": DINOV2_B14,
    "ViT-S/14": DINOV2_S14,
    "ViT-B/14": DINOV2_B14,
    "ViT-L/14": DINOV2_L14,
    "ViT-g/14": DINOV2_G14,
    # tiny towers for tests (not DINOv2 releases)
    "ViT-Test": ViTConfig(input_resolution=28, patch_size=14, width=32, layers=2, heads=2,
                          output_dim=32),
    "ViT-Test-SwiGLU": ViTConfig(input_resolution=28, patch_size=14, width=32, layers=2,
                                 heads=2, output_dim=32, ffn_layer="swiglufused"),
}


def init_ffn(gen: torch.Generator, cfg: ViTConfig, std: float) -> Params:
    """The FFN's params for the configured family: ``mlp`` (c_fc, c_proj) or
    ``swiglufused`` (w12 (W, 2 hidden), w3 (hidden, W))."""
    w = cfg.width
    if cfg.ffn_layer == "swiglufused":
        hidden = cfg.swiglu_hidden
        return {"w12": layers.init_linear(gen, w, 2 * hidden, std=std),
                "w3": layers.init_linear(gen, hidden, w, std=std)}
    if cfg.ffn_layer != "mlp":
        raise NotImplementedError(f"ffn_layer: {cfg.ffn_layer}")
    return {"c_fc": layers.init_linear(gen, w, 4 * w, std=std),
            "c_proj": layers.init_linear(gen, 4 * w, w, std=std)}


def apply_ffn(mlp: Params, y: torch.Tensor) -> torch.Tensor:
    """The exact-GELU MLP or, keyed on ``w12``, the fused SwiGLU: silu(x1) *
    x2 of w12's two halves, then w3."""
    if "w12" in mlp:
        x1, x2 = layers.linear(mlp["w12"], y).chunk(2, dim=-1)
        return layers.linear(mlp["w3"], F.silu(x1) * x2)
    return layers.linear(mlp["c_proj"], layers.gelu(layers.linear(mlp["c_fc"], y)))


def init_dinov2(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random init with the JAX package's scales (f32, CPU)."""
    w, scale = cfg.width, 0.02

    def block() -> Params:
        return {
            "ln_1": layers.init_layer_norm(w),
            "attn": {"in_proj": layers.init_linear(gen, w, 3 * w, std=scale),
                     "out_proj": layers.init_linear(gen, w, w, std=scale)},
            "ls1": torch.ones(w),
            "ln_2": layers.init_layer_norm(w),
            "mlp": init_ffn(gen, cfg, std=scale),
            "ls2": torch.ones(w),
        }

    return {
        "conv1": {"w": scale * torch.randn(w, 3, cfg.patch_size, cfg.patch_size, generator=gen),
                  "b": torch.zeros(w)},
        "class_embedding": scale * torch.randn(w, generator=gen),
        "mask_token": torch.zeros(w),
        "positional_embedding": scale * torch.randn(cfg.num_tokens, w, generator=gen),
        "blocks": [block() for _ in range(cfg.layers)],
        "ln_post": layers.init_layer_norm(w),
    }


def embed(params: Params, x: torch.Tensor, cfg: ViTConfig,
          compute_dtype: torch.dtype = torch.bfloat16,
          masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3, H, W) normalized frames -> [CLS; patches + b] + pos, (N, T, W),
    with the patches that the (N, P) bool ``masks`` marks replaced by the
    mask token (dinov2_vit.py:133-156) and the positional embedding resized
    to the frames' grid (``_pos_embed_for``)."""
    x = F.conv2d(x.to(compute_dtype), params["conv1"]["w"].to(compute_dtype),
                 stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2) + params["conv1"]["b"].to(compute_dtype)
    if masks is not None:
        x = torch.where(masks[..., None], params["mask_token"].to(compute_dtype), x)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    return x + _pos_embed_for(params["positional_embedding"], x.shape[1]).to(compute_dtype)


def _pos_embed_for(pos: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The (1 + S^2, W) positional embedding for ``n_tokens`` = 1 + g^2
    tokens: CLS kept, the S x S grid resized to g x g by jax.image.resize's
    bicubic with antialias=False (dinov2_vit.py:159-175): Keys' cubic
    (a = -0.5) with the kernel not stretched when shrinking, which is
    neither F.interpolate's bicubic (a = -0.75) nor the converter's
    antialiased resize. The (S, g) weight matrix is applied along one grid
    axis, then the other (jax.image's order), as torch products, so ``pos``
    stays in the autograd graph."""
    if n_tokens == pos.shape[0]:
        return pos
    src = int(round((pos.shape[0] - 1) ** 0.5))
    dst = int(round((n_tokens - 1) ** 0.5))
    wts = torch.from_numpy(_resize_weights(src, dst, antialias=False)).to(pos.device)
    grid = pos[1:].reshape(src, src, -1).float()
    grid = torch.tensordot(grid, wts, dims=([0], [0])).movedim(-1, 0)
    grid = torch.tensordot(grid, wts, dims=([1], [0])).movedim(-1, 1).to(pos.dtype)
    return torch.cat([pos[:1], grid.reshape(dst * dst, -1)])


def _block(bp: Params, h: torch.Tensor, cfg: ViTConfig, dp1: Optional[torch.Tensor] = None,
           dp2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-LN block under autograd (dinov2_vit.py:178-193). ``dp1`` /
    ``dp2``: per-sample stochastic-depth keep masks (N, 1, 1), pre-scaled by
    1 / keep, on the attention and FFN branches (None: kept)."""
    n, t, w = h.shape
    qkv = layers.linear(bp["attn"]["in_proj"], layers.layer_norm(bp["ln_1"], h))
    q, k, v = (s.reshape(n, t, cfg.heads, cfg.head_dim) for s in qkv.split(w, dim=-1))
    att = layers.linear(bp["attn"]["out_proj"],
                        trainable_encoder_attention(q, k, v).reshape(n, t, w))
    ls1, ls2 = bp["ls1"].to(h.dtype), bp["ls2"].to(h.dtype)
    h = h + (ls1 if dp1 is None else dp1 * ls1) * att
    y = apply_ffn(bp["mlp"], layers.layer_norm(bp["ln_2"], h))
    return h + (ls2 if dp2 is None else dp2 * ls2) * y


def dinov2_forward(
    params: Params, x: torch.Tensor, cfg: ViTConfig,
    compute_dtype: torch.dtype = torch.bfloat16, masks: Optional[torch.Tensor] = None,
    drop_path_rate: float = 0.0, gen: Optional[torch.Generator] = None, remat: bool = False,
) -> Dict[str, torch.Tensor]:
    """The whole tower for SSL and evaluation: {"cls": (N, W), "patch":
    (N, P, W)} in f32 after ``ln_post`` (dinov2_vit.py:196-245), with the
    iBOT ``masks`` (N, P) bool, and with ``drop_path_rate`` > 0 and a
    generator (on x's device) each block's two keep masks drawn per sample
    from ``gen`` (Bernoulli(1 - rate) / (1 - rate)); the draws are not the
    JAX package's (another generator). ``remat`` checkpoints each block
    (use_reentrant=False): its masks are drawn before the checkpointed call
    and passed in, because a recompute restores the global RNG state but
    not an explicit generator's, so the backward sees the same masks."""
    h = embed(params, x, cfg, compute_dtype, masks)
    keep = 1.0 - drop_path_rate
    for bp in params["blocks"]:
        dps = ()
        if drop_path_rate > 0.0 and gen is not None:
            dps = tuple((torch.rand((h.shape[0], 1, 1), generator=gen, device=h.device)
                         < keep).to(h.dtype) / keep for _ in range(2))
        if remat:
            h = torch.utils.checkpoint.checkpoint(_block, bp, h, cfg, *dps,
                                                  use_reentrant=False)
        else:
            h = _block(bp, h, cfg, *dps)
    h = layers.layer_norm(params["ln_post"], h)
    return {"cls": h[:, 0].float(), "patch": h[:, 1:].float()}


def dinov2_kv(
    params: Params, x: torch.Tensor, cfg: ViTConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    keep_layers: Optional[tuple] = None, drop_cls: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the frozen tower, exporting the kept layers' head-split K and V:
    {"k", "v"}: (Lsel, N, T', H, D), T' = T - drop_cls (no pad rows). Blocks
    after the last kept layer are skipped, and the last kept layer runs LN1
    and the qkv projection only (dinov2_vit.py:336-355)."""
    h = embed(params, x, cfg, compute_dtype)
    n, t, w = h.shape
    keep = tuple(range(cfg.layers)) if keep_layers is None else tuple(keep_layers)
    last = max(keep)
    slot_of = {layer: s for s, layer in enumerate(keep)}
    lo = 1 if drop_cls else 0
    kacc = torch.empty((len(keep), n, t - lo, w), dtype=h.dtype, device=h.device)
    vacc = torch.empty_like(kacc)
    for i in range(last + 1):
        into = (kacc, vacc, slot_of[i], len(keep)) if i in keep else None
        h, _ = composition_block(params["blocks"][i], h, cfg, into, drop_cls, attend=i < last,
                                 ffn=apply_ffn, separate_qkv=True)
    shape = (len(keep), n, t - lo, cfg.heads, cfg.head_dim)
    return {"k": kacc.view(shape), "v": vacc.view(shape)}
