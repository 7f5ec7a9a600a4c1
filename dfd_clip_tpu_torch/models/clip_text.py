"""CLIP's text tower and zero-shot scoring surface (counterpart of
dfd_clip_tpu/models/clip_text.py).

``clip_text_encode``: token embedding + positional, a pre-LN transformer
with a causal mask, ``ln_final``, the row at each prompt's EOT (the largest
id, so ``argmax(tokens)``) through ``text_projection``. Its attention is a
torch composition with the mask as a (1, 1, L, L) additive -inf bias on f32
logits, as the JAX package leaves it to XLA (no Pallas kernel runs there).

``clip_vision_features``: CLIP's pooled image path, ``ln_post`` on the CLS
row @ ``proj``. Its blocks are the ViT composition
(``clip_vit.composition_block``): LayerNorm through the row kernel on the
card, the products in ``layers.linear``, and the attention through
``encoder_self_attention_qkv``, which launches the packed encoder attention
kernel (csrc/encoder_attention.cu) for a bf16 tensor on the card and raises
for another dtype there; on the CPU each is its plain version.

``zero_shot_logits``: exp(logit_scale) x the cosine similarities.

Params are dicts of tensors with ``blocks`` a list of per-layer dicts;
models/weights.py turns the JAX package's layer-stacked trees into them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import clip_vit, layers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


ARCHITECTURES: Dict[str, TextConfig] = {
    "ViT-B/16": TextConfig(),                                  # pairs with ViT-B/16 (512)
    "ViT-L/14": TextConfig(width=768, heads=12, embed_dim=768),
    # a tiny tower for tests (not a CLIP release)
    "Text-Test": TextConfig(context_length=12, vocab_size=64, width=32, heads=4, layers=2,
                            embed_dim=16),
}


def init_clip_text(gen: torch.Generator, cfg: TextConfig) -> Params:
    """Random init with CLIP's scales (f32, CPU) from ``gen``."""
    w = cfg.width
    scale = w ** -0.5
    attn_std = scale * (2 * cfg.layers) ** -0.5
    params = {
        "token_embedding": 0.02 * torch.randn(cfg.vocab_size, w, generator=gen),
        "positional_embedding": 0.01 * torch.randn(cfg.context_length, w, generator=gen),
        "text_projection": scale * torch.randn(w, cfg.embed_dim, generator=gen),
    }
    params["blocks"] = [{
        "ln_1": layers.init_layer_norm(w),
        "attn": {"in_proj": layers.init_linear(gen, w, 3 * w, std=attn_std),
                 "out_proj": layers.init_linear(gen, w, w, std=attn_std)},
        "ln_2": layers.init_layer_norm(w),
        "mlp": {"c_fc": layers.init_linear(gen, w, 4 * w, std=scale),
                "c_proj": layers.init_linear(gen, 4 * w, w, std=scale)},
    } for _ in range(cfg.layers)]
    params["ln_final"] = layers.init_layer_norm(w)
    params["logit_scale"] = torch.tensor(2.6592)   # ln(1 / 0.07), CLIP's init
    return params


def _text_block(h: torch.Tensor, bp: Params, cfg: TextConfig, bias) -> torch.Tensor:
    """One pre-LN block with masked attention: f32 logits + ``bias``, the
    softmax cast to h's dtype, then P V in h's dtype."""
    b, l, w = h.shape
    qkv = layers.linear(bp["attn"]["in_proj"], layers.layer_norm(bp["ln_1"], h))
    q, k, v = (s.reshape(b, l, cfg.heads, cfg.head_dim) for s in qkv.split(w, dim=-1))
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * cfg.head_dim ** -0.5
    att = torch.softmax(logits + bias, dim=-1).to(h.dtype)
    o = torch.einsum("bhlm,bmhd->blhd", att, v).reshape(b, l, w)
    h = h + layers.linear(bp["attn"]["out_proj"], o)
    return h + clip_vit.clip_mlp(bp["mlp"], layers.layer_norm(bp["ln_2"], h))


def _normalized(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def clip_text_encode(params: Params, tokens: torch.Tensor, cfg: TextConfig,
                     compute_dtype: torch.dtype = torch.float32, normalize: bool = False,
                     causal: bool = True) -> torch.Tensor:
    """(B, L) int tokens -> (B, embed_dim) text features, on the params'
    device. ``causal`` (default) is CLIP's mask; ``causal=False`` the
    unmasked blocks of the reference's vendored copy."""
    tokens = torch.as_tensor(tokens, device=params["token_embedding"].device).long()
    _, l = tokens.shape
    h = params["token_embedding"][tokens] + params["positional_embedding"][:l]
    h = h.to(compute_dtype)
    if causal:
        keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=h.device))
        bias = torch.where(keep, 0.0, float("-inf"))[None, None]
    else:
        bias = 0.0
    for bp in params["blocks"]:
        h = _text_block(h, bp, cfg, bias)
    x = layers.layer_norm(params["ln_final"], h)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    feats = pooled @ params["text_projection"].to(compute_dtype)
    return _normalized(feats) if normalize else feats


def clip_vision_features(params: Params, x: torch.Tensor, cfg: clip_vit.ViTConfig,
                         compute_dtype: torch.dtype = torch.float32,
                         normalize: bool = False) -> torch.Tensor:
    """(B, 3, H, W) normalized images -> (B, output_dim) pooled features.
    Needs a tree with ``ln_post`` and ``proj`` (a converted checkpoint's;
    ``init_clip_vision`` has neither). On the card the compute dtype must be
    bf16, the attention kernel's input."""
    h = clip_vit.embed_patches(params, x, cfg, compute_dtype)
    for bp in params["blocks"]:
        h, _ = clip_vit.composition_block(bp, h, cfg, None, False)
    pooled = layers.layer_norm(params["ln_post"], h[:, 0])
    feats = pooled @ params["proj"].to(compute_dtype)
    return _normalized(feats) if normalize else feats


def zero_shot_logits(image_feats: torch.Tensor, text_feats: torch.Tensor,
                     logit_scale) -> torch.Tensor:
    """(B_img, B_txt) cosine-similarity logits scaled by exp(logit_scale)."""
    return torch.exp(torch.as_tensor(logit_scale)) * _normalized(image_feats) \
        @ _normalized(text_feats).T
