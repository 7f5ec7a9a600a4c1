"""CLIP's ModifiedResNet image tower, the RN50 family (counterpart of
dfd_clip_tpu/models/clip_resnet.py).

A 3-conv stem with a 2 x 2 average pool; bottlenecks whose strided ones
pool after conv2, with an avgpool + 1x1 conv + BN downsample; frozen
(running-statistics) BatchNorm in f32, eps 1e-5; and the attention pool:
the mean token prepended, q from the mean token only, k and v from every
token, in f32. ``clip_resnet_features`` pairs with
clip_text.zero_shot_logits as clip_vision_features does.

The convolutions are ``F.conv2d`` on NCHW activations (the JAX package's
``lax.conv`` runs no Pallas kernel); their weights are stored OIHW, the
layout ``F.conv2d`` reads (models/weights.py converts the JAX package's
HWIO). On the card they are cuDNN's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    heads: int = 32          # width * 32 // 64
    input_resolution: int = 224
    output_dim: int = 1024

    @property
    def embed_dim(self) -> int:
        return self.width * 32

    @property
    def spacial_dim(self) -> int:
        return self.input_resolution // 32


ARCHITECTURES: Dict[str, ResNetConfig] = {
    "RN50": ResNetConfig(),
    "RN101": ResNetConfig(layers=(3, 4, 23, 3), output_dim=512),
    "RN50x4": ResNetConfig(layers=(4, 6, 10, 6), width=80, heads=40, input_resolution=288,
                           output_dim=640),
    "RN50x16": ResNetConfig(layers=(6, 8, 18, 8), width=96, heads=48, input_resolution=384,
                            output_dim=768),
    "RN50x64": ResNetConfig(layers=(3, 15, 36, 10), width=128, heads=64, input_resolution=448,
                            output_dim=1024),
    # a tiny tower for tests (heads by the width * 32 // 64 rule)
    "RN-Test": ResNetConfig(layers=(1, 1, 1, 1), width=16, heads=8, input_resolution=32,
                            output_dim=8),
}


def _conv(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding)


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channel axis (1), in f32."""
    def c(name):
        return p[name].float()[None, :, None, None]

    out = (x.float() - c("mean")) * torch.rsqrt(c("var") + eps) * c("scale") + c("bias")
    return out.to(x.dtype)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """nn.AvgPool2d(k): window and stride k, floor."""
    return F.avg_pool2d(x, k)


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    out = F.relu(_bn(p["bn2"], _conv(p["conv2"], out, padding=1)))
    if stride > 1:
        out = _avg_pool(out, stride)
    out = _bn(p["bn3"], _conv(p["conv3"], out))
    idn = x
    if "downsample" in p:
        if stride > 1:
            idn = _avg_pool(idn, stride)
        idn = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"], idn))
    return F.relu(out + idn)


def _attn_pool(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """AttentionPool2d: the mean token's query over [mean; tokens], in f32."""
    n, c = x.shape[:2]
    toks = x.flatten(2).transpose(1, 2)                           # (N, HW, C)
    toks = torch.cat([toks.mean(dim=1, keepdim=True), toks], dim=1)
    toks = toks + p["positional_embedding"].to(toks.dtype)
    d = c // heads

    def proj(name, v):
        return v.float() @ p[name]["w"].float() + p[name]["b"].float()

    q = proj("q_proj", toks[:, :1]).reshape(n, 1, heads, d)
    k = proj("k_proj", toks).reshape(n, -1, heads, d)
    v = proj("v_proj", toks).reshape(n, -1, heads, d)
    probs = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q * d ** -0.5, k), dim=-1)
    pooled = torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(n, c)
    out = pooled @ p["c_proj"]["w"].float() + p["c_proj"]["b"].float()
    return out.to(x.dtype)


def clip_resnet_features(params: Params, x: torch.Tensor, cfg: ResNetConfig,
                         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, 3, H, W) normalized images -> (N, output_dim) pooled features, on
    x's device."""
    x = x.to(compute_dtype)
    stem = params["stem"]
    x = F.relu(_bn(stem["bn1"], _conv(stem["conv1"], x, stride=2, padding=1)))
    x = F.relu(_bn(stem["bn2"], _conv(stem["conv2"], x, padding=1)))
    x = F.relu(_bn(stem["bn3"], _conv(stem["conv3"], x, padding=1)))
    x = _avg_pool(x, 2)
    for stage, blocks in enumerate(cfg.layers):
        for b in range(blocks):
            x = _bottleneck(params[f"layer{stage + 1}"][b], x, 2 if stage and not b else 1)
    return _attn_pool(params["attnpool"], x, cfg.heads)


def init_clip_resnet(gen: torch.Generator, cfg: ResNetConfig) -> Params:
    """Random init (f32, CPU) from ``gen``, convolutions OIHW."""
    def conv(cin, cout, k):
        return {"w": (cin * k * k) ** -0.5 * torch.randn(cout, cin, k, k, generator=gen)}

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
                "var": torch.ones(c)}

    def bottleneck(cin, planes, stride):
        p = {"conv1": conv(cin, planes, 1), "bn1": bn(planes),
             "conv2": conv(planes, planes, 3), "bn2": bn(planes),
             "conv3": conv(planes, planes * 4, 1), "bn3": bn(planes * 4)}
        if stride > 1 or cin != planes * 4:
            p["downsample"] = {"conv": conv(cin, planes * 4, 1), "bn": bn(planes * 4)}
        return p

    w = cfg.width
    params: Params = {"stem": {"conv1": conv(3, w // 2, 3), "bn1": bn(w // 2),
                               "conv2": conv(w // 2, w // 2, 3), "bn2": bn(w // 2),
                               "conv3": conv(w // 2, w, 3), "bn3": bn(w)}}
    cin = w
    for stage, blocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        params[f"layer{stage + 1}"] = []
        for b in range(blocks):
            params[f"layer{stage + 1}"].append(
                bottleneck(cin, planes, 2 if stage and not b else 1))
            cin = planes * 4

    c = cfg.embed_dim

    def lin(cin_, cout_):
        return {"w": cin_ ** -0.5 * torch.randn(cin_, cout_, generator=gen),
                "b": torch.zeros(cout_)}

    params["attnpool"] = {
        "positional_embedding": c ** -0.5 * torch.randn(cfg.spacial_dim ** 2 + 1, c,
                                                        generator=gen),
        "q_proj": lin(c, c), "k_proj": lin(c, c), "v_proj": lin(c, c),
        "c_proj": lin(c, cfg.output_dim),
    }
    return params
