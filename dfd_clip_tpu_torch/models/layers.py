"""Shared functional primitives (counterpart of dfd_clip_tpu/models/layers.py).

Plain functions over parameter dicts of tensors, with the reference's
numerics: LayerNorm computed in float32 and cast back, QuickGELU, and linear
layers whose weights are stored ``(in, out)`` and whose bias is added in the
activation dtype after the product.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, cast back."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b); w stored (in, out) and rounded to x's dtype; the product
    (f32 accumulate) is rounded to x's dtype before the bias is added in it."""
    y = (x.float() @ params["w"].to(x.dtype).float()).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def linear_f32_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with the bias added in f32 before the cast to x's dtype: the
    rounding point of the encoder block kernels."""
    return (x.float() @ w.to(x.dtype).float() + b.float()).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate, drawn
    from ``gen`` (a generator on x's device), and scale the kept ones by
    1 / (1 - rate). Identity outside training, at rate 0 or without a
    generator. The draws are not the JAX package's (other generator)."""
    if not train or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


# -- initializers -------------------------------------------------------------

def init_layer_norm(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True,
                std: float | None = None) -> Params:
    if std is None:
        std = in_dim ** -0.5
    p: Params = {"w": std * torch.randn(in_dim, out_dim, generator=gen)}
    if bias:
        p["b"] = torch.zeros(out_dim)
    return p
