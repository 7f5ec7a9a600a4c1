"""Shared functional primitives (counterpart of dfd_clip_tpu/models/layers.py).

Plain functions over parameter dicts of tensors, with the reference's
numerics: LayerNorm computed in float32 and cast back, QuickGELU, exact
GELU, and linear layers whose weights are stored ``(in, out)`` and whose
bias is added in the activation dtype after the product. ``linear`` on a
bf16 tensor on the card multiplies bf16 operands in cuBLAS (``torch.matmul``,
as the JAX package leaves these products to XLA), with f32 accumulation once
``device.resolve_device`` has turned off the reduced-precision reductions;
``layer_norm_rows`` is ``layer_norm`` through the port's row kernel on the
card, for the towers' XLA compositions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.int8 import w8a8_linear, weight_q

Params = Dict[str, Any]


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, cast back."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def layer_norm_rows(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """layer_norm over the last axis: csrc/layer_norm.cu (bf16 rows, f32
    statistics) for a tensor on the card, layer_norm for a CPU tensor."""
    if _cuda.on_cpu("layer_norm_rows", x):
        return layer_norm(params, x, eps)
    rows = x.reshape(-1, x.shape[-1])
    return _cuda.layer_norm_rows(rows, params["scale"].float(), params["bias"].float(),
                                 eps).reshape(x.shape)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, jax.nn.gelu(approximate=False), in x's dtype."""
    return F.gelu(x)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b); w stored (in, out) and rounded to x's dtype; the product
    (f32 accumulate, see the module note for bf16 on the card) is rounded to
    x's dtype before the bias is added in it."""
    w = params["w"].to(x.dtype)
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = x @ w
    else:
        y = (x.float() @ w.float()).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def linear_w8a8(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) as W8A8 (the JAX layers.linear_w8a8): x quantised per
    row as round(x / s * 127) (not the kernels' y * (127 / s)), the
    per-channel int8 weights of ``params`` ("wq" (N, K) and "ws" (1, N) when
    pre-quantised, else from "w"), an exact integer product, the f32
    dequant and bias, then x's dtype: ops/int8.py:w8a8_linear, whose
    kernels (quant_rows' "linear" form, then gemm_s8) run it on the card."""
    wq, w_scale = weight_q(params)
    y = w8a8_linear(x.reshape(-1, x.shape[-1]), wq, w_scale, params.get("b"))
    return y.reshape(*x.shape[:-1], -1)


def linear_f32_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with the bias added in f32 before the cast to x's dtype: the
    rounding point of the encoder block kernels."""
    return (x.float() @ w.to(x.dtype).float() + b.float()).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            train: bool, rows=None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate, drawn
    from ``gen`` (a generator on x's device), and scale the kept ones by
    1 / (1 - rate). Identity outside training, at rate 0 or without a
    generator. The draws are not the JAX package's (other generator).
    ``rows`` (n, slice), where x holds a data rank's rows of a global
    batch (ops/spmd.py:data_rows): the mask is drawn for all n rows and x
    takes its slice, so every rank draws from one stream and a row's mask
    is the one a single process draws for it."""
    if not train or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    shape = x.shape if rows is None else (rows[0],) + tuple(x.shape[1:])
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if rows is not None:
        mask = mask[rows[1]]
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
