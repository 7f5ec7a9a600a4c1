"""Compression-invariant K/V adapter (counterpart of the adapter half of
dfd_clip_tpu/models/adapter.py: ``STRUCT_TYPES``, ``AdapterConfig``,
``init_adapter``, ``apply_adapter`` and ``calibrate_bn_stats``).

Per kept encoder layer and per subject ("k" / "v") a small bottleneck MLP
transforms the exported K/V stream, residual-added except for the "linear"
struct. The MLP sees (B, T, P, H*D) and hands back the head-split form.

Differences from the JAX package, by design:

* ``apply_adapter`` returns each subject as a LIST of per-layer
  (B, T, P, H, D) tensors, not a re-stacked (Lsel, ...) buffer: the decoder
  reads each block's K/V from its own tensor, so each attention call's
  backward hands back that layer's own dK/dV (no zero stack to sum);
* dropout draws come from the caller's ``torch.Generator`` in the JAX
  package's order (subject "k" then "v", layers in order, each branch's
  dropouts in order), so the k- and v-branch masks are independent; the
  draws are not JAX's;
* the "768-bn" batch statistics and the "nln" joint LayerNorm are computed
  in f32 and cast back to the activation dtype.

The adapter's linears are plain matrix products outside any kernel (the
JAX package leaves them to XLA): ``layers.linear``. Its GELU is JAX's
default ``jax.nn.gelu``, the tanh approximation. The standalone
``CompInvEncoder`` pretrainer is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import layers

Params = Dict[str, Any]

STRUCT_TYPES = (
    "768-x-768",
    "legacy-768-x-768",
    "768-x-768-nln",
    "768-x-768-ln",
    "768-x-768-z0",
    "768-bn",
    "768-xxx-768",
    "linear",
)


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    struct_type: str = "768-x-768"
    inner_dim: int = 768
    width: int = 768
    num_layers: int = 6  # number of kept encoder layers
    dropout: float = 0.0
    num_frames: int = 50
    patches: int = 196

    @property
    def residual(self) -> bool:
        return self.struct_type != "linear"


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _init_branch(gen: torch.Generator, cfg: AdapterConfig) -> Params:
    w, x = cfg.width, cfg.inner_dim
    st = cfg.struct_type
    if st in ("768-x-768", "legacy-768-x-768", "768-x-768-nln", "768-x-768-ln", "768-x-768-z0"):
        if st == "768-x-768-nln":
            # LayerNorm((patches, inner)): a joint (P, X) affine
            ln = {"scale": torch.ones(cfg.patches, x), "bias": torch.zeros(cfg.patches, x)}
        else:
            ln = layers.init_layer_norm(x)
        p = {
            "fc1": layers.init_linear(gen, w, x, bias=False),
            "ln": ln,
            "fc2": layers.init_linear(gen, x, w, bias=False),
        }
        if st == "768-x-768-z0":
            p["ln"]["scale"] = torch.zeros_like(p["ln"]["scale"])
            p["fc2"]["w"] = torch.zeros_like(p["fc2"]["w"])
        return p
    if st == "768-bn":
        f = cfg.num_frames
        return {
            "fc1": layers.init_linear(gen, w, w, bias=False),
            # BatchNorm2d over the frame axis; mean / var are the running
            # statistics read in evaluation (calibrate_bn_stats fills them)
            "bn": {"scale": torch.ones(f), "bias": torch.zeros(f),
                   "mean": torch.zeros(f), "var": torch.ones(f)},
        }
    if st == "768-xxx-768":
        return {
            "fc1": layers.init_linear(gen, w, x, bias=False),
            "fc2": layers.init_linear(gen, x, x, bias=False),
            "fc3": layers.init_linear(gen, x, w, bias=False),
        }
    if st == "linear":
        return {"fc1": {"w": torch.eye(w)}}
    raise NotImplementedError(f"Unknown adapter struct: {st}")


def _joint_layer_norm(p: Params, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm((patches, inner)): statistics over the last two axes, a
    (P, X) elementwise affine, in f32."""
    f32 = y.float()
    mu = f32.mean(dim=(-2, -1), keepdim=True)
    var = (f32 - mu).square().mean(dim=(-2, -1), keepdim=True)
    out = (f32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return out.to(y.dtype)


def _batch_norm(p: Params, y: torch.Tensor, train: bool, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d over the frame axis of (B, T, P, X): batch statistics in
    training, the stored running statistics in evaluation, in f32."""
    f32 = y.float()
    if train:
        mean = f32.mean(dim=(0, 2, 3), keepdim=True)
        var = (f32 - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = p["mean"].float()[None, :, None, None]
        var = p["var"].float()[None, :, None, None]
    out = (f32 - mean) * torch.rsqrt(var + eps)
    out = out * p["scale"].float()[None, :, None, None] + p["bias"].float()[None, :, None, None]
    return out.to(y.dtype)


def _apply_branch(p: Params, x: torch.Tensor, cfg: AdapterConfig,
                  gen: Optional[torch.Generator], train: bool) -> torch.Tensor:
    st = cfg.struct_type

    def drop(v, rate):
        return layers.dropout(v, rate, gen, train)

    if st == "768-x-768":
        y = layers.layer_norm(p["ln"], _gelu(layers.linear(p["fc1"], x)))
        y = layers.linear(p["fc2"], drop(y, cfg.dropout / 5))
        return drop(y, cfg.dropout)
    if st == "legacy-768-x-768":
        y = layers.layer_norm(p["ln"], _gelu(layers.linear(p["fc1"], x)))
        return drop(layers.linear(p["fc2"], y), cfg.dropout)
    if st in ("768-x-768-nln", "768-x-768-ln", "768-x-768-z0"):
        y = layers.linear(p["fc1"], x)
        y = (_joint_layer_norm(p["ln"], y) if st == "768-x-768-nln"
             else layers.layer_norm(p["ln"], y))
        y = drop(_gelu(y), cfg.dropout / 10)
        return drop(layers.linear(p["fc2"], y), cfg.dropout)
    if st == "768-bn":
        y = _batch_norm(p["bn"], layers.linear(p["fc1"], x), train)
        return drop(y, cfg.dropout)
    if st == "768-xxx-768":
        y = drop(_gelu(layers.linear(p["fc1"], x)), cfg.dropout / 5)
        y = drop(_gelu(layers.linear(p["fc2"], y)), cfg.dropout / 5)
        return drop(layers.linear(p["fc3"], y), cfg.dropout)
    if st == "linear":
        return drop(layers.linear(p["fc1"], x), cfg.dropout)
    raise NotImplementedError(st)


def init_adapter(gen: torch.Generator, cfg: AdapterConfig) -> Params:
    """Random f32 adapter params (CPU) from ``gen``: {"blocks": [{"k": branch,
    "v": branch}] * num_layers}, the JAX package's tree."""
    return {"blocks": [{"k": _init_branch(gen, cfg), "v": _init_branch(gen, cfg)}
                       for _ in range(cfg.num_layers)]}


def apply_adapter(params: Params, kvs: Dict[str, Any], cfg: AdapterConfig, *,
                  train: bool = False, gen: Optional[torch.Generator] = None
                  ) -> Dict[str, List[torch.Tensor]]:
    """Adapt {"k", "v"}: (Lsel, B, T, P, H, D) stacked, or lists of per-layer
    (B, T, P, H, D), layer by layer with the residual add -> {"k", "v"}:
    lists of per-layer (B, T, P, H, D) tensors. Dropout (``train``) draws
    from ``gen``."""
    out = {}
    for subject in ("k", "v"):
        adapted = []
        for i, feats in enumerate(kvs[subject]):
            b, t, p, h, d = feats.shape
            y = _apply_branch(params["blocks"][i][subject], feats.reshape(b, t, p, h * d), cfg,
                              gen, train).reshape(b, t, p, h, d)
            adapted.append(feats + y if cfg.residual else y)
        out[subject] = adapted
    return out


def calibrate_bn_stats(params: Params, kv_batches, cfg: AdapterConfig) -> Params:
    """Fill the "768-bn" running statistics from data in one pass: the
    population mean and variance (f64 sums) of each branch's post-fc1
    activations per frame channel, over ``kv_batches`` (an iterable of raw
    encoder exports {"k", "v"}: (Lsel, B, T, P, H, D), tensors or arrays).
    Other structs come back unchanged."""
    if cfg.struct_type != "768-bn":
        return params
    stats = None   # [subject][layer] -> [count, sum, sum of squares] per frame channel
    for kvs in kv_batches:
        if stats is None:
            stats = {s: [[0, 0.0, 0.0] for _ in range(len(kvs["k"]))] for s in ("k", "v")}
        for subject in ("k", "v"):
            for i, feats in enumerate(kvs[subject]):
                feats = torch.as_tensor(np.asarray(feats) if not torch.is_tensor(feats)
                                        else feats)
                b, t, p, h, d = feats.shape
                fc1 = params["blocks"][i][subject]["fc1"]
                y = layers.linear(fc1, feats.reshape(b, t, p, h * d)).detach().cpu().double()
                st = stats[subject][i]
                st[0] += y.shape[0] * y.shape[2] * y.shape[3]
                st[1] = st[1] + y.sum(dim=(0, 2, 3))
                st[2] = st[2] + (y * y).sum(dim=(0, 2, 3))
    if stats is None:
        raise ValueError("calibrate_bn_stats needs at least one batch")
    blocks = []
    for i, blk in enumerate(params["blocks"]):
        nb = dict(blk)
        for subject in ("k", "v"):
            n, sm, sq = stats[subject][i]
            mean = sm / n
            var = (sq / n - mean * mean).clamp_min(0.0)
            bn = dict(nb[subject]["bn"])
            dev = bn["mean"].device
            bn["mean"], bn["var"] = mean.float().to(dev), var.float().to(dev)
            nb[subject] = {**nb[subject], "bn": bn}
        blocks.append(nb)
    return {**params, "blocks": blocks}
