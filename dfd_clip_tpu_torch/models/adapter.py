"""Compression-invariant K/V adapter and its standalone pretrainer
(counterpart of dfd_clip_tpu/models/adapter.py: ``STRUCT_TYPES``,
``AdapterConfig``, ``init_adapter``, ``apply_adapter``,
``calibrate_bn_stats`` and ``CompInvEncoder``).

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
  in f32 and cast back to the activation dtype; on a data-parallel layout
  the batch statistics, and CompInv's loss maps, span the global batch
  through ``spmd.data_sum``, as JAX's reductions over its sharded batch do.

The adapter's linears are plain matrix products outside any kernel (the
JAX package leaves them to XLA): ``layers.linear``. Its GELU is JAX's
default ``jax.nn.gelu``, the tanh approximation.

``CompInvEncoder`` runs the frozen CLIP tower (``clip_vision_kv``, the
kept layers' unpadded export, the port's kernels on the card, under
``torch.no_grad``) and the adapter on raw / c23 clip pairs, with the
reference's recon and match losses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import layers
from ..ops import spmd

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
    training, the stored running statistics in evaluation, in f32. The
    batch statistics are the global batch's on a data-parallel layout: the
    mean from Σy and the row count summed over the data ranks, then the
    biased variance from Σ(y - mean)² summed over them (``spmd.data_sum``,
    through which the gradient flows)."""
    f32 = y.float()
    if train:
        dims = (0, 2, 3)
        t = f32.shape[1]
        rows = torch.full((1,), float(f32.numel() // t), device=f32.device)
        packed = spmd.data_sum(torch.cat([f32.sum(dim=dims), rows]))
        mean = (packed[:t] / packed[t]).reshape(1, t, 1, 1)
        var = (spmd.data_sum((f32 - mean).square().sum(dim=dims)) / packed[t]
               ).reshape(1, t, 1, 1)
    else:
        mean = p["mean"].float()[None, :, None, None]
        var = p["var"].float()[None, :, None, None]
    out = (f32 - mean) * torch.rsqrt(var + eps)
    out = out * p["scale"].float()[None, :, None, None] + p["bias"].float()[None, :, None, None]
    return out.to(y.dtype)


def _apply_branch(p: Params, x: torch.Tensor, cfg: AdapterConfig,
                  gen: Optional[torch.Generator], train: bool) -> torch.Tensor:
    st = cfg.struct_type
    rows = spmd.data_rows(x.shape[0]) if train else None

    def drop(v, rate):
        return layers.dropout(v, rate, gen, train, rows)

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
    from ``gen``, for the global batch on a data-parallel layout
    (``spmd.data_rows``)."""
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


def calibrate_bn_stats(params: Params, kv_batches, cfg: AdapterConfig,
                       reduce_sum=None) -> Params:
    """Fill the "768-bn" running statistics from data in one pass: the
    population mean and variance (f64 sums) of each branch's post-fc1
    activations per frame channel, over ``kv_batches`` (an iterable of raw
    encoder exports {"k", "v"}: (Lsel, B, T, P, H, D), tensors or arrays).
    ``reduce_sum`` (a multi-rank run's in-place SUM over the ranks) adds
    every rank's counts and sums before the statistics are taken, so that
    they are the population's. Other structs come back unchanged."""
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
    if reduce_sum is not None:
        for subject in ("k", "v"):
            for st in stats[subject]:
                packed = reduce_sum(torch.cat([torch.tensor([float(st[0])], dtype=torch.float64),
                                               st[1], st[2]]))
                c = (packed.numel() - 1) // 2
                st[0], st[1], st[2] = packed[0], packed[1:1 + c], packed[1 + c:]
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


class CompInvEncoder:
    """Standalone adapter pretrainer (reference src/models.py:943-1046):
    frozen CLIP -> adapter -> (recon, match) over raw / c23 pairs, the
    clips of a batch interleaved in pairs (rows 2i, 2i + 1), ``comp_is_raw``
    telling which member is raw. Losses (src/models.py:1002-1040):
    mode 0: recon = ||raw_orig - raw_adapted||, match = ||raw_adapted -
    c23_adapted||; mode 1: recon = 0, match = ||raw_orig - c23_adapted||;
    each the L1 maps summed over layers, pairs, K and V, then the reference's
    per-patch L2 norm of the frame-averaged map. On a data-parallel layout
    the maps are summed over the data ranks' pairs (the global batch's)
    before the norm, so every rank holds the global batch's losses."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "CompInvEncoder"
        C.architecture = "ViT-B/16"
        C.decode_mode = "stride"
        C.decode_stride = 2
        C.decode_indices = []
        C.adapter = CN(new_allowed=True)
        C.dropout = 0.0
        C.mode = 0
        return C

    def __init__(self, config, num_frames: int = 50, compute_dtype=torch.bfloat16,
                 device="cuda"):
        from . import clip_vit
        from .detector import resolve_layer_indices
        from ..device import resolve_device

        if config.adapter.struct.type not in STRUCT_TYPES:
            raise NotImplementedError(f"Unknown adapter struct: {config.adapter.struct.type}")
        self.device = resolve_device(device)
        self.config = config
        self.vit_cfg = clip_vit.ARCHITECTURES[config.architecture]
        self.layer_indices = resolve_layer_indices(config, self.vit_cfg.layers)
        self.mode = int(config.mode)
        if self.mode not in (0, 1):
            raise ValueError(f"CompInvEncoder mode {self.mode} (0 or 1)")
        self.num_frames = num_frames
        self.compute_dtype = compute_dtype
        self.adapter_cfg = AdapterConfig(
            struct_type=config.adapter.struct.type,
            inner_dim=int(config.adapter.struct.get("x", self.vit_cfg.width)),
            width=self.vit_cfg.width,
            num_layers=len(self.layer_indices),
            dropout=config.dropout,
            num_frames=num_frames,
            patches=self.vit_cfg.num_patches,
        )

    def init_params(self, gen: torch.Generator, encoder_params: Optional[Params] = None
                    ) -> Params:
        """Random f32 params (CPU) from ``gen``: the encoder (unless given),
        then the adapter."""
        from . import clip_vit

        if encoder_params is None:
            encoder_params = clip_vit.init_clip_vision(gen, self.vit_cfg)
        return {"encoder": encoder_params, "adapter": init_adapter(gen, self.adapter_cfg)}

    def partition_params(self, params: Params) -> Tuple[Params, Params]:
        """(trainable, frozen): the adapter trains, the encoder is frozen."""
        return {"adapter": params["adapter"]}, {"encoder": params["encoder"]}

    def prepare_params(self, params: Params) -> Params:
        """Params on the model's device: matrix weights (``w``, ``conv1``)
        in the compute dtype, everything else in f32."""
        from .detector import _map_tree

        def place(path, leaf):
            dtype = self.compute_dtype if path[-1] == "w" else torch.float32
            return leaf.to(device=self.device, dtype=dtype).contiguous()

        return _map_tree(place, params)

    def optimizer_spec(self):
        return {"name": "adamw", "weight_decay": 0.01}

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 (..., 3, H, W) -> resized, CLIP-normalised float on the
        device (the Detector's transform)."""
        from ..ops import image_ops
        from .detector import CLIP_MEAN, CLIP_STD

        if x.is_floating_point():
            return x
        return image_ops.resize_crop_normalize(x, self.vit_cfg.input_resolution, CLIP_MEAN,
                                               CLIP_STD)

    def predict(self, params: Params, x, *, train: bool = False,
                gen: Optional[torch.Generator] = None):
        """(adapted, raw) K/V of a clip batch x (B, T, 3, H, W): raw
        {"k", "v"} (Lsel, B, T, P, H, D), the tower's unpadded export
        without CLS, computed under no_grad; adapted, lists of per-layer
        (B, T, P, H, D) (apply_adapter), under autograd with ``train``."""
        from . import clip_vit

        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=self.device)
        cfg = self.vit_cfg
        with torch.no_grad():
            x = self.preprocess(x)
            b, t = x.shape[:2]
            kvs = clip_vit.clip_vision_kv(params["encoder"], x.reshape((b * t,) + x.shape[2:]),
                                          cfg, self.compute_dtype,
                                          keep_layers=tuple(self.layer_indices), drop_cls=True)
            kv_raw = {s: kvs[s].reshape(len(self.layer_indices), b, t, cfg.num_patches,
                                        cfg.heads, cfg.head_dim) for s in ("k", "v")}
        adapted = apply_adapter(params["adapter"], kv_raw, self.adapter_cfg, train=train, gen=gen)
        return adapted, kv_raw

    def forward(self, params: Params, x, comp_is_raw, *, train: bool = True,
                gen: Optional[torch.Generator] = None):
        """(recon, match) scalars for x (B, T, 3, H, W), raw / c23 pairs
        interleaved, and comp_is_raw (B,) bool."""
        adapted, raw = self.predict(params, x, train=train, gen=gen)
        nsel = len(self.layer_indices)
        _, b, t, p, h, d = raw["k"].shape
        w = b // 2
        raw_first = torch.as_tensor(comp_is_raw, device=self.device).bool().reshape(w, 2)[:, 0]
        sel = raw_first.reshape(w, 1, 1, 1, 1)

        def pair_order(feats: torch.Tensor):
            """(B, T, P, H, D) -> its (raw, c23) members, each (w, T, P, H, D)."""
            pairs = feats.reshape(w, 2, t, p, h, d)
            return (torch.where(sel, pairs[:, 0], pairs[:, 1]),
                    torch.where(sel, pairs[:, 1], pairs[:, 0]))

        zeros = torch.zeros((t, p, h, d), dtype=torch.float32, device=self.device)
        recon_diff, match_diff = zeros, zeros
        for s in ("k", "v"):
            for i in range(nsel):
                a_raw, a_c23 = pair_order(adapted[s][i])
                o_raw, _ = pair_order(raw[s][i])
                if self.mode == 0:
                    recon_diff = recon_diff + (o_raw.float() - a_raw.float()).abs().sum(0)
                    match_diff = match_diff + (a_raw.float() - a_c23.float()).abs().sum(0)
                else:
                    match_diff = match_diff + (o_raw.float() - a_c23.float()).abs().sum(0)
        # the maps summed over the global batch's pairs and divided by their
        # count before the norm, as JAX's loss over the sharded batch
        recon_diff, match_diff = spmd.data_sum(recon_diff), spmd.data_sum(match_diff)
        layout = spmd.spmd_layout()
        denom = w * (layout.data_parallel if layout is not None else 1) * nsel * 2

        def per_patch(diff: torch.Tensor) -> torch.Tensor:
            # the reference's reshape of the (T, P, H, D) map to (P, T, -1):
            # a reinterpretation of its memory, not a transpose
            # (src/models.py:1037-1038)
            return torch.linalg.vector_norm((diff / denom).reshape(p, t, -1).mean(dim=1)) / p

        return per_patch(recon_diff), per_patch(match_diff)
