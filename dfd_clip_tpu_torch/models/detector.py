"""Deepfake video detector (counterpart of dfd_clip_tpu/models/detector.py).

uint8 frames -> device-side resize/crop/normalize -> frozen ViT with the
stacked, 8-row-padded K/V export -> dual-activation decoder -> logits
L2-normalised to norm 5 -> per-task losses. The tower is a CLIP ViT
(``foundation`` "clip" or "farl", models/clip_vit.py) or DINOv2
(``foundation`` "dinov2", models/dinov2_vit.py, ImageNet normalisation, an
unpadded export; as in the JAX package it ignores ``compute_int8`` and
``kv_dtype``). The frozen encoder always runs
under ``torch.no_grad``; with ``train=True`` the decoder runs under autograd
(its attention's Function saves the K/V export for its backward, so the
export must not be an inference-mode tensor). ``op_mode.compute_int8`` runs
the W8A8 tower on weights that ``prepare_params`` pre-quantises, and
``op_mode.kv_dtype = "int8_rows"`` keeps the K/V export int8 with per-row
scales into the decoder; both are inference-only here. ``encoder_kernels``
(``EncoderKernels``) chooses the CLIP encoder's kernel paths, as the JAX
package's DFD_FUSED_BLOCK, DFD_MEGAKERNEL and DFD_INT8_ATTN do (the tower's
export is unpadded); DINOv2 ignores it, as JAX's DINOv2 tower ignores them.
``predict(patch_indices=...)`` gathers each kept layer's patches
before the decoder (bf16 and int8_rows K/V alike). The adapter,
``kv_dtype = "int8"``, the compression and temporal losses, ``ema_frame``
and ``patch_mask`` are not ported yet and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import clip_vit, decoder as decoder_lib, dinov2_vit
from ..device import resolve_device
from ..ops import image_ops

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- loss factories (per-sample losses, reduction left to the caller) ----------

def mse():
    """Expectation-vs-bpm squared error over a 140-bin distribution head."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        bins = torch.arange(140, dtype=torch.float32, device=logits.device)
        expect = torch.softmax(logits[:, :140].float(), dim=-1) @ bins
        return torch.square(expect - y.float()) / 1000.0

    return per_sample


def kl_div():
    """Elementwise KL(target || softmax(logits)), reduction='none'."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        log_q = torch.log_softmax(logits.float(), dim=1)
        y = y.float()
        # p * (log p - log q), with 0 log 0 := 0
        log_p = torch.where(y > 0, torch.log(y.clamp_min(1e-38)), 0.0)
        return y * (log_p - log_q)

    return per_sample


def auc_roc():
    """Per-sample cross-entropy against class indices or soft targets."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        log_p = torch.log_softmax(logits.float(), dim=-1)
        if y.ndim == 1 and not y.is_floating_point():
            targets = F.one_hot(y.long(), logits.shape[-1]).float()
        else:
            targets = y.float()
        return -torch.sum(targets * log_p, dim=-1)

    return per_sample


LOSSES = {"mse": mse, "kl_div": kl_div, "auc_roc": auc_roc}


def resolve_layer_indices(config, n_layers: int) -> Tuple[int, ...]:
    """decode_mode stride/index -> kept encoder layers."""
    if config.decode_mode == "stride":
        return tuple(range(0, n_layers, config.decode_stride))
    if config.decode_mode == "index":
        return tuple(config.decode_indices)
    raise ValueError(f"Unknown decode mode: {config.decode_mode}")


@dataclasses.dataclass(frozen=True)
class EncoderKernels:
    """The CLIP encoder's kernel paths (models/clip_vit.py clip_vision_kv),
    with the JAX package's defaults: ``block`` "auto" | "full" | "split"
    (DFD_FUSED_BLOCK), ``tower`` the whole-encoder tower (DFD_MEGAKERNEL=1),
    ``int8_attn`` "0" | "1" | "qk" (DFD_INT8_ATTN, compute_int8 only)."""
    block: str = "auto"
    tower: bool = False
    int8_attn: str = "0"


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


class Detector:
    """Config-constructed detector; compute methods are pure in ``params``."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN(new_allowed=True)
        C.name = "Detector"
        C.foundation = "clip"
        C.architecture = "ViT-B/16"
        C.decode_mode = "stride"
        C.decode_stride = 2
        C.decode_indices = []
        C.out_dim = []
        C.losses = []
        C.concat_ref = 0
        C.adapter = CN(new_allowed=True)
        C.adapter.type = "none"
        C.train_mode = CN(new_allowed=True)
        C.op_mode = CN(new_allowed=True)
        C.op_mode.temporal_position = 1
        C.dropout = 0.0
        C.weight_decay = 0.01
        C.optimizer = "sgd"
        return C

    def __init__(self, config, num_frames: int, compute_dtype=torch.bfloat16,
                 device="cuda", encoder_kernels: EncoderKernels = EncoderKernels()):
        if config.decode_mode not in ("stride", "index"):
            raise ValueError(f"Unknown decode mode: {config.decode_mode}")
        self.device = resolve_device(device)
        self.encoder_kernels = encoder_kernels
        self.config = config
        self.num_frames = num_frames
        self.compute_dtype = compute_dtype
        if config.foundation in ("clip", "farl"):
            self.vit_cfg = clip_vit.ARCHITECTURES[config.architecture]
            mean, std = CLIP_MEAN, CLIP_STD
        elif config.foundation == "dinov2":
            self.vit_cfg = dinov2_vit.ARCHITECTURES[config.architecture]
            mean, std = IMAGENET_MEAN, IMAGENET_STD
        else:
            raise NotImplementedError(f"Unknown foundation: {config.foundation}")
        if config.adapter.type != "none":
            raise NotImplementedError("the CompInv adapter is not ported yet")
        op = config.op_mode
        clip = config.foundation != "dinov2"
        if clip and op.get("kv_dtype", "auto") == "int8":
            raise NotImplementedError("kv_dtype 'int8' (per-(layer, head) scales) is not "
                                      "ported yet")
        self.compute_int8 = clip and bool(op.get("compute_int8", 0))
        if not all(isinstance(loss, str) for loss in config.losses):
            raise NotImplementedError("loss arguments are not ported yet")
        self.losses = [LOSSES[loss]() for loss in config.losses]
        self.transform = TransformSpec(self.vit_cfg.input_resolution, mean, std)
        self.layer_indices = resolve_layer_indices(config, self.vit_cfg.layers)
        self.decoder_cfg = decoder_lib.DecoderConfig(
            width=self.vit_cfg.width,
            heads=self.vit_cfg.heads,
            num_frames=num_frames,
            layer_indices=self.layer_indices,
            out_dims=tuple(config.out_dim),
            dropout=config.dropout,
            temporal_position=bool(op.get("temporal_position", 1)),
            attn_mode=tuple(op.attn_mode.split("+")) if "attn_mode" in op else (),
            aug_query=bool(op.get("aug_query", 0)),
            global_prediction=bool(op.get("global_prediction", 0)),
            concat_ref=bool(config.concat_ref),
        )

    # -- params ---------------------------------------------------------------
    def init_params(self, gen: torch.Generator,
                    encoder_params: Optional[Params] = None) -> Params:
        """Random f32 params (CPU) from ``gen``; the decoder's LayerNorms and
        MLPs are seeded from the encoder's kept layers."""
        if encoder_params is None:
            init = dinov2_vit.init_dinov2 if self._dinov2() else clip_vit.init_clip_vision
            encoder_params = init(gen, self.vit_cfg)
        return {
            "encoder": encoder_params,
            "decoder": decoder_lib.init_decoder(gen, self.decoder_cfg,
                                                encoder_params["blocks"]),
        }

    def prepare_params(self, params: Params) -> Params:
        """Move params to the detector's device, with the matrix weights
        (linear ``w``, ``conv1``) in the compute dtype and everything else
        (LayerNorms, biases, embeddings, task projections, int8 scales) in
        f32. With ``compute_int8`` the tower's block weights are first
        quantised from f32 (clip_vit.prepare_int8_params), and their int8
        ``wq`` stay int8."""
        if self.compute_int8:
            params = {**params, "encoder": clip_vit.prepare_int8_params(params["encoder"])}

        def place(path, leaf):
            if leaf.dtype == torch.int8:
                return leaf.to(device=self.device).contiguous()
            is_matrix = path[-1] == "w" and "task_projections" not in path
            dtype = self.compute_dtype if is_matrix else torch.float32
            return leaf.to(device=self.device, dtype=dtype).contiguous()

        return _map_tree(place, params)

    def partition_params(self, params: Params) -> Tuple[Params, Params]:
        """(trainable, frozen): the encoder never trains."""
        trainable = {k: v for k, v in params.items() if k != "encoder"}
        return trainable, {"encoder": params["encoder"]}

    def optimizer_spec(self):
        return {"name": self.config.optimizer, "weight_decay": self.config.weight_decay}

    # -- compute --------------------------------------------------------------
    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 (..., 3, H, W) -> normalized float (..., 3, n, n) on device."""
        if x.is_floating_point():
            return x
        return image_ops.resize_crop_normalize(x, self.transform.size, self.transform.mean,
                                               self.transform.std)

    def _dinov2(self) -> bool:
        return self.config.foundation == "dinov2"

    def _kv_rows8(self) -> bool:
        """op_mode.kv_dtype "int8_rows": per-row int8 K/V that stay
        quantised into the decoder (CLIP towers only)."""
        return not self._dinov2() and self.config.op_mode.get("kv_dtype", "auto") == "int8_rows"

    def encode_kv(self, params: Params, x: torch.Tensor,
                  pad_tokens: bool = False) -> Dict[str, torch.Tensor]:
        """(B, T, 3, H, W) -> {"k", "v"}: (Lsel, B, T, P, H, D); with
        ``pad_tokens`` a CLIP tower's P is zero-padded to a multiple of 8 (the
        DINOv2 export and the whole-encoder tower's are never padded). With
        int8_rows also {"k_scale", "v_scale"}: (Lsel, B, T, P, 1) f32."""
        b, t = x.shape[:2]
        frames = x.reshape((b * t,) + tuple(x.shape[2:]))
        if self._dinov2():
            kvs = dinov2_vit.dinov2_kv(params["encoder"], frames, self.vit_cfg,
                                       self.compute_dtype, keep_layers=self.layer_indices,
                                       drop_cls=True)
        else:
            kvs = clip_vit.clip_vision_kv(
                params["encoder"], frames, self.vit_cfg, self.compute_dtype,
                keep_layers=self.layer_indices, drop_cls=True, pad_tokens=pad_tokens,
                compute_int8=self.compute_int8, kv_int8_rows=self._kv_rows8(),
                **dataclasses.asdict(self.encoder_kernels))
        return {s: f.reshape((f.shape[0], b, t) + tuple(f.shape[2:])) for s, f in kvs.items()}

    def predict(self, params: Params, x, m, *, train: bool = False,
                gen: Optional[torch.Generator] = None, patch_indices=None,
                with_video_features: bool = False):
        """Logits for a clip batch: x (B, T, 3, H, W) uint8 or float, m (B, T)
        bool, as arrays or tensors. Returns (task logits list, features).
        ``train`` runs the decoder's differentiable composition (dropout
        drawn from ``gen``, a generator on the detector's device).
        ``patch_indices`` (Lsel, num_select) keeps, of each kept layer's
        export, the patches it lists (src/models.py:511-544); the gathered
        rows are all real patches, so no pad row is masked."""
        if train and (self.compute_int8 or self._kv_rows8()):
            raise NotImplementedError("training with compute_int8 or int8_rows K/V is not "
                                      "ported yet")
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=self.device)
        m = torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                            device=self.device).bool()
        with torch.no_grad():
            x = self.preprocess(x)
            # the export's patch axis is 8-aligned (196 -> 200, not on the
            # tower); the decoder masks the pad rows as keys through patch_valid
            kvs = self.encode_kv(params, x, pad_tokens=True)
            patch_valid = self.vit_cfg.num_patches
            if patch_indices is not None:
                # per layer on the patch axis; int8_rows scales (Lsel, B, T, P, 1) alike
                idx = torch.as_tensor(patch_indices, device=self.device).long()
                kvs = {s: torch.stack([f[i].index_select(2, idx[i]) for i in range(len(f))])
                       for s, f in kvs.items()}
                patch_valid = None
        with contextlib.nullcontext() if train else torch.no_grad():
            task_logits, video = decoder_lib.apply_decoder(
                params["decoder"], kvs, m, self.decoder_cfg, train=train, gen=gen,
                patch_valid=patch_valid)
            task_logits = [5.0 * t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-10)
                           for t in task_logits]
        features = {"video": video} if with_video_features else {}
        return task_logits, features

    def forward(self, params: Params, x, y: Sequence[Optional[torch.Tensor]], m,
                comp_is_raw: Optional[torch.Tensor] = None, *, train: bool = False,
                single_task: Optional[int] = None, gen: Optional[torch.Generator] = None):
        """Per-task losses and logits for a clip batch.

        y: per-task labels on the detector's device (None = task inactive);
        comp_is_raw: (B,) bool compression flags (``train_mode.nerf_raw``).
        Returns (task_losses, task_logits), and with ``train`` also the
        auxiliary losses (an empty dict: none is ported yet)."""
        tm, op = self.config.train_mode, self.config.op_mode
        unported = [name for name, on in (("compression", "compression" in tm),
                                          ("temporal", "temporal" in tm),
                                          ("patch_mask", "patch_mask" in tm),
                                          ("ema_frame", bool(op.get("ema_frame", 0)))) if on]
        if unported:
            raise NotImplementedError(f"{', '.join(unported)} not ported yet")
        b = x.shape[0]
        task_logits, _ = self.predict(params, x, m, train=train, gen=gen)
        task_losses = [
            loss_fn(logits, labels)
            if labels is not None and (single_task is None or i == single_task)
            else torch.zeros(b, device=self.device)
            for i, (loss_fn, logits, labels) in enumerate(zip(self.losses, task_logits, y))
        ]
        if not train:
            return task_losses, task_logits
        if "nerf_raw" in tm:
            nerf_power = min(tm.nerf_raw, 0)
            scale = torch.where(comp_is_raw.to(self.device), nerf_power, 2.0 - nerf_power)
            task_losses = [loss * scale.reshape((b,) + (1,) * (loss.ndim - 1))
                           for loss in task_losses]
        return task_losses, task_logits, {}
