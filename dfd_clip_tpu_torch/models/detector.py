"""Deepfake video detector, inference (counterpart of
dfd_clip_tpu/models/detector.py).

uint8 frames -> device-side resize/crop/normalize -> frozen ViT with the
stacked, 8-row-padded K/V export -> dual-activation decoder -> logits
L2-normalised to norm 5. The adapter, patch-index gathering and training are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import clip_vit, decoder as decoder_lib
from ..device import resolve_device
from ..ops import image_ops

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resolve_layer_indices(config, n_layers: int) -> Tuple[int, ...]:
    """decode_mode stride/index -> kept encoder layers."""
    if config.decode_mode == "stride":
        return tuple(range(0, n_layers, config.decode_stride))
    if config.decode_mode == "index":
        return tuple(config.decode_indices)
    raise ValueError(f"Unknown decode mode: {config.decode_mode}")


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
                 device="cuda"):
        if config.decode_mode not in ("stride", "index"):
            raise ValueError(f"Unknown decode mode: {config.decode_mode}")
        self.device = resolve_device(device)
        self.config = config
        self.num_frames = num_frames
        self.compute_dtype = compute_dtype
        if config.foundation not in ("clip", "farl"):
            raise NotImplementedError(f"foundation {config.foundation!r} is not ported yet")
        if config.adapter.type != "none":
            raise NotImplementedError("the CompInv adapter is not ported yet")
        op = config.op_mode
        if op.get("compute_int8", 0) or op.get("kv_dtype", "auto") not in ("auto", "bf16"):
            raise NotImplementedError("int8 modes are not ported yet")
        self.vit_cfg = clip_vit.ARCHITECTURES[config.architecture]
        self.transform = TransformSpec(self.vit_cfg.input_resolution, CLIP_MEAN, CLIP_STD)
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
            encoder_params = clip_vit.init_clip_vision(gen, self.vit_cfg)
        return {
            "encoder": encoder_params,
            "decoder": decoder_lib.init_decoder(gen, self.decoder_cfg,
                                                encoder_params["blocks"]),
        }

    def prepare_params(self, params: Params) -> Params:
        """Move params to the detector's device, with the matrix weights
        (linear ``w``, ``conv1``) in the compute dtype and everything else
        (LayerNorms, biases, embeddings, task projections) in f32."""
        def place(path, leaf):
            is_matrix = path[-1] == "w" and "task_projections" not in path
            dtype = self.compute_dtype if is_matrix else torch.float32
            return leaf.to(device=self.device, dtype=dtype).contiguous()

        return _map_tree(place, params)

    # -- compute --------------------------------------------------------------
    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 (..., 3, H, W) -> normalized float (..., 3, n, n) on device."""
        if x.is_floating_point():
            return x
        return image_ops.resize_crop_normalize(x, self.transform.size, self.transform.mean,
                                               self.transform.std)

    def encode_kv(self, params: Params, x: torch.Tensor,
                  pad_tokens: bool = False) -> Dict[str, torch.Tensor]:
        """(B, T, 3, H, W) -> {"k", "v"}: (Lsel, B, T, P, H, D); with
        ``pad_tokens`` P is zero-padded to a multiple of 8."""
        b, t = x.shape[:2]
        frames = x.reshape((b * t,) + tuple(x.shape[2:]))
        kvs = clip_vit.clip_vision_kv(
            params["encoder"], frames, self.vit_cfg, self.compute_dtype,
            keep_layers=self.layer_indices, drop_cls=True, pad_tokens=pad_tokens)
        return {s: f.reshape((f.shape[0], b, t) + tuple(f.shape[2:])) for s, f in kvs.items()}

    def predict(self, params: Params, x, m, *, train: bool = False,
                patch_indices=None, with_video_features: bool = False):
        """Logits for a clip batch: x (B, T, 3, H, W) uint8 or float, m (B, T)
        bool, as arrays or tensors. Returns (task logits list, features)."""
        if train:
            raise NotImplementedError("training is not ported yet")
        if patch_indices is not None:
            raise NotImplementedError("patch_indices is not ported yet")
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=self.device)
        m = torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                            device=self.device).bool()
        with torch.inference_mode():
            x = self.preprocess(x)
            # the export's patch axis is 8-aligned (196 -> 200); the decoder
            # masks the pad rows as keys through patch_valid
            kvs = self.encode_kv(params, x, pad_tokens=True)
            task_logits, video = decoder_lib.apply_decoder(
                params["decoder"], kvs, m, self.decoder_cfg,
                patch_valid=self.vit_cfg.num_patches)
            task_logits = [5.0 * t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-10)
                           for t in task_logits]
        features = {"video": video} if with_video_features else {}
        return task_logits, features
