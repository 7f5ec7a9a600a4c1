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
the W8A8 tower on weights that ``prepare_params`` pre-quantises (in
training too: the tower is frozen), ``op_mode.kv_dtype = "int8_rows"``
keeps the K/V export int8 with per-row scales into the decoder (training
dequantises each slot to bf16 for the trainable attention), and
``kv_dtype = "int8"`` quantises it with per-(layer, head) scales that
``encode_kv`` dequantises at once, in the compute dtype (capacity only, as
in the JAX package). ``op_mode.attn_mode`` and ``aug_query`` reach the
decoder (models/decoder.py). ``encoder_kernels``
(``EncoderKernels``) chooses the CLIP encoder's kernel paths, as the JAX
package's DFD_FUSED_BLOCK, DFD_MEGAKERNEL and DFD_INT8_ATTN do (the tower's
export is unpadded); DINOv2 ignores it, as JAX's DINOv2 tower ignores them.
``predict(patch_indices=...)`` gathers each kept layer's patches
before the decoder (bf16 and int8_rows K/V alike). With an adapter
(``adapter.type`` "scratch" or "pretrain", models/adapter.py) the export
is unpadded (the "nln" joint LayerNorm and the "768-bn" statistics must not
see pad rows), int8_rows K/V are dequantised first, and the adapter turns
the stacked export into per-layer K/V between the encoder and the decoder,
under autograd in training, so the decoder attention's backward hands back
dK/dV into the adapter. ``forward`` in training also returns the JAX
package's auxiliary losses: ``train_mode.compression`` ("feature-match" on
the video feature, "sync" on the adapter's per-layer K/V: "recon" and
"match"), ``train_mode.temporal`` ("ranking" on the trainable
``ranking_proj``: "speed/rank"; "triplet" on host-drawn triples:
"speed/triplet"); ``train_mode.patch_mask`` draws each step's patch
indices on the host (``sample_patch_indices``) and ``op_mode.ema_frame``
collapses a clip to one geometrically weighted frame.

On a multi-rank layout (runtime.MeshRuntime, ops/spmd.py) a rank holds its
rows of the global batch and, where ``takes_frame_shards`` allows it and
the seq width is above 1, its seq share of each clip's frames (the
trainer, the evaluator and ``MeshRuntime.shard_batch`` cut them). The
tower then runs on those frames (``spmd.spmd_encoder_kv``) and the
decoder's attention is the token-sharded one, combined over the seq row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import adapter as adapter_lib, clip_vit, decoder as decoder_lib, dinov2_vit
from ..device import resolve_device
from ..ops import image_ops, spmd

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- loss factories (per-sample losses, reduction left to the caller) ----------

def mse(*_, **__):
    """Expectation-vs-bpm squared error over a 140-bin distribution head
    (loss arguments are ignored, as in the JAX package)."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        bins = torch.arange(140, dtype=torch.float32, device=logits.device)
        expect = torch.softmax(logits[:, :140].float(), dim=-1) @ bins
        return torch.square(expect - y.float()) / 1000.0

    return per_sample


def kl_div(*_, **__):
    """Elementwise KL(target || softmax(logits)), reduction='none' (loss
    arguments are ignored, as in the JAX package)."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        log_q = torch.log_softmax(logits.float(), dim=1)
        y = y.float()
        # p * (log p - log q), with 0 log 0 := 0
        log_p = torch.where(y > 0, torch.log(y.clamp_min(1e-38)), 0.0)
        return y * (log_p - log_q)

    return per_sample


def auc_roc(weight=None, label_smoothing: float = 0.0, *_, **__):
    """Per-sample cross-entropy against class indices or soft targets,
    optionally label-smoothed and class-weighted."""

    def per_sample(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        num_classes = logits.shape[-1]
        log_p = torch.log_softmax(logits.float(), dim=-1)
        if y.ndim == 1 and not y.is_floating_point():
            targets = F.one_hot(y.long(), num_classes).float()
        else:
            targets = y.float()
        if label_smoothing:
            targets = targets * (1.0 - label_smoothing) + label_smoothing / num_classes
        if weight is not None:
            w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
            return -torch.sum(w * targets * log_p, dim=-1)
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
        op = config.op_mode
        self.compute_int8 = config.foundation != "dinov2" and bool(op.get("compute_int8", 0))
        self.losses = [LOSSES[loss]() if isinstance(loss, str)
                       else LOSSES[loss.name](**(loss.args.to_dict() if "args" in loss else {}))
                       for loss in config.losses]
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
        self.adapter_type = config.adapter.type
        self.adapter_cfg = None
        if self.adapter_type != "none":
            if config.adapter.struct.type not in adapter_lib.STRUCT_TYPES:
                raise NotImplementedError(f"Unknown adapter struct: {config.adapter.struct.type}")
            self.adapter_cfg = adapter_lib.AdapterConfig(
                struct_type=config.adapter.struct.type,
                inner_dim=int(config.adapter.struct.get("x", self.vit_cfg.width)),
                width=self.vit_cfg.width,
                num_layers=len(self.layer_indices),
                dropout=config.dropout,
                num_frames=num_frames,
                patches=self.vit_cfg.num_patches,
            )
        tm = config.train_mode
        self.guide_map = None
        if "patch_mask" in tm and tm.patch_mask.type == "guide":
            import pickle

            with open(tm.patch_mask.path, "rb") as f:
                self.guide_map = pickle.load(f)

    # -- params ---------------------------------------------------------------
    def init_params(self, gen: torch.Generator,
                    encoder_params: Optional[Params] = None) -> Params:
        """Random f32 params (CPU) from ``gen``; the decoder's LayerNorms and
        MLPs are seeded from the encoder's kept layers. With an adapter also
        ``adapter``, read from ``adapter.path`` for ``adapter.type``
        "pretrain"; with ``train_mode.temporal`` "ranking" also the trainable
        ``ranking_proj`` (W, 1), drawn last."""
        if encoder_params is None:
            init = dinov2_vit.init_dinov2 if self._dinov2() else clip_vit.init_clip_vision
            encoder_params = init(gen, self.vit_cfg)
        params = {
            "encoder": encoder_params,
            "decoder": decoder_lib.init_decoder(gen, self.decoder_cfg,
                                                encoder_params["blocks"]),
        }
        if self.adapter_cfg is not None:
            params["adapter"] = adapter_lib.init_adapter(gen, self.adapter_cfg)
            if self.adapter_type == "pretrain":
                from .weights import load_adapter_checkpoint

                params["adapter"] = load_adapter_checkpoint(self.config.adapter.path,
                                                            params["adapter"])
        if self._temporal() == "ranking":
            w = self.vit_cfg.width
            params["ranking_proj"] = (w ** -0.5) * torch.randn(w, 1, generator=gen)
        return params

    def prepare_params(self, params: Params) -> Params:
        """Move params to the detector's device, with the matrix weights
        (linear ``w``, ``conv1``) in the compute dtype and everything else
        (LayerNorms, biases, embeddings, task projections, int8 scales) in
        f32. With ``compute_int8`` the tower's block weights are first
        quantised from f32 (clip_vit.prepare_int8_params), and their int8
        ``wq`` stay int8."""
        if self.compute_int8 and "encoder" in params:
            params = {**params, "encoder": clip_vit.prepare_int8_params(params["encoder"])}

        def place(path, leaf):
            if leaf.dtype == torch.int8:
                return leaf.to(device=self.device).contiguous()
            is_matrix = path[-1] == "w" and "task_projections" not in path
            dtype = self.compute_dtype if is_matrix else torch.float32
            return leaf.to(device=self.device, dtype=dtype).contiguous()

        return _map_tree(place, params)

    def partition_params(self, params: Params) -> Tuple[Params, Params]:
        """(trainable, frozen): the encoder never trains; a pretrained adapter
        with ``adapter.frozen`` set does not either."""
        trainable = {k: v for k, v in params.items() if k != "encoder"}
        frozen = {"encoder": params["encoder"]}
        if self.adapter_type == "pretrain" and self.config.adapter.get("frozen", 0) \
                and "adapter" in trainable:
            frozen["adapter"] = trainable.pop("adapter")
        return trainable, frozen

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

    def _temporal(self) -> Optional[str]:
        tm = self.config.train_mode
        return tm.temporal if "temporal" in tm else None

    def _kv_rows8(self) -> bool:
        """op_mode.kv_dtype "int8_rows": per-row int8 K/V that stay
        quantised into the decoder (CLIP towers only)."""
        return not self._dinov2() and self.config.op_mode.get("kv_dtype", "auto") == "int8_rows"

    def _kv_int8(self) -> bool:
        """op_mode.kv_dtype "int8": per-(layer, head) int8 K/V, dequantised
        as soon as they are exported (CLIP towers only)."""
        return not self._dinov2() and self.config.op_mode.get("kv_dtype", "auto") == "int8"

    def takes_frame_shards(self) -> bool:
        """Whether a rank may hold only its seq share of each clip's frames.
        Not with kv_dtype "int8" or "int8_rows" (their scales span the
        whole batch in the JAX package, which keeps them off its sharded
        tower), an adapter (its statistics and losses span the clip), a
        factorised attn_mode or ema_frame (they mix the clip's frames), nor
        with host-drawn patch masks or speed triplets (each rank draws its
        own, and a seq row must compute one loss)."""
        tm, op = self.config.train_mode, self.config.op_mode
        return not (self._kv_int8() or self._kv_rows8() or self.adapter_cfg is not None
                    or self.decoder_cfg.attn_mode or op.get("ema_frame", 0)
                    or "patch_mask" in tm or self._temporal() == "triplet")

    def seq_layout(self, t_local: int):
        """The multi-rank layout when a batch of ``t_local`` frames a clip
        holds this rank's seq share of them (spmd.seq_layout), else None."""
        return spmd.seq_layout(t_local, self.num_frames) if self.takes_frame_shards() else None

    def _dequant_kvs(self, kvs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Float K/V in the compute dtype from the int8_rows form (the
        adapter reads float K/V); other exports as they are."""
        if "k_scale" not in kvs:
            return kvs
        return {s: (kvs[s].float() * kvs[f"{s}_scale"][..., None]).to(self.compute_dtype)
                for s in ("k", "v")}

    def encode_kv(self, params: Params, x: torch.Tensor,
                  pad_tokens: bool = False) -> Dict[str, torch.Tensor]:
        """(B, T, 3, H, W) -> {"k", "v"}: (Lsel, B, T, P, H, D); with
        ``pad_tokens`` a CLIP tower's P is zero-padded to a multiple of 8 (the
        DINOv2 export and the whole-encoder tower's are never padded). With
        int8_rows also {"k_scale", "v_scale"}: (Lsel, B, T, P, 1) f32. On a
        multi-rank layout B and T are this rank's clips and frames
        (``spmd_encoder_kv``: the tower needs no collective, save that
        kv_dtype "int8" takes its per-(layer, head) maxima over the data
        ranks, whose clips make up the global batch)."""
        layout = spmd.spmd_layout()
        reduce_max = (functools.partial(layout.all_reduce_, op="max", axis="data")
                      if layout is not None and self._kv_int8() else None)

        def tower(enc, frames):
            if self._dinov2():
                return dinov2_vit.dinov2_kv(enc, frames, self.vit_cfg, self.compute_dtype,
                                            keep_layers=self.layer_indices, drop_cls=True)
            kvs = clip_vit.clip_vision_kv(
                enc, frames, self.vit_cfg, self.compute_dtype,
                keep_layers=self.layer_indices, drop_cls=True, pad_tokens=pad_tokens,
                compute_int8=self.compute_int8, kv_int8_rows=self._kv_rows8(),
                kv_int8=self._kv_int8(), kv_scale_reduce=reduce_max,
                **dataclasses.asdict(self.encoder_kernels))
            if self._kv_int8():   # q.astype(cd) * (s / 127).astype(cd), detector.py:297-318
                cd = self.compute_dtype
                kvs = {s: kvs[s].to(cd) * (kvs[f"{s}_scale"][:, None, None, :, None] / 127.0)
                       .to(cd) for s in ("k", "v")}
            return kvs

        return spmd.spmd_encoder_kv(tower, params["encoder"], x)

    def predict(self, params: Params, x, m, *, train: bool = False,
                gen: Optional[torch.Generator] = None, patch_indices=None,
                with_video_features: bool = False, with_adapt_features: bool = False):
        """Logits for a clip batch: x (B, T, 3, H, W) uint8 or float, m (B, T)
        bool, as arrays or tensors. Returns (task logits list, features).
        ``train`` runs the adapter and the decoder's differentiable
        composition (dropout drawn from ``gen``, a generator on the
        detector's device: the adapter's draws first, then the decoder's).
        ``patch_indices`` (Lsel, num_select) keeps, of each kept layer's
        export, the patches it lists (src/models.py:511-544); the gathered
        rows are all real patches, so no pad row is masked.
        ``with_adapt_features``: features["adapt"] holds the adapter's
        output, {"k", "v"}: lists of per-layer (B, T, P, H, D)."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=self.device)
        m = torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                            device=self.device).bool()
        if with_adapt_features and self.adapter_cfg is None:
            raise ValueError("cannot return adaptive features without an adapter")
        # the export's patch axis is 8-aligned (196 -> 200, not on the tower)
        # without an adapter; the decoder masks the pad rows as keys through
        # patch_valid. An adapter reads the exact-P export.
        pad_tokens = self.adapter_cfg is None
        with torch.no_grad():
            x = self.preprocess(x)
            kvs = self.encode_kv(params, x, pad_tokens=pad_tokens)
            patch_valid = self.vit_cfg.num_patches if pad_tokens else None
            if patch_indices is not None:
                # per layer on the patch axis; int8_rows scales (Lsel, B, T, P, 1) alike
                idx = torch.as_tensor(patch_indices, device=self.device).long()
                kvs = {s: torch.stack([f[i].index_select(2, idx[i]) for i in range(len(f))])
                       for s, f in kvs.items()}
                patch_valid = None
            if self.adapter_cfg is not None:
                kvs = self._dequant_kvs(kvs)
        with contextlib.nullcontext() if train else torch.no_grad():
            if self.adapter_cfg is not None:
                kvs = adapter_lib.apply_adapter(params["adapter"], kvs, self.adapter_cfg,
                                                train=train, gen=gen)
            task_logits, video = decoder_lib.apply_decoder(
                params["decoder"], kvs, m, self.decoder_cfg, train=train, gen=gen,
                patch_valid=patch_valid, seq_layout=self.seq_layout(x.shape[1]))
            task_logits = [5.0 * t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-10)
                           for t in task_logits]
        features = {"video": video} if with_video_features else {}
        if with_adapt_features:
            features["adapt"] = kvs
        return task_logits, features

    def sample_patch_indices(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        """A step's patch indices (Lsel, num_select) for ``train_mode.patch_mask``,
        drawn from the host generator ``rng`` as the JAX package draws them:
        "batch" one draw for every kept layer, "sample" one a layer, "guide"
        one a layer weighted by the guide map's "v" of that encoder layer.
        None without a patch mask."""
        tm = self.config.train_mode
        if "patch_mask" not in tm:
            return None
        pm = tm.patch_mask
        num_patch = self.vit_cfg.num_patches
        num_select = int(num_patch * pm.ratio)
        nsel = len(self.layer_indices)
        if pm.type == "batch":
            return np.tile(rng.choice(num_patch, num_select, replace=False), (nsel, 1))
        if pm.type == "sample":
            return np.stack([rng.choice(num_patch, num_select, replace=False)
                             for _ in range(nsel)])
        if pm.type == "guide":
            return np.stack([rng.choice(num_patch, num_select, replace=False,
                                        p=self.guide_map["v"][self.layer_indices[i]].flatten())
                             for i in range(nsel)])
        raise NotImplementedError(pm.type)

    def forward(self, params: Params, x, y: Sequence[Optional[torch.Tensor]], m,
                comp_is_raw: Optional[torch.Tensor] = None, speed: Optional[torch.Tensor] = None,
                *, train: bool = False, single_task: Optional[int] = None,
                gen: Optional[torch.Generator] = None, patch_indices=None,
                triplet_indices=None):
        """Per-task losses and logits for a clip batch.

        y: per-task labels on the detector's device (None = task inactive);
        comp_is_raw: (B,) bool compression flags (``train_mode.nerf_raw`` and
        ``compression``); speed: (B,) f32 clip speeds (``temporal``);
        patch_indices: (Lsel, num_select) from ``sample_patch_indices``;
        triplet_indices: (R, 3) batch rows, each triple ordered fastest to
        slowest. Returns (task_losses, task_logits), and with ``train`` also
        the auxiliary losses {"recon", "match", "speed/rank",
        "speed/triplet"} of the modes that are on."""
        tm, op = self.config.train_mode, self.config.op_mode
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=self.device)
        m = torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                            device=self.device).bool()
        b, t = x.shape[:2]
        if op.get("ema_frame", 0):
            # one frame a clip: the preprocessed frames weighted (1 - r) r^(T-1-i)
            r = op.ema_frame
            with torch.no_grad():
                xf = self.preprocess(x)
                coef = (1 - r) * r ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                                   device=self.device)
                x = torch.einsum("t,btchw->bchw", coef.to(xf.dtype), xf)[:, None]
            m = m[:, :1]
        need_adapt = self.adapter_cfg is not None and "compression" in tm
        task_logits, features = self.predict(params, x, m, train=train, gen=gen,
                                             patch_indices=patch_indices,
                                             with_video_features=True,
                                             with_adapt_features=need_adapt)
        task_losses = [
            loss_fn(logits, labels)
            if labels is not None and (single_task is None or i == single_task)
            else torch.zeros(b, device=self.device)
            for i, (loss_fn, logits, labels) in enumerate(zip(self.losses, task_logits, y))
        ]
        if not train:
            return task_losses, task_logits
        video = features["video"]
        other: Dict[str, torch.Tensor] = {}
        if "compression" in tm:
            other.update(self._compression_losses(video, features.get("adapt"),
                                                  torch.as_tensor(comp_is_raw,
                                                                  device=self.device), b))
        if "nerf_raw" in tm:
            nerf_power = min(tm.nerf_raw, 0)
            scale = torch.where(comp_is_raw.to(self.device), nerf_power, 2.0 - nerf_power)
            task_losses = [loss * scale.reshape((b,) + (1,) * (loss.ndim - 1))
                           for loss in task_losses]
        temporal = self._temporal()
        if temporal is not None:
            speed = torch.as_tensor(speed, dtype=torch.float32, device=self.device)
            if temporal == "ranking":
                other["speed/rank"] = self._ranking_loss(params, video, speed)
            elif temporal == "triplet":
                other["speed/triplet"] = self._triplet_loss(
                    video, speed, torch.as_tensor(triplet_indices, device=self.device).long())
            else:
                raise NotImplementedError(temporal)
        return task_losses, task_logits, other

    # -- auxiliary losses ---------------------------------------------------------
    def _compression_losses(self, video: torch.Tensor, adapt: Optional[Dict],
                            comp_is_raw: torch.Tensor, b: int) -> Dict[str, torch.Tensor]:
        """raw / c23 invariance of interleaved pairs (rows 2i, 2i + 1): "recon"
        0, and "match" 100 x the KL of the c23 member's softmax from the raw
        member's, over the video feature's last axis ("feature-match", each
        block's feature apart under global_prediction) or over the head_dim
        of each adapted K/V layer ("sync", averaged over layers, pairs and
        K and V)."""
        w = b // 2
        raw_first = comp_is_raw.reshape(w, 2)[:, 0]

        def pair_order(feats: torch.Tensor):
            pairs = feats.reshape((w, 2) + tuple(feats.shape[1:]))
            sel = raw_first.reshape((w,) + (1,) * (feats.ndim - 1))
            return (torch.where(sel, pairs[:, 0], pairs[:, 1]),
                    torch.where(sel, pairs[:, 1], pairs[:, 0]))

        def kl(feats: torch.Tensor) -> torch.Tensor:
            """Per pair, the mean over its elements of p (log p - log q)."""
            raw, c23 = pair_order(feats.float())
            log_p, log_q = torch.log_softmax(raw, dim=-1), torch.log_softmax(c23, dim=-1)
            return (log_p.exp() * (log_p - log_q)).flatten(1).mean(dim=1)

        mode = self.config.train_mode.compression
        out = {"recon": torch.zeros((), device=self.device)}
        if mode == "feature-match":
            out["match"] = 100.0 * kl(video).sum() / w
        elif mode == "sync":
            if adapt is None:
                raise ValueError("train_mode.compression 'sync' needs an adapter")
            nsel = len(self.layer_indices)
            total = torch.zeros((), device=self.device)
            for s in ("k", "v"):
                total = total + sum(kl(f).sum() for f in adapt[s]) / (w * nsel * 2)
            out["match"] = 100.0 * total
        else:
            raise NotImplementedError(mode)
        return out

    @staticmethod
    def _last_feature(video: torch.Tensor) -> torch.Tensor:
        return video if video.ndim == 2 else video[:, -1]

    def _ranking_loss(self, params: Params, video: torch.Tensor,
                      speed: torch.Tensor) -> torch.Tensor:
        """0.05 x the mean hinge of (x_j - x_i) over the pairs i < j of the
        batch ordered fastest first (a stable sort), x the clips' projections
        on ``ranking_proj``."""
        logits = (self._last_feature(video) @ params["ranking_proj"].float()).squeeze(-1)
        x = logits[torch.argsort(-speed, stable=True)]
        n = x.shape[0]
        upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=x.device), diagonal=1)
        hinge = torch.clamp_min(x[None, :] - x[:, None], 0.0)
        return 0.05 * torch.where(upper, hinge, 0.0).sum() / upper.sum()

    def _triplet_loss(self, video: torch.Tensor, speed: torch.Tensor,
                      triplets: torch.Tensor) -> torch.Tensor:
        """Speed-ordered triplet margins over the (R, 3) rows (fastest,
        middle, slowest)."""
        vf = self._last_feature(video)
        a, p, n = vf[triplets[:, 0]], vf[triplets[:, 1]], vf[triplets[:, 2]]
        s = speed[triplets]

        def dist(u, v):
            return torch.linalg.vector_norm(u - v + 1e-6, dim=-1)

        l1 = torch.clamp_min(dist(a, p) - dist(a, n) + (s[:, 2] - s[:, 1]).abs(), 0.0)
        l2 = torch.clamp_min(dist(n, p) - dist(n, a) + (s[:, 1] - s[:, 0]).abs(), 0.0)
        return 0.01 * (l1.sum() + l2.sum()) / (triplets.shape[0] * 2)
