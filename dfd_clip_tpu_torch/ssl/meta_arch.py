"""SSL meta-architecture (counterpart of dfd_clip_tpu/ssl/meta_arch.py;
dinov2/train/ssl_meta_arch.py:34-403): student and teacher DINOv2 towers
with their DINO and iBOT heads, the DINO + iBOT + KoLeo loss with either
teacher normalisation (EMA centering or Sinkhorn-Knopp), and the teacher's
EMA. Params are plain dicts of tensors (models/weights.py's layout).

The towers run ``dinov2_forward``: the teacher on the clean global crops
under ``torch.no_grad``, the student on the masked global crops and on the
local crops under autograd, with stochastic depth and ``remat``. The
encoder attention of every block is csrc/encoder_attention.cu on the card
(forward, and under autograd through ``trainable_encoder_attention``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..engine.optim import named_leaves
from ..models import dinov2_vit
from ..models.clip_vit import ViTConfig
from ..ops import spmd
from . import losses as loss_lib
from .dino_head import apply_dino_head, init_dino_head

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    arch: ViTConfig
    out_dim: int = 65536
    ibot_out_dim: int = 65536
    ibot_separate_head: bool = True
    local_size: int = 98
    n_local_crops: int = 8
    student_temp: float = 0.1
    center_momentum: float = 0.9
    dino_weight: float = 1.0
    ibot_weight: float = 1.0
    koleo_weight: float = 0.1
    drop_path_rate: float = 0.0
    # rematerialise the student's blocks in the backward (dinov2_forward)
    remat: bool = False
    head_hidden_dim: int = 2048
    head_bottleneck_dim: int = 256
    head_n_layers: int = 3
    # teacher normalisation: "centering" (EMA-centered softmax) or
    # "sinkhorn_knopp" (dinov2 ssl_default_config.yaml:70)
    centering: str = "centering"


class SSLMetaArch:
    def __init__(self, cfg: SSLConfig, compute_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def init_params(self, gen: torch.Generator) -> Tuple[Params, Params, Params]:
        """(student, teacher, centers), f32 on the CPU; the teacher is a copy
        of the student. The draws are not the JAX package's."""
        c = self.cfg
        student: Params = {
            "backbone": dinov2_vit.init_dinov2(gen, c.arch),
            "dino_head": init_dino_head(gen, c.arch.width, c.out_dim, c.head_hidden_dim,
                                        c.head_bottleneck_dim, c.head_n_layers),
        }
        if c.ibot_separate_head:
            student["ibot_head"] = init_dino_head(gen, c.arch.width, c.ibot_out_dim,
                                                  c.head_hidden_dim, c.head_bottleneck_dim,
                                                  c.head_n_layers)
        centers = {"dino": torch.zeros(c.out_dim), "ibot": torch.zeros(c.ibot_out_dim)}
        return student, copy.deepcopy(student), centers

    def _ibot_head(self, params: Params) -> Params:
        return params["ibot_head"] if self.cfg.ibot_separate_head else params["dino_head"]

    def forward_loss(self, student: Params, teacher: Params, centers: Params,
                     global_crops: torch.Tensor, local_crops: Optional[torch.Tensor],
                     patch_masks: torch.Tensor, teacher_temp,
                     gen: Optional[torch.Generator] = None):
        """One SSL loss evaluation (meta_arch.py:84-185) on global crops (2,
        B, 3, S, S), local crops (n_local, B, 3, s, s) or None, and the
        global crops' patch masks (2, B, P) bool. ``gen`` draws the student's
        stochastic-depth masks, globals first. Returns (total, (metrics,
        new_centers)); the loss is differentiable in the student's leaves."""
        c = self.cfg
        two, b = global_crops.shape[:2]
        flat_globals = global_crops.reshape((two * b,) + global_crops.shape[2:])

        with torch.no_grad():
            t_out = dinov2_vit.dinov2_forward(teacher["backbone"], flat_globals, c.arch,
                                              self.compute_dtype)
            t_cls_logits = apply_dino_head(teacher["dino_head"], t_out["cls"]).reshape(two, b, -1)
            t_patch_logits = apply_dino_head(self._ibot_head(teacher), t_out["patch"]).reshape(
                two, b, -1, c.ibot_out_dim)
            del t_out

        flat_masks = patch_masks.reshape(two * b, -1)
        s_out_g = dinov2_vit.dinov2_forward(
            student["backbone"], flat_globals, c.arch, self.compute_dtype, masks=flat_masks,
            drop_path_rate=c.drop_path_rate, gen=gen, remat=c.remat)
        s_cls = [apply_dino_head(student["dino_head"], s_out_g["cls"]).reshape(two, b, -1)]
        if local_crops is not None and local_crops.shape[0] > 0:
            nl = local_crops.shape[0]
            s_out_l = dinov2_vit.dinov2_forward(
                student["backbone"], local_crops.reshape((nl * b,) + local_crops.shape[2:]),
                c.arch, self.compute_dtype, drop_path_rate=c.drop_path_rate, gen=gen,
                remat=c.remat)
            s_cls.append(apply_dino_head(student["dino_head"], s_out_l["cls"]).reshape(nl, b, -1))
        s_cls_logits = torch.cat(s_cls)

        layout = spmd.spmd_layout()   # Sinkhorn-Knopp and KoLeo span the global batch
        t_probs_dino = t_probs_ibot = None
        if c.centering == "sinkhorn_knopp":
            with torch.no_grad():
                t_probs_dino = loss_lib.sinkhorn_knopp(
                    t_cls_logits.reshape(two * b, -1), teacher_temp, layout=layout
                ).reshape(two, b, -1)
                t_probs_ibot = loss_lib.sinkhorn_knopp_masked(
                    t_patch_logits.reshape(two * b, -1, c.ibot_out_dim), flat_masks,
                    teacher_temp, layout=layout)
        elif c.centering != "centering":
            raise NotImplementedError(f"centering: {c.centering}")

        dino, dino_center = loss_lib.dino_loss(s_cls_logits, t_cls_logits, centers["dino"],
                                               c.student_temp, teacher_temp,
                                               teacher_probs=t_probs_dino)
        s_patch_logits = apply_dino_head(self._ibot_head(student), s_out_g["patch"])
        ibot, ibot_center = loss_lib.ibot_patch_loss(
            s_patch_logits.reshape(two * b, -1, c.ibot_out_dim),
            t_patch_logits.reshape(two * b, -1, c.ibot_out_dim), flat_masks,
            centers["ibot"], c.student_temp, teacher_temp, teacher_probs=t_probs_ibot)
        # both global crops, each on its own (never between two crops of one
        # image: ssl_meta_arch.py:316-318), each over the global batch
        koleo = (loss_lib.koleo_loss(s_out_g["cls"][:b], layout=layout)
                 + loss_lib.koleo_loss(s_out_g["cls"][b:], layout=layout))

        total = c.dino_weight * dino + c.ibot_weight * ibot + c.koleo_weight * koleo
        if c.centering == "sinkhorn_knopp":
            new_centers = centers
        else:
            new_centers = {
                "dino": loss_lib.update_center(centers["dino"], dino_center, c.center_momentum),
                "ibot": loss_lib.update_center(centers["ibot"], ibot_center, c.center_momentum),
            }
        metrics = {"dino": dino, "ibot": ibot, "koleo": koleo, "total": total}
        return total, (metrics, new_centers)

    @staticmethod
    @torch.no_grad()
    def ema_update(teacher: Params, student: Params, momentum: float) -> None:
        """teacher <- m * teacher + (1 - m) * student, in place, leaf by leaf
        (the JAX package's rounding: both products, then their sum)."""
        t_leaves = [t for _, t in named_leaves(teacher)]
        s_leaves = [s for _, s in named_leaves(student)]
        torch._foreach_mul_(t_leaves, momentum)
        torch._foreach_add_(t_leaves, torch._foreach_mul(s_leaves, 1.0 - momentum))
