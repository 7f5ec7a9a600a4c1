"""SSL objectives (counterpart of dfd_clip_tpu/ssl/losses.py): the DINO CLS
loss, its EMA center, Sinkhorn-Knopp centering (CLS and masked patches),
the iBOT masked-patch loss and the KoLeo regulariser, as torch ops in f32.
Sinkhorn-Knopp's normalisations and KoLeo's nearest neighbours span the
global batch: on a data-parallel layout (the runtime passed as
``layout``) the global maximum is one MAX and each sum over the batch one
SUM over the data ranks, as JAX's sums over its sharded batch are (the
teacher side has no gradient, so plain collectives do), and KoLeo gathers
the student's normalised CLS rows through a differentiable all-gather."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.spmd import data_gather, data_reduce


def dino_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              center: torch.Tensor, student_temp: float, teacher_temp,
              teacher_probs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft cross-entropy of the student (n_s, B, K) against the teacher
    (n_t, B, K), centered and sharpened (or ``teacher_probs``, the
    Sinkhorn-Knopp assignment), over every (teacher crop, student crop) pair
    except same-view ones. Returns (loss, the batch mean of the raw teacher
    logits for the center's EMA)."""
    if teacher_probs is None:
        teacher_probs = torch.softmax((teacher_logits - center) / teacher_temp, dim=-1)
    s_logp = torch.log_softmax(student_logits / student_temp, dim=-1)
    total, n_terms = 0.0, 0
    for it in range(teacher_probs.shape[0]):
        for is_ in range(s_logp.shape[0]):
            if it == is_:
                continue
            total = total - (teacher_probs[it] * s_logp[is_]).sum(-1).mean()
            n_terms += 1
    return total / max(n_terms, 1), teacher_logits.mean(dim=(0, 1))


def update_center(center: torch.Tensor, batch_center: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    return center * momentum + batch_center * (1.0 - momentum)


def sinkhorn_knopp(teacher_logits: torch.Tensor, teacher_temp,
                   n_iterations: int = 3, layout=None) -> torch.Tensor:
    """Sinkhorn-Knopp assignment (B, K) of the teacher's (B, K) logits, B
    this rank's rows of a global batch spread over ``layout``'s data ranks
    (every rank holding as many); the global maximum is subtracted before
    the exp (a constant factor that the first normalisation removes)."""
    z = (teacher_logits / teacher_temp).float()
    q = torch.exp(z - data_reduce(z.max(), "max", layout)).T
    q = q / data_reduce(q.sum(), "sum", layout)
    k, b = q.shape
    b *= 1 if layout is None else layout.data_parallel
    for _ in range(n_iterations):
        q = q / data_reduce(q.sum(dim=1, keepdim=True), "sum", layout) / k
        q = q / q.sum(dim=0, keepdim=True) / b
    return (q * b).T


def sinkhorn_knopp_masked(teacher_patch_logits: torch.Tensor, patch_mask: torch.Tensor,
                          teacher_temp, n_iterations: int = 3, layout=None) -> torch.Tensor:
    """Sinkhorn-Knopp over the masked patches only (N, P, K): B is the
    global batch's masked-patch count (summed over ``layout``'s data ranks),
    unmasked columns stay 0 (the loss never reads them), and an empty mask
    gives zeros, not 0/0."""
    n, p, k = teacher_patch_logits.shape
    z = (teacher_patch_logits.reshape(n * p, k) / teacher_temp).float()
    m = patch_mask.reshape(n * p).float()
    q = torch.exp(z - data_reduce(z.max(), "max", layout)).T * m[None, :]
    b = torch.clamp(data_reduce(m.sum(), "sum", layout), min=1.0)
    q = q / torch.clamp(data_reduce(q.sum(), "sum", layout), min=1e-30)
    for _ in range(n_iterations):
        rows = data_reduce(q.sum(dim=1, keepdim=True), "sum", layout)
        q = q / torch.where(rows > 0, rows, torch.ones_like(rows)) / k
        cols = q.sum(dim=0, keepdim=True)
        q = q / torch.where(cols > 0, cols, torch.ones_like(cols)) / b
    return (q * b).T.reshape(n, p, k)


def ibot_patch_loss(student_patch_logits: torch.Tensor, teacher_patch_logits: torch.Tensor,
                    patch_mask: torch.Tensor, center: torch.Tensor, student_temp: float,
                    teacher_temp, teacher_probs: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of student and teacher patch distributions (B, P, K) on
    the masked patches only, each image's patches weighted by 1 / its own
    masked count and the sum divided by the image count. Returns (loss, the
    mean raw teacher logits over the masked patches)."""
    if teacher_probs is None:
        teacher_probs = torch.softmax((teacher_patch_logits - center) / teacher_temp, dim=-1)
    s_logp = torch.log_softmax(student_patch_logits / student_temp, dim=-1)
    per_patch = -(teacher_probs * s_logp).sum(-1)
    per_image = torch.clamp(patch_mask.sum(-1, keepdim=True).float(), min=1.0)
    masked = torch.where(patch_mask, per_patch / per_image, torch.zeros_like(per_patch))
    loss = masked.sum() / patch_mask.shape[0]
    count = torch.clamp(patch_mask.sum(), min=1)
    batch_center = torch.where(patch_mask[..., None], teacher_patch_logits,
                               torch.zeros((), device=teacher_patch_logits.device)
                               ).sum(dim=(0, 1)) / count
    return loss, batch_center


def koleo_loss(features: torch.Tensor, eps: float = 1e-8, layout=None) -> torch.Tensor:
    """-mean log of each L2-normalised feature's distance to its nearest
    neighbour other than itself (the Kozachenko-Leonenko entropy estimate).
    On ``layout``'s data ranks ``features`` (B, C) are this rank's rows of
    the global batch: the ranks' normalised rows are gathered
    (``data_gather``), each own row's neighbour is taken over the global
    batch, and the loss is the mean over the rank's own rows, so that the
    ranks' mean is JAX's global mean and the trainers' mean of the ranks'
    gradients is its gradient (a row that is another rank's neighbour gets
    that rank's gradient through the gather's backward)."""
    f = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + eps)
    full, start = f, 0
    if layout is not None and layout.data_parallel > 1:
        full = data_gather(f, layout)
        rows = layout.rows(full.shape[0])
        f, start = full[rows], rows.start
    with torch.no_grad():   # the neighbour's index carries no gradient
        sim = f @ full.T
        own = torch.arange(f.shape[0], device=f.device)
        sim[own, own + start] -= 2.0   # exclude self
        nn = sim.argmax(-1)
    nn = full[nn]
    return -torch.log(torch.linalg.vector_norm(f - nn, dim=-1) + eps).mean()
