"""Plain dual-activation (softmax + CoDA) decoder attention (counterpart of
dfd_clip_tpu/ops/decoder_attention.py:dual_activation_attention for a single
query and no factorised ``attn_mode``).

A learned query attends the flattened (frames x patches) K/V stream with the
mean of a masked softmax and CoDA (tanh affinity gated by 2 sigmoid(-L1 x
scale), masked tokens contributing exactly 0). Fully masked rows give 0, not
NaN. All arithmetic in f32; the output takes v's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def dual_activation_attention(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, *, attn_mode: Sequence[str] = (),
    temporal_pos: Optional[torch.Tensor] = None, layer: Optional[int] = None,
) -> torch.Tensor:
    """(B, 1, H, D) queries, (B, L, H, D) K/V -- or the stacked
    (Lsel, B, L, H, D) buffers read at ``layer`` -- and a (B, L) bool mask
    -> (B, 1, H, D). ``temporal_pos`` (L, H, D) is added to K and V."""
    if attn_mode:
        raise NotImplementedError("factorised attn_mode is not ported yet")
    if q_smax.shape[1] != 1:
        raise NotImplementedError("only the single-query decoder is ported")
    if layer is not None:
        k, v = k[layer], v[layer]
    d = q_smax.shape[-1]
    scale = d ** -0.5
    kp, vp = k.float(), v.float()
    if temporal_pos is not None:
        pos = temporal_pos.float().expand(k.shape[1:])
        kp, vp = kp + pos, vp + pos
    qs, qc = q_smax[:, 0].float(), q_coda[:, 0].float()          # (B, H, D)
    m = mask[:, :, None]                                         # (B, L, 1)

    logits = torch.einsum("bhd,blhd->blh", qs * scale, kp)
    aff_smax = torch.softmax(logits.masked_fill(~m, float("-inf")), dim=1)
    aff_smax = torch.nan_to_num(aff_smax, nan=0.0)               # fully masked -> 0

    coda = torch.tanh(torch.einsum("bhd,blhd->blh", qc * scale, kp))
    l1 = (qc[:, None] - kp).abs().sum(-1)                        # (B, L, H)
    gate = torch.where(m, 2.0 * torch.sigmoid(-l1 * scale), torch.zeros((), device=l1.device))
    aff = 0.5 * (aff_smax + coda * gate)
    out = torch.einsum("blh,blhd->bhd", aff, vp)
    return out[:, None].to(v.dtype)
