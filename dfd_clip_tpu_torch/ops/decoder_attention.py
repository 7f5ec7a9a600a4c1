"""Plain dual-activation (softmax + CoDA) decoder attention (counterpart of
dfd_clip_tpu/ops/decoder_attention.py:dual_activation_attention for a single
query and no factorised ``attn_mode``), the plain ``partials`` form of
the fused kernel, and the merge of partials over chunks of L (counterpart of
the combine in dfd_clip_tpu/ops/spmd.py, the fused kernel's second launch). With int8_rows K/V (``k_scale``/``v_scale``) the plain
version dequantises each token's row in f32, as the port's kernel does (the
JAX XLA path rounds it to the query dtype, its kernel to bf16).

A learned query attends the flattened (frames x patches) K/V stream with the
mean of a masked softmax and CoDA (tanh affinity gated by 2 sigmoid(-L1 x
scale), masked tokens contributing exactly 0). Fully masked rows give 0, not
NaN. All arithmetic in f32; the output takes v's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_BIG = -1e30   # the kernels' finite start of the running maximum


def _stream(k, v, temporal_pos, layer, k_scale=None, v_scale=None):
    """The slot's K and V in f32 (int8 rows times their (B, L, 1) scales),
    with the temporal embedding added."""
    if layer is not None:
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    kp, vp = k.float(), v.float()
    if k_scale is not None:
        kp, vp = kp * k_scale[..., None].float(), vp * v_scale[..., None].float()
    if temporal_pos is not None:
        pos = temporal_pos.float().expand(k.shape[1:])
        kp, vp = kp + pos, vp + pos
    return kp, vp


def dual_activation_attention(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, *, attn_mode: Sequence[str] = (),
    temporal_pos: Optional[torch.Tensor] = None, layer: Optional[int] = None,
    differentiable: bool = False, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, 1, H, D) queries, (B, L, H, D) K/V -- or the stacked
    (Lsel, B, L, H, D) buffers read at ``layer`` -- and a (B, L) bool mask
    -> (B, 1, H, D). ``temporal_pos`` (L, H, D) is added to K and V. With
    int8 K/V, ``k_scale``/``v_scale`` (B, L, 1) (stacked (Lsel, B, L, 1))
    dequantise each token's row, and the output takes the queries' dtype.

    ``differentiable`` (the training path) routes to the fused kernels'
    autograd Function (ops/decoder_attention_vjp.py), whose backward gives
    the queries', the embedding's and, when asked, K/V's gradients."""
    if attn_mode:
        raise NotImplementedError("factorised attn_mode is not ported yet")
    if q_smax.shape[1] != 1:
        raise NotImplementedError("only the single-query decoder is ported")
    if differentiable:
        if k_scale is not None:
            raise NotImplementedError("training on int8_rows K/V is not ported yet")
        # imported here: the Function's module imports this one
        from .decoder_attention_vjp import fused_decoder_attention_trainable

        return fused_decoder_attention_trainable(q_smax, q_coda, k, v, mask,
                                                 temporal_pos, layer)
    kp, vp = _stream(k, v, temporal_pos, layer, k_scale, v_scale)
    d = q_smax.shape[-1]
    scale = d ** -0.5
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
    return out[:, None].to(q_smax.dtype if k_scale is not None else v.dtype)


def decoder_attention_partials_plain(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor] = None,
    layer: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softmax state of the single-query attention, as the fused
    kernel's ``partials`` form returns it: ``(o_sc, st)`` with o_sc
    (B, 2, H*D) f32 [row 0: the un-normalised softmax numerator, row 1: the
    CoDA output] and st (B, 2, H) f32 [row 0: the denominator, row 1: the
    maximum logit], numerator and denominator relative to that maximum. A
    fully masked sample gives numerator 0, denominator 0 and maximum -1e30."""
    kp, vp = _stream(k, v, temporal_pos, layer)
    b, _, h, d = q_smax.shape
    scale = d ** -0.5
    qs, qc = q_smax[:, 0].float(), q_coda[:, 0].float()          # (B, H, D)
    m = mask[:, :, None]                                         # (B, L, 1)

    ls = torch.einsum("bhd,blhd->blh", qs * scale, kp)
    mx = ls.masked_fill(~m, NEG_BIG).amax(dim=1)                 # (B, H)
    p = (ls - mx[:, None]).masked_fill(~m, float("-inf")).exp()
    num = torch.einsum("blh,blhd->bhd", p, vp)

    coda = torch.tanh(torch.einsum("bhd,blhd->blh", qc * scale, kp))
    l1 = (qc[:, None] - kp).abs().sum(-1)
    wc = (coda * 2.0 * torch.sigmoid(-l1 * scale)).masked_fill(~m, 0.0)
    o_c = torch.einsum("blh,blhd->bhd", wc, vp)
    o_sc = torch.stack([num.reshape(b, h * d), o_c.reshape(b, h * d)], dim=1)
    return o_sc, torch.stack([p.sum(1), mx], dim=1)


def merge_decoder_partials_plain(
    parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], normalise: bool = False,
):
    """Merge the softmax states of consecutive chunks of L, each ``(o_sc,
    st)`` as decoder_attention_partials_plain returns it, in chunk order,
    with JAX's combine: r = exp(max_c - max), numerator and denominator
    sum_c x_c r, CoDA sum_c x_c. Returns the merged ``(o_sc, st)``
    (relative to the merged maximum), or with ``normalise`` the f32
    (B, 1, H, D) output 0.5 * (numerator / max(denominator, 1e-30) + CoDA);
    a fully masked sample gives (0, 0, -1e30), normalised 0."""
    mx = parts[0][1][:, 1]
    for _, st in parts[1:]:
        mx = torch.maximum(mx, st[:, 1])                         # (B, H)
    b, h = mx.shape
    num = o_c = den = 0.0
    for o_sc, st in parts:
        r = torch.exp(st[:, 1] - mx)                             # <= 1
        num = num + o_sc[:, 0].reshape(b, h, -1) * r[..., None]
        o_c = o_c + o_sc[:, 1].reshape(b, h, -1)
        den = den + st[:, 0] * r
    if normalise:
        return (0.5 * (num / den.clamp_min(1e-30)[..., None] + o_c))[:, None]
    return torch.stack([num.reshape(b, -1), o_c.reshape(b, -1)], dim=1), torch.stack([den, mx], 1)
