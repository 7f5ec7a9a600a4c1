"""Backward of the fused decoder attention for the trainable leaves
(counterpart of dfd_clip_tpu/ops/pallas_decoder_attention.py:
fused_decoder_attention_bwd, and of _bwd_math in
dfd_clip_tpu/ops/decoder_attention_vjp.py, its plain version).

On a CUDA tensor this launches csrc/decoder_attention_bwd.cu: dq_smax,
dq_coda and dpos in one pass over slot ``layer`` of the stacked K/V export,
from the forward's saved softmax state. The wrapper computes the softmax
coupling term S = 0.5 sum_d g0 o_s before the launch. On a CPU tensor the
plain version (``_bwd_math``, which also gives dK/dV) runs instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .fused_decoder_attention import check_inputs

TILE = 64   # tokens per block of the kernel (csrc/decoder_attention_bwd.cu)


def _bwd_math(layer, q_smax, q_coda, k, v, mask, temporal_pos, denom, mx, ct):
    """Cotangents (dq_smax, dq_coda, dpos, dk, dv) from the saved softmax
    stats, all arithmetic in f32. dq and dpos come back in f32 (the caller
    casts them to its leaves' dtypes); dk/dv, in K/V's dtype, are for the
    SELECTED slot (B, L, H, D) and are zero at masked tokens."""
    kl, vl = (k[layer], v[layer]) if layer is not None else (k, v)
    b, l = mask.shape
    _, _, h, d = q_smax.shape
    s = d ** -0.5
    f32 = torch.float32

    qs = q_smax[:, 0].to(f32)                            # (B, H, D)
    qc = q_coda[:, 0].to(f32)
    kp = kl.to(f32)                                      # (B, L, H, D)
    vp = vl.to(f32)
    if temporal_pos is not None:
        pos = temporal_pos.to(f32).expand(l, h, d)
        kp = kp + pos[None]
        vp = vp + pos[None]
    m = mask[:, :, None]                                 # (B, L, 1) -> (B,L,H)
    g0 = ct[:, 0].to(f32)                                # (B, H, D)

    # ---- reconstruct the affinities from the saved stats (f32) ----
    ls = torch.einsum("bhd,blhd->blh", qs * s, kp)
    p = torch.where(m, torch.exp(ls - mx[:, None, :]), 0.0)
    a_s = p / denom.clamp_min(1e-30)[:, None, :]         # (B, L, H)
    lc = torch.einsum("bhd,blhd->blh", qc * s, kp)
    t = torch.tanh(lc)
    u = torch.sum(torch.abs(qc[:, None] - kp), dim=-1)   # (B, L, H)
    g_un = 2.0 * torch.sigmoid(-u * s)
    gate = torch.where(m, g_un, 0.0)

    # ---- cotangents; out = 0.5 * sum_l (a_s + tanh*gate) * vp ----
    w = torch.einsum("bhd,blhd->blh", g0, vp)            # d(a_s + a_c)
    da = 0.5 * w
    dls = a_s * (da - torch.sum(a_s * da, dim=1, keepdim=True))
    dt = da * gate
    dgate = da * t
    dlc = dt * (1.0 - t * t)
    # gate = mask * 2*sigmoid(-u*s); d(2σ(x))/dx = g_un*(1 - g_un/2)
    du = -s * torch.where(m, dgate * g_un * (1.0 - 0.5 * g_un), 0.0)
    sign = torch.sign(qc[:, None] - kp)                  # (B, L, H, D)

    dqs = s * torch.einsum("blh,blhd->bhd", dls, kp)
    dqc = (s * torch.einsum("blh,blhd->bhd", dlc, kp)
           + torch.einsum("blh,blhd->bhd", du, sign))

    # kp = k + pos and vp = v + pos, so dk == dkp and dv == dvp (the pos
    # cotangent is their sum reverse-broadcast)
    dkp = (dls[..., None] * (qs[:, None] * s)
           + dlc[..., None] * (qc[:, None] * s)
           - du[..., None] * sign)                       # (B, L, H, D)
    dvp = 0.5 * (a_s + t * gate)[..., None] * g0[:, None]

    dpos = None
    if temporal_pos is not None:
        dpos = torch.sum(dkp + dvp, dim=0).sum_to_size(temporal_pos.shape)

    return dqs[:, None], dqc[:, None], dpos, dkp.to(kl.dtype), dvp.to(vl.dtype)


def fused_decoder_attention_bwd(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor], layer: Optional[int],
    denom: torch.Tensor, mx: torch.Tensor, o_s: torch.Tensor, ct: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The forward's inputs, its saved denominator and maximum (B, H) f32,
    its normalised softmax output o_s (B, H, D) f32 and the output
    cotangent ct (B, 1, H, D) -> (dq_smax (B,1,H,D) f32, dq_coda (B,1,H,D)
    f32, dpos (L,H,D) f32 or None when temporal_pos is None)."""
    if _cuda.on_cpu("fused_decoder_attention_bwd", k):
        return fused_decoder_attention_bwd_plain(q_smax, q_coda, k, v, mask, temporal_pos,
                                                 layer, denom, mx, o_s, ct)
    kl, vl, b, l, h, d = check_inputs("fused_decoder_attention_bwd", q_smax, q_coda, k, v,
                                      mask, temporal_pos, layer)
    if denom.shape != (b, h) or mx.shape != (b, h) or o_s.shape != (b, h, d) \
            or ct.shape != (b, 1, h, d):
        raise ValueError("fused_decoder_attention_bwd: stats must be (B, H), o_s (B, H, D) "
                         "and ct (B, 1, H, D)")
    for t in (denom, mx, o_s, ct):
        if t.device != kl.device:
            raise ValueError("fused_decoder_attention_bwd: stats and ct must be on K/V's card")
    f32 = torch.float32
    g0 = ct[:, 0].to(f32).contiguous()                                  # (B, H, D)
    s_term = 0.5 * torch.einsum("bhd,bhd->bh", g0, o_s.to(f32))
    stats = torch.stack([mx.to(f32), denom.to(f32), s_term], dim=1).contiguous()   # (B, 3, H)
    dq_part = torch.empty((-(-l // TILE), b, 2, h * d), dtype=f32, device=kl.device)
    dq = torch.empty((b, 2, h * d), dtype=f32, device=kl.device)
    dpos = (torch.empty((l, h, d), dtype=f32, device=kl.device)
            if temporal_pos is not None else None)
    err = _cuda.library().dfd_decoder_attention_bwd(
        q_smax.data_ptr(), q_coda.data_ptr(), q_smax.stride(0), g0.data_ptr(),
        stats.data_ptr(), kl.data_ptr(), vl.data_ptr(), mask.data_ptr(),
        temporal_pos.data_ptr() if temporal_pos is not None else None,
        dq_part.data_ptr(), dq.data_ptr(), dpos.data_ptr() if dpos is not None else None,
        b, l, h, d ** -0.5, _cuda.stream())
    _cuda.check_launch("fused_decoder_attention_bwd", err)
    _cuda.LAUNCHES["fused_decoder_attention_bwd"] += 1
    return dq[:, 0].reshape(b, 1, h, d), dq[:, 1].reshape(b, 1, h, d), dpos


def fused_decoder_attention_bwd_plain(q_smax, q_coda, k, v, mask, temporal_pos, layer,
                                      denom, mx, o_s, ct):
    """Plain version of fused_decoder_attention_bwd (same contract; the
    coupling term comes from the affinities, so o_s is not read)."""
    dqs, dqc, dpos, _, _ = _bwd_math(layer, q_smax, q_coda, k, v, mask, temporal_pos,
                                     denom, mx, ct)
    return dqs, dqc, dpos
