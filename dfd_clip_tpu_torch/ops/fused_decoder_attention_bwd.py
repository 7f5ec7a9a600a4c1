"""Backward of the fused decoder attention for the trainable leaves
(counterpart of dfd_clip_tpu/ops/pallas_decoder_attention.py:
fused_decoder_attention_bwd, and of _bwd_math in
dfd_clip_tpu/ops/decoder_attention_vjp.py, its plain version).

On a CUDA tensor this launches csrc/decoder_attention_bwd.cu once: dq_smax,
dq_coda and dpos over slot ``layer`` of the stacked K/V export (or over
unstacked K/V with ``layer`` None), from the forward's saved softmax state,
with the softmax coupling term S = 0.5 sum_d g0 o_s and g0's f32 values
computed inside the kernel, so the wrapper does no arithmetic (its launch
geometry is _cuda.bwd_geometry); with ``with_kv`` the same launch also
writes the slot's dK and dV in K/V's bf16. On a CPU tensor the plain version
(``_bwd_math``) runs instead. ``_bwd_math`` counts its calls in
``_cuda.PLAIN_CALLS``, so a run on the card can show that it never ran.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .fused_decoder_attention import check_inputs


def _bwd_math(layer, q_smax, q_coda, k, v, mask, temporal_pos, denom, mx, ct, o_s=None):
    """Cotangents (dq_smax, dq_coda, dpos, dk, dv) from the saved softmax
    stats, all arithmetic in f32. dq and dpos come back in f32 (the caller
    casts them to its leaves' dtypes); dk/dv, in K/V's dtype, are for the
    SELECTED slot (B, L, H, D) and are zero at masked tokens. ``o_s`` (B, H,
    D), the normalised softmax output: when given, the softmax coupling
    term sum_l a_s da = 0.5 sum_d g0 o_s comes from it, as the kernel takes
    it; a token shard must take it so, since its own affinities sum over
    its tokens only."""
    _cuda.PLAIN_CALLS["_bwd_math"] += 1
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
    if o_s is None:
        coupling = torch.sum(a_s * da, dim=1, keepdim=True)
    else:
        coupling = 0.5 * torch.sum(g0 * o_s.to(f32), dim=-1)[:, None]
    dls = a_s * (da - coupling)
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


def _f32_rows(name, t, shape):
    """t as the kernel reads it: f32 with a contiguous last axis (a copy only
    where it is not)."""
    if t.shape != shape:
        raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    return t if t.dtype == torch.float32 and t.stride(-1) == 1 else t.float().contiguous()


def fused_decoder_attention_bwd(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor], layer: Optional[int],
    denom: torch.Tensor, mx: torch.Tensor, o_s: torch.Tensor, ct: torch.Tensor,
    dq_dtype: torch.dtype = torch.float32, stage_clock: Optional[torch.Tensor] = None,
    with_kv: bool = False, shard: bool = False,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The forward's inputs, its saved denominator and maximum (B, H) f32,
    its normalised softmax output o_s (B, H, D) f32 and the output
    cotangent ct (B, 1, H, D) -> (dq_smax (B,1,H,D), dq_coda (B,1,H,D) in
    ``dq_dtype`` (f32 or bf16: the kernel writes the query leaves' dtype
    itself), dpos (L,H,D) f32 or None when temporal_pos is None).
    ``stage_clock``: None, or an int64 tensor on the card of
    _cuda.bwd_geometry's grid x len(_cuda.BWD_CLOCK) entries, into which
    each block writes %globaltimer (ns) at the BWD_CLOCK points of its first
    item (tools/bench_decoder_bwd.py reads it). ``with_kv``: also return the
    slot's dK and dV, (B, L, H, D) in K/V's dtype, zero at masked tokens.
    ``shard``: K/V are one rank's token shard and the stats and o_s the seq
    row's combined ones (ops/spmd.py); the kernel reads them the same way,
    the plain version then takes the coupling from o_s (``_bwd_math``)."""
    name = "fused_decoder_attention_bwd"
    if dq_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dq_dtype {dq_dtype} is neither f32 nor bf16")
    if _cuda.on_cpu(name, k):
        return fused_decoder_attention_bwd_plain(q_smax, q_coda, k, v, mask, temporal_pos,
                                                 layer, denom, mx, o_s, ct, dq_dtype, with_kv,
                                                 shard)
    kl, vl, b, l, h, d = check_inputs(name, q_smax, q_coda, k, v, mask, temporal_pos, layer)
    if denom.shape != (b, h) or mx.shape != (b, h) or o_s.shape != (b, h, d) \
            or ct.shape != (b, 1, h, d):
        raise ValueError(f"{name}: stats must be (B, H), o_s (B, H, D) and ct (B, 1, H, D)")
    for t in (denom, mx, o_s, ct):
        if t.device != kl.device:
            raise ValueError(f"{name}: stats and ct must be on K/V's card")
    f32 = torch.float32
    g0 = ct.reshape(b, h, d)
    if g0.dtype not in (f32, torch.bfloat16) or not g0.is_contiguous():
        g0 = g0.float().contiguous()
    o_s = o_s if o_s.dtype == f32 and o_s.is_contiguous() else o_s.float().contiguous()
    denom, mx = _f32_rows(name, denom, (b, h)), _f32_rows(name, mx, (b, h))
    if denom.stride(0) != mx.stride(0):
        denom, mx = denom.contiguous(), mx.contiguous()
    index = kl.get_device()
    geo = _cuda.bwd_geometry(b, l, h, _cuda._sms(index))
    # one f32 allocation: dpos, then the chunks' dq partials (scratch)
    n_pos = l * h * d if temporal_pos is not None else 0
    scratch = torch.empty(n_pos + geo["chunks"] * b * 2 * h * d, dtype=f32, device=kl.device)
    dpos = scratch[:n_pos].view(l, h, d) if temporal_pos is not None else None
    dq = torch.empty((b, 2, h * d), dtype=dq_dtype, device=kl.device)
    dk = torch.empty_like(kl) if with_kv else None
    dv = torch.empty_like(vl) if with_kv else None
    stream = torch._C._cuda_getCurrentRawStream(index)
    ticket = _cuda.bwd_ticket(index, stream, h)
    if stage_clock is not None:
        _cuda.require_cuda(name, stage_clock, dtype=torch.int64)
        if stage_clock.numel() < geo["grid"] * len(_cuda.BWD_CLOCK) \
                or not stage_clock.is_contiguous():
            raise ValueError(f"{name}: stage_clock needs {geo['grid']} x "
                             f"{len(_cuda.BWD_CLOCK)} contiguous int64")
    err = _cuda.library().dfd_decoder_attention_bwd(
        q_smax.data_ptr(), q_coda.data_ptr(), q_smax.stride(0), g0.data_ptr(),
        int(g0.dtype == f32), o_s.data_ptr(), denom.data_ptr(), mx.data_ptr(), denom.stride(0),
        kl.data_ptr(), vl.data_ptr(), mask.data_ptr(),
        temporal_pos.data_ptr() if temporal_pos is not None else None,
        scratch.data_ptr() + 4 * n_pos, dq.data_ptr(), int(dq_dtype == f32),
        dpos.data_ptr() if dpos is not None else None,
        dk.data_ptr() if with_kv else None, dv.data_ptr() if with_kv else None,
        ticket.data_ptr(),
        b, l, h, geo["tiles"], geo["chunk_tiles"], geo["chunks"], geo["group"], geo["grid"],
        geo["smem"], d ** -0.5, stage_clock.data_ptr() if stage_clock is not None else None,
        stream)
    _cuda.check_launch(name, err)
    _cuda.LAUNCHES[name] += 1
    out = (dq[:, 0].reshape(b, 1, h, d), dq[:, 1].reshape(b, 1, h, d), dpos)
    return out + (dk, dv) if with_kv else out


def fused_decoder_attention_bwd_plain(q_smax, q_coda, k, v, mask, temporal_pos, layer,
                                      denom, mx, o_s, ct, dq_dtype=torch.float32,
                                      with_kv: bool = False, shard: bool = False):
    """Plain version of fused_decoder_attention_bwd (same contract; the
    coupling term comes from the affinities, and from o_s for a ``shard``)."""
    dqs, dqc, dpos, dk, dv = _bwd_math(layer, q_smax, q_coda, k, v, mask, temporal_pos,
                                       denom, mx, ct, o_s if shard else None)
    out = (dqs.to(dq_dtype), dqc.to(dq_dtype), dpos)
    return out + (dk, dv) if with_kv else out
