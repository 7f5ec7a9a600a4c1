"""The encoder block (counterparts of ``fused_encoder_attn_block``,
``fused_encoder_mlp_block`` and ``fused_encoder_block`` in
dfd_clip_tpu/ops/pallas_attention.py).

On a CUDA tensor each function is a short chain of this package's kernels:

  attention half: layer_norm_rows -> gemm (qkv, + K/V export)
                  -> encoder_attention -> gemm (out-proj, + residual)
  MLP half:       layer_norm_rows -> gemm (c_fc, + QuickGELU)
                  -> gemm (c_proj, + residual)
  int8 split pair (W8A8, the compute_int8 path at width 1024, ViT-L):
    attention:    layer_norm_quant -> gemm_s8 (qkv -> bf16, + K/V export)
                  -> encoder_attention -> gemm (bf16 out-proj, + residual)
    MLP:          layer_norm_quant -> gemm_s8_quant (c_fc, QuickGELU, its
                  rows quantised) -> gemm_s8 (c_proj, rounded to bf16, + h)
  whole int8 block (W8A8, the compute_int8 path at width <= 768):
                  layer_norm_quant -> gemm_s8 (qkv -> bf16, + K/V export)
                  -> encoder_attention (f32), or with int8_attn
                     encoder_attention_int8 (f32) -> quant_rows
                  -> gemm_s8 (out-proj, + h -> f32 hmid)
                  -> layer_norm_quant -> gemm_s8_quant (c_fc, QuickGELU,
                  its rows quantised) -> gemm_s8 (c_proj, + f32 hmid -> bf16)
  whole bf16 block (DFD_FUSED_BLOCK=full on a bf16 tower):
                  layer_norm_rows -> gemm (qkv, + K/V export)
                  -> encoder_attention -> gemm (out-proj, + h in f32 -> f32 hmid)
                  -> layer_norm_rows (f32 rows) -> gemm (c_fc, + QuickGELU)
                  -> gemm (c_proj, + f32 hmid -> bf16)
  int8 last_only: layer_norm_quant -> gemm_s8 (K/V columns, + export)

With ``kv_rows8`` (kv_dtype "int8_rows") the K/V export is quantised per
row (quant_rows, the _quant_kv_rows constants) from the bf16 K/V columns into
int8 slots, with (N, T', 1) f32 scales.

The int8 MLP's (T, 4W) intermediate stays on chip as in the TPU kernels:
gemm_s8_quant quantises c_fc's QuickGELU rows in its epilogue (a cluster
of CTAs holds a whole row; the row's maximum crosses the cluster), so no
f32 intermediate is written and read back. The packed qkv stream, the
attention output and the bf16 MLP intermediate still go through device
memory (PERF.md counts the bytes); fusing them away is later work. On a
CPU tensor the plain versions below run
instead; they keep the kernels' rounding points (LayerNorm in f32, biases
added in f32 before the bf16 cast, QuickGELU in f32, the residual added in
the activation dtype; on the int8 block the f32 residual stream between the
halves and the quantisation of f32 values without a bf16 round trip). The
int8 split pair keeps the Pallas kernels' points, not the XLA
composition's: its out-projection is bf16, not W8A8
(pallas_attention.py:403-407), and its MLP rounds the c_proj output to bf16
before adding h (:1270).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import layer_norm, linear_f32_bias
from . import _cuda
from .attention import attn_int8_cols_plain, encoder_attention_int8, plain_attention_qkv
from .int8 import export_kv_rows8, layer_norm_f32, quant_rows_plain, w8a8_dot_plain, weight_q


def encoder_attention(qkv: torch.Tensor, frames: int, tokens: int, heads: int,
                      head_dim: int, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel: self-attention over packed bf16 qkv rows (frames * tokens, 3W)
    -> (frames * tokens, W) in ``out_dtype`` (bf16, or f32 for the int8
    block's out-projection), at any token count."""
    out = _cuda.encoder_attention_packed(qkv, frames, tokens, heads, head_dim, out_dtype)
    _cuda.LAUNCHES["encoder_attention"] += 1
    return out


def _kv_slots(n: int, t_out: int, w: int, dtype, device, export_into):
    if export_into is not None:
        kacc, vacc, slot, _ = export_into
        return kacc[slot], vacc[slot]
    return (torch.empty((n, t_out, w), dtype=dtype, device=device),
            torch.empty((n, t_out, w), dtype=dtype, device=device))


def _kv_result(k, v, n, t_out, heads, head_dim, export_into):
    if export_into is not None:
        return export_into[0], export_into[1]   # (Lsel, N, T', W) buffers
    return k.reshape(n, t_out, heads, head_dim), v.reshape(n, t_out, heads, head_dim)


def _qkv_projection(h2, ln, in_proj, int8_gemm, *, col_off=0, store=True, export=None):
    """Kernels: LN1 and the qkv projection (columns from ``col_off`` on) of
    bf16 rows h2 (R, W): layer_norm_rows + gemm, or with ``int8_gemm``
    layer_norm_quant + gemm_s8 (bf16 output), with gemm's K/V export."""
    b = in_proj["b"].float()[col_off:]
    if int8_gemm:
        yq, ys = _cuda.layer_norm_quant(h2, ln["scale"].float(), ln["bias"].float())
        wq, ws = weight_q(in_proj)
        return _cuda.gemm_s8(yq, ys, wq[col_off:], ws[:, col_off:], b, store=store,
                             export=export, col_off=col_off)
    y = _cuda.layer_norm_rows(h2, ln["scale"].float(), ln["bias"].float())
    return _cuda.gemm(y, in_proj["w"].to(h2.dtype)[:, col_off:], b, store=store, export=export,
                      col_off=col_off)


def _w8a8_plain(x32: torch.Tensor, p: dict) -> torch.Tensor:
    """The kernels' W8A8 linear, plain: _quant_rows of f32 rows, the int8
    product with its dequant, plus the bias, in f32."""
    xq, xs = quant_rows_plain(x32)
    wq, ws = weight_q(p)
    return w8a8_dot_plain(xq, xs, wq, ws) + p["b"].float()


def export_kv(qkv2, n, t, w, lo, kv_pad, kv_rows8, export_into):
    """The K/V export of the packed (N * T, 3W) qkv rows with torch ops (the
    kv_rows8 quantiser launches its kernel on a CUDA tensor): (k_slot, v_slot,
    scales) with scales () on the bf16 path."""
    if kv_rows8:
        slots = None
        if export_into is not None:
            kacc, vacc, slot, _ = export_into
            slots = (kacc[slot], vacc[slot])
        k, v, ks, vs = export_kv_rows8(qkv2[:, w: 2 * w], qkv2[:, 2 * w:], n, t, lo, kv_pad,
                                       slots)
        return k, v, (ks, vs)
    rows = qkv2.reshape(n, t, 3 * w)[:, lo:]
    k = F.pad(rows[..., w: 2 * w], (0, 0, 0, kv_pad))
    v = F.pad(rows[..., 2 * w:], (0, 0, 0, kv_pad))
    if export_into is not None:
        kacc, vacc, slot, _ = export_into
        kacc[slot].copy_(k)
        vacc[slot].copy_(v)
    return k, v, ()


def fused_encoder_attn_block(
    h: torch.Tensor, ln: dict, attn: dict, heads: int, head_dim: int, *,
    export: bool = False, drop_cls: bool = False, last_only: bool = False,
    export_into: Optional[Tuple] = None, kv_pad: int = 0, int8_gemm: bool = False,
    kv_rows8: bool = False,
):
    """LN1 -> qkv -> attention -> out-proj -> +residual on h (N, T, W).

    Returns ``h_out``; ``(h_out, k, v)`` with ``export``; ``(k, v)`` with
    ``last_only`` (LN1 + the K/V columns of the qkv projection only). K/V are
    (N, T', H, D) with T' = T - drop_cls + kv_pad, the ``kv_pad`` rows zero;
    with ``export_into = (k_buf, v_buf, slot, n_slots)`` they are written into
    slot ``slot`` of the (n_slots, N, T', W) buffers, which are returned.
    ``kv_rows8``: K/V int8 with per-row scales, and the returns gain
    ``(k_scale, v_scale)``, (N, T', 1) f32, pad rows 0. ``int8_gemm``: the
    W8A8 qkv projection of the int8 tower (LN1 quantised per row in f32);
    the out-projection stays bf16, as in the TPU kernel."""
    if _cuda.on_cpu("fused_encoder_attn_block", h):
        return fused_encoder_attn_block_plain(
            h, ln, attn, heads, head_dim, export=export, drop_cls=drop_cls,
            last_only=last_only, export_into=export_into, kv_pad=kv_pad, int8_gemm=int8_gemm,
            kv_rows8=kv_rows8)
    n, t, w = h.shape
    if w != heads * head_dim:
        raise ValueError("fused_encoder_attn_block: width != heads * head_dim")
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    dt = h.dtype
    h2 = h.reshape(n * t, w)
    k_slot = v_slot = None
    if export or last_only:
        k_slot, v_slot = _kv_slots(n, t_out, w, torch.int8 if kv_rows8 else dt, h.device,
                                   export_into)
    bf16_export = (k_slot, v_slot, t, t_out, lo, w) if k_slot is not None and not kv_rows8 \
        else None
    scales = ()
    if last_only:
        kv = _qkv_projection(h2, ln, attn["in_proj"], int8_gemm, col_off=w, store=kv_rows8,
                             export=bf16_export)
        if kv_rows8:
            scales = export_kv_rows8(kv[:, :w], kv[:, w:], n, t, lo, kv_pad,
                                     (k_slot, v_slot))[2:]
        _cuda.LAUNCHES["fused_encoder_attn_block"] += 1
        return (*_kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into), *scales)
    qkv = _qkv_projection(h2, ln, attn["in_proj"], int8_gemm, export=bf16_export)
    if export and kv_rows8:
        scales = export_kv_rows8(qkv[:, w: 2 * w], qkv[:, 2 * w:], n, t, lo, kv_pad,
                                 (k_slot, v_slot))[2:]
    att = encoder_attention(qkv, n, t, heads, head_dim)
    h_out = _cuda.gemm(att, attn["out_proj"]["w"].to(dt), attn["out_proj"]["b"].float(),
                       residual=h2).reshape(n, t, w)
    _cuda.LAUNCHES["fused_encoder_attn_block"] += 1
    if export:
        return (h_out, *_kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into),
                *scales)
    return h_out


def fused_encoder_attn_block_plain(
    h: torch.Tensor, ln: dict, attn: dict, heads: int, head_dim: int, *,
    export: bool = False, drop_cls: bool = False, last_only: bool = False,
    export_into: Optional[Tuple] = None, kv_pad: int = 0, int8_gemm: bool = False,
    kv_rows8: bool = False,
):
    """Plain version of fused_encoder_attn_block (same contract)."""
    n, t, w = h.shape
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    h2 = h.reshape(n * t, w)
    if int8_gemm:
        qkv = _w8a8_plain(layer_norm_f32(ln, h2), attn["in_proj"]).to(h.dtype)
    else:
        qkv = linear_f32_bias(layer_norm(ln, h2), attn["in_proj"]["w"], attn["in_proj"]["b"])
    result = None
    if export or last_only:
        k, v, scales = export_kv(qkv, n, t, w, lo, kv_pad, kv_rows8, export_into)
        result = (*_kv_result(k, v, n, t_out, heads, head_dim, export_into), *scales)
    if last_only:
        return result
    att = plain_attention_qkv(qkv.reshape(n, t, 3 * w), heads, head_dim)
    h_out = h + linear_f32_bias(att, attn["out_proj"]["w"], attn["out_proj"]["b"])
    return (h_out, *result) if export else h_out


def fused_encoder_mlp_block(h: torch.Tensor, ln: dict, mlp: dict,
                            int8_gemm: bool = False) -> torch.Tensor:
    """LN2 -> c_fc -> QuickGELU (f32) -> c_proj -> +residual on h (N, T, W).
    ``int8_gemm``: both GEMMs W8A8 (LN2 and the GELU output quantised per row
    in f32, the latter in c_fc's epilogue on the card), the c_proj output
    rounded to h's dtype before h is added."""
    if _cuda.on_cpu("fused_encoder_mlp_block", h):
        return fused_encoder_mlp_block_plain(h, ln, mlp, int8_gemm=int8_gemm)
    n, t, w = h.shape
    dt = h.dtype
    h2 = h.reshape(n * t, w)
    if int8_gemm:
        (wfc, sfc), (wpr, spr) = weight_q(mlp["c_fc"]), weight_q(mlp["c_proj"])
        yq, ys = _cuda.layer_norm_quant(h2, ln["scale"].float(), ln["bias"].float())
        mq, m_s = _cuda.gemm_s8_quant(yq, ys, wfc, sfc, mlp["c_fc"]["b"].float())
        out = _cuda.gemm_s8(mq, m_s, wpr, spr, mlp["c_proj"]["b"].float(), residual=h2,
                            residual_after_cast=True, out_dtype=dt)
    else:
        y = _cuda.layer_norm_rows(h2, ln["scale"].float(), ln["bias"].float())
        mid = _cuda.gemm(y, mlp["c_fc"]["w"].to(dt), mlp["c_fc"]["b"].float(), gelu=True)
        out = _cuda.gemm(mid, mlp["c_proj"]["w"].to(dt), mlp["c_proj"]["b"].float(),
                         residual=h2)
    _cuda.LAUNCHES["fused_encoder_mlp_block"] += 1
    return out.reshape(n, t, w)


def fused_encoder_mlp_block_plain(h: torch.Tensor, ln: dict, mlp: dict,
                                  int8_gemm: bool = False) -> torch.Tensor:
    """Plain version of fused_encoder_mlp_block."""
    if int8_gemm:
        mid = _w8a8_plain(layer_norm_f32(ln, h), mlp["c_fc"])
        mid = mid * torch.sigmoid(1.702 * mid)
        return h + _w8a8_plain(mid, mlp["c_proj"]).to(h.dtype)
    y = layer_norm(ln, h)
    mid = y.float() @ mlp["c_fc"]["w"].to(h.dtype).float() + mlp["c_fc"]["b"].float()
    mid = (mid * torch.sigmoid(1.702 * mid)).to(h.dtype)
    return h + linear_f32_bias(mid, mlp["c_proj"]["w"], mlp["c_proj"]["b"])


INT8_ATTN = ("0", "1", "qk")


def check_int8_attn(int8_attn: str) -> None:
    """Raise unless ``int8_attn`` is one of INT8_ATTN."""
    if int8_attn not in INT8_ATTN:
        raise ValueError(f"int8_attn must be one of {INT8_ATTN}, got {int8_attn!r}")


def fused_encoder_block(
    h: torch.Tensor, ln1: dict, attn: dict, ln2: dict, mlp: dict, heads: int, head_dim: int,
    *, export: bool = False, drop_cls: bool = False, export_into: Optional[Tuple] = None,
    int8_gemm: bool = True, kv_rows8: bool = False, kv_pad: int = 0, int8_attn: str = "0",
):
    """The whole encoder block on h (N, T, W) with the TPU kernel's
    contract: ``h_out``, or with ``export`` ``(h_out, k, v)`` (K/V as in
    fused_encoder_attn_block, ``export_into`` and ``kv_pad`` alike), plus
    ``(k_scale, v_scale)`` with ``kv_rows8``. ``int8_gemm``: the four GEMMs
    (qkv, out-proj, c_fc, c_proj) W8A8 on the int8 weights of weight_q;
    otherwise bf16. The residual stream between the halves stays f32
    (``hmid32``). ``int8_attn`` "1" or "qk" (int8 only, ignored in bf16 as
    in the JAX kernel): the attention is encoder_attention_int8."""
    check_int8_attn(int8_attn)
    if _cuda.on_cpu("fused_encoder_block", h):
        return fused_encoder_block_plain(h, ln1, attn, ln2, mlp, heads, head_dim,
                                         export=export, drop_cls=drop_cls,
                                         export_into=export_into, int8_gemm=int8_gemm,
                                         kv_rows8=kv_rows8, kv_pad=kv_pad, int8_attn=int8_attn)
    n, t, w = h.shape
    if w != heads * head_dim:
        raise ValueError("fused_encoder_block: width != heads * head_dim")
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    dt = h.dtype
    h2 = h.reshape(n * t, w)
    k_slot = v_slot = None
    if export:
        k_slot, v_slot = _kv_slots(n, t_out, w, torch.int8 if kv_rows8 else dt, h.device,
                                   export_into)
    bf16_export = (k_slot, v_slot, t, t_out, lo, w) if export and not kv_rows8 else None
    scales = ()
    if not int8_gemm:
        y = _cuda.layer_norm_rows(h2, ln1["scale"].float(), ln1["bias"].float())
        xf = _cuda.gemm(y, attn["in_proj"]["w"].to(dt), attn["in_proj"]["b"].float(),
                        export=bf16_export)
        if export and kv_rows8:
            scales = export_kv_rows8(xf[:, w: 2 * w], xf[:, 2 * w:], n, t, lo, kv_pad,
                                     (k_slot, v_slot))[2:]
        att = encoder_attention(xf, n, t, heads, head_dim)
        hmid = _cuda.gemm(att, attn["out_proj"]["w"].to(dt), attn["out_proj"]["b"].float(),
                          residual=h2, residual_before_cast=True, out_dtype=torch.float32)
        y2 = _cuda.layer_norm_rows(hmid, ln2["scale"].float(), ln2["bias"].float())
        mid = _cuda.gemm(y2, mlp["c_fc"]["w"].to(dt), mlp["c_fc"]["b"].float(), gelu=True)
        h_out = _cuda.gemm(mid, mlp["c_proj"]["w"].to(dt), mlp["c_proj"]["b"].float(),
                           residual=hmid).reshape(n, t, w)
        _cuda.LAUNCHES["fused_encoder_block"] += 1
        if export:
            return (h_out, *_kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into),
                    *scales)
        return h_out
    (wqkv, sqkv), (wo, so), (wfc, sfc), (wpr, spr) = (
        weight_q(p) for p in (attn["in_proj"], attn["out_proj"], mlp["c_fc"], mlp["c_proj"]))
    yq, ys = _cuda.layer_norm_quant(h2, ln1["scale"].float(), ln1["bias"].float())
    xf = _cuda.gemm_s8(yq, ys, wqkv, sqkv, attn["in_proj"]["b"].float(), export=bf16_export)
    if export and kv_rows8:
        scales = export_kv_rows8(xf[:, w: 2 * w], xf[:, 2 * w:], n, t, lo, kv_pad,
                                 (k_slot, v_slot))[2:]
    if int8_attn == "0":
        att = encoder_attention(xf, n, t, heads, head_dim, out_dtype=torch.float32)
    else:
        att = encoder_attention_int8(xf, n, t, heads, head_dim, qk_only=int8_attn == "qk")
    aq, a_s = _cuda.quant_rows(att)
    hmid = _cuda.gemm_s8(aq, a_s, wo, so, attn["out_proj"]["b"].float(), residual=h2,
                         out_dtype=torch.float32)
    y2q, y2s = _cuda.layer_norm_quant(hmid, ln2["scale"].float(), ln2["bias"].float())
    mq, m_s = _cuda.gemm_s8_quant(y2q, y2s, wfc, sfc, mlp["c_fc"]["b"].float())
    h_out = _cuda.gemm_s8(mq, m_s, wpr, spr, mlp["c_proj"]["b"].float(), residual=hmid,
                          out_dtype=dt).reshape(n, t, w)
    _cuda.LAUNCHES["fused_encoder_block"] += 1
    if export:
        return (h_out, *_kv_result(k_slot, v_slot, n, t_out, heads, head_dim, export_into),
                *scales)
    return h_out


def fused_encoder_block_plain(
    h: torch.Tensor, ln1: dict, attn: dict, ln2: dict, mlp: dict, heads: int, head_dim: int,
    *, export: bool = False, drop_cls: bool = False, export_into: Optional[Tuple] = None,
    int8_gemm: bool = True, kv_rows8: bool = False, kv_pad: int = 0, int8_attn: str = "0",
):
    """Plain version of fused_encoder_block (same contract), the arithmetic
    of _make_full_block_kernel. int8: LN1 in f32 -> _quant_rows -> W8A8 qkv
    + bias -> bf16 xf (and its export) -> attention with an f32 output (or
    _attn_int8_cols) -> _quant_rows -> W8A8 out-proj + bias + h in f32 ->
    LN2 in f32 -> _quant_rows -> W8A8 c_fc + bias -> QuickGELU in f32 ->
    _quant_rows -> W8A8 c_proj + bias + hmid in f32 -> h's dtype. bf16: LN1
    -> qkv + bias in f32 -> xf -> attention -> out-proj + bias + h in f32 ->
    LN2 of the f32 hmid, rounded -> c_fc + bias, QuickGELU in f32, rounded ->
    c_proj + bias + hmid in f32 -> h's dtype."""
    check_int8_attn(int8_attn)
    n, t, w = h.shape
    lo = 1 if drop_cls else 0
    t_out = t - lo + kv_pad
    dt = h.dtype
    h2 = h.reshape(n * t, w)
    if int8_gemm:
        xf = _w8a8_plain(layer_norm_f32(ln1, h2), attn["in_proj"]).to(dt)
    else:
        xf = linear_f32_bias(layer_norm(ln1, h2), attn["in_proj"]["w"], attn["in_proj"]["b"])
    result = ()
    if export:
        k, v, scales = export_kv(xf, n, t, w, lo, kv_pad, kv_rows8, export_into)
        result = (*_kv_result(k, v, n, t_out, heads, head_dim, export_into), *scales)
    if not int8_gemm:
        att = plain_attention_qkv(xf.reshape(n, t, 3 * w), heads, head_dim).reshape(n * t, w)
        hmid = h2.float() + (att.float() @ attn["out_proj"]["w"].to(dt).float()
                             + attn["out_proj"]["b"].float())
        y2 = layer_norm(ln2, hmid).to(dt)
        mid = y2.float() @ mlp["c_fc"]["w"].to(dt).float() + mlp["c_fc"]["b"].float()
        mid = (mid * torch.sigmoid(1.702 * mid)).to(dt)
        h_out = (hmid + (mid.float() @ mlp["c_proj"]["w"].to(dt).float()
                         + mlp["c_proj"]["b"].float())).to(dt).reshape(n, t, w)
        return (h_out, *result) if export else h_out
    w8a8 = _w8a8_plain
    if int8_attn == "0":
        att = plain_attention_qkv(xf.reshape(n, t, 3 * w), heads, head_dim,
                                  out_dtype=torch.float32).reshape(n * t, w)
    else:
        att = attn_int8_cols_plain(xf, n, t, heads, head_dim, qk_only=int8_attn == "qk")
    hmid = h2.float() + w8a8(att, attn["out_proj"])
    mid = w8a8(layer_norm_f32(ln2, hmid), mlp["c_fc"])
    mid = mid * torch.sigmoid(1.702 * mid)
    h_out = (hmid + w8a8(mid, mlp["c_proj"])).to(dt).reshape(n, t, w)
    return (h_out, *result) if export else h_out
