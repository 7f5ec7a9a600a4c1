"""W8A8 building blocks of the int8 encoder (counterparts of
dfd_clip_tpu/ops/pallas_attention.py's _quant_rows, _w8a8_dot,
quantize_weight / weight_q and _quant_kv_rows, and of the f32 LayerNorm that
feeds _quant_rows inside _make_full_block_kernel).

The kernels (csrc/quant_rows.cu, csrc/gemm_s8.cu, csrc/gemm_s8_quant.cu)
are launched through ops/_cuda.py; these are their plain versions, and
export_kv_rows8 and w8a8_linear take either route by the device of their
input. The plain versions keep each JAX formula's own form, because the
forms round differently:

* _quant_rows: ``s = max|y| + 1e-8; q = clip(round(y * (127 / s)))``;
* _quant_kv_rows: ``s = max|r| * (1/127) + 1e-30; q = clip(round(r * (1 / s)))``;
* quantize_weight: ``round(w / s * 127)``, s the per-column absmax + 1e-8;
* the XLA W8A8 linear's activations (models/layers.py:linear_w8a8, no TPU
  kernel): ``s = max|x| + 1e-8; q = clip(round(x / s * 127))``, the
  kernel's "linear" form.

``round`` is half to even in both frameworks. The quotients 127 / s and
1 / s are taken tensor by tensor: ``scalar / tensor`` in PyTorch is a
reciprocal times the scalar, one rounding more. Dequantisation is
``acc * (y_s / 127) * (w_s / 127)`` in f32. The int8 products are summed in
float64, where sums of up to K = 3072 products of 127^2 (about 5e7, past
f32's exact 2^24) are exact, like the kernel's int32 accumulator.

Weights are stored transposed for the kernel: ``wq`` is (N, K) int8 (each
output channel's K weights contiguous) beside ``ws`` (1, N) f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _cuda


def _quotient(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den in one IEEE division per element."""
    return torch.full_like(den, num) / den


def _over(x: torch.Tensor, den: float) -> torch.Tensor:
    """x / den in one IEEE division per element (on the card PyTorch
    multiplies by the reciprocal of a scalar divisor)."""
    return x / torch.full_like(x, den)


def quant_rows_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """_quant_rows: rows (..., C) -> (int8 (..., C), f32 (..., 1) scales)."""
    y = y.float()
    s = y.abs().amax(-1, keepdim=True) + 1e-8
    q = torch.clamp(torch.round(y * _quotient(127.0, s)), -127, 127).to(torch.int8)
    return q, s


def quant_linear_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """layers.linear_w8a8's activation quantiser (the XLA W8A8 linear's
    form): rows (..., K) -> (int8 (..., K), f32 (..., 1) scales),
    ``s = max|x| + 1e-8, q = clip(round(x / s * 127))``."""
    x32 = x.float()
    s = x32.abs().amax(-1, keepdim=True) + 1e-8
    return torch.clamp(torch.round(x32 / s * 127.0), -127, 127).to(torch.int8), s


def quant_kv_rows_plain(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """_quant_kv_rows: rows (..., W) -> (int8 (..., W), f32 (..., 1) scales),
    dequantised as q * s."""
    r32 = rows.float()
    s = r32.abs().amax(-1, keepdim=True) * (1.0 / 127.0) + 1e-30
    q = torch.clamp(torch.round(r32 * _quotient(1.0, s)), -127, 127).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """quantize_weight: f32 (K, N) -> (int8 (N, K) transposed, f32 (1, N)
    per-column absmax scales)."""
    w = w.float()
    s = w.abs().amax(0, keepdim=True) + 1e-8
    return torch.round(w / s * 127.0).to(torch.int8).t().contiguous(), s


def weight_q(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-quantised (``wq`` (N, K), ``ws`` (1, N)) of a linear's params
    (models/clip_vit.py:prepare_int8_params), else quantised from ``w`` now."""
    if "wq" in p:
        return p["wq"], p["ws"]
    return quantize_weight(p["w"])


def w8a8_dot_plain(yq: torch.Tensor, y_s: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """_w8a8_dot: int8 (M, K) x int8 wq (N, K) -> f32 (M, N) with the
    per-row (M, 1) and per-channel (1, N) dequant."""
    acc = (yq.double() @ wq.double().t()).float()
    return acc * _over(y_s, 127.0) * _over(ws.reshape(1, -1), 127.0)


def w8a8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The XLA W8A8 linear on rows x (M, K), f32 or bf16: quant_linear_plain's
    rows, the int8 product with wq (N, K), ``acc * (x_s / 127) * (w_s /
    127) + bias`` in f32, rounded to x's dtype. A CUDA tensor launches
    quant_rows' "linear" form and gemm_s8 (its epilogue is that order, the
    bias a zero vector when there is none); a CPU one takes the plain
    versions."""
    if _cuda.on_cpu("w8a8_linear", x):
        return w8a8_linear_plain(x, wq, ws, bias)
    xq, xs = _cuda.quant_rows(x, form="linear")
    b = bias.float().contiguous() if bias is not None else \
        torch.zeros(wq.shape[0], dtype=torch.float32, device=x.device)
    return _cuda.gemm_s8(xq, xs, wq, ws.float().reshape(-1).contiguous(), b, out_dtype=x.dtype)


def w8a8_linear_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """w8a8_linear's plain version, on any device."""
    xq, xs = quant_linear_plain(x)
    y = w8a8_dot_plain(xq, xs, wq, ws)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def w8a8_gelu_quant_plain(yq: torch.Tensor, y_s: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                          bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 MLP's c_fc with its rows quantised (the TPU kernels'
    ``mid = _w8a8_dot(...) + b; mid = QuickGELU(mid); _quant_rows(mid)``;
    the kernel is _cuda.gemm_s8_quant): int8 (M, K) with (M, 1) scales x
    int8 wq (N, K) with (1, N) scales, + bias (N,), QuickGELU in f32 ->
    (int8 (M, N), f32 (M, 1) scales)."""
    mid = w8a8_dot_plain(yq, y_s, wq, ws) + bias.float()
    return quant_rows_plain(mid * torch.sigmoid(1.702 * mid))


def layer_norm_f32(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, left in f32 (the int8 block's
    LN1/LN2, whose output is quantised without a cast)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * params["scale"].float() \
        + params["bias"].float()


# -- the int8_rows export ----------------------------------------------------------

def export_kv_rows8(k_rows: torch.Tensor, v_rows: torch.Tensor, frames: int, tokens: int,
                    lo: int, kv_pad: int,
                    slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    plain: bool = False):
    """The int8_rows K/V export (_write_kv_export with scales): (frames *
    tokens, W) bf16 K and V column views -> int8 (frames, T', W) rows and f32
    (frames, T', 1) scales per K and V, T' = tokens - lo + kv_pad, the ``lo``
    leading rows of each frame dropped and the pad rows and pad scales zero.
    With ``slots`` the int8 rows go into those (frames, T', W) views.
    ``plain``: the plain quantiser on any device (a reference route).
    Returns (k, v, k_scale, v_scale)."""
    w = k_rows.shape[-1]
    t_out = tokens - lo + kv_pad
    dev = k_rows.device
    if slots is None:
        slots = (torch.empty((frames, t_out, w), dtype=torch.int8, device=dev),
                 torch.empty((frames, t_out, w), dtype=torch.int8, device=dev))
    scales = (torch.empty((frames, t_out, 1), dtype=torch.float32, device=dev),
              torch.empty((frames, t_out, 1), dtype=torch.float32, device=dev))
    for rows, slot, scale in zip((k_rows, v_rows), slots, scales):
        if plain or _cuda.on_cpu("export_kv_rows8", rows):
            q, s = quant_kv_rows_plain(rows.reshape(frames, tokens, w)[:, lo:])
            slot.zero_()
            scale.zero_()
            slot[:, : tokens - lo] = q
            scale[:, : tokens - lo] = s
        else:
            _cuda.quant_rows(rows, form="kv",
                             export=(slot, scale.view(frames, t_out), tokens, t_out, lo))
    return (*slots, *scales)
