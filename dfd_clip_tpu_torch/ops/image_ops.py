"""Device-side image transform (counterpart of dfd_clip_tpu/ops/image_ops.py).

uint8 frames go to the card as they are; the card does the bicubic resize of
the shorter side (torch/torchvision-matched interpolation matrices applied as
two products), the center crop and the channel normalisation.
``yuv420_to_rgb`` converts planar YUV420 frames to RGB on the tensor's device
(the JAX package runs it in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _torch_cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """PyTorch's bicubic kernel (a = -0.75)."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = (a + 2) * t[m1] ** 3 - (a + 3) * t[m1] ** 2 + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = a * t[m2] ** 3 - 5 * a * t[m2] ** 2 + 8 * a * t[m2] - 4 * a
    return out


@functools.lru_cache(maxsize=64)
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) interpolation weights matching torch's antialiased bicubic.
    Read-only: callers copy before changing it."""
    scale = in_size / out_size
    antialias = scale > 1.0
    # the antialias path follows PIL: cubic a=-0.5 stretched by the scale
    a = -0.5 if antialias else -0.75
    support = 2.0 * (scale if antialias else 1.0)
    centers = (np.arange(out_size) + 0.5) * scale - 0.5
    w = np.zeros((out_size, in_size), np.float32)
    for i, c in enumerate(centers):
        lo = int(np.floor(c - support)) + 1
        hi = int(np.ceil(c + support))
        idx = np.clip(np.arange(lo, hi + 1), 0, in_size - 1)
        t = (np.arange(lo, hi + 1) - c) / (scale if antialias else 1.0)
        np.add.at(w[i], idx, _torch_cubic(t, a))
    w /= w.sum(axis=1, keepdims=True)
    w.setflags(write=False)
    return w


def resize_shorter_side(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bicubic resize of float (..., C, H, W) so the shorter side is ``size``."""
    h, w = x.shape[-2], x.shape[-1]
    if h <= w:
        new_h, new_w = size, max(size, round(size * w / h))
    else:
        new_h, new_w = max(size, round(size * h / w)), size
    if (new_h, new_w) == (h, w):
        return x
    wh = torch.from_numpy(_bicubic_matrix(h, new_h).copy()).to(x.device)
    ww = torch.from_numpy(_bicubic_matrix(w, new_w).copy()).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    return torch.einsum("pw,...ow->...op", ww, y)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top: top + size, left: left + size]


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  full_range: bool = True) -> torch.Tensor:
    """Planar YUV420 uint8 (..., H, W) luma and (..., H/2, W/2) chroma -> RGB
    uint8 (..., 3, H, W): chroma upsampled 2x nearest, BT.601 coefficients,
    ``full_range`` the JPEG/full-range matrix, else limited range (16-235)."""
    def up(c):
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1).float() - 128.0

    yf, uu, vv = y.float(), up(u), up(v)
    if full_range:
        r = yf + 1.402 * vv
        g = yf - 0.344136 * uu - 0.714136 * vv
        b = yf + 1.772 * uu
    else:
        yy = (yf - 16.0) * (255.0 / 219.0)
        r = yy + 1.596027 * vv
        g = yy - 0.391762 * uu - 0.812968 * vv
        b = yy + 2.017232 * uu
    return torch.stack([r, g, b], dim=-3).round().clamp(0, 255).to(torch.uint8)


def resize_crop_normalize(x: torch.Tensor, size: int, mean: Sequence[float],
                          std: Sequence[float]) -> torch.Tensor:
    """uint8 (..., 3, H, W) -> normalized float32 (..., 3, size, size)."""
    x = x.float() / 255.0
    x = center_crop(resize_shorter_side(x, size), size)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(3, 1, 1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(3, 1, 1)
    return (x - mean_t) / std_t
