"""Time the encoder-attention variants of tools/bench_attention.py on the card.

    python -m dfd_clip_tpu_torch.tools.bench_attention [variant ...] [--device cuda|cpu]

The variants keep the JAX tool's names. ``xla_einsum`` is the plain version
(ops/attention.py ``plain_attention``), ``pallas_current`` the port's
encoder attention (``fused_encoder_attention``, csrc/encoder_attention.cu),
and every other Pallas variant the study kernel (ops/study_attention.py) in
the numerics mode of its kernel body; frames per grid step and the TPU's
head packing are not ported, so the variants that differ only in those run
the same kernel. Inputs are the tool's: three (N, T, H, D) = (320, 197, 12,
64) normal arrays from numpy's generator with seed 0, rounded to bf16.

Each variant is first checked against ``xla_einsum`` on the first 4 frames
(max abs error < 0.05, the tool's check), then timed on the card with CUDA
events: the median of 3 windows of ITERS calls, printed in ms and in
effective TFLOP/s (the two products' 2 N H T^2 D x 2). With ``--device cpu``
the variants are checked and not timed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.attention import fused_encoder_attention, plain_attention
from ..ops.study_attention import study_attention
from . import time_op

N, T, H, D = 320, 197, 12, 64  # ViT-B/16: 16 clips x 20 frames, 197 tokens
ITERS = 30


def flops() -> float:
    return 2.0 * N * H * (T * D * T + T * T * D)  # logits + mix


def make_inputs(seed: int = 0, device="cpu"):
    rng = np.random.default_rng(seed)

    def mk():
        x = rng.normal(size=(N, T, H, D)).astype(np.float32)
        return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)

    return mk(), mk(), mk()


def _study(mode: str):
    def fn(q, k, v):
        return study_attention(q, k, v, mode)

    fn.__name__ = f"study_{mode}"
    return fn


# variant name -> function of (q, k, v); the numerics mode of each kernel body
VARIANTS = {"xla_einsum": plain_attention, "pallas_current": fused_encoder_attention}
for _f in (2, 4, 8):
    VARIANTS[f"pallas_frames{_f}"] = _study("f32")        # make_multiframe_kernel
VARIANTS["pallas_batched_dot"] = _study("f32")            # make_batched_dot_kernel
VARIANTS["pallas_pair_packed"] = _study("f32")            # make_pair_packed_kernel
VARIANTS["pallas_full_packed"] = _study("bf16")           # make_full_packed_kernel
VARIANTS["pallas_full_packed_f4"] = _study("bf16")
for _f in (1, 2, 4):
    VARIANTS[f"pallas_bf16_f{_f}"] = _study("bf16")       # make_bf16_kernel
for _f in (1, 2):
    VARIANTS[f"pallas_diet_max_f{_f}"] = _study("diet")   # make_diet_kernel(with_max=True)
    VARIANTS[f"pallas_diet_nomax_f{_f}"] = _study("diet_nomax")
VARIANTS["pallas_pad256"] = _study("f32")                 # make_multiframe_kernel, t_pad 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"default: all of {list(VARIANTS)}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (checks only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = args.variants or list(VARIANTS)
    q, k, v = make_inputs(device=dev)
    print(f"shapes: N={N} T={T} H={H} D={D} dtype=bfloat16, device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    ref = plain_attention(q[:4], k[:4], v[:4]).float()
    results = {}
    for name in names:
        fn = VARIANTS[name]
        err = (fn(q, k, v)[:4].float() - ref).abs().max().item()
        if not err < 0.05:
            raise SystemExit(f"{name}: wrong result, max err {err}")
        if dev.type != "cuda":
            print(f"{name:34s} max err {err:.3e} (not timed on {dev})")
            continue
        t = time_op(fn, q, k, v, iters=ITERS)
        results[name] = t
        print(f"{name:34s} {t * 1e3:7.3f} ms   {flops() / t / 1e12:6.2f} TFLOPS-effective   "
              f"max err {err:.3e}")
    if results:
        best = min(results, key=results.get)
        print(f"best: {best} ({results[best] * 1e3:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
