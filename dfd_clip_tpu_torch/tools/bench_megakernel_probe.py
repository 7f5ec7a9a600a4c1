"""Time the megakernel probe of tools/bench_megakernel_probe.py on the card:
12 launches of one chained product (h through device memory between the
layers) against one launch that takes each pair of row panels through
every layer, a layer's output read back from L2 as the next one's input.

    python -m dfd_clip_tpu_torch.tools.bench_megakernel_probe [--check] [--device cuda|cpu]

Both compute LAYERS products h = bf16(h @ W_l) over (ROWS, W) x (W, W) with
f32 accumulation (ops/gemm_chain.py, csrc/gemm_chain.cu). The probe's
inputs: weights from numpy's generator with seed 1 (normal x 0.02), the
correctness rows from seed 2 (CHECK_ROWS of them, the JAX tool's two
default chunks of 7880), the timed h from seed 0, all rounded to bf16. The
two entries must agree within 1e-2 (the tool's check; the port's are
bit-equal). The JAX tool's rows per chunk is a TPU block shape and is not
ported. Times: CUDA events, the median of 3 windows of 20 calls; with
``--check`` or ``--device cpu`` nothing is timed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gemm_chain import gemm_chain_megakernel, gemm_chain_per_layer
from . import time_op

ROWS = 63040          # 320 frames x 197 tokens (flagship)
W = 768
LAYERS = 12
CHECK_ROWS = 2 * 7880
ITERS = 20


def bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=torch.bfloat16)


def make_weights(device="cpu") -> torch.Tensor:
    """(LAYERS, W, W) bf16, stacked once."""
    rng = np.random.default_rng(1)
    return torch.stack([bf16(rng.normal(size=(W, W)) * 0.02, device) for _ in range(LAYERS)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="the correctness check only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (check only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ws = make_weights(dev)
    print(f"rows={ROWS} W={W} layers={LAYERS} device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    hc = bf16(np.random.default_rng(2).normal(size=(CHECK_ROWS, W)) * 0.02, dev)
    a = gemm_chain_per_layer(hc, ws).float()
    b = gemm_chain_megakernel(hc, ws).float()
    err = (a - b).abs().max().item()
    if not err < 1e-2:
        raise SystemExit(f"megakernel wrong: max err {err}")
    print("correctness ok, max err", err)
    if args.check or dev.type != "cuda":
        return 0
    h0 = bf16(np.random.default_rng(0).normal(size=(ROWS, W)) * 0.02, dev)
    t_split = time_op(gemm_chain_per_layer, h0, ws, iters=ITERS)
    print(f"{'12 per-layer launches (h via HBM)':36s} {t_split * 1e3:7.3f} ms", flush=True)
    t_mega = time_op(gemm_chain_megakernel, h0, ws, iters=ITERS)
    print(f"{'one launch, h through L2':36s} {t_mega * 1e3:7.3f} ms", flush=True)
    print(f"delta {1e3 * (t_split - t_mega):+.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
