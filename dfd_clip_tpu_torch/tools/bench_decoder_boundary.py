"""Time the decoder boundary (ops/decoder_stack.py) on the card at the serve
batch's 16 rows, and each of its four GEMM launches alone, at the decoder
widths 768 (ViT-B/16, DINOv2 B/14) and 1024 (ViT-L/14).

    python -m dfd_clip_tpu_torch.tools.bench_decoder_boundary [--widths 768 1024] [--device cuda|cpu]

The boundary's middle form (the tail's out-projection + residual,
LayerNorm, c_fc + QuickGELU, c_proj + residual, then the query's LayerNorm
and in-projection) is held against decoder_boundary_plain within 1e-2 of
the plain result's maximum, then timed. Each time is read twice: CUDA
events, the median of 3 windows of ITERS calls (how long a call holds the
stream), and the host's time to issue one call (``time.perf_counter`` over
a window of ITERS calls, no synchronisation inside it). Where the two
agree the form is launch-bound: the card waits on the host. Parameters
and inputs: numpy's generator with seed 0, bf16 weights and rows, f32
biases and LayerNorm parameters. With ``--device cpu`` only the check runs.

The file uses no API newer than the boundary itself, so two trees compare
on one card: copy it into the other tree's dfd_clip_tpu_torch/tools/ and
run it from each tree's root in turn, alternating which goes first.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _cuda
from ..ops import decoder_stack as ds
from . import time_op

ROWS = 16          # the serve batch's clips
ITERS = 100
TOL = 1e-2         # max |kernel - plain| / max |plain|, as chip_smoke.py's decoder holds


def boundary_inputs(w: int, device) -> tuple:
    """(x, attn_out, tail_params, query_params) of one boundary at width w."""
    rng = np.random.default_rng(0)

    def t(shape, scale, dtype=torch.bfloat16, shift=0.0):
        x = shift + scale * rng.normal(size=shape)
        return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)

    def lin(k, n):
        return {"w": t((k, n), k ** -0.5), "b": t((n,), 0.02, torch.float32)}

    def ln():
        return {"scale": t((w,), 0.1, torch.float32, 1.0), "bias": t((w,), 0.1, torch.float32)}

    tail = {"attn_out_proj": lin(w, w), "ln_2": ln(),
            "mlp": {"c_fc": lin(w, 4 * w), "c_proj": lin(4 * w, w)}}
    query = {"ln_1": ln(), "in_proj": lin(w, 2 * w)}
    return t((ROWS, w), 1.0), t((ROWS, w), 1.0), tail, query


def host_ms(fn, *args) -> float:
    """The host's ms to issue one call of fn(*args), over ITERS calls."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / ITERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[768, 1024])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (check only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"rows={ROWS} widths={args.widths} device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    for w in args.widths:
        x, o, tail, query = boundary_inputs(w, dev)
        got = ds.decoder_boundary(x, o, tail, query)
        want = ds.decoder_boundary_plain(x, o, tail, query)
        err = max(((g.float() - p.float()).abs().max() / p.float().abs().max()).item()
                  for g, p in zip(got, want))
        if not err <= TOL:
            raise SystemExit(f"decoder_boundary wrong at width {w}: {err:.3e} of the max")
        print(f"width {w}: correctness ok, {err:.3e} of the max", flush=True)
        if dev.type != "cuda":
            continue
        mlp, bf = tail["mlp"], torch.bfloat16
        mid = torch.zeros(ROWS, 4 * w, device=dev, dtype=bf)
        calls = {
            "decoder_boundary": (ds.decoder_boundary, x, o, tail, query),
            "plain": (ds.decoder_boundary_plain, x, o, tail, query),
            "gemm out-proj + residual": (
                lambda: _cuda.gemm(o, tail["attn_out_proj"]["w"], tail["attn_out_proj"]["b"],
                                   bias_after_cast=True, residual=x),),
            "gemm c_fc + QuickGELU": (
                lambda: _cuda.gemm(x, mlp["c_fc"]["w"], mlp["c_fc"]["b"], bias_after_cast=True,
                                   gelu=True),),
            "gemm c_proj + residual": (
                lambda: _cuda.gemm(mid, mlp["c_proj"]["w"], mlp["c_proj"]["b"],
                                   bias_after_cast=True, residual=x),),
            "gemm in-proj": (
                lambda: _cuda.gemm(x, query["in_proj"]["w"], query["in_proj"]["b"],
                                   bias_after_cast=True),),
        }
        for name, (fn, *fargs) in calls.items():
            ms = time_op(fn, *fargs, iters=ITERS) * 1e3
            print(f"  {name:28s} {ms:.4f} ms (host {host_ms(fn, *fargs):.4f} ms a call)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
