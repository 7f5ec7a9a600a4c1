"""Time the decoder attention's backward (ops/fused_decoder_attention_bwd.py,
one launch of csrc/decoder_attention_bwd.cu) on the card at the train step's
shape (12 samples, L = 20 frames x 200 export rows, 196 of them real, 12
heads) and at the forward's wide rows (16 heads, L = 20 x 256 and 20 x 576),
with its stage clock.

    python -m dfd_clip_tpu_torch.tools.bench_decoder_bwd [--shapes 12x200x196x12 ...] [--device cuda|cpu]

A shape is samples x rows a frame x real rows a frame x heads, on slot 1 of
a (2, B, L, H, 64) bf16 K/V stack with pos; sample B - 2 has its last ten
frames masked and sample B - 1 all of them (the train batch's padding).
The forward's stats come from the plain partials. dq_smax, dq_coda and dpos
are held against fused_decoder_attention_bwd_plain within 1e-2 of each
plain leaf's maximum, then the call is timed: CUDA events, the median of 3
windows of ITERS calls, beside the bytes' bound (valid K/V rows, pos, mask,
queries, ct, o_s and stats read once, dq and dpos written once, at 3.35
TB/s), and the host's time to issue one call. Inputs: numpy's generator with
seed 0. With ``--device cpu`` only the check runs.

The stage clock follows: each block writes %globaltimer at the points of
_cuda.BWD_CLOCK for its first work item; printed in us from the first
block's start, the median and the last block's reading of each point.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _cuda
from ..ops import fused_decoder_attention as fda
from ..ops import fused_decoder_attention_bwd as fdb
from . import time_op

FRAMES = 20
ITERS = 50
TOL = 1e-2         # max |kernel - plain| / max |plain| a leaf, as chip_smoke.py's decoder holds
HBM = 3.35e12      # bytes a second, an H100 SXM's device memory
SHAPES = ("12x200x196x12", "12x256x256x16", "12x576x576x16")


def bwd_inputs(b: int, p: int, valid_p: int, h: int, device) -> tuple:
    """The backward's arguments at one shape (module note)."""
    rng = np.random.default_rng(0)
    l = FRAMES * p

    def t(shape, scale):
        x = scale * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)

    k, v = t((2, b, l, h, 64), 0.5), t((2, b, l, h, 64), 1.0)
    k.view(2, b, FRAMES, p, h, 64)[:, :, :, valid_p:] = 0
    v.view(2, b, FRAMES, p, h, 64)[:, :, :, valid_p:] = 0
    pos = t((l, h, 64), 0.04)
    qrow = t((b, 2 * h * 64), 1.0)
    qs, qc = (qrow[:, i * h * 64: (i + 1) * h * 64].reshape(b, 1, h, 64) for i in range(2))
    mask = torch.zeros(b, FRAMES, p, dtype=torch.bool, device=device)
    mask[:, :, :valid_p] = True
    if b > 1:
        mask[b - 2, FRAMES // 2:] = False
        mask[b - 1] = False
    mask = mask.reshape(b, l)
    o_sc, st = fda.fused_decoder_attention_plain(qs, qc, k, v, mask, pos, 1, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, h, 64) / denom.clamp_min(1e-30)[..., None]
    ct = t((b, 1, h, 64), 0.1)
    return qs, qc, k, v, mask, pos, 1, denom, mx, o_s, ct


def bound_ms(args: tuple) -> float:
    """The bytes' bound of one call (module note), ms."""
    qs, mask = args[0], args[4]
    b, _, h, d = qs.shape
    l, w = mask.shape[1], h * d
    valid = mask.sum().item()
    nbytes = (4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 2.0 * b * w + 4.0 * b * w
              + 8.0 * b * h + 8.0 * b * w + 4.0 * l * w)
    return nbytes / HBM * 1e3


def host_ms(args: tuple) -> float:
    """The host's ms to issue one call, over ITERS calls."""
    fdb.fused_decoder_attention_bwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fdb.fused_decoder_attention_bwd(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / ITERS


def stage_clock(args: tuple) -> dict:
    """One call's stage clock: us from the first block's start to each
    point, (median, last) over the blocks."""
    qs, mask = args[0], args[4]
    b, _, h, _ = qs.shape
    geo = _cuda.bwd_geometry(b, mask.shape[1], h, _cuda._sms(qs.get_device()))
    n = len(_cuda.BWD_CLOCK)
    clock = torch.zeros(geo["grid"] * n, dtype=torch.int64, device=qs.device)
    fdb.fused_decoder_attention_bwd(*args, stage_clock=clock)
    t = clock.view(geo["grid"], n).cpu().double()
    t0 = t[:, 0].min().item()
    return {name: ((t[:, i].median().item() - t0) / 1e3, (t[:, i].max().item() - t0) / 1e3)
            for i, name in enumerate(_cuda.BWD_CLOCK)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    help="samples x rows a frame x real rows a frame x heads")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (check only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"frames={FRAMES} device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    for shape in args.shapes:
        b, p, valid_p, h = (int(x) for x in shape.split("x"))
        bargs = bwd_inputs(b, p, valid_p, h, dev)
        got = fdb.fused_decoder_attention_bwd(*bargs)
        want = fdb.fused_decoder_attention_bwd_plain(*bargs)
        err = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                  for g, w in zip(got, want))
        if not err <= TOL:
            raise SystemExit(f"fused_decoder_attention_bwd wrong at {shape}: {err:.3e} of the max")
        print(f"{shape} (L = {FRAMES * p}): correctness ok, {err:.3e} of the max", flush=True)
        if dev.type != "cuda":
            continue
        ms = time_op(fdb.fused_decoder_attention_bwd, *bargs, iters=ITERS) * 1e3
        bound = bound_ms(bargs)
        print(f"  {ms:.4f} ms (bound {bound:.4f} by bytes, {bound / ms:.3f} of it; host "
              f"{host_ms(bargs):.4f} ms a call)", flush=True)
        print("  stage clock (us, median / last block): " + ", ".join(
            f"{k} {m:.2f} / {x:.2f}" for k, (m, x) in stage_clock(bargs).items()), flush=True)
        del bargs, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
