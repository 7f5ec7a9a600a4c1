"""Time the decoder boundary (ops/decoder_stack.py, one cooperative launch of
csrc/decoder_boundary.cu) on the card at the serve batch's 16 rows in its
three forms, beside the six-launch chain of gemm and layer_norm_rows that
computes the same boundary (a yardstick the port never calls), at the
decoder widths 768 (ViT-B/16, DINOv2 B/14) and 1024 (ViT-L/14).

    python -m dfd_clip_tpu_torch.tools.bench_decoder_boundary [--widths 768 1024] [--device cuda|cpu]

The middle form (the tail's out-projection + residual, LayerNorm, c_fc +
QuickGELU, c_proj + residual, then the query's LayerNorm and in-projection)
is held against decoder_boundary_plain within 1e-2 of the plain result's
maximum, then each form is timed. Each time is read twice: CUDA events, the
median of 3 windows of ITERS calls (how long a call holds the stream), and
the host's time to issue one call (``time.perf_counter`` over a window of
ITERS calls, no synchronisation inside it). Where the two agree the call is
launch-bound: the card waits on the host. Parameters and inputs: numpy's
generator with seed 0, bf16 weights and rows, f32 biases and LayerNorm
parameters. With ``--device cpu`` only the check runs.

Each form's stage clock follows its times: the kernel's blocks write
%globaltimer at the launch's start, once their weight loads are issued, as
each stage's weight slices arrive and as it ends, and as each grid barrier
completes; printed in us from the first block's start, the last block's
reading of each point.
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


FORMS = ("first", "middle", "last")


def form_args(form: str, x, o, tail, query) -> tuple:
    """decoder_boundary's arguments in a form: the first boundary is
    query-only, the last tail-only."""
    return {"first": (x, None, None, query), "middle": (x, o, tail, query),
            "last": (x, o, tail, None)}[form]


def six_launch_chain(x, o, tail, query):
    """The boundary as six launches of the shared kernels at M = B rows (the
    port's boundary before it was one launch): out-proj + residual,
    layer_norm_rows, c_fc + QuickGELU, c_proj + residual, layer_norm_rows,
    in-proj, each GEMM with the bias added after the bf16 cast. Returns
    (x_out, qrow) as decoder_boundary does."""
    def lin(y, p, **kw):
        return _cuda.gemm(y, p["w"], p["b"], bias_after_cast=True, **kw)

    def ln(y, p):
        return _cuda.layer_norm_rows(y, p["scale"], p["bias"])

    x_out = qrow = None
    if tail is not None:
        mlp = tail["mlp"]
        x1 = lin(o, tail["attn_out_proj"], residual=x)
        mid = lin(ln(x1, tail["ln_2"]), mlp["c_fc"], gelu=True)
        x = x_out = lin(mid, mlp["c_proj"], residual=x1)
    if query is not None:
        qrow = lin(ln(x, query["ln_1"]), query["in_proj"])
    return x_out, qrow


def bf16_row_ulps(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each row's largest magnitude, (R, 1): 2^(e - 7) for
    2^e <= max|row| < 2^(e + 1)."""
    top = t.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


def chain_links(got: tuple, args: tuple) -> list:
    """The boundary's links (name, the kernel's value, the six-launch
    chain's launch fed the kernel's own input for it, the most row ulps a
    value may differ by): the kernel leaves x1 (after the out-projection)
    and the MLP intermediate in its stream's scratch
    (_cuda.boundary_intermediates), so each link of the chain (gemm, or
    layer_norm_rows + gemm, keeping ops/decoder_stack.py's rounding points)
    differs from the kernel only in the f32 order of one product's sums.
    QuickGELU's slope reaches 1.13, so on c_fc a product one ulp apart can
    land two ulps apart. Call right after the boundary, on its stream."""
    x, o, tail, query = args

    def lin(y, p, **kw):
        return _cuda.gemm(y, p["w"], p["b"], bias_after_cast=True, **kw)

    def ln(y, p):
        return _cuda.layer_norm_rows(y, p["scale"], p["bias"])

    links = []
    if tail is not None:
        mlp = tail["mlp"]
        x1, mid = _cuda.boundary_intermediates(x, mlp["c_fc"]["w"].shape[1])
        links += [("out_proj", x1, lin(o, tail["attn_out_proj"], residual=x), 1),
                  ("c_fc", mid, lin(ln(x1, tail["ln_2"]), mlp["c_fc"], gelu=True), 2),
                  ("c_proj", got[0], lin(mid, mlp["c_proj"], residual=x1), 1)]
    if query is not None:
        src = got[0] if tail is not None else x
        links.append(("in_proj", got[1], lin(ln(src, query["ln_1"]), query["in_proj"]), 1))
    return links


def hold_links(got: tuple, args: tuple) -> tuple:
    """chain_links held: raises AssertionError where a value differs by more
    than its link's row ulps. Returns (values differing, values)."""
    differ = total = 0
    for name, k, c, most in chain_links(got, args):
        diff = (k.float() - c.float()).abs()
        ulps = (diff / bf16_row_ulps(c)).max().item()
        if not ulps <= most:
            raise AssertionError(f"{name}: {ulps:.2f} row ulps from the chain, "
                                 f"{int((diff > 0).sum())} values differ")
        differ += int((diff > 0).sum())
        total += diff.numel()
    return differ, total


def stage_clock(args: tuple) -> dict:
    """One boundary's stage clock (_cuda.BOUNDARY_CLOCK): us from the first
    block's start to the last block's reading of each point its form
    reaches."""
    x = args[0]
    hidden = args[2]["mlp"]["c_fc"]["w"].shape[1] if args[2] is not None else 4 * x.shape[1]
    grid = _cuda.boundary_geometry(x.shape[1], hidden, x.shape[0], _cuda._sms(x.get_device()))
    n = len(_cuda.BOUNDARY_CLOCK)
    clock = torch.zeros(grid["grid"] * n, dtype=torch.int64, device=x.device)
    _cuda.decoder_boundary(*args, stage_clock=clock)
    t = clock.view(grid["grid"], n).cpu()
    t0 = t[:, 0].min().item()
    out = {name: (t[:, i].max().item() - t0) / 1e3 for i, name in enumerate(_cuda.BOUNDARY_CLOCK)
           if t[:, i].max().item() > 0}
    return dict(sorted(out.items(), key=lambda kv: kv[1]))


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
        for form in FORMS:
            args_ = form_args(form, x, o, tail, query)
            for name, fn in (("decoder_boundary", ds.decoder_boundary),
                             ("six-launch chain", six_launch_chain),
                             ("plain", ds.decoder_boundary_plain)):
                ms = time_op(fn, *args_, iters=ITERS) * 1e3
                print(f"  {form:6s} {name:18s} {ms:.4f} ms (host {host_ms(fn, *args_):.4f} ms "
                      f"a call)", flush=True)
            print(f"  {form:6s} stage clock (us): " + ", ".join(
                f"{k} {v:.2f}" for k, v in stage_clock(args_).items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
