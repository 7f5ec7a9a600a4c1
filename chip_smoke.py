#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dfd_clip_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card, its power limit and the torch / nvcc versions;
2. builds the port's CUDA kernels from dfd_clip_tpu_torch/csrc (timed);
3. at the flagship shapes (CLIP ViT-B/16, 16 clips x 20 frames for serving
   and 12 clips x 20 frames for training, kept layers 6-11, bf16) runs every
   kernel against its plain PyTorch version on the same inputs, with stated
   tolerances, and times kernel, plain version, a one-call PyTorch yardstick
   where one exists, and the card's bound;
4. drives the serving path: a Scorer over a full-width, randomly
   initialised (seeded) ViT-B/16 Detector answers four requests of decoded
   224x224 uint8 frames, with every launch counter zeroed just before and
   read just after; one batch's logits are held against the same Detector
   run through the plain versions; then a device-resident predict is timed
   and one predict and one request are traced with torch.profiler (device
   busy time and the kernels that take it);
5. drives the training path: a flagship Trainer (batch 12, dropout 0.5,
   SGD + OneCycle) takes four steps on seeded synthetic uint8 batches, with
   every launch counter zeroed just before and read just after; one step's
   loss and decoder gradients are held against the same step through the
   plain versions of the decoder kernels and through the plain versions of
   all kernels (same parameters, batch and dropout seed); then a
   device-resident train step is timed, its peak memory read, and one step
   traced with torch.profiler;
6. prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase raises and the script exits nonzero without the last line.
It needs one card and no network; it imports nothing of the JAX package.
The plain versions run with TF32 disabled for matmuls and convolutions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

# flagship geometry (configs/deepfake/deepfake.yaml, bench.py): serving batch,
# training batch (bench.py:bench_train_step), frames per clip, kept layers
CLIPS, TRAIN_CLIPS, FRAMES, KEEP = 16, 12, 20, (6, 7, 8, 9, 10, 11)
TRAIN_STEPS = 4
PEAK_BF16_TC = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12          # H100 SXM f32 outside the tensor cores
HBM = 3.35e12             # H100 SXM device-memory bytes/s
TOL_ENCODER, TOL_DECODER, TOL_PFAKE = 2e-2, 1e-2, 1e-2
TOL_TRAIN_GRAD = 1e-1     # whole plain route, per-leaf relative L2 (see train_path)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, want, tol: float) -> float:
    """Max abs error; fails when max|got - want| / max|want| exceeds tol or
    anything is not finite."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                         f"or non-finite output")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    print(f"  {name}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g})", flush=True)
    if rel > tol:
        raise SystemExit(f"FAIL {name}: relative error {rel:.3e} > {tol:g}")
    return err


@contextlib.contextmanager
def plain_versions(encoder: bool = True):
    """Route the Detector through the plain PyTorch versions (for the
    end-to-end reference only); with ``encoder=False`` only the decoder's
    kernels, so both routes decode the same encoder export."""
    from dfd_clip_tpu_torch.models import clip_vit, decoder
    from dfd_clip_tpu_torch.ops import (
        decoder_attention_vjp,
        decoder_stack,
        encoder_block,
        fused_decoder_attention,
        fused_decoder_attention_bwd,
    )

    swaps = [
        (clip_vit, "fused_encoder_attn_block", encoder_block.fused_encoder_attn_block_plain),
        (clip_vit, "fused_encoder_mlp_block", encoder_block.fused_encoder_mlp_block_plain),
    ] if encoder else []
    swaps += [
        (decoder, "fused_decoder_attention",
         fused_decoder_attention.fused_decoder_attention_plain),
        (decoder, "decoder_boundary", decoder_stack.decoder_boundary_plain),
        (decoder_attention_vjp, "fused_decoder_attention",
         fused_decoder_attention.fused_decoder_attention_plain),
        (decoder_attention_vjp, "fused_decoder_attention_bwd",
         fused_decoder_attention_bwd.fused_decoder_attention_bwd_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_kernels(rows: list) -> None:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.models import clip_vit, layers
    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_stack as ds
    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda

    cfg = clip_vit.VIT_B16
    n, t, w, hh, d = CLIPS * FRAMES, cfg.num_tokens, cfg.width, cfg.heads, cfg.head_dim
    m_rows, t_out, nsel, bf = n * t, 200, len(KEEP), torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    blk = clip_vit.init_clip_vision(gen, dataclasses.replace(cfg, layers=1))["blocks"][0]
    for ln in (blk["ln_1"], blk["ln_2"]):
        ln["scale"].add_(0.1 * torch.randn(w, generator=gen))
        ln["bias"].add_(0.1 * torch.randn(w, generator=gen))
    for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                blk["mlp"]["c_proj"]):
        lin["b"].add_(0.02 * torch.randn(lin["b"].shape, generator=gen))
    blk = to_device(blk, dev)
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)

    def row(name, replaces, source, ms, plain, lib, flops, nbytes, peak, err,
            counter=None, paths=("serve", "train")):
        """One kernel's line; its launches are read later from ``counter``
        (default: the name) in the runs of ``paths``."""
        b, by = bound_ms(flops, nbytes, peak)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": lib,
                     "counter": counter or name, "paths": paths})
        print(f"  {name}: {ms:.4f} ms (plain {plain:.4f}, library "
              f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b:.4f} by {by})", flush=True)

    # -- layer_norm_rows ------------------------------------------------------
    h2 = h.reshape(m_rows, w)
    ln1 = blk["ln_1"]
    got = _cuda.layer_norm_rows(h2, ln1["scale"], ln1["bias"])
    err = compare("layer_norm_rows", got, layers.layer_norm(ln1, h2), TOL_ENCODER)
    row("layer_norm_rows", "dfd_clip_tpu/ops/pallas_attention.py:360",
        "dfd_clip_tpu_torch/csrc/layer_norm.cu",
        time_ms(lambda: _cuda.layer_norm_rows(h2, ln1["scale"], ln1["bias"])),
        time_ms(lambda: layers.layer_norm(ln1, h2)),
        time_ms(lambda: F.layer_norm(h2, (w,), ln1["scale"].to(bf), ln1["bias"].to(bf))),
        8.0 * m_rows * w, 4.0 * m_rows * w + 8.0 * w, PEAK_F32, err)

    # -- gemm (the qkv projection shape) -----------------------------------------
    y = layers.layer_norm(ln1, h2)
    wq, bq = blk["attn"]["in_proj"]["w"], blk["attn"]["in_proj"]["b"]
    got = _cuda.gemm(y, wq, bq)
    err = compare("gemm", got, layers.linear_f32_bias(y, wq, bq), TOL_ENCODER)
    bq16 = bq.to(bf)
    row("gemm", "dfd_clip_tpu/ops/pallas_attention.py:374", "dfd_clip_tpu_torch/csrc/gemm.cu",
        time_ms(lambda: _cuda.gemm(y, wq, bq)),
        time_ms(lambda: layers.linear_f32_bias(y, wq, bq)),
        time_ms(lambda: torch.addmm(bq16, y, wq)),
        2.0 * m_rows * w * 3 * w, 2.0 * (m_rows * w + 3 * w * w + m_rows * 3 * w) + 12.0 * w,
        PEAK_BF16_TC, err)

    # -- encoder_attention --------------------------------------------------------
    qkv = got
    from dfd_clip_tpu_torch.ops.attention import plain_attention_qkv

    att = eb.encoder_attention(qkv, n, t, hh, d)
    err = compare("encoder_attention", att,
                  plain_attention_qkv(qkv.reshape(n, t, 3 * w), hh, d).reshape(m_rows, w),
                  TOL_ENCODER)
    q4, k4, v4 = (s.reshape(n, t, hh, d).transpose(1, 2) for s in qkv.split(w, dim=-1))
    row("encoder_attention", "dfd_clip_tpu/ops/pallas_attention.py:385",
        "dfd_clip_tpu_torch/csrc/encoder_attention.cu",
        time_ms(lambda: eb.encoder_attention(qkv, n, t, hh, d)),
        time_ms(lambda: plain_attention_qkv(qkv.reshape(n, t, 3 * w), hh, d)),
        time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        4.0 * n * hh * t * t * d, 2.0 * (m_rows * 3 * w + m_rows * w), PEAK_BF16_TC, err)
    del qkv, q4, k4, v4, att, y, got

    # -- fused_encoder_attn_block: full + stacked export, and last_only -----------
    def bufs():
        return (torch.empty(nsel, n, t_out, w, dtype=bf, device=dev),
                torch.empty(nsel, n, t_out, w, dtype=bf, device=dev))

    kk, vk = bufs()
    kp, vp = bufs()
    ho, _, _ = eb.fused_encoder_attn_block(h, ln1, blk["attn"], hh, d, export=True,
                                           drop_cls=True, export_into=(kk, vk, 2, nsel),
                                           kv_pad=4)
    hp, _, _ = eb.fused_encoder_attn_block_plain(h, ln1, blk["attn"], hh, d, export=True,
                                                 drop_cls=True,
                                                 export_into=(kp, vp, 2, nsel), kv_pad=4)
    err = compare("fused_encoder_attn_block h", ho, hp, TOL_ENCODER)
    err = max(err, compare("fused_encoder_attn_block k", kk[2], kp[2], TOL_ENCODER))
    err = max(err, compare("fused_encoder_attn_block v", vk[2], vp[2], TOL_ENCODER))
    if kk[2, :, 196:].abs().max().item() != 0 or vk[2, :, 196:].abs().max().item() != 0:
        raise SystemExit("FAIL fused_encoder_attn_block: export pad rows are not zero")
    kl, vl = bufs()
    eb.fused_encoder_attn_block(h, ln1, blk["attn"], hh, d, drop_cls=True, last_only=True,
                                export_into=(kl, vl, 5, nsel), kv_pad=4)
    eb.fused_encoder_attn_block_plain(h, ln1, blk["attn"], hh, d, drop_cls=True,
                                      last_only=True, export_into=(kp, vp, 5, nsel), kv_pad=4)
    err = max(err, compare("fused_encoder_attn_block last_only k", kl[5], kp[5], TOL_ENCODER))
    err = max(err, compare("fused_encoder_attn_block last_only v", vl[5], vp[5], TOL_ENCODER))
    if kl[5, :, 196:].abs().max().item() != 0:
        raise SystemExit("FAIL fused_encoder_attn_block last_only: pad rows are not zero")

    def attn_full():
        return eb.fused_encoder_attn_block(h, ln1, blk["attn"], hh, d, export=True,
                                           drop_cls=True, export_into=(kk, vk, 2, nsel),
                                           kv_pad=4)

    def attn_plain():
        return eb.fused_encoder_attn_block_plain(h, ln1, blk["attn"], hh, d, export=True,
                                                 drop_cls=True,
                                                 export_into=(kp, vp, 2, nsel), kv_pad=4)

    flops = 2.0 * m_rows * w * 4 * w + 4.0 * n * hh * t * t * d
    nbytes = 4.0 * m_rows * w + 8.0 * w * w + 4.0 * n * t_out * w + 32.0 * w
    row("fused_encoder_attn_block", "dfd_clip_tpu/ops/pallas_attention.py:412",
        "dfd_clip_tpu_torch/ops/encoder_block.py", time_ms(attn_full), time_ms(attn_plain),
        None, flops, nbytes, PEAK_BF16_TC, err)
    last_ms = time_ms(lambda: eb.fused_encoder_attn_block(
        h, ln1, blk["attn"], hh, d, drop_cls=True, last_only=True,
        export_into=(kl, vl, 5, nsel), kv_pad=4))
    lb, lby = bound_ms(2.0 * m_rows * w * 2 * w,
                       2.0 * m_rows * w + 4.0 * w * w + 4.0 * n * t_out * w, PEAK_BF16_TC)
    print(f"  fused_encoder_attn_block last_only: {last_ms:.4f} ms (bound {lb:.4f} by {lby})",
          flush=True)
    del kk, vk, kp, vp, kl, vl, ho, hp

    # -- fused_encoder_mlp_block -------------------------------------------------
    got = eb.fused_encoder_mlp_block(h, blk["ln_2"], blk["mlp"])
    err = compare("fused_encoder_mlp_block", got,
                  eb.fused_encoder_mlp_block_plain(h, blk["ln_2"], blk["mlp"]), TOL_ENCODER)
    row("fused_encoder_mlp_block", "dfd_clip_tpu/ops/pallas_attention.py:1275",
        "dfd_clip_tpu_torch/ops/encoder_block.py",
        time_ms(lambda: eb.fused_encoder_mlp_block(h, blk["ln_2"], blk["mlp"])),
        time_ms(lambda: eb.fused_encoder_mlp_block_plain(h, blk["ln_2"], blk["mlp"])),
        None, 16.0 * m_rows * w * w, 4.0 * m_rows * w + 16.0 * w * w + 28.0 * w,
        PEAK_BF16_TC, err)
    del got, h

    # -- fused_decoder_attention ------------------------------------------------
    b, p = CLIPS, t_out
    l = FRAMES * p
    kv_shape = (nsel, b, l, hh, d)
    kall = (0.5 * torch.randn(kv_shape, generator=gen)).to(dev, bf)
    vall = torch.randn(kv_shape, generator=gen).to(dev, bf)
    kall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, 196:] = 0
    vall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, 196:] = 0
    pos = (0.04 * torch.randn(l, hh, d, generator=gen)).to(dev, bf)
    qrow = torch.randn(b, 2 * w, generator=gen).to(dev, bf)
    qs, qc = qrow[:, :w].reshape(b, 1, hh, d), qrow[:, w:].reshape(b, 1, hh, d)
    frames_ok = torch.ones(b, FRAMES, dtype=torch.bool, device=dev)
    mask = token_mask(frames_ok, p, 196)
    got = fda.fused_decoder_attention(qs, qc, kall, vall, mask, pos, layer=3)
    err = compare("fused_decoder_attention", got,
                  fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask, pos, layer=3),
                  TOL_DECODER)
    frames_ok[b - 2, FRAMES // 2:] = False
    frames_ok[b - 1] = False
    mask2 = token_mask(frames_ok, p, 196)
    got2 = fda.fused_decoder_attention(qs, qc, kall, vall, mask2, pos, layer=3)
    err = max(err, compare("fused_decoder_attention masked", got2,
                           fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask2, pos,
                                                             layer=3), TOL_DECODER))
    if got2[b - 1].abs().max().item() != 0:
        raise SystemExit("FAIL fused_decoder_attention: a fully masked sample is not 0")
    valid = mask.sum().item()
    row("fused_decoder_attention", "dfd_clip_tpu/ops/pallas_decoder_attention.py:505",
        "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
        time_ms(lambda: fda.fused_decoder_attention(qs, qc, kall, vall, mask, pos, layer=3)),
        time_ms(lambda: fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask, pos,
                                                          layer=3)),
        None, 16.0 * valid * w, 4.0 * valid * w + 2.0 * l * w + b * l + 6.0 * b * w,
        PEAK_F32, err, paths=("serve",))
    del kall, vall
    check_train_attention(rows, row, gen, dev)

    # -- decoder_boundary (first, middle and last forms) ---------------------------
    dgen = torch.Generator().manual_seed(2)
    dblk = {
        "ln_1": blk["ln_1"], "ln_2": blk["ln_2"], "mlp": blk["mlp"],
        "in_proj": {"w": (w ** -0.5 * torch.randn(w, 2 * w, generator=dgen)).to(dev, bf),
                    "b": (0.02 * torch.randn(2 * w, generator=dgen)).to(dev)},
        "out_proj": {"w": (w ** -0.5 * torch.randn(w, w, generator=dgen)).to(dev, bf),
                     "b": (0.02 * torch.randn(w, generator=dgen)).to(dev)},
    }
    x = torch.randn(b, w, generator=dgen).to(dev, bf)
    o = torch.randn(b, w, generator=dgen).to(dev, bf)
    tail = {"attn_out_proj": dblk["out_proj"], "ln_2": dblk["ln_2"], "mlp": dblk["mlp"]}
    query = {"ln_1": dblk["ln_1"], "in_proj": dblk["in_proj"]}
    err = 0.0
    for form, args in (("first", (x, None, None, query)), ("middle", (x, o, tail, query)),
                       ("last", (x, o, tail, None))):
        got = ds.decoder_boundary(*args)
        want = ds.decoder_boundary_plain(*args)
        for g_, w_, part in zip(got, want, ("x", "qrow")):
            if w_ is not None:
                err = max(err, compare(f"decoder_boundary {form} {part}", g_, w_, TOL_DECODER))
    row("decoder_boundary", "dfd_clip_tpu/ops/pallas_decoder_stack.py:102",
        "dfd_clip_tpu_torch/ops/decoder_stack.py",
        time_ms(lambda: ds.decoder_boundary(x, o, tail, query), iters=100),
        time_ms(lambda: ds.decoder_boundary_plain(x, o, tail, query), iters=100),
        None, 2.0 * b * 11 * w * w, 22.0 * w * w + 4.0 * 12 * w + 2.0 * 6 * b * w,
        PEAK_BF16_TC, err)


def check_train_attention(rows: list, row, gen, dev) -> None:
    """The training forward (partials) and the backward of the decoder
    attention at the flagship train shapes: slot 3 of a (6, 12, 4000, 12,
    64) bf16 stack with pos, one sample partly and one fully masked."""
    import torch

    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda
    from dfd_clip_tpu_torch.ops import fused_decoder_attention_bwd as fdb

    b, p, nsel, hh, d = TRAIN_CLIPS, 200, len(KEEP), 12, 64
    l, w, bf = FRAMES * p, hh * d, torch.bfloat16
    kv_shape = (nsel, b, l, hh, d)
    kall = (0.5 * torch.randn(kv_shape, generator=gen)).to(dev, bf)
    vall = torch.randn(kv_shape, generator=gen).to(dev, bf)
    kall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, 196:] = 0
    vall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, 196:] = 0
    pos = (0.04 * torch.randn(l, hh, d, generator=gen)).to(dev, bf)
    qrow = torch.randn(b, 2 * w, generator=gen).to(dev, bf)
    qs, qc = qrow[:, :w].reshape(b, 1, hh, d), qrow[:, w:].reshape(b, 1, hh, d)
    frames_ok = torch.ones(b, FRAMES, dtype=torch.bool, device=dev)
    frames_ok[b - 2, FRAMES // 2:] = False
    frames_ok[b - 1] = False
    mask = token_mask(frames_ok, p, 196)
    args = (qs, qc, kall, vall, mask, pos, 3)
    valid = mask.sum().item()

    (o_sc, st), (o_p, st_p) = (fda.fused_decoder_attention(*args, partials=True),
                               fda.fused_decoder_attention_plain(*args, partials=True))
    err = compare("partials numerator|coda", o_sc, o_p, TOL_DECODER)
    err = max(err, compare("partials denominator", st[: b - 1, 0], st_p[: b - 1, 0], TOL_DECODER))
    err = max(err, compare("partials maximum", st[: b - 1, 1], st_p[: b - 1, 1], TOL_DECODER))
    if o_sc[b - 1].abs().max().item() != 0 or st[b - 1, 0].abs().max().item() != 0 \
            or (st[b - 1, 1] != -1e30).any().item():
        raise SystemExit("FAIL partials: a fully masked sample is not (0, 0, -1e30)")
    row("fused_decoder_attention partials", "dfd_clip_tpu/ops/pallas_decoder_attention.py:505",
        "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
        time_ms(lambda: fda.fused_decoder_attention(*args, partials=True)),
        time_ms(lambda: fda.fused_decoder_attention_plain(*args, partials=True)),
        None, 16.0 * valid * w,
        4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 8.0 * b * w + 8.0 * b * hh,
        PEAK_F32, err, counter="fused_decoder_attention", paths=("train",))

    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, hh, d) / denom.clamp_min(1e-30)[..., None]
    ct = (0.1 * torch.randn(b, 1, hh, d, generator=gen)).to(dev, bf)
    bargs = args + (denom, mx, o_s, ct)
    got, want = fdb.fused_decoder_attention_bwd(*bargs), fdb.fused_decoder_attention_bwd_plain(*bargs)
    err = 0.0
    for g_, w_, part in zip(got, want, ("dq_smax", "dq_coda", "dpos")):
        err = max(err, compare(f"fused_decoder_attention_bwd {part}", g_, w_, TOL_DECODER))
    if got[0][b - 1].abs().max().item() != 0 or got[1][b - 1].abs().max().item() != 0:
        raise SystemExit("FAIL fused_decoder_attention_bwd: a fully masked sample's dq is not 0")
    # bytes: valid K/V rows, pos, mask, queries, g0, stats; dq and dpos out
    row("fused_decoder_attention_bwd", "dfd_clip_tpu/ops/pallas_decoder_attention.py:394",
        "dfd_clip_tpu_torch/csrc/decoder_attention_bwd.cu",
        time_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs)),
        time_ms(lambda: fdb.fused_decoder_attention_bwd_plain(*bargs)),
        None, 27.0 * valid * w,
        4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 4.0 * b * w + 12.0 * b * hh
        + 8.0 * b * w + 4.0 * l * w, PEAK_F32, err, paths=("train",))


def to_device(tree, dev):
    """Params to the card: matrix weights ("w") in bf16, the rest f32."""
    import torch

    if isinstance(tree, dict):
        return {k: (v.to(dev, torch.bfloat16) if k == "w" else to_device(v, dev))
                for k, v in tree.items()}
    return tree.to(dev, torch.float32)


def flagship_detector(**extra):
    """The flagship Detector (bench.py:_detector_cfg) on the card, bf16."""
    import torch

    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": list(KEEP),
                              "out_dim": [2], "losses": ["auc_roc"],
                              "op_mode": {"temporal_position": 1}, **extra})
    return Detector(cfg, num_frames=FRAMES, compute_dtype=torch.bfloat16, device="cuda")


def check_counts(path: str, counts: dict, expected: dict, runs: int) -> None:
    print("  kernels " + json.dumps(counts), flush=True)
    for name, per_run in expected.items():
        if counts.get(name, 0) != per_run * runs:
            raise SystemExit(f"FAIL {path} path: {name} launched {counts.get(name, 0)} times, "
                             f"expected {per_run * runs}")
    for name in ("gemm", "layer_norm_rows", "encoder_attention"):
        if counts.get(name, 0) <= 0:
            raise SystemExit(f"FAIL {path} path: {name} never launched")


def serve_path(card: str) -> dict:
    """A Scorer over the flagship Detector answers four requests. Returns
    the launch counts of those requests."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.serve import Scorer

    det = flagship_detector()
    scorer = Scorer(det, det.init_params(torch.Generator().manual_seed(0)), batch_size=CLIPS)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1, 224, 224, 3), np.uint8)
    requests = [np.clip(base.astype(np.int16) + rng.integers(-40, 41, (nf, 224, 224, 3)),
                        0, 255).astype(np.uint8) for nf in (40, 60, 80, 80)]

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    times, scores = [], []
    for frames in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores.append(scorer.score_frames(frames))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _cuda.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, (frames, s, dt) in enumerate(zip(requests, scores, times)):
        print(f"  request {i}: {len(frames)} frames -> {len(frames) // FRAMES} clips, "
              f"P(fake) {s:.6f}, {dt * 1e3:.2f} ms", flush=True)
        if not 0.0 <= s <= 1.0:
            raise SystemExit(f"FAIL request {i}: P(fake) {s} outside [0, 1]")
    steady = times[1:]
    print(f"  predict batch {CLIPS} clips x {FRAMES} frames: "
          f"{CLIPS * len(steady) / sum(steady):.2f} clips/s (padded batch clips), "
          f"{sum(len(f) // FRAMES for f in requests[1:]) / sum(steady):.2f} real clips/s, "
          f"peak memory {peak_gb:.3f} GB, on {card}", flush=True)
    check_counts("serve", counts, {"fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
                                   "fused_decoder_attention": 6, "decoder_boundary": 7},
                 len(requests))

    # one batch's logits: kernels vs the same Detector through the plain versions
    clips = requests[-1].transpose(0, 3, 1, 2).reshape(4, FRAMES, 3, 224, 224)
    x = np.concatenate([clips, np.repeat(clips[-1:], CLIPS - 4, 0)])
    m = np.ones((CLIPS, FRAMES), bool)
    m[-1, FRAMES // 2:] = False
    got = scorer.predict(scorer.params, x, m)
    with plain_versions():
        want = scorer.predict(scorer.params, x, m)
    compare("predict logits", got, want, TOL_ENCODER)
    dp = (got.float().softmax(-1)[:, 1] - want.float().softmax(-1)[:, 1]).abs().max().item()
    print(f"  predict |dP(fake)| max {dp:.3e} (tol {TOL_PFAKE:g})", flush=True)
    if dp > TOL_PFAKE:
        raise SystemExit(f"FAIL predict: |dP(fake)| {dp:.3e} > {TOL_PFAKE:g}")

    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
    print(f"  device-resident predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    profile_device("predict", lambda: scorer.predict(scorer.params, xd, md))
    profile_device("request", lambda: scorer.score_frames(requests[-1]))
    return counts


def train_path(card: str) -> dict:
    """A flagship Trainer takes TRAIN_STEPS steps. Returns their launch
    counts."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.ops import _cuda

    det = flagship_detector(dropout=0.5)
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3})
    rng = np.random.default_rng(1)
    labels = (np.arange(TRAIN_CLIPS) % 2).astype(np.int32)
    batches = [(rng.integers(0, 256, (TRAIN_CLIPS, FRAMES, 3, 224, 224), np.uint8), labels,
                np.ones((TRAIN_CLIPS, FRAMES), bool), ["raw"] * TRAIN_CLIPS,
                np.ones(TRAIN_CLIPS, np.float32), np.zeros(TRAIN_CLIPS, np.int64))
               for _ in range(2)]
    trainer = Trainer(tcfg, det, {"deepfake": batches}, seed=0)

    # each step's time, loss and learning rate, read around the Trainer's own step
    step, log = trainer.train_step, []

    def logged_step(round_batches):
        lr = trainer.current_lr()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(round_batches)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, float(trainer.batch_losses["deepfake"].mean()),
                    lr, trainer.optimizer.param_groups[0]["lr"]))

    trainer.train_step = logged_step
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    trainer.run()
    counts = _cuda.launches()
    trainer.train_step = step
    for i, (dt, loss, lr, used) in enumerate(log):
        print(f"  step {i}: loss {loss:.6f}, lr {used:.6e}, {dt * 1e3:.2f} ms", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"FAIL train step {i}: loss {loss}")
        if abs(used - trainer.schedule(i)) > 1e-12 or abs(lr - used) > 1e-12:
            raise SystemExit(f"FAIL train step {i}: lr {used} is not schedule({i}) "
                             f"= {trainer.schedule(i)}")
    if len(log) != TRAIN_STEPS:
        raise SystemExit(f"FAIL train path: {len(log)} steps, expected {TRAIN_STEPS}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, on {card}",
          flush=True)
    check_counts("train", counts, {"fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
                                   "fused_decoder_attention": 6,
                                   "fused_decoder_attention_bwd": 6, "decoder_boundary": 0},
                 TRAIN_STEPS)

    # one step's loss and decoder gradients: kernels vs the plain versions
    batch = trainer.prepare_batch(batches[0])
    leaves = named_leaves(trainer.trainable)

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(7)
        losses, _, _ = det.forward({**trainer.frozen, **trainer.trainable}, batch["x"],
                                   [batch["label"]], batch["m"], batch["comp_is_raw"],
                                   train=True, single_task=0, gen=gen)
        loss = losses[0].mean()
        return loss.item(), torch.autograd.grad(loss, [t for _, t in leaves])

    # Decoder kernels alone: the same export decoded through the kernels and
    # through their plain versions, held at TOL_DECODER on the loss and
    # TOL_ENCODER of each leaf's max. The whole plain route also swaps the
    # encoder, whose bf16 export differs from the kernels' by rounding order
    # (about 7e-3 of the predict logits); the backward at dropout 0.5 amplifies
    # that, so its leaves are held by relative L2 norm at TOL_TRAIN_GRAD.
    loss_k, grads_k = loss_and_grads()
    for route, encoder, measure, tol in (("decoder kernels", False, "max", TOL_ENCODER),
                                         ("all kernels", True, "l2", TOL_TRAIN_GRAD)):
        with plain_versions(encoder=encoder):
            loss_p, grads_p = loss_and_grads()
        rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  {route} vs plain: loss {loss_k:.6f} vs {loss_p:.6f}, rel {rel:.3e} "
              f"(tol {TOL_DECODER:g})", flush=True)
        if not rel <= TOL_DECODER:
            raise SystemExit(f"FAIL train loss ({route}): relative error {rel:.3e} > "
                             f"{TOL_DECODER:g}")
        worst = []
        for (path, _), gk, gp in zip(leaves, grads_k, grads_p):
            if measure == "max":
                err = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
            else:
                err = (gk - gp).norm().item() / max(gp.norm().item(), 1e-30)
            if not (torch.isfinite(gk).all() and err <= tol):
                raise SystemExit(f"FAIL train gradient ({route}) {path}: {measure} rel "
                                 f"{err:.3e} > {tol:g}")
            worst.append((err, ".".join(map(str, path))))
        worst.sort(reverse=True)
        print(f"  {route}: {len(worst)} gradient leaves within {tol:g} ({measure} rel); worst "
              + ", ".join(f"{name} {e:.3e}" for e, name in worst[:3]), flush=True)

    dev_round = [("deepfake", batch)]
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: trainer.train_step(dev_round), iters=5, warmup=1)
    print(f"  device-resident train step: {ms:.2f} ms per {TRAIN_CLIPS}-clip batch "
          f"({TRAIN_CLIPS * 1e3 / ms:.2f} clips/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, on {card}", flush=True)
    profile_device("train step", lambda: trainer.train_step(dev_round))
    return counts


def device_us(event) -> float:
    """Self device time of a profiler row (the attribute's name varies
    across torch versions)."""
    return getattr(event, "self_device_time_total", None) or event.self_cuda_time_total


def profile_device(name: str, fn) -> None:
    """Device busy time and the kernels that take it over one call of fn
    (torch.profiler): the breakdowns of PERF.md section 5."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched, and a user annotation on
    # the device timeline (the optimizer's step) spans kernels counted apart
    events = [e for e in prof.key_averages()
              if e.self_cpu_time_total == 0 and device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    device = sum(device_us(e) for e in events) / 1e3
    print(f"  profile {name}: wall {wall * 1e3:.2f} ms, device busy {device:.2f} ms "
          f"({100 * device / (wall * 1e3):.1f} %), {sum(e.count for e in events)} device "
          f"kernels and copies", flush=True)
    for e in sorted(events, key=lambda e: -device_us(e))[:8]:
        print(f"    {device_us(e) / 1e3:9.3f} ms {e.count:5d}x {e.key[:70]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from dfd_clip_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[card] {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}",
          flush=True)
    print("[note] plain versions run with TF32 off (matmul and cudnn)", flush=True)

    t0 = time.perf_counter()
    lib_path, log = _cuda.build()
    _cuda.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            print("  " + line.strip(), flush=True)

    rows: list = []
    print("[kernels] flagship shapes, bf16", flush=True)
    check_kernels(rows)
    counts = {}
    print("[serve path] Scorer over ViT-B/16, 20 frames, keep 6-11, bf16, batch 16", flush=True)
    counts["serve"] = serve_path(card)
    print(f"[train path] Trainer over ViT-B/16, 20 frames, keep 6-11, bf16, batch "
          f"{TRAIN_CLIPS}, dropout 0.5, SGD + OneCycle, {TRAIN_STEPS} steps", flush=True)
    counts["train"] = train_path(card)

    for r in rows:
        key, paths = r.pop("counter"), r.pop("paths")
        r["launches_by_path"] = {p: counts[p].get(key, 0) for p in paths}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
