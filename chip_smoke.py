#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dfd_clip_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--pfake-seeds N]

1. prints the card, its power limit and the torch / nvcc versions;
2. builds the port's CUDA kernels from dfd_clip_tpu_torch/csrc (timed);
3. at the flagship shapes (CLIP ViT-B/16, 16 clips x 20 frames for serving
   and 12 clips x 20 frames for training, kept layers 6-11, bf16) runs every
   kernel against its plain PyTorch version on the same inputs, with stated
   tolerances, and times kernel, plain version, a one-call PyTorch yardstick
   where one exists, and the card's bound (layer_norm_rows also on f32
   rows, and each bf16 row's f32 form timed beside it; the decoder
   boundary's one launch in its three forms, one launch a call, held
   against its plain version and, link by link on its own intermediates,
   against the six-launch chain of gemm and layer_norm_rows it replaced,
   timed by CUDA events, device time and host issue time beside that chain,
   with one launch's stage clock; the decoder attention's backward, one
   launch a call, held against its plain version, a fully masked sample's
   dq exactly 0, two calls bit-equal, timed by CUDA events, device time
   and host issue time, at the train shape and at 16 heads over 5,120 and
   11,520 keys); then sweeps the encoder
   attention's two entries and outputs over 1 to 1025 tokens against its
   plain version, with several work items to each of the kernel's
   persistent blocks (`[kernels sweep]`);
4. drives the serving path: a Scorer over a full-width, randomly
   initialised (seeded) ViT-B/16 Detector answers four requests of decoded
   224x224 uint8 frames, with every launch counter zeroed just before and
   read just after; one batch's logits are held against the same Detector
   run through the plain versions; then a device-resident predict is timed
   and one predict and one request are traced with torch.profiler (device
   busy time and the kernels that take it); then the HTTP entry as a user
   runs it (`[serve http]`, which needs cv2 and yaml): a run directory
   written by the port's save_params from seeded params with a setting.yaml
   for the flagship preset, Scorer.from_run_dir (setting.yaml read, then
   from_preset), a ThreadingHTTPServer on 127.0.0.1 answering /healthz, 404
   for an unknown path, four synthetic:// videos through /score_path (40-80
   frames, one at 320 pixels) and a cv2-written mp4v video's bytes through
   /score, each counted (12 / 11 / 6 / 7 launches) and equal to an
   independent Scorer's score_frames on the same frames, HTTP and Scorer
   times printed, and 400 for a missing video; then inference.main
   (`python -m dfd_clip_tpu_torch.inference`'s entry) on the same run over
   a Celeb-DF tree of four cv2-written videos, counted and each video's
   P(fake) equal to that Scorer's on the clips the dataset packs; then one
   predict with patch_indices (98 of 196 patches a kept layer) held against
   the plain versions;
5. checks the int8 kernels (W8A8 GEMM, the row quantisers, the MLP's c_fc
   with its rows quantised on chip (gemm_s8_quant), the f32 encoder
   attention, the whole int8 block, the int8 last_only layer and the int8
   K/V decoder attention) against their plain versions at the flagship
   shapes; after the int8 sweep below, gemm and gemm_s8 at every path shape
   and gemm_s8_quant at the ViT-B, ViT-L and ViT-L@336 c_fc shapes, bit for
   bit against gemm_s8's f32 QuickGELU form + quant_rows and timed beside
   that pair (`[kernels gemm]`); and drives int8 serving: a Scorer over the
   flagship Detector with
   op_mode compute_int8 answers the same four requests, launch counters
   zeroed before and read after; one batch's logits are held against its
   plain route and compared with the bf16 Detector on the same parameters;
   a device-resident predict is timed and traced; then a compute_int8 +
   kv_dtype "int8_rows" Detector runs one device-resident predict, counted,
   held against its plain route, timed and traced; before the int8 serve
   path, the int8 encoder attention is swept over 1 to 1025 tokens in both
   modes on 24 frames of 12 heads (more than two work items to each
   persistent block) against its plain version, and timed at the paths'
   shapes, (320, 197, 12 x 64), (320, 257, 16 x 64) and (320, 577, 16 x 64),
   beside the bf16 encoder attention's f32 output and its bound (`[kernels
   int8 sweep]`);
6. drives the training path: a flagship Trainer (batch 12, dropout 0.5,
   SGD + OneCycle) takes four steps on seeded synthetic uint8 batches, with
   every launch counter zeroed just before and read just after; one step's
   loss and decoder gradients are held against the same step through the
   plain versions of the decoder kernels and through the plain versions of
   all kernels (same parameters, batch and dropout seed); then a
   device-resident train step is timed, its peak memory read, and one step
   traced with torch.profiler;
7. checks the 257-token kernels at their path shapes (`[kernels wide]`):
   the packed encoder attention at CLIP ViT-L/14's (320, 257, 16 x 64), the
   separate-q/k/v one at DINOv2 ViT-B/14's (320, 257, 12 x 64) on strided
   views of one packed buffer (and on contiguous tensors), each against its
   plain version with a scaled_dot_product_attention yardstick, the int8
   split pair (fused_encoder_attn_block and fused_encoder_mlp_block with
   int8_gemm) at (320, 257, 1024) with each kernel of its chain, the
   towers' layer_norm_rows, and the decoder at these paths' shapes
   (attention over 16 x 5120 rows at 16 and 12 heads, boundaries at width
   1024);
8. drives ViT-L/14 serving (`[vit-l serve path]`, keep 0, 4, ..., 20): a
   Scorer answers the four requests in bf16 (the XLA composition with the
   packed attention kernel), then a compute_int8 Scorer (the int8 split
   pair) answers them again, counters zeroed before and read after each;
   on the params of `--pfake-seeds` seeds (default 3) and two batches each
   the kernels, the plain route and the plain route in f32 are compared and
   the kernels' logits and P(fake) held against the f32 route, their P(fake)
   against the bf16 plain route (|dP| <= 1e-2), int8 against bf16 by
   cosine, and a
   device-resident predict of each is timed and traced; on the bf16 route
   each block's two halves (attention, MLP) are fed the same input through
   the kernels and the bf16 plain route and read layer by layer;
9. drives DINOv2 ViT-B/14 serving (`[dinov2 serve path]`, keep 6-11) the
   same way in bf16;
10. checks the encoder's alternative kernels at the flagship shapes
   (`[kernels variants]`): the bf16 whole block with its stacked export, the
   int8 encoder attention in both modes at (320, 197, 12 x 64), and the
   whole-encoder tower (12 layers, keep 6-11) in bf16 and int8 with int8
   attention "0", "1" and "qk", each against its plain version and against
   the per-layer kernel chain, whose bodies its stages run (to 1e-3 of the
   max with 99 % of the values equal; with bf16 attention each layer's
   stage is also held on the same input and the tower's K/V printed layer
   by layer), timed with its bound beside the chain's time on the same
   input, its chunk, grid, grid barriers and the build's time, one launch's
   stage clock, and (bf16, int8 attention "1") its time at each chunk rule;
11. drives the six paths of those kernels (`[variant serve paths]`): a
   Scorer over the flagship Detector with EncoderKernels(block="full"), with
   compute_int8 and int8_attn "1", and with tower=True in bf16 and in
   compute_int8 with int8_attn "0", "1" and "qk" answers the four requests,
   counters zeroed before and read after each; then one counted
   device-resident predict of compute_int8 with int8_attn "qk" (the
   per-layer qk form). Each path's encoder launch counts are asserted, one
   batch is held against its plain route (|dP(fake)| <= 1e-2), the int8
   paths' logits are compared with the bf16 whole block's by cosine (gated at
   0.99 without int8 attention, recorded with it), and a device-resident
   predict is timed and traced;
12. checks the 577-token kernels at CLIP ViT-L/14@336px's shapes
   (`[kernels 577]`): the encoder attention at (320, 577, 16 x 64)
   through both entries, bf16 and f32 out, each against its plain version
   with a scaled_dot_product_attention yardstick, the int8 split pair at
   (320, 577, 1024), quant_rows on the whole int8 block's (184640, 1024)
   attention output, layer_norm_rows on (184640, 1024) rows, and the
   decoder attention over L = 20 x 576 keys;
13. drives ViT-L/14@336px serving (`[vit-l@336 serve path]`, keep 0, 4, ...,
   20) as in 8, on one parameter seed (`--pfake-seeds` N other than the
   default reads N here too): the four requests in bf16 and in
   compute_int8 (20 encoder attention launches a predict), logits and
   P(fake) held
   against the f32 plain route, int8 against bf16 by cosine, a
   device-resident predict timed, its peak memory read and traced;
14. checks the ViT-L int8 ladder's kernels at its shapes (`[kernels tower
   wide]`, 320 frames, width 1024, 16 heads): the whole int8 block at 257 and
   577 tokens with int8 attention "0" and "1"; the 24-layer int8 tower
   (keep 18-23) at 257 and 577 tokens in each int8 attention mode, against
   the per-layer kernel chain (bit-level, as in 10; with bf16 attention
   each layer's stage on the same input too) and the plain chain, timed
   beside the chain with its chunk, grid, grid barriers and stage clock
   (mode "0": at each chunk rule too), printing the kernel chain's drift
   from the plain chain layer by layer;
15. drives the JAX package's megaL ladder (`[vit-l ladder]`,
   tools/bench_r3_ladder.py:330-393): on ViT-L/14 and ViT-L/14@336px (24
   layers, keep 18-23, compute_int8, one parameter seed) each rung, the
   split control, block "full" with int8 attention "0" and "1" and the
   tower with "0", "1" and "qk", answers the four requests through a
   Scorer, counters zeroed before and read after, its launches asserted;
   the last request's batch is held against the plain route in f32, its
   logits compared with the split control's by cosine (gated without int8
   attention), each tower rung's K/V held to its per-layer kernel chain
   (bit-level, as in 10);
   a device-resident predict is timed and traced;
16. checks the tools' kernels (`[kernels study]`): every numerics mode of
   the study attention at (320, 197, 12 x 64) through the port tool's
   variants, each against the tool's own check and its plain version, and
   the megakernel probe's two entries at (63040, 768) x 12 layers,
   bit-equal to each other and held to the plain chain, each timed by CUDA
   events and by its device time in a trace, with its share of the
   operations bound beside 12 chained torch.matmul; then runs both
   ported tools as a user does (`[tool_attention]`, `[tool_probe]`),
   counters zeroed before and read after each;
17. prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase raises and the script exits nonzero without the last line.
It needs one card and no network; it imports nothing of the JAX package.
The plain versions run with TF32 disabled for matmuls and convolutions.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
PEAK_INT8_TC = 1979e12    # H100 SXM dense int8 tensor-core OP/s (data sheet)
PEAK_F32 = 67e12          # H100 SXM f32 outside the tensor cores
HBM = 3.35e12             # H100 SXM device-memory bytes/s
TOL_ENCODER, TOL_DECODER, TOL_PFAKE = 2e-2, 1e-2, 1e-2
TOL_TRAIN_GRAD = 1e-1     # whole plain route, per-leaf relative L2 (see train_path)
# int8 quantisers: values may differ by 1 on this share of the elements
# (quant_rows: the same f32 operations; layer_norm_quant: LN sums in another
# order), scales within TOL_SCALE relative
TOL_FLIPS_QUANT, TOL_FLIPS_LN, TOL_SCALE = 1e-5, 1e-4, 1e-6
TOL_COSINE = 0.99         # int8 vs bf16 logits on the same parameters
# The 12-layer towers against their plain version (the per-layer plain
# chain): the kernels' f32 sums run in another order, which moves int8
# quantisers across a rounding step (1/127 of a row's maximum) and bf16 by an
# ulp, and the next layers carry that on (on an H100 80GB HBM3 at 700 W: bf16
# 8.9e-3, int8 2.6-2.8e-2 of the max).
TOL_TOWER = 5e-2
# Each tower is also held to its per-layer kernel chain, whose bodies its
# stages run (the GEMM frame with the same Op types and epilogue forms, the
# encoder attention's body, the row and int8 attention bodies): within
# TOL_CHAIN of the max with at least CHAIN_EQUAL of the values equal
# (bit-equal in every mode on an H100 80GB HBM3 at 700 W, PERF.md).
TOL_CHAIN, CHAIN_EQUAL = 1e-3, 0.99


def hold_chain(name: str, pairs) -> tuple:
    """A tower's outputs against its per-layer kernel chain's, ``pairs`` of
    (tower, chain) tensors: max|d| / max|chain| within TOL_CHAIN and at least
    CHAIN_EQUAL of the values equal, else the run fails after the phase.
    Returns (rel_err, equal share)."""
    err = max(rel_err(got, chain) for got, chain in pairs)
    same = min((got == chain).float().mean().item() for got, chain in pairs)
    print(f"  {name} vs the per-layer kernel chain: rel_err {err:.3e}, equal share {same:.6f}, "
          f"bit-equal {same == 1.0} (tol {TOL_CHAIN:g}, equal >= {CHAIN_EQUAL:g})", flush=True)
    if err > TOL_CHAIN or same < CHAIN_EQUAL:
        fail(f"FAIL {name}: {err:.3e} from the per-layer kernel chain, {same:.6f} of the values "
             f"equal", True)
    return err, same


def chunk_rules(frames: int, tokens: int, width: int, clusters: int) -> dict:
    """The tower's chunk rules timed against each other (frames a chunk):
    the earlier L2 rule, a chunk's h and qkv within half of the 50 MB L2
    (floor(25 MiB / (8 T W))); the most frames whose W-wide products fill
    the co-resident clusters 1 to 8 times; and ops/_cuda.py tower_chunk's,
    the whole batch up to 2^16 rows."""
    from dfd_clip_tpu_torch.ops import _cuda

    rules = {"L2 (earlier)": max(1, min(frames, 25 * 2 ** 20 // (8 * tokens * width)))}
    # a unit is two 128-row panels at one 256-column tile of the W-wide product
    panels = 2 * (clusters // -(-width // 256))
    for waves in (1, 2, 4, 8):
        rules[f"{waves} wave{'s' if waves > 1 else ''}"] = max(
            1, min(frames, waves * panels * 128 // tokens))
    rules["tower_chunk (the whole batch, <= 2^16 rows)"] = _cuda.tower_chunk(frames, tokens)
    return rules


def tower_timings(name: str, h, blocks: list, hh: int, keep: tuple, int8: bool, mode: str,
                  ms: float, chain_ms: float, rules: bool = False) -> None:
    """Print the tower's time beside its per-layer kernel chain's on the same
    input, its chunk, grid, grid barriers a launch and the build's time, then
    one launch's stage clock (tools/bench_tower_stages.py) and, with
    ``rules``, the tower timed at each rule of chunk_rules."""
    from dfd_clip_tpu_torch.ops import _cuda, tower
    from dfd_clip_tpu_torch.tools import bench_tower_stages as bts

    n, t, w = h.shape
    grid = _cuda.tower_grid(t, int8, mode)
    clusters = grid // _cuda.TOWER_CLUSTER
    chunk = _cuda.tower_chunk(n, t)
    print(f"  {name}: tower {ms:.3f} ms, per-layer kernel chain {chain_ms:.3f} ms on the same "
          f"input (tower / chain {ms / chain_ms:.3f}); chunk {chunk} frames, grid {grid} blocks "
          f"({clusters} clusters of {_cuda.TOWER_CLUSTER}), "
          f"{_cuda.tower_barriers(n, chunk, keep[-1] + 1, int8)} grid barriers a launch; build "
          f"{BUILD_S:.2f} s", flush=True)
    stages, total = bts.stage_times(h, blocks, hh, keep, int8, mode)
    print(f"  {name} stage clock (one launch, {total:.3f} ms): " + ", ".join(
        f"{k} {v[0]:.3f} ms ({1e3 * v[0] / v[1]:.1f} us x {v[1]})"
        for k, v in sorted(stages.items(), key=lambda kv: -kv[1][0])), flush=True)
    if not rules:
        return
    layers = [tower._layer(b, h.dtype, int8) for b in blocks[: keep[-1] + 1]]
    times = []
    for rule, frames in chunk_rules(n, t, w, clusters).items():
        tm = time_ms(lambda: _cuda.encoder_tower(h, layers, hh, first=keep[0], lo=1, int8=int8,
                                                 attn=mode, chunk=frames), iters=3, warmup=1)
        times.append(f"{rule}: {frames} frames {tm:.3f} ms")
    print(f"  {name} chunk rules: " + "; ".join(times), flush=True)


def tower_stage_holds(name: str, blocks: list, inputs: list, hh: int, d: int, int8: bool,
                      mode: str) -> list:
    """Each layer's tower stage against the per-layer kernels on the same
    input, before any layer carries a difference on: for layer i a two-layer
    tower (keep (1,)) over ``inputs[i]``, the per-layer chain's input to
    layer i, against the per-layer kernels' block i and layer i + 1's K/V
    columns, held at TOL_ENCODER. Returns the readings, layer by layer."""
    import torch

    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import tower

    errs = []
    for i, x in enumerate(inputs):
        k, v = tower.fused_encoder_tower(x, blocks[i:i + 2], hh, d, keep=(1,), drop_cls=True,
                                         int8_gemm=int8, int8_attn=mode)
        kc, vc = torch.empty_like(k), torch.empty_like(v)
        b, nxt = blocks[i], blocks[i + 1]
        y = eb.fused_encoder_block(x, b["ln_1"], b["attn"], b["ln_2"], b["mlp"], hh, d,
                                   int8_gemm=int8, int8_attn=mode)
        eb.fused_encoder_attn_block(y, nxt["ln_1"], nxt["attn"], hh, d, drop_cls=True,
                                    last_only=True, export_into=(kc, vc, 0, 1), int8_gemm=int8)
        errs.append(max(rel_err(k, kc), rel_err(v, vc)))
        del k, v, kc, vc, y
    print(f"  {name}, each layer's stage vs the per-layer kernels on the same input (K/V of "
          f"the next layer, rel of the max, layers 0-{len(errs) - 1}): "
          + " ".join(f"{e:.2e}" for e in errs) + f" (tol {TOL_ENCODER:g})", flush=True)
    if max(errs) > TOL_ENCODER:
        fail(f"FAIL {name}: a layer's stage {max(errs):.3e} from the per-layer kernels", True)
    return errs


# The 257-token paths hold their logits (rel_err of the max) and P(fake)
# against the plain versions computing in f32 (the exact route): on these
# random towers the bf16 rounding of the path itself moves the normalised
# logits past TOL_ENCODER and P(fake) past TOL_PFAKE, the bf16 plain route as
# much as the kernels (PERF.md section 6). The limits are set from the
# bf16 plain route's own distance from the f32 route over the 48 batches of
# `--pfake-seeds 8` (3 paths x 8 seeds x 2 batches; at most 2.36e-2 in P(fake)
# and 2.83e-2 in the logits on an H100), with a margin.
TOL_PFAKE_F32, TOL_LOGITS_F32 = 3e-2, 5e-2
PFAKE_SEEDS = 3           # parameter seeds each 257-token path is held on
# token counts of the encoder attention's sweep: one key block (1, 17, 64),
# a ragged one (65), ViT-B/16, ViT-L/14 (a narrow last block, an odd
# query-tile count), the old staged limit and one past it, ViT-L/14@336px
# (the K/V ring full) and one that refills the ring
SWEEP_TOKENS = (1, 17, 64, 65, 197, 257, 320, 321, 577, 1025)
# frames of the sweep: at 12 heads more than two work items, (frame, head)
# pairs, to each of the kernel's persistent blocks (one a SM, 132 on an
# H100 SXM), so that tiles are dealt across items and the ring refills
# item after item
SWEEP_FRAMES = 24
VITB_PATHS = ("serve", "serve_http", "train", "int8_serve", "int8_rows")
VITL_PATHS = ("vitl_serve", "vitl_int8_serve")
# the encoder's alternative kernel paths (EncoderKernels): block="full" in
# bf16, compute_int8 with int8_attn "1" and "qk", and the tower
VARIANT_PATHS = ("full_bf16", "int8_attn", "int8_qk", "tower_bf16", "tower_int8",
                 "tower_int8_attn", "tower_int8_qk")
INT8_VARIANTS = ("int8_attn", "int8_qk")      # the per-layer int8 whole block
# the paths on which neither shared row kernel runs now that the decoder
# boundary is one launch (csrc/decoder_boundary.cu): the int8 encoder blocks
# and the towers launch neither gemm nor layer_norm_rows (the int8 split
# pair's bf16 out-projection still launches gemm; the ViT-L and DINOv2 bf16
# compositions' products are torch's, so they launch no gemm either)
NO_BF16_ROWS = {"gemm": 0, "layer_norm_rows": 0}
# ViT-L/14 @ 224 with decode_stride 4 (tests/test_models.py:433-440): 257
# tokens, kept layers 0, 4, ..., 20; DINOv2 ViT-B/14 (configs/deepfake/dino/
# deepfake.yaml:17-27): 257 tokens, kept layers 6-11
WIDE_TOKENS, VITL_KEEP = 257, (0, 4, 8, 12, 16, 20)
# ViT-L/14@336px (OpenAI CLIP's public release, models/clip_vit.py
# ARCHITECTURES) with the same decode_stride 4: 577 tokens, a 576-row export;
# held on one parameter
# seed (two batches) to keep the run's time down
L336_TOKENS, L336_SEEDS = 577, 1
VITL336_PATHS = ("vitl336_serve", "vitl336_int8_serve")
# the JAX package's megaL ladder (tools/bench_r3_ladder.py:330-393, BENCH_ARCH
# ViT-L/14 or ViT-L/14@336px; bench.py:63-68 adds the qk rung): 24 layers,
# the last 6 kept, compute_int8, through the encoder's kernel forms
LADDER_KEEP = tuple(range(18, 24))
LADDER_RUNGS = {  # rung: EncoderKernels arguments
    "split": {},
    "full": {"block": "full"},
    "full_attn": {"block": "full", "int8_attn": "1"},
    "tower": {"tower": True},
    "tower_attn": {"tower": True, "int8_attn": "1"},
    "tower_qk": {"tower": True, "int8_attn": "qk"},
}
LADDER_ARCHS = (("ViT-L/14", "vitl"), ("ViT-L/14@336px", "vitl336"))
VITL_LADDER = tuple(f"vitl_{r}" for r in LADDER_RUNGS)
VITL336_LADDER = tuple(f"vitl336_{r}" for r in LADDER_RUNGS)
# the port's tools (dfd_clip_tpu_torch/tools) run as a user runs them
TOOL_PATHS = ("tool_attention", "tool_probe")
# the tools/bench_attention.py variants held and timed on the card, one a
# kernel body and packed site: (variant, pallas_call line, numerics mode)
STUDY_ROWS = (("pallas_frames2", 102, "f32"), ("pallas_bf16_f1", 102, "bf16"),
              ("pallas_diet_max_f1", 102, "diet"), ("pallas_diet_nomax_f1", 102, "diet_nomax"),
              ("pallas_pair_packed", 252, "f32"), ("pallas_full_packed", 323, "bf16"))
DEFERRED: list = []       # failed holds of a phase that ran to its end
BUILD_S = 0.0             # the kernels' build, seconds (main)


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


def kernel_row(rows: list, name, replaces, source, ms, plain, lib, flops, nbytes, peak, err,
               counter=None, paths=("serve", "train"), bound=None):
    """One kernel's line; its launches are read later from ``counter``
    (default: the name) in the runs of ``paths``. ``bound`` (ms, by)
    overrides the bound of ``flops`` at ``peak`` and ``nbytes``."""
    b, by = bound or bound_ms(flops, nbytes, peak)
    rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": lib,
                 "counter": counter or name, "paths": paths})
    print(f"  {name}: {ms:.4f} ms (plain {plain:.4f}, library "
          f"{'n/a' if lib is None else f'{lib:.4f}'}, bound {b:.4f} by {by}; "
          f"{'' if lib is None else f'ms / library {ms / lib:.3f}, '}bound / ms {b / ms:.3f})",
          flush=True)


def compare(name: str, got, want, tol: float, defer: bool = False) -> float:
    """Max abs error; fails when max|got - want| / max|want| exceeds tol or
    anything is not finite (with ``defer``, a relative error past tol fails
    the run after its last phase: DEFERRED)."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                         f"or non-finite output")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    print(f"  {name}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g})", flush=True)
    if rel > tol:
        fail(f"FAIL {name}: relative error {rel:.3e} > {tol:g}", defer)
    return err


def fail(message: str, defer: bool) -> None:
    """Stop the run now, or with ``defer`` after its last phase."""
    if not defer:
        raise SystemExit(message)
    DEFERRED.append(message)
    print("  " + message, flush=True)


@contextlib.contextmanager
def plain_versions(encoder: bool = True):
    """Route the Detector through the plain PyTorch versions (for the
    end-to-end reference only); with ``encoder=False`` only the decoder's
    kernels, so both routes decode the same encoder export."""
    from dfd_clip_tpu_torch.models import clip_vit, decoder, layers
    from dfd_clip_tpu_torch.ops import (
        attention,
        decoder_attention_vjp,
        decoder_stack,
        encoder_block,
        fused_decoder_attention,
        fused_decoder_attention_bwd,
        tower,
    )

    swaps = [
        (clip_vit, "fused_encoder_tower", tower.fused_encoder_tower_plain),
        (clip_vit, "fused_encoder_attn_block", encoder_block.fused_encoder_attn_block_plain),
        (clip_vit, "fused_encoder_mlp_block", encoder_block.fused_encoder_mlp_block_plain),
        (clip_vit, "fused_encoder_block", encoder_block.fused_encoder_block_plain),
        (clip_vit, "encoder_self_attention_qkv", attention.plain_attention_qkv),
        (clip_vit, "encoder_self_attention", attention.plain_attention),
        (layers, "layer_norm_rows", layers.layer_norm),
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
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    cfg = clip_vit.VIT_B16
    n, t, w, hh, d = CLIPS * FRAMES, cfg.num_tokens, cfg.width, cfg.heads, cfg.head_dim
    m_rows, t_out, nsel, bf = n * t, 200, len(KEEP), torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    blk = random_block(gen, dev)
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)
    row = functools.partial(kernel_row, rows)

    # -- layer_norm_rows ------------------------------------------------------
    h2 = h.reshape(m_rows, w)
    ln1 = blk["ln_1"]
    check_layer_norm(rows, "layer_norm_rows", h2, ln1, VITB_PATHS + VARIANT_PATHS)
    # f32 rows: the bf16 whole block's LN2 of its f32 residual stream hmid
    check_layer_norm(rows, f"layer_norm_rows f32 {m_rows} x {w}",
                     3.0 * torch.randn(m_rows, w, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(14)),
                     blk["ln_2"], ("full_bf16",))

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
        PEAK_BF16_TC, err, paths=VITB_PATHS + ("dinov2_serve",) + VARIANT_PATHS)

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
        4.0 * n * hh * t * t * d, 2.0 * (m_rows * 3 * w + m_rows * w), PEAK_BF16_TC, err,
        paths=("serve", "serve_http", "train", "full_bf16"))
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
    row("fused_encoder_attn_block", "dfd_clip_tpu/ops/pallas_attention.py:532",
        "dfd_clip_tpu_torch/ops/encoder_block.py", time_ms(attn_full), time_ms(attn_plain),
        None, flops, nbytes, PEAK_BF16_TC, err,
        paths=("serve", "serve_http", "train", "full_bf16"))
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
    row("fused_encoder_mlp_block", "dfd_clip_tpu/ops/pallas_attention.py:1326",
        "dfd_clip_tpu_torch/ops/encoder_block.py",
        time_ms(lambda: eb.fused_encoder_mlp_block(h, blk["ln_2"], blk["mlp"])),
        time_ms(lambda: eb.fused_encoder_mlp_block_plain(h, blk["ln_2"], blk["mlp"])),
        None, 16.0 * m_rows * w * w, 4.0 * m_rows * w + 16.0 * w * w + 28.0 * w,
        PEAK_BF16_TC, err, paths=("serve", "serve_http", "train"))
    del got, h

    # -- fused_decoder_attention and decoder_boundary (the ViT-B export: 200
    # rows a frame, 196 of them valid); DINOv2's boundaries run at this width
    check_decoder_attention(rows, "fused_decoder_attention", gen, dev, hh, t_out, 196,
                            ("serve", "serve_http", "int8_serve") + VARIANT_PATHS)
    check_train_attention(row, gen, dev)
    check_decoder_boundary(rows, "decoder_boundary", blk, 2,
                           VITB_PATHS + ("dinov2_serve",) + VARIANT_PATHS)


# The GEMMs' path shapes (csrc/gemm.cu, csrc/gemm_s8.cu), rows M of each
# path: the ViT-B/16 serve batch (16 clips x 20 frames x 197 tokens), the
# train batch (12 x 20 x 197), ViT-L/14 (320 x 257) and ViT-L/14@336px
# (320 x 577) at width 1024, and the decoder's 16 rows (the links of the
# six-launch chain that the decoder boundary's one launch is held against).
GEMM_ROWS = {"vit-b": CLIPS * FRAMES * 197, "train": TRAIN_CLIPS * FRAMES * 197,
             "vit-l": CLIPS * FRAMES * 257, "vit-l@336": CLIPS * FRAMES * 577, "boundary": CLIPS}
TOL_S8_GELU = 1e-5        # gemm_s8 with QuickGELU: expf against torch.sigmoid
# gemm_s8_quant against its plain version: the quantiser's f32 input differs
# by an ulp where expf and torch.sigmoid round apart (TOL_S8_GELU), which can
# move a value across a rounding step as a LayerNorm sum's order does; against
# gemm_s8's QuickGELU form + quant_rows it is bit for bit
TOL_FLIPS_GELU = 1e-4


def wgmma_serialised(log: str, sources: tuple) -> list:
    """The ptxas lines of these sources' sections of the build log that say
    their wgmma products were serialised (C7510-C7520)."""
    bad = []
    for section in log.split("== ")[1:]:
        name = section.split("\n", 1)[0].strip()
        if name in sources:
            bad += [f"{name}: {line.strip()}" for line in section.splitlines()
                    if "C75" in line or "serializ" in line]
    return bad


def gemm_line(name: str, ms: float, plain: float, lib: float, flops: float, nbytes: float,
              peak: float) -> None:
    b, by = bound_ms(flops, nbytes, peak)
    print(f"  {name}: {ms:.4f} ms (plain {plain:.4f}, library {lib:.4f}, ms / library "
          f"{ms / lib:.3f}, bound {b:.4f} by {by}, bound / ms {b / ms:.3f})", flush=True)


def check_gemm_kernels() -> None:
    """gemm and gemm_s8 at every path shape against their plain versions,
    with the one-call yardsticks torch.addmm (bf16) and torch._int_mm (int8,
    no epilogue): bf16 within TOL_ENCODER, every W8A8 form without QuickGELU
    bit for bit, QuickGELU within TOL_S8_GELU; the K/V export into a stacked
    slot with its pad rows zero. Then gemm_s8_quant at the three c_fc shapes:
    bit for bit gemm_s8's QuickGELU form + quant_rows (q and s), against its
    plain version within TOL_FLIPS_GELU, timed beside that pair (and each of
    its two launches), torch._int_mm and its bound."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import w8a8_dot_plain, w8a8_gelu_quant_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    def exported(m, w, tokens, drop_cls=1, pad=4):
        t_out = tokens - drop_cls + pad
        kb = torch.full((2, m // tokens, t_out, w), float("nan"), device=dev, dtype=bf)
        return kb, torch.full_like(kb, float("nan")), t_out

    def hold_export(name, kb, vb, want, tokens, w):
        frames = kb.shape[1]
        rows = want.reshape(frames, tokens, -1)[:, 1:]
        if not (torch.equal(kb[1, :, tokens - 1:], torch.zeros_like(kb[1, :, tokens - 1:]))
                and torch.equal(vb[1, :, tokens - 1:], torch.zeros_like(vb[1, :, tokens - 1:]))
                and torch.isnan(kb[0]).all() and torch.isnan(vb[0]).all()):
            raise SystemExit(f"FAIL {name}: export pad rows not zero or another slot written")
        return rows[..., -2 * w: -w], rows[..., -w:]

    # -- bf16 -------------------------------------------------------------------
    def bf16_case(name, m, k, n, form, tokens=197):
        a = randn(m, k)
        wt = randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1, dtype=torch.float32)
        res = None
        kw = {}
        if form == "export":
            w = n // 3
            kb, vb, t_out = exported(m, w, tokens)
            kw = dict(export=(kb[1], vb[1], tokens, t_out, 1, w))
        elif form in ("resid", "resid_bf16_bias"):
            res = randn(m, n)
            kw = dict(residual=res)
        elif form == "wide_out":
            res = randn(m, n)
            kw = dict(residual=res, residual_before_cast=True, out_dtype=torch.float32)
        elif form == "wide_res":
            res = randn(m, n, dtype=torch.float32)
            kw = dict(residual=res)
        if form in ("gelu", "gelu_bf16_bias"):
            kw["gelu"] = True
        if form.endswith("bf16_bias"):
            kw["bias_after_cast"] = True

        def plain():
            acc = a.float() @ wt.float()
            if kw.get("bias_after_cast"):
                v = (acc.to(bf) + bias.to(bf)).float()
            else:
                v = acc + bias
            if kw.get("gelu"):
                v = v * torch.sigmoid(1.702 * v)
            if form in ("resid", "resid_bf16_bias"):
                return res + v.to(bf)
            if form == "wide_out":
                return res.float() + v
            if form == "wide_res":
                return (res + v).to(bf)
            return v.to(bf)

        got = _cuda.gemm(a, wt, bias, **kw)
        want = plain()
        if form == "export":
            k_want, v_want = hold_export(name, kb, vb, want, tokens, n // 3)
            compare(f"{name} C", got, want, TOL_ENCODER)
            compare(f"{name} K", kb[1, :, : tokens - 1], k_want, TOL_ENCODER)
            compare(f"{name} V", vb[1, :, : tokens - 1], v_want, TOL_ENCODER)
        else:
            compare(name, got, want, TOL_ENCODER)
        b16 = bias.to(bf)
        out_bytes = (4 if form == "wide_out" else 2) * m * n
        extra = 0 if res is None else res.element_size() * m * n
        extra += 2 * 2 * kb[1].numel() if form == "export" else 0   # K and V slots, bf16
        gemm_line(name, time_ms(lambda: _cuda.gemm(a, wt, bias, **kw)), time_ms(plain, 3, 1),
                  time_ms(lambda: torch.addmm(b16, a, wt)), 2.0 * m * n * k,
                  2.0 * (m * k + k * n) + out_bytes + extra + 4 * n, PEAK_BF16_TC)

    for path in ("vit-b", "train"):
        m = GEMM_ROWS[path]
        bf16_case(f"gemm {path} qkv + export", m, 768, 2304, "export")
        bf16_case(f"gemm {path} out-proj", m, 768, 768, "resid")
        bf16_case(f"gemm {path} c_fc", m, 768, 3072, "gelu")
        bf16_case(f"gemm {path} c_proj", m, 3072, 768, "resid")
    m = GEMM_ROWS["vit-b"]
    bf16_case("gemm vit-b whole block out-proj (f32 out)", m, 768, 768, "wide_out")
    bf16_case("gemm vit-b whole block c_proj (f32 residual)", m, 3072, 768, "wide_res")
    for path in ("vit-l", "vit-l@336"):
        bf16_case(f"gemm {path} out-proj", GEMM_ROWS[path], 1024, 1024, "resid")
    m = GEMM_ROWS["boundary"]
    for w in (768, 1024):
        bf16_case(f"gemm boundary {w} out-proj", m, w, w, "resid_bf16_bias")
        bf16_case(f"gemm boundary {w} c_fc", m, w, 4 * w, "gelu_bf16_bias")
        bf16_case(f"gemm boundary {w} c_proj", m, 4 * w, w, "resid_bf16_bias")
        bf16_case(f"gemm boundary {w} query in-proj", m, w, 2 * w, "bf16_bias")

    # -- W8A8 -------------------------------------------------------------------
    def s8_case(name, m, k, n, form, tokens=197):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        a_s = torch.rand(m, generator=gen, device=dev) + 0.5
        ws = (torch.rand(n, generator=gen, device=dev) + 0.5).reshape(1, n)
        bias = randn(n, scale=0.1, dtype=torch.float32)
        res, kw = None, {}
        if form == "export":
            w = n // 3
            kb, vb, t_out = exported(m, w, tokens)
            kw = dict(export=(kb[1], vb[1], tokens, t_out, 1, w))
        elif form == "out_f32_res_bf16":
            res = randn(m, n)
            kw = dict(residual=res, out_dtype=torch.float32)
        elif form == "gelu_f32":
            kw = dict(gelu=True, out_dtype=torch.float32)
        elif form == "res_f32":
            res = randn(m, n, dtype=torch.float32)
            kw = dict(residual=res)
        elif form == "res_after_cast":
            res = randn(m, n)
            kw = dict(residual=res, residual_after_cast=True)

        def plain():
            v = w8a8_dot_plain(a, a_s[:, None], wq, ws) + bias
            if form == "gelu_f32":
                return v * torch.sigmoid(1.702 * v)
            if form == "out_f32_res_bf16":
                return res.float() + v
            if form == "res_f32":
                return (res + v).to(bf)
            if form == "res_after_cast":
                return (res.float() + v.to(bf).float()).to(bf)
            return v.to(bf)

        got = _cuda.gemm_s8(a, a_s, wq, ws, bias, **kw)
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        if form == "gelu_f32":
            compare(name, got, want, TOL_S8_GELU)
        else:
            equal = torch.equal(got, want)
            if form == "export":
                k_want, v_want = hold_export(name, kb, vb, want, tokens, n // 3)
                equal = equal and torch.equal(kb[1, :, : tokens - 1], k_want) \
                    and torch.equal(vb[1, :, : tokens - 1], v_want)
            print(f"  {name}: bit-equal {equal} (max_abs_err {err:.3e})", flush=True)
            if not equal:
                raise SystemExit(f"FAIL {name}: not bit-equal to w8a8_dot_plain + its epilogue")
        out_bytes = (4 if form in ("gelu_f32", "out_f32_res_bf16") else 2) * m * n
        extra = 0 if res is None else res.element_size() * m * n
        extra += 2 * 2 * kb[1].numel() if form == "export" else 0   # K and V slots, bf16
        wt = wq.t()
        gemm_line(name, time_ms(lambda: _cuda.gemm_s8(a, a_s, wq, ws, bias, **kw)),
                  time_ms(plain, 3, 1), time_ms(lambda: torch._int_mm(a, wt)), 2.0 * m * n * k,
                  1.0 * (m * k + k * n) + out_bytes + extra + 4.0 * (m + 2 * n), PEAK_INT8_TC)

    m = GEMM_ROWS["vit-b"]
    s8_case("gemm_s8 vit-b qkv + export", m, 768, 2304, "export")
    s8_case("gemm_s8 vit-b out-proj (f32 out, + h)", m, 768, 768, "out_f32_res_bf16")
    s8_case("gemm_s8 vit-b c_fc (QuickGELU, f32 out)", m, 768, 3072, "gelu_f32")
    s8_case("gemm_s8 vit-b c_proj (+ f32 hmid)", m, 3072, 768, "res_f32")
    for path, tokens in (("vit-l", 257), ("vit-l@336", 577)):
        m = GEMM_ROWS[path]
        s8_case(f"gemm_s8 {path} qkv + export", m, 1024, 3072, "export", tokens)
        s8_case(f"gemm_s8 {path} out-proj (f32 out, + h)", m, 1024, 1024, "out_f32_res_bf16")
        s8_case(f"gemm_s8 {path} c_fc (QuickGELU, f32 out)", m, 1024, 4096, "gelu_f32")
        s8_case(f"gemm_s8 {path} c_proj (+ f32 hmid)", m, 4096, 1024, "res_f32")
        s8_case(f"gemm_s8 {path} split c_proj (bf16 after the cast)", m, 4096, 1024,
                "res_after_cast")
        torch.cuda.empty_cache()

    # -- the int8 MLP's c_fc with its rows quantised on chip -----------------------
    for path, k in (("vit-b", 768), ("vit-l", 1024), ("vit-l@336", 1024)):
        m, n = GEMM_ROWS[path], 4 * k
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        a_s = torch.rand(m, generator=gen, device=dev) + 0.5
        ws = (torch.rand(n, generator=gen, device=dev) + 0.5).reshape(1, n)
        bias = randn(n, scale=0.1, dtype=torch.float32)
        name = f"gemm_s8_quant {path} c_fc ({m} x {k} -> {n})"

        def fused():
            return _cuda.gemm_s8_quant(a, a_s, wq, ws, bias)

        def c_fc_f32():
            return _cuda.gemm_s8(a, a_s, wq, ws, bias, gelu=True, out_dtype=torch.float32)

        q, s = fused()
        mid = c_fc_f32()
        q2, s2 = _cuda.quant_rows(mid)
        equal = torch.equal(q, q2) and torch.equal(s, s2)
        differ = (q != q2).float().mean().item()
        print(f"  {name}: bit-equal to gemm_s8 (f32, QuickGELU) + quant_rows {equal} (values "
              f"differing {differ:.3e}, scales equal {torch.equal(s, s2)})", flush=True)
        if not equal:
            raise SystemExit(f"FAIL {name}: not bit-equal to gemm_s8 (f32, QuickGELU) + "
                             f"quant_rows")
        del q2, s2
        compare_int8(f"{name} vs its plain version", q, s,
                     *w8a8_gelu_quant_plain(a, a_s[:, None], wq, ws, bias), TOL_FLIPS_GELU)
        del q, s
        fused_ms = time_ms(fused)
        c_fc_ms = time_ms(c_fc_f32)
        rows_ms = time_ms(lambda: _cuda.quant_rows(mid))
        del mid
        pair_ms = time_ms(lambda: _cuda.quant_rows(c_fc_f32()))
        plain_ms = time_ms(lambda: w8a8_gelu_quant_plain(a, a_s[:, None], wq, ws, bias), 3, 1)
        wt = wq.t()
        lib_ms = time_ms(lambda: torch._int_mm(a, wt))
        b, by = bound_ms(2.0 * m * n * k, 1.0 * (m * k + n * k + m * n) + 8.0 * (m + n),
                         PEAK_INT8_TC)
        print(f"  {name}: {fused_ms:.4f} ms; the pair {pair_ms:.4f} (gemm_s8 f32 QuickGELU "
              f"{c_fc_ms:.4f} + quant_rows {rows_ms:.4f}), fused / pair "
              f"{fused_ms / pair_ms:.3f}; plain {plain_ms:.4f}, library {lib_ms:.4f}, "
              f"ms / library {fused_ms / lib_ms:.3f}, bound {b:.4f} by {by}, bound / ms "
              f"{b / fused_ms:.3f}", flush=True)
        del a, wq, wt
        torch.cuda.empty_cache()


def check_layer_norm(rows: list, name: str, h2, ln: dict, paths: tuple) -> None:
    """layer_norm_rows on the bf16 or f32 rows h2 (R, W) against
    layers.layer_norm (rounded to bf16), with the F.layer_norm yardstick (in
    the rows' own type); the bound counts the rows read once and written
    once as bf16."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.models import layers
    from dfd_clip_tpu_torch.ops import _cuda

    m_rows, w = h2.shape
    dt = h2.dtype
    got = _cuda.layer_norm_rows(h2, ln["scale"], ln["bias"])
    err = compare(name, got, layers.layer_norm(ln, h2).to(torch.bfloat16), TOL_ENCODER)
    kernel_row(rows, name, "dfd_clip_tpu/ops/pallas_attention.py:360",
               "dfd_clip_tpu_torch/csrc/layer_norm.cu",
               time_ms(lambda: _cuda.layer_norm_rows(h2, ln["scale"], ln["bias"])),
               time_ms(lambda: layers.layer_norm(ln, h2)),
               time_ms(lambda: F.layer_norm(h2, (w,), ln["scale"].to(dt), ln["bias"].to(dt))),
               8.0 * m_rows * w, (h2.element_size() + 2.0) * m_rows * w + 8.0 * w, PEAK_F32, err,
               counter="layer_norm_rows", paths=paths)
    if dt == torch.bfloat16:   # the same rows as f32 input (the bf16 whole block's LN2 form)
        h32 = h2.float()
        ms = time_ms(lambda: _cuda.layer_norm_rows(h32, ln["scale"], ln["bias"]))
        b, _ = bound_ms(8.0 * m_rows * w, 6.0 * m_rows * w + 8.0 * w, PEAK_F32)
        print(f"  {name} (f32 in): {ms:.4f} ms (bound {b:.4f} by bytes; bound / ms "
              f"{b / ms:.3f})", flush=True)
        del h32


def check_decoder_attention(rows: list, name: str, gen, dev, hh: int, p: int, valid_p: int,
                            paths: tuple, forms: bool = False) -> None:
    """The serving decoder attention on slot 3 of a (6, CLIPS, FRAMES * p,
    hh, 64) bf16 K/V stack with pos (``p`` export rows a frame, the first
    ``valid_p`` of them real), all frames valid, then one sample partly and
    one fully masked. With ``forms`` also its partials form and its int8 K/V
    form (slot 3 quantised per row) on the same inputs, timed beside their
    bounds (no path runs them at this shape: no launches)."""
    import torch

    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda

    b, d, nsel, bf = CLIPS, 64, len(KEEP), torch.bfloat16
    l, w = FRAMES * p, hh * d
    kv_shape = (nsel, b, l, hh, d)
    kall = (0.5 * torch.randn(kv_shape, generator=gen)).to(dev, bf)
    vall = torch.randn(kv_shape, generator=gen).to(dev, bf)
    kall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, valid_p:] = 0
    vall.view(nsel, b, FRAMES, p, hh, d)[:, :, :, valid_p:] = 0
    pos = (0.04 * torch.randn(l, hh, d, generator=gen)).to(dev, bf)
    qrow = torch.randn(b, 2 * w, generator=gen).to(dev, bf)
    qs, qc = qrow[:, :w].reshape(b, 1, hh, d), qrow[:, w:].reshape(b, 1, hh, d)
    frames_ok = torch.ones(b, FRAMES, dtype=torch.bool, device=dev)
    mask = token_mask(frames_ok, p, valid_p)
    got = fda.fused_decoder_attention(qs, qc, kall, vall, mask, pos, layer=3)
    err = compare(name, got,
                  fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask, pos, layer=3),
                  TOL_DECODER)
    frames_ok[b - 2, FRAMES // 2:] = False
    frames_ok[b - 1] = False
    mask2 = token_mask(frames_ok, p, valid_p)
    got2 = fda.fused_decoder_attention(qs, qc, kall, vall, mask2, pos, layer=3)
    err = max(err, compare(f"{name} masked", got2,
                           fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask2, pos,
                                                             layer=3), TOL_DECODER))
    if got2[b - 1].abs().max().item() != 0:
        raise SystemExit(f"FAIL {name}: a fully masked sample is not 0")
    valid = mask.sum().item()
    kernel_row(rows, name, "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
               "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
               time_ms(lambda: fda.fused_decoder_attention(qs, qc, kall, vall, mask, pos,
                                                           layer=3)),
               time_ms(lambda: fda.fused_decoder_attention_plain(qs, qc, kall, vall, mask, pos,
                                                                 layer=3)),
               None, 16.0 * valid * w, 4.0 * valid * w + 2.0 * l * w + b * l + 6.0 * b * w,
               PEAK_F32, err, counter="fused_decoder_attention", paths=paths)
    if not forms:
        return
    from dfd_clip_tpu_torch.ops import int8

    args = (qs, qc, kall, vall, mask2, pos, 3)
    valid2 = mask2.sum().item()
    (o_sc, st), (o_p, st_p) = (fda.fused_decoder_attention(*args, partials=True),
                               fda.fused_decoder_attention_plain(*args, partials=True))
    err = compare(f"{name} partials numerator|coda", o_sc, o_p, TOL_DECODER)
    err = max(err, compare(f"{name} partials denominator", st[: b - 1, 0], st_p[: b - 1, 0],
                           TOL_DECODER))
    err = max(err, compare(f"{name} partials maximum", st[: b - 1, 1], st_p[: b - 1, 1],
                           TOL_DECODER))
    if o_sc[b - 1].abs().max().item() != 0 or st[b - 1, 0].abs().max().item() != 0 \
            or (st[b - 1, 1] != -1e30).any().item():
        raise SystemExit(f"FAIL {name} partials: a fully masked sample is not (0, 0, -1e30)")
    kernel_row(rows, f"{name} partials", "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
               "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
               time_ms(lambda: fda.fused_decoder_attention(*args, partials=True)),
               time_ms(lambda: fda.fused_decoder_attention_plain(*args, partials=True)),
               None, 16.0 * valid2 * w,
               4.0 * valid2 * w + 2.0 * l * w + b * l + 4.0 * b * w + 8.0 * b * w + 8.0 * b * hh,
               PEAK_F32, err, counter="fused_decoder_attention", paths=())
    del o_sc, st, o_p, st_p
    (kq, ks), (vq, vs) = (int8.quant_kv_rows_plain(t[3].reshape(1, b, l, w)) for t in (kall, vall))
    del kall, vall
    args = (qs, qc, kq.reshape(1, b, l, hh, d), vq.reshape(1, b, l, hh, d), mask2, pos, 0)
    scales = dict(k_scale=ks, v_scale=vs)
    got = fda.fused_decoder_attention(*args, **scales)
    err = compare(f"{name} int8", got, fda.fused_decoder_attention_plain(*args, **scales),
                  TOL_DECODER)
    if got[b - 1].abs().max().item() != 0:
        raise SystemExit(f"FAIL {name} int8: a fully masked sample is not 0")
    kernel_row(rows, f"{name} int8", "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
               "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
               time_ms(lambda: fda.fused_decoder_attention(*args, **scales)),
               time_ms(lambda: fda.fused_decoder_attention_plain(*args, **scales)),
               None, 16.0 * valid2 * w,
               2.0 * valid2 * w + 8.0 * valid2 + 2.0 * l * w + b * l + 6.0 * b * w,
               PEAK_F32, err, counter="fused_decoder_attention_int8", paths=())


def check_layer_norm_quant(rows: list, x, ln: dict, paths: tuple = ()) -> None:
    """layer_norm_quant on rows x (R, W), bf16 (LN1 on the residual stream,
    3 bytes a value) or f32 (LN2 on hmid, 5 bytes a value), against its
    plain route, timed beside its byte bound. One counter serves both forms
    and every shape, so only the first row of a path set carries its
    launches (``paths``); the others are measurements."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda, int8

    m_rows, w = x.shape
    form = "f32" if x.dtype == torch.float32 else "bf16"
    name = f"layer_norm_quant {form} {m_rows} x {w}"
    yq, ys = _cuda.layer_norm_quant(x, ln["scale"], ln["bias"])
    err = compare_int8(name, yq, ys, *int8.quant_rows_plain(int8.layer_norm_f32(ln, x)),
                       TOL_FLIPS_LN)
    del yq, ys
    kernel_row(rows, name, "dfd_clip_tpu/ops/pallas_attention.py:"
               + ("1008" if form == "bf16" else "1050"), "dfd_clip_tpu_torch/csrc/quant_rows.cu",
               time_ms(lambda: _cuda.layer_norm_quant(x, ln["scale"], ln["bias"])),
               time_ms(lambda: int8.quant_rows_plain(int8.layer_norm_f32(ln, x)), iters=3,
                       warmup=1),
               None, 12.0 * m_rows * w,
               (x.element_size() + 1.0) * m_rows * w + 4.0 * m_rows + 8.0 * w, PEAK_F32, err,
               counter="layer_norm_quant", paths=paths)


def device_rows(fn, calls: int) -> tuple:
    """The profiler's device rows (kernels, copies) over ``calls`` calls of
    fn, after one untraced call, every cycle's events kept: their summed
    time in ms, and their count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_cpu_time_total == 0 and device_us(e) > 0]
    return sum(device_us(e) for e in rows) / 1e3, sum(e.count for e in rows)


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call of fn: its device rows over ``calls`` calls,
    summed and divided."""
    return device_rows(fn, calls)[0] / calls


def launches_ms(fn, launches: int | None = None, calls: int = 10) -> tuple:
    """Device time of one call of fn that issues ``launches`` launches (by
    default the device rows of a trace of one call): the trace's sum over
    ``calls`` calls, divided, where the trace holds every launch, else None
    (not measured). Returns (ms or None, rows traced, launches issued)."""
    if launches is None:
        launches = device_rows(fn, 1)[1]
    total, count = device_rows(fn, calls)
    whole = count > 0 and count == calls * launches
    return (total / calls if whole else None), count, calls * launches


def check_decoder_boundary(rows: list, name: str, blk: dict, seed: int, paths: tuple) -> None:
    """decoder_boundary (one cooperative launch of csrc/decoder_boundary.cu)
    in its first, middle and last forms on CLIPS rows at the width of the
    encoder block ``blk`` (its LayerNorms and MLP), the query in-proj and
    out-proj drawn from ``seed``: one launch a call, each form held against
    its plain version at TOL_DECODER and, link by link, against the
    six-launch chain of gemm and layer_norm_rows it replaced, each link fed
    the kernel's own intermediates (at least CHAIN_EQUAL of the values
    bit-equal, the rest within one bf16 ulp of their row's largest
    magnitude, two after QuickGELU; the end-to-end share of bit-equal values
    printed); each form timed by CUDA events over 100 calls, by the
    profiler's device time and by the host's issue time, beside the chain
    (a yardstick the port never calls: no one PyTorch call computes the
    boundary) and the plain version, and one launch's stage clock printed."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_stack as ds
    from dfd_clip_tpu_torch.tools import bench_decoder_boundary as tbd

    b, w, bf = CLIPS, blk["ln_1"]["scale"].shape[0], torch.bfloat16
    dev = blk["ln_1"]["scale"].device
    dgen = torch.Generator().manual_seed(seed)
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
    err, times = 0.0, {}
    for form in tbd.FORMS:
        args = tbd.form_args(form, x, o, tail, query)
        before = _cuda.launches().get("decoder_boundary", 0)
        got = ds.decoder_boundary(*args)
        if _cuda.launches().get("decoder_boundary", 0) != before + 1:
            raise SystemExit(f"FAIL {name} {form}: not one launch a call")
        try:
            differ, total = tbd.hold_links(got, args)
        except AssertionError as e:
            raise SystemExit(f"FAIL {name} {form} against the six-launch chain: {e}")
        if differ > (1 - CHAIN_EQUAL) * total:
            raise SystemExit(f"FAIL {name} {form}: {differ} of {total} values differ from the "
                             f"six-launch chain's links")
        chain = tbd.six_launch_chain(*args)
        want = ds.decoder_boundary_plain(*args)
        same = sum(int((g == c).sum()) for g, c in zip(got, chain) if g is not None)
        count = sum(g.numel() for g in got if g is not None)
        for g_, w_, part in zip(got, want, ("x", "qrow")):
            if w_ is not None:
                err = max(err, compare(f"{name} {form} {part}", g_, w_, TOL_DECODER))
        print(f"  {name} {form}: links {total - differ} of {total} values bit-equal to the "
              f"chain's; end to end {same} of {count} ({same / count:.4f})", flush=True)
        for label, fn in (("kernel", ds.decoder_boundary), ("chain", tbd.six_launch_chain),
                          ("plain", ds.decoder_boundary_plain)):
            times[form, label] = time_ms(lambda: fn(*args), iters=100)
            print(f"    {label}: {times[form, label]:.4f} ms (device "
                  f"{device_ms(lambda: fn(*args)):.4f} ms, host {tbd.host_ms(fn, *args):.4f} ms "
                  f"a call)", flush=True)
        print("    stage clock (us): " + ", ".join(f"{k} {v:.2f}"
                                                   for k, v in tbd.stage_clock(args).items()),
              flush=True)
    kernel_row(rows, name, "dfd_clip_tpu/ops/pallas_decoder_stack.py:170",
               "dfd_clip_tpu_torch/csrc/decoder_boundary.cu", times["middle", "kernel"],
               times["middle", "plain"], None, 2.0 * b * 11 * w * w,
               22.0 * w * w + 4.0 * 12 * w + 2.0 * 5 * b * w, PEAK_BF16_TC, err,
               counter="decoder_boundary", paths=paths)


def check_train_attention(row, gen, dev) -> None:
    """The training forward (partials) and the backward of the decoder
    attention at the flagship train shapes: slot 3 of a (6, 12, 4000, 12,
    64) bf16 stack with pos, one sample partly and one fully masked; the
    backward also at 16 heads over 5,120 and 11,520 keys."""
    import torch

    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda

    b, hh, d = TRAIN_CLIPS, 12, 64
    bargs = decoder_bwd_inputs(gen, dev, b, 200, 196, hh)
    args, mask = bargs[:7], bargs[4]
    l, w = mask.shape[1], hh * d
    valid = mask.sum().item()

    (o_sc, st), (o_p, st_p) = (fda.fused_decoder_attention(*args, partials=True),
                               fda.fused_decoder_attention_plain(*args, partials=True))
    err = compare("partials numerator|coda", o_sc, o_p, TOL_DECODER)
    err = max(err, compare("partials denominator", st[: b - 1, 0], st_p[: b - 1, 0], TOL_DECODER))
    err = max(err, compare("partials maximum", st[: b - 1, 1], st_p[: b - 1, 1], TOL_DECODER))
    if o_sc[b - 1].abs().max().item() != 0 or st[b - 1, 0].abs().max().item() != 0 \
            or (st[b - 1, 1] != -1e30).any().item():
        raise SystemExit("FAIL partials: a fully masked sample is not (0, 0, -1e30)")
    row("fused_decoder_attention partials", "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
        "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
        time_ms(lambda: fda.fused_decoder_attention(*args, partials=True)),
        time_ms(lambda: fda.fused_decoder_attention_plain(*args, partials=True)),
        None, 16.0 * valid * w,
        4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 8.0 * b * w + 8.0 * b * hh,
        PEAK_F32, err, counter="fused_decoder_attention", paths=("train",))

    del o_sc, st, o_p, st_p
    check_decoder_bwd(row, "fused_decoder_attention_bwd", bargs, ("train",))
    del bargs, args
    # the forward's wide rows: 16 heads over the 257-token towers' 5,120 and
    # ViT-L@336's 11,520 keys, at the train batch (no path trains there: no
    # launches)
    for p_, name in ((256, "fused_decoder_attention_bwd 16 heads, L 5120"),
                     (576, "fused_decoder_attention_bwd 16 heads, L 11520")):
        bargs = decoder_bwd_inputs(gen, dev, b, p_, p_, 16)
        check_decoder_bwd(row, name, bargs, ())
        del bargs
        torch.cuda.empty_cache()


def decoder_bwd_inputs(gen, dev, b: int, p: int, valid_p: int, hh: int) -> tuple:
    """The backward's arguments on slot 3 of a (6, b, FRAMES * p, hh, 64)
    bf16 stack with pos (``p`` export rows a frame, the first ``valid_p`` of
    them real), sample b - 2 half and b - 1 fully masked, its stats from
    the plain partials and a random cotangent."""
    import torch

    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda

    d, bf = 64, torch.bfloat16
    l, w = FRAMES * p, hh * d
    kv_shape = (len(KEEP), b, l, hh, d)
    kall = (0.5 * torch.randn(kv_shape, generator=gen)).to(dev, bf)
    vall = torch.randn(kv_shape, generator=gen).to(dev, bf)
    kall.view(-1, b, FRAMES, p, hh, d)[:, :, :, valid_p:] = 0
    vall.view(-1, b, FRAMES, p, hh, d)[:, :, :, valid_p:] = 0
    pos = (0.04 * torch.randn(l, hh, d, generator=gen)).to(dev, bf)
    qrow = torch.randn(b, 2 * w, generator=gen).to(dev, bf)
    qs, qc = qrow[:, :w].reshape(b, 1, hh, d), qrow[:, w:].reshape(b, 1, hh, d)
    frames_ok = torch.ones(b, FRAMES, dtype=torch.bool, device=dev)
    frames_ok[b - 2, FRAMES // 2:] = False
    frames_ok[b - 1] = False
    mask = token_mask(frames_ok, p, valid_p)
    args = (qs, qc, kall, vall, mask, pos, 3)
    o_sc, st = fda.fused_decoder_attention_plain(*args, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, hh, d) / denom.clamp_min(1e-30)[..., None]
    ct = (0.1 * torch.randn(b, 1, hh, d, generator=gen)).to(dev, bf)
    return args + (denom, mx, o_s, ct)


def check_decoder_bwd(row, name: str, bargs: tuple, paths: tuple) -> None:
    """fused_decoder_attention_bwd (one launch of csrc/decoder_attention_bwd.cu)
    on ``bargs`` (decoder_bwd_inputs' form): dq_smax, dq_coda and dpos held
    against the plain version at TOL_DECODER, the fully masked last sample's
    dq exactly 0, two calls bit-equal, one launch a call (the CUDA runtime's
    launch calls in the profiler's trace, its device rows printed beside),
    its time by CUDA events, by the profiler's device time and by the host's
    issue of a call, beside its bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import fused_decoder_attention_bwd as fdb

    qs, mask = bargs[0], bargs[4]
    b, _, hh, d = qs.shape
    l, w = mask.shape[1], hh * d
    valid = mask.sum().item()
    got = fdb.fused_decoder_attention_bwd(*bargs)
    again = fdb.fused_decoder_attention_bwd(*bargs)
    want = fdb.fused_decoder_attention_bwd_plain(*bargs)
    err = 0.0
    for g_, w_, part in zip(got, want, ("dq_smax", "dq_coda", "dpos")):
        err = max(err, compare(f"{name} {part}", g_, w_, TOL_DECODER))
    if got[0][b - 1].abs().max().item() != 0 or got[1][b - 1].abs().max().item() != 0:
        raise SystemExit(f"FAIL {name}: a fully masked sample's dq is not 0")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise SystemExit(f"FAIL {name}: two calls differ")
    del got, again, want
    # launches a call: the CUDA runtime's launch calls over CALLS calls in
    # the profiler's host trace (every kernel, memset or copy the call
    # issues, its own or torch's); the device rows, which the profiler has
    # dropped at times on the longest of these calls, are printed beside
    calls = 3
    for _ in range(3):   # a trace with no launch call at all is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fdb.fused_decoder_attention_bwd(*bargs)
            torch.cuda.synchronize()
        events = prof.key_averages()
        issued = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")
                     or e.key.startswith("cudaMemsetAsync")
                     or e.key.startswith("cudaMemcpyAsync"))
        if issued:
            break
    rows = [e for e in events if e.self_cpu_time_total == 0 and device_us(e) > 0]
    geo = _cuda.bwd_geometry(b, l, hh, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"  {name}: {issued} launches in {calls} calls (device rows: "
          f"{', '.join(f'{e.count}x {e.key[:40]}' for e in rows) or 'none'}); tiles "
          f"{geo['tiles']}, chunks of {geo['chunk_tiles']} tiles, {geo['items']} items on "
          f"{geo['grid']} blocks, {geo['passes']} pass(es) of {geo['group']} samples, "
          f"{geo['smem']} B shared memory", flush=True)
    if issued != calls:
        fail(f"FAIL {name}: {issued} launches in {calls} calls, not one a call", True)
    ms = time_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs), iters=50)
    dev_ms = device_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fdb.fused_decoder_attention_bwd(*bargs)
    host = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    print(f"  {name}: {ms:.4f} ms by events, device {dev_ms:.4f} ms, host {host:.4f} ms a "
          f"call", flush=True)
    # bytes: valid K/V rows, pos, mask, queries, ct, o_s, stats; dq and dpos out
    row(name, "dfd_clip_tpu/ops/pallas_decoder_attention.py:477",
        "dfd_clip_tpu_torch/csrc/decoder_attention_bwd.cu", ms,
        time_ms(lambda: fdb.fused_decoder_attention_bwd_plain(*bargs), iters=3, warmup=1),
        None, 27.0 * valid * w,
        4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 2.0 * b * w + 4.0 * b * w
        + 8.0 * b * hh + 8.0 * b * w + 4.0 * l * w, PEAK_F32, err,
        counter="fused_decoder_attention_bwd", paths=paths)


def to_device(tree, dev):
    """Params to the card: matrix weights ("w") in bf16, int8 weights as
    they are, the rest f32."""
    import torch

    if isinstance(tree, dict):
        return {k: (v.to(dev, torch.bfloat16) if k == "w" else to_device(v, dev))
                for k, v in tree.items()}
    return tree.to(dev) if tree.dtype == torch.int8 else tree.to(dev, torch.float32)


def to_card(tree):
    """A tree of dicts and lists of tensors moved to the card as they are
    (raw f32 params, which Detector.prepare_params then places and
    quantises there)."""
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v) for v in tree]
    return tree.to("cuda")


def random_block(gen, dev, int8: bool = False, cfg=None):
    """One encoder block's seeded random params on the card (the flagship
    ViT-B/16's unless ``cfg``), with LayerNorms and biases moved off their
    init values; with ``int8`` also the pre-quantised weights
    (clip_vit.prepare_int8_params, from f32)."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit

    cfg = cfg or clip_vit.VIT_B16
    w = cfg.width
    params = clip_vit.init_clip_vision(gen, dataclasses.replace(cfg, layers=1))
    blk = params["blocks"][0]
    for ln in (blk["ln_1"], blk["ln_2"]):
        ln["scale"].add_(0.1 * torch.randn(w, generator=gen))
        ln["bias"].add_(0.1 * torch.randn(w, generator=gen))
    for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                blk["mlp"]["c_proj"]):
        lin["b"].add_(0.02 * torch.randn(lin["b"].shape, generator=gen))
    if int8:
        blk = clip_vit.prepare_int8_params(params)["blocks"][0]
    return to_device(blk, dev)


def compare_int8(name: str, q, s, q_p, s_p, share: float, step: float = 1 / 127) -> float:
    """int8 values and their (R,) scales against the plain version's: values
    within 1 on at most ``share`` of the elements, scales within TOL_SCALE
    relative. Returns the max abs error of the dequantised values q * s *
    step (step 1/127 for _quant_rows' absmax scales, 1 for the K/V form's)."""
    import torch

    s_p = s_p.reshape(-1)
    diff = (q.to(torch.int32) - q_p.to(torch.int32)).abs()
    flips = (diff > 0).float().mean().item()
    srel = ((s - s_p).abs() / s_p.abs().clamp_min(1e-30)).max().item()
    err = step * (q.float() * s[:, None] - q_p.float() * s_p[:, None]).abs().max().item()
    print(f"  {name}: int8 max |diff| {diff.max().item()}, share differing {flips:.3e} "
          f"(tol {share:g}), scale rel {srel:.3e} (tol {TOL_SCALE:g}), dequant max_abs_err "
          f"{err:.3e}", flush=True)
    if diff.max().item() > 1 or flips > share or srel > TOL_SCALE:
        raise SystemExit(f"FAIL {name}: int8 values or scales disagree with the plain version")
    return err


def check_int8_kernels(rows: list) -> None:
    """The int8 serving kernels vs their plain versions at the flagship
    shapes (320 frames x 197 tokens = 63040 rows, width 768, hidden 3072)."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops import _cuda, int8
    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import fused_decoder_attention as fda
    from dfd_clip_tpu_torch.ops.attention import plain_attention_qkv

    cfg = clip_vit.VIT_B16
    n, t, w, hh, d = CLIPS * FRAMES, cfg.num_tokens, cfg.width, cfg.heads, cfg.head_dim
    m_rows, t_out, nsel, bf = n * t, 200, len(KEEP), torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    blk = random_block(gen, dev, int8=True)
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)
    h2 = h.reshape(m_rows, w)
    ln1, attn, mlp = blk["ln_1"], blk["attn"], blk["mlp"]
    int8_paths = ("int8_serve", "int8_rows") + INT8_VARIANTS
    row = functools.partial(kernel_row, rows, paths=int8_paths)

    # -- layer_norm_quant (LN1 on the bf16 residual stream) ----------------------
    yq, ys = _cuda.layer_norm_quant(h2, ln1["scale"], ln1["bias"])
    err = compare_int8("layer_norm_quant", yq, ys,
                       *int8.quant_rows_plain(int8.layer_norm_f32(ln1, h2)), TOL_FLIPS_LN)
    row("layer_norm_quant", "dfd_clip_tpu/ops/pallas_attention.py:1008",
        "dfd_clip_tpu_torch/csrc/quant_rows.cu",
        time_ms(lambda: _cuda.layer_norm_quant(h2, ln1["scale"], ln1["bias"])),
        time_ms(lambda: int8.quant_rows_plain(int8.layer_norm_f32(ln1, h2))),
        None, 12.0 * m_rows * w, 3.0 * m_rows * w + 4.0 * m_rows + 8.0 * w, PEAK_F32, err)
    # the LN2 form on the f32 hmid rows (its launches are on the row above)
    check_layer_norm_quant(rows, torch.randn(m_rows, w, device=dev, generator=torch.Generator(
        device=dev).manual_seed(13)), blk["ln_2"])

    # -- gemm_s8 at the qkv shape (768 -> 2304, bf16 out) -------------------------
    wq, ws, bq = attn["in_proj"]["wq"], attn["in_proj"]["ws"], attn["in_proj"]["b"]
    xf = _cuda.gemm_s8(yq, ys, wq, ws, bq)
    err = compare("gemm_s8 qkv", xf,
                  (int8.w8a8_dot_plain(yq, ys[:, None], wq, ws) + bq).to(bf), TOL_ENCODER)
    n3 = 3 * w
    row("gemm_s8", "dfd_clip_tpu/ops/pallas_attention.py:173",
        "dfd_clip_tpu_torch/csrc/gemm_s8.cu",
        time_ms(lambda: _cuda.gemm_s8(yq, ys, wq, ws, bq)),
        time_ms(lambda: (int8.w8a8_dot_plain(yq, ys[:, None], wq, ws) + bq).to(bf)),
        time_ms(lambda: torch._int_mm(yq, wq.t())),
        2.0 * m_rows * n3 * w, m_rows * w + n3 * w + 4.0 * m_rows + 8.0 * n3 + 2.0 * m_rows * n3,
        PEAK_INT8_TC, err)

    # -- quant_rows, the K/V export form (bf16 K columns, CLS dropped, 4 pad rows)
    kq = torch.full((nsel, n, t_out, w), 7, dtype=torch.int8, device=dev)
    k_s = torch.full((n, t_out), 7.0, device=dev)
    _cuda.quant_rows(xf[:, w: 2 * w], kv=True, export=(kq[2], k_s, t, t_out, 1))
    q_p, s_p = int8.quant_kv_rows_plain(xf[:, w: 2 * w].reshape(n, t, w)[:, 1:])
    compare_int8("quant_rows kv export", kq[2, :, : t - 1].reshape(-1, w),
                 k_s[:, : t - 1].reshape(-1), q_p.reshape(-1, w), s_p, TOL_FLIPS_QUANT, step=1.0)
    if kq[2, :, t - 1:].abs().max().item() != 0 or k_s[:, t - 1:].abs().max().item() != 0 \
            or (kq[1] != 7).any().item():
        raise SystemExit("FAIL quant_rows kv export: pad rows or other slots wrong")
    del kq, k_s, q_p, s_p

    # -- encoder_attention with the f32 output -----------------------------------
    att = eb.encoder_attention(xf, n, t, hh, d, out_dtype=torch.float32)
    err = compare("encoder_attention f32", att,
                  plain_attention_qkv(xf.reshape(n, t, n3), hh, d,
                                      out_dtype=torch.float32).reshape(m_rows, w), TOL_ENCODER)
    q4, k4, v4 = (s.reshape(n, t, hh, d).transpose(1, 2) for s in xf.split(w, dim=-1))
    row("encoder_attention f32", "dfd_clip_tpu/ops/pallas_attention.py:1022",
        "dfd_clip_tpu_torch/csrc/encoder_attention.cu",
        time_ms(lambda: eb.encoder_attention(xf, n, t, hh, d, out_dtype=torch.float32)),
        time_ms(lambda: plain_attention_qkv(xf.reshape(n, t, n3), hh, d,
                                            out_dtype=torch.float32)),
        time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        4.0 * n * hh * t * t * d, 2.0 * m_rows * n3 + 4.0 * m_rows * w, PEAK_BF16_TC, err,
        counter="encoder_attention", paths=("int8_serve", "int8_rows"))
    del att, q4, k4, v4, xf, yq, ys

    # -- quant_rows on the f32 attention output (768 wide; the K/V form is above) --
    att = torch.randn(m_rows, w, generator=gen).to(dev)
    aq, a_s = _cuda.quant_rows(att)
    err = compare_int8("quant_rows", aq, a_s, *int8.quant_rows_plain(att), TOL_FLIPS_QUANT)
    row("quant_rows", "dfd_clip_tpu/ops/pallas_attention.py:158",
        "dfd_clip_tpu_torch/csrc/quant_rows.cu", time_ms(lambda: _cuda.quant_rows(att)),
        time_ms(lambda: int8.quant_rows_plain(att)), None, 4.0 * m_rows * w,
        5.0 * m_rows * w + 4.0 * m_rows, PEAK_F32, err)
    del att, aq, a_s

    # -- gemm_s8_quant: c_fc (768 -> 3072) with QuickGELU, its rows quantised -------
    y2q, y2s = _cuda.layer_norm_quant(h2, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    fc = mlp["c_fc"]
    k4w = 4 * w
    mq, ms = _cuda.gemm_s8_quant(y2q, y2s, fc["wq"], fc["ws"], fc["b"])
    err = compare_int8("gemm_s8_quant c_fc", mq, ms,
                       *int8.w8a8_gelu_quant_plain(y2q, y2s[:, None], fc["wq"], fc["ws"],
                                                   fc["b"]), TOL_FLIPS_GELU)
    row("gemm_s8_quant", "dfd_clip_tpu/ops/pallas_attention.py:1062",
        "dfd_clip_tpu_torch/csrc/gemm_s8_quant.cu",
        time_ms(lambda: _cuda.gemm_s8_quant(y2q, y2s, fc["wq"], fc["ws"], fc["b"])),
        time_ms(lambda: int8.w8a8_gelu_quant_plain(y2q, y2s[:, None], fc["wq"], fc["ws"],
                                                   fc["b"])),
        time_ms(lambda: torch._int_mm(y2q, fc["wq"].t())), 2.0 * m_rows * k4w * w,
        m_rows * w + k4w * w + 1.0 * m_rows * k4w + 8.0 * (m_rows + k4w), PEAK_INT8_TC, err)
    del y2q, y2s
    wp, wps, bp = mlp["c_proj"]["wq"], mlp["c_proj"]["ws"], mlp["c_proj"]["b"]
    hmid = torch.randn(m_rows, w, generator=gen).to(dev)

    def c_proj_plain():
        return (hmid + (int8.w8a8_dot_plain(mq, ms[:, None], wp, wps) + bp)).to(bf)

    err = compare("gemm_s8 c_proj", _cuda.gemm_s8(mq, ms, wp, wps, bp, residual=hmid),
                  c_proj_plain(), TOL_ENCODER)
    row("gemm_s8 c_proj", "dfd_clip_tpu/ops/pallas_attention.py:1063",
        "dfd_clip_tpu_torch/csrc/gemm_s8.cu",
        time_ms(lambda: _cuda.gemm_s8(mq, ms, wp, wps, bp, residual=hmid)),
        time_ms(c_proj_plain), time_ms(lambda: torch._int_mm(mq, wp.t())),
        2.0 * m_rows * w * k4w,
        m_rows * k4w + w * k4w + 4.0 * m_rows + 8.0 * w + 4.0 * m_rows * w + 2.0 * m_rows * w,
        PEAK_INT8_TC, err, counter="gemm_s8")
    del mq, ms, hmid

    # -- fused_encoder_block: stacked bf16 export (compute_int8) and int8_rows ------
    block_ops = 2.0 * m_rows * w * w * 12 / PEAK_INT8_TC + 4.0 * n * hh * t * t * d / PEAK_BF16_TC
    block_bytes = (4.0 * m_rows * w + 12.0 * w * w + 4.0 * 2 * 9 * w + 16.0 * w
                   + 4.0 * n * t_out * w)
    err = 0.0
    for rows8 in (False, True):
        kv_dt = torch.int8 if rows8 else bf
        bufs = [(torch.empty(nsel, n, t_out, w, dtype=kv_dt, device=dev),
                 torch.empty(nsel, n, t_out, w, dtype=kv_dt, device=dev)) for _ in range(2)]
        outs = [fn(h, ln1, attn, blk["ln_2"], mlp, hh, d, export=True, drop_cls=True,
                   export_into=(kb, vb, 2, nsel), kv_rows8=rows8, kv_pad=4)
                for fn, (kb, vb) in zip((eb.fused_encoder_block, eb.fused_encoder_block_plain),
                                        bufs)]
        form = "int8_rows" if rows8 else "bf16 export"
        err = max(err, compare(f"fused_encoder_block {form} h", outs[0][0], outs[1][0],
                               TOL_ENCODER))
        for i, part in ((1, "k"), (2, "v")):
            got, want = outs[0][i][2], outs[1][i][2]
            if rows8:
                got = got.float() * outs[0][i + 2]
                want = want.float() * outs[1][i + 2]
            err = max(err, compare(f"fused_encoder_block {form} {part}", got, want, TOL_ENCODER))
            if outs[0][i][2, :, 196:].abs().max().item() != 0:
                raise SystemExit(f"FAIL fused_encoder_block {form}: pad rows are not zero")
        if rows8:
            for i in (3, 4):
                if outs[0][i][:, 196:].abs().max().item() != 0:
                    raise SystemExit("FAIL fused_encoder_block int8_rows: pad scales are not 0")
            rows8_ms = time_ms(lambda: eb.fused_encoder_block(
                h, ln1, attn, blk["ln_2"], mlp, hh, d, export=True, drop_cls=True,
                export_into=(*bufs[0], 2, nsel), kv_rows8=True, kv_pad=4), iters=10)
            print(f"  fused_encoder_block int8_rows export: {rows8_ms:.4f} ms", flush=True)
        else:
            main_bufs = bufs[0]
            block_plain = time_ms(lambda: eb.fused_encoder_block_plain(
                h, ln1, attn, blk["ln_2"], mlp, hh, d, export=True, drop_cls=True,
                export_into=(*bufs[1], 2, nsel), kv_pad=4), iters=3, warmup=1)
        del outs
    block_ms = time_ms(lambda: eb.fused_encoder_block(
        h, ln1, attn, blk["ln_2"], mlp, hh, d, export=True, drop_cls=True,
        export_into=(*main_bufs, 2, nsel), kv_pad=4), iters=10)
    row("fused_encoder_block", "dfd_clip_tpu/ops/pallas_attention.py:1212",
        "dfd_clip_tpu_torch/ops/encoder_block.py", block_ms, block_plain, None, 0, 0, 0, err,
        bound=(max(block_ops, block_bytes / HBM) * 1e3,
               "operations" if block_ops >= block_bytes / HBM else "bytes"))
    del bufs, main_bufs

    # -- the int8 last_only layer: bf16 export (compute_int8) and int8_rows ------------
    err = 0.0
    for rows8 in (False, True):
        kv_dt = torch.int8 if rows8 else bf
        outs = []
        for fn in (eb.fused_encoder_attn_block, eb.fused_encoder_attn_block_plain):
            kb = torch.zeros(nsel, n, t_out, w, dtype=kv_dt, device=dev)
            outs.append(fn(h, ln1, attn, hh, d, drop_cls=True, last_only=True, int8_gemm=True,
                           kv_rows8=rows8, export_into=(kb, torch.zeros_like(kb), 5, nsel),
                           kv_pad=4))
        form = "int8_rows" if rows8 else "bf16 export"
        for i, part in ((0, "k"), (1, "v")):
            got, want = outs[0][i][5], outs[1][i][5]
            if rows8:
                got, want = got.float() * outs[0][i + 2], want.float() * outs[1][i + 2]
            err = max(err, compare(f"int8 last_only {form} {part}", got, want, TOL_ENCODER))
        if rows8:
            last_rows8_ms = time_ms(lambda: eb.fused_encoder_attn_block(
                h, ln1, attn, hh, d, drop_cls=True, last_only=True, int8_gemm=True,
                kv_rows8=True, export_into=(outs[0][0], outs[0][1], 5, nsel), kv_pad=4))
            print(f"  int8 last_only int8_rows export: {last_rows8_ms:.4f} ms", flush=True)
        else:
            kl = (outs[0][0], outs[0][1])
            last_plain = time_ms(lambda: eb.fused_encoder_attn_block_plain(
                h, ln1, attn, hh, d, drop_cls=True, last_only=True, int8_gemm=True,
                export_into=(*kl, 5, nsel), kv_pad=4), iters=3, warmup=1)
        del outs
    row("fused_encoder_attn_block int8 last_only", "dfd_clip_tpu/ops/pallas_attention.py:532",
        "dfd_clip_tpu_torch/ops/encoder_block.py",
        time_ms(lambda: eb.fused_encoder_attn_block(
            h, ln1, attn, hh, d, drop_cls=True, last_only=True, int8_gemm=True,
            export_into=(*kl, 5, nsel), kv_pad=4)),
        last_plain, None, 2.0 * m_rows * w * 2 * w,
        2.0 * m_rows * w + 2.0 * w * w + 4.0 * 2 * 2 * w + 8.0 * w + 4.0 * n * t_out * w,
        PEAK_INT8_TC, err, counter="fused_encoder_attn_block", paths=int8_paths)
    del kl, h, h2

    # -- fused_decoder_attention on int8 K/V (slot 3 of a (6, 16, 4000, 12, 64) stack)
    b, p = CLIPS, t_out
    l = FRAMES * p
    kv_shape = (nsel, b, l, hh, d)
    stacks = []
    for scale in (0.5, 1.0):
        x = (scale * torch.randn(kv_shape, generator=gen)).to(dev, bf)
        x.view(nsel, b, FRAMES, p, hh, d)[:, :, :, 196:] = 0
        q, s = int8.quant_kv_rows_plain(x.reshape(nsel, b, l, w))
        s.view(nsel, b, FRAMES, p)[:, :, :, 196:] = 0
        stacks.append((q.reshape(kv_shape), s))
        del x
    (kall, ks), (vall, vs) = stacks
    pos = (0.04 * torch.randn(l, hh, d, generator=gen)).to(dev, bf)
    qrow = torch.randn(b, 2 * w, generator=gen).to(dev, bf)
    qs, qc = qrow[:, :w].reshape(b, 1, hh, d), qrow[:, w:].reshape(b, 1, hh, d)
    frames_ok = torch.ones(b, FRAMES, dtype=torch.bool, device=dev)
    frames_ok[b - 2, FRAMES // 2:] = False
    frames_ok[b - 1] = False
    mask = token_mask(frames_ok, p, 196)
    args = (qs, qc, kall, vall, mask, pos, 3)
    scales = dict(k_scale=ks, v_scale=vs)
    got = fda.fused_decoder_attention(*args, **scales)
    err = compare("fused_decoder_attention int8", got,
                  fda.fused_decoder_attention_plain(*args, **scales), TOL_DECODER)
    if got[b - 1].abs().max().item() != 0:
        raise SystemExit("FAIL fused_decoder_attention int8: a fully masked sample is not 0")
    valid = mask.sum().item()
    row("fused_decoder_attention int8", "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
        "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
        time_ms(lambda: fda.fused_decoder_attention(*args, **scales)),
        time_ms(lambda: fda.fused_decoder_attention_plain(*args, **scales)),
        None, 16.0 * valid * w,
        2.0 * valid * w + 8.0 * valid + 2.0 * l * w + b * l + 6.0 * b * w,
        PEAK_F32, err, counter="fused_decoder_attention_int8", paths=("int8_rows",))


def detector(kernels=None, **extra):
    """A Detector on the card, bf16, 20 frames, out_dim [2]: the flagship
    (bench.py:_detector_cfg) with ``extra``'s keys overridden and the
    encoder's kernel paths ``kernels`` (EncoderKernels arguments)."""
    import torch

    from dfd_clip_tpu_torch.models.detector import Detector, EncoderKernels

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": list(KEEP),
                              "out_dim": [2], "losses": ["auc_roc"],
                              "op_mode": {"temporal_position": 1}, **extra})
    return Detector(cfg, num_frames=FRAMES, compute_dtype=torch.bfloat16, device="cuda",
                    encoder_kernels=EncoderKernels(**(kernels or {})))


def check_counts(path: str, counts: dict, expected: dict, runs: int,
                 used=("gemm", "layer_norm_rows", "encoder_attention")) -> None:
    print("  kernels " + json.dumps(counts), flush=True)
    for name, per_run in expected.items():
        if counts.get(name, 0) != per_run * runs:
            raise SystemExit(f"FAIL {path} path: {name} launched {counts.get(name, 0)} times, "
                             f"expected {per_run * runs}")
    for name in used:
        if counts.get(name, 0) <= 0:
            raise SystemExit(f"FAIL {path} path: {name} never launched")


def make_requests():
    """Four requests of 40-80 synthetic decoded 224x224 frames (seeded)."""
    import numpy as np

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1, 224, 224, 3), np.uint8)
    return [np.clip(base.astype(np.int16) + rng.integers(-40, 41, (nf, 224, 224, 3)),
                    0, 255).astype(np.uint8) for nf in (40, 60, 80, 80)]


def last_batch(requests, index: int = -1):
    """One batch from a request (the last by default): its clips padded to
    CLIPS with copies of its last clip, the last row's second half masked."""
    import numpy as np

    clips = requests[index].transpose(0, 3, 1, 2).reshape(-1, FRAMES, 3, 224, 224)
    x = np.concatenate([clips, np.repeat(clips[-1:], CLIPS - len(clips), 0)])
    m = np.ones((CLIPS, FRAMES), bool)
    m[-1, FRAMES // 2:] = False
    return x, m


def answer(scorer, requests, card: str, label: str) -> dict:
    """The Scorer answers the requests with every launch counter zeroed
    just before and read just after. Returns the counts."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda

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
            raise SystemExit(f"FAIL {label} request {i}: P(fake) {s} outside [0, 1]")
    steady = times[1:]
    print(f"  predict batch {CLIPS} clips x {FRAMES} frames: "
          f"{CLIPS * len(steady) / sum(steady):.2f} clips/s (padded batch clips), "
          f"{sum(len(f) // FRAMES for f in requests[1:]) / sum(steady):.2f} real clips/s, "
          f"peak memory {peak_gb:.3f} GB, on {card}", flush=True)
    return counts


def p_delta(a, b) -> float:
    """max |P(fake)| difference of two logit batches."""
    return (a.float().softmax(-1)[:, 1] - b.float().softmax(-1)[:, 1]).abs().max().item()


def hold_against_plain(label: str, predict, x, m, defer: bool = False):
    """One batch's logits through the kernels vs the plain versions: within
    TOL_ENCODER of the max and |dP(fake)| <= TOL_PFAKE (``defer``: see
    compare). Returns the kernels' logits."""
    got = predict(x, m)
    with plain_versions():
        want = predict(x, m)
    compare(f"{label} logits", got, want, TOL_ENCODER, defer)
    dp = p_delta(got, want)
    print(f"  {label} |dP(fake)| max {dp:.3e} (tol {TOL_PFAKE:g})", flush=True)
    if dp > TOL_PFAKE:
        fail(f"FAIL {label}: |dP(fake)| {dp:.3e} > {TOL_PFAKE:g}", defer)
    return got


ROUTES = ("kernels", "bf16 plain", "f32 plain")
PAIRS = ((0, 1), (0, 2), (1, 2))   # the routes compared on each batch


def rel_err(got, want) -> float:
    """max|got - want| / max|want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def hold_wide(label: str, predict, predict_f32, x, m) -> tuple:
    """One batch of a 257-token path through three routes: the kernels, the
    plain versions in bf16, and the plain versions in f32 (``predict_f32``,
    the same Detector computing in f32: the exact route). ``predict``
    returns (logits, video features). Returns (the kernels' logits, a
    reading per pair of PAIRS: (logits rel_err, video-feature rel_err,
    per-clip max |dP(fake)|)); wide_serve holds them."""
    import torch

    outs = [predict(x, m)]
    with plain_versions():
        outs += [predict(x, m), predict_f32(x, m)]
    for logits, video in outs:
        if logits.shape != outs[0][0].shape or not (torch.isfinite(logits).all()
                                                    and torch.isfinite(video).all()):
            raise SystemExit(f"FAIL {label}: logits of shape {tuple(logits.shape)} or not finite")
    reading = tuple((rel_err(outs[i][0], outs[j][0]), rel_err(outs[i][1], outs[j][1]),
                     p_delta(outs[i][0], outs[j][0])) for i, j in PAIRS)
    print(f"  {label}: " + "; ".join(
        f"{ROUTES[i]} vs {ROUTES[j]}: logits {r[0]:.3e}, video {r[1]:.3e}, dP {r[2]:.3e}"
        for (i, j), r in zip(PAIRS, reading)), flush=True)
    return outs[0][0], reading


@contextlib.contextmanager
def recording_attention(store: list):
    """Append every encoder self-attention output of the towers' composition
    blocks (models/clip_vit.py's two entries, whichever route is in place)
    to ``store``."""
    from dfd_clip_tpu_torch.models import clip_vit

    names = ("encoder_self_attention", "encoder_self_attention_qkv")
    saved = {n: getattr(clip_vit, n) for n in names}

    def recorded(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.append(out)
            return out
        return call

    try:
        for n in names:
            setattr(clip_vit, n, recorded(saved[n]))
        yield
    finally:
        for n in names:
            setattr(clip_vit, n, saved[n])


def kv_drift(label: str, det, params, x) -> None:
    """Print each kept layer's K and V, and each composition block's
    attention output, on one batch from the kernels against the bf16 plain
    route (max|d| / max|plain| a layer; the int8 split pair's attention is
    inside its block kernel and is not recorded)."""
    import torch

    atts = ([], [])
    with torch.no_grad():
        frames = det.preprocess(torch.as_tensor(x, device="cuda"))
        with recording_attention(atts[0]):
            got = det.encode_kv(params, frames)
        with plain_versions(), recording_attention(atts[1]):
            want = det.encode_kv(params, frames)
    errs = {s_: [rel_err(got[s_][i], want[s_][i]) for i in range(got[s_].shape[0])]
            for s_ in ("k", "v")}
    print(f"  {label} K/V of the kept layers, kernels vs bf16 plain: " + "; ".join(
        f"{s_} " + " ".join(f"{e:.3e}" for e in errs[s_]) for s_ in ("k", "v")), flush=True)
    if atts[0]:
        print(f"  {label} attention output a layer, kernels vs bf16 plain: " + " ".join(
            f"{rel_err(a, b):.3e}" for a, b in zip(*atts)), flush=True)

def half_drift(label: str, det, params, x) -> list:
    """Each block's two halves of the bf16 composition (models/clip_vit.py
    composition_block) on one batch, the kernel route and the bf16 plain
    route fed the same input: the attention half (LN1, qkv, attention,
    out-projection, residual) from the kernel route's block input, the MLP
    half (LN2, MLP, residual) from the kernel route's attention-half output;
    printed layer by layer as max|d| / max|plain| of the half's output.
    Returns the readings [(attention half, MLP half)] by layer."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit, dinov2_vit, layers

    cfg, enc = det.vit_cfg, params["encoder"]
    dinov2 = det._dinov2()
    ffn = dinov2_vit.apply_ffn if dinov2 else clip_vit.clip_mlp

    def attn_half(bp, h):
        n, t, w = h.shape
        qkv = layers.linear(bp["attn"]["in_proj"], layers.layer_norm_rows(bp["ln_1"], h))
        if dinov2:
            q, k, v = (s_.reshape(n, t, cfg.heads, cfg.head_dim) for s_ in qkv.split(w, dim=-1))
            att = clip_vit.encoder_self_attention(q, k, v).reshape(n, t, w)
        else:
            att = clip_vit.encoder_self_attention_qkv(qkv, cfg.heads, cfg.head_dim)
        return h + clip_vit._layer_scale(bp, "ls1", layers.linear(bp["attn"]["out_proj"], att))

    def mlp_half(bp, h):
        return h + clip_vit._layer_scale(bp, "ls2", ffn(bp["mlp"],
                                                        layers.layer_norm_rows(bp["ln_2"], h)))

    readings = []
    with torch.no_grad():
        frames = det.preprocess(torch.as_tensor(x, device="cuda"))
        frames = frames.reshape((-1,) + tuple(frames.shape[2:]))
        embed = dinov2_vit.embed if dinov2 else clip_vit.embed_patches
        h = embed(enc, frames, cfg, det.compute_dtype)
        for i in range(max(det.layer_indices)):
            bp = enc["blocks"][i]
            hmid = attn_half(bp, h)
            out = mlp_half(bp, hmid)
            with plain_versions():
                readings.append((rel_err(hmid, attn_half(bp, h)), rel_err(out, mlp_half(bp, hmid))))
            h = out
    print(f"  {label} each block's halves on the same input, kernels vs bf16 plain (rel of "
          f"the max, layers 0-{len(readings) - 1}): attention half " + " ".join(
              f"{a:.2e}" for a, _ in readings) + "; MLP half " + " ".join(
              f"{b:.2e}" for _, b in readings), flush=True)
    return readings


def with_video(det, params, x, m):
    """(logits, video features) of one predict."""
    logits, feats = det.predict(params, x, m, with_video_features=True)
    return logits[0], feats["video"]


def serve_path(card: str) -> dict:
    """A Scorer over the flagship Detector answers four requests. Returns
    the launch counts of those requests."""
    import torch

    from dfd_clip_tpu_torch.serve import Scorer

    det = detector()
    scorer = Scorer(det, det.init_params(torch.Generator().manual_seed(0)), batch_size=CLIPS)
    requests = make_requests()
    counts = answer(scorer, requests, card, "serve")
    check_counts("serve", counts, FLAGSHIP_COUNTS, len(requests))

    # one batch's logits: kernels vs the same Detector through the plain versions
    x, m = last_batch(requests)
    hold_against_plain("predict", lambda x_, m_: scorer.predict(scorer.params, x_, m_), x, m)

    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
    print(f"  device-resident predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    profile_device("predict", lambda: scorer.predict(scorer.params, xd, md))
    profile_device("request", lambda: scorer.score_frames(requests[-1]))
    return counts


# the HTTP phase's videos: (seconds at 25 fps, frame size); 40, 60, 80 and 80
# frames, as make_requests's, one at 320 pixels (resize and crop)
HTTP_VIDEOS = ((8, 224), (12, 224), (16, 320), (16, 224))
CLIP_SECONDS = 4.0        # data.clip_duration (configs/deepfake/deepfake.yaml)
TOL_HTTP = 1e-6           # an answer against the Scorer's score_frames, same frames
FLAGSHIP_COUNTS = {"fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
                   "fused_decoder_attention": 6, "decoder_boundary": 7}
# the video file sent to /score as raw bytes: (seconds at 25 fps, frame size)
SCORE_VIDEO = (12, 320)
# inference.main's Celeb-DF tree: (label, seconds at 25 fps) of each video,
# 224-pixel MJPG .avi files as the preprocessing pipeline writes them
EVAL_VIDEOS = (("REAL", 8), ("REAL", 12), ("FAKE", 12), ("FAKE", 8))


def http_call(port: int, endpoint: str, body=None) -> tuple:
    """(status, JSON payload) of one request to the local server; an error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{endpoint}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def write_video(file: str, seconds: float, size: int, fourcc: str, seed: int) -> None:
    """A 25 fps video of a seeded image drifting in brightness (cv2)."""
    import cv2
    import numpy as np

    Path(file).parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(file, cv2.VideoWriter_fourcc(*fourcc), 25.0, (size, size))
    if not writer.isOpened():
        raise SystemExit(f"FAIL serve_http: cv2 cannot write {file} ({fourcc})")
    base = np.random.default_rng(seed).integers(0, 200, (size, size, 3), np.uint8)
    for i in range(int(seconds * 25)):
        writer.write(np.clip(base.astype(np.int32) + i % 50, 0, 255).astype(np.uint8))
    writer.release()


def sampled_frames(backend, file: str):
    """The frames score_video reads: every CLIP_SECONDS / FRAMES seconds that
    the video holds."""
    import numpy as np

    from dfd_clip_tpu_torch.data.video import _time_to_frame_index

    meta = backend.probe(file)
    times = [t for t in np.arange(0, meta.duration, CLIP_SECONDS / FRAMES)
             if _time_to_frame_index(t, meta.fps) < meta.frames]
    return backend.read_frames(file, times)


def dataset_frames(backend, file: str):
    """A test video's clips as the datasets pack them (data/datasets.py,
    get_dict): clip k at int(k * clip_duration) seconds, FRAMES frames
    (fps * clip_duration - 1) / (FRAMES - 1) frame intervals apart, every
    whole clip the video holds; the clips' frames one after another."""
    import numpy as np

    meta = backend.probe(file)
    stride = ((int(meta.fps * CLIP_SECONDS) - 1) / (FRAMES - 1)) / meta.fps
    clips = [backend.read_frames(file, [int(k * CLIP_SECONDS) + i * stride
                                        for i in range(FRAMES)])
             for k in range(int(meta.duration // CLIP_SECONDS))]
    return np.concatenate(clips)


def timed_score(reference, frames) -> tuple:
    """(P(fake), ms) of the reference Scorer's score_frames."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = reference.score_frames(frames)
    torch.cuda.synchronize()
    return want, (time.perf_counter() - t0) * 1e3


def serve_http_path(card: str) -> dict:
    """The serving entries as a user runs them: a run directory written with
    the port's save_params (a framework-native encoder.pt and
    best_weights.pt from seeded params) and a setting.yaml for the flagship
    preset; Scorer.from_run_dir (which reads it and calls from_preset) behind
    a ThreadingHTTPServer on a thread; /healthz, an unknown path, four
    synthetic:// videos through /score_path and a cv2-written video's raw
    bytes through /score, each counted and held to an independent Scorer's
    score_frames on the same frames, and a video that cannot be read; then
    inference.main over a Celeb-DF tree of cv2-written videos, counted and
    held video by video to that Scorer on the clips the dataset packs; then
    one predict with patch_indices held against the plain versions. Returns
    the launch counts of the requests and of inference.main."""
    import collections
    import os
    import pickle
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    import cv2
    import numpy as np
    import torch
    import yaml

    from dfd_clip_tpu_torch import inference
    from dfd_clip_tpu_torch.data.video import OpenCVBackend, SyntheticBackend
    from dfd_clip_tpu_torch.models.weights import save_params
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.serve import Scorer, make_handler

    print(f"  cv2 {cv2.__version__}, yaml {yaml.__version__}", flush=True)
    det = detector()
    params = det.init_params(torch.Generator().manual_seed(0))
    reference = Scorer(det, params, batch_size=CLIPS)
    counts: collections.Counter = collections.Counter()
    with tempfile.TemporaryDirectory() as work:
        run_dir, cdf = str(Path(work) / "run"), str(Path(work) / "cdf")
        encoder = str(Path(run_dir) / "encoder.pt")
        Path(run_dir).mkdir()
        save_params(encoder, {"backbone": params["encoder"]})
        save_params(str(Path(run_dir) / "best_weights.pt"),
                    {"trainable": {"decoder": params["decoder"]}, "steps": 0})
        setting = {"model": {**det.config.to_dict(), "pretrained": encoder},
                   "data": {"num_frames": FRAMES, "clip_duration": CLIP_SECONDS,
                            "eval": [{"name": "CDF", "category": "Deepfake",
                                      "root_dir": cdf}]}}
        (Path(run_dir) / "setting.yaml").write_text(yaml.safe_dump(setting))
        t0 = time.perf_counter()
        scorer = Scorer.from_run_dir(run_dir, batch_size=CLIPS)
        print(f"  Scorer.from_run_dir: {time.perf_counter() - t0:.2f} s (setting.yaml read, "
              f"from_preset, params on the card)", flush=True)
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(scorer))
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            status, payload = http_call(port, "/healthz")
            print(f"  GET /healthz -> {status} {payload}", flush=True)
            if (status, payload) != (200, {"ok": True}):
                raise SystemExit(f"FAIL serve_http: /healthz answered {status} {payload}")
            status, payload = http_call(port, "/nope")
            print(f"  GET /nope -> {status} {payload}", flush=True)
            if status != 404:
                raise SystemExit(f"FAIL serve_http: /nope answered {status}, expected 404")
            video = str(Path(work) / "upload.mp4")
            write_video(video, *SCORE_VIDEO, "mp4v", seed=5)
            requests = [(f"/score_path {url}", "/score_path",
                         json.dumps({"path": url}).encode(), SyntheticBackend(), url)
                        for url in (f"synthetic://{i}?fps=25&duration={sec}&size={size}"
                                    for i, (sec, size) in enumerate(HTTP_VIDEOS))]
            requests.append((f"/score {Path(video).stat().st_size} bytes of mp4v "
                             f"{SCORE_VIDEO[1]}x{SCORE_VIDEO[1]}", "/score",
                             Path(video).read_bytes(), OpenCVBackend(), video))
            for i, (label, endpoint, body, backend, source) in enumerate(requests):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                status, payload = http_call(port, endpoint, body)
                http_ms = (time.perf_counter() - t0) * 1e3
                request_counts = _cuda.launches()
                counts.update(request_counts)
                if status != 200:
                    raise SystemExit(f"FAIL serve_http request {i}: {status} {payload}")
                frames = sampled_frames(backend, source)
                want, scorer_ms = timed_score(reference, frames)
                delta = abs(payload["p_fake"] - want)
                print(f"  POST {label}: {len(frames)} frames -> {len(frames) // FRAMES} "
                      f"clips, P(fake) {payload['p_fake']:.9f}, Scorer score_frames "
                      f"{want:.9f}, |d| {delta:.3e} (tol {TOL_HTTP:g}); HTTP {http_ms:.2f} "
                      f"ms, score_frames {scorer_ms:.2f} ms, on {card}", flush=True)
                check_counts(f"serve_http request {i}", request_counts, FLAGSHIP_COUNTS, 1)
                if not delta <= TOL_HTTP:
                    raise SystemExit(f"FAIL serve_http request {i}: P(fake) "
                                     f"{payload['p_fake']} vs score_frames {want}")
            status, payload = http_call(port, "/score_path",
                                        json.dumps({"path": "/nonexistent.avi"}).encode())
            print(f"  POST /score_path /nonexistent.avi -> {status} {payload}", flush=True)
            if status != 400 or not isinstance(payload.get("error"), str):
                raise SystemExit(f"FAIL serve_http: a missing video answered {status} {payload}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

        # inference.main over a Celeb-DF tree: one predict a video (each
        # video's clips fit one batch of CLIPS)
        names = {"REAL": [], "FAKE": []}
        for i, (label, seconds) in enumerate(EVAL_VIDEOS):
            name = f"{label.lower()}{i}"
            write_video(f"{cdf}/{label}/videos/{name}.avi", seconds, 224, "MJPG", seed=10 + i)
            names[label].append(name)
        Path(cdf, "csv_files").mkdir()
        for label, rows in names.items():
            Path(cdf, "csv_files", f"test_{label.lower()}.csv").write_text(
                "\n".join(f"{n}.avi {int(label == 'FAKE')}" for n in rows))
        print(f"[serve http inference] inference.main over {len(EVAL_VIDEOS)} Celeb-DF "
              f"videos ({', '.join(f'{s} s' for _, s in EVAL_VIDEOS)}), --modality video, "
              f"batch {CLIPS}", flush=True)
        previous = os.getcwd()
        os.chdir(work)   # the datasets' video-table cache goes under the working directory
        try:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            report = inference.main(inference.parse_args(
                [run_dir, "--batch_size", str(CLIPS), "--num_workers", "2",
                 "--video_backend", "opencv"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_counts = _cuda.launches()
        finally:
            os.chdir(previous)
        counts.update(run_counts)
        (stats_file,) = Path(run_dir).glob("stats_*_best_video.pickle")
        (report_file,) = Path(run_dir).glob("report_*_best_video.json")
        stats = pickle.loads(stats_file.read_bytes())
        print(f"  inference.main: {wall:.2f} s, report {report}", flush=True)
        check_counts("serve_http inference.main", run_counts, FLAGSHIP_COUNTS,
                     len(EVAL_VIDEOS))
        if json.loads(report_file.read_text()) != report or sorted(report) != ["CDF"]:
            raise SystemExit(f"FAIL serve_http inference.main: report {report}")
        labels = [int(label == "FAKE") for label, _ in EVAL_VIDEOS]
        if sorted(stats) != ["CDF"] or sorted(stats["CDF"]["label"]) != sorted(labels):
            raise SystemExit(f"FAIL serve_http inference.main: stats {stats}")
        order = [(label, f"{label.lower()}{i}") for i, (label, _) in enumerate(EVAL_VIDEOS)]
        order = [o for lab in ("REAL", "FAKE") for o in order if o[0] == lab]
        opencv = OpenCVBackend()
        for (label, name), got, got_label in zip(order, stats["CDF"]["prob"],
                                                 stats["CDF"]["label"]):
            frames = dataset_frames(opencv, f"{cdf}/{label}/videos/{name}.avi")
            want, _ = timed_score(reference, frames)
            delta = abs(got - want)
            print(f"  {label}/{name}: {len(frames) // FRAMES} clips, P(fake) {got:.9f}, "
                  f"Scorer score_frames {want:.9f}, |d| {delta:.3e} (tol {TOL_HTTP:g})",
                  flush=True)
            if got_label != int(label == "FAKE") or not delta <= TOL_HTTP:
                raise SystemExit(f"FAIL serve_http inference.main {name}: label {got_label}, "
                                 f"P(fake) {got} vs score_frames {want}")
    del reference

    # patch_indices: half of the 196 patches, drawn per kept layer
    rng = np.random.default_rng(7)
    idx = np.stack([rng.choice(196, 98, replace=False) for _ in KEEP])
    x, m = last_batch(make_requests())

    def predict(x_, m_):
        return scorer.model.predict(scorer.params, x_, m_, patch_indices=idx)[0][0]

    print(f"[serve http patch_indices] 98 of 196 patches a kept layer, L = {FRAMES} x 98",
          flush=True)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    predict(x, m)
    torch.cuda.synchronize()
    check_counts("serve_http patch_indices", _cuda.launches(), FLAGSHIP_COUNTS, 1)
    hold_against_plain("patch_indices predict", predict, x, m)
    return dict(counts)


def int8_serve_path(card: str):
    """A Scorer over the flagship compute_int8 Detector answers the four
    requests; then one compute_int8 + int8_rows predict. Returns the launch
    counts of the requests and of that predict."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.serve import Scorer

    int8_mode = {"temporal_position": 1, "compute_int8": 1}
    det = detector(op_mode=int8_mode)
    raw = det.init_params(torch.Generator().manual_seed(0))
    scorer = Scorer(det, raw, batch_size=CLIPS)
    requests = make_requests()
    counts = answer(scorer, requests, card, "int8 serve")
    check_counts("int8 serve", counts,
                 {"fused_encoder_block": 11, "fused_encoder_attn_block": 1,
                  "fused_encoder_mlp_block": 0, "fused_decoder_attention": 6,
                  "fused_decoder_attention_int8": 0, "decoder_boundary": 7,
                  "gemm_s8_quant": 11, "quant_rows": 11, **NO_BF16_ROWS},
                 len(requests), used=("gemm_s8", "gemm_s8_quant", "quant_rows",
                                      "layer_norm_quant", "encoder_attention"))

    x, m = last_batch(requests)
    got = hold_against_plain("int8 predict",
                             lambda x_, m_: scorer.predict(scorer.params, x_, m_), x, m)
    bf16 = detector()
    bf16_params = bf16.prepare_params(raw)
    ref = bf16.predict(bf16_params, x, m)[0][0].float()
    del bf16_params
    cos = F.cosine_similarity(got.float().flatten(), ref.flatten(), dim=0).item()
    per_clip = F.cosine_similarity(got.float(), ref, dim=-1).min().item()
    print(f"  int8 vs bf16 logits, same params: cosine {cos:.6f} (tol {TOL_COSINE:g}), "
          f"lowest per clip {per_clip:.6f}", flush=True)
    if not cos >= TOL_COSINE:
        raise SystemExit(f"FAIL int8 predict: cosine to bf16 {cos:.6f} < {TOL_COSINE:g}")

    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
    print(f"  device-resident int8 predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    profile_device("int8 predict", lambda: scorer.predict(scorer.params, xd, md))
    del scorer

    print("[int8_rows predict] compute_int8 + kv_dtype int8_rows, device-resident batch",
          flush=True)
    rdet = detector(op_mode={**int8_mode, "kv_dtype": "int8_rows"})
    rparams = rdet.prepare_params(raw)

    def predict(x_, m_):
        return rdet.predict(rparams, x_, m_)[0][0]

    torch.cuda.synchronize()
    _cuda.reset_launches()
    predict(xd, md)
    torch.cuda.synchronize()
    rows_counts = _cuda.launches()
    # quant_rows: the 11 attention outputs and the 6 kept layers' K and V rows
    check_counts("int8_rows", rows_counts,
                 {"fused_encoder_block": 11, "fused_encoder_attn_block": 1,
                  "fused_decoder_attention": 0, "fused_decoder_attention_int8": 6,
                  "decoder_boundary": 7, "gemm_s8_quant": 11, "quant_rows": 11 + 12,
                  **NO_BF16_ROWS}, 1,
                 used=("gemm_s8", "gemm_s8_quant", "quant_rows", "layer_norm_quant",
                       "encoder_attention"))
    hold_against_plain("int8_rows predict", predict, xd, md)
    ms = time_ms(lambda: predict(xd, md), iters=5, warmup=1)
    print(f"  device-resident int8_rows predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    profile_device("int8_rows predict", lambda: predict(xd, md))
    return counts, rows_counts


def train_path(card: str) -> dict:
    """A flagship Trainer takes TRAIN_STEPS steps. Returns their launch
    counts."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.ops import _cuda

    det = detector(dropout=0.5)
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


def attention_row(rows: list, name: str, replaces: str, fn, plain, qkv, n: int, t: int,
                  hh: int, paths: tuple, counter=None, out_bytes: int = 2,
                  source: str = "dfd_clip_tpu_torch/csrc/encoder_attention.cu") -> None:
    """One encoder attention entry at a path shape against its plain
    version, with the scaled_dot_product_attention yardstick; the output is
    ``out_bytes`` a value (2 bf16, 4 f32)."""
    import torch.nn.functional as F

    w = hh * 64
    err = compare(name, fn(), plain(), TOL_ENCODER)
    q4, k4, v4 = (s.reshape(n, t, hh, 64).transpose(1, 2) for s in qkv.split(w, dim=-1))
    kernel_row(rows, name, replaces, source, time_ms(fn), time_ms(plain, iters=5),
               time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
               4.0 * n * hh * t * t * 64, 2.0 * n * t * 3 * w + out_bytes * n * t * w,
               PEAK_BF16_TC, err, counter=counter, paths=paths)


def check_attention_sweep() -> None:
    """The encoder attention's two entries and two outputs at every regime of
    its schedule (SWEEP_TOKENS: one key block, ragged and exact ones, the
    narrow last block, odd query-tile counts, the resident and the refilled
    K/V ring), SWEEP_FRAMES frames of 12 and 16 heads, against
    plain_attention at TOL_ENCODER; the separate entry on strided views of
    one packed buffer. The _cuda entries count nothing."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    dev, n = torch.device("cuda"), SWEEP_FRAMES
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if n * 12 <= 2 * sms:
        raise SystemExit(f"FAIL attention sweep: {n} frames of 12 heads are not more than two "
                         f"work items to each of {sms} blocks")
    print(f"  {n} frames: {n * 12} and {n * 16} work items on {sms} persistent blocks",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    for t in SWEEP_TOKENS:
        worst = 0.0
        for hh in (12, 16):
            w = hh * 64
            qkv = torch.randn(n, t, 3 * w, generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = (s_.reshape(n, t, hh, 64) for s_ in qkv.split(w, dim=-1))
            for odt in (torch.bfloat16, torch.float32):
                want = att.plain_attention(q, k, v, out_dtype=odt).reshape(n * t, w)
                for entry, got in (
                        ("packed", _cuda.encoder_attention_packed(qkv.reshape(n * t, -1), n, t,
                                                                  hh, 64, odt)),
                        ("separate", _cuda.encoder_attention_separate(q, k, v, odt))):
                    if got.dtype != odt or not torch.isfinite(got).all():
                        raise SystemExit(f"FAIL attention sweep {t} tokens, {hh} heads, "
                                         f"{entry} {odt}: wrong type or not finite")
                    err = rel_err(got, want)
                    worst = max(worst, err)
                    if err > TOL_ENCODER:
                        raise SystemExit(f"FAIL attention sweep {t} tokens, {hh} heads, "
                                         f"{entry} {odt}: rel_err {err:.3e} > {TOL_ENCODER:g}")
        print(f"  {t} tokens: both entries, bf16 and f32 out, 12 and 16 heads: worst rel_err "
              f"{worst:.3e} (tol {TOL_ENCODER:g})", flush=True)


def check_int8_attention_sweep(rows: list) -> None:
    """The int8 encoder attention (csrc/encoder_attention_s8.cu, one kernel
    for both modes and every token count) at SWEEP_TOKENS on SWEEP_FRAMES
    frames of 12 heads, more than two work items to each persistent block,
    both modes, against attn_int8_cols_plain at TOL_ENCODER, with the share
    of rows off by more than 1e-4 printed (a P value on a rounding boundary
    may quantise one step apart). Then at the paths' shapes, 320 frames of
    197 tokens x 12 heads (ViT-B/16), 257 x 16 (ViT-L/14) and 577 x 16
    (ViT-L/14@336px), each mode timed beside the bf16 encoder attention's f32
    output and the bound; the 257- and 577-token rows join the kernel table
    (the 197-token rows come from `[kernels variants]`)."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    dev, n, bf = torch.device("cuda"), SWEEP_FRAMES, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if n * 12 <= 2 * sms:
        raise SystemExit(f"FAIL int8 attention sweep: {n} frames of 12 heads are not more than "
                         f"two work items to each of {sms} blocks")
    gen = torch.Generator(device=dev).manual_seed(15)
    for t in SWEEP_TOKENS:
        qkv = torch.randn(n * t, 3 * 12 * 64, generator=gen, device=dev).to(bf)
        line = []
        for mode, qk in (("1", False), ("qk", True)):
            got = att.encoder_attention_int8(qkv, n, t, 12, 64, qk_only=qk)
            want = att.attn_int8_cols_plain(qkv, n, t, 12, 64, qk_only=qk)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise SystemExit(f"FAIL int8 attention sweep {t} tokens, mode {mode}: shape "
                                 f"{tuple(got.shape)} or not finite")
            err = rel_err(got, want)
            off = ((got - want).abs().amax(-1) / want.abs().max() > 1e-4).float().mean().item()
            line.append(f"'{mode}' rel_err {err:.3e}, rows off by > 1e-4 {off:.2e}")
            if err > TOL_ENCODER:
                raise SystemExit(f"FAIL int8 attention sweep {t} tokens, mode {mode}: rel_err "
                                 f"{err:.3e} > {TOL_ENCODER:g}")
            del got, want
        print(f"  {t} tokens, {n} frames x 12 heads: " + "; ".join(line)
              + f" (tol {TOL_ENCODER:g})", flush=True)
        del qkv
    torch.cuda.empty_cache()

    n = CLIPS * FRAMES
    pa = "dfd_clip_tpu/ops/pallas_attention.py"
    for t, hh, path in ((197, 12, None), (WIDE_TOKENS, 16, "vitl_full_attn"),
                        (L336_TOKENS, 16, "vitl336_full_attn")):
        w = hh * 64
        qkv = torch.randn(n * t, 3 * w, generator=gen, device=dev).to(bf)
        bf16_ms = time_ms(lambda: _cuda.encoder_attention_packed(qkv, n, t, hh, 64,
                                                                 torch.float32))
        ops, nb = 4.0 * n * hh * t * t * 64, 2.0 * n * t * 3 * w + 4.0 * n * t * w
        for mode, qk in (("1", False), ("qk", True)):
            # operations: QK^T on int8; PV on int8, or bf16 in the qk mode
            ops_t = ops / 2 / PEAK_INT8_TC + ops / 2 / (PEAK_BF16_TC if qk else PEAK_INT8_TC)
            bound = max(ops_t, nb / HBM) * 1e3
            ms = time_ms(lambda: att.encoder_attention_int8(qkv, n, t, hh, 64, qk_only=qk))
            print(f"  int8 attention '{mode}' at ({n}, {t}, {hh} x 64): {ms:.4f} ms; bf16 "
                  f"attention, f32 out, {bf16_ms:.4f} ms (int8 / bf16 {ms / bf16_ms:.3f}); bound "
                  f"{bound:.4f} ms by {'operations' if ops_t >= nb / HBM else 'bytes'} "
                  f"(ms / bound {ms / bound:.3f})", flush=True)
            if path is None:
                continue
            name = f"encoder_attention_int8{' qk' if qk else ''} {t}"
            err = compare(name, att.encoder_attention_int8(qkv, n, t, hh, 64, qk_only=qk),
                          att.attn_int8_cols_plain(qkv, n, t, hh, 64, qk_only=qk), TOL_ENCODER)
            kernel_row(rows, name, f"{pa}:214", "dfd_clip_tpu_torch/csrc/encoder_attention_s8.cu",
                       ms, time_ms(lambda: att.attn_int8_cols_plain(qkv, n, t, hh, 64,
                                                                    qk_only=qk),
                                   iters=2, warmup=1),
                       None, 0, 0, 0, err, counter="encoder_attention_int8",
                       paths=() if qk else (path,),
                       bound=(bound, "operations" if ops_t >= nb / HBM else "bytes"))
        del qkv
        torch.cuda.empty_cache()


def check_wide_kernels(rows: list) -> None:
    """The kernels of the 257-token paths at their shapes (320 frames x 257
    tokens): the packed attention at ViT-L/14's 16 heads, the separate one
    at DINOv2 ViT-B/14's 12 heads on strided views of one packed buffer and
    on contiguous tensors, the int8 split pair at width 1024 in all its
    forms and each kernel of its chain, layer_norm_rows on the towers'
    (82240, W) rows, and the decoder (attention over L = 20 x 256 rows,
    boundaries at width 1024). A row counts the launches of the paths that
    run its kernel at its shape (the width-1024 rows also those of the
    577-token ViT-L/14@336px paths); the products inside the decoder boundaries
    count with their path's encoder-shape gemm row (ViT-L's with the
    out-projection row, DINOv2's, at width 768, with ViT-B's) and are held
    at their own shapes by the decoder_boundary rows."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    n, t, bf = CLIPS * FRAMES, WIDE_TOKENS, torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)

    # -- the packed entry (ViT-L/14) and the separate entry (DINOv2 B/14) ----------
    qkv = torch.randn(n, t, 3 * 1024, generator=gen).to(dev, bf)
    attention_row(rows, "fused_encoder_attention_qkv",
                  "dfd_clip_tpu/ops/pallas_attention.py:145",
                  lambda: att.fused_encoder_attention_qkv(qkv, 16, 64),
                  lambda: att.plain_attention_qkv(qkv, 16, 64), qkv, n, t, 16, ("vitl_serve",))
    # the same kernel inside the int8 split attention block (bf16 out)
    qkv2 = qkv.reshape(n * t, 3 * 1024)
    attention_row(rows, "encoder_attention 257 tokens",
                  "dfd_clip_tpu/ops/pallas_attention.py:385",
                  lambda: eb.encoder_attention(qkv2, n, t, 16, 64),
                  lambda: att.plain_attention_qkv(qkv, 16, 64).reshape(n * t, 1024), qkv, n, t,
                  16, ("vitl_int8_serve", "vitl_split", "vitl_full"), counter="encoder_attention")
    del qkv2
    qkv = torch.randn(n, t, 3 * 768, generator=gen).to(dev, bf)
    q, k, v = (s.reshape(n, t, 12, 64) for s in qkv.split(768, dim=-1))
    attention_row(rows, "fused_encoder_attention",
                  "dfd_clip_tpu/ops/pallas_attention.py:1346",
                  lambda: att.fused_encoder_attention(q, k, v),
                  lambda: att.plain_attention(q, k, v), qkv, n, t, 12, ("dinov2_serve",))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    compare("fused_encoder_attention contiguous q, k, v", att.fused_encoder_attention(qc, kc, vc),
            att.plain_attention(qc, kc, vc), TOL_ENCODER)
    del qkv, q, k, v, qc, kc, vc

    # -- layer_norm_rows on the towers' rows (ViT-L: 1024 wide, DINOv2: 768) -------
    for w, paths in ((1024, VITL_PATHS), (768, ("dinov2_serve",))):
        ln = {"scale": (1.0 + 0.1 * torch.randn(w, generator=gen)).to(dev),
              "bias": (0.1 * torch.randn(w, generator=gen)).to(dev)}
        h2 = torch.randn(n * t, w, generator=gen).to(dev, bf)
        check_layer_norm(rows, f"layer_norm_rows {n * t} x {w}", h2, ln, paths)
        del h2

    # -- the int8 split pair at (320, 257, 1024) -------------------------------------
    cfg = clip_vit.VIT_L14
    w, hh, t_out, nsel = cfg.width, cfg.heads, t - 1, len(VITL_KEEP)
    m_rows = n * t
    blk = random_block(gen, dev, int8=True, cfg=cfg)
    ln1, attn, ln2, mlp = blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"]
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)
    err = compare("int8 split attn block h", eb.fused_encoder_attn_block(
        h, ln1, attn, hh, 64, int8_gemm=True), eb.fused_encoder_attn_block_plain(
        h, ln1, attn, hh, 64, int8_gemm=True), TOL_ENCODER)
    for rows8 in (False, True):
        kv_dt = torch.int8 if rows8 else bf
        bufs = [(torch.zeros(nsel, n, t_out, w, dtype=kv_dt, device=dev),
                 torch.zeros(nsel, n, t_out, w, dtype=kv_dt, device=dev)) for _ in range(2)]
        outs = [fn(h, ln1, attn, hh, 64, export=True, drop_cls=True,
                   export_into=(kb, vb, 2, nsel), int8_gemm=True, kv_rows8=rows8)
                for fn, (kb, vb) in zip((eb.fused_encoder_attn_block,
                                         eb.fused_encoder_attn_block_plain), bufs)]
        form = "int8_rows export" if rows8 else "bf16 export"
        err = max(err, compare(f"int8 split attn block {form} h", outs[0][0], outs[1][0],
                               TOL_ENCODER))
        for i, part in ((1, "k"), (2, "v")):
            got, want = outs[0][i][2], outs[1][i][2]
            if rows8:
                got, want = got.float() * outs[0][i + 2], want.float() * outs[1][i + 2]
            err = max(err, compare(f"int8 split attn block {form} {part}", got, want,
                                   TOL_ENCODER))
        if not rows8:
            main_bufs = bufs
        del outs
    del bufs
    # the int8 last_only layer at this width (slot 5)
    for fn, (kb, vb) in zip((eb.fused_encoder_attn_block, eb.fused_encoder_attn_block_plain),
                            main_bufs):
        fn(h, ln1, attn, hh, 64, drop_cls=True, last_only=True, int8_gemm=True,
           export_into=(kb, vb, 5, nsel))
    for i, part in ((0, "k"), (1, "v")):
        err = max(err, compare(f"int8 split last_only {part}", main_bufs[0][i][5],
                               main_bufs[1][i][5], TOL_ENCODER))
    into, into_p = ((*b, 2, nsel) for b in main_bufs)
    # bound: the int8 qkv product and the bf16 out-projection and attention on
    # the tensor cores; bytes: h in, h out, the weights, the K/V export
    ops_t = (2.0 * m_rows * w * 3 * w / PEAK_INT8_TC
             + (2.0 * m_rows * w * w + 4.0 * n * hh * t * t * 64) / PEAK_BF16_TC)
    nbytes = 4.0 * m_rows * w + 3.0 * w * w + 2.0 * w * w + 4.0 * n * t_out * w + 24.0 * w
    kernel_row(rows, "fused_encoder_attn_block int8 split",
               "dfd_clip_tpu/ops/pallas_attention.py:532",
               "dfd_clip_tpu_torch/ops/encoder_block.py",
               time_ms(lambda: eb.fused_encoder_attn_block(
                   h, ln1, attn, hh, 64, export=True, drop_cls=True, export_into=into,
                   int8_gemm=True), iters=10),
               time_ms(lambda: eb.fused_encoder_attn_block_plain(
                   h, ln1, attn, hh, 64, export=True, drop_cls=True, export_into=into_p,
                   int8_gemm=True), iters=3, warmup=1),
               None, 0, 0, 0, err, counter="fused_encoder_attn_block",
               paths=("vitl_int8_serve", "vitl_split"),
               bound=(max(ops_t, nbytes / HBM) * 1e3,
                      "operations" if ops_t >= nbytes / HBM else "bytes"))
    del into, into_p, main_bufs

    got = eb.fused_encoder_mlp_block(h, ln2, mlp, int8_gemm=True)
    err = compare("int8 split mlp block", got,
                  eb.fused_encoder_mlp_block_plain(h, ln2, mlp, int8_gemm=True), TOL_ENCODER)
    del got
    kernel_row(rows, "fused_encoder_mlp_block int8",
               "dfd_clip_tpu/ops/pallas_attention.py:1326",
               "dfd_clip_tpu_torch/ops/encoder_block.py",
               time_ms(lambda: eb.fused_encoder_mlp_block(h, ln2, mlp, int8_gemm=True), iters=10),
               time_ms(lambda: eb.fused_encoder_mlp_block_plain(h, ln2, mlp, int8_gemm=True),
                       iters=3, warmup=1),
               None, 16.0 * m_rows * w * w, 4.0 * m_rows * w + 8.0 * w * w + 48.0 * w,
               PEAK_INT8_TC, err, counter="fused_encoder_mlp_block",
               paths=("vitl_int8_serve", "vitl_split"))
    check_split_chain(rows, h, blk)
    del h

    # -- the decoder over the 257-token towers' export (256 rows a frame) ----------
    check_decoder_attention(rows, "fused_decoder_attention 16 heads, L 5120", gen, dev, 16,
                            t_out, t_out, VITL_PATHS + VITL_LADDER)
    check_decoder_attention(rows, "fused_decoder_attention 12 heads, L 5120", gen, dev, 12,
                            t_out, t_out, ("dinov2_serve",))
    check_decoder_boundary(rows, "decoder_boundary width 1024", blk, 5,
                           VITL_PATHS + VITL336_PATHS + VITL_LADDER + VITL336_LADDER)


def check_split_chain(rows: list, h, blk: dict) -> None:
    """Each kernel of the int8 split pair's chain on its own at (320 x 257,
    1024), against its plain version: layer_norm_quant, gemm_s8 at qkv and
    c_proj (rounded to bf16, then + h), gemm_s8_quant at c_fc (QuickGELU,
    its (82240, 4096) rows quantised), and the bf16 out-projection gemm with
    the residual. (The attention between them is held above.)"""
    import torch

    from dfd_clip_tpu_torch.models import layers
    from dfd_clip_tpu_torch.ops import _cuda, int8

    n, t, w = h.shape
    m_rows, bf = n * t, torch.bfloat16
    h2 = h.reshape(m_rows, w)
    ln1, attn, mlp = blk["ln_1"], blk["attn"], blk["mlp"]
    paths = ("vitl_int8_serve", "vitl336_int8_serve") + tuple(
        f"{a}_{r}" for a in ("vitl", "vitl336") for r in ("split", "full", "full_attn"))
    tag = f"{m_rows} x {w}"

    yq, ys = _cuda.layer_norm_quant(h2, ln1["scale"], ln1["bias"])
    err = compare_int8(f"layer_norm_quant {tag}", yq, ys,
                       *int8.quant_rows_plain(int8.layer_norm_f32(ln1, h2)), TOL_FLIPS_LN)
    kernel_row(rows, f"layer_norm_quant {tag}", "dfd_clip_tpu/ops/pallas_attention.py:1008",
               "dfd_clip_tpu_torch/csrc/quant_rows.cu",
               time_ms(lambda: _cuda.layer_norm_quant(h2, ln1["scale"], ln1["bias"])),
               time_ms(lambda: int8.quant_rows_plain(int8.layer_norm_f32(ln1, h2))),
               None, 12.0 * m_rows * w, 3.0 * m_rows * w + 4.0 * m_rows + 8.0 * w, PEAK_F32, err,
               counter="layer_norm_quant", paths=paths)
    check_layer_norm_quant(rows, torch.randn(m_rows, w, device=h.device, generator=torch.Generator(
        device=h.device).manual_seed(14)), blk["ln_2"])

    def s8_row(name, a, a_s, p, plain, k, nn, out_bytes, extra_bytes=0.0, **kw):
        wq, ws, b = p["wq"], p["ws"], p["b"]
        got = _cuda.gemm_s8(a, a_s, wq, ws, b, **kw)
        err = compare(name, got, plain(), TOL_ENCODER)
        kernel_row(rows, name, "dfd_clip_tpu/ops/pallas_attention.py:173",
                   "dfd_clip_tpu_torch/csrc/gemm_s8.cu",
                   time_ms(lambda: _cuda.gemm_s8(a, a_s, wq, ws, b, **kw)), time_ms(plain),
                   time_ms(lambda: torch._int_mm(a, wq.t())), 2.0 * m_rows * nn * k,
                   m_rows * k + nn * k + 4.0 * m_rows + 8.0 * nn + out_bytes * m_rows * nn
                   + extra_bytes, PEAK_INT8_TC, err, counter="gemm_s8", paths=paths)
        return got

    qkv_p = attn["in_proj"]
    s8_row(f"gemm_s8 qkv {tag}", yq, ys, qkv_p,
           lambda: (int8.w8a8_dot_plain(yq, ys[:, None], qkv_p["wq"], qkv_p["ws"])
                    + qkv_p["b"]).to(bf), w, 3 * w, 2.0)
    del yq, ys
    yq, ys = _cuda.layer_norm_quant(h2, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    fc = mlp["c_fc"]
    k4w = 4 * w

    def c_fc_plain():
        return int8.w8a8_gelu_quant_plain(yq, ys[:, None], fc["wq"], fc["ws"], fc["b"])

    mq, ms = _cuda.gemm_s8_quant(yq, ys, fc["wq"], fc["ws"], fc["b"])
    err = compare_int8(f"gemm_s8_quant c_fc {tag}", mq, ms, *c_fc_plain(), TOL_FLIPS_GELU)
    kernel_row(rows, f"gemm_s8_quant c_fc {tag}", "dfd_clip_tpu/ops/pallas_attention.py:1262",
               "dfd_clip_tpu_torch/csrc/gemm_s8_quant.cu",
               time_ms(lambda: _cuda.gemm_s8_quant(yq, ys, fc["wq"], fc["ws"], fc["b"])),
               time_ms(c_fc_plain), time_ms(lambda: torch._int_mm(yq, fc["wq"].t())),
               2.0 * m_rows * k4w * w,
               m_rows * w + k4w * w + 1.0 * m_rows * k4w + 8.0 * (m_rows + k4w), PEAK_INT8_TC,
               err, counter="gemm_s8_quant", paths=paths)
    del yq, ys
    pr = mlp["c_proj"]
    s8_row(f"gemm_s8 c_proj {tag}", mq, ms, pr,
           lambda: h2 + (int8.w8a8_dot_plain(mq, ms[:, None], pr["wq"], pr["ws"])
                         + pr["b"]).to(bf), 4 * w, w, 2.0, extra_bytes=2.0 * m_rows * w,
           residual=h2, residual_after_cast=True, out_dtype=bf)
    del mq, ms

    # the bf16 out-projection with the residual (the attention output's place
    # is taken by seeded rows of its scale)
    att = (0.5 * torch.randn(m_rows, w, generator=torch.Generator().manual_seed(6))).to(
        h.device, bf)
    op = attn["out_proj"]
    wo, bo = op["w"].to(bf), op["b"].float()

    def out_plain():
        return h2 + layers.linear_f32_bias(att, op["w"], op["b"])

    err = compare(f"gemm out-proj {tag}", _cuda.gemm(att, wo, bo, residual=h2), out_plain(),
                  TOL_ENCODER)
    kernel_row(rows, f"gemm out-proj {tag}", "dfd_clip_tpu/ops/pallas_attention.py:374",
               "dfd_clip_tpu_torch/csrc/gemm.cu",
               time_ms(lambda: _cuda.gemm(att, wo, bo, residual=h2)), time_ms(out_plain),
               time_ms(lambda: torch.addmm(h2, att, wo)), 2.0 * m_rows * w * w,
               2.0 * (3 * m_rows * w + w * w) + 4.0 * w, PEAK_BF16_TC, err, counter="gemm",
               paths=VITL_PATHS + VITL336_PATHS + VITL_LADDER + VITL336_LADDER)


def wide_serve(card: str, label: str, det, raws: list, expected: dict, used: tuple,
               halves: bool = False, hold_bf16: bool = False):
    """A Scorer over ``det`` with params ``raws[0]`` answers the four
    requests (counted); then, on the params of every seed in ``raws`` and on
    the batches of the last two requests, the kernels, the bf16 plain route
    and the f32 plain route are compared (hold_wide), and the kernels' logits
    and per-clip |dP(fake)| must lie within TOL_LOGITS_F32 and TOL_PFAKE_F32
    of the f32 route on every batch (a miss fails the run after the phase);
    with ``hold_bf16`` their |dP(fake)| must also lie within TOL_PFAKE of the
    bf16 plain route on every batch; a device-resident predict is timed and
    traced; with ``halves`` each block's two halves are read on the same
    input (half_drift). Returns (counts, the logits of seed 0 on the last
    request's batch)."""
    import torch

    from dfd_clip_tpu_torch.serve import Scorer

    scorer = Scorer(det, raws[0], batch_size=CLIPS)
    requests = make_requests()
    counts = answer(scorer, requests, card, label)
    check_counts(label, counts, expected, len(requests), used=used)
    det32 = copy.copy(det)
    det32.compute_dtype = torch.float32
    readings = []
    kv_drift(label, det, scorer.params, last_batch(requests)[0])
    if halves:
        half_drift(label, det, scorer.params, last_batch(requests)[0])
    for seed, raw in enumerate(raws):
        params = scorer.params if seed == 0 else det.prepare_params(raw)
        params32 = det32.prepare_params(raw)
        for index in (-2, -1):
            x, m = last_batch(requests, index)
            xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
            got, reading = hold_wide(
                f"{label} seed {seed}, request {len(requests) + index}",
                lambda x_, m_: with_video(det, params, x_, m_),
                lambda x_, m_: with_video(det32, params32, x_, m_), xd, md)
            readings.append(reading)
            if seed == 0:
                ref = got
        del params, params32
    worst = [[max(r[p][k] for r in readings) for k in range(3)] for p in range(len(PAIRS))]
    print(f"  {label} over {len(raws)} seeds x 2 batches, max: " + "; ".join(
        f"{ROUTES[i]} vs {ROUTES[j]}: logits {w[0]:.3e}, video {w[1]:.3e}, dP {w[2]:.3e}"
        for (i, j), w in zip(PAIRS, worst)), flush=True)
    for k, name, tol in ((0, "logits rel_err", TOL_LOGITS_F32), (2, "|dP(fake)|", TOL_PFAKE_F32)):
        if worst[1][k] > tol:
            fail(f"FAIL {label}: {name} of the kernels from the f32 plain route "
                 f"{worst[1][k]:.3e} > {tol:g}", True)
    if hold_bf16 and worst[0][2] > TOL_PFAKE:
        fail(f"FAIL {label}: |dP(fake)| of the kernels from the bf16 plain route "
             f"{worst[0][2]:.3e} > {TOL_PFAKE:g}", True)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
    print(f"  device-resident {label} predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, on {card}", flush=True)
    profile_device(f"{label} predict", lambda: scorer.predict(scorer.params, xd, md))
    del scorer
    torch.cuda.empty_cache()
    return counts, ref


def vitl_serve_path(card: str, seeds: int, arch: str = "ViT-L/14", label: str = "vit-l"):
    """ViT-L/14 Scorers (``arch``: also "ViT-L/14@336px"), bf16 then
    compute_int8, on the same seeded params (one encoder attention kernel at
    257 and 577 tokens alike). At 257 tokens both are also held against the
    bf16 plain route at TOL_PFAKE (ViT-L/14@336px stays on the f32 route's
    limits). Returns the launch counts of both."""
    import torch
    import torch.nn.functional as F

    cfg = {"architecture": arch, "decode_mode": "stride", "decode_stride": 4}
    bf16 = detector(**cfg)
    tokens = bf16.vit_cfg.num_tokens
    if bf16.layer_indices != VITL_KEEP:
        raise SystemExit(f"FAIL {label}: kept layers {bf16.layer_indices}")
    raws = [bf16.init_params(torch.Generator().manual_seed(s)) for s in range(seeds)]
    decoder = {"fused_decoder_attention": 6, "decoder_boundary": 7, "fused_encoder_block": 0}
    counts, ref = wide_serve(
        card, f"{label} serve", bf16, raws,
        {"fused_encoder_attention_qkv": 20, "fused_encoder_attn_block": 0,
         "fused_encoder_mlp_block": 0, "encoder_attention": 0, "gemm": 0, **decoder},
        used=("fused_encoder_attention_qkv", "layer_norm_rows"),
        halves=tokens == WIDE_TOKENS, hold_bf16=tokens == WIDE_TOKENS)
    print(f"[{label} int8 serve] the same params and requests, op_mode compute_int8", flush=True)
    int8 = detector(**cfg, op_mode={"temporal_position": 1, "compute_int8": 1})
    counts8, got = wide_serve(
        card, f"{label} int8 serve", int8, raws,
        {"fused_encoder_attn_block": 21, "fused_encoder_mlp_block": 20, "encoder_attention": 20,
         "fused_encoder_attention_qkv": 0, "gemm_s8_quant": 20, "quant_rows": 0,
         "layer_norm_rows": 0, **decoder},
        used=("gemm_s8", "gemm_s8_quant", "layer_norm_quant", "encoder_attention", "gemm"),
        hold_bf16=tokens == WIDE_TOKENS)
    cos = F.cosine_similarity(got.float().flatten(), ref.float().flatten(), dim=0).item()
    per_clip = F.cosine_similarity(got.float(), ref.float(), dim=-1).min().item()
    print(f"  {label} int8 vs bf16 logits, same params: cosine {cos:.6f} "
          f"(tol {TOL_COSINE:g}), lowest per clip {per_clip:.6f}", flush=True)
    if not cos >= TOL_COSINE:
        raise SystemExit(f"FAIL {label} int8 predict: cosine to bf16 {cos:.6f} < {TOL_COSINE:g}")
    return counts, counts8


def dinov2_serve_path(card: str, seeds: int) -> dict:
    """A DINOv2 ViT-B/14 Scorer (keep 6-11, no adapter) in bf16."""
    import torch

    det = detector(foundation="dinov2")
    raws = [det.init_params(torch.Generator().manual_seed(s)) for s in range(seeds)]
    counts, _ = wide_serve(
        card, "dinov2 serve", det, raws,
        {"fused_encoder_attention": 11, "fused_encoder_attention_qkv": 0,
         "fused_encoder_attn_block": 0, "fused_encoder_mlp_block": 0,
         "fused_decoder_attention": 6, "decoder_boundary": 7, "gemm": 0},
        used=("fused_encoder_attention", "layer_norm_rows"), halves=True)
    return counts


def tower_params(gen, dev, cfg=None):
    """A tower's seeded blocks on the card (the flagship ViT-B/16's unless
    ``cfg``), LayerNorms and biases off their init values, with the
    pre-quantised int8 weights beside the bf16 ones."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit

    cfg = cfg or clip_vit.VIT_B16
    params = clip_vit.init_clip_vision(gen, cfg)
    w = cfg.width
    for blk in params["blocks"]:
        for ln in (blk["ln_1"], blk["ln_2"]):
            ln["scale"].add_(0.1 * torch.randn(w, generator=gen))
            ln["bias"].add_(0.1 * torch.randn(w, generator=gen))
        for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                    blk["mlp"]["c_proj"]):
            lin["b"].add_(0.02 * torch.randn(lin["b"].shape, generator=gen))
    return [to_device(b, dev) for b in clip_vit.prepare_int8_params(params)["blocks"]]


def check_variant_kernels(rows: list) -> dict:
    """The encoder's alternative kernels against their plain versions at the
    flagship shapes (320 frames x 197 tokens, width 768): the bf16 whole
    block, the int8 encoder attention in both modes, and the 12-layer tower
    (keep 6-11) in bf16 and int8 with each int8 attention mode. Returns the
    towers' errors from their plain versions (PERF.md reads them)."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import tower
    from dfd_clip_tpu_torch.tools import bench_tower_stages as bts

    cfg = clip_vit.VIT_B16
    n, t, w, hh, d = CLIPS * FRAMES, cfg.num_tokens, cfg.width, cfg.heads, cfg.head_dim
    m_rows, t_out, nsel, bf = n * t, 200, len(KEEP), torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    blk = random_block(gen, dev)
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)
    attn_ops = 4.0 * n * hh * t * t * d

    # -- the bf16 whole block with the stacked export ----------------------------
    def bufs():
        return (torch.empty(nsel, n, t_out, w, dtype=bf, device=dev),
                torch.empty(nsel, n, t_out, w, dtype=bf, device=dev))

    kb, vb = bufs()
    kp, vp = bufs()
    args = (h, blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"], hh, d)
    kw = dict(export=True, drop_cls=True, kv_pad=4, int8_gemm=False)
    got = eb.fused_encoder_block(*args, export_into=(kb, vb, 2, nsel), **kw)
    want = eb.fused_encoder_block_plain(*args, export_into=(kp, vp, 2, nsel), **kw)
    err = compare("fused_encoder_block bf16 h", got[0], want[0], TOL_ENCODER)
    err = max(err, compare("fused_encoder_block bf16 k", kb[2], kp[2], TOL_ENCODER))
    err = max(err, compare("fused_encoder_block bf16 v", vb[2], vp[2], TOL_ENCODER))
    if kb[2, :, 196:].abs().max().item() != 0 or vb[2, :, 196:].abs().max().item() != 0:
        raise SystemExit("FAIL fused_encoder_block bf16: export pad rows are not zero")
    del got, want
    flops = 24.0 * m_rows * w * w + attn_ops
    nbytes = 4.0 * m_rows * w + 24.0 * w * w + 4.0 * 9 * w + 4.0 * n * t_out * w
    row = functools.partial(kernel_row, rows)
    row("fused_encoder_block bf16", "dfd_clip_tpu/ops/pallas_attention.py:1212",
        "dfd_clip_tpu_torch/ops/encoder_block.py",
        time_ms(lambda: eb.fused_encoder_block(*args, export_into=(kb, vb, 2, nsel), **kw),
                iters=10),
        time_ms(lambda: eb.fused_encoder_block_plain(*args, export_into=(kp, vp, 2, nsel), **kw),
                iters=3, warmup=1),
        None, flops, nbytes, PEAK_BF16_TC, err, counter="fused_encoder_block",
        paths=("full_bf16",))
    del kb, vb, kp, vp

    # -- the int8 encoder attention at (320, 197, 12 x 64), both modes ----------------
    qkv = torch.randn(m_rows, 3 * w, generator=gen).to(dev, bf)
    for mode, qk in (("1", False), ("qk", True)):
        name = "encoder_attention_int8" + (" qk" if qk else "")
        got = att.encoder_attention_int8(qkv, n, t, hh, d, qk_only=qk)
        err = compare(name, got, att.attn_int8_cols_plain(qkv, n, t, hh, d, qk_only=qk),
                      TOL_ENCODER)
        # operations: QK^T on int8; PV on int8, or bf16 in the qk mode
        ops_t = attn_ops / 2 / PEAK_INT8_TC + attn_ops / 2 / (PEAK_BF16_TC if qk else PEAK_INT8_TC)
        nb = 2.0 * m_rows * 3 * w + 4.0 * m_rows * w
        row(name, "dfd_clip_tpu/ops/pallas_attention.py:214",
            "dfd_clip_tpu_torch/csrc/encoder_attention_s8.cu",
            time_ms(lambda: att.encoder_attention_int8(qkv, n, t, hh, d, qk_only=qk)),
            time_ms(lambda: att.attn_int8_cols_plain(qkv, n, t, hh, d, qk_only=qk), iters=3,
                    warmup=1),
            None, 0, 0, 0, err, counter="encoder_attention_int8",
            paths=("int8_qk",) if qk else ("int8_attn",),
            bound=(max(ops_t, nb / HBM) * 1e3, "operations" if ops_t >= nb / HBM else "bytes"))
        del got
    del qkv, h, blk

    # -- the tower: 12 layers over the flagship batch, keep 6-11 -------------------------
    blocks = tower_params(torch.Generator().manual_seed(8), dev)
    h = torch.randn(n, t, w, generator=gen).to(dev, bf)
    errs = {}
    for label, int8, mode in (("bf16", False, "0"), ("int8", True, "0"),
                              ("int8 attn", True, "1"), ("int8 qk", True, "qk")):
        name = f"fused_encoder_tower {label}"
        kw = dict(keep=KEEP, drop_cls=True, int8_gemm=int8, int8_attn=mode)
        k, v = tower.fused_encoder_tower(h, blocks, hh, d, **kw)
        # the per-layer kernel chain (one launch a kernel), exporting layers
        # 1-11 and keeping each layer's input
        kc = torch.empty((KEEP[-1], *k.shape[1:]), dtype=k.dtype, device=dev)
        vc = torch.empty_like(kc)
        x, inputs = h, []
        for i in range(KEEP[-1]):
            inputs.append(x)
            into = (kc, vc, i - 1, KEEP[-1]) if i >= 1 else None
            b = blocks[i]
            out = eb.fused_encoder_block(x, b["ln_1"], b["attn"], b["ln_2"], b["mlp"], hh, d,
                                         export=into is not None, drop_cls=True,
                                         export_into=into, int8_gemm=int8, int8_attn=mode)
            x = out[0] if into is not None else out
        eb.fused_encoder_attn_block(x, blocks[-1]["ln_1"], blocks[-1]["attn"], hh, d,
                                    drop_cls=True, last_only=True,
                                    export_into=(kc, vc, KEEP[-1] - 1, KEEP[-1]), int8_gemm=int8)
        del x
        kept = slice(KEEP[0] - 1, KEEP[-1])
        hold_chain(name, ((k, kc[kept]), (v, vc[kept])))
        if mode == "0":
            # each stage on the same input, then the tower against the chain
            # over layers 1-11
            tower_stage_holds(name, blocks, inputs, hh, d, int8, mode)
            ka, va = tower.fused_encoder_tower(h, blocks, hh, d,
                                               **{**kw, "keep": range(1, KEEP[-1] + 1)})
            print(f"  {name} vs the per-layer kernel chain, K/V of layers 1-11 (rel of the "
                  f"max): " + " ".join(f"{max(rel_err(ka[j], kc[j]), rel_err(va[j], vc[j])):.2e}"
                                       for j in range(KEEP[-1])), flush=True)
            del ka, va
        del kc, vc, inputs
        kp, vp = tower.fused_encoder_tower_plain(h, blocks, hh, d, **kw)
        err = compare(f"{name} k", k, kp, TOL_TOWER, defer=True)
        err = max(err, compare(f"{name} v", v, vp, TOL_TOWER, defer=True))
        errs[label] = err
        del kp, vp
        # operations: 11 whole blocks and the K/V columns of layer 11 (the
        # attention's two products on int8 or bf16 as the mode has them);
        # bytes: h in, every weight, bias, scale and LayerNorm read once, the
        # six layers' K/V out
        peak = PEAK_INT8_TC if int8 else PEAK_BF16_TC
        attn_t = (attn_ops / PEAK_BF16_TC if mode == "0" else attn_ops / 2 / PEAK_INT8_TC
                  + attn_ops / 2 / (PEAK_BF16_TC if mode == "qk" else PEAK_INT8_TC))
        ops_t = (11 * 24.0 + 4.0) * m_rows * w * w / peak + 11 * attn_t
        wb = 1 if int8 else 2
        layer_bytes = 12.0 * w * w * wb + 4.0 * 13 * w + (4.0 * 9 * w if int8 else 0)
        nb = (2.0 * m_rows * w + 11 * layer_bytes + 2.0 * w * w * wb + 4.0 * 6 * w
              + 2 * 2.0 * nsel * n * (t - 1) * w)
        ms = time_ms(lambda: tower.fused_encoder_tower(h, blocks, hh, d, **kw), iters=5)
        kc, vc = torch.empty_like(k), torch.empty_like(v)
        chain_ms = time_ms(lambda: bts.kernel_chain(h, blocks, hh, KEEP, int8, mode, kc, vc),
                           iters=5)
        del k, v, kc, vc
        row(name, "dfd_clip_tpu/ops/pallas_tower.py:425", "dfd_clip_tpu_torch/csrc/encoder_tower.cu",
            ms,
            time_ms(lambda: tower.fused_encoder_tower_plain(h, blocks, hh, d, **kw), iters=1,
                    warmup=1),
            None, 0, 0, 0, err, counter="fused_encoder_tower",
            paths=("tower_" + label.replace(" ", "_"),),
            bound=(max(ops_t, nb / HBM) * 1e3, "operations" if ops_t >= nb / HBM else "bytes"))
        tower_timings(name, h, blocks, hh, KEEP, int8, mode, ms, chain_ms,
                      rules=label in ("bf16", "int8 attn"))
    return errs


VARIANTS = {  # path: (EncoderKernels arguments, compute_int8, encoder launches a predict)
    "full_bf16": ({"block": "full"}, False,
                  {"fused_encoder_block": 11, "fused_encoder_attn_block": 1,
                   "fused_encoder_mlp_block": 0, "fused_encoder_tower": 0,
                   "encoder_attention": 11, "encoder_attention_int8": 0}),
    "int8_attn": ({"int8_attn": "1"}, True,
                  {"fused_encoder_block": 11, "fused_encoder_attn_block": 1,
                   "fused_encoder_mlp_block": 0, "fused_encoder_tower": 0,
                   "encoder_attention": 0, "encoder_attention_int8": 11,
                   "gemm_s8_quant": 11, "quant_rows": 11, **NO_BF16_ROWS}),
    "tower_bf16": ({"tower": True}, False, {}),
    "tower_int8": ({"tower": True}, True, {}),
    "tower_int8_attn": ({"tower": True, "int8_attn": "1"}, True, {}),
    "tower_int8_qk": ({"tower": True, "int8_attn": "qk"}, True, {}),
}
TOWER_COUNTS = {"fused_encoder_tower": 1, "fused_encoder_block": 0,
                "fused_encoder_attn_block": 0, "fused_encoder_mlp_block": 0, "gemm_s8": 0,
                "gemm_s8_quant": 0, "quant_rows": 0, "encoder_attention": 0,
                "encoder_attention_int8": 0, **NO_BF16_ROWS}


def variant_serve_paths(card: str) -> dict:
    """The six paths of VARIANTS through a Scorer over the flagship Detector
    on the four requests, then the per-layer int8_attn "qk" form as one
    counted device-resident predict. Returns the launch counts of each."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.serve import Scorer

    requests = make_requests()
    x, m = last_batch(requests)
    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    raw = detector().init_params(torch.Generator().manual_seed(0))
    decoder = {"fused_decoder_attention": 6, "decoder_boundary": 7}
    counts, ref = {}, None
    for path, (kernels, int8, encoder) in VARIANTS.items():
        op_mode = {"temporal_position": 1, "compute_int8": int(int8)}
        print(f"[variant serve path {path}] EncoderKernels({kernels}), compute_int8 {int(int8)}",
              flush=True)
        det = detector(kernels, op_mode=op_mode)
        scorer = Scorer(det, raw, batch_size=CLIPS)
        counts[path] = answer(scorer, requests, card, path)
        expected = {**(encoder or TOWER_COUNTS), **decoder}
        used = ("fused_encoder_tower",) if kernels.get("tower") else (
            ("gemm_s8", "gemm_s8_quant", "quant_rows", "layer_norm_quant") if int8
            else ("gemm", "layer_norm_rows", "encoder_attention"))
        check_counts(path, counts[path], expected, len(requests), used=used)
        got = hold_against_plain(path, lambda x_, m_: scorer.predict(scorer.params, x_, m_), x, m,
                                 defer=True)
        if ref is None:
            ref = got.float()        # the bf16 whole block's logits (the first path)
        elif int8:
            cos = F.cosine_similarity(got.float().flatten(), ref.flatten(), dim=0).item()
            gated = kernels.get("int8_attn", "0") == "0"
            print(f"  {path} vs bf16 logits, same params: cosine {cos:.6f}"
                  + (f" (tol {TOL_COSINE:g})" if gated else " (recorded; int8 attention is "
                     "gated by AUROC in the JAX package)"), flush=True)
            if gated and not cos >= TOL_COSINE:
                fail(f"FAIL {path}: cosine to bf16 {cos:.6f} < {TOL_COSINE:g}", True)
        ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
        print(f"  device-resident {path} predict: {ms:.2f} ms per {CLIPS}-clip batch "
              f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
        profile_device(f"{path} predict", lambda: scorer.predict(scorer.params, xd, md))
        del scorer, det
        torch.cuda.empty_cache()

    print("[variant predict int8_qk] compute_int8, EncoderKernels(int8_attn='qk'), "
          "device-resident batch", flush=True)
    det = detector({"int8_attn": "qk"}, op_mode={"temporal_position": 1, "compute_int8": 1})
    params = det.prepare_params(raw)

    def predict(x_, m_):
        return det.predict(params, x_, m_)[0][0]

    torch.cuda.synchronize()
    _cuda.reset_launches()
    got = predict(xd, md)
    torch.cuda.synchronize()
    counts["int8_qk"] = _cuda.launches()
    check_counts("int8_qk", counts["int8_qk"],
                 {**VARIANTS["int8_attn"][2], **decoder}, 1,
                 used=("gemm_s8", "gemm_s8_quant", "quant_rows", "encoder_attention_int8"))
    hold_against_plain("int8_qk", predict, xd, md, defer=True)
    cos = F.cosine_similarity(got.float().flatten(), ref.flatten(), dim=0).item()
    print(f"  int8_qk vs bf16 logits, same params: cosine {cos:.6f} (recorded)", flush=True)
    ms = time_ms(lambda: predict(xd, md), iters=5, warmup=1)
    print(f"  device-resident int8_qk predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    return counts


def check_577_kernels(rows: list) -> None:
    """The 577-token kernels at ViT-L/14@336px's shapes (320 frames x 577
    tokens): the encoder attention at (320, 577, 16 x 64) through the packed
    entry and the separate one (strided views of one packed buffer), bf16
    and f32 out, each against its plain version with the SDPA yardstick; the
    int8 split pair at (320, 577, 1024); quant_rows on the (184640, 1024)
    attention output of the whole int8 block (the MLP's intermediate is
    quantised inside gemm_s8_quant, held in [kernels gemm]); and the decoder
    attention over L = 20 x 576 keys at 16 heads."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import _cuda, int8
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    n, t, hh, bf, f32 = CLIPS * FRAMES, L336_TOKENS, 16, torch.bfloat16, torch.float32
    w = hh * 64
    dev = torch.device("cuda")
    dgen = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(n, t, 3 * w, generator=dgen, device=dev).to(bf)
    qkv2 = qkv.reshape(n * t, 3 * w)
    q, k, v = (s.reshape(n, t, hh, 64) for s in qkv.split(w, dim=-1))
    pa = "dfd_clip_tpu/ops/pallas_attention.py"
    bf16_counters = ("fused_encoder_attention_qkv", "encoder_attention")
    forms = (  # the bf16 row counts the ViT-L/14@336px paths' bf16-out launches
        ("encoder_attention packed 577", f"{pa}:145",
         lambda: att.fused_encoder_attention_qkv(qkv, hh, 64),
         lambda: att.plain_attention_qkv(qkv, hh, 64), 2, VITL336_PATHS + ("vitl336_split",),
         bf16_counters),
        ("encoder_attention packed f32 577", f"{pa}:1212",
         lambda: eb.encoder_attention(qkv2, n, t, hh, 64, out_dtype=f32).reshape(n, t, w),
         lambda: att.plain_attention_qkv(qkv, hh, 64, out_dtype=f32), 4, ("vitl336_full",),
         "encoder_attention"),
        ("encoder_attention separate 577", f"{pa}:1346",
         lambda: att.fused_encoder_attention(q, k, v),
         lambda: att.plain_attention(q, k, v), 2, (), "fused_encoder_attention"),
        ("encoder_attention separate f32 577", f"{pa}:1346",
         lambda: _cuda.encoder_attention_separate(q, k, v, f32).reshape(n, t, hh, 64),
         lambda: att.plain_attention(q, k, v, out_dtype=f32), 4, (), "fused_encoder_attention"),
    )
    for name, replaces, fn, plain, out_bytes, paths, counter in forms:
        attention_row(rows, name, replaces, fn, plain, qkv, n, t, hh, paths,
                      counter=counter, out_bytes=out_bytes)
    del qkv, qkv2, q, k, v

    # -- the int8 split pair at (320, 577, 1024), two export slots -------------------
    gen = torch.Generator().manual_seed(10)
    blk = random_block(gen, dev, int8=True, cfg=clip_vit.VIT_L14)
    ln1, attn, ln2, mlp = blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"]
    h = torch.randn(n, t, w, generator=dgen, device=dev).to(bf)
    m_rows, t_out = n * t, t - 1
    bufs = [(torch.zeros(2, n, t_out, w, dtype=bf, device=dev),
             torch.zeros(2, n, t_out, w, dtype=bf, device=dev)) for _ in range(2)]
    kw = dict(export=True, drop_cls=True, int8_gemm=True)
    outs = [fn(h, ln1, attn, hh, 64, export_into=(*b, 1, 2), **kw)
            for fn, b in zip((eb.fused_encoder_attn_block, eb.fused_encoder_attn_block_plain),
                             bufs)]
    err = compare("int8 split attn block 577 h", outs[0][0], outs[1][0], TOL_ENCODER)
    for i, part in ((1, "k"), (2, "v")):
        err = max(err, compare(f"int8 split attn block 577 {part}", outs[0][i][1],
                               outs[1][i][1], TOL_ENCODER))
    del outs
    ops_t = (2.0 * m_rows * w * 3 * w / PEAK_INT8_TC
             + (2.0 * m_rows * w * w + 4.0 * n * hh * t * t * 64) / PEAK_BF16_TC)
    nbytes = 4.0 * m_rows * w + 3.0 * w * w + 2.0 * w * w + 4.0 * n * t_out * w + 24.0 * w
    kernel_row(rows, "fused_encoder_attn_block int8 split 577", f"{pa}:532",
               "dfd_clip_tpu_torch/ops/encoder_block.py",
               time_ms(lambda: eb.fused_encoder_attn_block(h, ln1, attn, hh, 64,
                                                           export_into=(*bufs[0], 1, 2), **kw),
                       iters=5),
               time_ms(lambda: eb.fused_encoder_attn_block_plain(
                   h, ln1, attn, hh, 64, export_into=(*bufs[1], 1, 2), **kw), iters=2, warmup=1),
               None, 0, 0, 0, err, counter="fused_encoder_attn_block",
               paths=("vitl336_int8_serve", "vitl336_split"),
               bound=(max(ops_t, nbytes / HBM) * 1e3,
                      "operations" if ops_t >= nbytes / HBM else "bytes"))
    del bufs
    err = compare("int8 split mlp block 577", eb.fused_encoder_mlp_block(h, ln2, mlp, int8_gemm=True),
                  eb.fused_encoder_mlp_block_plain(h, ln2, mlp, int8_gemm=True), TOL_ENCODER)
    kernel_row(rows, "fused_encoder_mlp_block int8 577", f"{pa}:1326",
               "dfd_clip_tpu_torch/ops/encoder_block.py",
               time_ms(lambda: eb.fused_encoder_mlp_block(h, ln2, mlp, int8_gemm=True), iters=5),
               time_ms(lambda: eb.fused_encoder_mlp_block_plain(h, ln2, mlp, int8_gemm=True),
                       iters=2, warmup=1),
               None, 16.0 * m_rows * w * w, 4.0 * m_rows * w + 8.0 * w * w + 48.0 * w,
               PEAK_INT8_TC, err, counter="fused_encoder_mlp_block",
               paths=("vitl336_int8_serve", "vitl336_split"))
    del h, blk
    torch.cuda.empty_cache()

    # -- quant_rows at these paths' shape: the f32 attention output of the whole
    # int8 block's rungs ----------------------------------------------------------------
    x = torch.randn(m_rows, w, generator=dgen, device=dev)
    name = f"quant_rows {m_rows} x {w}"
    err = compare_int8(name, *_cuda.quant_rows(x), *int8.quant_rows_plain(x), TOL_FLIPS_QUANT)
    kernel_row(rows, name, f"{pa}:158", "dfd_clip_tpu_torch/csrc/quant_rows.cu",
               time_ms(lambda: _cuda.quant_rows(x)),
               time_ms(lambda: int8.quant_rows_plain(x), iters=3, warmup=1), None,
               4.0 * m_rows * w, 5.0 * m_rows * w + 4.0 * m_rows, PEAK_F32, err,
               counter="quant_rows", paths=("vitl336_full", "vitl336_full_attn"))
    # -- layer_norm_quant at these paths' shape, LN1 (bf16 h) and LN2 (f32 hmid) ---------
    ln = {"scale": 1 + 0.3 * torch.randn(w, generator=dgen, device=dev),
          "bias": 0.1 * torch.randn(w, generator=dgen, device=dev)}
    check_layer_norm_quant(rows, x.to(bf), ln)
    check_layer_norm_quant(rows, x, ln)
    # -- layer_norm_rows at these paths' shape (the bf16 towers' LN1 / LN2) ------------
    check_layer_norm(rows, f"layer_norm_rows {m_rows} x {w}", x.to(bf), ln, VITL336_PATHS)
    del x
    torch.cuda.empty_cache()

    # -- the decoder over the 576-row export (L = 11,520), in its three forms ------------
    check_decoder_attention(rows, "fused_decoder_attention 16 heads, L 11520", gen, dev, 16,
                            t_out, t_out, VITL336_PATHS + VITL336_LADDER, forms=True)


def check_tower_wide_kernels(rows: list) -> None:
    """The ViT-L int8 ladder's kernels at its shapes (320 frames, width 1024,
    16 heads): the whole int8 block at 257 and 577 tokens with int8
    attention "0" and "1"; and the 24-layer int8 tower (keep 18-23) at 257
    and 577 tokens in each int8 attention mode, against the per-layer kernel
    chain (the same block bodies; with bf16 attention each layer's stage on
    the same input as well) and the plain chain, with the plain chain's
    drift from the kernel chain printed layer by layer. (The int8 attention
    at these shapes is held and timed in `[kernels int8 sweep]`.)"""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import tower
    from dfd_clip_tpu_torch.tools import bench_tower_stages as bts

    n, w, hh, d, bf = CLIPS * FRAMES, 1024, 16, 64, torch.bfloat16
    dev = torch.device("cuda")
    dgen = torch.Generator(device=dev).manual_seed(12)
    row = functools.partial(kernel_row, rows)
    pa = "dfd_clip_tpu/ops/pallas_attention.py"

    def attn_time(frames, t, int8_attn):
        """(attention operations' time at peak, their count) of one layer."""
        ops = 4.0 * frames * hh * t * t * d
        if int8_attn == "0":
            return ops / PEAK_BF16_TC, ops
        return ops / 2 / PEAK_INT8_TC + ops / 2 / (
            PEAK_BF16_TC if int8_attn == "qk" else PEAK_INT8_TC), ops

    # -- the whole int8 block at width 1024 ------------------------------------------------
    blk = random_block(torch.Generator().manual_seed(13), dev, int8=True, cfg=clip_vit.VIT_L14)
    args = (blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"], hh, d)
    for t, arch in ((WIDE_TOKENS, "vitl"), (L336_TOKENS, "vitl336")):
        h = torch.randn(n, t, w, generator=dgen, device=dev).to(bf)
        m_rows, t_out = n * t, t - 1
        bufs = [(torch.empty(2, n, t_out, w, dtype=bf, device=dev),
                 torch.empty(2, n, t_out, w, dtype=bf, device=dev)) for _ in range(2)]
        for mode in ("0", "1"):
            name = f"fused_encoder_block int8{' attn' if mode == '1' else ''} {t} x {w}"
            kw = dict(export=True, drop_cls=True, int8_gemm=True, int8_attn=mode)
            got = eb.fused_encoder_block(h, *args, export_into=(*bufs[0], 1, 2), **kw)
            want = eb.fused_encoder_block_plain(h, *args, export_into=(*bufs[1], 1, 2), **kw)
            err = compare(f"{name} h", got[0], want[0], TOL_ENCODER)
            for i, part in ((1, "k"), (2, "v")):
                err = max(err, compare(f"{name} {part}", got[i][1], want[i][1], TOL_ENCODER))
            del got, want
            # operations: the four W8A8 products and the attention; bytes: h
            # in and out, the int8 weights and their scales, biases and
            # LayerNorms, the K/V export
            ops_t = 24.0 * m_rows * w * w / PEAK_INT8_TC + attn_time(n, t, mode)[0]
            nb = 4.0 * m_rows * w + 12.0 * w * w + 4.0 * 22 * w + 4.0 * n * t_out * w
            row(name, f"{pa}:1212", "dfd_clip_tpu_torch/ops/encoder_block.py",
                time_ms(lambda: eb.fused_encoder_block(h, *args, export_into=(*bufs[0], 1, 2),
                                                       **kw), iters=5),
                time_ms(lambda: eb.fused_encoder_block_plain(
                    h, *args, export_into=(*bufs[1], 1, 2), **kw), iters=1, warmup=1),
                None, 0, 0, 0, err, counter="fused_encoder_block",
                paths=(f"{arch}_full_attn" if mode == "1" else f"{arch}_full",),
                bound=(max(ops_t, nb / HBM) * 1e3, "operations" if ops_t >= nb / HBM else "bytes"))
        del h, bufs
    del blk
    torch.cuda.empty_cache()

    # -- the 24-layer int8 tower, keep 18-23 ---------------------------------------------------
    blocks = tower_params(torch.Generator().manual_seed(14), dev, clip_vit.VIT_L14)
    first, last = LADDER_KEEP[0], LADDER_KEEP[-1]
    nsel = len(LADDER_KEEP)
    for t, arch in ((WIDE_TOKENS, "vitl"), (L336_TOKENS, "vitl336")):
        h = torch.randn(n, t, w, generator=dgen, device=dev).to(bf)
        m_rows = n * t
        print(f"  tower at {t} tokens: grid {[_cuda.tower_grid(t, True, a) for a in ('0', '1', 'qk')]}"
              f" blocks (int8 attention 0, 1, qk) on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
        for mode in ("0", "1", "qk"):
            label = {"0": "", "1": " attn", "qk": " qk"}[mode]
            name = f"fused_encoder_tower int8{label} 24 layers {t}"
            kw = dict(keep=LADDER_KEEP, drop_cls=True, int8_gemm=True, int8_attn=mode)
            k, v = tower.fused_encoder_tower(h, blocks, hh, d, **kw)
            # the per-layer kernel chain (a launch a kernel: the bodies the
            # tower's stages run), keeping h after every layer
            kc, vc = torch.empty_like(k), torch.empty_like(v)
            x, hs = h, []
            for i in range(last):
                into = (kc, vc, i - first, nsel) if i >= first else None
                b = blocks[i]
                out = eb.fused_encoder_block(x, b["ln_1"], b["attn"], b["ln_2"], b["mlp"], hh, d,
                                             export=into is not None, drop_cls=True,
                                             export_into=into, int8_gemm=True, int8_attn=mode)
                x = out[0] if into is not None else out
                hs.append(x)
            eb.fused_encoder_attn_block(x, blocks[last]["ln_1"], blocks[last]["attn"], hh, d,
                                        drop_cls=True, last_only=True,
                                        export_into=(kc, vc, nsel - 1, nsel), int8_gemm=True)
            hold_chain(name, ((k, kc), (v, vc)))
            print(f"  {name} vs the per-layer kernel chain, layers {first}-{last}: "
                  + " ".join(f"{max(rel_err(k[j], kc[j]), rel_err(v[j], vc[j])):.2e}"
                             for j in range(nsel)), flush=True)
            chain_ms = time_ms(lambda: bts.kernel_chain(h, blocks, hh, LADDER_KEEP, True, mode,
                                                        kc, vc), iters=2, warmup=1)
            del kc, vc, x
            if mode == "0":   # each stage on the same input as the per-layer kernels
                tower_stage_holds(name, blocks, [h] + hs[:-1], hh, d, True, mode)
            # the plain chain, layer by layer as fused_encoder_tower_plain runs it
            # (timed, one run), and its drift from the kernel chain after each layer
            kp, vp = torch.empty_like(k), torch.empty_like(v)
            drift = []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            xp = h
            for i in range(last):
                into = (kp, vp, i - first, nsel) if i >= first else None
                b = blocks[i]
                out = eb.fused_encoder_block_plain(xp, b["ln_1"], b["attn"], b["ln_2"], b["mlp"],
                                                   hh, d, export=into is not None, drop_cls=True,
                                                   export_into=into, int8_gemm=True,
                                                   int8_attn=mode)
                xp = out[0] if into is not None else out
                drift.append(rel_err(hs[i], xp))
            eb.fused_encoder_attn_block_plain(xp, blocks[last]["ln_1"], blocks[last]["attn"], hh,
                                              d, drop_cls=True, last_only=True,
                                              export_into=(kp, vp, nsel - 1, nsel),
                                              int8_gemm=True)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            del hs, xp
            print(f"  {name}: drift of the kernel chain from the plain chain, h after each "
                  f"layer (rel of the max): " + " ".join(f"{e:.2e}" for e in drift), flush=True)
            err = compare(f"{name} k", k, kp, TOL_TOWER, defer=True)
            err = max(err, compare(f"{name} v", v, vp, TOL_TOWER, defer=True))
            del kp, vp, k, v
            # operations: 23 whole blocks and the K/V columns of layer 23;
            # bytes: h in, every weight, scale, bias and LayerNorm read once,
            # the six layers' K/V out
            ops_t = (23 * 24.0 + 4.0) * m_rows * w * w / PEAK_INT8_TC + 23 * attn_time(n, t, mode)[0]
            layer_bytes = 12.0 * w * w + 4.0 * 13 * w + 4.0 * 9 * w
            nb = 2.0 * m_rows * w + 23 * layer_bytes + 2.0 * w * w + 4.0 * 6 * w \
                + 2 * 2.0 * nsel * n * (t - 1) * w
            ms = time_ms(lambda: tower.fused_encoder_tower(h, blocks, hh, d, **kw), iters=3,
                         warmup=1)
            row(name, "dfd_clip_tpu/ops/pallas_tower.py:425",
                "dfd_clip_tpu_torch/csrc/encoder_tower.cu", ms,
                plain_ms, None, 0, 0, 0, err, counter="fused_encoder_tower",
                paths=(f"{arch}_tower{label.replace(' ', '_')}",),
                bound=(max(ops_t, nb / HBM) * 1e3, "operations" if ops_t >= nb / HBM else "bytes"))
            tower_timings(name, h, blocks, hh, LADDER_KEEP, True, mode, ms, chain_ms,
                          rules=mode == "0")
        del h
        torch.cuda.empty_cache()
    del blocks
    torch.cuda.empty_cache()


def ladder_counts(rung: str) -> dict:
    """A ladder rung's encoder and decoder launches a predict (24 layers: 23
    blocks and the last kept layer's K/V columns)."""
    decoder = {"fused_decoder_attention": 6, "decoder_boundary": 7}
    if rung.startswith("tower"):
        return {**TOWER_COUNTS, **decoder}
    if rung == "split":   # the MLP's rows quantised in c_fc: no quant_rows
        return {"fused_encoder_attn_block": 24, "fused_encoder_mlp_block": 23,
                "fused_encoder_block": 0, "fused_encoder_tower": 0, "encoder_attention": 23,
                "encoder_attention_int8": 0, "gemm_s8_quant": 23, "quant_rows": 0,
                "layer_norm_rows": 0, **decoder}
    int8_attn = rung == "full_attn"
    return {"fused_encoder_block": 23, "fused_encoder_attn_block": 1,
            "fused_encoder_mlp_block": 0, "fused_encoder_tower": 0,
            "encoder_attention": 0 if int8_attn else 23,
            "encoder_attention_int8": 23 if int8_attn else 0, "gemm_s8_quant": 23,
            "quant_rows": 23, **NO_BF16_ROWS, **decoder}


def ladder_paths(card: str) -> dict:
    """The megaL ladder on ViT-L/14 and ViT-L/14@336px (24 layers, keep
    18-23, compute_int8, one parameter seed each): each rung of LADDER_RUNGS
    through a Scorer answers the four requests, counters zeroed before and
    read after; on the last request's batch its logits and P(fake) are held
    against the plain route in f32, compared with the split control's by
    cosine (gated without int8 attention), the tower rungs' K/V held to
    their per-layer kernel chain (block "full", the same int8 attention);
    a device-resident predict is timed and traced. Returns the counts by
    path."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.serve import Scorer

    requests = make_requests()
    x, m = last_batch(requests)
    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    counts = {}
    int8_mode = {"temporal_position": 1, "compute_int8": 1}
    enc = None
    for arch, tag in LADDER_ARCHS:
        cfg = {"architecture": arch, "decode_indices": list(LADDER_KEEP), "op_mode": int8_mode}
        base = detector(**cfg)
        tokens = base.vit_cfg.num_tokens
        if base.layer_indices != LADDER_KEEP or base.vit_cfg.layers != 24:
            raise SystemExit(f"FAIL {tag} ladder: kept layers {base.layer_indices}")
        gen = torch.Generator().manual_seed(20)
        if enc is None:   # ViT-L/14's tower; the 336-pixel one shares its blocks
            enc = clip_vit.init_clip_vision(gen, base.vit_cfg)
        else:
            enc = {**enc, "positional_embedding": base.vit_cfg.width ** -0.5 * torch.randn(
                tokens, base.vit_cfg.width, generator=gen)}
        raw = to_card(base.init_params(gen, encoder_params=enc))
        det32 = copy.copy(base)
        det32.compute_dtype = torch.float32
        params32 = det32.prepare_params(raw)
        plain, ref = {}, None
        for rung, kernels in LADDER_RUNGS.items():
            path = f"{tag}_{rung}"
            print(f"[{tag} ladder {rung}] {arch}, EncoderKernels({kernels}), compute_int8, keep "
                  f"18-23", flush=True)
            det = detector(kernels, **cfg)
            scorer = Scorer(det, raw, batch_size=CLIPS)
            counts[path] = answer(scorer, requests, card, path)
            used = ("fused_encoder_tower",) if kernels.get("tower") else (
                "gemm_s8", "gemm_s8_quant", "layer_norm_quant")
            check_counts(path, counts[path], ladder_counts(rung), len(requests), used=used)
            got = scorer.predict(scorer.params, xd, md)
            # the plain route in f32: a tower rung's is its whole-block chain's
            # (the same plain functions, and neither export has pad rows here)
            key = (kernels.get("tower") or kernels.get("block") == "full",
                   kernels.get("int8_attn", "0"))
            if key not in plain:
                det32.encoder_kernels = det.encoder_kernels
                with plain_versions():
                    plain[key] = det32.predict(params32, xd, md)[0][0]
            want = plain[key]
            logit_err, dp = rel_err(got, want), p_delta(got, want)
            print(f"  {path} vs the f32 plain route: logits {logit_err:.3e} (tol "
                  f"{TOL_LOGITS_F32:g}), |dP(fake)| {dp:.3e} (tol {TOL_PFAKE_F32:g})", flush=True)
            if not torch.isfinite(got).all() or logit_err > TOL_LOGITS_F32 or dp > TOL_PFAKE_F32:
                fail(f"FAIL {path}: logits {logit_err:.3e} / dP {dp:.3e} from the f32 plain "
                     f"route", True)
            if ref is None:
                ref = got.float()   # the split control's logits
            else:
                cos = F.cosine_similarity(got.float().flatten(), ref.flatten(), dim=0).item()
                gated = kernels.get("int8_attn", "0") == "0"
                print(f"  {path} vs the split control, same params: cosine {cos:.6f}"
                      + (f" (tol {TOL_COSINE:g})" if gated else " (recorded)"), flush=True)
                if gated and not cos >= TOL_COSINE:
                    fail(f"FAIL {path}: cosine to the split control {cos:.6f} < {TOL_COSINE:g}",
                         True)
            if kernels.get("tower"):
                chain = detector({"block": "full", "int8_attn": kernels.get("int8_attn", "0")},
                                 **cfg)
                frames = det.preprocess(xd)
                kv = det.encode_kv(scorer.params, frames)
                kv_chain = chain.encode_kv(scorer.params, frames)
                hold_chain(f"{path} K/V", ((kv["k"], kv_chain["k"]), (kv["v"], kv_chain["v"])))
                del frames, kv, kv_chain
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=3, warmup=1)
            print(f"  device-resident {path} predict: {ms:.2f} ms per {CLIPS}-clip batch "
                  f"({CLIPS * 1e3 / ms:.2f} clips/s), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, on {card}", flush=True)
            profile_device(f"{path} predict", lambda: scorer.predict(scorer.params, xd, md))
            del scorer, det, got
            torch.cuda.empty_cache()
        del raw, params32, plain, ref
        torch.cuda.empty_cache()
    return counts


def check_study_kernels(rows: list) -> None:
    """The tools' kernels at the tools' shapes. The study attention at
    (320, 197, 12 x 64) bf16 (tools/bench_attention.py's inputs, seed 0)
    through the port tool's VARIANTS, one variant a kernel body and packed
    site (STUDY_ROWS): each held to the tool's own check (max abs error <
    0.05 against xla_einsum on the first 4 frames) and to its plain version
    (TOL_ENCODER of the max), with the SDPA yardstick. The probe's two
    entries at (63040, 768) x 12 layers (its inputs): bit-equal to each
    other, each within TOL_ENCODER of the plain chain, each timed by CUDA
    events and by the profiler's device time, with its share of the
    operations bound, beside 12 chained torch.matmul (the yardstick) timed
    in the same run; the launches' geometry and the card's co-resident
    clusters printed."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import gemm_chain as gc
    from dfd_clip_tpu_torch.ops import study_attention as sa
    from dfd_clip_tpu_torch.tools import bench_attention as tba
    from dfd_clip_tpu_torch.tools import bench_megakernel_probe as tbm

    dev = torch.device("cuda")
    q, k, v = tba.make_inputs(device=dev)
    n, t, hh, d = q.shape
    ref4 = tba.VARIANTS["xla_einsum"](q[:4], k[:4], v[:4]).float()
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    flops, nbytes = 4.0 * n * hh * t * t * d, 2.0 * 4 * n * t * hh * d
    for variant, line, mode in STUDY_ROWS:
        fn = tba.VARIANTS[variant]
        name = f"study_attention {mode} ({variant})"
        got = fn(q, k, v)
        tool_err = (got[:4].float() - ref4).abs().max().item()
        print(f"  {name}: the tool's check, max abs err {tool_err:.3e} from xla_einsum "
              f"(tol 0.05)", flush=True)
        if not tool_err < 0.05:
            raise SystemExit(f"FAIL {name}: the tool's check, max err {tool_err}")
        err = compare(name, got, sa.study_attention_plain(q, k, v, mode), TOL_ENCODER)
        del got
        kernel_row(rows, name, f"tools/bench_attention.py:{line}",
                   "dfd_clip_tpu_torch/csrc/study_attention.cu", time_ms(lambda: fn(q, k, v)),
                   time_ms(lambda: sa.study_attention_plain(q, k, v, mode), iters=3, warmup=1),
                   sdpa, flops, nbytes, PEAK_F32 if mode == "f32" else PEAK_BF16_TC, err,
                   counter="study_attention", paths=("tool_attention",))
    del q, k, v, q4, k4, v4, ref4

    ws = tbm.make_weights(dev)
    h0 = tbm.bf16(np.random.default_rng(0).normal(size=(tbm.ROWS, tbm.W)) * 0.02, dev)
    per_layer, mega = gc.gemm_chain_per_layer(h0, ws), gc.gemm_chain_megakernel(h0, ws)
    same = torch.equal(per_layer, mega)
    print(f"  gemm_chain per-layer vs one launch: bit-equal {same}", flush=True)
    if not same:
        raise SystemExit("FAIL gemm_chain: the two entries are not bit-equal")
    plain = gc.gemm_chain_plain(h0, ws)
    err = compare("gemm_chain", mega, plain, TOL_ENCODER)
    del per_layer, mega, plain

    def library():
        return chained_matmul(h0, ws)

    rows_, width, layers = h0.shape[0], h0.shape[1], ws.shape[0]
    geo = _cuda.chain_geometry(rows_, width, layers)
    print(f"  gemm_chain megakernel geometry: {geo['panels']} panels of 128 rows, {geo['tiles']} "
          f"column tiles of 256 a layer, {geo['units']} units of two panels on {geo['grid']} "
          f"CTAs ({geo['clusters']} co-resident clusters of two), {geo['smem']} B shared memory",
          flush=True)
    flops = 2.0 * rows_ * width * width * layers
    nbytes = 2.0 * 2 * rows_ * width + 2.0 * layers * width * width
    bound, _ = bound_ms(flops, nbytes, PEAK_BF16_TC)
    plain_ms = time_ms(lambda: gc.gemm_chain_plain(h0, ws), iters=3, warmup=1)
    entries = (("gemm_chain per_layer_calls", 60, gc.gemm_chain_per_layer, "gemm_chain_per_layer",
                layers),
               ("gemm_chain megakernel", 90, gc.gemm_chain_megakernel, "gemm_chain_megakernel", 1))
    # the two entries and the yardstick in turns, each timed twice
    times = {name: [] for name, *_ in entries}
    lib = []
    for _ in range(2):
        lib.append(time_ms(library))
        for name, _, fn, _, _ in entries:
            times[name].append(time_ms(lambda: fn(h0, ws)))
    lib_ms = min(lib)
    def on_device(dev, traced, issued):
        # a trace that lost a launch's row measured nothing
        return (f"{dev:.4f} ms on the device ({traced} of {issued} launches traced)"
                if dev is not None else
                f"device time not measured ({traced} of {issued} launches traced)")

    traces = probe_traces_child()
    lib_dev = traces["library"]
    print(f"  12 x torch.matmul: {' / '.join(f'{t:.4f}' for t in lib)} ms by events, "
          f"{on_device(*lib_dev)}", flush=True)
    for name, line, fn, counter, launches in entries:
        ms = min(times[name])
        dev = traces[counter]
        shares = f"{bound / ms:.3f} of it by events"
        if dev[0] is not None:
            shares += f", {bound / dev[0]:.3f} on the device"
        ratio = f"{ms / lib_ms:.3f} x 12 torch.matmul by events ({lib_ms:.4f} ms)"
        if dev[0] is not None and lib_dev[0] is not None:
            ratio += f", {dev[0] / lib_dev[0]:.3f} on the device"
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms by events, "
              f"{on_device(*dev)}; bound {bound:.4f} ms (operations): {shares}; {ratio}",
              flush=True)
        kernel_row(rows, name, f"tools/bench_megakernel_probe.py:{line}",
                   "dfd_clip_tpu_torch/csrc/gemm_chain.cu", ms, plain_ms, lib_ms, flops, nbytes,
                   PEAK_BF16_TC, err, counter=counter, paths=("tool_probe",))


def chained_matmul(h, ws):
    """The probe's yardstick: len(ws) chained torch.matmul calls."""
    import torch

    for w_ in ws:
        h = torch.matmul(h, w_)
    return h


def probe_traces() -> None:
    """The device times of the probe's calls at (63040, 768) x 12 on its
    inputs (12 x torch.matmul, gemm_chain_per_layer, gemm_chain_megakernel),
    each from launches_ms, printed as one JSON line {name: [ms or null,
    rows traced, launches issued]}. Run in a process of its own by
    probe_traces_child."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import gemm_chain as gc
    from dfd_clip_tpu_torch.tools import bench_megakernel_probe as tbm

    _cuda.library()
    dev = torch.device("cuda")
    ws = tbm.make_weights(dev)
    h0 = tbm.bf16(np.random.default_rng(0).normal(size=(tbm.ROWS, tbm.W)) * 0.02, dev)
    print(json.dumps({
        "library": launches_ms(lambda: chained_matmul(h0, ws)),
        "gemm_chain_per_layer": launches_ms(lambda: gc.gemm_chain_per_layer(h0, ws), len(ws)),
        "gemm_chain_megakernel": launches_ms(lambda: gc.gemm_chain_megakernel(h0, ws), 1)}))


def probe_traces_child() -> dict:
    """probe_traces in a new process (the kernels already built), waited
    for: late in this script's run the profiler lost device rows of these
    traces (a whole one was rare), while the traces of a process that has
    taken none before held every launch."""
    here = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.probe_traces()"],
                         cwd=here, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the probe's traces (exit {res.returncode}):\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def tool_paths() -> dict:
    """The port's tools as a user runs them (``python -m
    dfd_clip_tpu_torch.tools.bench_attention``, ``... .bench_megakernel_probe``):
    each main() with every launch counter zeroed just before and read just
    after; each checks its own results and prints its times. Returns the
    counts by path."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.tools import bench_attention as tba
    from dfd_clip_tpu_torch.tools import bench_megakernel_probe as tbm

    counts = {}
    for path, main_fn, used in (("tool_attention", tba.main, ("study_attention",)),
                                ("tool_probe", tbm.main,
                                 ("gemm_chain_per_layer", "gemm_chain_megakernel"))):
        print(f"[{path}]", flush=True)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        if main_fn([]) != 0:
            raise SystemExit(f"FAIL {path}: the tool exited nonzero")
        torch.cuda.synchronize()
        counts[path] = _cuda.launches()
        check_counts(path, counts[path], {}, 1, used=used)
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
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pfake-seeds", type=int, default=PFAKE_SEEDS,
                    help="parameter seeds each 257-token path is held on (default "
                         f"{PFAKE_SEEDS}; ViT-L/14@336px {L336_SEEDS} unless another N is "
                         "given); more widen the P(fake) noise readings")
    args = ap.parse_args()
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

    global BUILD_S
    t0 = time.perf_counter()
    lib_path, log = _cuda.build()
    _cuda.library()
    BUILD_S = time.perf_counter() - t0
    print(f"[build] {BUILD_S:.2f} s -> {lib_path.name}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            print("  " + line.strip(), flush=True)
    serialised = wgmma_serialised(log, ("gemm.cu", "gemm_s8.cu", "gemm_s8_quant.cu",
                                        "encoder_attention_s8.cu", "study_attention.cu",
                                        "gemm_chain.cu"))
    if serialised:
        raise SystemExit("FAIL the GEMMs', the int8 attention's, the study attention's or the "
                         "chained GEMM's wgmma products were serialised:\n"
                         + "\n".join(serialised))
    for line in wgmma_serialised(log, tuple(p.name for p in _cuda.CSRC.glob("encoder_tower*.cu"))):
        print(f"  [the tower's ptxas] {line[:200]}", flush=True)

    rows: list = []
    print("[kernels] flagship shapes, bf16", flush=True)
    check_kernels(rows)
    print("[kernels sweep] the encoder attention at 1 to 1025 tokens, both entries and outputs",
          flush=True)
    check_attention_sweep()
    print("[kernels int8] flagship shapes, W8A8 and int8_rows K/V", flush=True)
    check_int8_kernels(rows)
    print("[kernels int8 sweep] the int8 encoder attention at 1 to 1025 tokens in both modes, "
          f"then at the paths' shapes beside the bf16 attention; every time on {card}",
          flush=True)
    check_int8_attention_sweep(rows)
    print(f"[kernels gemm] gemm and gemm_s8 at every path shape; every time on {card}",
          flush=True)
    check_gemm_kernels()
    counts = {}
    print("[serve path] Scorer over ViT-B/16, 20 frames, keep 6-11, bf16, batch 16", flush=True)
    counts["serve"] = serve_path(card)
    print("[serve http] Scorer.from_run_dir on a run directory (ViT-B/16, 20 frames, keep "
          "6-11, bf16, batch 16), HTTP on 127.0.0.1, four synthetic:// videos and a video "
          "file's bytes; inference.main on the same run", flush=True)
    counts["serve_http"] = serve_http_path(card)
    print("[int8 serve path] Scorer over ViT-B/16, 20 frames, keep 6-11, compute_int8, "
          "batch 16", flush=True)
    counts["int8_serve"], counts["int8_rows"] = int8_serve_path(card)
    print(f"[train path] Trainer over ViT-B/16, 20 frames, keep 6-11, bf16, batch "
          f"{TRAIN_CLIPS}, dropout 0.5, SGD + OneCycle, {TRAIN_STEPS} steps", flush=True)
    counts["train"] = train_path(card)
    print("[kernels wide] 257 tokens: ViT-L/14 and DINOv2 B/14 attention, int8 split pair",
          flush=True)
    check_wide_kernels(rows)
    print("[vit-l serve path] Scorer over ViT-L/14, 20 frames, keep 0-20 stride 4, bf16, "
          "batch 16", flush=True)
    counts["vitl_serve"], counts["vitl_int8_serve"] = vitl_serve_path(
        card, args.pfake_seeds)
    print("[dinov2 serve path] Scorer over DINOv2 ViT-B/14, 20 frames, keep 6-11, bf16, "
          "batch 16", flush=True)
    counts["dinov2_serve"] = dinov2_serve_path(card, args.pfake_seeds)
    print("[kernels variants] flagship shapes: bf16 whole block, int8 attention, tower",
          flush=True)
    check_variant_kernels(rows)
    print("[variant serve paths] Scorers over ViT-B/16, 20 frames, keep 6-11, batch 16, "
          "through the encoder's alternative kernels", flush=True)
    counts.update(variant_serve_paths(card))
    print("[kernels 577] ViT-L/14@336px shapes: the encoder attention, the int8 "
          "split pair, the decoder over L = 11520", flush=True)
    check_577_kernels(rows)
    print("[vit-l@336 serve path] Scorer over ViT-L/14@336px, 20 frames, keep 0-20 stride 4, "
          "bf16, batch 16", flush=True)
    seeds336 = L336_SEEDS if args.pfake_seeds == PFAKE_SEEDS else args.pfake_seeds
    counts["vitl336_serve"], counts["vitl336_int8_serve"] = vitl_serve_path(
        card, seeds336, arch="ViT-L/14@336px", label="vit-l@336")
    print("[kernels tower wide] the ViT-L int8 ladder's shapes: the int8 attention above 320 "
          "tokens, the whole int8 block and the 24-layer tower at width 1024, 257 and 577 "
          f"tokens; every time on {card}", flush=True)
    check_tower_wide_kernels(rows)
    print("[vit-l ladder] ViT-L/14 and ViT-L/14@336px, 20 frames, keep 18-23, compute_int8, "
          "batch 16, through each encoder form", flush=True)
    counts.update(ladder_paths(card))
    print("[kernels study] the tools' shapes: the study attention modes at (320, 197, 12 x 64), "
          "the megakernel probe's pair at (63040, 768) x 12 layers", flush=True)
    check_study_kernels(rows)
    counts.update(tool_paths())

    if DEFERRED:
        raise SystemExit("\n".join(DEFERRED))
    for r in rows:
        key, paths = r.pop("counter"), r.pop("paths")
        keys = key if isinstance(key, tuple) else (key,)
        r["launches_by_path"] = {p: sum(counts[p].get(k, 0) for k in keys) for p in paths}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
