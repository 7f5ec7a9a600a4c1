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
   traced with torch.profiler; then the training CLI (`[train cli]`):
   python -m dfd_clip_tpu_torch.main's main, in this process, on
   configs/deepfake/deepfake.yaml (the 768-x-768-z0 adapter on the
   unpadded export, normal+frame augmentation of FFPP contrast pairs)
   with its roots, scales, max_steps (4), evaluation, training-evaluation
   and checkpoint intervals (2) and tracking directory changed, each
   change printed, over cv2-written 224-pixel MJPG FFPP, DFDC and CDF
   trees: each step's loss finite and its lr schedule(step), 12 / 11 / 6 /
   6 launches a step and 12 / 11 / 6 / 7 an evaluation predict, the
   decoder backward's plain version never called, two evaluations
   reporting accuracy and roc_auc for ffpp, dfdc and cdf, the run
   directory's setting.yaml, best_weights.pt, last_weights.pt,
   metrics.jsonl and checkpoints/; a run resumed from the run's step-2
   checkpoint to step 4 bit-equal to the uninterrupted run (`[train cli
   resume]`); inference.main on the run directory, each video's P(fake)
   equal to Scorer.from_run_dir's on the same clips (`[train cli
   inference]`); a step with a non-z0 768-x-768 adapter, its conditioning
   recorded, every backward call's dq / dpos / dK / dV on its own inputs
   and every gradient leaf through the decoder kernels held to the plain
   versions, timed, its peak memory read and traced (`[train cli adapter
   step]`); the backward's dK/dV form is held in the kernel phase at L =
   3,920 unpadded and 4,000 stacked;
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
10. runs the Detector's remaining options: the ViT-g/14 kernels at their
   shapes (`[kernels boundary wide]`: the decoder boundary at width 1536, MLP
   6144, in its streamed form, its three forms held and timed as at the
   narrower widths, which keep the resident form; the encoder attention at
   (320, 257, 24 x 64); layer_norm_rows at (82240, 1536); the decoder
   attention at 24 heads over L = 5,120); DINOv2 ViT-g/14 serving
   (`[dinov2 giant serve]`, 40 layers, keep 34-39, one seed held against the
   f32 plain route, launches a predict from the code: 39 encoder attention,
   79 layer_norm_rows, 6 decoder attention, 7 boundary); the flagship with
   kv_dtype "int8" (`[kv int8 serve]`: four requests counted, held to its
   plain route, |dP(fake)| against the bf16-K/V predict recorded);
   device-resident Trainer steps with compute_int8 and compute_int8 +
   int8_rows (`[int8 train]`, counted, every decoder leaf held to the
   decoder-plain route, timed and traced beside the bf16 step); a step and
   a predict with each decoder option (`[decoder options]`: attn_mode
   "frame", "temporal", "temporal+frame", aug_query; counted, the predict
   held to its plain route); and the four int8 AUROC gates at flagship
   width (`[int8 gates]`, dfd_clip_tpu_torch/tools/int8_gates.py, JAX's
   thresholds);
11. checks the encoder's alternative kernels at the flagship shapes
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
12. drives the six paths of those kernels (`[variant serve paths]`): a
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
13. checks the 577-token kernels at CLIP ViT-L/14@336px's shapes
   (`[kernels 577]`): the encoder attention at (320, 577, 16 x 64)
   through both entries, bf16 and f32 out, each against its plain version
   with a scaled_dot_product_attention yardstick, the int8 split pair at
   (320, 577, 1024), quant_rows on the whole int8 block's (184640, 1024)
   attention output, layer_norm_rows on (184640, 1024) rows, and the
   decoder attention over L = 20 x 576 keys;
14. drives ViT-L/14@336px serving (`[vit-l@336 serve path]`, keep 0, 4, ...,
   20) as in 8, on one parameter seed (`--pfake-seeds` N other than the
   default reads N here too): the four requests in bf16 and in
   compute_int8 (20 encoder attention launches a predict), logits and
   P(fake) held
   against the f32 plain route, int8 against bf16 by cosine, a
   device-resident predict timed, its peak memory read and traced;
15. checks the ViT-L int8 ladder's kernels at its shapes (`[kernels tower
   wide]`, 320 frames, width 1024, 16 heads): the whole int8 block at 257 and
   577 tokens with int8 attention "0" and "1"; the 24-layer int8 tower
   (keep 18-23) at 257 and 577 tokens in each int8 attention mode, against
   the per-layer kernel chain (bit-level, as in 11; with bf16 attention
   each layer's stage on the same input too) and the plain chain, timed
   beside the chain with its chunk, grid, grid barriers and stage clock
   (the chunk rules are timed at ViT-B in 11, not here, to hold the run's
   time), printing the kernel chain's drift from the plain chain layer by
   layer;
16. drives the JAX package's megaL ladder (`[vit-l ladder]`,
   tools/bench_r3_ladder.py:330-393): on ViT-L/14 and ViT-L/14@336px (cut
   from 24 to 12 layers, keep 6-11, compute_int8, one parameter seed;
   [kernels tower wide] keeps the 24-layer tower's timings) each rung, the
   split control, block "full" with int8 attention "0" and "1" and the
   tower with "0", "1" and "qk", answers the four requests through a
   Scorer, counters zeroed before and read after, its launches asserted;
   the last request's batch is held against the plain route in f32, its
   logits compared with the split control's by cosine (gated without int8
   attention), each tower rung's K/V held to its per-layer kernel chain
   (bit-level, as in 11);
   a device-resident predict is timed and traced;
17. checks the tools' kernels (`[kernels study]`): every numerics mode of
   the study attention at (320, 197, 12 x 64) through the port tool's
   variants, each against the tool's own check and its plain version, and
   the megakernel probe's two entries at (63040, 768) x 12 layers,
   bit-equal to each other and held to the plain chain, each timed by CUDA
   events and by its device time in a trace, with its share of the
   operations bound beside 12 chained torch.matmul; then runs both
   ported tools as a user does (`[tool_attention]`, `[tool_probe]`),
   counters zeroed before and read after each;
18. runs the SSL slice (DINOv2 pretraining and its evaluation): the
   encoder attention at the SSL crops' shapes, (64, 257, 12 x 64) and (256,
   50, 12 x 64), against its plain version with the SDPA yardstick, and its
   autograd Function's dq / dk / dv against autograd through
   plain_attention in f32 (`[kernels ssl]`); python -m
   dfd_clip_tpu_torch.ssl_train's main in this process on
   configs/ssl/base.yaml at full width and depth (ViT-B/14, out_dim 65536,
   batch 32, 2 x 224 globals and 8 x 98 locals, remat 1, fsdp 1) over
   --synthetic 256 for 6 steps, with warmup, the prototype freeze, the
   teacher temperature's warmup and the checkpoint interval changed as
   printed: every step's losses finite, counters zeroed before and read
   after each step (60 encoder attention launches: 36 at 257 tokens, 24 at
   50), last_v / last_g held through the freeze and moved after it, each
   step timed by CUDA events and on the host clock with its peak memory
   (`[ssl train]`); a run resumed from step 3's checkpoint against the
   uninterrupted run's teacher and student, reported bit-equal or by its
   largest difference (`[ssl train resume]`); a step traced in a child
   process (busy share); one forward_loss + gradient with drop_path_rate
   0.1 and one with centering sinkhorn_knopp held against the plain route
   (plain_attention under autograd) with the step's own sensitivity
   beside it, then each step counted (`[ssl train drop_path_rate]`, `[ssl
   train centering]`); python -m dfd_clip_tpu_torch.ssl_eval on the
   exported teacher over cv2-written labelled folders in every mode, 12
   launches a feature batch, the CLS features held to the plain route
   (`[ssl eval]`);
19. drives CLIP's zero-shot surface (`[zero shot]`): 8 prompts tokenised
   with the repo's BPE table (framing and EOT at each row's argmax
   checked), the text tower at ViT-B/16's (12 layers, width 512, 77 tokens,
   causal, f32) held to the same call on the CPU at TOL_TEXT; ViT-B/16's
   pooled image features (seeded ln_post and proj) on 16 images in bf16
   through the packed encoder attention kernel, 12 launches counted, held
   to the bf16 plain route (the f32 route's distance printed); RN50's
   features in bf16 (cuDNN convolutions, BN statistics away from 0 and 1)
   held to its f32 route at TOL_RN; the (16, 8) zero-shot logits held to
   the f32 route's at 2e-2 of their range exp(logit_scale) (random towers
   put the cosines near 0, so the max-relative reading is printed beside
   it), with their argmax agreement; each tower timed; then the
   encoder-analysis CLIs (`[analysis]`, python -m
   dfd_clip_tpu_torch.tools.analysis's main in this process on the [train
   cli] FFPP tree, ViT-B/16, 20 frames): kv-dist on one clip (its q / k / v
   / out held block by block to the bf16 plain route on the same input,
   each route's whole export recorded), semantic-patches
   over 4 samples, augment-impact with one setting over 2, comb-impact into
   a guide map, each counted (12 packed attention launches a clip forward)
   and its pickle checked, then a flagship predict with patch_mask type
   "guide" reading that map, counted and held to its plain route; the
   packed attention timed at both paths' shapes;
20. drives a W8A8 CLIP tower wider than 1024 (`[int8 wide]`): width 1280,
   20 heads of 64, 32 layers, patch 14 at 224 pixels (257 tokens), output
   1024, what models/weights.py:infer_clip_vit_config reads from a
   1280-wide, 32-block CLIP-layout state dict (OpenCLIP ViT-H/14's visual
   tree), its weights drawn on the card from a seeded CUDA generator and
   quantised by prepare_int8_params, keep 26-31, compute_int8 in bf16: the
   XLA linear_w8a8 composition (layers.linear_w8a8 on quant_rows' linear
   form and gemm_s8, the packed attention at 20 heads, layer_norm_rows).
   Its kernels at the path's shapes against their plain versions (the
   quantiser's int8 values equal, scales within TOL_SCALE; gemm_s8 at the
   four products bit for bit, torch._int_mm beside it; the attention with
   the SDPA yardstick); a 16-clip x 20-frame forward and its int8_rows form
   counted exactly (W8_COUNTS), each timed by CUDA events and, in a fresh
   process, traced and timed by its device time over two traced forwards
   (given where that trace holds twice a one-forward trace's rows); on 2
   clips every layer on the same input held to the plain W8A8 route at
   TOL_ENCODER, the whole export to the plain chain at TOL_TOWER
   (recorded, not held, where every layer holds and the chain alone reads
   past it) with the bf16 plain route's distance from f32 beside it, the
   int8 export to the bf16 composition by cosine (TOL_COSINE), and the
   int8_rows export, dequantised, to its plain route;
21. runs the native video decoder (`[native video]`) where this machine can
   build it (g++, FFmpeg's headers and libraries; data/native_video.py's
   own check): [serve http]'s /score video decoded natively beside opencv
   (probe equal, frames bit-equal at score_video's seeks), its YUV planes
   read into pinned buffers (read_frames_yuv_into), converted on the card
   by yuv420_to_rgb and scored by the flagship predict against the RGB
   frames (|dP(fake)| <= TOL_PFAKE); elsewhere one line names what is
   missing and that it did not run (no pass, and no later phase needs it);
22. drives the port on several ranks (`[multi rank]`, runtime.MeshRuntime
   over torch.distributed): the flagship predict through a one-rank NCCL
   runtime, bit-equal to the one-process predict; then two ranks spawned
   on this one card over Gloo (NCCL refuses two ranks on one device), each
   building the
   same seeded weights: at (data 1, seq 2) each rank encodes 10 of the 20
   frames and runs the decoder's partials kernel on its tokens, combined
   over the two ranks (the gathered P(fake) held to the one-process
   predict at TOL_PFAKE); a flagship Trainer step at batch 12 at (2, 1)
   and at (1, 2) against the one-process step on the same 12 clips: at
   dropout 0 its loss and every gradient leaf at the train-step limits, at
   dropout 0.5 (the masks drawn for the global batch from one seeded
   stream) its loss at that limit and each clip's within MR_CLIP_LOSS_TOL;
   SSL on configs/ssl/base.yaml (ViT-B/14 at full width and depth) at
   MR_SSL_IMAGES images a rank, with fsdp 0 for one step and then with
   fsdp 1 for MR_SSL_STEPS (most student leaves moved from their initial
   values), a checkpoint and a resume bit-equal to the run, the same
   gathered checksum on both ranks; each rank's device
   memory held after set-up and at its peak in each (fsdp 1 must hold
   under 0.6 of fsdp 0's: its leaves and Adam moments are slices); KoLeo
   over the global batch: each rank's value and feature gradient on its
   rows of seeded features, and one SSL step on its rows of seeded images
   (f32, plain attention), against one process on the whole batch at
   TOL_KOLEO. Each rank's launch counts (6 partials a predict or step, 6
   backward a step) and each collective's bytes are printed;
23. prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Before the build it prints one line on what the native video decoder would
need on this machine (`[ffmpeg probe]`: FFmpeg's headers and libraries,
pkg-config's view, g++); it installs nothing.

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
VITB_PATHS = ("serve", "serve_http", "train", "int8_serve", "int8_rows", "kv_int8",
              "int8_train", "int8_rows_train", "options", "gates")
RECIPE_PATHS = ("compinv", "mix", "modes")   # [train cli compinv] / [train cli mix], [train modes]
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
# ViT-L/14 or ViT-L/14@336px; bench.py:63-68 adds the qk rung): the last 6
# layers kept, compute_int8, through the encoder's kernel forms. Its towers
# are cut from 24 layers to LADDER_LAYERS to hold the run's time ([kernels
# tower wide] times the 24-layer tower at these widths and token counts).
# Not to 8: there the random tower's P(fake) is unsaturated (~0.83, against
# ~0.0015 at 12 and 24) and the W8A8 rungs' |dP(fake)| from the f32 plain
# route reads 3.2e-2 to 5.0e-2, past TOL_PFAKE_F32 (ROADMAP queue 3 item 1)
LADDER_LAYERS = 12
LADDER_KEEP = tuple(range(LADDER_LAYERS - 6, LADDER_LAYERS))
TOWER_WIDE_KEEP = tuple(range(18, 24))   # [kernels tower wide]: the 24-layer tower's
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
    import functools

    from dfd_clip_tpu_torch.models import clip_vit, decoder, layers
    from dfd_clip_tpu_torch.ops import (
        attention,
        decoder_attention_vjp,
        decoder_stack,
        encoder_block,
        fused_decoder_attention,
        fused_decoder_attention_bwd,
        int8,
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
        (layers, "w8a8_linear", int8.w8a8_linear_plain),
        (encoder_block, "export_kv_rows8", functools.partial(int8.export_kv_rows8, plain=True)),
    ] if encoder else []
    swaps += [
        (decoder, "fused_decoder_attention",
         fused_decoder_attention.fused_decoder_attention_plain),
        (decoder_stack, "decoder_boundary", decoder_stack.decoder_boundary_plain),
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
    check_layer_norm(rows, "layer_norm_rows", h2, ln1,
                     VITB_PATHS + VARIANT_PATHS + RECIPE_PATHS)
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
        PEAK_BF16_TC, err,
        paths=VITB_PATHS + ("dinov2_serve",) + VARIANT_PATHS + RECIPE_PATHS)

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
        paths=("serve", "serve_http", "train", "full_bf16") + RECIPE_PATHS)
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
        paths=("serve", "serve_http", "train", "full_bf16") + RECIPE_PATHS)
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
        PEAK_BF16_TC, err, paths=("serve", "serve_http", "train") + RECIPE_PATHS)
    del got, h

    # -- fused_decoder_attention and decoder_boundary (the ViT-B export: 200
    # rows a frame, 196 of them valid); DINOv2's boundaries run at this width
    check_decoder_attention(rows, "fused_decoder_attention", gen, dev, hh, t_out, 196,
                            ("serve", "serve_http", "int8_serve", "kv_int8", "options",
                             "gates") + VARIANT_PATHS)
    check_train_attention(row, gen, dev)
    check_decoder_boundary(rows, "decoder_boundary", blk, 2,
                           VITB_PATHS + ("dinov2_serve",) + VARIANT_PATHS + ("mix", "mr"))


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
            dev_ms = device_ms(lambda: fn(*args))
            on_device = f"device {dev_ms:.4f} ms" if dev_ms > 0 else "device not measured"
            print(f"    {label}: {times[form, label]:.4f} ms ({on_device}, host "
                  f"{tbd.host_ms(fn, *args):.4f} ms a call)", flush=True)
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
        PEAK_F32, err, counter="fused_decoder_attention",
        paths=("train", "mix", "modes", "int8_train", "int8_rows_train", "mr"))

    del o_sc, st, o_p, st_p
    check_decoder_bwd(row, "fused_decoder_attention_bwd", bargs,
                      ("train", "modes", "int8_train", "int8_rows_train", "options", "gates",
                       "mr"))
    # dK/dV from the same launch: the stacked padded export at slot 3 (L =
    # 4,000), then the adapter's per-layer unpadded K/V (L = 20 x 196 = 3,920)
    check_decoder_bwd_kv(row, "fused_decoder_attention_bwd dK/dV stacked, L 4000", bargs, ())
    del bargs, args
    bargs = decoder_bwd_inputs(gen, dev, b, 196, 196, hh)
    bargs = bargs[:2] + (bargs[2][3].contiguous(), bargs[3][3].contiguous()) + bargs[4:6] \
        + (None,) + bargs[7:]
    check_decoder_bwd_kv(row, "fused_decoder_attention_bwd dK/dV", bargs, ("train_cli", "mix"))
    del bargs
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


def check_decoder_bwd_kv(row, name: str, bargs: tuple, paths: tuple) -> None:
    """The backward's dK/dV form (``with_kv``: the same launch also writes
    the slot's dK and dV in bf16) on ``bargs``: dK and dV held against
    _bwd_math's at TOL_DECODER, exactly 0 at every masked token (the fully
    masked last sample's included), dq and dpos bit-equal to the launch
    without dK/dV and within TOL_DECODER of the plain version, two calls
    bit-equal; its time by CUDA events and device time beside its bound (the
    reads of check_decoder_bwd plus both (B, L, H, 64) bf16 outputs) and
    the plain version's."""
    import torch

    from dfd_clip_tpu_torch.ops import fused_decoder_attention_bwd as fdb

    qs, mask = bargs[0], bargs[4]
    b, _, hh, d = qs.shape
    l, w = mask.shape[1], hh * d
    valid = mask.sum().item()
    got = fdb.fused_decoder_attention_bwd(*bargs, with_kv=True)
    again = fdb.fused_decoder_attention_bwd(*bargs, with_kv=True)
    without = fdb.fused_decoder_attention_bwd(*bargs)
    want = fdb.fused_decoder_attention_bwd_plain(*bargs, with_kv=True)
    err = 0.0
    for g_, w_, part in zip(got, want, ("dq_smax", "dq_coda", "dpos", "dK", "dV")):
        err = max(err, compare(f"{name} {part}", g_, w_, TOL_DECODER))
    dead = ~mask
    for g_, part in zip(got[3:], ("dK", "dV")):
        if g_.dtype != torch.bfloat16 or g_[dead].abs().max().item() != 0 \
                or g_[b - 1].abs().max().item() != 0:
            raise SystemExit(f"FAIL {name}: {part} is not bf16 with zeros at the masked tokens")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise SystemExit(f"FAIL {name}: two calls differ")
    if not all(torch.equal(x, y) for x, y in zip(got[:3], without)):
        raise SystemExit(f"FAIL {name}: dq / dpos differ from the launch without dK/dV")
    print(f"  {name}: dK/dV zero on {int(dead.sum())} masked tokens of {b * l}", flush=True)
    del got, again, without, want
    ms = time_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs, with_kv=True), iters=50)
    dev_ms = device_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs, with_kv=True))
    base = time_ms(lambda: fdb.fused_decoder_attention_bwd(*bargs), iters=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fdb.fused_decoder_attention_bwd(*bargs, with_kv=True)
    host = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    print(f"  {name}: {ms:.4f} ms by events, device {dev_ms:.4f} ms, host {host:.4f} ms a call; "
          f"without dK/dV {base:.4f} ms by events, on {card_line()}", flush=True)
    row(name, "dfd_clip_tpu/ops/pallas_decoder_attention.py:477",
        "dfd_clip_tpu_torch/csrc/decoder_attention_bwd.cu", ms,
        time_ms(lambda: fdb.fused_decoder_attention_bwd_plain(*bargs, with_kv=True), iters=3,
                warmup=1),
        None, 27.0 * valid * w,
        4.0 * valid * w + 2.0 * l * w + b * l + 4.0 * b * w + 2.0 * b * w + 4.0 * b * w
        + 8.0 * b * hh + 8.0 * b * w + 4.0 * l * w + 4.0 * b * l * w, PEAK_F32, err,
        counter="fused_decoder_attention_bwd", paths=paths)


def to_device(tree, dev):
    """Params (dicts and lists of tensors) to the card: matrix weights ("w")
    in bf16, int8 weights as they are, the rest f32."""
    import torch

    if isinstance(tree, dict):
        return {k: (v.to(dev, torch.bfloat16) if k == "w" else to_device(v, dev))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
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
    int8_paths = ("int8_serve", "int8_rows", "int8_train", "int8_rows_train",
                  "gates") + INT8_VARIANTS
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
    _cuda.quant_rows(xf[:, w: 2 * w], form="kv", export=(kq[2], k_s, t, t_out, 1))
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
    # its partials form (a token shard's input, ops/spmd.py): the int8 kernel
    # then the merge into the softmax state, no path runs it at this shape
    o_sc, st = fda.fused_decoder_attention(*args, partials=True, **scales)
    o_p, st_p = fda.fused_decoder_attention_plain(*args, partials=True, **scales)
    compare("fused_decoder_attention int8 partials numerator|coda", o_sc, o_p, TOL_DECODER)
    compare("fused_decoder_attention int8 partials denominator", st[: b - 1, 0],
            st_p[: b - 1, 0], TOL_DECODER)
    compare("fused_decoder_attention int8 partials maximum", st[: b - 1, 1], st_p[: b - 1, 1],
            TOL_DECODER)
    if o_sc[b - 1].abs().max().item() != 0 or (st[b - 1, 1] != -1e30).any().item():
        raise SystemExit("FAIL fused_decoder_attention int8 partials: a fully masked sample "
                         "is not (0, 0, -1e30)")
    del o_sc, st, o_p, st_p
    valid = mask.sum().item()
    row("fused_decoder_attention int8", "dfd_clip_tpu/ops/pallas_decoder_attention.py:633",
        "dfd_clip_tpu_torch/csrc/decoder_attention.cu",
        time_ms(lambda: fda.fused_decoder_attention(*args, **scales)),
        time_ms(lambda: fda.fused_decoder_attention_plain(*args, **scales)),
        None, 16.0 * valid * w,
        2.0 * valid * w + 8.0 * valid + 2.0 * l * w + b * l + 6.0 * b * w,
        PEAK_F32, err, counter="fused_decoder_attention_int8", paths=("int8_rows",))


def detector(kernels=None, device="cuda", **extra):
    """A Detector on the card (``device``), bf16, 20 frames, out_dim [2]: the
    flagship (bench.py:_detector_cfg) with ``extra``'s keys overridden and
    the encoder's kernel paths ``kernels`` (EncoderKernels arguments)."""
    import torch

    from dfd_clip_tpu_torch.models.detector import Detector, EncoderKernels

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": list(KEEP),
                              "out_dim": [2], "losses": ["auc_roc"],
                              "op_mode": {"temporal_position": 1}, **extra})
    return Detector(cfg, num_frames=FRAMES, compute_dtype=torch.bfloat16, device=device,
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


def write_video(file: str, seconds: float, size: int, fourcc: str, seed: int,
                noise: int = 0) -> None:
    """A 25 fps video of a seeded image drifting in brightness (cv2);
    ``noise`` adds seeded noise of up to that amplitude to the image (the
    c23 member of a raw / c23 pair: the same picture, degraded)."""
    import cv2
    import numpy as np

    Path(file).parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(file, cv2.VideoWriter_fourcc(*fourcc), 25.0, (size, size))
    if not writer.isOpened():
        raise SystemExit(f"FAIL serve_http: cv2 cannot write {file} ({fourcc})")
    base = np.random.default_rng(seed).integers(0, 200, (size, size, 3), np.uint8)
    if noise:
        base = np.clip(base.astype(np.int32) + np.random.default_rng(seed + 7919).integers(
            -noise, noise + 1, base.shape), 0, 255).astype(np.uint8)
    for i in range(int(seconds * 25)):
        writer.write(np.clip(base.astype(np.int32) + i % 50, 0, 255).astype(np.uint8))
    writer.release()


def write_videos(jobs: list) -> None:
    """write_video(*job) for every job, on a thread a core (cv2 encodes
    without the GIL); each job's seed fixes its content."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        for f in [pool.submit(write_video, *job) for job in jobs]:
            f.result()


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

    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.ops import _cuda

    det = detector(dropout=0.5)
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3})
    batches = train_batches(2)
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
    hold_train_step(det, trainer, batch, "train")

    dev_round = [("deepfake", batch)]
    timed_train_step("device-resident train step", trainer, dev_round, card)
    profile_device("train step", lambda: trainer.train_step(dev_round))
    return counts


# [train cli]: the training CLI on trees of cv2-written 224-pixel MJPG videos
CLI_VIDEO_SECONDS = 8.5   # two 4-second clips a video
CLI_IDS = ("000", "001", "002", "003", "004", "005", "006", "007")
CLI_STEPS, CLI_EVERY = 4, 2   # trainer.max_steps; evaluation / checkpoint interval
TRAIN_COUNTS = {"fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
                "fused_decoder_attention": 6, "fused_decoder_attention_bwd": 6,
                "decoder_boundary": 0}


def cli_trees(work: str) -> dict:
    """FFPP (c23; REAL, DF, FS, F2F for training, REAL and NT for
    evaluation; 8 ids in 4 pairs, one split file for train, val and test),
    DFDC and Celeb-DF (two real, two fake videos each), every video
    CLI_VIDEO_SECONDS long at 224 pixels."""
    import json as json_

    ffpp, dfdc, cdf = (str(Path(work) / n) for n in ("ffpp", "dfdc", "cdf"))
    pairs = [list(CLI_IDS[i: i + 2]) for i in range(0, len(CLI_IDS), 2)]
    jobs, seed = [], 0
    for kind, folder in (("REAL", "real"), ("DF", "DF"), ("FS", "FS"), ("F2F", "F2F"),
                         ("NT", "NT")):
        names = list(CLI_IDS) if kind == "REAL" else (
            [f"{a}_{b}" for a, b in pairs] + [f"{b}_{a}" for a, b in pairs])
        for name in names:
            jobs.append((f"{ffpp}/{folder}/c23/videos/{name}.avi", CLI_VIDEO_SECONDS, 224, "MJPG",
                         seed))
            seed += 1
    Path(ffpp, "splits").mkdir(parents=True)
    for split in ("train", "val", "test"):
        Path(ffpp, "splits", f"{split}.json").write_text(json_.dumps(pairs))
    rows = []
    for i in range(4):
        jobs.append((f"{dfdc}/videos/v{i}.avi", CLI_VIDEO_SECONDS, 224, "MJPG", 300 + i))
        rows.append(f"v{i}.avi {i % 2}")
    Path(dfdc, "csv_files").mkdir(parents=True)
    Path(dfdc, "csv_files", "test.csv").write_text("\n".join(rows))
    Path(cdf, "csv_files").mkdir(parents=True)
    for label in ("REAL", "FAKE"):
        names = [f"{label.lower()}{i}" for i in range(2)]
        for i, name in enumerate(names):
            jobs.append((f"{cdf}/{label}/videos/{name}.avi", CLI_VIDEO_SECONDS, 224, "MJPG",
                         400 + 10 * (label == "FAKE") + i))
        Path(cdf, "csv_files", f"test_{label.lower()}.csv").write_text(
            "\n".join(f"{n}.avi {int(label == 'FAKE')}" for n in names))
    write_videos(jobs)
    return {"FFPP": ffpp, "DFDC": dfdc, "CDF": cdf}


def cli_config(work: str, trees: dict, tracking: str, checkpoint_dir: str = "") -> str:
    """configs/deepfake/deepfake.yaml with the roots, scales, max_steps, the
    evaluation, checkpoint and training-evaluation intervals and
    tracking.directory (and, for a run to be resumed, trainer.checkpoint_dir)
    changed, each change printed; the file's path."""
    import yaml

    src = Path(__file__).resolve().parent / "configs" / "deepfake" / "deepfake.yaml"
    cfg = yaml.safe_load(src.read_text())
    changes = [(("trainer", "max_steps"), CLI_STEPS),
               (("trainer", "checkpoint_interval"), CLI_EVERY),
               (("system", "evaluation_interval"), CLI_EVERY),
               (("system", "training_eval_interval"), CLI_EVERY),
               (("tracking", "directory"), tracking)]
    if checkpoint_dir:
        changes.append((("trainer", "checkpoint_dir"), checkpoint_dir))
    for where, entries in (("train", cfg["data"]["train"]), ("eval", cfg["data"]["eval"])):
        for i, d in enumerate(entries):
            changes.append((("data", where, i, "root_dir"), trees[d["name"]]))
            # the FFPP evaluation set at half its (8 + 8) videos: one ragged batch
            scale = 0.5 if where == "eval" and d["name"] == "FFPP" else 1.0
            changes.append((("data", where, i, "scale"), scale))
    for keys, value in changes:
        node = cfg
        for k in keys[:-1]:
            node = node[k]
        print(f"  {src.name}: {'.'.join(map(str, keys))} {node.get(keys[-1])!r} -> {value!r}",
              flush=True)
        node[keys[-1]] = value
    out = Path(work) / f"train_cli_{len(list(Path(work).glob('train_cli_*.yaml')))}.yaml"
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


def cli_run(card: str, work: str, cfg: str, compinv: bool = False,
            keep: dict = None) -> tuple:
    """``python -m dfd_clip_tpu_torch.main --cfg cfg`` in this process on the
    card (the working directory ``work``, where the datasets cache their
    video tables), every launch counter zeroed before and read after. Each
    train step's losses, lr and launches and each evaluation's launches are
    recorded around the trainer's own step and the evaluator's own run
    (CompInvTrainer's and CompInvEvaluator's with ``compinv``), and held:
    a step's launches TRAIN_COUNTS (COMPINV_COUNTS) a task batch, an
    evaluation's FLAGSHIP_COUNTS (COMPINV_COUNTS) a predict. ``keep``: gets the
    trainer ("trainer"), its first step's round of task batches ("round"),
    the first of them ("batch") and its trainable leaves before that step
    ("start"). Returns
    (run directory, counts, step log, evaluation log)."""
    import os

    import numpy as np
    import torch

    from dfd_clip_tpu_torch import main as tmain
    from dfd_clip_tpu_torch.engine.evaluator import CompInvEvaluator, Evaluator
    from dfd_clip_tpu_torch.engine.trainer import CompInvTrainer, Trainer
    from dfd_clip_tpu_torch.ops import _cuda

    Trainer_, Evaluator_ = (CompInvTrainer, CompInvEvaluator) if compinv else (Trainer, Evaluator)
    step_counts, eval_counts = ((COMPINV_COUNTS, COMPINV_COUNTS) if compinv
                                else (TRAIN_COUNTS, FLAGSHIP_COUNTS))
    steps, evals = [], []
    train_step, run_eval = Trainer_.train_step, Evaluator_.run

    def delta(before):
        after = _cuda.launches()
        return {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}

    def logged_step(self, round_batches):
        lr, index = self.current_lr(), self.steps
        if keep is not None and "trainer" not in keep:
            keep["trainer"], keep["batch"], keep["round"] = (self, round_batches[0][1],
                                                             round_batches)
            keep["start"] = [t.detach().clone() for t in _leaf_tensors(self.trainable)]
        torch.cuda.synchronize()
        before, t0 = _cuda.launches(), time.perf_counter()
        train_step(self, round_batches)
        torch.cuda.synchronize()
        losses = np.concatenate([np.ravel(v) for v in self.batch_losses.values()])
        steps.append({"step": index, "lr": lr, "used": self.optimizer.param_groups[0]["lr"],
                      "schedule": self.schedule(index), "loss": float(losses.mean()),
                      "losses": {k: float(np.mean(v)) for k, v in self.batch_losses.items()},
                      "finite": bool(np.isfinite(losses).all()),
                      "clips": sum(b["x"].shape[0] for _, b in round_batches),
                      "tasks": len(round_batches),
                      "ms": (time.perf_counter() - t0) * 1e3, "counts": delta(before)})

    def logged_eval(self, trainer):
        torch.cuda.synchronize()
        before, t0 = _cuda.launches(), time.perf_counter()
        run_eval(self, trainer)
        torch.cuda.synchronize()
        evals.append({"step": trainer.steps, "predicts": sum(len(d) for d in
                                                             self.dataloaders.values()),
                      "s": time.perf_counter() - t0, "counts": delta(before)})

    previous = os.getcwd()
    Trainer_.train_step, Evaluator_.run = logged_step, logged_eval
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        run = tmain.main(tmain.parse_args(["--cfg", cfg, "--video_backend", "opencv"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = _cuda.launches(), _cuda.plain_calls()
    finally:
        os.chdir(previous)
        Trainer_.train_step, Evaluator_.run = train_step, run_eval
    print(f"  main: {wall:.2f} s of wall, {len(steps)} steps, {len(evals)} evaluations, "
          f"plain calls {plain or 'none'}, on {card}", flush=True)
    if plain:
        raise SystemExit(f"FAIL train cli: plain versions ran on the card: {plain}")
    for st in steps:
        print(f"  step {st['step']}: {st['clips']} clips in {st['tasks']} task batches, losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in st["losses"].items())
              + f", lr {st['used']:.6e}, {st['ms']:.2f} ms (host clock), launches "
              f"{json.dumps(st['counts'])}", flush=True)
        if not st["finite"]:
            raise SystemExit(f"FAIL train cli step {st['step']}: losses {st['losses']}")
        if abs(st["used"] - st["schedule"]) > 1e-12 or abs(st["lr"] - st["used"]) > 1e-12:
            raise SystemExit(f"FAIL train cli step {st['step']}: lr {st['used']} is not "
                             f"schedule({st['step']}) = {st['schedule']}")
        check_counts(f"train cli step {st['step']}", st["counts"], step_counts, st["tasks"])
    for ev in evals:
        print(f"  evaluation at step {ev['step']}: {ev['predicts']} predicts, {ev['s']:.2f} s, "
              f"launches {json.dumps(ev['counts'])}", flush=True)
        check_counts(f"train cli evaluation at step {ev['step']}", ev["counts"],
                     eval_counts, ev["predicts"])
    return run, counts, steps, evals


def train_cli_path(card: str, work: str) -> tuple:
    """The training CLI on the flagship recipe: main on a YAML derived from
    configs/deepfake/deepfake.yaml (the 768-x-768-z0 adapter on the
    unpadded export, normal+frame augmentation of FFPP contrast pairs,
    evaluation of FFPP, DFDC and CDF), in this process on the card; its
    steps, evaluations, run directory, plain calls and launches checked;
    then a run resumed from the run's step-2 checkpoint to step 4,
    held to the uninterrupted run; then inference.main on the run
    directory held video by video to Scorer.from_run_dir on the same clips;
    then one train step with a non-z0 adapter held to the plain versions and
    the adapter's device-resident train step timed and traced; then, on the
    same trees, the other recipes (compinv_paths). The trees and runs go
    under ``work``, which the caller keeps for the [analysis] phase.
    Returns (the launch counts of the first run ("train_cli") and of
    compinv_paths', the trees)."""
    import pickle
    import shutil

    import numpy as np
    import torch
    import yaml

    from dfd_clip_tpu_torch import inference
    from dfd_clip_tpu_torch.config import CN
    from dfd_clip_tpu_torch.data import datasets as tds
    from dfd_clip_tpu_torch.models.weights import load_params
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.serve import Scorer

    t0 = time.perf_counter()
    trees = cli_trees(work)
    print(f"  trees: {len(list(Path(work).rglob('*.avi')))} MJPG videos of "
          f"{CLI_VIDEO_SECONDS} s at 224 pixels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    print("[train cli] python -m dfd_clip_tpu_torch.main --cfg <deepfake.yaml, changed "
          "as printed> --video_backend opencv", flush=True)
    run, counts, steps, evals = cli_run(card, work, cli_config(work, trees,
                                                              f"{work}/logs"))
    if len(steps) != CLI_STEPS or [e["step"] for e in evals] != [2, 4]:
        raise SystemExit(f"FAIL train cli: {len(steps)} steps, evaluations at "
                         f"{[e['step'] for e in evals]}")
    names = sorted(p.name for p in Path(run).iterdir())
    print(f"  run directory {Path(run).relative_to(work)}: {', '.join(names)}", flush=True)
    for need in ("setting.yaml", "best_weights.pt", "last_weights.pt", "metrics.jsonl",
                 "checkpoints"):
        if need not in names:
            raise SystemExit(f"FAIL train cli: no {need} in the run directory")
    lines = [json.loads(s) for s in Path(run, "metrics.jsonl").read_text().splitlines()]
    for step in (2, 4):
        got = {k: v for r in lines if r["step"] == step for k, v in r.items()
               if k.startswith("evaluator/metric/")}
        print(f"  evaluation at step {step}: " + ", ".join(
            f"{k.split('/', 2)[2]} {v:.4f}" for k, v in sorted(got.items())), flush=True)
        for ds in ("ffpp", "dfdc", "cdf"):
            for metric in ("accuracy", "roc_auc"):
                value = got.get(f"evaluator/metric/deepfake/{ds}/{metric}")
                if value is None or not np.isfinite(value):
                    raise SystemExit(f"FAIL train cli: evaluation at step {step} reports "
                                     f"{ds} {metric} {value}")
    setting = yaml.safe_load(Path(run, "setting.yaml").read_text())
    print(f"  setting.yaml: adapter {setting['model']['adapter']}, batch "
          f"{setting['trainer']['batch_size']} (contrast pairs: {steps[0]['clips']} clips a "
          f"step)", flush=True)

    print(f"[train cli resume] a run resumed from the run's step {CLI_EVERY} checkpoint to "
          f"step {CLI_STEPS}", flush=True)
    ck = Path(work, "resume_checkpoints")
    ck.mkdir()
    shutil.copytree(Path(run, "checkpoints", f"step_{CLI_EVERY:08d}"),
                    ck / f"step_{CLI_EVERY:08d}")
    resumed, _, rsteps, _ = cli_run(card, work, cli_config(work, trees,
                                                           f"{work}/logs_resumed", str(ck)))
    if [s["step"] for s in rsteps] != list(range(CLI_EVERY, CLI_STEPS)):
        raise SystemExit(f"FAIL train cli resume: steps {[s['step'] for s in rsteps]}")
    want, got = (load_params(f"{d}/last_weights.pt") for d in (run, resumed))
    worst, equal, n = 0.0, True, 0
    for a, b in zip(*(_tree_leaves(t["trainable"]) for t in (got, want))):
        worst = max(worst, float(np.abs(a - b).max()))
        equal = equal and np.array_equal(a, b)
        n += 1
    print(f"  resumed vs uninterrupted last_weights.pt: {n} leaves, bit-equal {equal}, "
          f"max |d| {worst:.3e} (hold: bit-equal; every kernel of the step is "
          f"deterministic)", flush=True)
    if got["steps"] != want["steps"] or not equal:
        raise SystemExit("FAIL train cli resume: the resumed run's weights differ")

    print("[train cli inference] python -m dfd_clip_tpu_torch.inference <run> "
          f"--batch_size {CLIPS}, each video held to Scorer.from_run_dir", flush=True)
    import os
    from concurrent.futures import ThreadPoolExecutor

    previous = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        report = inference.main(inference.parse_args(
            [run, "--batch_size", str(CLIPS), "--num_workers", "2",
             "--video_backend", "opencv"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts = _cuda.launches()
        (stats_file,) = Path(run).glob("stats_*_best_video.pickle")
        stats = pickle.loads(stats_file.read_bytes())
        reference = Scorer.from_run_dir(run, batch_size=CLIPS)
        videos = 0
        for d in setting["data"]["eval"]:
            cls = getattr(tds, d["name"])
            dcfg = cls.get_default_config().merge_from_other_cfg(CN(d))
            dcfg.pack, dcfg.scale = 1, 1.0
            ds = cls(dcfg, setting["data"]["num_frames"], setting["data"]["clip_duration"],
                     split="test", video_backend="opencv")
            probs, labels = stats[d["name"]]["prob"], stats[d["name"]]["label"]
            if len(probs) != len(ds):
                raise SystemExit(f"FAIL train cli inference: {d['name']} has {len(probs)} "
                                 f"videos, the dataset {len(ds)}")
            # the videos decoded on a thread a core (cv2 decodes without the
            # GIL; each item is a pure function of its index), scored in turn
            with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
                items = list(pool.map(lambda i: ds[i][:2], range(len(ds))))
            for i, (clips, label) in enumerate(items):
                x = np.stack(clips)                      # (clips, T, 3, H, W)
                want_p = reference.score_frames(
                    x.transpose(0, 1, 3, 4, 2).reshape(-1, *x.shape[3:], 3))
                delta = abs(probs[i] - want_p)
                print(f"  {d['name']} video {i}: {len(clips)} clips, label {labels[i]}, "
                      f"P(fake) {probs[i]:.9f}, Scorer {want_p:.9f}, |d| {delta:.3e} "
                      f"(tol {TOL_HTTP:g})", flush=True)
                if labels[i] != label[0] or not delta <= TOL_HTTP:
                    raise SystemExit(f"FAIL train cli inference: {d['name']} video {i}")
                videos += 1
    finally:
        os.chdir(previous)
    print(f"  inference.main: {wall:.2f} s, report {report}, {videos} videos", flush=True)
    check_counts("train cli inference.main", run_counts, FLAGSHIP_COUNTS, videos)
    del reference
    adapter_step(card)
    recipes = compinv_paths(card, work, trees)
    return {"train_cli": counts, **recipes}, trees


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def adapter_params(det, fc2_scale: float) -> dict:
    """``det``'s params (seed 0) with its 768-x-768 adapter's (x 256)
    LayerNorms drawn at random and its fc2 scaled by ``fc2_scale``."""
    import torch

    gen = torch.Generator().manual_seed(11)
    params = det.init_params(torch.Generator().manual_seed(0))
    for blk in params["adapter"]["blocks"]:
        for branch in blk.values():
            branch["ln"]["scale"] = 1.0 + 0.2 * torch.randn(256, generator=gen)
            branch["ln"]["bias"] = 0.2 * torch.randn(256, generator=gen)
            branch["fc2"]["w"] = fc2_scale * branch["fc2"]["w"]
    return params


def adapter_trainer(fc2_scale: float):
    """A flagship Trainer with the 768-x-768 adapter (x 256), its LayerNorms
    random and its fc2 scaled by ``fc2_scale``, and a prepared random batch
    of TRAIN_CLIPS clips: (Detector, Trainer, batch)."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.trainer import Trainer

    det = detector(dropout=0.5, adapter={"type": "normal",
                                         "struct": {"type": "768-x-768", "x": 256}})
    params = adapter_params(det, fc2_scale)
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3})
    rng = np.random.default_rng(2)
    raw = (rng.integers(0, 256, (TRAIN_CLIPS, FRAMES, 3, 224, 224), np.uint8),
           (np.arange(TRAIN_CLIPS) % 2).astype(np.int32), np.ones((TRAIN_CLIPS, FRAMES), bool),
           ["c23"] * TRAIN_CLIPS, np.ones(TRAIN_CLIPS, np.float32),
           np.zeros(TRAIN_CLIPS, np.int64))
    trainer = Trainer(tcfg, det, {"deepfake": [raw]}, params=params, seed=0)
    return det, trainer, trainer.prepare_batch(raw)


def l2_rel(got: list, want: list) -> float:
    """The worst leaf's relative L2 distance of ``got`` from ``want``."""
    return max((g - w).norm().item() / max(w.norm().item(), 1e-30) for g, w in zip(got, want))


def adapter_step(card: str) -> None:
    """A train step of the flagship Trainer with a non-z0 adapter (768-x-768,
    x 256; at z0 every adapter gradient is 0, so the recipe alone cannot
    show a wrong dK/dV). First its conditioning, recorded: with fc2 as
    drawn, the kernels' gradients against the plain versions' beside the
    plain versions' own against a step whose parameters were nudged by 1e-4
    of themselves. Then, with fc2 at a tenth of its draw (a trained z0
    adapter's scale, where the decoder's route is conditioned), every
    backward call's dq, dpos, dK and dV on the step's own inputs held to
    _bwd_math at TOL_DECODER, the unpadded export held to the plain
    versions at TOL_ENCODER and to the padded export's first rows bit for
    bit, the loss and every gradient leaf through the decoder kernels held
    to their plain versions (hold_train_step; the all-kernels route
    recorded beside what the export's difference alone makes of the
    gradients), the launches counted, and its device-resident step
    (batch TRAIN_CLIPS, as the train path's no-adapter step) timed by CUDA
    events, its peak memory read and one step traced."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_attention_vjp as vjp
    from dfd_clip_tpu_torch.ops import fused_decoder_attention_bwd as fdb

    print(f"[train cli adapter step] Trainer over ViT-B/16 with the 768-x-768 adapter (x 256, "
          f"LayerNorms random), batch {TRAIN_CLIPS}, dropout 0.5", flush=True)
    det, trainer, batch = adapter_trainer(1.0)
    _, grads_k = step_grads(det, trainer, batch)
    _, grads_p = step_grads(det, trainer, batch, "decoder")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for t in _leaf_tensors(trainer.trainable):
            t.mul_(1 + 1e-4 * (2 * torch.rand(t.shape, generator=gen, device=t.device) - 1))
    _, grads_n = step_grads(det, trainer, batch, "decoder")
    print(f"  conditioning, fc2 as drawn (recorded, not held): kernels vs plain, worst leaf "
          f"{l2_rel(grads_k, grads_p):.3e} (l2 rel); plain vs plain with every parameter "
          f"nudged by 1e-4 of itself, {l2_rel(grads_n, grads_p):.3e}", flush=True)
    del det, trainer, batch, grads_k, grads_p, grads_n
    torch.cuda.empty_cache()

    det, trainer, batch = adapter_trainer(0.1)
    calls, kernel = [], vjp.fused_decoder_attention_bwd

    def both(*args, **kwargs):
        got = kernel(*args, **kwargs)
        want = fdb.fused_decoder_attention_bwd_plain(*args, **kwargs)
        calls.append([(part, (g.float() - w.float()).abs().max().item()
                       / max(w.float().abs().max().item(), 1e-30))
                      for part, g, w in zip(("dq_smax", "dq_coda", "dpos", "dK", "dV"), got, want)
                      if w is not None])
        return got

    vjp.fused_decoder_attention_bwd = both
    try:
        step_grads(det, trainer, batch)
    finally:
        vjp.fused_decoder_attention_bwd = kernel
    worst = max((e, part, i) for i, c in enumerate(calls) for part, e in c)
    print(f"  fc2 at a tenth: {len(calls)} backward calls on the step's own inputs vs "
          f"_bwd_math, worst {worst[1]} of call {worst[2]} at {worst[0]:.3e} of its max (tol "
          f"{TOL_DECODER:g})", flush=True)
    if len(calls) != len(KEEP) or {p for c in calls for p, _ in c} != {
            "dq_smax", "dq_coda", "dpos", "dK", "dV"} or not worst[0] <= TOL_DECODER:
        raise SystemExit(f"FAIL train cli adapter step: backward calls {calls}")
    # The unpadded export the adapter reads (never on the card's serve paths,
    # whose export is padded to 200 rows): kernels against the plain
    # versions at TOL_ENCODER, and against the kernels' own padded export's
    # first 196 rows.
    with torch.no_grad():
        x = det.preprocess(batch["x"])
        kv = det.encode_kv(trainer.frozen_run, x)
        padded = det.encode_kv(trainer.frozen_run, x, pad_tokens=True)
        with plain_versions():
            plain = det.encode_kv(trainer.frozen_run, x)
    for s_ in ("k", "v"):
        compare(f"train cli unpadded export {s_.upper()} (6 layers, {tuple(kv[s_].shape[1:])})",
                kv[s_], plain[s_], TOL_ENCODER)
        if not torch.equal(kv[s_], padded[s_][:, :, :, :kv[s_].shape[3]]):
            raise SystemExit(f"FAIL train cli: the unpadded export's {s_} is not the padded "
                             f"export's first rows")
    print(f"  the unpadded export equals the padded export's first "
          f"{kv['k'].shape[3]} rows of {padded['k'].shape[3]}, bit for bit", flush=True)
    del x, kv, padded, plain
    # The all-kernels route's leaves are recorded, not held: past the decoder
    # kernels' route (held above) it differs only in the encoder's export,
    # within TOL_ENCODER of the plain one (just held); the decoder-plain route
    # against the all-plain one shows what that export difference alone
    # makes of this step's gradients.
    grads = hold_train_step(det, trainer, batch, "train cli adapter", hold_all=False)
    print(f"  fc2 at a tenth: the decoder-plain route (the kernels' export) against the "
          f"all-plain route (the plain export), worst leaf "
          f"{l2_rel(grads['decoder'], grads['all']):.3e} (l2 rel)", flush=True)
    del grads
    dev_round = [("deepfake", batch)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    trainer.train_step(dev_round)
    torch.cuda.synchronize()
    check_counts("train cli adapter step", _cuda.launches(), TRAIN_COUNTS, 1)
    if _cuda.plain_calls():
        raise SystemExit(f"FAIL train cli adapter step: plain calls {_cuda.plain_calls()}")
    timed_train_step("device-resident train step with the adapter", trainer, dev_round, card)
    profile_device("train step with the adapter", lambda: trainer.train_step(dev_round))


# [train cli compinv], [train cli pretrain], [train cli mix], [train modes]:
# the recipes of configs/ beside the flagship one, and the Detector's
# training modes, at full width
COMPINV_SECONDS = 12.0    # clip_duration 10: a shorter video has no clip
COMPINV_IDS = CLI_IDS[:4]   # 20 pairs to train on (batch 5), 8 to evaluate (batch 6)
COMPINV_COUNTS = {"fused_encoder_attn_block": 11, "fused_encoder_mlp_block": 10,
                  "fused_decoder_attention": 0, "fused_decoder_attention_bwd": 0,
                  "decoder_boundary": 0}
MIX_STEPS = 2             # trainer.max_steps of the mix run (one evaluation, at step 2)
HCI_SESSIONS, HCI_SECONDS = 8, 8.5   # two 4-second clips a session; 6 train, 2 val
TOL_COMPINV = 1e-2        # a CompInv step's match, kernels vs plain (relative)


def compinv_tree(work: str) -> str:
    """FFPP of every type, raw and c23 (the same picture with noise) for
    COMPINV_IDS, COMPINV_SECONDS long at 224 pixels, one split file."""
    import json as json_

    root = f"{work}/ffpp_pairs"
    pairs = [list(COMPINV_IDS[i: i + 2]) for i in range(0, len(COMPINV_IDS), 2)]
    jobs, seed = [], 600
    for kind, folder in (("REAL", "real"), ("DF", "DF"), ("FS", "FS"), ("F2F", "F2F"),
                         ("NT", "NT")):
        names = list(COMPINV_IDS) if kind == "REAL" else (
            [f"{a}_{b}" for a, b in pairs] + [f"{b}_{a}" for a, b in pairs])
        for name in names:
            for comp, noise in (("raw", 0), ("c23", 12)):
                jobs.append((f"{root}/{folder}/{comp}/videos/{name}.avi", COMPINV_SECONDS, 224,
                             "MJPG", seed, noise))
            seed += 1
    write_videos(jobs)
    Path(root, "splits").mkdir()
    for split in ("train", "val", "test"):
        Path(root, "splits", f"{split}.json").write_text(json_.dumps(pairs))
    return root


def hci_tree(work: str) -> str:
    """MAHNOB-HCI as preprocessing/rppg.py lays it out: per session
    Metas/<id>/meta.pickle, Measures/<id>/data.pickle (bpm measures every
    2 s, 60 to 117 bpm) and cropped_faces/c23/<id>/cam.avi (224 pixels,
    HCI_SECONDS long)."""
    import pickle

    root = f"{work}/hci"
    hr_freq = 256.0
    write_videos([(f"{root}/cropped_faces/c23/{10 + i}/cam.avi", HCI_SECONDS, 224, "MJPG",
                   700 + i) for i in range(HCI_SESSIONS)])
    for i in range(HCI_SESSIONS):
        sid = str(10 + i)
        session = f"{root}/Sessions/{sid}"
        Path(session).mkdir(parents=True)
        meta = {"session_dir": session, "video_path": f"{session}/cam.avi",
                "bdf_path": f"{session}/ecg.bdf", "session_video_sample_freq": 25.0,
                "session_video_beg_sample": 0, "flag_video_beg_sample": 0,
                "session_hr_sample_freq": hr_freq, "flag_hr_beg_sample": 0,
                "duration": HCI_SECONDS}
        measures = {"idx": [int(hr_freq * t) for t in range(0, 13, 2)],
                    "data": [{"bpm": 60.0 + 3 * j + 7 * i} for j in range(7)]}
        for folder, name, obj in (("Metas", "meta.pickle", meta),
                                  ("Measures", "data.pickle", measures)):
            Path(root, folder, sid).mkdir(parents=True)
            Path(root, folder, sid, name).write_bytes(pickle.dumps(obj))
    return root


def recipe_config(work: str, name: str, src: str, changes: list) -> str:
    """``src`` (a YAML under configs/) with ``changes`` [(keys, value)]
    applied, each printed; the written file's path."""
    import yaml

    path_ = Path(__file__).resolve().parent / "configs" / src
    cfg = yaml.safe_load(path_.read_text())
    for keys, value in changes:
        node = cfg
        for k in keys[:-1]:
            node = node[k]
        print(f"  {src}: {'.'.join(map(str, keys))} {node.get(keys[-1])!r} -> {value!r}",
              flush=True)
        node[keys[-1]] = value
    out = Path(work) / f"{name}.yaml"
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


def roots_changes(cfg_src: str, roots: dict) -> list:
    """The data roots of every train and eval entry of ``cfg_src``."""
    import yaml

    cfg = yaml.safe_load((Path(__file__).resolve().parent / "configs" / cfg_src).read_text())
    return [(("data", where, i, "root_dir"), roots[d["name"]])
            for where in ("train", "eval") for i, d in enumerate(cfg["data"][where])]


def steps_changes(steps: int, every: int, tracking: str) -> list:
    return [(("trainer", "max_steps"), steps), (("system", "evaluation_interval"), every),
            (("system", "training_eval_interval"), every), (("tracking", "directory"), tracking)]


def eval_metrics(run: str, prefix: str) -> dict:
    """{step: {metric or loss name: value}} of a run's evaluations."""
    out = {}
    for line in Path(run, "metrics.jsonl").read_text().splitlines():
        r = json.loads(line)
        got = {k.split("/", 1)[1]: v for k, v in r.items() if k.startswith(prefix + "/")}
        if got:
            out.setdefault(r["step"], {}).update(got)
    return out


def device_step(label: str, fn, card: str, per: str) -> None:
    """A step's ms by CUDA events (3 after 1), the peak memory while they ran
    and one traced step's device busy share."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(fn, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: {ms:.2f} ms per {per}, peak memory {peak / 1e9:.3f} GB, "
          f"{(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB allocated before, "
          f"on {card}", flush=True)
    profile_device(label, fn)


def compinv_paths(card: str, work: str, trees: dict) -> dict:
    """configs/comp-inv-encoder/deepfake.yaml through the training CLI
    ([train cli compinv]), its adapter read by the flagship recipe as
    ``adapter.type: pretrain`` ([train cli pretrain]), then
    configs/cross-task/mix.yaml ([train cli mix]), in ``work`` beside the
    flagship ``trees`` (cli_trees). Returns the launch counts of the CompInv
    run ("compinv") and of the mix run ("mix")."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.models.adapter import CompInvEncoder
    from dfd_clip_tpu_torch.models.weights import load_params, save_params
    from dfd_clip_tpu_torch.ops import _cuda

    print("[train cli compinv] the training CLI on the CompInv adapter pretrainer "
          "(configs/comp-inv-encoder/deepfake.yaml: ViT-B/16, 50 frames, keep 0-10 stride 2, "
          "768-x-768 adapter x 256, batch 5 raw / c23 pairs), its adapter read as "
          "adapter.type pretrain, then the cross-task mix (configs/cross-task/mix.yaml)",
          flush=True)
    counts = {}
    t0 = time.perf_counter()
    pairs_root, hci = compinv_tree(work), hci_tree(work)
    print(f"  trees: FFPP raw / c23 pairs of {COMPINV_SECONDS} s and {HCI_SESSIONS} HCI "
          f"sessions of {HCI_SECONDS} s, MJPG at 224 pixels, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- [train cli compinv] -----------------------------------------------------
    src = "comp-inv-encoder/deepfake.yaml"
    print(f"[train cli compinv] python -m dfd_clip_tpu_torch.main --cfg <{src}, changed "
          "as printed> --video_backend opencv", flush=True)
    cfg = recipe_config(work, "compinv", src,
                        roots_changes(src, {"FFPP": pairs_root})
                        + steps_changes(CLI_STEPS, CLI_EVERY, f"{work}/logs"))
    keep = {}
    run, counts["compinv"], steps, evals = cli_run(card, work, cfg, compinv=True, keep=keep)
    trainer, batch = keep["trainer"], keep["batch"]
    model = trainer.model
    if len(steps) != CLI_STEPS or [e["step"] for e in evals] != [2, 4]:
        raise SystemExit(f"FAIL train cli compinv: {len(steps)} steps, evaluations at "
                         f"{[e['step'] for e in evals]}")
    for st in steps:
        if not (np.isfinite(st["losses"]["match"]) and st["losses"]["recon"] == 0.0):
            raise SystemExit(f"FAIL train cli compinv step {st['step']}: {st['losses']} "
                             "(mode 1: recon 0, match finite)")
    print(f"  {steps[0]['clips']} clips of {model.num_frames} frames a step "
          f"({steps[0]['clips'] * model.num_frames} frames, keep "
          f"{list(model.layer_indices)}, mode {model.mode}, adapter "
          f"{model.adapter_cfg.struct_type} x {model.adapter_cfg.inner_dim})", flush=True)
    names = sorted(p.name for p in Path(run).iterdir())
    print(f"  run directory {Path(run).relative_to(work)}: {', '.join(names)}", flush=True)
    if "best_weights.pt" not in names or "last_weights.pt" not in names:
        raise SystemExit("FAIL train cli compinv: no best_weights.pt / last_weights.pt")
    got = eval_metrics(run, "compinvevaluator")
    for step in (2, 4):
        print(f"  evaluation at step {step}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(got.get(step, {}).items())), flush=True)
        if not np.isfinite(got.get(step, {}).get("loss/match", np.nan)):
            raise SystemExit(f"FAIL train cli compinv: no finite loss/match at step {step}")
    first = load_params(f"{run}/last_weights.pt")
    if set(first["trainable"]) != {"adapter"} or first["steps"] != CLI_STEPS:
        raise SystemExit("FAIL train cli compinv: last_weights.pt is not {trainable: "
                         "{adapter}, steps}")
    # the adapter moved: its leaves now against the same leaves before step 0
    moved = max((a - b).abs().max().item() for a, b in zip(
        _leaf_tensors(trainer.trainable["adapter"]), keep["start"]))
    print(f"  the adapter's leaves moved by up to {moved:.3e}", flush=True)
    if not moved > 0:
        raise SystemExit("FAIL train cli compinv: the adapter did not train")
    # one step's match through the kernels against the plain versions
    params = trainer.eval_params()
    with torch.no_grad():
        _, match_k = model.forward(params, batch["x"], batch["comp_is_raw"], train=False)
        with plain_versions():
            _, match_p = model.forward(params, batch["x"], batch["comp_is_raw"],
                                       train=False)
    rel = abs(match_k.item() - match_p.item()) / abs(match_p.item())
    print(f"  match through the kernels {match_k.item():.6f}, plain {match_p.item():.6f}, "
          f"rel {rel:.3e} (tol {TOL_COMPINV:g})", flush=True)
    if not rel <= TOL_COMPINV:
        raise SystemExit(f"FAIL train cli compinv: match rel {rel:.3e}")
    if _cuda.plain_calls():
        raise SystemExit(f"FAIL train cli compinv: plain calls {_cuda.plain_calls()}")
    dev_round = [("deepfake/ffpp", batch)]
    device_step("device-resident CompInv step", lambda: trainer.train_step(dev_round), card,
                f"{batch['x'].shape[0]}-clip batch ({batch['x'].shape[0] * model.num_frames}"
                " frames)")
    adapter_file = f"{work}/compinv_adapter.pt"
    save_params(adapter_file, {"adapter": trainer.trainable["adapter"]})
    del trainer, keep, params, batch, dev_round
    torch.cuda.empty_cache()

    # -- [train cli pretrain] ----------------------------------------------------
    src = "deepfake/deepfake.yaml"
    print(f"[train cli pretrain] the CompInv adapter ({{'adapter': ...}} by save_params) "
          f"read by {src} as adapter.type pretrain, frozen", flush=True)
    cfg = recipe_config(work, "pretrain", src, roots_changes(src, trees) + [
        (("model", "adapter", "type"), "pretrain"), (("model", "adapter", "frozen"), 1),
        (("model", "adapter", "path"), adapter_file),
        (("model", "adapter", "struct", "type"), "768-x-768"),
        (("trainer", "max_steps"), 2), (("system", "evaluation_interval"), 4),
        (("system", "training_eval_interval"), 2),
        (("tracking", "directory"), f"{work}/logs_pretrain")])
    keep = {}
    run, _, psteps, pevals = cli_run(card, work, cfg, keep=keep)
    trainer, batch = keep["trainer"], keep["batch"]
    det = trainer.model
    if len(psteps) != 2 or pevals:
        raise SystemExit(f"FAIL train cli pretrain: {len(psteps)} steps, {len(pevals)} "
                         "evaluations")
    if "adapter" in trainer.trainable or "adapter" not in trainer.frozen_run:
        raise SystemExit("FAIL train cli pretrain: the adapter is not frozen")
    saved = load_params(adapter_file)["adapter"]
    placed = det.prepare_params({"adapter": saved_tensors(saved)})["adapter"]
    equal = all(torch.equal(a, b)
                for a, b in zip(_leaf_tensors(trainer.frozen_run["adapter"]),
                                _leaf_tensors(placed)))
    print(f"  the frozen adapter after 2 steps equals the file's, placed: {equal}",
          flush=True)
    if not equal:
        raise SystemExit("FAIL train cli pretrain: the frozen adapter changed")
    ccfg = CompInvEncoder.get_default_config()
    ccfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": list(KEEP),
                               "adapter": {"struct": {"type": "768-x-768", "x": 256}}})
    enc = CompInvEncoder(ccfg, num_frames=FRAMES, device="cuda")
    with torch.no_grad():
        _, feats = det.predict(trainer.eval_params(), batch["x"], batch["m"],
                               with_adapt_features=True)
        want, _ = enc.predict({"encoder": trainer.frozen_run["encoder"],
                               "adapter": trainer.frozen_run["adapter"]}, batch["x"])
    err = max(compare(f"pretrain adapted {s.upper()} layer {i}", g, w, TOL_DECODER)
              for s in ("k", "v") for i, (g, w) in enumerate(zip(feats["adapt"][s], want[s])))
    print(f"  the Detector's adapted K/V against CompInvEncoder.predict's on the same "
          f"{batch['x'].shape[0]} clips: worst {err:.3e} of the max (tol {TOL_DECODER:g})",
          flush=True)
    del trainer, keep, det, enc, feats, want, batch
    torch.cuda.empty_cache()

    # -- [train cli mix] ---------------------------------------------------------
    src = "cross-task/mix.yaml"
    print(f"[train cli mix] python -m dfd_clip_tpu_torch.main --cfg <{src}, changed as "
          "printed> --video_backend opencv", flush=True)
    cfg = recipe_config(work, "mix", src,
                        roots_changes(src, {"RPPG": hci, "FFPP": trees["FFPP"]})
                        + steps_changes(MIX_STEPS, MIX_STEPS, f"{work}/logs_mix"))
    keep = {}
    run, counts["mix"], msteps, mevals = cli_run(card, work, cfg, keep=keep)
    if len(msteps) != MIX_STEPS or [e["step"] for e in mevals] != [MIX_STEPS]:
        raise SystemExit(f"FAIL train cli mix: {len(msteps)} steps, evaluations at "
                         f"{[e['step'] for e in mevals]}")
    for st in msteps:
        if st["tasks"] != 2 or set(st["losses"]) != {"rppg/rppg", "deepfake/ffpp"}:
            raise SystemExit(f"FAIL train cli mix step {st['step']}: {st['losses']}")
    got = eval_metrics(run, "evaluator")
    for step, values in sorted(got.items()):
        print(f"  evaluation at step {step}: rppg/rppg rmse "
              f"{values.get('metric/rppg/rppg/rmse', 'not reported')} (the JAX package's "
              "rmse takes bpm labels, the recipe's are distributions), loss/rppg/rppg "
              f"{values.get('loss/rppg/rppg', float('nan')):.6f}, deepfake/ffpp accuracy "
              f"{values.get('metric/deepfake/ffpp/accuracy', float('nan')):.4f}, roc_auc "
              f"{values.get('metric/deepfake/ffpp/roc_auc', float('nan')):.4f}", flush=True)
        for k in ("loss/rppg/rppg", "metric/deepfake/ffpp/accuracy",
                  "metric/deepfake/ffpp/roc_auc"):
            if not np.isfinite(values.get(k, np.nan)):
                raise SystemExit(f"FAIL train cli mix: evaluation at step {step}: {k}")
    trainer, mix_round = keep["trainer"], keep["round"]
    device_step("device-resident mix step", lambda: trainer.train_step(mix_round), card,
                " + ".join(f"{b['x'].shape[0]}-clip {n} batch" for n, b in mix_round))
    del trainer, mix_round, keep
    torch.cuda.empty_cache()
    return counts


def saved_tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: saved_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [saved_tensors(v) for v in tree]
    return torch.from_numpy(tree)


# [train modes]: (label, model overrides, the decoder's L and valid keys a sample)
TRAIN_MODES = (
    ("compression sync", {"adapter": {"type": "normal",
                                      "struct": {"type": "768-x-768", "x": 256}},
                          "train_mode": {"compression": "sync"}}, FRAMES * 196, FRAMES * 196),
    ("compression feature-match", {"train_mode": {"compression": "feature-match"},
                                   "op_mode": {"temporal_position": 1, "global_prediction": 1}},
     FRAMES * 200, FRAMES * 196),
    ("temporal ranking", {"train_mode": {"temporal": "ranking"}}, FRAMES * 200, FRAMES * 196),
    ("temporal triplet", {"train_mode": {"temporal": "triplet"}}, FRAMES * 200, FRAMES * 196),
    ("ema_frame 0.5", {"op_mode": {"temporal_position": 1, "ema_frame": 0.5}}, 200, 196),
    ("patch_mask sample 0.5", {"train_mode": {"patch_mask": {"type": "sample", "ratio": 0.5}}},
     FRAMES * 98, FRAMES * 98),
)


def train_modes(card: str) -> dict:
    """One flagship Trainer step (batch TRAIN_CLIPS, 20 frames, keep 6-11,
    dropout 0.5; the sync mode's adapter as adapter_params(det, 0.1) makes
    it) in each of TRAIN_MODES through the kernels: finite task and
    auxiliary losses, the decoder attention's launches at the mode's L,
    _bwd_math never; then every backward call of a step on its own inputs
    held to _bwd_math and every gradient leaf to the decoder-plain route
    (hold_train_step's decoder hold). Rows 2i and 2i + 1 of the batch are a
    raw / c23 pair of one clip. Returns the steps' launches."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.trainer import Trainer, order_triplets
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_attention_vjp as vjp
    from dfd_clip_tpu_torch.ops import fused_decoder_attention_bwd as fdb

    # rows 2i and 2i + 1 a raw / c23 pair, as FFPP with pair 1 collates them:
    # the same frames, the c23 member with seeded noise of up to 12 levels
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (TRAIN_CLIPS // 2, FRAMES, 3, 224, 224), np.uint8)
    noisy = np.clip(frames.astype(np.int16) + rng.integers(-12, 13, frames.shape), 0, 255)
    raw = (np.stack([frames, noisy.astype(np.uint8)], axis=1).reshape(
               TRAIN_CLIPS, FRAMES, 3, 224, 224),
           (np.arange(TRAIN_CLIPS) // 2 % 2).astype(np.int32),
           np.ones((TRAIN_CLIPS, FRAMES), bool),
           ["raw" if i % 2 == 0 else "c23" for i in range(TRAIN_CLIPS)],
           (0.5 + 0.5 * rng.random(TRAIN_CLIPS)).astype(np.float32),
           np.zeros(TRAIN_CLIPS, np.int64))
    del frames, noisy
    total, seen, kernel = {}, [], vjp.fused_decoder_attention

    def recording(q_smax, q_coda, k, v, mask, *args, **kwargs):
        seen.append((k.shape[-3], int(mask[0].sum().item())))
        return kernel(q_smax, q_coda, k, v, mask, *args, **kwargs)

    for label, over, length, valid in TRAIN_MODES:
        det = detector(dropout=0.5, **over)
        tcfg = Trainer.get_default_config()
        tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3})
        # the adapter at [train cli adapter step]'s conditioned scale: fc2 at a
        # tenth of its draw
        params = adapter_params(det, 0.1) if "adapter" in over else None
        trainer = Trainer(tcfg, det, {"deepfake": [raw]}, params=params, seed=0)
        batch = trainer.prepare_batch(raw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        seen.clear()
        vjp.fused_decoder_attention = recording
        t0 = time.perf_counter()
        try:
            trainer.train_step([("deepfake", batch)])
        finally:
            vjp.fused_decoder_attention = kernel
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        counts, plain = _cuda.launches(), _cuda.plain_calls()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        losses = {k: float(np.mean(v)) for k, v in trainer.batch_losses.items()}
        print(f"[train modes] {label}: losses " + ", ".join(f"{k} {v:.6f}"
                                                           for k, v in losses.items())
              + f"; decoder attention at (L, valid keys a sample) {sorted(set(seen))}, "
              f"{step_ms:.2f} ms (host clock, the mode's first step, synchronised), "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, on {card}; "
              f"launches {json.dumps(counts)}", flush=True)
        aux = {"compression": {"recon", "match"}, "temporal ranking": {"speed/rank"},
               "temporal triplet": {"speed/triplet"}}
        want = next((v for k, v in aux.items() if label.startswith(k)), set())
        if set(losses) != {"deepfake"} | want or not np.isfinite(list(losses.values())).all():
            raise SystemExit(f"FAIL train modes {label}: losses {losses}")
        if set(seen) != {(length, valid)} or len(seen) != len(KEEP):
            raise SystemExit(f"FAIL train modes {label}: decoder attention at {seen}, expected "
                             f"{len(KEEP)} calls at L {length} with {valid} valid keys")
        check_counts(f"train modes {label}", counts, TRAIN_COUNTS, 1)
        if plain:
            raise SystemExit(f"FAIL train modes {label}: plain calls {plain}")
        # the step's own extras, drawn again for both routes of the hold
        patch_indices, triplets = trainer._host_extras(TRAIN_CLIPS)
        if triplets is not None:
            triplets = order_triplets(triplets, raw[4])
        extras = {"patch_indices": patch_indices, "triplet_indices": triplets}
        # each backward call on the step's own inputs against _bwd_math
        calls, bwd = [], vjp.fused_decoder_attention_bwd

        def both(*args, **kwargs):
            got = bwd(*args, **kwargs)
            want = fdb.fused_decoder_attention_bwd_plain(*args, **kwargs)
            calls.append(max((g.float() - w.float()).abs().max().item()
                             / max(w.float().abs().max().item(), 1e-30)
                             for g, w in zip(got, want) if w is not None))
            return got

        vjp.fused_decoder_attention_bwd = both
        try:
            step_grads(det, trainer, batch, extras=extras)
        finally:
            vjp.fused_decoder_attention_bwd = bwd
        print(f"  {len(calls)} backward calls on the step's own inputs vs _bwd_math, worst "
              f"{max(calls):.3e} of its max (tol {TOL_DECODER:g})", flush=True)
        if len(calls) != len(KEEP) or not max(calls) <= TOL_DECODER:
            raise SystemExit(f"FAIL train modes {label}: backward calls {calls}")
        grads = hold_train_step(det, trainer, batch, f"train modes {label}",
                                routes=("decoder",), extras=extras)["decoder"]
        # the step's conditioning, recorded: the same route with every
        # parameter nudged by 1e-4 of itself
        gen = torch.Generator(device="cuda").manual_seed(3)
        with torch.no_grad():
            for t in _leaf_tensors(trainer.trainable):
                t.mul_(1 + 1e-4 * (2 * torch.rand(t.shape, generator=gen, device=t.device) - 1))
        _, nudged = step_grads(det, trainer, batch, "decoder", extras)
        worst = max((n - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                    for n, g in zip(nudged, grads))
        print(f"  conditioning (recorded, not held): the decoder-plain route against itself "
              f"with every parameter nudged by 1e-4 of itself, worst leaf {worst:.3e} (max rel)",
              flush=True)
        del det, trainer, batch, params, grads, nudged
        torch.cuda.empty_cache()
    return total


def timed_train_step(label: str, trainer, dev_round: list, card: str) -> None:
    """A device-resident train step's ms by CUDA events (5 after 1), and the
    peak memory allocated while they ran, beside what was already allocated
    when they started (the live tensors of the run, the step's parameters
    and batch included)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(lambda: trainer.train_step(dev_round), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: {ms:.2f} ms per {TRAIN_CLIPS}-clip batch ({TRAIN_CLIPS * 1e3 / ms:.2f} "
          f"clips/s), peak memory {peak / 1e9:.3f} GB, {(peak - base) / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB allocated before the steps, on {card}", flush=True)


def _leaf_tensors(tree) -> list:
    from dfd_clip_tpu_torch.engine.optim import named_leaves

    return [t for _, t in named_leaves(tree)]


def step_grads(det, trainer, batch: dict, plain: str = "", extras: dict = None) -> tuple:
    """(loss, gradients of the trainable leaves) of one train-mode step of
    ``trainer``'s parameters on ``batch`` (dropout seed 7), through the
    kernels or, with ``plain`` "decoder" or "all", the plain versions of the
    decoder's kernels or of every kernel. ``extras``: the step's
    patch_indices / triplet_indices; the loss is the task loss plus the
    auxiliary losses, as the Trainer's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    with plain_versions(encoder=plain == "all") if plain else contextlib.nullcontext():
        losses, _, other = det.forward({**trainer.frozen_run, **trainer.trainable}, batch["x"],
                                       [batch["label"]], batch["m"], batch["comp_is_raw"],
                                       batch.get("speed"), train=True, single_task=0, gen=gen,
                                       **(extras or {}))
        loss = losses[0].mean() + sum(v.mean() for v in other.values())
        return loss.item(), list(torch.autograd.grad(loss, _leaf_tensors(trainer.trainable)))


def hold_train_step(det, trainer, batch: dict, label: str, hold_all: bool = True,
                    extras: dict = None, routes: tuple = ("decoder", "all")) -> dict:
    """One step's loss and the gradient of every trainable leaf (the
    adapter's too, when the Detector has one) through the kernels, held
    against the same step (parameters, batch, dropout seed, ``extras``)
    through the plain versions: the decoder kernels alone, then all kernels
    (with ``hold_all`` False the latter's leaves are printed, not held);
    ``routes`` the plain routes taken. Returns each plain route's
    gradients."""
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves

    leaves = named_leaves(trainer.trainable)
    # Decoder kernels alone: the same export decoded through the kernels and
    # through their plain versions, held at TOL_DECODER on the loss and
    # TOL_ENCODER of each leaf's max. The whole plain route also swaps the
    # encoder, whose bf16 export differs from the kernels' by rounding order
    # (about 7e-3 of the predict logits); the backward at dropout 0.5 amplifies
    # that, so its leaves are held by relative L2 norm at TOL_TRAIN_GRAD.
    loss_k, grads_k = step_grads(det, trainer, batch, extras=extras)
    taken = {}
    for route, plain, measure, tol in (("decoder kernels", "decoder", "max", TOL_ENCODER),
                                       ("all kernels", "all", "l2", TOL_TRAIN_GRAD)):
        if plain not in routes:
            continue
        loss_p, grads_p = taken[plain] = step_grads(det, trainer, batch, plain, extras)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  {route} vs plain: loss {loss_k:.6f} vs {loss_p:.6f}, rel {rel:.3e} "
              f"(tol {TOL_DECODER:g})", flush=True)
        if not rel <= TOL_DECODER:
            raise SystemExit(f"FAIL {label} loss ({route}): relative error {rel:.3e} > "
                             f"{TOL_DECODER:g}")
        worst = []
        for (path, _), gk, gp in zip(leaves, grads_k, grads_p):
            if measure == "max":
                err = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
            else:
                err = (gk - gp).norm().item() / max(gp.norm().item(), 1e-30)
            held = hold_all or plain == "decoder"
            if not torch.isfinite(gk).all() or held and not err <= tol:
                raise SystemExit(f"FAIL {label} gradient ({route}) {path}: {measure} rel "
                                 f"{err:.3e} > {tol:g}")
            worst.append((err, ".".join(map(str, path))))
        worst.sort(reverse=True)
        verdict = (f"within {tol:g}" if hold_all or plain == "decoder" else
                   f"recorded, {sum(e > tol for e, _ in worst)} past {tol:g}")
        print(f"  {route}: {len(worst)} gradient leaves {verdict} ({measure} rel); worst "
              + ", ".join(f"{name} {e:.3e}" for e, name in worst[:3]), flush=True)
        adapter = [e for e, name in worst if name.startswith("adapter")]
        if adapter:
            print(f"  {route}: {len(adapter)} adapter leaves, worst {max(adapter):.3e}",
                  flush=True)
    return {plain: grads for plain, (_, grads) in taken.items()}


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
               halves: bool = False, hold_bf16: bool = False, drift: bool = True):
    """A Scorer over ``det`` with params ``raws[0]`` answers the four
    requests (counted); then, on the params of every seed in ``raws`` and on
    the batches of the last two requests, the kernels, the bf16 plain route
    and the f32 plain route are compared (hold_wide), and the kernels' logits
    and per-clip |dP(fake)| must lie within TOL_LOGITS_F32 and TOL_PFAKE_F32
    of the f32 route on every batch (a miss fails the run after the phase);
    with ``hold_bf16`` their |dP(fake)| must also lie within TOL_PFAKE of the
    bf16 plain route on every batch; a device-resident predict is timed and
    traced; with ``halves`` each block's two halves are read on the same
    input (half_drift); without ``drift`` the kept layers' K/V and the
    attention outputs are not read layer by layer (kv_drift). Returns
    (counts, the logits of seed 0 on the last request's batch)."""
    import torch

    from dfd_clip_tpu_torch.serve import Scorer

    scorer = Scorer(det, raws[0], batch_size=CLIPS)
    requests = make_requests()
    counts = answer(scorer, requests, card, label)
    check_counts(label, counts, expected, len(requests), used=used)
    det32 = copy.copy(det)
    det32.compute_dtype = torch.float32
    readings = []
    if drift:
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
    first, last = TOWER_WIDE_KEEP[0], TOWER_WIDE_KEEP[-1]
    nsel = len(TOWER_WIDE_KEEP)
    for t, arch in ((WIDE_TOKENS, "vitl"), (L336_TOKENS, "vitl336")):
        h = torch.randn(n, t, w, generator=dgen, device=dev).to(bf)
        m_rows = n * t
        print(f"  tower at {t} tokens: grid {[_cuda.tower_grid(t, True, a) for a in ('0', '1', 'qk')]}"
              f" blocks (int8 attention 0, 1, qk) on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
        for mode in ("0", "1", "qk"):
            label = {"0": "", "1": " attn", "qk": " qk"}[mode]
            name = f"fused_encoder_tower int8{label} 24 layers {t}"
            kw = dict(keep=TOWER_WIDE_KEEP, drop_cls=True, int8_gemm=True, int8_attn=mode)
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
            chain_ms = time_ms(lambda: bts.kernel_chain(h, blocks, hh, TOWER_WIDE_KEEP, True,
                                                        mode, kc, vc), iters=2, warmup=1)
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
            tower_timings(name, h, blocks, hh, TOWER_WIDE_KEEP, True, mode, ms, chain_ms)
        del h
        torch.cuda.empty_cache()
    del blocks
    torch.cuda.empty_cache()


def ladder_counts(rung: str) -> dict:
    """A ladder rung's encoder and decoder launches a predict (LADDER_LAYERS
    layers: the blocks before the last kept layer and its K/V columns)."""
    decoder = {"fused_decoder_attention": 6, "decoder_boundary": 7}
    n = LADDER_LAYERS - 1
    if rung.startswith("tower"):
        return {**TOWER_COUNTS, **decoder}
    if rung == "split":   # the MLP's rows quantised in c_fc: no quant_rows
        return {"fused_encoder_attn_block": n + 1, "fused_encoder_mlp_block": n,
                "fused_encoder_block": 0, "fused_encoder_tower": 0, "encoder_attention": n,
                "encoder_attention_int8": 0, "gemm_s8_quant": n, "quant_rows": 0,
                "layer_norm_rows": 0, **decoder}
    int8_attn = rung == "full_attn"
    return {"fused_encoder_block": n, "fused_encoder_attn_block": 1,
            "fused_encoder_mlp_block": 0, "fused_encoder_tower": 0,
            "encoder_attention": 0 if int8_attn else n,
            "encoder_attention_int8": n if int8_attn else 0, "gemm_s8_quant": n,
            "quant_rows": n, **NO_BF16_ROWS, **decoder}


def ladder_detector(kernels, cfg: dict):
    """``detector(kernels, **cfg)`` with its tower cut to LADDER_LAYERS."""
    det = detector(kernels, **cfg)
    det.vit_cfg = dataclasses.replace(det.vit_cfg, layers=LADDER_LAYERS)
    return det


def ladder_paths(card: str) -> dict:
    """The megaL ladder on ViT-L/14 and ViT-L/14@336px (LADDER_LAYERS
    layers, the last 6 kept, compute_int8, one parameter seed each): each
    rung of LADDER_RUNGS
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
        base = ladder_detector(None, cfg)
        tokens = base.vit_cfg.num_tokens
        if base.layer_indices != LADDER_KEEP or base.vit_cfg.layers != LADDER_LAYERS:
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
            print(f"[{tag} ladder {rung}] {arch} at {LADDER_LAYERS} layers, EncoderKernels("
                  f"{kernels}), compute_int8, keep {LADDER_KEEP[0]}-{LADDER_KEEP[-1]}",
                  flush=True)
            det = ladder_detector(kernels, cfg)
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
                chain = ladder_detector({"block": "full",
                                         "int8_attn": kernels.get("int8_attn", "0")}, cfg)
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


# DINOv2 ViT-g/14 (giant2: width 1536, 40 layers, 24 heads, the fused SwiGLU
# FFN), kept layers 34-39: every layer runs
GIANT_KEEP = tuple(range(34, 40))
# the Detector's decoder options (op_mode), each a Trainer step and a predict
OPTIONS = {"attn_mode frame": {"attn_mode": "frame"},
           "attn_mode temporal": {"attn_mode": "temporal"},
           "attn_mode temporal+frame": {"attn_mode": "temporal+frame"},
           "aug_query": {"aug_query": 1}}
# launches of a flagship train step with the W8A8 encoder (the whole int8
# block a layer, the int8 last_only layer) and of the decoder's kernels
INT8_TRAIN_COUNTS = {"fused_encoder_block": 11, "fused_encoder_attn_block": 1,
                     "fused_decoder_attention": 6, "fused_decoder_attention_bwd": 6,
                     "fused_decoder_attention_int8": 0, "decoder_boundary": 0}


def check_giant_kernels(rows: list) -> None:
    """The ViT-g/14 path's kernels at its shapes (320 frames x 257 tokens,
    width 1536, 24 heads): the decoder boundary at width 1536 (MLP 6144) in
    its streamed form, held and timed in its three forms as at the narrower
    widths (check_decoder_boundary), the separate-entry encoder attention at
    (320, 257, 24 x 64), layer_norm_rows on (82240, 1536) rows, and the
    decoder attention at 24 heads over L = 20 x 256. Widths 768 and 1024
    keep the resident form. The boundary's device time a call is traced in
    a new process (boundary_device_times): this late in the run the
    profiler loses rows."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    n, t, w, hh, bf = CLIPS * FRAMES, WIDE_TOKENS, 1536, 24, torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    sms = _cuda._sms(0)
    forms = {w_: _cuda.boundary_geometry(w_, 4 * w_, CLIPS, sms) for w_ in (768, 1024, w)}
    geo = forms[w]
    print(f"  decoder_boundary forms: " + ", ".join(f"{w_} {g['form']} ({g['smem']} bytes)"
                                                    for w_, g in forms.items())
          + f"; at {w}: chunks of {geo['kc']} K values through {geo['slots']} slots, grid "
          f"{geo['grid']}", flush=True)
    if [g["form"] for g in forms.values()] != ["resident", "resident", "streamed"]:
        raise SystemExit("FAIL decoder_boundary: widths 768 / 1024 must stay resident, 1536 "
                         "streamed")
    blk = random_block(gen, dev, cfg=dataclasses.replace(clip_vit.VIT_B16, width=w, heads=hh))
    check_decoder_boundary(rows, "decoder_boundary width 1536 (streamed)", blk, 7,
                           ("dinov2_giant",))
    del blk
    here = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-c", f"import chip_smoke; "
                          f"chip_smoke.boundary_device_times({w})"], cwd=here,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the boundary's traces (exit {res.returncode}):\n"
                         f"{res.stderr[-3000:]}")
    traced = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"  decoder_boundary width {w}, device ms a call traced in a new process "
          "(a trace this late in the run loses rows; null: not measured): "
          + ", ".join(f"{form} {v[0] if v[0] is None else round(v[0], 4)} ({v[1]} of {v[2]} "
                      f"launches traced)" for form, v in traced.items()), flush=True)
    qkv = torch.randn(n, t, 3 * w, generator=gen).to(dev, bf)
    q, k, v = (s_.reshape(n, t, hh, 64) for s_ in qkv.split(w, dim=-1))
    attention_row(rows, "fused_encoder_attention 24 heads",
                  "dfd_clip_tpu/ops/pallas_attention.py:1346",
                  lambda: att.fused_encoder_attention(q, k, v),
                  lambda: att.plain_attention(q, k, v), qkv, n, t, hh, ("dinov2_giant",),
                  counter="fused_encoder_attention")
    del qkv, q, k, v
    ln = {"scale": (1.0 + 0.1 * torch.randn(w, generator=gen)).to(dev),
          "bias": (0.1 * torch.randn(w, generator=gen)).to(dev)}
    h2 = torch.randn(n * t, w, generator=gen).to(dev, bf)
    check_layer_norm(rows, f"layer_norm_rows {n * t} x {w}", h2, ln, ("dinov2_giant",))
    del h2
    check_decoder_attention(rows, "fused_decoder_attention 24 heads, L 5120", gen, dev, hh,
                            t - 1, t - 1, ("dinov2_giant",))
    torch.cuda.empty_cache()


def boundary_device_times(width: int) -> None:
    """Each form's device time a call of the decoder boundary at ``width``
    on tools/bench_decoder_boundary.py's inputs (16 rows), from
    launches_ms, printed as one JSON line {form: [ms or null, rows traced,
    launches issued]}. Run in a process of its own by check_giant_kernels."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_stack as ds
    from dfd_clip_tpu_torch.tools import bench_decoder_boundary as tbd

    _cuda.library()
    inputs = tbd.boundary_inputs(width, torch.device("cuda"))
    print(json.dumps({form: launches_ms(
        lambda f=form: ds.decoder_boundary(*tbd.form_args(f, *inputs)), 1)
        for form in tbd.FORMS}))


def giant_serve_path(card: str) -> dict:
    """A DINOv2 ViT-g/14 Scorer (keep 34-39, bf16, random weights from a
    seeded torch.Generator) answers the four requests, counted against the
    launches the code gives a predict: the encoder attention once a layer
    before the last kept one, layer_norm_rows twice a layer and once more
    (the last kept layer runs LN1 and its qkv only), the decoder's 6
    attention and 7 boundary launches; then held against the f32 plain
    route as the DINOv2 B/14 path is (wide_serve, one seed), timed and
    traced."""
    import torch

    det = detector(foundation="dinov2", architecture="ViT-g/14",
                   decode_indices=list(GIANT_KEEP))
    cfg, last = det.vit_cfg, max(det.layer_indices)
    expected = {"fused_encoder_attention": last, "layer_norm_rows": 2 * last + 1,
                "fused_decoder_attention": len(GIANT_KEEP),
                "decoder_boundary": len(GIANT_KEEP) + 1, "fused_encoder_attention_qkv": 0,
                "fused_encoder_attn_block": 0, "fused_encoder_mlp_block": 0, "gemm": 0}
    print(f"  ViT-g/14: width {cfg.width}, {cfg.layers} layers, {cfg.heads} heads, SwiGLU "
          f"hidden {cfg.swiglu_hidden}, {cfg.num_tokens} tokens; launches a predict: "
          f"{json.dumps(expected)}", flush=True)
    t0 = time.perf_counter()
    raw = det.init_params(torch.Generator().manual_seed(0))
    count = sum(t_.numel() for t_ in _leaf_tensors(raw))
    print(f"  random init on the host (torch.Generator seed 0): {count} parameters, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts, _ = wide_serve(card, "dinov2 giant serve", det, [raw], expected,
                           used=("fused_encoder_attention", "layer_norm_rows"), drift=False)
    del raw
    torch.cuda.empty_cache()
    return counts


def kv_int8_serve_path(card: str) -> dict:
    """A Scorer over the flagship with op_mode kv_dtype "int8" (per-(layer,
    head) scales, dequantised at the export) answers the four requests,
    counted as the bf16 flagship; one batch is held against its own plain
    route at TOL_PFAKE and read against the bf16-K/V predict on the same
    parameters (|dP(fake)| recorded); a device-resident predict is timed."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.serve import Scorer

    det = detector(op_mode={"temporal_position": 1, "kv_dtype": "int8"})
    raw = det.init_params(torch.Generator().manual_seed(0))
    scorer = Scorer(det, raw, batch_size=CLIPS)
    requests = make_requests()
    counts = answer(scorer, requests, card, "kv int8 serve")
    check_counts("kv int8 serve", counts, FLAGSHIP_COUNTS, len(requests))
    x, m = last_batch(requests)
    got = hold_against_plain("kv int8 predict",
                             lambda x_, m_: scorer.predict(scorer.params, x_, m_), x, m)
    bf16 = detector()
    with torch.no_grad():
        (ref,), _ = bf16.predict(bf16.prepare_params(raw), x, m)
    cos = F.cosine_similarity(got.float().flatten(), ref.float().flatten(), dim=0).item()
    print(f"  kv int8 vs bf16 K/V, same params and batch: |dP(fake)| max "
          f"{p_delta(got, ref):.3e}, logits cosine {cos:.6f} (recorded)", flush=True)
    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    ms = time_ms(lambda: scorer.predict(scorer.params, xd, md), iters=5, warmup=1)
    print(f"  device-resident kv int8 predict: {ms:.2f} ms per {CLIPS}-clip batch "
          f"({CLIPS * 1e3 / ms:.2f} clips/s) on {card}", flush=True)
    profile_device("kv int8 predict", lambda: scorer.predict(scorer.params, xd, md))
    return counts


def train_batches(n: int, seed: int = 1) -> list:
    """``n`` seeded flagship train batches (TRAIN_CLIPS uint8 clips of
    FRAMES 224-pixel frames, labels alternating), in the six-field form."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = (np.arange(TRAIN_CLIPS) % 2).astype(np.int32)
    return [(rng.integers(0, 256, (TRAIN_CLIPS, FRAMES, 3, 224, 224), np.uint8), labels,
             np.ones((TRAIN_CLIPS, FRAMES), bool), ["raw"] * TRAIN_CLIPS,
             np.ones(TRAIN_CLIPS, np.float32), np.zeros(TRAIN_CLIPS, np.int64))
            for _ in range(n)]


def counted_run(trainer, label: str) -> dict:
    """trainer.run() with every launch counter zeroed just before and read
    just after; each step's loss printed (a non-finite one aborts the step).
    Returns the counts."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import _cuda

    losses = []
    trainer.add_callback("on_batch_end", lambda t: losses.append(
        float(np.mean(t.batch_losses["deepfake"]))))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    trainer.run()
    torch.cuda.synchronize()
    counts = _cuda.launches()
    print(f"  {label}: losses " + ", ".join(f"{v:.6f}" for v in losses), flush=True)
    if len(losses) != trainer.config.max_steps or not np.isfinite(losses).all():
        raise SystemExit(f"FAIL {label}: losses {losses}")
    return counts


def int8_train_path(card: str) -> dict:
    """Flagship Trainers (batch 12, dropout 0.5, SGD + OneCycle) with the
    W8A8 encoder, in two forms: compute_int8, and compute_int8 + int8_rows
    (each slot dequantised to bf16 for the trainable attention). Two steps
    each, counted; one step's loss and every decoder leaf's gradient through
    the kernels held to the decoder-plain route on the same K/V; a
    device-resident step timed (events) and traced (busy share), the bf16
    step timed the same way beside them. Returns the counts by path."""
    import torch

    from dfd_clip_tpu_torch.engine.trainer import Trainer

    batches = train_batches(2)
    counts = {}
    for label, path, op in (("bf16", None, {}), ("compute_int8", "int8_train",
                                                  {"compute_int8": 1}),
                            ("compute_int8 + int8_rows", "int8_rows_train",
                             {"compute_int8": 1, "kv_dtype": "int8_rows"})):
        det = detector(dropout=0.5, op_mode={"temporal_position": 1, **op})
        tcfg = Trainer.get_default_config()
        tcfg.merge_from_other_cfg({"max_steps": 2, "learning_rate": 2.5e-3})
        trainer = Trainer(tcfg, det, {"deepfake": batches}, seed=0)
        batch = trainer.prepare_batch(batches[0])
        if path is not None:
            counts[path] = counted_run(trainer, f"int8 train {label}")
            check_counts(f"int8 train {label}", counts[path], INT8_TRAIN_COUNTS, 2,
                         used=("gemm_s8", "gemm_s8_quant", "layer_norm_quant"))
            hold_train_step(det, trainer, batch, f"int8 train {label}", routes=("decoder",))
        dev_round = [("deepfake", batch)]
        timed_train_step(f"device-resident {label} train step", trainer, dev_round, card)
        profile_device(f"{label} train step", lambda: trainer.train_step(dev_round))
        del trainer, det, batch, dev_round
        torch.cuda.empty_cache()
    return counts


def options_path(card: str) -> dict:
    """For each decoder option (OPTIONS: the factorised attn_mode "frame",
    "temporal", "temporal+frame", and aug_query with its offsets drawn away
    from their zero init) one flagship Trainer step (batch 12, dropout 0.5)
    and one predict (batch 16), each counted: 0 decoder attention launches
    (forward or backward) and 0 boundary launches with attn_mode, whose
    attention is the torch composition; 6 attention (6 backward in the
    step) and 0 boundary launches with aug_query. The step's loss finite,
    its ms by events; the predict's P(fake) held to its plain route at
    TOL_PFAKE. Returns the counts of the steps and predicts, summed."""
    import torch

    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.ops import _cuda

    batches = train_batches(1, seed=2)
    x, m = last_batch(make_requests())
    xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")
    total = {}
    for label, op in OPTIONS.items():
        det = detector(dropout=0.5, op_mode={"temporal_position": 1, **op})
        raw = det.init_params(torch.Generator().manual_seed(0))
        if "aug_query" in op:
            raw["decoder"]["aug_query"] = 0.1 * torch.randn(
                raw["decoder"]["aug_query"].shape, generator=torch.Generator().manual_seed(3))
        attn = 0 if "attn_mode" in op else len(KEEP)
        tcfg = Trainer.get_default_config()
        tcfg.merge_from_other_cfg({"max_steps": 1, "learning_rate": 2.5e-3})
        trainer = Trainer(tcfg, det, {"deepfake": batches}, params=raw, seed=0)
        step = counted_run(trainer, f"{label} step")
        check_counts(f"{label} step", step, {
            "fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
            "fused_decoder_attention": attn, "fused_decoder_attention_bwd": attn,
            "decoder_boundary": 0}, 1)
        params = trainer.eval_params()
        predict = functools.partial(det.predict, params)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with torch.no_grad():
            (logits,), _ = predict(xd, md)
        torch.cuda.synchronize()
        counted = _cuda.launches()
        check_counts(f"{label} predict", counted, {
            "fused_encoder_attn_block": 12, "fused_encoder_mlp_block": 11,
            "fused_decoder_attention": attn, "decoder_boundary": 0}, 1)
        if not torch.isfinite(logits).all():
            raise SystemExit(f"FAIL {label} predict: logits not finite")
        hold_against_plain(f"{label} predict", lambda x_, m_: predict(x_, m_)[0][0], xd, md)
        dev_round = [("deepfake", trainer.prepare_batch(batches[0]))]
        step_ms = time_ms(lambda: trainer.train_step(dev_round), iters=3, warmup=1)
        with torch.no_grad():
            pred_ms = time_ms(lambda: predict(xd, md), iters=5, warmup=1)
        print(f"  {label}: device-resident step {step_ms:.2f} ms ({TRAIN_CLIPS} clips), "
              f"predict {pred_ms:.2f} ms ({CLIPS} clips) on {card}", flush=True)
        for k, v in list(step.items()) + list(counted.items()):
            total[k] = total.get(k, 0) + v
        del trainer, det, raw, params, dev_round
        torch.cuda.empty_cache()
    return total


def int8_gates_path(card: str) -> dict:
    """The four int8 AUROC gates (dfd_clip_tpu_torch/tools/int8_gates.py,
    the port of tests/test_int8_e2e.py:47-250) at flagship width on the
    card's kernels, JAX's step counts and thresholds, over the two fixture
    trees the tool writes (numpy + cv2), counted. Returns the counts."""
    import tempfile

    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.runtime import OneProcess
    from dfd_clip_tpu_torch.tools import int8_gates

    class Quiet(OneProcess):
        def print(self, *a, **k):
            pass

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with tempfile.TemporaryDirectory() as work:
        out = int8_gates.run_gates(int8_gates.flagship_factory("cuda"), work, Quiet("cuda"),
                                   log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    counts = _cuda.launches()
    print(f"  the four gates in {time.perf_counter() - t0:.1f} s on {card}; kernels "
          f"{json.dumps(counts)}", flush=True)
    if out["failures"]:
        raise SystemExit("FAIL int8 gates:\n" + "\n".join(out["failures"]))
    for name in ("fused_encoder_block", "fused_decoder_attention_bwd", "decoder_boundary",
                 "fused_encoder_tower", "fused_decoder_attention_int8"):
        if counts.get(name, 0) <= 0:
            raise SystemExit(f"FAIL int8 gates: {name} never launched")
    return counts


# -- the SSL slice: DINOv2 pretraining and its evaluation --------------------------------

# configs/ssl/base.yaml at full width and depth (ViT-B/14, out_dim 65536,
# batch 32, 2 x 224 globals and 8 x 98 locals, remat 1, fsdp 1) on
# --synthetic 256, with these changes so that 6 steps run both sides of the
# prototype freeze and a checkpoint in the middle
SSL_CFG, SSL_SYNTHETIC, SSL_STEPS = "ssl/base.yaml", 256, 6
SSL_CHANGES = (("warmup_steps", 2), ("freeze_last_layer_steps", 2),
               ("warmup_teacher_temp_steps", 2), ("checkpoint_interval", 3))
# encoder attention launches of a train step at ViT-B/14 with remat 1: 12 for
# the teacher, 12 for the student's global crops, 12 for its local crops and
# 24 recomputed in the backward (36 with remat 0); by token count, 36 at 257
# (globals) and 24 at 50 (locals); 12 a feature batch of extract_features
SSL_STEP_LAUNCHES = {257: 36, 50: 24}
SSL_FEATURE_LAUNCHES = 12
# ssl_eval's labelled folders: classes (told apart by colour), train and
# test images a class, at 224 pixels
SSL_EVAL_IMAGES = (3, 16, 8, 224)


@contextlib.contextmanager
def attention_tally(tally):
    """Tally the separate-q/k/v encoder attention's launches by token count
    (``tally[t] += 1`` where ``_cuda.encoder_attention_separate`` is called,
    which fused_encoder_attention calls exactly where it counts a launch)."""
    from dfd_clip_tpu_torch.ops import _cuda

    entry = _cuda.encoder_attention_separate

    def tallied(q, k, v, *args, **kwargs):
        tally[q.shape[1]] += 1
        return entry(q, k, v, *args, **kwargs)

    _cuda.encoder_attention_separate = tallied
    try:
        yield tally
    finally:
        _cuda.encoder_attention_separate = entry


@contextlib.contextmanager
def plain_ssl_attention():
    """dinov2_forward's blocks through plain_attention (under autograd where
    the tower takes a gradient) in place of the kernel's Function: the
    plain route of the SSL holds."""
    from dfd_clip_tpu_torch.models import dinov2_vit
    from dfd_clip_tpu_torch.ops import attention as att

    kernel = dinov2_vit.trainable_encoder_attention
    dinov2_vit.trainable_encoder_attention = att.plain_attention
    try:
        yield
    finally:
        dinov2_vit.trainable_encoder_attention = kernel


def ffmpeg_probe() -> dict:
    """What the native video decoder (g++ over FFmpeg's libraries) would need
    on this machine, looked up without installing anything: FFmpeg's
    development headers, its shared libraries (the unversioned ``.so`` that
    ``-lavformat`` links against, and versioned runtime ones), pkg-config's
    view of them, and g++."""
    import glob
    import shutil

    incs = ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu",
            "/usr/include/ffmpeg")
    libdirs = ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib", "/usr/local/lib")
    out = {}
    for header in ("libavformat/avformat.h", "libavcodec/avcodec.h", "libswscale/swscale.h"):
        out[header] = next((str(Path(i, header)) for i in incs if Path(i, header).is_file()),
                           None)
    for lib in ("libavformat", "libavcodec", "libswscale", "libavutil"):
        found = sorted(f for d in libdirs for f in glob.glob(f"{d}/{lib}.so*"))
        out[f"{lib}.so"] = next((f for f in found if f.endswith(".so")), None)
        out[f"{lib} runtime"] = [f for f in found if not f.endswith(".so")][:2]
    try:
        import cv2

        bundled = sorted(glob.glob(str(Path(cv2.__file__).resolve().parent.parent
                                       / "opencv_python*.libs" / "libavformat*")))
        out["cv2's bundled libavformat"] = bundled[:1]
    except ImportError:
        out["cv2's bundled libavformat"] = None
    pc = shutil.which("pkg-config")
    out["pkg-config libavformat"] = None
    if pc:
        res = subprocess.run([pc, "--modversion", "libavformat", "libavcodec", "libswscale"],
                             capture_output=True, text=True, timeout=30)
        out["pkg-config libavformat"] = (res.stdout.split() if res.returncode == 0
                                         else res.stderr.strip()[:120])
    gxx = shutil.which("g++")
    out["g++"] = gxx and subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                        timeout=30).stdout.splitlines()[0]
    out["native decoder buildable"] = bool(out["libavformat/avformat.h"]
                                           and out["libavcodec/avcodec.h"]
                                           and out["libswscale/swscale.h"]
                                           and out["libavformat.so"] and out["libavcodec.so"]
                                           and out["libswscale.so"] and gxx)
    return out


def check_ssl_kernels(rows: list) -> None:
    """The encoder attention at the SSL path's shapes, separate q / k / v on
    strided views of one packed buffer: the 224-pixel global crops (64
    frames of 257 tokens: 2 crops of batch 32) and the 98-pixel local crops
    (256 frames of 50 tokens: 8 crops of 32), each against its plain version
    with the scaled_dot_product_attention yardstick; then the trainable
    Function's dq, dk and dv (kernel forward, encoder_attention_vjp
    backward) against autograd through plain_attention in f32 on the same
    bf16 inputs and cotangent, within TOL_ENCODER of each one's max, and
    the backward timed."""
    import torch

    from dfd_clip_tpu_torch.ops import attention as att

    dev, bf, hh, w = torch.device("cuda"), torch.bfloat16, 12, 768
    gen = torch.Generator().manual_seed(21)
    for n, t in ((64, 257), (256, 50)):
        qkv = torch.randn(n, t, 3 * w, generator=gen).to(dev, bf)
        q, k, v = (s.reshape(n, t, hh, 64) for s in qkv.split(w, dim=-1))
        attention_row(rows, f"fused_encoder_attention ssl {t} tokens",
                      "dfd_clip_tpu/ops/pallas_attention.py:1346",
                      lambda: att.fused_encoder_attention(q, k, v),
                      lambda: att.plain_attention(q, k, v), qkv, n, t, hh,
                      (f"ssl_train_{t}",) + (("ssl_eval_257",) if t == 257 else ()),
                      counter="fused_encoder_attention")
        ct = torch.randn(n, t, hh, 64, generator=gen).to(dev, bf)
        got = qkv.detach().clone().requires_grad_()
        att.trainable_encoder_attention(*(s.reshape(n, t, hh, 64)
                                          for s in got.split(w, dim=-1))).backward(ct)
        want = qkv.detach().float().requires_grad_()
        att.plain_attention(*(s.reshape(n, t, hh, 64) for s in want.split(w, dim=-1))
                            ).backward(ct.float())
        for i, name in enumerate(("dq", "dk", "dv")):
            err = rel_err(got.grad[..., i * w:(i + 1) * w], want.grad[..., i * w:(i + 1) * w])
            print(f"  trainable attention {t} tokens {name}: rel_err {err:.3e} against "
                  f"autograd through plain_attention in f32 (tol {TOL_ENCODER:g})", flush=True)
            if not err <= TOL_ENCODER:
                raise SystemExit(f"FAIL trainable attention {t} tokens {name}: rel_err "
                                 f"{err:.3e} > {TOL_ENCODER:g}")
        bwd = time_ms(lambda: att.encoder_attention_vjp(q, k, v, ct), iters=5, warmup=1)
        print(f"  trainable attention {t} tokens: backward (torch products) {bwd:.3f} ms by "
              f"CUDA events", flush=True)
        del qkv, q, k, v, ct, got, want
    torch.cuda.empty_cache()


def ssl_config(work: str, changes: tuple) -> str:
    """configs/ssl/base.yaml with ``changes`` (key, value) applied, each
    printed; the written file's path."""
    import yaml

    cfg = yaml.safe_load((Path(__file__).resolve().parent / "configs" / SSL_CFG).read_text())
    for key, value in changes:
        print(f"  {SSL_CFG}: {key} {cfg.get(key)!r} -> {value!r}", flush=True)
        cfg[key] = value
    out = Path(work) / "ssl.yaml"
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


def ssl_cli_run(out_dir: str, cfg: str, tally) -> tuple:
    """python -m dfd_clip_tpu_torch.ssl_train's main in this process (--cfg
    ``cfg``, --synthetic SSL_SYNTHETIC, --steps SSL_STEPS) with every train
    step observed: the launch counters and the tally zeroed just before the
    step and read just after, its ms by CUDA events and on the host clock
    (synchronised), the peak memory, its losses, and whether each head's
    prototype layer (last_v, last_g) moved. Returns (trainer, steps)."""
    import torch

    from dfd_clip_tpu_torch import ssl_train
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ssl.train import SSLTrainer

    steps, step_fn = [], SSLTrainer.train_step

    def observed(self, g, loc, masks, step):
        before = [t.detach().clone() for h in ("dino_head", "ibot_head")
                  for t in (self.student[h]["last_v"], self.student[h]["last_g"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        tally.clear()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = step_fn(self, g, loc, masks, step)
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        after = [self.student[h][k] for h in ("dino_head", "ibot_head")
                 for k in ("last_v", "last_g")]
        steps.append({"step": step, "losses": {k: float(v) for k, v in out.items()},
                      "ms": start.elapsed_time(end), "host_ms": host,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": _cuda.launches(), "by_tokens": dict(tally),
                      "moved": [not torch.equal(a, b) for a, b in zip(after, before)]})
        return out

    SSLTrainer.train_step = observed
    try:
        trainer = ssl_train.main(ssl_train.parse_args(
            ["--cfg", cfg, "--synthetic", str(SSL_SYNTHETIC), "--steps", str(SSL_STEPS),
             "--out_dir", out_dir]))
    finally:
        SSLTrainer.train_step = step_fn
    return trainer, steps


def ssl_train_path(card: str, work: str) -> tuple:
    """ssl_train on configs/ssl/base.yaml at full width and depth, changed
    as SSL_CHANGES prints: every step's dino / ibot / koleo / total finite,
    SSL_STEP_LAUNCHES attention launches a step (60 with remat), the
    prototype layers unchanged through the freeze window (steps 0 and 1)
    and moved after it; then a run resumed from step 3's checkpoint
    against the uninterrupted run's teacher and student (bit-equal, or
    the largest difference printed); then the step traced in a child
    process (its busy share). Returns (the first run's counts by path, its
    run directory)."""
    import collections
    import shutil

    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves

    cfg = ssl_config(work, SSL_CHANGES)
    tally = collections.Counter()
    run = str(Path(work) / "ssl_run")
    print(f"[ssl train] python -m dfd_clip_tpu_torch.ssl_train --cfg <base.yaml, changed as "
          f"printed> --synthetic {SSL_SYNTHETIC} --steps {SSL_STEPS}", flush=True)
    with attention_tally(tally):
        trainer, steps = ssl_cli_run(run, cfg, tally)
    want = {"fused_encoder_attention": sum(SSL_STEP_LAUNCHES.values())}
    freeze = dict(SSL_CHANGES)["freeze_last_layer_steps"]
    for s in steps:
        print(f"  step {s['step']}: " + ", ".join(f"{k} {v:.6f}" for k, v in s["losses"].items())
              + f"; {s['ms']:.2f} ms by CUDA events, {s['host_ms']:.2f} ms on the host clock, "
              f"peak memory {s['peak_gb']:.3f} GB, launches {json.dumps(s['launches'])}, by "
              f"tokens {json.dumps(s['by_tokens'])}, prototypes moved {s['moved']}; on {card}",
              flush=True)
        if not all(np.isfinite(v) for v in s["losses"].values()):
            raise SystemExit(f"FAIL ssl train step {s['step']}: losses {s['losses']}")
        if s["launches"] != want or s["by_tokens"] != SSL_STEP_LAUNCHES:
            raise SystemExit(f"FAIL ssl train step {s['step']}: launches {s['launches']} by "
                             f"tokens {s['by_tokens']}, expected {want} {SSL_STEP_LAUNCHES}")
        if s["moved"] != [s["step"] >= freeze] * 4:
            raise SystemExit(f"FAIL ssl train step {s['step']}: last_v / last_g moved "
                             f"{s['moved']} with freeze_last_layer_steps {freeze}")
    if [s["step"] for s in steps] != list(range(SSL_STEPS)):
        raise SystemExit(f"FAIL ssl train: steps {[s['step'] for s in steps]}")
    names = sorted(p.name for p in Path(run).iterdir())
    ckpts = sorted(p.name for p in (Path(run) / "checkpoints").iterdir())
    print(f"  run directory: {names}; checkpoints {ckpts}", flush=True)
    if not {"setting.yaml", "teacher_backbone.pt", "checkpoints"} <= set(names) or \
            ckpts != ["step_00000003", "step_00000006"]:
        raise SystemExit(f"FAIL ssl train: run directory {names}, checkpoints {ckpts}")
    counts = {f"ssl_train_{t}": {"fused_encoder_attention": n * SSL_STEPS}
              for t, n in SSL_STEP_LAUNCHES.items()}

    print("[ssl train resume] a run resumed from step 3's checkpoint to step 6", flush=True)
    resumed_dir = Path(work) / "ssl_resumed"
    shutil.copytree(Path(run) / "checkpoints" / "step_00000003",
                    resumed_dir / "checkpoints" / "step_00000003")
    resumed, rsteps = ssl_cli_run(str(resumed_dir), cfg, collections.Counter())
    if [s["step"] for s in rsteps] != [3, 4, 5] or resumed.optimizer.count != SSL_STEPS:
        raise SystemExit(f"FAIL ssl train resume: steps {[s['step'] for s in rsteps]}, "
                         f"optimizer count {resumed.optimizer.count}")
    for name in ("teacher", "student"):
        pairs = list(zip(named_leaves(getattr(trainer, name)),
                         named_leaves(getattr(resumed, name))))
        differ = [(path, (a - b).abs().max().item(), a.abs().max().item())
                  for (path, a), (_, b) in pairs if not torch.equal(a, b)]
        if not differ:
            print(f"  {name}: bit-equal to the uninterrupted run ({len(pairs)} leaves)",
                  flush=True)
        else:
            worst = max(differ, key=lambda d: d[1] / max(d[2], 1e-30))
            print(f"  {name}: {len(differ)} of {len(pairs)} leaves differ from the "
                  f"uninterrupted run; largest {worst[1]:.3e} at {'.'.join(map(str, worst[0]))} "
                  f"(max |value| {worst[2]:.3e})", flush=True)
    for s, r in zip(steps[3:], rsteps):
        print(f"  step {r['step']}: total {r['losses']['total']:.6f} resumed, "
              f"{s['losses']['total']:.6f} uninterrupted", flush=True)
    del resumed
    torch.cuda.empty_cache()
    trace = ssl_trace_child(cfg)
    print(f"  traced step (a child process, step 2 of 3 with the prefetch thread live): wall "
          f"{trace['wall_ms']:.2f} ms, device busy {trace['device_ms']:.2f} ms "
          f"({100 * trace['busy']:.1f} %), {trace['kernels']} device kernels and copies; on "
          f"{card}", flush=True)
    for ms, count, key in trace["top"]:
        print(f"    {ms:9.3f} ms {count:5d}x {key}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return counts, run


def ssl_trace() -> None:
    """One SSL train step traced with torch.profiler (the third of three, the
    prefetch thread running as in a real run) on configs/ssl/base.yaml with
    SSL_CHANGES at full width; prints one JSON line: the step's wall ms
    (synchronised), the device rows' summed ms, their share, their count
    and the eight largest. Run in a process of its own by ssl_trace_child."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.runtime import OneProcess
    from dfd_clip_tpu_torch.ssl_train import SyntheticImages
    from dfd_clip_tpu_torch.ssl.train import SSLTrainer

    _cuda.library()
    cfg = SSLTrainer.get_default_config()
    cfg.merge_from_file(sys.argv[1])
    cfg.max_steps, cfg.checkpoint_interval = 3, 0
    trainer = SSLTrainer(cfg, OneProcess("cuda"), SyntheticImages(SSL_SYNTHETIC), device="cuda")
    out, step_fn = {}, trainer.train_step

    def traced(g, loc, masks, step):
        if step != 2:
            return step_fn(g, loc, masks, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = step_fn(g, loc, masks, step)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.self_cpu_time_total == 0 and device_us(e) > 0
                  and not getattr(e, "is_user_annotation", False)]
        out["device_ms"] = sum(device_us(e) for e in events) / 1e3
        out["busy"] = out["device_ms"] / out["wall_ms"]
        out["kernels"] = sum(e.count for e in events)
        out["top"] = [(device_us(e) / 1e3, e.count, e.key[:70])
                      for e in sorted(events, key=lambda e: -device_us(e))[:8]]
        return res

    trainer.train_step = traced
    trainer.run()
    print(json.dumps(out))


def ssl_trace_child(cfg: str) -> dict:
    """ssl_trace in a new process (the kernels already built), waited for."""
    here = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.ssl_trace()",
                          cfg], cwd=here, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the SSL step's trace (exit {res.returncode}):\n"
                         f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def ssl_route_holds(card: str) -> None:
    """One SSLTrainer step (base.yaml, batch 32, full width) with
    drop_path_rate 0.1 and one with centering sinkhorn_knopp: first one
    forward_loss + gradient through the kernels held against the plain
    route (plain_attention under autograd) on the same params, batch and
    stochastic-depth seed, the loss within TOL_DECODER relative and every
    student leaf within a relative L2 of TOL_TRAIN_GRAD; the step's own
    sensitivity recorded beside it (the plain route against itself with
    every parameter nudged by 1e-4 of itself); then the step itself,
    counted (SSL_STEP_LAUNCHES) and its losses finite."""
    import collections

    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.runtime import OneProcess
    from dfd_clip_tpu_torch.ssl_train import SyntheticImages
    from dfd_clip_tpu_torch.ssl.train import SSLTrainer

    base = Path(__file__).resolve().parent / "configs" / SSL_CFG
    for label, change in (("drop_path_rate", 0.1), ("centering", "sinkhorn_knopp")):
        print(f"[ssl train {label}] an SSLTrainer step on {SSL_CFG} with {label} {change!r}",
              flush=True)
        cfg = SSLTrainer.get_default_config()
        cfg.merge_from_file(str(base))
        cfg.merge_from_other_cfg({label: change, "checkpoint_interval": 0})
        trainer = SSLTrainer(cfg, OneProcess("cuda"), SyntheticImages(SSL_SYNTHETIC),
                             device="cuda")
        trainer._sampler_iter = iter(range(cfg.batch_size))
        g, loc, masks = (trainer._place(a) for a in trainer._next_batch(cfg.batch_size))

        def loss_grads(plain: bool) -> tuple:
            with plain_ssl_attention() if plain else contextlib.nullcontext():
                total, _ = trainer.meta.forward_loss(
                    trainer.student, trainer.teacher, trainer.centers, g, loc, masks,
                    trainer.temp_schedule(0), gen=trainer._drop_path_gen(0))
                return total.item(), list(torch.autograd.grad(total, trainer.leaves))

        loss_k, grads_k = loss_grads(False)
        loss_p, grads_p = loss_grads(True)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        errs = sorted(((gk - gp).norm().item() / max(gp.norm().item(), 1e-30),
                       ".".join(map(str, path)))
                      for path, gk, gp in zip(trainer.optimizer.paths, grads_k, grads_p))[::-1]
        with torch.no_grad():
            ngen = torch.Generator(device="cuda").manual_seed(3)
            for t in trainer.leaves:
                t.mul_(1 + 1e-4 * (2 * torch.rand(t.shape, generator=ngen, device=t.device) - 1))
        _, grads_n = loss_grads(True)
        print(f"  kernels vs plain route: loss {loss_k:.6f} vs {loss_p:.6f}, rel {rel:.3e} (tol "
              f"{TOL_DECODER:g}); {len(errs)} student leaves, worst l2 rel "
              + ", ".join(f"{name} {e:.3e}" for e, name in errs[:3])
              + f" (tol {TOL_TRAIN_GRAD:g}); sensitivity (recorded, not held): the plain "
              f"route against itself with every parameter nudged by 1e-4 of itself, worst "
              f"leaf {l2_rel(grads_n, grads_p):.3e} (l2 rel)", flush=True)
        if not rel <= TOL_DECODER or not errs[0][0] <= TOL_TRAIN_GRAD or \
                not all(torch.isfinite(x).all() for x in grads_k):
            raise SystemExit(f"FAIL ssl train {label}: loss rel {rel:.3e}, worst leaf "
                             f"{errs[0]}")
        del grads_k, grads_p, grads_n
        torch.cuda.synchronize()
        _cuda.reset_launches()
        tally = collections.Counter()
        with attention_tally(tally):
            t0 = time.perf_counter()
            losses = {k: float(v) for k, v in trainer.train_step(g, loc, masks, 0).items()}
            torch.cuda.synchronize()
        counted = _cuda.launches()
        print(f"  step: " + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
              + f"; {(time.perf_counter() - t0) * 1e3:.2f} ms on the host clock; launches "
              f"{json.dumps(counted)}, by tokens {json.dumps(dict(tally))}; on {card}",
              flush=True)
        if not all(np.isfinite(v) for v in losses.values()) or \
                dict(tally) != SSL_STEP_LAUNCHES:
            raise SystemExit(f"FAIL ssl train {label}: losses {losses}, launches {counted}")
        del trainer, g, loc, masks
        torch.cuda.empty_cache()


def ssl_eval_path(card: str, work: str, run: str) -> dict:
    """ssl_eval on the exported teacher_backbone.pt over cv2-written
    labelled folders (SSL_EVAL_IMAGES: classes told apart by colour), in
    every mode: SSL_FEATURE_LAUNCHES attention launches each feature batch
    (counters zeroed just before it and read just after), the CLS features
    of the train folder within TOL_ENCODER of the plain route's max, the
    results printed. Returns the run's counts by path."""
    import collections

    import cv2
    import numpy as np
    import torch

    from dfd_clip_tpu_torch import ssl_eval
    from dfd_clip_tpu_torch.models import dinov2_vit
    from dfd_clip_tpu_torch.models import weights as weights_lib
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ssl import evals

    n_cls, n_train, n_test, size = SSL_EVAL_IMAGES
    rng = np.random.default_rng(31)
    colours = [(200, 60, 60), (60, 200, 60), (60, 60, 200)]
    for split, n in (("train", n_train), ("test", n_test)):
        for c in range(n_cls):
            d = Path(work) / "ssl_eval" / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                img = np.clip(np.array(colours[c])[None, None]
                              + rng.normal(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
                cv2.imwrite(str(d / f"{i}.png"), img)
    weights = str(Path(run) / "teacher_backbone.pt")
    print(f"[ssl eval] python -m dfd_clip_tpu_torch.ssl_eval --weights <run>/teacher_backbone.pt "
          f"--arch ViT-B/14 --mode knn linear linear-grid logreg over {n_cls} classes x "
          f"{n_train} train / {n_test} test cv2-written {size}-pixel images", flush=True)
    calls, tally, cls = [], collections.Counter(), evals._cls

    def counted(params, arch, x, dtype):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        tally.clear()
        out = cls(params, arch, x, dtype)
        calls.append((len(x), _cuda.launches(), dict(tally)))
        return out

    evals._cls = counted
    try:
        with attention_tally(tally):
            t0 = time.perf_counter()
            results = ssl_eval.main(ssl_eval.parse_args(
                ["--weights", weights, "--train_dir", str(Path(work) / "ssl_eval" / "train"),
                 "--test_dir", str(Path(work) / "ssl_eval" / "test"), "--size", str(size),
                 "--mode", "knn", "linear", "linear-grid", "logreg"]))
            wall = time.perf_counter() - t0
    finally:
        evals._cls = cls
    print(f"  results {json.dumps(results)}; {wall:.2f} s on the host clock; feature batches "
          f"(images, launches, by tokens): {calls}; on {card}", flush=True)
    want = {"fused_encoder_attention": SSL_FEATURE_LAUNCHES}
    tokens = (size // 14) ** 2 + 1
    if [c[0] for c in calls] != [n_cls * n_train, n_cls * n_test] or \
            any(c[1] != want or c[2] != {tokens: SSL_FEATURE_LAUNCHES} for c in calls):
        raise SystemExit(f"FAIL ssl eval: feature batches {calls}")
    if set(results) != {"knn_top1", "linear_top1", "linear_grid_top1", "linear_grid_best",
                        "logreg_top1"}:
        raise SystemExit(f"FAIL ssl eval: results {results}")
    state = weights_lib.load_params(weights)
    backbone = weights_lib.to_device(weights_lib.params_from_jax(state["backbone"]), "cuda")
    x, _, _ = ssl_eval.load_labeled_folder(str(Path(work) / "ssl_eval" / "train"), size)
    arch = dinov2_vit.ARCHITECTURES["ViT-B/14"]
    got = torch.from_numpy(evals.extract_features(backbone, arch, x))
    with plain_ssl_attention():
        plain = torch.from_numpy(evals.extract_features(backbone, arch, x))
        plain32 = torch.from_numpy(evals.extract_features(backbone, arch, x,
                                                          compute_dtype=torch.float32))
    print(f"  ssl eval CLS features, kernels vs the bf16 plain route: rel_err "
          f"{rel_err(got, plain):.3e}; the bf16 plain route vs the f32 plain route: "
          f"{rel_err(plain, plain32):.3e}", flush=True)
    compare("ssl eval CLS features, kernels vs the f32 plain route", got, plain32, TOL_ENCODER)
    del backbone
    torch.cuda.empty_cache()
    return {f"ssl_eval_{tokens}": {"fused_encoder_attention": sum(
        c[1]["fused_encoder_attention"] for c in calls)}}


def ssl_paths(card: str) -> dict:
    """The SSL slice's phases in one work directory; their counts by path."""
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        counts, run = ssl_train_path(card, work)
        ssl_route_holds(card)
        counts.update(ssl_eval_path(card, work, run))
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


# [zero shot]: CLIP's zero-shot surface at ViT-B/16 width
ZS_PROMPTS = ("a photo of a real face.", "a photo of a fake face.",
              "a face swapped by deepfakes.", "a face reenacted by face2face.",
              "a face swapped by faceswap.", "a face rendered by neural textures.",
              "an unaltered video frame of a person talking, lit from the left.",
              "a blurry, over-compressed frame (c23) of a newsreader!")
ZS_IMAGES = 2 * len(ZS_PROMPTS)   # images through each image tower: a pair a prompt
ZS_NUDGE = 0.1            # the second image of a pair: the first + this x fresh noise
TOL_TEXT = 1e-3           # the text tower on the card vs the CPU, f32 (TF32 off)
TOL_RN = 5e-2             # RN50 in bf16 vs its f32 route on the card
ZS_COUNTS = {"fused_encoder_attention_qkv": 12, "layer_norm_rows": 24}
# [analysis]: the encoder-analysis CLIs on the [train cli] FFPP tree
AN_COUNTS = {"fused_encoder_attention_qkv": 12, "layer_norm_rows": 24}   # a clip forward


def zero_shot_path(card: str, rows: list) -> dict:
    """CLIP's zero-shot surface at ViT-B/16 width: the prompts tokenised
    with the repo's BPE table (framing, EOT at each row's argmax); the text
    tower ("ViT-B/16": 12 layers, width 512, 77 tokens, causal, f32) on the
    card held to the CPU's; the pooled image features of ViT-B/16 (seeded
    ln_post and proj) on ZS_IMAGES images in bf16 through the packed
    attention kernel, counted (ZS_COUNTS) and held to the bf16 plain route,
    the f32 route's distance printed; RN50 in bf16 held to its f32 route;
    the (images, prompts) zero-shot logits held to the f32 route's at
    TOL_ENCODER of their max, each image's argmax held to its pair's
    prompt on both routes (the text projection fitted so that prompt j's
    feature shares the f32 image features' mean direction and what sets
    images j and j + 8 apart); the packed attention at the path's shape
    against its plain version; each tower timed by CUDA events. Returns
    the vision forward's counts ("zs")."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.data import tokenizer
    from dfd_clip_tpu_torch.models import clip_resnet, clip_text, clip_vit
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    dev, bf = torch.device("cuda"), torch.bfloat16
    tok = tokenizer.ClipTokenizer()
    tokens = tokenizer.tokenize(list(ZS_PROMPTS), tok)
    eot_at = (tokens == tok.eot).argmax(-1)
    framed = (tokens[:, 0] == tok.sot).all() and (tokens.argmax(-1) == eot_at).all() and all(
        (row[e + 1:] == 0).all() for row, e in zip(tokens, eot_at))
    print(f"  tokens {tokens.shape}: lengths {(eot_at + 1).tolist()}, framed {bool(framed)}",
          flush=True)
    if not framed:
        raise SystemExit("FAIL [zero shot]: the tokens are not framed <sot> ... <eot> 0...")

    tcfg = clip_text.ARCHITECTURES["ViT-B/16"]
    tparams = clip_text.init_clip_text(torch.Generator().manual_seed(30), tcfg)
    tokens_d = torch.as_tensor(tokens, device=dev)
    want_txt = clip_text.clip_text_encode(tparams, tokens, tcfg)
    tcard = to_card(tparams)
    txt = clip_text.clip_text_encode(tcard, tokens_d, tcfg)
    compare("[zero shot] text features (card vs CPU, f32)", txt, want_txt.to(dev), TOL_TEXT)
    txt_ms = time_ms(lambda: clip_text.clip_text_encode(tcard, tokens_d, tcfg), iters=10)

    vcfg = clip_vit.VIT_B16
    gen = torch.Generator().manual_seed(31)
    vparams = clip_vit.init_clip_vision(gen, vcfg)
    vparams["ln_post"] = {"scale": 1 + 0.1 * torch.randn(vcfg.width, generator=gen),
                          "bias": 0.1 * torch.randn(vcfg.width, generator=gen)}
    vparams["proj"] = vcfg.width ** -0.5 * torch.randn(vcfg.width, vcfg.output_dim, generator=gen)
    vbf, v32 = to_device(vparams, dev), to_card(vparams)
    base = torch.randn(len(ZS_PROMPTS), 3, 224, 224, generator=gen)
    x = torch.cat([base, base + ZS_NUDGE * torch.randn(base.shape, generator=gen)]).to(dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    img = clip_text.clip_vision_features(vbf, x, vcfg, bf)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    check_counts("zs", counts, ZS_COUNTS, 1, used=tuple(ZS_COUNTS))
    with plain_versions():
        img_plain = clip_text.clip_vision_features(vbf, x, vcfg, bf)
        img_f32 = clip_text.clip_vision_features(v32, x, vcfg, torch.float32)
    compare("[zero shot] ViT-B/16 image features (kernels vs bf16 plain)", img, img_plain,
            TOL_ENCODER)
    print(f"  ViT-B/16 image features vs the f32 route: kernels {rel_err(img, img_f32):.3e}, "
          f"bf16 plain route {rel_err(img_plain, img_f32):.3e} (recorded)", flush=True)
    vis_ms = time_ms(lambda: clip_text.clip_vision_features(vbf, x, vcfg, bf), iters=10)

    rcfg = clip_resnet.ARCHITECTURES["RN50"]
    rgen = torch.Generator().manual_seed(32)
    rparams = clip_resnet.init_clip_resnet(rgen, rcfg)

    def running_stats(tree):   # BN statistics and affine away from (0, 1)
        if isinstance(tree, list):
            for t in tree:
                running_stats(t)
        elif isinstance(tree, dict):
            if "var" in tree:
                c = tree["var"].shape[0]
                tree.update(mean=0.1 * torch.randn(c, generator=rgen),
                            var=0.5 + torch.rand(c, generator=rgen),
                            scale=1 + 0.1 * torch.randn(c, generator=rgen),
                            bias=0.1 * torch.randn(c, generator=rgen))
            for t in tree.values():
                running_stats(t)

    running_stats(rparams)
    rcard = to_card(rparams)
    rn = clip_resnet.clip_resnet_features(rcard, x, rcfg, bf)
    rn32 = clip_resnet.clip_resnet_features(rcard, x, rcfg, torch.float32)
    compare("[zero shot] RN50 features (bf16 vs its f32 route)", rn, rn32, TOL_RN)
    rn_ms = time_ms(lambda: clip_resnet.clip_resnet_features(rcard, x, rcfg, bf), iters=10)
    rn32_ms = time_ms(lambda: clip_resnet.clip_resnet_features(rcard, x, rcfg, torch.float32),
                      iters=5)

    # random towers give every image nearly one pooled feature, and every
    # prompt a cosine near 0 with it. So the prompts'
    # projection is fitted (to f32 rounding: the text tower is f32 on both
    # routes) so that prompt j's feature is the f32 image features' mean
    # direction plus the unit part, orthogonal to it, that sets pair j
    # (images j and j + 8) apart from the mean: each image's argmax is its
    # pair's prompt, and a route that moves what tells images apart moves it
    pairs = len(ZS_PROMPTS)
    mean = img_f32.mean(0)
    m = mean / mean.norm()
    d = (img_f32 - mean)[:pairs] + (img_f32 - mean)[pairs:]
    d = d - (d @ m)[:, None] * m
    targets = (m + d / d.norm(dim=-1, keepdim=True)) / 2 ** 0.5
    eye = dict(tcard, text_projection=torch.eye(tcfg.width, device=dev))
    eot_rows = clip_text.clip_text_encode(eye, tokens_d, tcfg).double()
    fitted = dict(tcard, text_projection=(torch.linalg.pinv(eot_rows) @ targets.double()).float())
    txt_zs = clip_text.clip_text_encode(fitted, tokens_d, tcfg)
    print(f"  prompt features fitted to their targets within {rel_err(txt_zs, targets):.3e} "
          "of the max (recorded)", flush=True)
    logits = clip_text.zero_shot_logits(img.float(), txt_zs, tcard["logit_scale"])
    logits32 = clip_text.zero_shot_logits(img_f32, txt_zs, tcard["logit_scale"])
    if tuple(logits.shape) != (ZS_IMAGES, pairs):
        raise SystemExit(f"FAIL [zero shot]: logits {tuple(logits.shape)}")
    top2 = logits32.topk(2, dim=-1).values
    print(f"  f32 route logits: max {logits32.abs().max().item():.4f}, spread "
          f"{(logits32.max() - logits32.min()).item():.4f}, least top-1 - top-2 margin "
          f"{(top2[:, 0] - top2[:, 1]).min().item():.4f}", flush=True)
    compare("[zero shot] logits (kernels vs the f32 route)", logits, logits32, TOL_ENCODER)
    want_top = torch.arange(ZS_IMAGES, device=dev) % pairs
    agree = (logits.argmax(-1) == logits32.argmax(-1)).float().mean().item()
    print(f"  zero-shot argmax: kernels route {logits.argmax(-1).tolist()}, f32 route "
          f"{logits32.argmax(-1).tolist()}, agreement {agree:.4f} of {ZS_IMAGES} images",
          flush=True)
    if not ((logits.argmax(-1) == want_top).all() and (logits32.argmax(-1) == want_top).all()):
        raise SystemExit("FAIL [zero shot]: an image's argmax is not its pair's prompt")
    print(f"  text tower {len(ZS_PROMPTS)} x 77 tokens f32: {txt_ms:.3f} ms; ViT-B/16 image "
          f"features {ZS_IMAGES} images bf16: {vis_ms:.3f} ms; RN50 {ZS_IMAGES} images bf16: "
          f"{rn_ms:.3f} ms (f32 {rn32_ms:.3f} ms); on {card}", flush=True)

    qkv = torch.randn(ZS_IMAGES, vcfg.num_tokens, 3 * vcfg.width,
                      generator=torch.Generator(device=dev).manual_seed(33), device=dev).to(bf)
    attention_row(rows, "fused_encoder_attention_qkv zs",
                  "dfd_clip_tpu/ops/pallas_attention.py:145",
                  lambda: att.fused_encoder_attention_qkv(qkv, vcfg.heads, 64),
                  lambda: att.plain_attention_qkv(qkv, vcfg.heads, 64), qkv, ZS_IMAGES,
                  vcfg.num_tokens, vcfg.heads, ("zs",), counter="fused_encoder_attention_qkv")
    del vbf, v32, rcard, tcard, x, qkv
    torch.cuda.empty_cache()
    return counts


def analysis_path(card: str, rows: list, ffpp: str) -> dict:
    """python -m dfd_clip_tpu_torch.tools.analysis as a user runs it (main
    in this process, on the card, ViT-B/16, random weights seeded 0, 20
    frames) over the [train cli] FFPP tree, in a working directory of its
    own: kv-dist on one clip, semantic-patches over 4 samples,
    augment-impact with the setting "any" over 2 samples, comb-impact of those
    into a guide map, each with the counters zeroed before and read after
    (12 packed attention launches a clip forward) and its pickle checked
    for its layout and finiteness; kv-dist's clip's q / k / v / out held
    block by block to the bf16 plain route on the same input (each route's
    whole export, where a layer's input carries the earlier layers'
    rounding, recorded beside it); then a flagship predict with
    patch_mask type "guide" reading the map, counted and held to its plain
    route; the packed attention at the analysis shape against its plain
    version. Returns the counts by subcommand, summed ("an")."""
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.tools import analysis

    common = ["--root", ffpp, "--arch", "ViT-B/16", "--types", "REAL", "DF", "--num-frames",
              str(FRAMES), "--seed", "0"]
    total: dict = {}
    previous = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)   # the video-table cache and misc/ lookups go under it
        try:
            def run(label, argv, forwards):
                print(f"[analysis {label}] python -m dfd_clip_tpu_torch.tools.analysis "
                      + " ".join(argv), flush=True)
                torch.cuda.synchronize()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                analysis.main(argv)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = _cuda.launches()
                expected = {k: v * forwards for k, v in AN_COUNTS.items()} if forwards else {}
                check_counts(f"analysis {label}", counts, expected, 1,
                             used=tuple(AN_COUNTS) if forwards else ())
                print(f"  {label}: {dt:.2f} s host clock, {forwards} clip forwards, on {card}",
                      flush=True)
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v

            def load(name):
                with open(name, "rb") as f:
                    return pickle.load(f)

            def finite_maps(label, tree, shape):
                leaves = [a for v in tree.values() for a in (v if isinstance(v, list) else
                                                             v.values())]
                bad = [np.shape(a) for a in leaves if np.shape(a) != shape
                       or not np.isfinite(a).all()]
                if bad or not leaves:
                    raise SystemExit(f"FAIL [analysis {label}]: maps {bad[:3]} vs {shape}")

            run("kv-dist", ["kv-dist", *common, "--index", "0", "--out-dir", "kv"], 1)
            kv = load("kv/kv_distribution.pickle")
            for comp, res in kv.items():
                for kind, shape in (("variance", (14, 14)), ("similarity", (14, 14 * FRAMES))):
                    if set(res[kind]) != set(analysis.SUBJECTS) or any(
                            len(v) != 12 for v in res[kind].values()):
                        raise SystemExit(f"FAIL [analysis kv-dist]: {comp} {kind} layout")
                    finite_maps(f"kv-dist {comp} {kind}", res[kind], shape)
            run("semantic-patches", ["semantic-patches", *common, "--num-samples", "4",
                                     "--out", "sem.pickle"], 4)
            sem = load("sem.pickle")
            for s, regions in sem.items():
                if set(regions) != set(analysis.SEMANTIC_LOCATIONS):
                    raise SystemExit("FAIL [analysis semantic-patches]: regions")
                finite_maps(f"semantic-patches {s}", regions, (768,))
            setting = "any"   # two clips: a fixed augmentation's two draws are equal
            run("augment-impact", ["augment-impact", *common, "--settings", setting,
                                   "--num-samples", "2", "--out-dir", "."], 4)
            finite_maps("augment-impact", load(f"{setting}.pickle"), (14, 14))
            run("comb-impact", ["comb-impact", "--inputs", f"{setting}.pickle", "--weights",
                                "1.0", "--out", "guide_map.pickle"], 0)
            guide = load("guide_map.pickle")
            finite_maps("comb-impact", guide, (14, 14))
            if not all(abs(m.sum() - 1.0) < 1e-9 for s in guide for m in guide[s]):
                raise SystemExit("FAIL [analysis comb-impact]: a map does not sum to 1")

            # kv-dist's clip: each block through the kernels and the bf16 plain
            # route on the same input (the plain route's previous output),
            # then the whole export of each route
            args = analysis.parse_args(["kv-dist", *common])
            args.dev = torch.device("cuda")
            params, cfg = analysis.load_encoder("ViT-B/16", args.dev)
            clip = analysis.fetch_clip(analysis.build_dataset(args, "none"), 0)["c23"]
            clip_d = torch.as_tensor(clip).cuda()
            with torch.no_grad():
                with plain_versions():
                    h = analysis.embed(params, clip_d, cfg)
                per_layer = []
                for i, bp in enumerate(params["blocks"]):
                    got = analysis.tower_block(bp, h, cfg)
                    with plain_versions():
                        want = analysis.tower_block(bp, h, cfg)
                    per_layer.append(max((rel_err(got[s][:, 1:], want[s][:, 1:]), s, i)
                                         for s in analysis.SUBJECTS))
                    h = want["out"]
            worst = max(per_layer)
            print(f"  kv-dist clip ({len(clip)} frames), each block on the same input: q / k / "
                  "v / out vs the bf16 plain route, worst a layer "
                  + " ".join(f"{r[0]:.2e}" for r in per_layer)
                  + f"; worst {worst[0]:.3e} of the max at {worst[1]} layer {worst[2]} (tol "
                  f"{TOL_ENCODER:g})", flush=True)
            if not worst[0] <= TOL_ENCODER:
                raise SystemExit(f"FAIL [analysis]: features {worst}")
            got = analysis.extract_features(params, cfg, clip, device=args.dev)
            with plain_versions():
                want = analysis.extract_features(params, cfg, clip, device=args.dev)
            drift = {s: max(float(np.abs(got[s][l] - want[s][l]).max() / np.abs(want[s][l]).max())
                            for l in range(cfg.layers)) for s in analysis.SUBJECTS}
            print("  the whole export, each route on its own stream (a layer's input carries "
                  "the earlier layers' rounding): worst a subject " + json.dumps(
                      {s: float(f"{v:.3e}") for s, v in drift.items()}) + " (recorded)",
                  flush=True)
            fwd_ms = time_ms(lambda: analysis.export_qkv_out(params, clip_d, cfg), iters=5)
            print(f"  analysis tower forward ({len(clip)} frames, q / k / v / out export): "
                  f"{fwd_ms:.3f} ms on {card}", flush=True)

            # the guide map read by a flagship Detector's patch_mask type "guide"
            det = detector(train_mode={"patch_mask": {"type": "guide", "ratio": 0.5,
                                                      "path": os.path.abspath(
                                                          "guide_map.pickle")}})
            if det.guide_map is None:
                raise SystemExit("FAIL [analysis guide]: the Detector read no guide map")
            dparams = det.prepare_params(
                to_card(det.init_params(torch.Generator().manual_seed(0))))
            idx = det.sample_patch_indices(np.random.default_rng(0))
            x, m = last_batch(make_requests())
            xd, md = torch.as_tensor(x, device="cuda"), torch.as_tensor(m, device="cuda")

            def predict(x_, m_):
                return det.predict(dparams, x_, m_, patch_indices=idx)[0][0]

            print(f"[analysis guide] flagship predict, patch_mask guide: "
                  f"{np.shape(idx)[-1]} of 196 patches a kept layer", flush=True)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            predict(xd, md)
            torch.cuda.synchronize()
            check_counts("analysis guide predict", _cuda.launches(), FLAGSHIP_COUNTS, 1)
            hold_against_plain("guide predict", predict, xd, md)
            del det, dparams, params, clip_d
        finally:
            os.chdir(previous)
    qkv = torch.randn(FRAMES, 197, 3 * 768, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(34)
                      ).to(torch.bfloat16)
    attention_row(rows, "fused_encoder_attention_qkv an",
                  "dfd_clip_tpu/ops/pallas_attention.py:145",
                  lambda: att.fused_encoder_attention_qkv(qkv, 12, 64),
                  lambda: att.plain_attention_qkv(qkv, 12, 64), qkv, FRAMES, 197, 12, ("an",),
                  counter="fused_encoder_attention_qkv")
    torch.cuda.empty_cache()
    return total


# [int8 wide]: a W8A8 CLIP tower wider than 1024 (the XLA linear_w8a8
# composition): what infer_clip_vit_config reads from a 1280-wide, 32-block
# CLIP-layout state dict (OpenCLIP ViT-H/14's visual tree), keep 26-31
W8_GEOMETRY = dict(input_resolution=224, patch_size=14, width=1280, layers=32, heads=20,
                   output_dim=1024)
W8_KEEP = tuple(range(26, 32))
W8_SEED = 24              # the tower's weights and the frames (CUDA generators)
W8_CHECK_CLIPS = 2        # clips of the holds against the plain and bf16 routes
W8_ITERS = 3              # timed forwards (CUDA events)
# launches a forward: both LayerNorms, the four products' quantiser and
# gemm_s8 and the packed attention a layer before the last kept one, whose
# LN1 and qkv alone run; the int8_rows form adds the K/V export's quantiser
# twice a kept layer
W8_LAST = W8_KEEP[-1]
W8_COUNTS = {"layer_norm_rows": 2 * W8_LAST + 1, "quant_rows": 4 * W8_LAST + 1,
             "gemm_s8": 4 * W8_LAST + 1, "fused_encoder_attention_qkv": W8_LAST}
W8_USED = tuple(W8_COUNTS)


def w8_tower(gen):
    """The [int8 wide] tower's seeded params, drawn on the card (W8_GEOMETRY,
    CLIP's init scales, LayerNorms and biases off their init values), f32
    weights beside the int8 ones prepare_int8_params quantises from them."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit

    cfg = clip_vit.ViTConfig(**W8_GEOMETRY)
    with torch.device("cuda"):
        params = clip_vit.init_clip_vision(gen, cfg)
        for blk in params["blocks"]:
            for ln in (blk["ln_1"], blk["ln_2"]):
                ln["scale"].add_(0.1 * torch.randn(cfg.width, generator=gen))
                ln["bias"].add_(0.1 * torch.randn(cfg.width, generator=gen))
            for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                        blk["mlp"]["c_proj"]):
                lin["b"].add_(0.02 * torch.randn(lin["b"].shape, generator=gen))
    return cfg, clip_vit.prepare_int8_params(params)


def w8_counted(label: str, fn, expected: dict) -> dict:
    """One call of fn with the counters zeroed before and read after, held
    to ``expected`` exactly: every kernel it names, and no other launch."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = _cuda.launches()
    check_counts(label, counts, expected, 1, used=W8_USED)
    extra = {k: v for k, v in counts.items() if k not in expected and v}
    if extra or _cuda.plain_calls():
        raise SystemExit(f"FAIL {label}: launches outside the composition's kernels {extra} "
                         f"or plain calls {_cuda.plain_calls()}")
    return counts


def w8_kernels(rows: list, cfg) -> None:
    """The wide path's kernels at its shapes (320 frames x 257 tokens = 82,240
    rows, width 1280, hidden 5120, 20 heads of 64) against their plain
    versions: quant_rows' linear form on the LN1 and c_proj inputs (int8
    values equal, scales within TOL_SCALE), gemm_s8 at the four products
    with their bias and bf16 output (bit for bit), the packed attention, and
    layer_norm_rows; each timed beside its plain version, its one-call
    yardstick (torch._int_mm, SDPA, F.layer_norm) and its bound."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda, int8
    from dfd_clip_tpu_torch.ops import attention as att

    n, t, w, hh = CLIPS * FRAMES, cfg.num_tokens, cfg.width, cfg.heads
    m_rows, bf, dev = n * t, torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(W8_SEED + 1)
    paths = ("w8", "w8r")

    # -- quant_rows, the W8A8 linear's form (x / s * 127) ----------------------
    for name, k in (("quant_rows linear", w), ("quant_rows linear c_proj in", 4 * w)):
        x = torch.randn(m_rows, k, generator=gen, device=dev).to(bf)
        q, s = _cuda.quant_rows(x, form="linear")
        err = compare_int8(name, q, s, *int8.quant_linear_plain(x), 0.0)
        args = (time_ms(lambda: _cuda.quant_rows(x, form="linear")),
                time_ms(lambda: int8.quant_linear_plain(x)), None, 4.0 * m_rows * k,
                3.0 * m_rows * k + 4.0 * m_rows, PEAK_F32, err)
        if k == w:
            kernel_row(rows, name, "dfd_clip_tpu/models/layers.py:62",
                       "dfd_clip_tpu_torch/csrc/quant_rows.cu", *args, counter="quant_rows",
                       paths=paths)
        else:
            b, by = bound_ms(*args[3:6])
            print(f"  {name}: {args[0]:.4f} ms (plain {args[1]:.4f}, bound {b:.4f} by {by}, "
                  f"bound / ms {b / args[0]:.3f})", flush=True)
        del x, q, s

    # -- gemm_s8 at the four products, bias and bf16 output (w8a8_linear's form)
    for name, k, nn in (("gemm_s8 w8 qkv", w, 3 * w), ("gemm_s8 w8 out-proj", w, w),
                        ("gemm_s8 w8 c_fc", w, 4 * w), ("gemm_s8 w8 c_proj", 4 * w, w)):
        a = torch.randint(-127, 128, (m_rows, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (nn, k), generator=gen, device=dev, dtype=torch.int8)
        a_s = torch.rand(m_rows, generator=gen, device=dev) + 0.5
        ws = (torch.rand(nn, generator=gen, device=dev) + 0.5).reshape(1, nn)
        bias = 0.1 * torch.randn(nn, generator=gen, device=dev)

        got = _cuda.gemm_s8(a, a_s, wq, ws, bias)
        want = (int8.w8a8_dot_plain(a, a_s[:, None], wq, ws) + bias).to(bf)
        equal = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        print(f"  {name} ({m_rows} x {k} -> {nn}): bit-equal {equal} (max_abs_err {err:.3e})",
              flush=True)
        if not equal:
            raise SystemExit(f"FAIL {name}: not bit-equal to w8a8_dot_plain + bias")
        del got, want
        wt = wq.t()
        args = (time_ms(lambda: _cuda.gemm_s8(a, a_s, wq, ws, bias)),
                time_ms(lambda: (int8.w8a8_dot_plain(a, a_s[:, None], wq, ws) + bias).to(bf),
                        3, 1),
                time_ms(lambda: torch._int_mm(a, wt)), 2.0 * m_rows * nn * k,
                1.0 * (m_rows * k + k * nn) + 2.0 * m_rows * nn + 4.0 * (m_rows + 2 * nn),
                PEAK_INT8_TC)
        if nn == 4 * w:
            kernel_row(rows, name, "dfd_clip_tpu/models/layers.py:64",
                       "dfd_clip_tpu_torch/csrc/gemm_s8.cu", *args, err, counter="gemm_s8",
                       paths=paths)
        else:
            gemm_line(name, *args)
        del a, wq, wt
        torch.cuda.empty_cache()

    # -- the packed attention at 20 heads, and the row LayerNorm at width 1280 --
    qkv = torch.randn(m_rows, 3 * w, generator=gen, device=dev).to(bf)
    packed = qkv.view(n, t, 3 * w)
    attention_row(rows, "fused_encoder_attention_qkv w8",
                  "dfd_clip_tpu/ops/pallas_attention.py:145",
                  lambda: att.fused_encoder_attention_qkv(packed, hh, 64),
                  lambda: att.plain_attention_qkv(packed, hh, 64), qkv, n, t, hh, paths,
                  counter="fused_encoder_attention_qkv")
    del qkv, packed
    ln = {"scale": 1.0 + 0.1 * torch.randn(w, generator=gen, device=dev),
          "bias": 0.1 * torch.randn(w, generator=gen, device=dev)}
    check_layer_norm(rows, "layer_norm_rows w8", torch.randn(m_rows, w, generator=gen,
                                                             device=dev).to(bf), ln, paths)
    torch.cuda.empty_cache()


def w8_forward(params, cfg, x, dtype=None, **kw):
    """The [int8 wide] forward: clip_vision_kv with compute_int8 (bf16 by
    default), keep W8_KEEP, the Detector's export (drop_cls, pad_tokens)."""
    import torch

    from dfd_clip_tpu_torch.models import clip_vit

    return clip_vit.clip_vision_kv(params, x, cfg, dtype or torch.bfloat16, keep_layers=W8_KEEP,
                                   drop_cls=True, pad_tokens=True, compute_int8=True, **kw)


def w8_traces() -> None:
    """The [int8 wide] 16-clip forward traced in each export form: the
    profile's busy share and top kernels, then one JSON line {form: [ms or
    null, rows traced, rows expected]} from launches_ms over two forwards
    (a device time only where that trace holds twice the rows of a
    one-forward trace). Run in a process of its own by w8_traces_child,
    on the tower and frames int8_wide_path draws."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda

    _cuda.library()
    gen = torch.Generator(device="cuda").manual_seed(W8_SEED)
    cfg, params = w8_tower(gen)
    x = torch.randn(CLIPS * FRAMES, 3, cfg.input_resolution, cfg.input_resolution,
                    generator=gen, device="cuda")
    w8_forward(params, cfg, x)   # the process's first launches, untraced
    torch.cuda.synchronize()
    out = {}
    for form, kw in (("bf16 export", {}), ("int8_rows", {"kv_int8_rows": True})):
        profile_device(f"int8 wide forward, {form}", lambda: w8_forward(params, cfg, x, **kw))
        out[form] = launches_ms(lambda: w8_forward(params, cfg, x, **kw), calls=2)
    print(json.dumps(out))


def w8_traces_child(card: str) -> None:
    """w8_traces in a new process (the kernels already built), waited for,
    its lines printed: late in this script's run the profiler loses device
    rows (PERF.md §7), while a process that has traced nothing before holds
    every launch."""
    here = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.w8_traces()"],
                         cwd=here, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the [int8 wide] traces (exit {res.returncode}):\n"
                         f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    for form, (ms, traced, issued) in json.loads(lines[-1]).items():
        print(f"  [int8 wide] {form}: device time "
              + ("not measured" if ms is None else f"{ms:.2f} ms a forward")
              + f" ({traced} of {issued} device rows traced, a fresh process); {card}",
              flush=True)


def int8_wide_path(card: str, rows: list) -> dict:
    """[int8 wide] (docstring item 20): the W8A8 tower wider than 1024 at
    full width and depth. Returns the launch counts of its forwards as
    paths "w8" (the bf16 export) and "w8r" (int8_rows)."""
    import torch
    import torch.nn.functional as F

    from dfd_clip_tpu_torch.models import clip_vit, layers

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(W8_SEED)
    cfg, params = w8_tower(gen)
    torch.cuda.synchronize()
    count = sum(t_.numel() for t_ in _leaf_tensors(params) if t_.dtype == torch.float32)
    print(f"  ViT width {cfg.width}, {cfg.layers} layers, {cfg.heads} heads of "
          f"{cfg.head_dim}, patch {cfg.patch_size}, {cfg.num_tokens} tokens, keep "
          f"{W8_KEEP[0]}-{W8_KEEP[-1]}: {count} f32 parameters drawn on the card and "
          f"quantised (prepare_int8_params) in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  launches a forward: {json.dumps(W8_COUNTS)}", flush=True)
    w8_kernels(rows, cfg)

    x = torch.randn(CLIPS * FRAMES, 3, cfg.input_resolution, cfg.input_resolution,
                    generator=gen, device="cuda")
    xs = x[: W8_CHECK_CLIPS * FRAMES]

    def forward(frames, dtype=None, **kw):
        return w8_forward(params, cfg, frames, dtype, **kw)

    counts = {}
    rows8 = {"kv_int8_rows": True}
    for path, kw, extra in (("w8", {}, 0), ("w8r", rows8, 2 * len(W8_KEEP))):
        label = f"[int8 wide] {CLIPS} clips x {FRAMES} frames" + (", int8_rows" if kw else "")
        counts[path] = w8_counted(label, lambda: forward(x, **kw),
                                  {**W8_COUNTS, "quant_rows": W8_COUNTS["quant_rows"] + extra})
        ms = time_ms(lambda: forward(x, **kw), iters=W8_ITERS, warmup=1)
        print(f"  {label}: {ms:.2f} ms a forward by CUDA events ({W8_ITERS} forwards), "
              f"{CLIPS * 1e3 / ms:.2f} clips/s; {card}", flush=True)
    w8_traces_child(card)
    torch.cuda.reset_peak_memory_stats()
    forward(x)
    print(f"  peak device memory of a forward: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the tower's f32 and int8 "
          "weights included)", flush=True)
    del x

    # each layer on the same input: the kernels vs the plain W8A8 route
    h = clip_vit.embed_patches(params, xs, cfg, torch.bfloat16)
    reads = []
    for i in range(W8_LAST + 1):
        bp = params["blocks"][i]

        def block(h_in, bp=bp, i=i):
            qkv = clip_vit.block_qkv(bp, h_in, layers.linear_w8a8)
            if i == W8_LAST:
                return qkv, None
            return qkv, clip_vit.block_tail(bp, h_in, qkv, cfg, clip_vit.clip_mlp_w8a8,
                                            lin=layers.linear_w8a8)

        got = block(h)
        with plain_versions():
            want = block(h)
        reads.append(max(rel_err(g, w_) for g, w_ in zip(got, want) if g is not None))
        h = got[1]
    worst = max(reads)
    print(f"  each layer on the same input vs the plain W8A8 route (qkv and the block's "
          f"output, max|d| / max|plain|), layers 0-{W8_LAST}: "
          + " ".join(f"{r:.2e}" for r in reads) + f"; worst {worst:.3e} (tol {TOL_ENCODER:g})",
          flush=True)
    if not worst <= TOL_ENCODER:
        raise SystemExit(f"FAIL [int8 wide]: a layer {worst:.3e} from the plain W8A8 route")
    del h

    # the whole export: the kernels, the plain route in bf16 and in f32, bf16
    got = forward(xs)
    with plain_versions():
        plain = forward(xs)
        plain32 = forward(xs, torch.float32)
    whole = max(rel_err(got[s], plain[s]) for s in ("k", "v"))
    own = max(rel_err(plain[s], plain32[s]) for s in ("k", "v"))
    print(f"  the {cfg.layers}-layer export ({W8_CHECK_CLIPS} clips) vs the plain W8A8 chain: "
          f"{whole:.3e} of the max (tol {TOL_TOWER:g}); the bf16 plain route's own distance "
          f"from its f32 run {own:.3e}", flush=True)
    if not whole <= TOL_TOWER:
        print(f"  RECORDED, not held: every layer holds {TOL_ENCODER:g} on its input while "
              f"the {cfg.layers}-layer chain reads {whole:.3e} (ROADMAP queue 3 item 2)",
              flush=True)
    bf16 = clip_vit.clip_vision_kv(params, xs, cfg, torch.bfloat16, keep_layers=W8_KEEP,
                                   drop_cls=True, pad_tokens=True)
    cos = min(F.cosine_similarity(got[s][j].double().flatten(), bf16[s][j].double().flatten(),
                                  dim=0).item() for s in ("k", "v") for j in range(len(W8_KEEP)))
    print(f"  the int8 export vs the bf16 composition at width {cfg.width}: least cosine over "
          f"the kept layers' K and V {cos:.6f} (tol {TOL_COSINE:g})", flush=True)
    if not cos >= TOL_COSINE:
        raise SystemExit(f"FAIL [int8 wide]: cosine {cos:.6f} against the bf16 composition")
    del got, plain, plain32, bf16

    # the int8_rows form against its plain route (dequantised K / V)
    got = forward(xs, **rows8)
    with plain_versions():
        want = forward(xs, **rows8)
    deq = [(d[s].reshape(*d[f"{s}_scale"].shape[:3], -1).float() * d[f"{s}_scale"])
           for d in (got, want) for s in ("k", "v")]
    rows8_err = max(rel_err(deq[0], deq[2]), rel_err(deq[1], deq[3]))
    print(f"  int8_rows export ({W8_CHECK_CLIPS} clips), dequantised, vs its plain route: "
          f"{rows8_err:.3e} of the max (tol {TOL_TOWER:g})", flush=True)
    if not rows8_err <= TOL_TOWER:
        raise SystemExit(f"FAIL [int8 wide]: the int8_rows export {rows8_err:.3e} from its "
                         "plain route")
    del params, got, want, deq
    torch.cuda.empty_cache()
    return counts


def native_video_path(card: str) -> None:
    """[native video] (docstring item 21): the port's FFmpeg decoder where
    this machine can build it; else one line naming what is missing."""
    import tempfile

    import numpy as np
    import torch

    from dfd_clip_tpu_torch.data import native_video
    from dfd_clip_tpu_torch.data.video import (
        NativeBackend,
        OpenCVBackend,
        _time_to_frame_index,
        backend_name,
    )
    from dfd_clip_tpu_torch.ops.image_ops import yuv420_to_rgb

    t0 = time.perf_counter()
    try:
        lib_path = native_video.build()
    except native_video.NativeToolchainMissing as e:
        print(f"  NOT RUN (not a pass): {e}. Every run on this machine decodes through "
              f"{backend_name('auto')} (\"auto\"); [ffmpeg probe] above lists what it has",
              flush=True)
        return
    print(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s; \"auto\" is "
          f"{backend_name('auto')}", flush=True)
    nat, ocv, lib = NativeBackend(), OpenCVBackend(), native_video.NativeVideoLib.get()
    with tempfile.TemporaryDirectory() as tmp:
        video = f"{tmp}/score.mp4"
        write_video(video, *SCORE_VIDEO, "mp4v", seed=5)   # [serve http]'s /score video
        metas = nat.probe(video), ocv.probe(video)
        if (metas[0].fps, metas[0].frames) != (metas[1].fps, metas[1].frames):
            raise SystemExit(f"FAIL [native video]: probe {metas[0]} vs opencv's {metas[1]}")
        times = [t for t in np.arange(0, metas[0].duration, CLIP_SECONDS / FRAMES)
                 if _time_to_frame_index(t, metas[0].fps) < metas[0].frames]
        decoded = {}
        for name, fn in (("native", lambda: nat.read_frames(video, times)),
                         ("opencv", lambda: ocv.read_frames(video, times))):
            t1 = time.perf_counter()
            decoded[name] = fn()
            decoded[f"{name} ms"] = (time.perf_counter() - t1) * 1e3
        if not np.array_equal(decoded["native"], decoded["opencv"]):
            raise SystemExit("FAIL [native video]: native frames differ from opencv's")
        h, w = lib.frame_size(video)
        n = len(times)
        bufs = [torch.empty(shape, dtype=torch.uint8).pin_memory()
                for shape in ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2))]
        t1 = time.perf_counter()
        full = lib.read_frames_yuv_into(video, times, *(b.numpy() for b in bufs))
        yuv_ms = (time.perf_counter() - t1) * 1e3
    print(f"  {SCORE_VIDEO[0]} s mp4v at {SCORE_VIDEO[1]} px: probe equal, {n} frames "
          f"bit-equal to opencv's at every seek; decode ms (host clock): native RGB "
          f"{decoded['native ms']:.1f}, opencv {decoded['opencv ms']:.1f}, native YUV into "
          f"pinned buffers {yuv_ms:.1f} (full range {full})", flush=True)
    y, u, v = (b.cuda(non_blocking=True) for b in bufs)
    rgb = yuv420_to_rgb(y, u, v, full)
    clips = n // FRAMES
    det = detector()
    params = det.prepare_params(det.init_params(torch.Generator().manual_seed(MR_SEED)))
    x_rgb = torch.from_numpy(decoded["native"][: clips * FRAMES]).cuda().permute(0, 3, 1, 2)
    m = torch.ones(clips, FRAMES, dtype=torch.bool, device="cuda")
    logits = [det.predict(params, xx.reshape(clips, FRAMES, 3, h, w), m)[0][0]
              for xx in (rgb[: clips * FRAMES], x_rgb.contiguous())]
    dp = p_delta(*logits)
    print(f"  flagship predict on {clips} clips: the card's YUV route vs the RGB frames, "
          f"|dP(fake)| max {dp:.3e} (tol {TOL_PFAKE:g}); {card}", flush=True)
    if not dp <= TOL_PFAKE:
        raise SystemExit(f"FAIL [native video]: |dP(fake)| {dp:.3e} between the YUV and RGB "
                         "routes")
    del det, params
    torch.cuda.empty_cache()


# [multi rank]: two ranks on this card over Gloo
MR_SEED = 0               # the ranks' and the one-process run's weights
MR_SSL_IMAGES = 4         # SSL images a rank (configs/ssl/base.yaml: batch 32)
MR_SSL_STEPS = 2          # the SSL run's steps (lr 0 at step 0); its checkpoint is at the last
MR_TIMEOUT = 600          # seconds the two ranks may take
# the train steps' dropouts: at 0 the step is held to the train-step limits
# (loss and every leaf); at 0.5 each clip's loss is held within
# MR_CLIP_LOSS_TOL of the one-process step's, which shows that a rank drew
# the global batch's masks for its rows (another mask moves a clip's loss by
# O(1): dropout 0 vs 0.5 moves them 30 % to 25x), while its leaves carry the
# bf16 rounding of a 6-row batch beside a 12-row one through the dropped
# units (about 3e-2 of a leaf's max, recorded, not held)
MR_DROPOUTS = (0.0, 0.5)
MR_CLIP_LOSS_TOL = 5e-2
# KoLeo over the global batch: seeded f32 CLS-width features and an SSL
# step's crops and block masks for the ranks' 2 x MR_SSL_IMAGES images, held
# to one process on the whole batch
MR_KOLEO_SEED = 11
TOL_KOLEO = 1e-5


def mr_work() -> Path:
    import shutil

    work = Path(__file__).resolve().parent / "build" / "multi_rank"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    return work


def mr_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mr_flagship():
    """The seeded flagship Detector and its prepared params, and the last
    request's batch on the card."""
    import torch

    det = detector()
    params = det.prepare_params(det.init_params(torch.Generator().manual_seed(MR_SEED)))
    x, m = last_batch(make_requests())
    return det, params, x, m


def mr_train_step(trainer, batch) -> tuple:
    """One counted step of ``trainer`` on ``batch`` (six-field, this rank's
    rows): (losses, gradient leaves as host tensors, counts, plain calls,
    ms on the host clock around a synchronised step)."""
    import torch

    from dfd_clip_tpu_torch.ops import _cuda

    prepared = trainer.prepare_batch(batch)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    trainer.train_step([("deepfake", prepared)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = [t.grad.detach().float().cpu() for t in _leaf_tensors(trainer.trainable)]
    return (trainer.batch_losses["deepfake"], grads, _cuda.launches(), _cuda.plain_calls(), ms,
            prepared["x"].shape[1])


def mr_rank(rank: int, world: int, work: str) -> int:
    """One of the two ranks of the [multi rank] phase (run by main with
    --rank-job): the seq-sharded predict, the two train-step layouts, SSL
    with fsdp 1; results into <work>/rank<rank>.pt."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.runtime import MeshRuntime, launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch.initialize("gloo", init_method=f"file://{work}/store", world_size=world, rank=rank)
    out = {}
    try:
        rt = MeshRuntime(seq_parallel=2, device="cuda:0", backend="gloo")
        det, params, x, m = mr_flagship()
        fr = rt.frames(FRAMES)
        xs, ms_ = (torch.from_numpy(np.ascontiguousarray(a[:, fr])).cuda() for a in (x, m))
        det.predict(params, xs, ms_)        # warm
        torch.cuda.synchronize()
        _cuda.reset_launches()
        rt.traffic.clear()
        t0 = time.perf_counter()
        logits = det.predict(params, xs, ms_)[0][0].float()
        torch.cuda.synchronize()
        out["predict"] = {"logits": logits.cpu(), "counts": _cuda.launches(),
                          "plain": _cuda.plain_calls(), "traffic": dict(rt.traffic),
                          "ms": (time.perf_counter() - t0) * 1e3, "frames": xs.shape[1]}
        # the runtime's other collectives on the card's tensors and the host's
        sent = rt.broadcast_(torch.full((4,), float(rank + 1), device="cuda:0"))
        ragged = rt.gather_ragged(np.full((rank + 1, 2), rank, np.int64))
        out["collectives"] = {"broadcast": sent.tolist(), "ragged": ragged.tolist(),
                              "name": rt.broadcast_str(f"rank {rank}"),
                              "metrics": rt.gather_for_metrics(np.arange(2) + 10 * rank).tolist()}
        rt.deactivate()
        del det, params, xs, ms_

        batch = train_batches(1)[0]
        for dp, sp in ((2, 1), (1, 2)):
            rt = MeshRuntime(seq_parallel=sp, device="cuda:0", backend="gloo")
            tcfg = Trainer.get_default_config()
            tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3,
                                       "batch_size": TRAIN_CLIPS // dp, "num_workers": 0})
            rows = rt.rows(TRAIN_CLIPS)
            local = tuple(f[rows] for f in batch)
            for dropout in MR_DROPOUTS:
                trainer = Trainer(tcfg, rt, detector(dropout=dropout, device=rt.device), [],
                                  seed=MR_SEED)
                rt.traffic.clear()
                losses, grads, counts, plain, ms, frames = mr_train_step(trainer, local)
                res = {"losses": losses, "counts": counts, "plain": plain, "ms": ms,
                       "traffic": dict(rt.traffic), "frames": frames,
                       "grad_sums": [float(g.double().sum()) for g in grads]}
                if rank == 0:
                    torch.save(grads, Path(work) / f"grads_{dp}{sp}_{dropout}.pt")
                out[f"train_{dp}{sp}_{dropout}"] = res
                del trainer, grads
                torch.cuda.empty_cache()
            rt.deactivate()

        out["ssl"] = mr_ssl(work)
        rt = MeshRuntime(device="cuda:0", backend="gloo")
        out["koleo"] = mr_koleo_step(rt, mr_koleo_inputs(), rt.rows(2 * MR_SSL_IMAGES))
        rt.deactivate()
    finally:
        launch.shutdown()
    torch.save(out, Path(work) / f"rank{rank}.pt")
    return 0


def mr_ssl_config(**over):
    """configs/ssl/base.yaml at MR_SSL_IMAGES images a rank and MR_SSL_STEPS
    steps, with ``over`` changed."""
    from dfd_clip_tpu_torch.ssl import SSLTrainer

    cfg = SSLTrainer.get_default_config()
    cfg.merge_from_file(str(Path(__file__).resolve().parent / "configs" / SSL_CFG))
    cfg.merge_from_other_cfg({"batch_size": MR_SSL_IMAGES, "max_steps": MR_SSL_STEPS,
                              "warmup_steps": 1, **over})
    return cfg


def mr_koleo_inputs() -> dict:
    """The KoLeo hold's global batch of 2 x MR_SSL_IMAGES (numpy, seeded):
    features of the CLS width, and both global crops, the 8 local crops and
    the block masks at configs/ssl/base.yaml's sizes."""
    import numpy as np

    rng = np.random.default_rng(MR_KOLEO_SEED)
    n = 2 * MR_SSL_IMAGES
    return {"features": rng.standard_normal((n, 768)).astype(np.float32),
            "globals": rng.standard_normal((2, n, 3, 224, 224)).astype(np.float32),
            "locals": rng.standard_normal((8, n, 3, 98, 98)).astype(np.float32),
            "masks": rng.random((2, n, 256)) < 0.3}


def mr_koleo_step(runtime, a: dict, rows: slice) -> dict:
    """KoLeo on ``rows`` of the features (over the registered layout's global
    batch on several ranks): its value and feature gradient; then one SSL
    step on those rows of the images (configs/ssl/base.yaml, fsdp 0) in f32
    with the plain attention (the kernel takes bf16), where only the order
    of sums differs from one process: its metrics."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.ops import spmd
    from dfd_clip_tpu_torch.ssl import SSLTrainer
    from dfd_clip_tpu_torch.ssl.losses import koleo_loss
    from dfd_clip_tpu_torch.ssl_train import SyntheticImages

    f = torch.from_numpy(a["features"][rows]).cuda().requires_grad_()
    value = koleo_loss(f, layout=spmd.spmd_layout())
    value.backward()
    n = rows.stop - rows.start
    trainer = SSLTrainer(mr_ssl_config(fsdp=0, batch_size=n), runtime, SyntheticImages(8),
                         device="cuda:0")
    trainer.meta.compute_dtype = torch.float32
    with plain_ssl_attention():
        metrics = trainer.train_step(*(torch.from_numpy(np.ascontiguousarray(a[k][:, rows]))
                                       .cuda() for k in ("globals", "locals", "masks")), 1)
    return {"value": value.item(), "grad": f.grad.cpu(),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def mr_ssl(work: str) -> dict:
    """SSL on the two ranks (configs/ssl/base.yaml, MR_SSL_IMAGES images a
    rank) with fsdp 0 for one step, then with fsdp 1 for MR_SSL_STEPS steps
    and a checkpoint at the last, then a trainer resumed from it: its start
    step, how many of the run's gathered student leaves moved from their
    initial values, whether the resumed student equals the run's bit for
    bit, the gathered checksum, and this rank's device memory (MiB, the
    allocator's)
    held after each run's set-up and at each run's peak (a step's: the
    moments are allocated at set-up, so later steps reach the same)."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.runtime import MeshRuntime
    from dfd_clip_tpu_torch.ssl import SSLTrainer
    from dfd_clip_tpu_torch.ssl_train import SyntheticImages

    rt = MeshRuntime(device="cuda:0", backend="gloo")
    data = SyntheticImages(8 * MR_SSL_IMAGES)
    memory = {}

    def build(cfg):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trainer = SSLTrainer(cfg, rt, data, device="cuda:0")
        torch.cuda.synchronize()
        memory[f"fsdp{cfg.fsdp}"] = {"held": (torch.cuda.memory_allocated() - base) / 2**20}
        return trainer, base

    def peak(fsdp: int, base: int) -> None:
        torch.cuda.synchronize()
        memory[f"fsdp{fsdp}"]["peak"] = (torch.cuda.max_memory_allocated() - base) / 2**20

    replicated, base = build(mr_ssl_config(fsdp=0, max_steps=1))
    replicated.run()
    peak(0, base)
    del replicated
    cfg = mr_ssl_config(fsdp=1, checkpoint_interval=MR_SSL_STEPS,
                 checkpoint_dir=str(Path(work) / "ssl_ckpt"))
    trainer, base = build(cfg)
    sharded = sum(f for _, f in named_leaves(trainer.sharded))
    initial = [a for _, a in named_leaves(rt.materialize(trainer.student, trainer.sharded))]
    torch.cuda.reset_peak_memory_stats()   # the gather above is not a step's
    times = []
    step_fn = trainer.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return metrics

    trainer.train_step = timed_step
    rt.traffic.clear()
    _cuda.reset_launches()
    metrics = trainer.run()
    peak(1, base)
    counts = _cuda.launches()
    traffic = dict(rt.traffic)
    whole = rt.materialize(trainer.student, trainer.sharded)
    moved = sum(not np.array_equal(a, b) for a, (_, b) in zip(initial, named_leaves(whole)))
    resumed = SSLTrainer(cfg, rt, data, device="cuda:0")
    again = rt.materialize(resumed.student, resumed.sharded)
    equal = all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_leaves(whole),
                                                                named_leaves(again)))
    return {"metrics": metrics, "step_ms": times, "counts": counts, "traffic": traffic,
            "sharded": (sharded, len(named_leaves(trainer.sharded))),
            "start_step": resumed.start_step, "resumed_equal": equal, "memory": memory,
            "moved": (moved, len(initial)),
            "checksum": float(sum(np.float64(np.sum(a)) for _, a in named_leaves(again)))}


def mr_print_rank(r: int, label: str, res: dict) -> None:
    traffic = ", ".join(f"{k} {v} B" for k, v in sorted(res["traffic"].items()))
    print(f"  rank {r} {label}: {res['ms']:.2f} ms (host clock), launches "
          + json.dumps(res["counts"]) + f"; collectives: {traffic or 'none'}", flush=True)


def multi_rank_paths(card: str) -> dict:
    """[multi rank] (docstring item 22); returns the ranks' summed launch
    counts of the sharded predict and the two train steps as path "mr"."""
    import numpy as np
    import torch

    from dfd_clip_tpu_torch.engine.optim import named_leaves
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.runtime import MeshRuntime, OneProcess, launch

    work = mr_work()
    det, params, x, m = mr_flagship()
    xt, mt = torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda()
    want = det.predict(params, xt, mt)[0][0].float()

    # one rank on NCCL: the one-rank path, bit for bit
    launch.initialize("nccl", init_method=f"tcp://127.0.0.1:{mr_free_port()}", world_size=1,
                      rank=0)
    try:
        rt = MeshRuntime(device="cuda:0", backend="nccl")
        got = det.predict(params, xt, mt)[0][0].float()
        rt.deactivate()
    finally:
        launch.shutdown()
    if not torch.equal(got, want):
        raise SystemExit("FAIL [multi rank] NCCL world size 1: the predict differs from the "
                         f"one-process predict by {(got - want).abs().max().item():.3e}")
    print(f"  NCCL, world size 1: the flagship predict (16 clips x 20 frames) bit-equal to "
          f"the one-process predict, on {card}", flush=True)
    p_want = torch.softmax(want, -1)[:, 1].cpu()
    del det, params, xt, mt

    # the one-process train steps on the same 12 clips, at each dropout
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": TRAIN_STEPS, "learning_rate": 2.5e-3,
                               "batch_size": TRAIN_CLIPS})
    batch = train_batches(1)[0]
    one_step = {}
    for dropout in MR_DROPOUTS:
        one = Trainer(tcfg, detector(dropout=dropout), {}, seed=MR_SEED)
        one_step[dropout] = mr_train_step(one, batch)[:2]
        names = [".".join(map(str, p)) for p, _ in named_leaves(one.trainable)]
        del one
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    logs = [work / f"rank{r}.log" for r in range(2)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank-job", str(r), "2",
                 str(work)], stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(MR_TIMEOUT - (time.perf_counter() - t0), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"FAIL [multi rank] rank {r} exited {p.returncode}:\n"
                             + log.read_text()[-3000:])
    res = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    print(f"  two ranks on cuda:0 over Gloo: {time.perf_counter() - t0:.1f} s with their "
          "start-up", flush=True)

    # the seq-sharded predict: 10 frames a rank, its tokens' partials combined
    counts = {}
    for r, rr in enumerate(res):
        pr = rr["predict"]
        mr_print_rank(r, f"predict (data 1, seq 2), {pr['frames']} frames", pr)
        check_counts("[multi rank] predict", pr["counts"], FLAGSHIP_COUNTS, 1)
        if pr["plain"]:
            raise SystemExit(f"FAIL [multi rank] predict ran plain versions: {pr['plain']}")
        if pr["traffic"].get("all_reduce_max seq", 0) == 0:
            raise SystemExit("FAIL [multi rank] predict: no combine over the seq ranks")
        counts = {k: counts.get(k, 0) + pr["counts"].get(k, 0)
                  for k in set(counts) | set(pr["counts"])}
    if not torch.equal(res[0]["predict"]["logits"], res[1]["predict"]["logits"]):
        raise SystemExit("FAIL [multi rank] predict: the two seq ranks' logits differ")
    # at (1, 2) the two ranks share their rows: the metric gather keeps seq rank 0's
    want_coll = {"broadcast": [1.0] * 4, "ragged": [[0, 0], [1, 1], [1, 1]], "name": "rank 0",
                 "metrics": [0, 1]}
    for r, rr in enumerate(res):
        if rr["collectives"] != want_coll:
            raise SystemExit(f"FAIL [multi rank] rank {r}'s collectives: {rr['collectives']}")
    print("  broadcast_ (a card tensor), gather_ragged (1 and 2 host rows), broadcast_str, "
          "gather_for_metrics: as expected on both ranks", flush=True)
    p_got = torch.softmax(res[0]["predict"]["logits"], -1)[:, 1]
    dp_max = (p_got - p_want).abs().max().item()
    print(f"  seq-sharded predict: |dP(fake)| <= {dp_max:.3e} against the one-process kernel "
          f"predict (tol {TOL_PFAKE:g})", flush=True)
    if not dp_max <= TOL_PFAKE:
        raise SystemExit(f"FAIL [multi rank] predict: |dP(fake)| {dp_max:.3e} > {TOL_PFAKE:g}")

    # the train steps against the one-process step
    for dp, sp in ((2, 1), (1, 2)):
        for dropout in MR_DROPOUTS:
            key = f"train_{dp}{sp}_{dropout}"
            loss_one, grads_one = one_step[dropout]
            for r, rr in enumerate(res):
                tr = rr[key]
                mr_print_rank(r, f"train step (data {dp}, seq {sp}), dropout {dropout}, "
                              f"{tr['frames']} frames", tr)
                check_counts(f"[multi rank] train ({dp}, {sp})", tr["counts"], TRAIN_COUNTS, 1)
                if tr["plain"]:
                    raise SystemExit(f"FAIL [multi rank] train ran plain versions: "
                                     f"{tr['plain']}")
                counts = {k: counts.get(k, 0) + tr["counts"].get(k, 0)
                          for k in set(counts) | set(tr["counts"])}
            if res[0][key]["grad_sums"] != res[1][key]["grad_sums"]:
                raise SystemExit(f"FAIL [multi rank] train ({dp}, {sp}): the ranks' gradients "
                                 "differ")
            losses = np.concatenate([rr[key]["losses"] for rr in res[::sp]])
            rel = abs(losses.mean() - loss_one.mean()) / abs(loss_one.mean())
            clip_rel = np.abs(losses - loss_one) / np.abs(loss_one)
            grads = torch.load(work / f"grads_{dp}{sp}_{dropout}.pt")
            worst = max(((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30), n)
                        for g, w, n in zip(grads, grads_one, names))
            print(f"  train ({dp}, {sp}), dropout {dropout}, vs one process: loss "
                  f"{losses.mean():.6f} vs {loss_one.mean():.6f}, rel {rel:.3e} (tol "
                  f"{TOL_DECODER:g}); each clip's loss within {clip_rel.max():.3e} relative, "
                  f"{int((losses == loss_one).sum())} of {len(losses)} bit-equal; "
                  f"{len(grads)} gradient leaves, worst {worst[1]} {worst[0]:.3e} of its max "
                  + (f"(tol {TOL_ENCODER:g})" if not dropout else "(recorded)"), flush=True)
            if not rel <= TOL_DECODER:
                raise SystemExit(f"FAIL [multi rank] train ({dp}, {sp}), dropout {dropout}: "
                                 "the loss beyond the train-step limit")
            if not dropout and not worst[0] <= TOL_ENCODER:
                raise SystemExit(f"FAIL [multi rank] train ({dp}, {sp}): a gradient leaf "
                                 "beyond the train-step limit")
            if dropout and not clip_rel.max() <= MR_CLIP_LOSS_TOL:
                raise SystemExit(f"FAIL [multi rank] train ({dp}, {sp}), dropout {dropout}: "
                                 f"a clip's loss {clip_rel.max():.3e} from the one-process "
                                 "step's: its dropout masks are not the global batch's")
            del grads

    # SSL, fsdp 1
    for r, rr in enumerate(res):
        ss = rr["ssl"]
        traffic = ", ".join(f"{k} {v} B" for k, v in sorted(ss["traffic"].items()))
        print(f"  rank {r} ssl (fsdp 1, {MR_SSL_IMAGES} images, {ss['sharded'][0]} of "
              f"{ss['sharded'][1]} leaves sharded): steps "
              + ", ".join(f"{t:.1f}" for t in ss["step_ms"]) + " ms (host clock), losses "
              + json.dumps({k: round(v, 6) for k, v in ss["metrics"].items()})
              + f", launches {json.dumps(ss['counts'])}; collectives: {traffic}; resumed at "
              f"step {ss['start_step']}, bit-equal {ss['resumed_equal']}, checksum "
              f"{ss['checksum']!r}; {ss['moved'][0]} of {ss['moved'][1]} student leaves "
              "moved from their initial values", flush=True)
        mem = ss["memory"]
        print(f"  rank {r} ssl device memory (MiB; held after set-up, peak over its "
              f"steps): fsdp 0 {mem['fsdp0']['held']!r}, "
              f"{mem['fsdp0']['peak']!r}; fsdp 1 {mem['fsdp1']['held']!r}, "
              f"{mem['fsdp1']['peak']!r}; on {card}", flush=True)
        if ss["start_step"] != MR_SSL_STEPS or not ss["resumed_equal"] \
                or not np.isfinite(ss["metrics"]["total"]) or not 0 < ss["sharded"][0]:
            raise SystemExit(f"FAIL [multi rank] ssl on rank {r}")
        if not 2 * ss["moved"][0] > ss["moved"][1]:
            raise SystemExit(f"FAIL [multi rank] ssl on rank {r}: {ss['moved'][0]} of "
                             f"{ss['moved'][1]} student leaves moved, so the resume and the "
                             "checksums compare (nearly) the initial weights")
        if not mem["fsdp1"]["held"] < 0.6 * mem["fsdp0"]["held"]:
            raise SystemExit(f"FAIL [multi rank] ssl on rank {r}: fsdp 1 holds "
                             f"{mem['fsdp1']['held']:.1f} MiB after set-up, fsdp 0 "
                             f"{mem['fsdp0']['held']:.1f} MiB: its leaves are not slices")
    if res[0]["ssl"]["checksum"] != res[1]["ssl"]["checksum"]:
        raise SystemExit("FAIL [multi rank] ssl: the ranks' checksums differ")

    # KoLeo over the global batch, and an SSL step with it, vs one process
    a = mr_koleo_inputs()
    one = mr_koleo_step(OneProcess("cuda:0"), a, slice(0, 2 * MR_SSL_IMAGES))
    value = np.mean([rr["koleo"]["value"] for rr in res])
    grad = torch.cat([rr["koleo"]["grad"] for rr in res]) / len(res)
    reads = {"value": abs(value - one["value"]) / abs(one["value"]),
             "feature gradient": rel_err(grad, one["grad"])}
    for k in ("koleo", "dino", "ibot", "total"):
        mean = np.mean([rr["koleo"]["metrics"][k] for rr in res])
        reads[f"step {k}"] = abs(mean - one["metrics"][k]) / abs(one["metrics"][k])
    print(f"  KoLeo on two ranks ({MR_SSL_IMAGES} of {2 * MR_SSL_IMAGES} rows each) vs one "
          f"process on the global batch: value {value!r} vs {one['value']!r}; the SSL step "
          "(f32, plain attention) koleo "
          + ", ".join(f"rank {r} {rr['koleo']['metrics']['koleo']!r}"
                      for r, rr in enumerate(res))
          + f" vs {one['metrics']['koleo']!r}; relative: "
          + ", ".join(f"{k} {v:.3e}" for k, v in reads.items()) + f" (tol {TOL_KOLEO:g})",
          flush=True)
    for k in ("value", "feature gradient", "step koleo"):
        if not reads[k] <= TOL_KOLEO:
            raise SystemExit(f"FAIL [multi rank] KoLeo {k}: {reads[k]:.3e} from one process "
                             "on the global batch")
    return counts


def main() -> int:
    import argparse
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pfake-seeds", type=int, default=PFAKE_SEEDS,
                    help="parameter seeds each 257-token path is held on (default "
                         f"{PFAKE_SEEDS}; ViT-L/14@336px {L336_SEEDS} unless another N is "
                         "given); more widen the P(fake) noise readings")
    ap.add_argument("--rank-job", nargs=3, metavar=("RANK", "WORLD", "WORKDIR"),
                    help=argparse.SUPPRESS)   # one rank of [multi rank], spawned by it
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
    if args.rank_job:
        rank, world, work = args.rank_job
        return mr_rank(int(rank), int(world), work)

    card = card_line()
    t_start = time.perf_counter()

    def elapsed() -> None:
        print(f"  [elapsed {time.perf_counter() - t_start:.1f} s since the build began]",
              flush=True)

    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[card] {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}",
          flush=True)
    print("[note] plain versions run with TF32 off (matmul and cudnn)", flush=True)
    print(f"[ffmpeg probe] {json.dumps(ffmpeg_probe())}", flush=True)

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
    elapsed()
    print("[kernels sweep] the encoder attention at 1 to 1025 tokens, both entries and outputs",
          flush=True)
    check_attention_sweep()
    elapsed()
    print("[kernels int8] flagship shapes, W8A8 and int8_rows K/V", flush=True)
    check_int8_kernels(rows)
    elapsed()
    print("[kernels int8 sweep] the int8 encoder attention at 1 to 1025 tokens in both modes, "
          f"then at the paths' shapes beside the bf16 attention; every time on {card}",
          flush=True)
    check_int8_attention_sweep(rows)
    elapsed()
    print(f"[kernels gemm] gemm and gemm_s8 at every path shape; every time on {card}",
          flush=True)
    check_gemm_kernels()
    elapsed()
    counts = {}
    print("[serve path] Scorer over ViT-B/16, 20 frames, keep 6-11, bf16, batch 16", flush=True)
    counts["serve"] = serve_path(card)
    elapsed()
    print("[serve http] Scorer.from_run_dir on a run directory (ViT-B/16, 20 frames, keep "
          "6-11, bf16, batch 16), HTTP on 127.0.0.1, four synthetic:// videos and a video "
          "file's bytes; inference.main on the same run", flush=True)
    counts["serve_http"] = serve_http_path(card)
    elapsed()
    print("[int8 serve path] Scorer over ViT-B/16, 20 frames, keep 6-11, compute_int8, "
          "batch 16", flush=True)
    counts["int8_serve"], counts["int8_rows"] = int8_serve_path(card)
    elapsed()
    print(f"[train path] Trainer over ViT-B/16, 20 frames, keep 6-11, bf16, batch "
          f"{TRAIN_CLIPS}, dropout 0.5, SGD + OneCycle, {TRAIN_STEPS} steps", flush=True)
    counts["train"] = train_path(card)
    elapsed()
    print("[train cli] the training CLI on the flagship recipe (configs/deepfake/deepfake.yaml: "
          "768-x-768-z0 adapter, normal+frame, FFPP / DFDC / CDF evaluation)", flush=True)
    cli_work = tempfile.TemporaryDirectory()   # the CLI trees, read again by [analysis]
    cli_counts, cli_tree = train_cli_path(card, cli_work.name)
    counts.update(cli_counts)
    elapsed()
    print(f"[train modes] Trainer steps over ViT-B/16, 20 frames, keep 6-11, batch "
          f"{TRAIN_CLIPS}, dropout 0.5, in each training mode", flush=True)
    counts["modes"] = train_modes(card)
    elapsed()
    print("[kernels wide] 257 tokens: ViT-L/14 and DINOv2 B/14 attention, int8 split pair",
          flush=True)
    check_wide_kernels(rows)
    elapsed()
    print("[vit-l serve path] Scorer over ViT-L/14, 20 frames, keep 0-20 stride 4, bf16, "
          "batch 16", flush=True)
    counts["vitl_serve"], counts["vitl_int8_serve"] = vitl_serve_path(
        card, args.pfake_seeds)
    elapsed()
    print("[dinov2 serve path] Scorer over DINOv2 ViT-B/14, 20 frames, keep 6-11, bf16, "
          "batch 16", flush=True)
    counts["dinov2_serve"] = dinov2_serve_path(card, args.pfake_seeds)
    elapsed()
    print("[kernels boundary wide] ViT-g/14 shapes: the decoder boundary at width 1536 in its "
          "streamed form, the encoder attention at 24 heads, layer_norm_rows at width 1536, "
          "the decoder attention at 24 heads over L = 5120", flush=True)
    check_giant_kernels(rows)
    elapsed()
    print("[dinov2 giant serve] Scorer over DINOv2 ViT-g/14, 20 frames, keep 34-39, bf16, "
          "batch 16", flush=True)
    counts["dinov2_giant"] = giant_serve_path(card)
    elapsed()
    print("[kv int8 serve] Scorer over ViT-B/16, 20 frames, keep 6-11, kv_dtype int8, batch 16",
          flush=True)
    counts["kv_int8"] = kv_int8_serve_path(card)
    elapsed()
    print(f"[int8 train] Trainer over ViT-B/16, 20 frames, keep 6-11, batch {TRAIN_CLIPS}, "
          "dropout 0.5: compute_int8, and compute_int8 + int8_rows, beside bf16", flush=True)
    counts.update(int8_train_path(card))
    elapsed()
    print(f"[decoder options] ViT-B/16, 20 frames, keep 6-11: a Trainer step (batch "
          f"{TRAIN_CLIPS}) and a predict (batch {CLIPS}) with each of "
          + ", ".join(OPTIONS), flush=True)
    counts["options"] = options_path(card)
    elapsed()
    print("[int8 gates] the four int8 AUROC gates at flagship width (ViT-B/16, keep 6-11, "
          "4-frame clips of 2 s, batch 16) on the separable and adversarial fixture trees",
          flush=True)
    counts["gates"] = int8_gates_path(card)
    elapsed()
    print("[kernels variants] flagship shapes: bf16 whole block, int8 attention, tower",
          flush=True)
    check_variant_kernels(rows)
    elapsed()
    print("[variant serve paths] Scorers over ViT-B/16, 20 frames, keep 6-11, batch 16, "
          "through the encoder's alternative kernels", flush=True)
    counts.update(variant_serve_paths(card))
    elapsed()
    print("[kernels 577] ViT-L/14@336px shapes: the encoder attention, the int8 "
          "split pair, the decoder over L = 11520", flush=True)
    check_577_kernels(rows)
    elapsed()
    print("[vit-l@336 serve path] Scorer over ViT-L/14@336px, 20 frames, keep 0-20 stride 4, "
          "bf16, batch 16", flush=True)
    seeds336 = L336_SEEDS if args.pfake_seeds == PFAKE_SEEDS else args.pfake_seeds
    counts["vitl336_serve"], counts["vitl336_int8_serve"] = vitl_serve_path(
        card, seeds336, arch="ViT-L/14@336px", label="vit-l@336")
    print("[kernels tower wide] the ViT-L int8 ladder's shapes: the int8 attention above 320 "
          "tokens, the whole int8 block and the 24-layer tower at width 1024, 257 and 577 "
          f"tokens; every time on {card}", flush=True)
    check_tower_wide_kernels(rows)
    elapsed()
    print(f"[vit-l ladder] ViT-L/14 and ViT-L/14@336px cut to {LADDER_LAYERS} layers, 20 "
          f"frames, keep {LADDER_KEEP[0]}-{LADDER_KEEP[-1]}, compute_int8, batch 16, through "
          "each encoder form", flush=True)
    counts.update(ladder_paths(card))
    elapsed()
    print("[kernels study] the tools' shapes: the study attention modes at (320, 197, 12 x 64), "
          "the megakernel probe's pair at (63040, 768) x 12 layers", flush=True)
    check_study_kernels(rows)
    elapsed()
    counts.update(tool_paths())
    elapsed()
    print("[kernels ssl] the encoder attention at the SSL crops' shapes: (64, 257, 12 x 64) "
          "and (256, 50, 12 x 64), forward and under autograd", flush=True)
    check_ssl_kernels(rows)
    elapsed()
    counts.update(ssl_paths(card))
    elapsed()
    print("[zero shot] CLIP's zero-shot surface at ViT-B/16 width: 8 prompts through the "
          f"text tower, {ZS_IMAGES} images through the ViT-B/16 and RN50 towers; every time on "
          f"{card}", flush=True)
    counts["zs"] = zero_shot_path(card, rows)
    elapsed()
    print("[analysis] python -m dfd_clip_tpu_torch.tools.analysis on the [train cli] FFPP tree "
          f"(ViT-B/16, {FRAMES} frames): kv-dist, semantic-patches, augment-impact, "
          f"comb-impact, a guide-map predict; every time on {card}", flush=True)
    counts["an"] = analysis_path(card, rows, cli_tree["FFPP"])
    cli_work.cleanup()
    elapsed()
    print(f"[int8 wide] a W8A8 CLIP tower wider than 1024 (width {W8_GEOMETRY['width']}, "
          f"{W8_GEOMETRY['heads']} heads of 64, {W8_GEOMETRY['layers']} layers, patch "
          f"{W8_GEOMETRY['patch_size']}, {W8_GEOMETRY['input_resolution']} px, keep "
          f"{W8_KEEP[0]}-{W8_KEEP[-1]}, compute_int8, bf16): the linear_w8a8 composition on "
          f"quant_rows' linear form, gemm_s8 and the packed attention; every time on {card}",
          flush=True)
    counts.update(int8_wide_path(card, rows))
    elapsed()
    print("[native video] the port's FFmpeg decoder (built with g++ against FFmpeg's headers) "
          "beside opencv, its YUV planes converted on the card", flush=True)
    native_video_path(card)
    elapsed()
    print("[multi rank] runtime.MeshRuntime: the flagship predict on one NCCL rank; two ranks "
          "on cuda:0 over Gloo: the seq-sharded predict (data 1, seq 2), a train step at "
          f"(2, 1) and (1, 2), batch {TRAIN_CLIPS}, dropout 0 and 0.5; SSL fsdp 0 and 1 on "
          "ViT-B/14; every time on "
          f"{card}", flush=True)
    counts["mr"] = multi_rank_paths(card)
    elapsed()

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
