"""Where the whole-encoder tower's time goes: one launch's stage clock
(ops/_cuda.py encoder_tower, ``stage_clock``: %globaltimer as each grid
barrier completes), summed by stage over the chunks and layers, beside the
launch's own time and the per-layer kernel chain's on the same input.

    python -m dfd_clip_tpu_torch.tools.bench_tower_stages [--arch ViT-B/16]
        [--frames 320] [--int8] [--attn 0|1|qk] [--chunk N] [--seed 0]

The tower runs layers 0..max(keep) of a randomly initialised (seeded)
tower, keep = the last six layers (the flagship's 6-11 on ViT-B/16, the
ladder's 18-23 on ViT-L), over random bf16 rows of the architecture's token
count; --chunk overrides the chunk rule (ops/_cuda.py tower_chunk). A
stage's reading is the time between two barrier completions on block 0,
so it includes the barrier's own wait. Needs a card.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from ..models import clip_vit
from ..ops import _cuda
from ..ops import encoder_block as eb
from ..ops import tower


def tower_inputs(arch: str, frames: int, int8: bool, seed: int = 0):
    """(h, blocks, cfg, keep) on the card: seeded parameters (int8 weights
    beside the bf16 ones with ``int8``) and random bf16 rows."""
    cfg = clip_vit.ARCHITECTURES[arch]
    gen = torch.Generator().manual_seed(seed)
    params = clip_vit.init_clip_vision(gen, cfg)
    if int8:
        params = clip_vit.prepare_int8_params(params)
    dev = torch.device("cuda")
    blocks = [{k: _to(v, dev) for k, v in b.items()} for b in params["blocks"]]
    h = torch.randn(frames, cfg.num_tokens, cfg.width, generator=gen).to(dev, torch.bfloat16)
    return h, blocks, cfg, tuple(range(cfg.layers - 6, cfg.layers))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def stage_times(h: torch.Tensor, blocks: list, heads: int, keep: tuple, int8: bool, attn: str,
                chunk: Optional[int] = None) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """One tower launch with the stage clock: ({stage: (ms summed over the
    chunks and layers, readings)}, the launch's ms from its first reading
    to its last)."""
    n, t = h.shape[:2]
    layers = [tower._layer(b, h.dtype, int8) for b in blocks[: keep[-1] + 1]]
    chunk = chunk or _cuda.tower_chunk(n, t)
    clock = torch.zeros(2 + _cuda.tower_barriers(n, chunk, len(layers), int8), dtype=torch.int64,
                        device=h.device)
    _cuda.encoder_tower(h, layers, heads, first=keep[0], lo=1, int8=int8, attn=attn, chunk=chunk,
                        stage_clock=clock)
    torch.cuda.synchronize()
    readings = clock[1: 1 + int(clock[0].item())].tolist()
    names = []
    for _ in range(-(-n // chunk)):
        for _ in range(len(layers) - 1):
            names += list(_cuda.TOWER_STAGES[int8])
        names += list(_cuda.TOWER_LAST_STAGES)
    if len(readings) != len(names) + 1:
        raise RuntimeError(f"stage clock: {len(readings)} readings for {len(names)} stages")
    out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for name, t0, t1 in zip(names, readings, readings[1:]):
        out[name][0] += (t1 - t0) / 1e6
        out[name][1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}, (readings[-1] - readings[0]) / 1e6


def kernel_chain(h: torch.Tensor, blocks: list, heads: int, keep: tuple, int8: bool,
                 attn: str, kc: torch.Tensor, vc: torch.Tensor) -> None:
    """The per-layer whole-block chain the tower computes (fused_encoder_block
    below max(keep), then the K/V columns of the last layer), into kc, vc."""
    first, last = keep[0], keep[-1]
    nsel, x = len(keep), h
    for i in range(last):
        into = (kc, vc, i - first, nsel) if i >= first else None
        b = blocks[i]
        out = eb.fused_encoder_block(x, b["ln_1"], b["attn"], b["ln_2"], b["mlp"], heads, 64,
                                     export=into is not None, drop_cls=True, export_into=into,
                                     int8_gemm=int8, int8_attn=attn)
        x = out[0] if into is not None else out
    eb.fused_encoder_attn_block(x, blocks[last]["ln_1"], blocks[last]["attn"], heads, 64,
                                drop_cls=True, last_only=True,
                                export_into=(kc, vc, nsel - 1, nsel), int8_gemm=int8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="ViT-B/16", choices=sorted(clip_vit.ARCHITECTURES))
    ap.add_argument("--frames", type=int, default=320)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--attn", default="0", choices=("0", "1", "qk"))
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_tower_stages: needs a CUDA card")
    h, blocks, cfg, keep = tower_inputs(args.arch, args.frames, args.int8, args.seed)
    stage_times(h, blocks, cfg.heads, keep, args.int8, args.attn, args.chunk)   # the build, warm-up
    stages, total = stage_times(h, blocks, cfg.heads, keep, args.int8, args.attn, args.chunk)
    print(f"{args.arch}, {args.frames} frames x {cfg.num_tokens} tokens, layers 0-{keep[-1]}, "
          f"{'int8' if args.int8 else 'bf16'}, attention {args.attn}: launch {total:.3f} ms "
          f"on {torch.cuda.get_device_name(0)}")
    for name, (ms, count) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:10s} {ms:9.3f} ms  {count:4d} stages  {1e3 * ms / count:8.2f} us each")
    kc = torch.empty((len(keep), h.shape[0], h.shape[1] - 1, h.shape[2]), dtype=h.dtype,
                     device=h.device)
    vc = torch.empty_like(kc)
    kernel_chain(h, blocks, cfg.heads, keep, args.int8, args.attn, kc, vc)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kernel_chain(h, blocks, cfg.heads, keep, args.int8, args.attn, kc, vc)
    end.record()
    torch.cuda.synchronize()
    print(f"  the per-layer kernel chain on the same input: {start.elapsed_time(end):.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
