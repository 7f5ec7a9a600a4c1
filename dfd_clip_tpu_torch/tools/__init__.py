"""The port of the study tools under tools/ that reach the kernels
(bench_attention, bench_megakernel_probe), and the port's own timing of the
decoder boundary beside the six-launch chain it replaced
(bench_decoder_boundary) and of the decoder attention's backward with its
stage clock (bench_decoder_bwd), the int8 AUROC gates (int8_gates), and
the encoder-analysis CLIs (analysis)."""

from __future__ import annotations

import torch


def time_op(fn, *args, iters: int) -> float:
    """Median seconds per call of fn(*args) over 3 windows of ``iters``
    calls (CUDA events, after one warm-up call)."""
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return sorted(times)[1]
