"""Per-video scoring (counterpart of dfd_clip_tpu/scoring.py): frames
sampled every clip_duration / num_frames seconds -> consecutive windows ->
batched predict -> mean softmax P(fake).

``score_video`` decodes a video through its backend (data/video.py) and
hands the frames to ``score_frames``, which scores decoded frames.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch


def resolve_deepfake_task(preset) -> int:
    """Deepfake head index: first-appearance order of data.train categories;
    single-task runs -> 0."""
    try:
        cats = list(dict.fromkeys(d.category for d in preset.data.train))
        return cats.index("Deepfake")
    except (AttributeError, KeyError, ValueError):
        return 0


def score_video(
    video_path: str,
    predict_fn: Callable,
    params,
    *,
    num_frames: int,
    clip_duration: float,
    batch_size: int = 16,
    depth: int = 3,
    lock: Optional[threading.Lock] = None,
    video_backend: str = "auto",
) -> float:
    """Every frame at t = 0, s, 2s, ... (s = clip_duration / num_frames) that
    the video holds -> ``score_frames``. The seek times are kept by the
    backend's own time-to-index mapping, not by a duration comparison: a
    time in the last frame interval whose index equals the frame count
    (NTSC-style rates, where the container's duration exceeds frames / fps)
    is dropped instead of seeking past the end."""
    from .data.video import _time_to_frame_index, backend_for_path

    backend = backend_for_path(video_path, video_backend)
    meta = backend.probe(video_path)
    times = [t for t in np.arange(0, meta.duration, clip_duration / num_frames)
             if _time_to_frame_index(t, meta.fps) < meta.frames]
    return score_frames(backend.read_frames(video_path, times), predict_fn, params,
                        num_frames=num_frames, batch_size=batch_size, depth=depth, lock=lock)


def score_frames(
    frames: np.ndarray,
    predict_fn: Callable,
    params,
    *,
    num_frames: int,
    batch_size: int = 16,
    depth: int = 3,
    lock: Optional[threading.Lock] = None,
) -> float:
    """Decoded frames (N, H, W, 3) uint8 -> consecutive ``num_frames``-frame
    windows -> mean softmax P(fake) over windows.

    ``predict_fn(params, x, m) -> (B, n_cls) logits`` for the Deepfake head.
    Every short sub-batch is padded to ``batch_size`` by repeating its last
    clip (one input shape per model); the padded rows are dropped before the
    mean. At most ``depth`` batches are in flight; ``lock`` serialises device
    use across threads."""
    frames = np.ascontiguousarray(np.asarray(frames).transpose(0, 3, 1, 2))
    clips = [frames[i: i + num_frames]
             for i in range(0, len(frames) - num_frames + 1, num_frames)]
    if not clips:
        raise ValueError(f"video too short: {len(frames)} frames < {num_frames}")
    clips = np.stack(clips)
    masks = np.ones(clips.shape[:2], bool)

    def host(o) -> np.ndarray:
        return o.float().cpu().numpy() if torch.is_tensor(o) else np.asarray(o)

    if lock is None:
        lock = threading.Lock()
    n = batch_size
    with lock:
        pending, done = [], []
        for i in range(0, len(clips), n):
            x, m = clips[i: i + n], masks[i: i + n]
            valid = x.shape[0]
            if valid < n:
                x = np.concatenate([x, np.repeat(x[-1:], n - valid, 0)])
                m = np.concatenate([m, np.repeat(m[-1:], n - valid, 0)])
            pending.append((predict_fn(params, x, m), valid))
            if len(pending) >= depth:
                o, nv = pending.pop(0)
                done.append(host(o)[:nv])
        done.extend(host(o)[:nv] for o, nv in pending)
    logits = np.concatenate(done)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    return float(p.mean(0)[1])
