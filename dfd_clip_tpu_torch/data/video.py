"""Video decode backends (the port's own copy of dfd_clip_tpu/data/video.py).

Backends behind one interface (``probe`` -> VideoMeta, ``read_frames(path,
times)`` -> (N, H, W, 3) uint8):

  * ``synthetic`` -- deterministic generated frames for tests and smoke runs
    (``synthetic://<seed>?fps=25&duration=10&size=224``), no file IO; its
    frames equal the JAX package's byte for byte;
  * ``opencv`` -- cv2.VideoCapture frame-index seeking, for the constant-fps
    clips the preprocessing pipeline writes; ``cv2`` is imported only when a
    file is opened;
  * ``native`` -- the JAX package's FFmpeg seek-decoder (csrc/videodecode.cpp)
    is not ported: ``NativeBackend()`` raises NotImplementedError.

``"auto"`` is the JAX package's rule, native when it loads, else opencv;
with no native decoder here it is opencv. The backend is an argument, never
read from the environment.

Seek semantics match TorchVision's ``seek(t); next()``: the first frame
whose pts >= t, for constant-fps streams frame ``ceil(t * fps - eps)``.
"""

from __future__ import annotations

import dataclasses
import urllib.parse
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class VideoMeta:
    fps: float
    frames: int
    duration: float


def _time_to_frame_index(t: float, fps: float) -> int:
    return int(np.ceil(t * fps - 1e-6))


class SyntheticBackend:
    """Deterministic procedural clips; no file IO."""

    @staticmethod
    def _parse(path: str):
        parsed = urllib.parse.urlparse(path)
        q = urllib.parse.parse_qs(parsed.query)
        seed = int(parsed.netloc or 0)
        fps = float(q.get("fps", ["25"])[0])
        duration = float(q.get("duration", ["10"])[0])
        size = int(q.get("size", ["64"])[0])
        return seed, fps, duration, size

    def probe(self, path: str) -> VideoMeta:
        _, fps, duration, _ = self._parse(path)
        return VideoMeta(fps=fps, frames=round(duration * fps), duration=duration)

    def read_frames(self, path: str, times: Sequence[float]) -> np.ndarray:
        seed, fps, duration, size = self._parse(path)
        n_frames = round(duration * fps)
        out = []
        for t in times:
            idx = _time_to_frame_index(t, fps)
            if idx >= n_frames:
                raise IndexError(f"seek past end: t={t} of {duration}s")
            rng = np.random.default_rng((seed * 1_000_003 + idx) & 0x7FFFFFFF)
            out.append(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
        return np.stack(out)


class OpenCVBackend:
    """cv2.VideoCapture with frame-index seeks (constant-fps streams)."""

    def probe(self, path: str) -> VideoMeta:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise IOError(f"cannot open video: {path}")
            fps = cap.get(cv2.CAP_PROP_FPS)
            frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if fps <= 0:
                raise IOError(f"invalid fps for {path}")
            return VideoMeta(fps=fps, frames=frames, duration=frames / fps)
        finally:
            cap.release()

    def read_frames(self, path: str, times: Sequence[float]) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise IOError(f"cannot open video: {path}")
            fps = cap.get(cv2.CAP_PROP_FPS)
            n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            out = []
            last_idx = None
            for t in times:
                idx = _time_to_frame_index(t, fps)
                if idx >= n_frames:
                    raise IndexError(f"seek past end of {path}: t={t}")
                if last_idx is None or idx != last_idx + 1:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if not ok:
                    raise IOError(f"decode failure at frame {idx} of {path}")
                last_idx = idx
                out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            return np.stack(out)
        finally:
            cap.release()


class NativeBackend:
    """The JAX package's FFmpeg seek-decoder (csrc/videodecode.cpp through
    ctypes) has no port yet."""

    def __init__(self):
        raise NotImplementedError(
            "the native FFmpeg video decoder (csrc/videodecode.cpp, "
            "dfd_clip_tpu/data/native_video.py) is not ported; use the opencv or "
            "synthetic backend")


_BACKENDS: Dict[str, object] = {}


def get_backend(name: str = "auto"):
    """A backend by name: "synthetic", "opencv", "native" or "auto". One
    instance a name."""
    if name in _BACKENDS:
        return _BACKENDS[name]
    if name == "synthetic":
        backend = SyntheticBackend()
    elif name in ("opencv", "auto"):
        # "auto" would take the native decoder first; it is not ported
        backend = OpenCVBackend()
    elif name == "native":
        backend = NativeBackend()
    else:
        raise ValueError(f"Unknown video backend: {name}")
    _BACKENDS[name] = backend
    return backend


def backend_for_path(path: str, backend: str = "auto"):
    """``synthetic://`` paths always take the synthetic backend; every other
    path takes ``backend``."""
    if path.startswith("synthetic://"):
        return get_backend("synthetic")
    return get_backend(backend)
