"""Video decode backends (the port's own copy of dfd_clip_tpu/data/video.py).

Backends behind one interface (``probe`` -> VideoMeta, ``read_frames(path,
times)`` -> (N, H, W, 3) uint8):

  * ``synthetic`` -- deterministic generated frames for tests and smoke runs
    (``synthetic://<seed>?fps=25&duration=10&size=224``), no file IO; its
    frames equal the JAX package's byte for byte;
  * ``opencv`` -- cv2.VideoCapture frame-index seeking, for the constant-fps
    clips the preprocessing pipeline writes; ``cv2`` is imported only when a
    file is opened;
  * ``native`` -- the port's FFmpeg seek-decoder (csrc/videodecode.cpp through
    ctypes, data/native_video.py), built with g++ on first use.

``"auto"`` is the JAX package's rule, native first: it takes opencv only
where the decoder cannot be built for want of g++, FFmpeg's headers or its
libraries (native_video.NativeToolchainMissing); any other failure, a
compile error in the port's own source included, raises. The backend is an
argument, never read from the environment; ``backend_name`` names the class
a name resolves to, which the entry points print.

Seek semantics match TorchVision's ``seek(t); next()``: the first frame
whose pts >= t, for constant-fps streams frame ``ceil(t * fps - eps)``.

``DECODE_ERRORS`` are the exceptions a backend raises for a clip it cannot
read (a file it cannot open or decode, a seek past the end): what a caller
that resamples a corrupt clip may catch, and nothing else.
"""

from __future__ import annotations

import dataclasses
import urllib.parse
from typing import Dict, Sequence

import numpy as np


DECODE_ERRORS = (OSError, IndexError)


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
    """The port's C++ FFmpeg decoder (csrc/videodecode.cpp) through ctypes."""

    def __init__(self):
        from .native_video import NativeVideoLib

        self._lib = NativeVideoLib.get()

    def probe(self, path: str) -> VideoMeta:
        fps, frames, duration = self._lib.probe(path)
        return VideoMeta(fps=fps, frames=frames, duration=duration)

    def read_frames(self, path: str, times: Sequence[float]) -> np.ndarray:
        return self._lib.read_frames(path, list(times))


_BACKENDS: Dict[str, object] = {}


def get_backend(name: str = "auto"):
    """A backend by name: "synthetic", "opencv", "native" or "auto". One
    instance a name."""
    if name in _BACKENDS:
        return _BACKENDS[name]
    if name == "synthetic":
        backend = SyntheticBackend()
    elif name == "opencv":
        backend = OpenCVBackend()
    elif name == "native":
        backend = NativeBackend()
    elif name == "auto":
        from .native_video import NativeToolchainMissing

        try:
            backend = NativeBackend()
        except NativeToolchainMissing:
            backend = OpenCVBackend()
    else:
        raise ValueError(f"Unknown video backend: {name}")
    _BACKENDS[name] = backend
    return backend


def backend_name(name: str = "auto") -> str:
    """The class of the backend ``name`` resolves to (``"auto"``:
    NativeBackend or OpenCVBackend), for a run to show which decoder it
    used."""
    return type(get_backend(name)).__name__


def backend_for_path(path: str, backend: str = "auto"):
    """``synthetic://`` paths always take the synthetic backend; every other
    path takes ``backend``."""
    if path.startswith("synthetic://"):
        return get_backend("synthetic")
    return get_backend(backend)
