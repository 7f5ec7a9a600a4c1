"""ctypes bindings for the port's FFmpeg seek-decoder (counterpart of
dfd_clip_tpu/data/native_video.py), over its own sources,
``dfd_clip_tpu_torch/csrc/videodecode.cpp`` and ``videoencode.cpp``.

``build()`` compiles them on first use with g++ (``-O2 -fPIC -shared
-std=c++17 ... -lavformat -lavcodec -lavutil -lswscale``) into
``build/dfd_clip_tpu_torch/libdfdvideo_<digest>.so``, the digest taken over
the sources and the command, so an edited source rebuilds; it writes a
temporary name and renames it into place, so two processes may build at
once. Before compiling it checks for the toolchain: g++, FFmpeg's headers
(``libavcodec/avcodec.h``, ``libavformat/avformat.h``,
``libavutil/imgutils.h``, ``libswscale/swscale.h``) in the compiler's
include directories, and the four libraries where the linker looks. What it lacks raises ``NativeToolchainMissing``, the one
error on which ``data/video.py``'s ``"auto"`` takes opencv; a failed
compile raises RuntimeError with the compiler's output.

The C API (the JAX package's symbols):

  int dfd_probe(const char* path, double* fps, long* frames, double* duration);
  int dfd_frame_size(const char* path, int* height, int* width);
  int dfd_read_frames(const char* path, const double* times, int n, uint8* out);
  int dfd_read_frames_yuv(const char* path, const double* times, int n,
                          uint8* y, uint8* u, uint8* v, int* full_range);
  int dfd_encode_video(const char* path, const uint8* frames, int n, int h,
                       int w, double fps, int crf, const char* codec);

``read_frames`` decodes the first frame with pts >= t for each requested
time (TorchVision's seek semantics) into one contiguous RGB24 buffer. Every
nonzero return code raises IOError naming the path, which the datasets'
resampling catches (data/video.py:DECODE_ERRORS).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("videodecode.cpp", "videoencode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dfd_clip_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIBS = ("avformat", "avcodec", "avutil", "swscale")
HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h", "libavutil/imgutils.h",
           "libswscale/swscale.h")


class NativeToolchainMissing(RuntimeError):
    """The decoder cannot be built here: g++, FFmpeg's headers or its
    libraries are missing."""


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise NativeToolchainMissing("g++ not found: the native video decoder cannot be built")
    return found


def include_dirs(cxx: str) -> List[Path]:
    """The directories the compiler searches for ``#include <...>``."""
    out = subprocess.run([cxx, "-xc++", "-E", "-v", "-"], input="", capture_output=True,
                         text=True).stderr.splitlines()
    try:
        first = out.index("#include <...> search starts here:") + 1
        last = out.index("End of search list.")
    except ValueError:
        return []
    return [Path(line.strip()) for line in out[first:last]]


def find_headers(cxx: str) -> Path:
    """The first of the compiler's include directories that holds all of
    FFmpeg's HEADERS."""
    dirs = include_dirs(cxx)
    for d in dirs:
        if all((d / h).is_file() for h in HEADERS):
            return d
    raise NativeToolchainMissing(
        f"FFmpeg's headers ({', '.join(HEADERS)}) are not in {[str(d) for d in dirs]}: the "
        "native video decoder cannot be built")


def check_libraries(cxx: str) -> None:
    """Raise unless the linker finds each of LIBS (``-print-file-name``
    answers a bare name for one it does not find)."""
    missing = [lib for lib in LIBS
               if os.sep not in subprocess.run([cxx, f"-print-file-name=lib{lib}.so"],
                                               capture_output=True, text=True).stdout.strip()]
    if missing:
        raise NativeToolchainMissing(f"the linker finds no lib{', lib'.join(missing)}.so: the "
                                     "native video decoder cannot be built")


def build() -> Path:
    """The decoder library for the current sources, compiled if missing."""
    cxx = compiler()
    inc = find_headers(cxx)
    check_libraries(cxx)
    cmd = [cxx, *CXX_FLAGS, f"-I{inc}", *(str(CSRC / s) for s in SOURCES)]
    h = hashlib.sha256(" ".join(cmd[1:] + [f"-l{lib}" for lib in LIBS]).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    lib = BUILD_DIR / f"libdfdvideo_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    done = subprocess.run([*cmd, "-o", str(tmp), *(f"-l{lib}" for lib in LIBS)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on the native video decoder:\n{done.stderr}")
    os.replace(tmp, lib)
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


class NativeVideoLib:
    _instance: Optional["NativeVideoLib"] = None

    def __init__(self, lib_path: str):
        self.lib = ctypes.CDLL(str(lib_path))
        p_u8, p_int = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
        p_dbl = ctypes.POINTER(ctypes.c_double)
        for name, args in {
            "dfd_probe": [ctypes.c_char_p, p_dbl, ctypes.POINTER(ctypes.c_long), p_dbl],
            "dfd_frame_size": [ctypes.c_char_p, p_int, p_int],
            "dfd_read_frames": [ctypes.c_char_p, p_dbl, ctypes.c_int, p_u8],
            "dfd_read_frames_yuv": [ctypes.c_char_p, p_dbl, ctypes.c_int, p_u8, p_u8, p_u8,
                                    p_int],
            "dfd_encode_video": [ctypes.c_char_p, p_u8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_int, ctypes.c_char_p],
        }.items():
            fn = getattr(self.lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int

    @classmethod
    def get(cls) -> "NativeVideoLib":
        """The process's library: built (``build``) and loaded on first use."""
        if cls._instance is None:
            cls._instance = cls(str(build()))
        return cls._instance

    def probe(self, path: str) -> Tuple[float, int, float]:
        fps, frames, duration = ctypes.c_double(), ctypes.c_long(), ctypes.c_double()
        rc = self.lib.dfd_probe(path.encode(), ctypes.byref(fps), ctypes.byref(frames),
                                ctypes.byref(duration))
        if rc != 0:
            raise IOError(f"native probe failed ({rc}): {path}")
        return fps.value, frames.value, duration.value

    def frame_size(self, path: str) -> Tuple[int, int]:
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self.lib.dfd_frame_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            raise IOError(f"native frame_size failed ({rc}): {path}")
        return h.value, w.value

    def read_frames(self, path: str, times: List[float]) -> np.ndarray:
        """(N, H, W, 3) RGB uint8: the first frame with pts >= t for each t."""
        h, w = self.frame_size(path)
        n = len(times)
        out = np.empty((n, h, w, 3), np.uint8)
        rc = self.lib.dfd_read_frames(path.encode(), (ctypes.c_double * n)(*times), n, _ptr(out))
        if rc != 0:
            raise IOError(f"native read_frames failed ({rc}): {path}")
        return out

    def read_frames_yuv(self, path: str, times: List[float]):
        """Planar YUV420: (y (N, H, W), u, v (N, H/2, W/2), full_range), half
        the bytes of RGB to copy to the card, where
        ops/image_ops.py:yuv420_to_rgb converts them."""
        h, w = self.frame_size(path)
        n = len(times)
        y = np.empty((n, h, w), np.uint8)
        u = np.empty((n, h // 2, w // 2), np.uint8)
        v = np.empty_like(u)
        return y, u, v, self._yuv(path, times, y, u, v)

    def read_frames_yuv_into(self, path: str, times: List[float],
                             y: np.ndarray, u: np.ndarray, v: np.ndarray) -> bool:
        """Decode straight into the caller's contiguous uint8 buffers (y (N,
        H, W), u / v (N, H/2, W/2), checked against the video's frame size;
        a pinned host tensor's ``.numpy()`` view for a copy to the card).
        Returns full_range."""
        h, w = self.frame_size(path)
        n = len(times)
        for name, a, shape in (("y", y, (n, h, w)), ("u", u, (n, h // 2, w // 2)),
                               ("v", v, (n, h // 2, w // 2))):
            if a.dtype != np.uint8 or not a.flags["C_CONTIGUOUS"] or a.shape != shape:
                raise ValueError(f"read_frames_yuv_into: {name} must be contiguous uint8 "
                                 f"{shape}, got {a.dtype} {a.shape}")
        return self._yuv(path, times, y, u, v)

    def _yuv(self, path: str, times: List[float], y, u, v) -> bool:
        n = len(times)
        full_range = ctypes.c_int()
        rc = self.lib.dfd_read_frames_yuv(path.encode(), (ctypes.c_double * n)(*times), n,
                                          _ptr(y), _ptr(u), _ptr(v), ctypes.byref(full_range))
        if rc != 0:
            raise IOError(f"native read_frames_yuv failed ({rc}): {path}")
        return bool(full_range.value)

    def encode_video(self, path: str, frames: np.ndarray, fps: float,
                     crf: int = 23, codec: str = "libx264") -> None:
        """Encode (N, H, W, 3) RGB uint8 frames; x264 CRF or mpeg4 (the c23 /
        c40 re-encode of preprocessing/compression.py, without the ffmpeg
        binary)."""
        frames = np.ascontiguousarray(frames, np.uint8)
        n, h, w, _ = frames.shape
        rc = self.lib.dfd_encode_video(path.encode(), _ptr(frames), n, h, w, float(fps),
                                       int(crf), codec.encode())
        if rc != 0:
            raise IOError(f"native encode failed ({rc}): {path}")
