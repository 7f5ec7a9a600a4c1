"""Build, load and launch the port's CUDA kernels.

The sources under ``dfd_clip_tpu_torch/csrc/`` are compiled on first use with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together, then
one link) into a shared library with a plain C interface under
``build/dfd_clip_tpu_torch/``, and loaded with ``ctypes``. The library's file
name carries a hash of the sources and flags, so an edited source rebuilds. A
failed build raises with the compiler's output.

Launch counters: every wrapper that launches a kernel adds one to its count
in ``LAUNCHES`` where it launches, and nowhere else, so a run can show that
its path went through the kernels (``reset_launches`` / ``launches``).

``gemm`` and ``layer_norm_rows`` are the shared building blocks of the fused
encoder and decoder blocks; they take CUDA tensors only (the plain versions
live beside the functions that use them).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dfd_clip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()

# gemm epilogue flags (csrc/gemm.cu)
BIAS_F32, BIAS_BF16, GELU, RESID, STORE, EXPORT = 1, 2, 4, 8, 16, 32


def reset_launches() -> None:
    LAUNCHES.clear()


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile the sources if the library for their hash is missing.
    Returns (library path, compiler log)."""
    lib = BUILD_DIR / f"libdfd_kernels_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}_{lib.stem[-16:]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    log_path.write_text("\n".join(log))
    return lib, "\n".join(log)


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "dfd_gemm": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                 _P, _P, _I, _I, _I, _I, _I, _P],
    "dfd_layer_norm": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _P],
    "dfd_encoder_attention": [_P, _P, _I, _I, _I, _F, _P],
    "dfd_decoder_attention": [_P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "dfd_decoder_attention_partials": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "dfd_decoder_attention_bwd": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _F, _P],
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the caller takes its plain version); False for
    a CUDA one (the caller launches its kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless every tensor is on the card, of ``dtype``, with a
    contiguous last axis, 16-byte aligned rows and a 16-byte aligned start."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous")
        elem = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor start must be 16-byte aligned")
        if t.dim() > 1 and any((s * elem) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: row strides must be multiples of 16 bytes")


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, *,
         bias_after_cast: bool = False, gelu: bool = False,
         residual: Optional[torch.Tensor] = None, store: bool = True,
         export: Optional[tuple] = None, col_off: int = 0) -> Optional[torch.Tensor]:
    """bf16 ``a (M, K) @ b (K, N)`` with f32 accumulate and a fused epilogue.

    ``bias`` (N,) f32 is added in f32 before the bf16 cast, or with
    ``bias_after_cast`` rounded to bf16 and added after it (layers.linear).
    ``gelu`` applies QuickGELU in f32; ``residual`` (M, N) bf16 is added in
    bf16. ``export = (k_slot, v_slot, tokens, t_out, lo, width)`` writes the
    K/V columns (packed column ``col + col_off`` >= width) of each row into
    the (frames, t_out, width) slot views, dropping ``lo`` leading rows per
    frame and zeroing the pad rows. Returns C (M, N) when ``store``."""
    require_cuda("gemm", a, b)
    require_cuda("gemm", bias, dtype=torch.float32)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or bias.shape != (n,) or not bias.is_contiguous():
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}, bias {tuple(bias.shape)}")
    if k % 32 or n % 8:
        raise ValueError(f"gemm: needs K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    flags = (BIAS_BF16 if bias_after_cast else BIAS_F32) | (GELU if gelu else 0)
    c = None
    if store:
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        flags |= STORE
    if residual is not None:
        require_cuda("gemm", residual)
        if residual.shape != (m, n):
            raise ValueError("gemm: residual shape")
        flags |= RESID
    kv = (None, None, 1, 1, 0, 1)
    if export is not None:
        k_slot, v_slot, tokens, t_out, lo, width = export
        require_cuda("gemm", k_slot, v_slot)
        frames = m // tokens
        for t in (k_slot, v_slot):
            if not t.is_contiguous() or t.shape != (frames, t_out, width):
                raise ValueError(f"gemm: export slot {tuple(t.shape)} != {(frames, t_out, width)}")
        if m % tokens or width % 8 or col_off + n > 3 * width:
            raise ValueError("gemm: export geometry")
        kv = (k_slot.data_ptr(), v_slot.data_ptr(), tokens, t_out, lo, width)
        flags |= EXPORT
    err = library().dfd_gemm(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        c.data_ptr() if c is not None else None, n, m, n, k, bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        residual.stride(0) if residual is not None else 0, flags,
        *kv, col_off, stream())
    check_launch("gemm", err)
    LAUNCHES["gemm"] += 1
    return c


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of bf16 rows x (R, W) with f32 statistics -> bf16 (R, W)."""
    require_cuda("layer_norm_rows", x)
    require_cuda("layer_norm_rows", scale, shift, dtype=torch.float32)
    rows, width = x.shape
    if width % 8 or scale.shape != (width,) or shift.shape != (width,):
        raise ValueError("layer_norm_rows: width must be a multiple of 8 and match scale/shift")
    y = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    err = library().dfd_layer_norm(x.data_ptr(), x.stride(0), scale.data_ptr(),
                                   shift.data_ptr(), y.data_ptr(), width, rows, width,
                                   eps, stream())
    check_launch("layer_norm_rows", err)
    LAUNCHES["layer_norm_rows"] += 1
    return y
