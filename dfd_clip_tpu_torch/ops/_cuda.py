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
encoder and decoder blocks, ``gemm_s8``, ``gemm_s8_quant``, ``quant_rows``
and ``layer_norm_quant`` those of the int8 (W8A8) encoder blocks
(``gemm_s8_quant``: the int8 MLP's c_fc with QuickGELU and its rows
quantised in the epilogue, a cluster of CTAs a row panel,
csrc/gemm_s8_quant.cu); the two GEMMs
are one persistent TMA / ``wgmma`` kernel each (csrc/gemm.cu, csrc/gemm_s8.cu
over the frame of csrc/gemm_hopper.cuh: clusters of two CTAs sharing the
weight's tiles, a kernel per epilogue form: QuickGELU, a residual or the
K/V export, one at a time), which read A and the weight through tensor
maps, so every operand's start and row pitch is 16-byte aligned
(``require_cuda``) and ragged tiles need no padding;
``encoder_attention_packed`` / ``encoder_attention_separate`` the two
entries of the encoder attention (one TMA / wgmma kernel at every token
count), ``encoder_attention_s8`` the int8 encoder attention (one TMA / int8
``wgmma`` kernel at every token count, on the encoder attention's frame)
and ``encoder_tower`` the whole-encoder tower (one cooperative launch whose
stages run the GEMMs', the encoder attention's and the int8 attention's
bodies), and ``study_attention`` / ``gemm_chain`` the kernels of the
tools' studies (ops/study_attention.py, ops/gemm_chain.py).
They take CUDA tensors only; the attention entries and the tower count
nothing themselves, their callers count them under their own names (the plain
versions live beside the functions that use them, the int8 ones in
ops/int8.py, the attention in ops/attention.py, the tower in ops/tower.py).
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
OUT_F32, RES_ADD_F32, RES_IS_F32 = 64, 128, 256
# gemm_s8 epilogue flags (csrc/gemm_s8.cu)
S8_GELU, S8_RES_F32, S8_RES_BF16, S8_OUT_F32, S8_STORE, S8_EXPORT = 1, 2, 4, 8, 16, 32
S8_RES_AFTER_CAST = 64
GRID_MAX = 2 ** 31 - 1
# gemm_s8_quant (csrc/gemm_s8_quant.cu): the columns a CTA may take (two
# consumer warpgroups of 256 or 192), and the most CTAs a cluster (a
# portable cluster), which together cover a whole row
QUANT_TILES, QUANT_MAX_CLUSTER = (512, 384), 8
# the encoder attention's frame (csrc/attention_hopper.cuh), which the int8
# attention (csrc/attention_s8_hopper.cuh) shares: key blocks and query
# tiles of 64, a ring of 10 stages of 16 KB (raw K and V), two 8 KB Q
# buffers a consumer warpgroup, and the int8 attention's scales (512 B a
# stage) and ready barriers
ATTN_BLOCK, ATTN_STAGES = 64, 10
S8_CONSUMERS = 2   # the int8 attention's consumer warpgroups (csrc/encoder_attention_s8.cu)
SMEM_LIMIT = 232448   # dynamic shared memory a block may use
# CTAs a cluster of the tower's launch (csrc/encoder_tower.cuh)
TOWER_CLUSTER = 2
# the most rows a tower chunk holds (tower_chunk): its scratch's bound
TOWER_MAX_ROWS = 2 ** 16
# int8 attention modes of the tower (csrc/encoder_tower.cu TowerArgs.attn)
TOWER_ATTN = {"0": 0, "1": 1, "qk": 2}
TOWER_MAP_BYTES, TOWER_LAYER_POINTERS = 128, 16   # a CUtensorMap; a LayerW record
# the decoder attention (csrc/decoder_attention.cu): tokens a chunk (a block
# takes one (chunk, head) over every sample), and the f32 workspace a
# (sample, head, chunk): numerator 64, CoDA sum 64, denominator, maximum, pad
DECODER_CHUNK, DECODER_WS = 64, 132


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
    "dfd_layer_norm": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P],
    "dfd_gemm_s8": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                    _P, _P, _I, _I, _I, _I, _I, _P],
    "dfd_gemm_s8_quant": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "dfd_quant_rows": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P],
    "dfd_layer_norm_quant": [_P, _I, _I, _P, _P, _I, _I, _F, _P, _P, _P],
    "dfd_encoder_attention": [_P, _P, _P, _LL, _P, _I, _I, _I, _F, _I, _P],
    "dfd_encoder_attention_packed": [_P, _P, _I, _I, _I, _F, _I, _P],
    "dfd_encoder_attention_s8": [_P, _P, _I, _I, _I, _F, _I, _P],
    "dfd_study_attention": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "dfd_gemm_chain": [_P, _P, _P, _I, _I, _I, _P],
    "dfd_encoder_tower_grid": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "dfd_encoder_tower_table": [_P, _I, _I, _I, _I],
    "dfd_encoder_tower": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                          _F, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "dfd_decoder_attention": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                              _I, _I, _I, _F, _P],
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


def one_form(name: str, gelu: bool, residual, export) -> None:
    """Raise unless at most one of QuickGELU, a residual and the K/V export
    is asked for: the GEMMs' kernels exist for those forms alone
    (csrc/gemm_hopper.cuh, kForms)."""
    if bool(gelu) + (residual is not None) + (export is not None) > 1:
        raise ValueError(f"{name}: QuickGELU, a residual and the K/V export go one at a time")


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


def _export_args(name: str, export: tuple, m: int, n: int, col_off: int) -> tuple:
    """Check a GEMM's K/V export ``(k_slot, v_slot, tokens, t_out, lo,
    width)`` into contiguous bf16 (frames, t_out, width) slot views; returns
    the kernel's export arguments."""
    k_slot, v_slot, tokens, t_out, lo, width = export
    require_cuda(name, k_slot, v_slot)
    frames = m // tokens
    for t in (k_slot, v_slot):
        if not t.is_contiguous() or t.shape != (frames, t_out, width):
            raise ValueError(f"{name}: export slot {tuple(t.shape)} != {(frames, t_out, width)}")
    if m % tokens or width % 8 or col_off + n > 3 * width:
        raise ValueError(f"{name}: export geometry")
    return (k_slot.data_ptr(), v_slot.data_ptr(), tokens, t_out, lo, width)


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, *,
         bias_after_cast: bool = False, gelu: bool = False,
         residual: Optional[torch.Tensor] = None, residual_before_cast: bool = False,
         out_dtype: torch.dtype = torch.bfloat16, store: bool = True,
         export: Optional[tuple] = None, col_off: int = 0) -> Optional[torch.Tensor]:
    """bf16 ``a (M, K) @ b (K, N)`` with f32 accumulate and a fused epilogue:
    csrc/gemm.cu, a persistent TMA / ``wgmma`` kernel (128 x 256 tiles in
    clusters of two, 128 x 64 where M is small). ``a`` and ``b`` may be
    views with a row pitch larger than their width (``in_proj["w"][:,
    col_off:]``), 16-byte aligned; K need only be a multiple of 32 (TMA
    zero-fills the last depth tile).

    ``bias`` (N,) f32 is added in f32 before the bf16 cast, or with
    ``bias_after_cast`` rounded to bf16 and added after it (layers.linear).
    ``gelu`` applies QuickGELU in f32. ``residual`` (M, N) bf16 is added in
    bf16 to the rounded value, or with ``residual_before_cast`` in f32 before
    the one rounding; an f32 residual is always added so (the bf16 whole
    block's hmid). C is ``out_dtype``, bf16 or f32. ``export = (k_slot,
    v_slot, tokens, t_out, lo, width)`` (bf16 C only) writes the K/V columns
    (packed column ``col + col_off`` >= width) of each row into the (frames,
    t_out, width) slot views, dropping ``lo`` leading rows per frame and
    zeroing the pad rows. ``gelu``, ``residual`` and ``export`` are forms
    of their own: a kernel exists for one of them at a time. Returns C
    (M, N) when ``store``."""
    one_form("gemm", gelu, residual, export)
    require_cuda("gemm", a, b)
    require_cuda("gemm", bias, dtype=torch.float32)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or bias.shape != (n,) or not bias.is_contiguous():
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}, bias {tuple(bias.shape)}")
    if k % 32 or n % 8:
        raise ValueError(f"gemm: needs K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm: output {out_dtype} is neither f32 nor bf16")
    flags = (BIAS_BF16 if bias_after_cast else BIAS_F32) | (GELU if gelu else 0)
    if out_dtype == torch.float32:
        flags |= OUT_F32
    c = None
    if store:
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
        flags |= STORE
    if residual is not None:
        require_cuda("gemm", residual, dtype=residual.dtype)
        if residual.shape != (m, n) or residual.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("gemm: residual must be (M, N) f32 or bf16")
        if residual.dtype == torch.float32:
            flags |= RES_ADD_F32 | RES_IS_F32
        elif residual_before_cast:
            flags |= RES_ADD_F32
        else:
            flags |= RESID
    if out_dtype == torch.float32 and flags & RESID:
        raise ValueError("gemm: an f32 output takes its residual before the cast")
    kv = (None, None, 1, 1, 0, 1)
    if export is not None:
        if flags & (OUT_F32 | RES_ADD_F32):
            raise ValueError("gemm: the K/V export writes the bf16 epilogue's values")
        kv = _export_args("gemm", export, m, n, col_off)
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
    """LayerNorm of bf16 or f32 rows x (R, W) with f32 statistics -> bf16
    (R, W)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm_rows: takes f32 or bf16, got {x.dtype}")
    require_cuda("layer_norm_rows", x, dtype=x.dtype)
    require_cuda("layer_norm_rows", scale, shift, dtype=torch.float32)
    rows, width = x.shape
    if width % 8 or scale.shape != (width,) or shift.shape != (width,):
        raise ValueError("layer_norm_rows: width must be a multiple of 8 and match scale/shift")
    y = torch.empty((rows, width), dtype=torch.bfloat16, device=x.device)
    err = library().dfd_layer_norm(x.data_ptr(), x.stride(0), int(x.dtype == torch.float32),
                                   scale.data_ptr(), shift.data_ptr(), y.data_ptr(), width, rows,
                                   width, eps, stream())
    check_launch("layer_norm_rows", err)
    LAUNCHES["layer_norm_rows"] += 1
    return y


def gemm_s8(a: torch.Tensor, a_scale: torch.Tensor, b_t: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor, *, out_dtype: torch.dtype = torch.bfloat16, gelu: bool = False,
            residual: Optional[torch.Tensor] = None, residual_after_cast: bool = False,
            store: bool = True, export: Optional[tuple] = None,
            col_off: int = 0) -> Optional[torch.Tensor]:
    """W8A8 product ``a (M, K) int8 @ b_t (N, K) int8 ^T`` with an exact int32
    accumulate (csrc/gemm_s8.cu, a persistent TMA / ``wgmma`` kernel) and the
    dequant epilogue of _w8a8_dot, in f32, bit for bit the plain version's
    operations outside QuickGELU:
    ``acc * (a_scale / 127) * (w_scale / 127) + bias``, then QuickGELU with
    ``gelu``, then ``residual`` (M, N) f32 or bf16 added in f32, or with
    ``residual_after_cast`` (bf16 residual and output) added to the value
    rounded to bf16. ``a_scale`` (M,) and ``w_scale`` (N,) or (1, N),
    ``bias`` (N,) are f32. C is ``out_dtype`` (f32 or bf16). ``export``
    (bf16 output only) is gemm's K/V export; as in gemm, ``gelu``,
    ``residual`` and ``export`` go one at a time. Returns C (M, N) when
    ``store``."""
    one_form("gemm_s8", gelu, residual, export)
    require_cuda("gemm_s8", a, b_t, dtype=torch.int8)
    w_scale = w_scale.reshape(-1)
    require_cuda("gemm_s8", a_scale, w_scale, bias, dtype=torch.float32)
    m, k = a.shape
    n, k2 = b_t.shape
    if k != k2 or a_scale.shape != (m,) or w_scale.shape != (n,) or bias.shape != (n,) \
            or not (a_scale.is_contiguous() and w_scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"gemm_s8: shapes {tuple(a.shape)} @ {tuple(b_t.shape)}^T, scales "
                         f"{tuple(a_scale.shape)} {tuple(w_scale.shape)}, bias {tuple(bias.shape)}")
    if k % 64 or n % 8:
        raise ValueError(f"gemm_s8: needs K % 64 == 0 and N % 8 == 0, got K={k}, N={n}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm_s8: output {out_dtype} is neither f32 nor bf16")
    flags = (S8_GELU if gelu else 0) | (S8_OUT_F32 if out_dtype == torch.float32 else 0)
    c = None
    if store:
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
        flags |= S8_STORE
    if residual is not None:
        require_cuda("gemm_s8", residual, dtype=residual.dtype)
        if residual.shape != (m, n) or residual.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("gemm_s8: residual must be (M, N) f32 or bf16")
        if residual_after_cast:
            if residual.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
                raise ValueError("gemm_s8: residual_after_cast takes a bf16 residual and output")
            flags |= S8_RES_AFTER_CAST
        else:
            flags |= S8_RES_F32 if residual.dtype == torch.float32 else S8_RES_BF16
    kv = (None, None, 1, 1, 0, 1)
    if export is not None:
        if out_dtype != torch.bfloat16:
            raise ValueError("gemm_s8: the K/V export writes bf16")
        kv = _export_args("gemm_s8", export, m, n, col_off)
        flags |= S8_EXPORT
    err = library().dfd_gemm_s8(
        a.data_ptr(), a.stride(0), a_scale.data_ptr(), b_t.data_ptr(), b_t.stride(0),
        w_scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        residual.stride(0) if residual is not None else 0,
        c.data_ptr() if c is not None else None, n, m, n, k, flags, *kv, col_off, stream())
    check_launch("gemm_s8", err)
    LAUNCHES["gemm_s8"] += 1
    return c


def quant_geometry(n: int) -> Tuple[int, int]:
    """gemm_s8_quant's (cluster size, columns a CTA) for an output of N
    columns: a row's scale needs all N columns, so a cluster of N / tile
    CTAs covers whole rows, at most 8. Of the tiles that fit, the first in
    QUANT_TILES that gives a power-of-two cluster (more of those are
    co-resident on an H100: 8 CTAs of 384 at ViT-B/16's 3072, 8 of 512 at
    ViT-L/14's 4096), else the first. A width no tile fits raises."""
    fits = [(n // tile, tile) for tile in QUANT_TILES
            if n > 0 and n % tile == 0 and n // tile <= QUANT_MAX_CLUSTER]
    for cluster, tile in fits:
        if cluster & (cluster - 1) == 0:
            return cluster, tile
    if not fits:
        raise ValueError(f"gemm_s8_quant: cannot tile an output of {n} columns: it takes a "
                         f"multiple of {' or '.join(map(str, QUANT_TILES))} of at most "
                         f"{QUANT_MAX_CLUSTER} tiles (a cluster of CTAs covers a row)")
    return fits[0]


def gemm_s8_quant(a: torch.Tensor, a_scale: torch.Tensor, b_t: torch.Tensor,
                  w_scale: torch.Tensor, bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 MLP's c_fc with its output rows quantised on chip
    (csrc/gemm_s8_quant.cu): ``mid = QuickGELU(a (M, K) int8 @ b_t (N, K)
    int8 ^T dequantised with a_scale (M,) and w_scale (N,) or (1, N), +
    bias (N,))`` in f32, gemm_s8's QuickGELU form's own operations, then
    quant_rows' ``s = max|mid| + 1e-8, q = clip(rint(mid * (127 / s)))``
    per row, bit for bit that pair's values and scales. N as quant_geometry
    takes it; K % 64 == 0. Returns (q (M, N) int8, s (M,) f32)."""
    name = "gemm_s8_quant"
    require_cuda(name, a, b_t, dtype=torch.int8)
    w_scale = w_scale.reshape(-1)
    require_cuda(name, a_scale, w_scale, bias, dtype=torch.float32)
    m, k = a.shape
    n, k2 = b_t.shape
    if k != k2 or a_scale.shape != (m,) or w_scale.shape != (n,) or bias.shape != (n,) \
            or not (a_scale.is_contiguous() and w_scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ {tuple(b_t.shape)}^T, scales "
                         f"{tuple(a_scale.shape)} {tuple(w_scale.shape)}, bias {tuple(bias.shape)}")
    if k % 64:
        raise ValueError(f"{name}: needs K % 64 == 0, got K={k}")
    cluster, tile = quant_geometry(n)
    q = torch.empty((m, n), dtype=torch.int8, device=a.device)
    s = torch.empty((m,), dtype=torch.float32, device=a.device)
    err = library().dfd_gemm_s8_quant(
        a.data_ptr(), a.stride(0), a_scale.data_ptr(), b_t.data_ptr(), b_t.stride(0),
        w_scale.data_ptr(), bias.data_ptr(), q.data_ptr(), n, s.data_ptr(), m, n, k, tile,
        stream())
    if err == -1:
        raise RuntimeError(f"{name}: no cluster of {cluster} CTAs can be resident on this card")
    check_launch(name, err)
    LAUNCHES[name] += 1
    return q, s


def quant_rows(x: torch.Tensor, *, kv: bool = False,
               export: Optional[tuple] = None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-row absmax int8 quantisation of x (R, C), f32 or bf16, any row
    stride (16-byte multiple). ``kv=False``: the _quant_rows constants;
    returns (q (R, C) int8, s (R,) f32). ``kv=True``: the _quant_kv_rows
    constants; with ``export = (q_slot, s_slot, tokens, t_out, lo)`` the
    rows go into the (frames, t_out, C) int8 slot view and the (frames,
    t_out) f32 scale view, ``lo`` leading rows of each frame dropped and the
    pad rows and pad scales zero (returns None)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_rows: takes f32 or bf16, got {x.dtype}")
    require_cuda("quant_rows", x, dtype=x.dtype)
    rows, cols = x.shape
    if cols % 8:
        raise ValueError(f"quant_rows: needs C % 8 == 0, got C={cols}")
    if export is None:
        q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
        s = torch.empty((rows,), dtype=torch.float32, device=x.device)
        geo = (rows, rows, 0)
    else:
        if not kv:
            raise ValueError("quant_rows: the export is the K/V form (kv=True)")
        q, s, tokens, t_out, lo = export
        frames = rows // tokens
        require_cuda("quant_rows", q, dtype=torch.int8)
        if rows % tokens or t_out < tokens - lo or q.shape != (frames, t_out, cols) \
                or not q.is_contiguous() or s.dtype != torch.float32 \
                or s.shape != (frames, t_out) or not s.is_contiguous() or s.device != x.device:
            raise ValueError(f"quant_rows: export slots {tuple(q.shape)} / {tuple(s.shape)} "
                             f"for {rows} rows of {tokens} tokens")
        geo = (tokens, t_out, lo)
    err = library().dfd_quant_rows(x.data_ptr(), x.stride(0), int(x.dtype == torch.float32),
                                   rows, cols, int(kv), q.data_ptr(), cols, s.data_ptr(),
                                   *geo, stream())
    check_launch("quant_rows", err)
    LAUNCHES["quant_rows"] += 1
    return None if export is not None else (q, s)


def layer_norm_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm of rows x (R, W), bf16 or f32, in f32, quantised with the
    _quant_rows constants without a bf16 round trip -> (q (R, W) int8,
    s (R,) f32)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm_quant: takes f32 or bf16, got {x.dtype}")
    require_cuda("layer_norm_quant", x, dtype=x.dtype)
    require_cuda("layer_norm_quant", scale, shift, dtype=torch.float32)
    rows, width = x.shape
    if width % 8 or width > 1024 or scale.shape != (width,) or shift.shape != (width,):
        raise ValueError("layer_norm_quant: width must be a multiple of 8, at most 1024, "
                         "and match scale/shift")
    q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    err = library().dfd_layer_norm_quant(x.data_ptr(), x.stride(0), int(x.dtype == torch.float32),
                                         scale.data_ptr(), shift.data_ptr(), rows, width, eps,
                                         q.data_ptr(), s.data_ptr(), stream())
    check_launch("layer_norm_quant", err)
    LAUNCHES["layer_norm_quant"] += 1
    return q, s


def decoder_split(tokens: int, heads: int) -> Dict[str, int]:
    """The decoder attention's grid over L = ``tokens`` keys of ``heads``
    heads: chunks of DECODER_CHUNK tokens (the last one ragged), a block a
    (chunk, head), each walking every sample."""
    if tokens < 1 or heads < 1:
        raise ValueError(f"decoder_split: needs tokens and heads >= 1, got {tokens}, {heads}")
    chunks = -(-tokens // DECODER_CHUNK)
    return {"chunk": DECODER_CHUNK, "chunks": chunks, "blocks": chunks * heads}


def s8_attention_geometry(tokens: int, consumers: int) -> Dict[str, int]:
    """The int8 attention's schedule for one work item, a (frame, head), on a
    block of ``consumers`` consumer warpgroups (S8_CONSUMERS = 2 in the
    per-layer kernel and in the tower), as csrc/attention_s8_hopper.cuh
    computes it: its key blocks, whether they stay resident in the ring
    while all its query tiles walk them (up to 640 tokens), its ring loads
    (above the ring, each group of ``consumers`` tiles walks the keys twice)
    and query slots, and the per-layer launch's dynamic shared memory (ring,
    Q buffers, scales, the quantisers' partial maxima, barriers and 1024
    bytes of alignment), the same at every token count."""
    blocks = -(-tokens // ATTN_BLOCK)
    resident = blocks <= ATTN_STAGES
    groups = -(-blocks // consumers)
    data = ATTN_STAGES * 2 * ATTN_BLOCK * 128 + 2 * consumers * ATTN_BLOCK * 128 \
        + ATTN_STAGES * 2 * ATTN_BLOCK * 4 + 2 * 8 * ATTN_BLOCK * 4
    bars = 8 * (2 * ATTN_STAGES + 4 * consumers) + 8 * 2 * ATTN_STAGES
    return {"key_blocks": blocks, "resident": int(resident),
            "loads": blocks if resident else 2 * groups * blocks,
            "slots": blocks if resident else groups * consumers,
            "smem": data + bars + 1024}


def _attention_args(name: str, frames: int, tokens: int, heads: int, head_dim: int,
                    out_dtype: torch.dtype) -> None:
    """Raise unless the attention kernels take this geometry: head_dim 64,
    at least one token, and work items (frames x heads) that an int
    counts."""
    if head_dim != 64 or tokens < 1:
        raise ValueError(f"{name}: takes head_dim 64 and at least 1 token, got head_dim "
                         f"{head_dim}, {tokens} tokens")
    if frames * heads > GRID_MAX:
        raise ValueError(f"{name}: {frames} frames x {heads} heads exceed the kernels' "
                         f"work-item count")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: output {out_dtype} is neither bf16 nor f32")


def _launch_attention(name: str, fn, args: tuple, frames: int, tokens: int, heads: int,
                      head_dim: int, out_dtype: torch.dtype, device) -> torch.Tensor:
    out = torch.empty((frames * tokens, heads * head_dim), dtype=out_dtype, device=device)
    err = fn(*args, out.data_ptr(), frames, tokens, heads, head_dim ** -0.5,
             int(out_dtype == torch.float32), stream())
    check_launch(name, err)
    return out


def encoder_attention_packed(qkv: torch.Tensor, frames: int, tokens: int, heads: int,
                             head_dim: int,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Self-attention over contiguous packed bf16 rows qkv (frames * tokens,
    3W), [q | k | v], W = heads * head_dim -> (frames * tokens, W) in
    ``out_dtype`` (bf16, or f32 for the int8 whole block)."""
    name = "encoder_attention_packed"
    require_cuda(name, qkv)
    _attention_args(name, frames, tokens, heads, head_dim, out_dtype)
    if qkv.shape != (frames * tokens, 3 * heads * head_dim) or not qkv.is_contiguous():
        raise ValueError(f"{name}: takes contiguous (frames*tokens, 3W) rows, got "
                         f"{tuple(qkv.shape)}")
    return _launch_attention(name, library().dfd_encoder_attention_packed, (qkv.data_ptr(),),
                             frames, tokens, heads, head_dim, out_dtype, qkv.device)


def _row_pitch(x: torch.Tensor) -> Optional[int]:
    """The row pitch of an (N, T, H, D) view whose (frame, token) rows hold
    H * D values (head-major, D contiguous) at a fixed pitch, else None."""
    n, t, h, d = x.shape
    pitch = x.stride(1) if t > 1 else (x.stride(0) if n > 1 else h * d)
    want = (t * pitch, pitch, d, 1)
    ok = all(s == w or size == 1 for s, w, size in zip(x.stride(), want, x.shape))
    return pitch if ok else None


def encoder_attention_separate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Self-attention over bf16 q, k, v (N, T, H, D) -> (N * T, H * D) in
    ``out_dtype``. The three must share one row pitch: three contiguous
    tensors, or the [q | k | v] column blocks of one packed (N, T, 3HD)
    buffer (no copy is made)."""
    name = "encoder_attention_separate"
    require_cuda(name, q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be (N, T, H, D) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, t, h, d = q.shape
    _attention_args(name, n, t, h, d, out_dtype)
    pitch = _row_pitch(q)
    if pitch is None or _row_pitch(k) != pitch or _row_pitch(v) != pitch:
        raise ValueError(f"{name}: q, k and v must be rows of one pitch, got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    return _launch_attention(name, library().dfd_encoder_attention,
                             (q.data_ptr(), k.data_ptr(), v.data_ptr(), pitch),
                             n, t, h, d, out_dtype, q.device)


def encoder_attention_s8(qkv: torch.Tensor, frames: int, tokens: int, heads: int, head_dim: int,
                         qk_only: bool = False) -> torch.Tensor:
    """_attn_int8_cols over contiguous packed bf16 rows qkv (frames * tokens,
    3W) -> f32 (frames * tokens, W): both products on the int8 tensor cores,
    or with ``qk_only`` the logits only (PV in bf16). One persistent kernel
    (a block a SM, two consumer warpgroups) at every token count; a
    block's ring loads and query slots are counted in ints."""
    name = "encoder_attention_s8"
    require_cuda(name, qkv)
    _attention_args(name, frames, tokens, heads, head_dim, torch.float32)
    if qkv.shape != (frames * tokens, 3 * heads * head_dim) or not qkv.is_contiguous():
        raise ValueError(f"{name}: takes contiguous (frames*tokens, 3W) rows, got "
                         f"{tuple(qkv.shape)}")
    geo = s8_attention_geometry(tokens, S8_CONSUMERS)
    sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
    if -(-frames * heads // sms) * max(geo["loads"], geo["slots"]) > GRID_MAX:
        raise ValueError(f"{name}: {frames} frames x {heads} heads at {tokens} tokens exceed "
                         f"a block's load count")
    out = torch.empty((frames * tokens, heads * head_dim), dtype=torch.float32, device=qkv.device)
    err = library().dfd_encoder_attention_s8(qkv.data_ptr(), out.data_ptr(), frames, tokens,
                                             heads, head_dim ** -0.5 / (127.0 * 127.0),
                                             int(qk_only), stream())
    check_launch(name, err)
    return out


# numerics modes of csrc/study_attention.cu and its largest token count
STUDY_MODES = {"f32": 0, "bf16": 1, "diet": 2, "diet_nomax": 3}
STUDY_MAX_TOKENS = 256


def study_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """The attention study kernel over contiguous bf16 q, k, v (N, T, H, 64)
    in numerics mode ``mode`` (STUDY_MODES) -> (N, T, H, 64) bf16."""
    name = "study_attention"
    require_cuda(name, q, k, v)
    if mode not in STUDY_MODES:
        raise ValueError(f"{name}: mode must be one of {tuple(STUDY_MODES)}, got {mode!r}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous (N, T, H, D) of one shape")
    n, t, h, d = q.shape
    if d != 64 or not 1 <= t <= STUDY_MAX_TOKENS:
        raise ValueError(f"{name}: takes head_dim 64 and 1 to {STUDY_MAX_TOKENS} tokens, got "
                         f"head_dim {d}, {t} tokens")
    out = torch.empty_like(q)
    err = library().dfd_study_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        n, t, h, d ** -0.5, STUDY_MODES[mode], stream())
    check_launch(name, err)
    return out


def gemm_chain(h: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """csrc/gemm_chain.cu: h (R, W) bf16 through len(ws) products h =
    bf16(h @ ws[l]) in one launch, ws (L, W, W) contiguous bf16, W a
    multiple of 128 and at most 768 -> (R, W) bf16."""
    name = "gemm_chain"
    require_cuda(name, h, ws)
    if h.dim() != 2 or ws.dim() != 3 or not (h.is_contiguous() and ws.is_contiguous()):
        raise ValueError(f"{name}: takes contiguous h (R, W) and ws (L, W, W)")
    rows, w = h.shape
    if ws.shape[1:] != (w, w) or ws.shape[0] < 1 or w % 128 or w > 768 or rows < 1:
        raise ValueError(f"{name}: h {tuple(h.shape)}, ws {tuple(ws.shape)}: W must be a "
                         f"multiple of 128, at most 768")
    out = torch.empty_like(h)
    err = library().dfd_gemm_chain(h.data_ptr(), out.data_ptr(), ws.data_ptr(), rows, w,
                                   ws.shape[0], stream())
    check_launch(name, err)
    return out


def tower_chunk(frames: int, tokens: int) -> int:
    """Frames per chunk of the tower: the whole batch, up to TOWER_MAX_ROWS
    rows (the scratch then stays within about 2.4 GB at width 1024 in
    int8, as the per-layer chain's own intermediates would). Fewer frames a
    chunk only added stages, and each stage's fill, drain and grid barrier:
    on an H100 the batch of 320 frames ran fastest whole, against chunks
    that fill the card's 66 clusters 1 to 8 times and against the earlier
    L2 rule (PERF.md section 6). 320 frames (one chunk) at ViT-B/16, 255
    at ViT-L/14, 113 at ViT-L/14@336px."""
    return max(1, min(frames, TOWER_MAX_ROWS // tokens))


# the stages of one tower layer, in launch order, each ending in a grid
# barrier (csrc/encoder_tower.cuh walk): below the last layer, and the last
TOWER_STAGES = {
    False: ("ln1", "qkv", "attention", "out_proj", "ln2", "c_fc", "c_proj"),
    True: ("ln1_quant", "qkv", "attention", "quant_att", "out_proj", "ln2_quant", "c_fc",
           "quant_mid", "c_proj"),
}
TOWER_LAST_STAGES = ("ln1", "qkv_kv")


def tower_barriers(frames: int, chunk: int, layers: int, int8: bool) -> int:
    """Grid barriers of one tower launch over ``layers`` layers (the last
    K/V only): a stage of TOWER_STAGES each below the last, 2 for it, per
    chunk of ``chunk`` frames."""
    return -(-frames // chunk) * (len(TOWER_STAGES[int8]) * (layers - 1) + len(TOWER_LAST_STAGES))


def tower_grid(tokens: int, int8: bool, attn: str) -> int:
    """The largest co-resident grid of the tower kernel for this geometry
    (0: it cannot run cooperatively on this card)."""
    grid = ctypes.c_int(0)
    check_launch("encoder_tower", library().dfd_encoder_tower_grid(
        tokens, int(int8), TOWER_ATTN[attn], ctypes.byref(grid)))
    return grid.value


def tower_table(layers: list, width: int, hidden: int, int8: bool,
                device) -> torch.Tensor:
    """The tower's per-call device table: the weights' tensor maps (4 a
    layer, encoded by dfd_encoder_tower_table), the LayerW records (16
    pointers a layer: weights, scales, biases, LayerNorms) and a zeroed word
    for the grid barrier's counter, in one host buffer copied once."""
    ptrs = []
    for weights, scales, biases, norms in layers:
        ptrs += [x.data_ptr() for x in weights]
        ptrs += [x.data_ptr() if int8 else 0 for x in scales]
        ptrs += [x.data_ptr() for x in (*biases, *norms)]
    maps = 4 * len(layers) * TOWER_MAP_BYTES
    table = torch.zeros(maps + 8 * len(ptrs) + 16, dtype=torch.uint8)
    table[maps: maps + 8 * len(ptrs)].view(torch.int64).copy_(torch.tensor(ptrs, dtype=torch.int64))
    check_launch("encoder_tower", library().dfd_encoder_tower_table(
        table.data_ptr(), len(layers), width, hidden, int(int8)))
    return table.to(device)


def encoder_tower(h: torch.Tensor, layers: list, heads: int, *, first: int, lo: int,
                  int8: bool, attn: str = "0", grid: int = 0, chunk: Optional[int] = None,
                  stage_clock: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-encoder tower (csrc/encoder_tower.cu) over h (N, T, W) bf16,
    head_dim 64, any token count: layers 0..len(layers) - 1, the last of
    them K/V only, exporting layers ``first``.. with ``lo`` leading rows of
    each frame dropped. ``layers``: one (weights, scales, biases,
    norms) tuple of four tensors each a layer: the qkv, out-proj, c_fc and
    c_proj weights, bf16 (K, N) or with ``int8`` int8 (N, K) beside their
    (N,) f32 scales (None in bf16), their (N,) f32 biases, and the
    LayerNorms' f32 (W,) ln_1 scale, ln_1 shift, ln_2 scale, ln_2 shift.
    ``attn``: "0", "1" or "qk" (int8 only). One cooperative launch of
    ``grid`` blocks, whole clusters of two (0: as many as are co-resident);
    a grid that cannot be co-resident raises and nothing runs. ``chunk``:
    frames a chunk, tower_chunk's rule unless given (the chip check times
    other rules through it). ``stage_clock``: a zeroed int64
    tensor on the card of 2 + tower_barriers(...) entries, or None: the
    launch writes its reading count, then %globaltimer (ns) at its start and
    as each grid barrier completes (tools/bench_tower_stages.py reads it).
    Returns (k, v), (len(layers) - first, N, T - lo, W) bf16."""
    name = "encoder_tower"
    require_cuda(name, h)
    if h.dim() != 3 or not h.is_contiguous():
        raise ValueError(f"{name}: takes a contiguous (N, T, W) residual stream")
    n, t, w = h.shape
    last = len(layers) - 1
    if t < 1 or w != heads * 64 or w > 1024 or not 0 <= first <= last or lo not in (0, 1):
        raise ValueError(f"{name}: width {w} (at most 1024) with {heads} heads of 64, layers "
                         f"{first}..{last}")
    if attn not in TOWER_ATTN or (attn != "0" and not int8):
        raise ValueError(f"{name}: int8 attention {attn!r} needs the int8 tower")
    wdt = torch.int8 if int8 else torch.bfloat16
    hidden = layers[0][0][2].shape[0 if int8 else 1]
    if hidden % 64:
        raise ValueError(f"{name}: the MLP width {hidden} is not a multiple of 64")
    shapes = [(w, 3 * w), (w, w), (w, hidden), (hidden, w)]
    for weights, scales, biases, norms in layers:
        for i, (wt, (kin, nout)) in enumerate(zip(weights, shapes)):
            require_cuda(name, wt, dtype=wdt)
            require_cuda(name, biases[i], dtype=torch.float32)
            if tuple(wt.shape) != ((nout, kin) if int8 else (kin, nout)) or not wt.is_contiguous() \
                    or biases[i].shape != (nout,) or not biases[i].is_contiguous():
                raise ValueError(f"{name}: weight {i} {tuple(wt.shape)} / bias "
                                 f"{tuple(biases[i].shape)} for ({kin}, {nout})")
            if int8:
                require_cuda(name, scales[i], dtype=torch.float32)
                if scales[i].numel() != nout or not scales[i].is_contiguous():
                    raise ValueError(f"{name}: scale {i} {tuple(scales[i].shape)}")
        for x in norms:
            require_cuda(name, x, dtype=torch.float32)
            if x.shape != (w,) or not x.is_contiguous():
                raise ValueError(f"{name}: LayerNorm parameter {tuple(x.shape)}")
    if chunk is None:
        chunk = tower_chunk(n, t)
    if not 1 <= chunk <= n:
        raise ValueError(f"{name}: a chunk of {chunk} frames for {n} frames")
    if stage_clock is not None:
        require_cuda(name, stage_clock, dtype=torch.int64)
        if stage_clock.numel() < 2 + tower_barriers(n, chunk, len(layers), int8):
            raise ValueError(f"{name}: the stage clock needs 2 + "
                             f"{tower_barriers(n, chunk, len(layers), int8)} entries")
    table = tower_table(layers, w, hidden, int8, h.device)
    t_out, nsel = t - lo, last + 1 - first
    k = torch.empty((nsel, n, t_out, w), dtype=torch.bfloat16, device=h.device)
    v = torch.empty_like(k)
    rows = chunk * t

    def scratch(cols, dtype):
        return torch.empty((rows, cols), dtype=dtype, device=h.device)

    act = torch.float32 if int8 else torch.bfloat16
    buf = [scratch(w, torch.bfloat16), scratch(3 * w, torch.bfloat16), scratch(w, act),
           scratch(w, torch.float32), scratch(hidden, act)]
    buf += ([None, scratch(hidden, torch.int8), scratch(1, torch.float32)] if int8
            else [scratch(w, torch.bfloat16), None, None])
    err = library().dfd_encoder_tower(
        h.data_ptr(), table.data_ptr(), k.data_ptr(), v.data_ptr(), n, t, w, heads, hidden, first,
        last, lo, t_out, rows // t, int(int8), TOWER_ATTN[attn], 64 ** -0.5,
        64 ** -0.5 / (127.0 * 127.0), *(b.data_ptr() if b is not None else None for b in buf),
        grid, stage_clock.data_ptr() if stage_clock is not None else None, stream())
    if err == -1:
        raise RuntimeError(f"{name}: a grid of {grid or 'the co-resident'} blocks cannot be "
                           f"co-resident on this card at {t} tokens (at most "
                           f"{tower_grid(t, int8, attn)}); the tower launches cooperatively "
                           f"or not at all")
    check_launch(name, err)
    return k, v
