"""Host-side parts of the decoder attention backward and the study attention
(dfd_clip_tpu_torch on the CPU): the backward's tile, chunk, grid, pass and
shared-memory geometry (_cuda.bwd_geometry) and the study kernel's
(_cuda.study_geometry) with their refusals, the constants they share with
the CUDA sources, and the wrappers' contracts on CPU tensors (shapes, dtypes,
no dpos without pos, ValueErrors). The kernels themselves run on the card
(tests/test_torch_port_cuda.py); on the CPU each wrapper takes its plain
version, which tests/test_torch_port_train.py and
tests/test_torch_port_tools.py hold against the JAX package.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import study_attention as sa
from dfd_clip_tpu_torch.ops.fused_decoder_attention_bwd import (
    _bwd_math,
    fused_decoder_attention_bwd,
    fused_decoder_attention_bwd_plain,
)

H100_SMS = 132


def constexpr(source: str, name: str) -> int:
    text = (_cuda.CSRC / source).read_text()
    found = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert found, f"{name} not in {source}"
    return found.group(1).strip()


def test_bwd_constants_match_the_kernel():
    """The geometry's tile, ring and warps are the kernel's constants."""
    assert int(constexpr("decoder_attention_bwd.cu", "WARPS")) == _cuda.BWD_WARPS
    assert int(constexpr("decoder_attention_bwd.cu", "STAGES")) == _cuda.BWD_STAGES
    assert int(constexpr("decoder_attention_bwd.cu", "HEADER_BYTES")) == _cuda.BWD_HEADER
    assert int(constexpr("decoder_attention_bwd.cu", "ALIGN")) == _cuda.BWD_ALIGN
    # TILE = WARPS x STEPS x 4 tokens
    steps = int(constexpr("decoder_attention_bwd.cu", "STEPS"))
    assert _cuda.BWD_WARPS * steps * 4 == _cuda.BWD_TILE


@pytest.mark.parametrize("batch,tokens,heads,tiles,chunk_tiles,chunks", [
    (12, 4000, 12, 42, 4, 11),      # the train step: 132 items, one wave
    (12, 5120, 16, 54, 7, 8),       # the 257-token towers' L at 16 heads
    (12, 11520, 16, 120, 15, 8),    # ViT-L@336's L at 16 heads
    (3, 1, 2, 1, 1, 1),
    (3, 96, 2, 1, 1, 1),
    (3, 97, 2, 2, 1, 2),
    (3, 4000, 200, 42, 42, 1),      # more heads than SMs: one chunk a head
])
def test_bwd_geometry(batch, tokens, heads, tiles, chunk_tiles, chunks):
    geo = _cuda.bwd_geometry(batch, tokens, heads, H100_SMS)
    assert (geo["tiles"], geo["chunk_tiles"], geo["chunks"]) == (tiles, chunk_tiles, chunks)
    assert geo["items"] == heads * chunks
    assert geo["grid"] == min(geo["items"], H100_SMS)
    # the chunks cover the tiles, the last one holds at least one
    assert (chunks - 1) * chunk_tiles < tiles <= chunks * chunk_tiles
    # heads x chunks fill the SMs in one wave where the heads allow it
    assert geo["items"] <= max(H100_SMS, heads)
    assert geo["group"] == batch and geo["passes"] == 1
    assert geo["smem"] <= _cuda.SMEM_LIMIT


def test_bwd_geometry_shared_memory():
    """The layout below the samples (ring, two pos tiles, headers, barriers,
    flag, 128-byte aligned) plus the alignment slack plus `group` samples,
    and groups as large as the limit allows."""
    tile_bytes = _cuda.BWD_TILE * 64 * 2
    stages = _cuda.BWD_STAGES
    fixed = stages * 2 * tile_bytes + 2 * tile_bytes + stages * 32 + 8 * (2 * stages + 4) + 16
    fixed = -(-fixed // 128) * 128
    geo = _cuda.bwd_geometry(12, 4000, 12, H100_SMS)
    assert geo["smem"] == 128 + fixed + 12 * _cuda.BWD_SAMPLE
    assert _cuda.BWD_SAMPLE == 4 * 196 + _cuda.BWD_WARPS * 512
    most = (_cuda.SMEM_LIMIT - 128 - fixed) // _cuda.BWD_SAMPLE
    big = _cuda.bwd_geometry(4 * most + 1, 300, 12, H100_SMS)
    assert big["group"] == most and big["passes"] == 5
    assert big["smem"] <= _cuda.SMEM_LIMIT
    assert big["smem"] + _cuda.BWD_SAMPLE > _cuda.SMEM_LIMIT


@pytest.mark.parametrize("args", [(0, 10, 2, 132), (2, 0, 2, 132), (2, 10, 0, 132),
                                  (2, 10, 2, 0), (2 ** 16, 2 ** 16, 2, 132)])
def test_bwd_geometry_refuses(args):
    with pytest.raises(ValueError):
        _cuda.bwd_geometry(*args)


def test_study_constants_match_the_kernel():
    assert int(constexpr("study_attention.cu", "BAND")) == _cuda.STUDY_BAND
    assert int(constexpr("study_attention.cu", "KTILE")) == _cuda.STUDY_KTILE
    assert int(constexpr("study_attention.cu", "MAX_TOKENS")) == _cuda.STUDY_MAX_TOKENS
    assert constexpr("study_attention.cu", "VP") == "D + 4" and _cuda.STUDY_V_PITCH == 68


@pytest.mark.parametrize("tokens,blocks,narrow", [(1, 1, 0), (16, 1, 0), (17, 1, 0),
                                                  (64, 1, 0), (65, 2, 1), (80, 2, 1),
                                                  (81, 2, 0), (128, 2, 0), (129, 3, 1),
                                                  (197, 4, 1), (256, 4, 0)])
@pytest.mark.parametrize("mode", ["bf16", "diet", "diet_nomax"])
def test_study_geometry_tensor_core_modes(mode, tokens, blocks, narrow):
    """The bf16 modes: key blocks of 64, at most 4 (the kernel's template
    argument), resident in the encoder attention's ring; the N = 16 tail
    where the last of two or more blocks holds at most 16 keys."""
    geo = _cuda.study_geometry(tokens, mode)
    assert geo["route"] == "wgmma"
    assert (geo["key_blocks"], geo["narrow"]) == (blocks, narrow)
    assert geo["key_blocks"] <= min(4, _cuda.ATTN_STAGES)


@pytest.mark.parametrize("tokens,bands,pitch,chunk", [(1, 1, 4, 32), (5, 1, 8, 32),
                                                      (32, 1, 32, 32), (33, 2, 36, 64),
                                                      (197, 7, 200, 96), (256, 8, 256, 64)])
def test_study_geometry_f32(tokens, bands, pitch, chunk):
    """"f32": a warp a band of 32 rows, Q^T at a pitch of the tokens rounded
    up to 4 with 32 floats of slack (a band's reads past the last row stay
    inside), the keys in chunks of the widest multiple of 32 with which two
    blocks share a SM (K^T [64][chunk] + 32, V [chunk][68])."""
    geo = _cuda.study_geometry(tokens, "f32")
    assert geo["route"] == "ffma"
    assert (geo["bands"], geo["pitch"], geo["chunk"]) == (bands, pitch, chunk)
    assert geo["chunks"] == -(-tokens // chunk)
    assert bands * 32 - pitch <= 32
    floats = lambda c: 64 * pitch + 32 + 64 * c + 32 + c * 68
    assert geo["smem"] == 4 * floats(chunk)
    assert 2 * (geo["smem"] + 1024) <= 228 * 1024
    wider = chunk + 32
    assert wider > -(-tokens // 32) * 32 or 2 * (4 * floats(wider) + 1024) > 228 * 1024


@pytest.mark.parametrize("tokens,mode", [(0, "f32"), (257, "f32"), (257, "bf16"),
                                         (10, "tf32"), (10, "F32")])
def test_study_geometry_refuses(tokens, mode):
    with pytest.raises(ValueError):
        _cuda.study_geometry(tokens, mode)


def test_study_wrapper_on_cpu():
    """On CPU tensors the wrapper is the plain version: bf16 (N, T, H, 64)
    out, an unknown mode a ValueError, nothing launched."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 3, 64))).bfloat16() for _ in range(3))
    _cuda.reset_launches()
    for mode in sa.MODES:
        got = sa.study_attention(q, k, v, mode)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert torch.equal(got, sa.study_attention_plain(q, k, v, mode))
    assert _cuda.launches() == {}
    with pytest.raises(ValueError):
        sa.study_attention(q, k, v, "tf32")


def bwd_args(rng, b=3, h=2, l=37, with_pos=True, stacked=True):
    """The backward's arguments on the CPU: bf16 queries, K/V (stacked,
    read at slot 1), pos, a mask with the last sample fully masked, the
    forward's stats and a bf16 cotangent."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    qs, qc = f(b, 1, h, 64).bfloat16(), f(b, 1, h, 64).bfloat16()
    shape = ((2,) if stacked else ()) + (b, l, h, 64)
    k, v = (0.5 * f(*shape)).bfloat16(), f(*shape).bfloat16()
    pos = (0.1 * f(l, h, 64)).bfloat16() if with_pos else None
    mask = torch.ones(b, l, dtype=torch.bool)
    mask[0, l // 2:] = False
    mask[b - 1] = False
    denom, mx = f(b, h).abs() + 1.0, f(b, h)
    o_s, ct = f(b, h, 64), f(b, 1, h, 64).bfloat16()
    return (qs, qc, k, v, mask, pos, 1 if stacked else None, denom, mx, o_s, ct)


@pytest.mark.parametrize("with_pos", [True, False])
@pytest.mark.parametrize("stacked", [True, False])
def test_bwd_wrapper_on_cpu(with_pos, stacked):
    """On CPU tensors the wrapper is _bwd_math's dq / dpos: dq (B, 1, H, 64)
    in f32 (or bf16 when asked: the f32 values rounded), dpos (L, H, 64)
    f32, None without pos; the fully masked sample's dq is 0; nothing
    launched."""
    args = bwd_args(np.random.default_rng(4), with_pos=with_pos, stacked=stacked)
    b, l, h = 3, 37, 2
    _cuda.reset_launches()
    dqs, dqc, dpos = fused_decoder_attention_bwd(*args)
    assert _cuda.launches() == {}
    for dq in (dqs, dqc):
        assert dq.shape == (b, 1, h, 64) and dq.dtype == torch.float32
        assert torch.equal(dq[b - 1], torch.zeros_like(dq[b - 1]))
    assert (dpos is None) == (not with_pos)
    if with_pos:
        assert dpos.shape == (l, h, 64) and dpos.dtype == torch.float32
    layer, rest = args[6], args[:6]
    want = _bwd_math(layer, *rest[:5], rest[5], args[7], args[8], args[10])
    assert torch.equal(dqs, want[0]) and torch.equal(dqc, want[1])
    lo = fused_decoder_attention_bwd(*args, dq_dtype=torch.bfloat16)
    assert torch.equal(lo[0], dqs.bfloat16()) and torch.equal(lo[1], dqc.bfloat16())
    plain = fused_decoder_attention_bwd_plain(*args, dq_dtype=torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(lo[:2], plain[:2]))


@pytest.mark.parametrize("stacked", [True, False])
def test_bwd_wrapper_with_kv_on_cpu(stacked):
    """with_kv: the wrapper also returns the slot's dK and dV, (B, L, H,
    64) in K/V's bf16, _bwd_math's own, exactly 0 at masked tokens; dq and
    dpos as without; each plain call counted in _cuda.plain_calls (which
    reset_launches clears), no launch."""
    args = bwd_args(np.random.default_rng(7), stacked=stacked)
    _cuda.reset_launches()
    got = fused_decoder_attention_bwd(*args, with_kv=True)
    assert _cuda.launches() == {} and _cuda.plain_calls() == {"_bwd_math": 1}
    without = fused_decoder_attention_bwd(*args)
    assert _cuda.plain_calls() == {"_bwd_math": 2}
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got[:3], without))
    want = _bwd_math(args[6], *args[:6], args[7], args[8], args[10])
    mask = args[4]
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == torch.bfloat16 and g.shape == (3, 37, 2, 64) and torch.equal(g, w)
        assert torch.equal(g[~mask], torch.zeros_like(g[~mask]))
    _cuda.reset_launches()
    assert _cuda.plain_calls() == {}


def test_bwd_wrapper_refuses_on_cpu():
    """dq_dtype other than f32 / bf16 is a TypeError; another device than CPU
    or CUDA a ValueError."""
    args = bwd_args(np.random.default_rng(5))
    with pytest.raises(TypeError):
        fused_decoder_attention_bwd(*args, dq_dtype=torch.float16)
    meta = tuple(t.to("meta") if isinstance(t, torch.Tensor) else t for t in args)
    with pytest.raises(ValueError):
        fused_decoder_attention_bwd(*meta)


def test_bwd_trainable_function_grads_in_query_dtype():
    """The autograd Function's backward hands back dq in the queries' dtype
    (bf16 queries: bf16 grads) and dpos in the embedding's (f32), so no cast
    follows the kernel."""
    from dfd_clip_tpu_torch.ops.decoder_attention_vjp import fused_decoder_attention_trainable

    qs, qc, k, v, mask, pos, layer, *_ = bwd_args(np.random.default_rng(6))
    qs, qc = qs.requires_grad_(), qc.requires_grad_()
    pos = pos.float().requires_grad_()
    out = fused_decoder_attention_trainable(qs, qc, k, v, mask, pos, layer)
    out.float().sum().backward()
    assert qs.grad.dtype == torch.bfloat16 and qc.grad.dtype == torch.bfloat16
    assert pos.grad.dtype == torch.float32 and pos.grad.shape == pos.shape


def test_bwd_tool_checks_on_cpu_and_defaults_to_the_card(capsys):
    """tools/bench_decoder_bwd's main(): with --device cpu its check at small
    shapes (one with the masked samples, one of a single sample) and no
    timing; without a device argument the card, which a machine without one
    lacks."""
    from dfd_clip_tpu_torch.tools import bench_decoder_bwd as tbw

    assert tbw.main(["--device", "cpu", "--shapes", "3x13x11x2", "1x7x7x3"]) == 0
    out = capsys.readouterr().out
    assert "3x13x11x2 (L = 260): correctness ok" in out and " ms" not in out
    assert "1x7x7x3 (L = 140): correctness ok" in out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbw.main(["--shapes", "3x13x11x2"])
