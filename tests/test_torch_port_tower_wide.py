"""The port's ViT-L int8 ladder on the CPU against the JAX package: the
whole-encoder tower at width 1024 (16 heads of 64) at 257, 321 and 577
tokens in each int8 attention mode against JAX's megakernel
(pallas_tower.fused_encoder_tower interpreted), the int8 attention's plain
version at 577 tokens against ``_attn_int8_cols`` (and its frame chunks),
the whole int8 block with int8 attention at width 1024 and 577 tokens
against its Pallas kernel interpreted, clip_vision_kv's tower and its gate
on a narrow 336-pixel tower (577 tokens) and at width 1024, and
Detector.predict through the tower with int8 attention at that geometry.
Inputs come from numpy with fixed seeds; each JAX tower reference is built
once per module.

Tolerances, with their reasons (those of tests/test_torch_port_variants.py,
whose helpers this module uses, and one more for what follows an attention):
* f32 with int8 quantisers: ``TOL_F32`` (1e-4) of the output's maximum on
  all but ``TIE_SHARE`` (10 %) of the rows, ``TOL_TIE`` (2e-2) on every
  row. The two packages take their f32 sums in another order (and the port
  subtracts the softmax's row maximum, the TPU kernel does not), so a value
  on a half-integer step of a per-row quantiser can round to the
  neighbouring int8 value, which moves its row by a quantum and feeds the
  next quantiser;
* after an attention the share of rows no longer bounds the difference: a
  tie that flips before the attention (in LN1's quantiser, say) moves one
  token's K and V, so every query row of its frame moves by a few ulps and
  the next quantiser flips on any of them (at 577 tokens and width 1024 one
  such flip a frame is typical). There every row is held at TOL_TIE and the
  mean difference at ``TOL_MEAN`` (1e-3) of the maximum, an eighth of a
  quantum on average (measured at 257-577 tokens: rows at most 1.26e-2 of
  the max, means at most 3.4e-4, 1.3-21 % of the rows past TOL_F32);
* f32 without quantisers: TOL_F32 of the maximum;
* the tower pads tokens to a multiple of 8 on the TPU, and with int8
  attention "1" its per-channel V scale takes the pad rows too, whose V is
  ln_1's shift through W_v plus b_v. The tower tests keep those two at zero
  (``pad_safe``), so JAX's scale is the unpadded one the port computes; the
  whole-block test, which does not pad, keeps them nonzero.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models.detector import Detector as JDetector
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu.ops import pallas_tower as jpt
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models.detector import Detector, EncoderKernels
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import attention as tatt
from dfd_clip_tpu_torch.ops import encoder_block as eb
from dfd_clip_tpu_torch.ops import tower as ttower
from test_torch_port_l336 import port_cfg
from test_torch_port_variants import (
    TOL_F32,
    TOL_TIE,
    _np,
    assert_close_ties,
    block_params,
    rel_err,
    th,
)

TOL_MEAN = 1e-3
W, HEADS, D, FRAMES = 1024, 16, 64, 2
# a narrow tower of ViT-L/14@336px's geometry: 24 x 24 patches of 14 plus CLS
NARROW = jvit.ViTConfig(input_resolution=336, patch_size=14, width=128, layers=2, heads=2,
                        output_dim=32)


def assert_close_after_attention(got, want):
    """TOL_TIE on every row (last axis), TOL_MEAN of the maximum on average
    (the module note's allowance past an attention)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want) / max(np.abs(want).max(), 1e-30)
    assert diff.max() <= TOL_TIE, diff.max()
    assert diff.mean() <= TOL_MEAN, diff.mean()


# -- the tower at width 1024 ------------------------------------------------------------

TOWER_CASES = [(tokens, mode, True) for tokens in (257, 321, 577) for mode in ("0", "1", "qk")]
TOWER_CASES += [(577, mode, False) for mode in ("0", "1", "qk")]


@pytest.fixture(scope="module")
def tower_blocks():
    """Two width-1024 blocks (pad_safe) and their stacked JAX form."""
    rng = np.random.default_rng(71)
    blocks = [block_params(rng, W, pad_safe=True) for _ in range(2)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                                     *blocks)
    return blocks, stacked


@pytest.fixture(scope="module")
def jax_tower(tower_blocks):
    """JAX's int8 tower interpreted (DFD_INT8_ATTN = mode), keep (0, 1), over
    a seeded (2, tokens, 1024) residual stream, one call per geometry and
    mode for the whole module: (h, (k, v))."""
    _, stacked = tower_blocks

    @functools.cache
    def build(tokens, mode, drop_cls):
        h = np.random.default_rng(tokens).standard_normal((FRAMES, tokens, W)).astype(np.float32)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DFD_INT8_ATTN", mode)
            want = jpt.fused_encoder_tower(jnp.asarray(h), stacked, HEADS, D, keep=(0, 1),
                                           drop_cls=drop_cls, int8_gemm=True)
        return h, [np.asarray(x) for x in want]

    return build


@pytest.mark.parametrize("tokens,mode,drop_cls", TOWER_CASES,
                         ids=[f"t{t}-attn{m}" + ("" if c else "-cls") for t, m, c in TOWER_CASES])
def test_tower_width_1024_matches_jax_tower(tower_blocks, jax_tower, tokens, mode, drop_cls):
    """The port's int8 tower (its plain version, on the CPU) against JAX's
    megakernel interpreted, keep (0, 1), 2 frames, in f32: layer 0's export
    (LN1 and the qkv projection of the input) with the tie allowance, layer
    1's (after layer 0's attention) with the allowance past an attention."""
    blocks, _ = tower_blocks
    h, want = jax_tower(tokens, mode, drop_cls)
    _cuda.reset_launches()
    got = ttower.fused_encoder_tower(torch.from_numpy(h), [th(b) for b in blocks], HEADS, D,
                                     keep=(0, 1), drop_cls=drop_cls, int8_gemm=True,
                                     int8_attn=mode)
    assert _cuda.launches() == {}   # a CPU tensor runs the plain version
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == (2, FRAMES, tokens - drop_cls, W)
        assert_close_ties(g[0], w_[0])
        assert_close_after_attention(g[1], w_[1])


# -- the int8 attention at 577 tokens -------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "qk"])
def test_attn_int8_cols_plain_577_matches_jax(mode):
    """attn_int8_cols_plain against _attn_int8_cols on the same arrays, 2
    frames of 577 tokens, 4 heads of 64, f32."""
    frames, tokens, heads = 2, 577, 4
    w = heads * D
    x = np.random.default_rng(72).standard_normal((frames, tokens, 3 * w)).astype(np.float32)
    want = np.stack([np.concatenate([np.asarray(c) for c in jpa._attn_int8_cols(
        jnp.asarray(x[f]), heads, D, D ** -0.5, qk_only=mode == "qk")], -1)
        for f in range(frames)])
    got = tatt.attn_int8_cols_plain(torch.from_numpy(x).reshape(frames * tokens, 3 * w), frames,
                                    tokens, heads, D, qk_only=mode == "qk")
    assert got.dtype == torch.float32
    assert_close_ties(got.reshape(frames, tokens, w), want)


@pytest.mark.parametrize("mode", ["1", "qk"])
def test_attn_int8_cols_plain_frame_chunks_change_nothing(monkeypatch, mode):
    """The int8 plain version's frame chunks (PLAIN_LOGITS_BYTES) leave the
    result bit for bit as one pass computes it: 5 frames of 577 tokens in
    chunks of 2 frames, and of 1."""
    frames, tokens, heads = 5, 577, 2
    x = torch.from_numpy(np.random.default_rng(73).standard_normal(
        (frames * tokens, 3 * heads * D)).astype(np.float32)).bfloat16()
    whole = tatt.attn_int8_cols_plain(x, frames, tokens, heads, D, qk_only=mode == "qk")
    for per_chunk in (2, 1):
        monkeypatch.setattr(tatt, "PLAIN_LOGITS_BYTES", per_chunk * 4 * heads * tokens * tokens)
        assert torch.equal(tatt.attn_int8_cols_plain(x, frames, tokens, heads, D,
                                                     qk_only=mode == "qk"), whole)


# -- the whole int8 block at width 1024 ------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "qk"])
def test_int8_whole_block_577_matches_pallas(monkeypatch, mode):
    """fused_encoder_block with int8_gemm and int8_attn at width 1024, 16
    heads and 577 tokens (1 frame, ln_1's shift and the V bias nonzero: the
    per-layer block does not pad) against the Pallas whole block with
    DFD_INT8_ATTN interpreted, in f32: the CLS-dropped K/V export with the
    tie allowance, h (past the attention) with the allowance past an
    attention."""
    monkeypatch.setenv("DFD_INT8_ATTN", mode)
    rng = np.random.default_rng(74)
    bp = block_params(rng, W)
    assert np.abs(bp["ln_1"]["bias"]).min() > 0 and np.abs(bp["attn"]["in_proj"]["b"]).min() > 0
    h = rng.standard_normal((1, 577, W)).astype(np.float32)
    j = jax.tree_util.tree_map(jnp.asarray, bp)
    t = th(bp)
    kw = dict(export=True, drop_cls=True, int8_gemm=True)
    want = jpa.fused_encoder_block(jnp.asarray(h), j["ln_1"], j["attn"], j["ln_2"], j["mlp"],
                                   HEADS, D, **kw)
    _cuda.reset_launches()
    got = eb.fused_encoder_block(torch.from_numpy(h), t["ln_1"], t["attn"], t["ln_2"], t["mlp"],
                                 HEADS, D, int8_attn=mode, **kw)
    assert _cuda.launches() == {}
    assert len(got) == len(want) == 3
    assert tuple(got[1].shape) == (1, 576, HEADS, D)
    assert_close_after_attention(got[0], want[0])
    for g, w_ in zip(got[1:], want[1:]):
        assert_close_ties(g, w_)


# -- clip_vision_kv's tower and its gate -----------------------------------------------------

def _env(monkeypatch, tower, attn):
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    monkeypatch.setenv("DFD_MEGAKERNEL", "1" if tower else "0")
    monkeypatch.setenv("DFD_INT8_ATTN", attn)


@pytest.fixture(scope="module")
def narrow_io():
    params = jax.tree_util.tree_map(np.asarray, jvit.init_clip_vision(jax.random.key(75), NARROW))
    x = np.random.default_rng(76).standard_normal((FRAMES, 3, 336, 336)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("attn", ["0", "1", "qk"])
def test_clip_vision_kv_336_tower_matches_jax(narrow_io, monkeypatch, attn):
    """clip_vision_kv(tower=True, compute_int8=True) on the narrow 336-pixel
    tower (577 tokens, keep (0, 1), drop_cls, pad_tokens) against JAX with
    DFD_MEGAKERNEL=1 and DFD_INT8_ATTN, interpreted, in f32 (layer 0's
    export with the tie allowance, layer 1's with the allowance past an
    attention); the port's tower runs (not the per-layer blocks), its export
    unpadded."""
    params, x = narrow_io
    _env(monkeypatch, True, attn)
    kw = dict(keep_layers=(0, 1), drop_cls=True, pad_tokens=True, compute_int8=True)
    want = jvit.clip_vision_kv(jvit.prepare_int8_params(
        jax.tree_util.tree_map(jnp.asarray, params)), jnp.asarray(x), NARROW,
        compute_dtype=jnp.float32, **kw)
    calls = []
    tower = tvit.fused_encoder_tower
    monkeypatch.setattr(tvit, "fused_encoder_tower",
                        lambda *a, **k: calls.append(1) or tower(*a, **k))
    got = tvit.clip_vision_kv(tvit.prepare_int8_params(params_from_jax(params)),
                              torch.from_numpy(x), port_cfg(NARROW),
                              compute_dtype=torch.float32, tower=True, int8_attn=attn, **kw)
    assert calls == [1]
    for s in ("k", "v"):
        assert tuple(got[s].shape) == (2, FRAMES, 576, NARROW.heads, NARROW.head_dim)
        assert_close_ties(got[s][0], want[s][0])
        assert_close_after_attention(got[s][1], want[s][1])


# a 2-layer, 16-head tower of width 1024 at 32 pixels (5 tokens)
WIDE_TINY = jvit.ViTConfig(input_resolution=32, patch_size=16, width=W, layers=2, heads=HEADS,
                           output_dim=32)


@pytest.fixture(scope="module")
def wide_tiny_io():
    params = jax.tree_util.tree_map(np.asarray,
                                    jvit.init_clip_vision(jax.random.key(77), WIDE_TINY))
    x = np.random.default_rng(78).standard_normal((FRAMES, 3, 32, 32)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_refused", "compute_int8"])
def test_clip_vision_kv_width_1024_tower_gate_matches_jax(wide_tiny_io, monkeypatch, int8):
    """At width 1024 the gate takes the tower with compute_int8 only: a bf16
    tower request runs the XLA composition, as JAX's gate does with
    DFD_MEGAKERNEL=1 (WIDE_TINY, keep (0, 1), drop_cls, pad_tokens: the
    composition's export is padded to 8 rows, the tower's not)."""
    cfg = WIDE_TINY
    params, x = wide_tiny_io
    _env(monkeypatch, True, "0")
    kw = dict(keep_layers=(0, 1), drop_cls=True, pad_tokens=True, compute_int8=int8)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jvit.clip_vision_kv(jvit.prepare_int8_params(jp) if int8 else jp, jnp.asarray(x), cfg,
                               compute_dtype=jnp.float32, **kw)
    calls = []
    tower = tvit.fused_encoder_tower
    monkeypatch.setattr(tvit, "fused_encoder_tower",
                        lambda *a, **k: calls.append(1) or tower(*a, **k))
    tp = params_from_jax(params)
    got = tvit.clip_vision_kv(tvit.prepare_int8_params(tp) if int8 else tp, torch.from_numpy(x),
                              port_cfg(cfg), compute_dtype=torch.float32, tower=True, **kw)
    assert calls == ([1] if int8 else [])
    for s in ("k", "v"):
        assert tuple(got[s].shape) == (2, FRAMES, 4 if int8 else 8, HEADS, D)
        if int8:
            assert_close_ties(got[s][0], want[s][0])
            assert_close_after_attention(got[s][1], want[s][1])
        else:
            assert rel_err(got[s], want[s]) <= TOL_F32


# -- the detector ------------------------------------------------------------------------------

def test_detector_predict_336_int8_tower_matches_jax(monkeypatch):
    """The narrow "ViT-L/14@336px" detector (NARROW, keep (0, 1), 2 frames a
    clip) with compute_int8 and EncoderKernels(tower=True, int8_attn="1")
    against JAX with DFD_MEGAKERNEL=1 and DFD_INT8_ATTN=1, Pallas
    interpreted, in f32: the decoder reads the tower's 576-row export."""
    _env(monkeypatch, True, "1")
    monkeypatch.setenv("DFD_DEC_STACK", "force")
    cfg = {"architecture": "ViT-L/14@336px", "decode_mode": "index", "decode_indices": [0, 1],
           "out_dim": [2], "losses": ["auc_roc"],
           "op_mode": {"temporal_position": 1, "compute_int8": 1}}
    jcfg, tcfg = JDetector.get_default_config(), Detector.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    jdet = JDetector(jcfg, num_frames=2, compute_dtype=jnp.float32)
    tdet = Detector(tcfg, num_frames=2, compute_dtype=torch.float32, device="cpu",
                    encoder_kernels=EncoderKernels(tower=True, int8_attn="1"))
    for det, vit in ((jdet, NARROW), (tdet, port_cfg(NARROW))):
        assert det.transform.size == 336
        det.vit_cfg = vit
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=vit.width, heads=vit.heads)
    jparams = jdet.init_params(jax.random.key(79))
    tparams = tdet.prepare_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    x = np.random.default_rng(80).integers(0, 256, (2, 2, 3, 224, 240), dtype=np.uint8)
    m = np.array([[True, True], [True, False]])
    kv = tdet.encode_kv(tparams, tdet.preprocess(torch.from_numpy(x)), pad_tokens=True)
    assert tuple(kv["k"].shape) == (2, 2, 2, 576, 2, 64)
    want, _ = jdet.predict(jdet.prepare_params(jparams), jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    assert np.abs(got[0].float().numpy() - np.asarray(want[0])).max() <= TOL_F32 * 5
