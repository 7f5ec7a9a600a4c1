"""The port's 577-token slice (CLIP ViT-L/14@336px) on the CPU against the
JAX package: the encoder attention's plain versions above the staged
kernel's 320 tokens (the streamed kernel's rounding point) against JAX's
XLA attention and its Pallas kernels interpreted, clip_vision_kv on a narrow
336-pixel, patch-14 tower (577 tokens), the int8 split pair at width 1024
and 577 tokens against its Pallas kernels, Detector.predict on a narrow
336-pixel detector, and the geometry of the real ViT-L/14@336px detector.

Tolerances, with their reasons:
* f32: atol = rtol = 1e-4 (conftest sets the JAX matmul precision to
  "highest"; the Pallas kernels clamp the logits at 60 and subtract no
  maximum, the port subtracts it, which differs in f32 rounding only);
* bf16: 1e-2 of the output's maximum, about two bf16 ulps (the port rounds
  exp(l - max) to bf16, the TPU kernel exp(l), and XLA the normalised
  probabilities: the same values rounded at other scales);
* the int8 split pair in f32: 1e-4 of the maximum on all but ``TIE_SHARE``
  (10 %) of the rows and ``TOL_TIE`` (2e-2) on every row. Its LayerNorm
  and GELU outputs are quantised per row; a value that the two packages'
  f32 sums (taken in another order) put on either side of a half-integer
  step rounds to neighbouring int8 values, which moves its output row by a
  quantum (observed on 0.45 % of the elements of a 577-row block, 2.2e-2
  absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models.detector import Detector as JDetector
from dfd_clip_tpu.ops import attention as jattn
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import attention as tattn
from dfd_clip_tpu_torch.ops import encoder_block as eb

TOL = dict(rtol=1e-4, atol=1e-4)
REL = 1e-2
TOL_F32, TOL_TIE, TIE_SHARE = 1e-4, 2e-2, 0.1
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# a narrow tower of ViT-L/14@336px's geometry: 24 x 24 patches of 14 plus CLS
NARROW = jvit.ViTConfig(input_resolution=336, patch_size=14, width=128, layers=2, heads=2,
                        output_dim=32)
# the width-1024, 16-head int8 split pair at 577 tokens
WIDE = jvit.ViTConfig(input_resolution=336, patch_size=14, width=1024, layers=1, heads=16,
                      output_dim=32)


def close(got, want, dtype):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


def close_ties(got, want):
    """The int8 tie allowance of the module note, over output rows."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    rows = (np.abs(got - want) / np.abs(want).max()).reshape(-1, got.shape[-1]).max(-1)
    assert rows.max() <= TOL_TIE, rows.max()
    assert (rows > TOL_F32).mean() <= TIE_SHARE, ((rows > TOL_F32).mean(), rows.max())


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_cfg(cfg):
    return tvit.ViTConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tvit.ViTConfig)})


# -- the encoder attention above 320 tokens --------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("frames,tokens", [(2, 321), (1, 577)], ids=["t321", "t577"])
@pytest.mark.parametrize("entry", ["packed", "separate"])
def test_streamed_attention_plain_matches_jax(monkeypatch, entry, frames, tokens, reference,
                                              dtype):
    """head_dim 64, 2 heads, through the dispatchers on both sides: JAX's XLA
    attention or fused_encoder_attention_qkv / fused_encoder_attention
    interpreted; on the CPU the port takes its plain version and launches
    nothing."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    jdt, tdt = DTYPES[dtype]
    heads, d = 2, 64
    qkv = np.random.default_rng(tokens + frames).standard_normal(
        (frames, tokens, 3 * heads * d)).astype(np.float32)
    _cuda.reset_launches()
    if entry == "packed":
        want = jattn.encoder_self_attention_qkv(jnp.asarray(qkv, jdt), heads, d)
        got = tattn.encoder_self_attention_qkv(torch.from_numpy(qkv).to(tdt), heads, d)
    else:
        q, k, v = (jnp.asarray(s, jdt).reshape(frames, tokens, heads, d)
                   for s in np.split(qkv, 3, axis=-1))
        want = jattn.encoder_self_attention(q, k, v)
        tq, tk, tv = (s.reshape(frames, tokens, heads, d)
                      for s in torch.from_numpy(qkv).to(tdt).split(heads * d, dim=-1))
        got = tattn.encoder_self_attention(tq, tk, tv)
    assert _cuda.launches() == {}
    assert got.dtype == tdt
    close(got, want, dtype)


def test_plain_attention_frame_chunks_change_nothing(monkeypatch):
    """The plain versions' frame chunks (PLAIN_LOGITS_BYTES) leave the result
    bit for bit as one pass computes it, at 577 and at 197 tokens."""
    rng = np.random.default_rng(3)
    for tokens in (577, 197):
        q, k, v = (torch.from_numpy(rng.standard_normal((5, tokens, 2, 64)).astype(np.float32))
                   .bfloat16() for _ in range(3))
        whole = tattn.plain_attention(q, k, v)
        monkeypatch.setattr(tattn, "PLAIN_LOGITS_BYTES", 2 * 4 * 2 * tokens * tokens)
        assert torch.equal(tattn.plain_attention(q, k, v), whole)   # chunks of 2 frames
        monkeypatch.undo()


@pytest.mark.parametrize("tokens,heads", [(197, 12), (257, 16), (577, 2)])
def test_streamed_rounding_point_is_the_tpu_kernels(monkeypatch, tokens, heads):
    """In bf16 the plain version rounds the unnormalised probabilities (the
    TPU kernel's point, and the kernel's at every token count): it sits
    closer, in mean |d|, to the Pallas kernel interpreted than the
    normalised rounding (XLA's point, computed here) does, on the same
    2-frame input at ViT-B/16's, ViT-L/14's and ViT-L/14@336px's token
    counts."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    w = heads * 64
    qkv = np.random.default_rng(5).standard_normal((2, tokens, 3 * w)).astype(np.float32)
    want = np.asarray(jattn.encoder_self_attention_qkv(jnp.asarray(qkv, jnp.bfloat16), heads, 64)
                      .astype(jnp.float32))
    x = torch.from_numpy(qkv).bfloat16()
    got = tattn.plain_attention_qkv(x, heads, 64).float().numpy()
    q, k, v = (s_.reshape(2, tokens, heads, 64).float() for s_ in x.split(w, dim=-1))
    logits = torch.einsum("nqhd,nkhd->nhqk", q * 64 ** -0.5, k)
    probs = torch.softmax(logits, dim=-1).bfloat16().float()
    normalised = torch.einsum("nhqk,nkhd->nqhd", probs, v).bfloat16().float()
    normalised = normalised.reshape(2, tokens, w).numpy()
    assert np.abs(got - want).mean() < np.abs(normalised - want).mean()


# -- the towers ------------------------------------------------------------------------------

@pytest.mark.parametrize("reference,dtype", [("xla", "f32"), ("pallas", "f32"),
                                             ("pallas", "bf16")])
def test_clip_vision_kv_577_tokens_matches_jax(monkeypatch, reference, dtype):
    """The narrow 336-pixel tower, 2 frames, keep (0, 1), drop_cls,
    pad_tokens: 576 patches, already a multiple of 8, so no pad rows."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    jdt, tdt = DTYPES[dtype]
    assert NARROW.num_tokens == 577
    params = to_np(jvit.init_clip_vision(jax.random.key(11), NARROW))
    x = np.random.default_rng(12).standard_normal((2, 3, 336, 336)).astype(np.float32)
    kw = dict(keep_layers=(0, 1), drop_cls=True, pad_tokens=True)
    want = jvit.clip_vision_kv(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                               NARROW, compute_dtype=jdt, **kw)
    got = tvit.clip_vision_kv(params_from_jax(params), torch.from_numpy(x), port_cfg(NARROW),
                              compute_dtype=tdt, **kw)
    for s in ("k", "v"):
        assert tuple(got[s].shape) == (2, 2, 576, 2, 64) and got[s].dtype == tdt
        close(got[s], want[s], dtype)


@pytest.fixture(scope="module")
def wide_block():
    """One seeded width-1024 block with LayerNorms and biases off their init
    values, and a residual stream of 1 frame x 577 tokens."""
    rng = np.random.default_rng(13)
    bp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                to_np(jvit.init_clip_vision(jax.random.key(14), WIDE)["blocks"]))
    w = WIDE.width
    for ln in (bp["ln_1"], bp["ln_2"]):
        ln["scale"] = (1 + 0.3 * rng.standard_normal(w)).astype(np.float32)
        ln["bias"] = (0.1 * rng.standard_normal(w)).astype(np.float32)
    for lin in (bp["attn"]["in_proj"], bp["attn"]["out_proj"], bp["mlp"]["c_fc"],
                bp["mlp"]["c_proj"]):
        lin["b"] = (0.05 * rng.standard_normal(lin["b"].shape)).astype(np.float32)
    bp["h"] = rng.standard_normal((1, WIDE.num_tokens, w)).astype(np.float32)
    return bp


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("half", ["attn_export", "mlp"])
def test_int8_split_pair_577_tokens_matches_pallas(wide_block, half, dtype):
    """compute_int8's split pair at ViT-L/14@336px's width and 577 tokens:
    the attention half with its CLS-dropped K/V export and the MLP half,
    against fused_encoder_attn_block / fused_encoder_mlp_block interpreted."""
    jdt, tdt = DTYPES[dtype]
    bp = wide_block
    jp, tp = jax.tree_util.tree_map(jnp.asarray, bp), params_from_jax(bp)
    if half == "mlp":
        want = [jpa.fused_encoder_mlp_block(jnp.asarray(bp["h"], jdt), jp["ln_2"], jp["mlp"],
                                            int8_gemm=True)]
        got = [eb.fused_encoder_mlp_block(tp["h"].to(tdt), tp["ln_2"], tp["mlp"], int8_gemm=True)]
    else:
        kw = dict(export=True, drop_cls=True, int8_gemm=True)
        want = jpa.fused_encoder_attn_block(jnp.asarray(bp["h"], jdt), jp["ln_1"], jp["attn"],
                                            WIDE.heads, WIDE.head_dim, **kw)
        got = eb.fused_encoder_attn_block(tp["h"].to(tdt), tp["ln_1"], tp["attn"], WIDE.heads,
                                          WIDE.head_dim, **kw)
        assert tuple(got[1].shape) == (1, 576, 16, 64)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == tdt
        if dtype == "f32":
            close_ties(g, w_)
        else:
            close(g, w_, dtype)


# -- the detector ---------------------------------------------------------------------------

def narrow_detectors(monkeypatch):
    """JAX's and the port's "ViT-L/14@336px" detectors with the tower swapped
    for NARROW (keep (0, 1)), f32, 2 frames a clip: the 336-pixel bicubic
    preprocess, the 576-row export and a decoder over L = 2 x 576 keys."""
    cfg = {"architecture": "ViT-L/14@336px", "decode_mode": "index", "decode_indices": [0, 1],
           "out_dim": [2], "losses": ["auc_roc"], "op_mode": {"temporal_position": 1}}
    jcfg, tcfg = JDetector.get_default_config(), Detector.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    jdet = JDetector(jcfg, num_frames=2, compute_dtype=jnp.float32)
    tdet = Detector(tcfg, num_frames=2, compute_dtype=torch.float32, device="cpu")
    for det, vit in ((jdet, NARROW), (tdet, port_cfg(NARROW))):
        assert det.transform.size == 336
        det.vit_cfg = vit
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=vit.width, heads=vit.heads)
    return jdet, tdet


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_detector_predict_336_matches_jax(monkeypatch, reference):
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    monkeypatch.setenv("DFD_DEC_STACK", "force" if reference == "pallas" else "0")
    jdet, tdet = narrow_detectors(monkeypatch)
    jparams = jdet.init_params(jax.random.key(15))
    tparams = tdet.prepare_params(params_from_jax(to_np(jparams)))
    x = np.random.default_rng(16).integers(0, 256, (2, 2, 3, 224, 240), dtype=np.uint8)
    m = np.array([[True, True], [True, False]])
    kv = tdet.encode_kv(tparams, tdet.preprocess(torch.from_numpy(x)), pad_tokens=True)
    assert tuple(kv["k"].shape) == (2, 2, 2, 576, 2, 64)
    want, _ = jdet.predict(jparams, jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    close(got[0], want[0], "f32")


def test_vit_l14_336_detector_geometry():
    """ViT-L/14@336px: 577 tokens (24 x 24 patches of 14 plus CLS), a
    576-row export with no pad rows, kept layers (0, 4, ..., 20), a 16-head
    width-1024 decoder over L = 20 x 576 = 11,520 keys, held to JAX's
    detector."""
    cfg = {"architecture": "ViT-L/14@336px", "decode_mode": "stride", "decode_stride": 4,
           "out_dim": [2], "losses": ["auc_roc"],
           "op_mode": {"temporal_position": 1, "compute_int8": 1}}
    tcfg, jcfg = Detector.get_default_config(), JDetector.get_default_config()
    tcfg.merge_from_other_cfg(cfg)
    jcfg.merge_from_other_cfg(cfg)
    det = Detector(tcfg, num_frames=20, device="cpu")
    jdet = JDetector(jcfg, num_frames=20)
    vit = det.vit_cfg
    assert (vit.num_tokens, vit.grid, vit.num_patches) == (577, 24, 576)
    assert (-vit.num_patches) % 8 == 0                     # pad_tokens adds no rows
    assert det.layer_indices == (0, 4, 8, 12, 16, 20) == tuple(jdet.layer_indices)
    assert (det.decoder_cfg.width, det.decoder_cfg.heads) == (1024, 16) and det.compute_int8
    assert det.decoder_cfg.num_frames * vit.num_patches == 11520
    assert det.transform.size == jdet.transform.size == 336
    for f in dataclasses.fields(det.decoder_cfg):
        if hasattr(jdet.decoder_cfg, f.name):
            assert getattr(det.decoder_cfg, f.name) == getattr(jdet.decoder_cfg, f.name), f.name
    for f in dataclasses.fields(vit):
        assert getattr(vit, f.name) == getattr(jdet.vit_cfg, f.name), f.name
