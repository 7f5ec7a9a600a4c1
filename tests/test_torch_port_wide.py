"""The port's 257-token towers on the CPU against the JAX package: both
encoder attentions (packed and separate q/k/v) against the Pallas kernels in
interpret mode, the int8 split pair (fused_encoder_attn_block and
fused_encoder_mlp_block with int8_gemm) in every form against their Pallas
kernels, clip_vision_kv on a width-1024, 16-head tower (the bf16 XLA
composition against JAX's XLA path, compute_int8 against its Pallas path),
dinov2_kv, and Detector.predict with foundation "dinov2".

Tolerances, with their reasons:
* f32: atol = rtol = 1e-4 (conftest sets the JAX matmul precision to
  "highest"; the softmax forms differ only in rounding: the Pallas kernels
  clamp the logits at 60 and normalise after PV, the port subtracts the row
  maximum);
* bf16: 1e-2 of the output's maximum, about two bf16 ulps (the two
  frameworks round elementwise bf16 chains at other points);
* int8 K/V: values within 1 on at most 1e-3 of the elements (a quantiser
  input on a rounding boundary may flip by one quantum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import dinov2_vit as jdino
from dfd_clip_tpu.models.detector import Detector as JDetector
from dfd_clip_tpu.ops import attention as jattn
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import dinov2_vit as tdino
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import attention as tattn
from dfd_clip_tpu_torch.ops import encoder_block as eb

TOL = dict(rtol=1e-4, atol=1e-4)
REL = 1e-2
# the width-1024, 16-head tower of tests/test_pallas_ops.py (ViT-L class)
WIDE = jvit.ViTConfig(input_resolution=32, patch_size=16, width=1024, layers=2, heads=16,
                      output_dim=32)
FRAMES, TOKENS = 2, WIDE.num_tokens


def close(got, want, dtype):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype") else want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


def int8_close(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_cfg(cfg):
    """The port's ViTConfig with the fields of a JAX one."""
    return tvit.ViTConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tvit.ViTConfig)})


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


# -- the two encoder attentions ------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("frames,tokens", [(3, 17), (1, 257), (2, 257)],
                         ids=["t17", "t257-n1", "t257-n2"])
@pytest.mark.parametrize("entry", ["packed", "separate"])
def test_encoder_attention_matches_pallas(monkeypatch, entry, frames, tokens, dtype):
    """head_dim 64, 2 heads, through the dispatchers on both sides."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    jdt, tdt = DTYPES[dtype]
    heads, d = 2, 64
    qkv = np.random.default_rng(tokens + frames).standard_normal(
        (frames, tokens, 3 * heads * d)).astype(np.float32)
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
    assert got.dtype == tdt
    close(got, want, dtype)


# -- the int8 split pair ---------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_block():
    """Layer 0 of the seeded width-1024 tower with LayerNorms and biases
    moved off their init values, and a residual stream (2 frames x 5
    tokens)."""
    rng = np.random.default_rng(21)
    bp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                to_np(jvit.init_clip_vision(jax.random.key(5), WIDE)["blocks"]))
    w = WIDE.width
    for ln in (bp["ln_1"], bp["ln_2"]):
        ln["scale"] = (1 + 0.3 * rng.standard_normal(w)).astype(np.float32)
        ln["bias"] = (0.1 * rng.standard_normal(w)).astype(np.float32)
    for lin in (bp["attn"]["in_proj"], bp["attn"]["out_proj"], bp["mlp"]["c_fc"],
                bp["mlp"]["c_proj"]):
        lin["b"] = (0.05 * rng.standard_normal(lin["b"].shape)).astype(np.float32)
    bp["h"] = rng.standard_normal((FRAMES, TOKENS, w)).astype(np.float32)
    return bp


SPLIT_FORMS = {  # name: (export, stacked, kv_pad, kv_rows8, last_only)
    "plain": (False, False, 0, False, False),
    "export": (True, False, 0, False, False),
    "stacked_pad": (True, True, 4, False, False),
    "stacked_pad_rows8": (True, True, 4, True, False),
    "last_only": (False, True, 4, False, True),
    "last_only_rows8": (False, True, 4, True, True),
}


def _stacks(rows8, kv_pad, jax_side, dt):
    shape = (3, FRAMES, TOKENS - 1 + kv_pad, WIDE.width)
    if jax_side:
        kdt = jnp.int8 if rows8 else dt
        return (jnp.zeros(shape, kdt), jnp.zeros(shape, kdt), 1, 3)
    kdt = torch.int8 if rows8 else dt
    return (torch.full(shape, 7, dtype=kdt), torch.full(shape, 7, dtype=kdt), 1, 3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", list(SPLIT_FORMS))
def test_int8_attn_block_matches_pallas(wide_block, form, dtype):
    export, stacked, kv_pad, rows8, last_only = SPLIT_FORMS[form]
    jdt, tdt = DTYPES[dtype]
    bp = wide_block
    jp, tp = jax.tree_util.tree_map(jnp.asarray, bp), params_from_jax(bp)
    kw = dict(export=export, drop_cls=True, kv_pad=kv_pad, kv_rows8=rows8, last_only=last_only,
              int8_gemm=True)
    want = jpa.fused_encoder_attn_block(
        jnp.asarray(bp["h"], jdt), jp["ln_1"], jp["attn"], WIDE.heads, WIDE.head_dim,
        export_into=_stacks(rows8, kv_pad, True, jdt) if stacked else None, **kw)
    into = _stacks(rows8, kv_pad, False, tdt) if stacked else None
    got = eb.fused_encoder_attn_block(tp["h"].to(tdt), tp["ln_1"], tp["attn"], WIDE.heads,
                                      WIDE.head_dim, export_into=into, **kw)
    if not (export or last_only):
        assert got.dtype == tdt
        close(got, want, dtype)
        return
    assert len(got) == len(want)
    kv_at = (0, 1) if last_only else (1, 2)
    for i, (g, w_) in enumerate(zip(got, want)):
        if i in kv_at:
            g, w_ = (g[1], w_[1]) if stacked else (g, w_)
            if rows8:
                int8_close(g.numpy(), w_)
                continue
        close(g, w_, dtype)
    if stacked:   # the other slots are untouched, the pad rows zero
        assert (into[0][0] == 7).all() and (into[0][2] == 7).all()
        assert (into[0][1, :, TOKENS - 1:] == 0).all() and (into[1][1, :, TOKENS - 1:] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_mlp_block_matches_pallas(wide_block, dtype):
    """LN2 quantised per row in f32, W8A8 c_fc, QuickGELU in f32, W8A8
    c_proj, its output rounded to h's dtype before h is added."""
    jdt, tdt = DTYPES[dtype]
    bp = wide_block
    jp, tp = jax.tree_util.tree_map(jnp.asarray, bp), params_from_jax(bp)
    want = jpa.fused_encoder_mlp_block(jnp.asarray(bp["h"], jdt), jp["ln_2"], jp["mlp"],
                                       int8_gemm=True)
    got = eb.fused_encoder_mlp_block(tp["h"].to(tdt), tp["ln_2"], tp["mlp"], int8_gemm=True)
    assert got.dtype == tdt
    close(got, want, dtype)


# -- the towers -----------------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [("bf16_composition", "f32"), ("bf16_composition", "bf16"),
                                        ("compute_int8", "f32"), ("compute_int8_rows8", "f32")])
def test_clip_vision_kv_wide_matches_jax(rng, monkeypatch, mode, dtype):
    """keep (0, 1), drop_cls, pad_tokens (4 patches -> 8 rows). Without
    compute_int8 the width-1024 tower runs the XLA composition on both sides
    (JAX's XLA path); with it, the int8 split pair (JAX's Pallas path). The
    int8 tower is held in f32: in bf16 the encoder softmax's rounding point
    (ROADMAP queue 3) moves the next layer's LayerNorm inputs by an ulp,
    which flips int8 quanta of 1/127 of a row's maximum (observed 1.4e-2 of
    the maximum at layer 1; the blocks alone hold 1e-2 in bf16 above)."""
    int8 = mode != "bf16_composition"
    rows8 = mode == "compute_int8_rows8"
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas" if int8 else "xla")
    jdt, tdt = DTYPES[dtype]
    params = to_np(jvit.init_clip_vision(jax.random.key(7), WIDE))
    x = rng.standard_normal((FRAMES, 3, 32, 32)).astype(np.float32)
    kw = dict(keep_layers=(0, 1), drop_cls=True, pad_tokens=True, compute_int8=int8,
              kv_int8_rows=rows8)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jvit.clip_vision_kv(jvit.prepare_int8_params(jparams) if int8 else jparams,
                               jnp.asarray(x), WIDE, compute_dtype=jdt, **kw)
    tparams = params_from_jax(params)
    got = tvit.clip_vision_kv(tvit.prepare_int8_params(tparams) if int8 else tparams,
                              torch.from_numpy(x), port_cfg(WIDE), compute_dtype=tdt, **kw)
    assert sorted(got) == sorted(want)
    for s in got:
        if rows8 and s in ("k", "v"):
            int8_close(got[s].numpy(), want[s])
        else:
            close(got[s], want[s], dtype)
    assert (got["k"][:, :, 4:] == 0).all()                  # pad rows


DINO_TOWERS = {"ViT-Test": "ViT-Test",
               "head_dim64": jvit.ViTConfig(input_resolution=28, patch_size=14, width=128,
                                            layers=3, heads=2, output_dim=32)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("tower", list(DINO_TOWERS))
def test_dinov2_kv_matches_jax(rng, monkeypatch, tower, reference, dtype):
    """keep (0, 1): the last kept layer runs LN1 + qkv only and the layers
    after it are skipped; drop_cls."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    jdt, tdt = DTYPES[dtype]
    cfg = DINO_TOWERS[tower]
    jcfg = jdino.ARCHITECTURES[cfg] if isinstance(cfg, str) else cfg
    tcfg = tdino.ARCHITECTURES[cfg] if isinstance(cfg, str) else port_cfg(cfg)
    params = to_np(jdino.init_dinov2(jax.random.key(9), jcfg))
    rs = np.random.default_rng(1)
    for bp_ls in ("ls1", "ls2"):   # LayerScale off its init of ones
        params["blocks"][bp_ls] = (1 + 0.5 * rs.standard_normal(
            params["blocks"][bp_ls].shape)).astype(np.float32)
    params["conv1"]["b"] = (0.1 * rs.standard_normal(jcfg.width)).astype(np.float32)
    x = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jdino.dinov2_kv(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg,
                           compute_dtype=jdt, keep_layers=(0, 1), drop_cls=True)
    got = tdino.dinov2_kv(params_from_jax(params), torch.from_numpy(x), tcfg, compute_dtype=tdt,
                          keep_layers=(0, 1), drop_cls=True)
    for s in ("k", "v"):
        assert got[s].dtype == tdt
        close(got[s], want[s], dtype)


def dinov2_detectors(op_mode=None):
    cfg = {"foundation": "dinov2", "architecture": "ViT-Test", "decode_mode": "index",
           "decode_indices": [0, 1], "out_dim": [2], "losses": ["auc_roc"],
           "op_mode": {"temporal_position": 1, **(op_mode or {})}}
    jcfg, tcfg = JDetector.get_default_config(), Detector.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    return (JDetector(jcfg, num_frames=4, compute_dtype=jnp.float32),
            Detector(tcfg, num_frames=4, compute_dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_detector_predict_dinov2_matches_jax(rng, monkeypatch, reference):
    """ImageNet normalisation, the unpadded 4-patch export, patch_valid 4."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    monkeypatch.setenv("DFD_DEC_STACK", "force" if reference == "pallas" else "0")
    jdet, tdet = dinov2_detectors()
    assert tdet.transform.mean == (0.485, 0.456, 0.406)
    jparams = jdet.init_params(jax.random.key(0))
    tparams = tdet.prepare_params(params_from_jax(to_np(jparams)))
    x = rng.integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    want, _ = jdet.predict(jparams, jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    close(got[0], want[0], "f32")


def test_dinov2_detector_ignores_int8_modes(rng):
    """compute_int8 and kv_dtype leave a DINOv2 tower in its compute dtype,
    as in the JAX package: the same logits as without them."""
    _, plain = dinov2_detectors()
    jdet, int8 = dinov2_detectors({"compute_int8": 1, "kv_dtype": "int8_rows"})
    assert not int8.compute_int8 and not int8._kv_rows8()
    params = params_from_jax(to_np(jdet.init_params(jax.random.key(0))))
    x = rng.integers(0, 256, (2, 4, 3, 28, 28), dtype=np.uint8)
    m = np.ones((2, 4), bool)
    got = int8.predict(int8.prepare_params(params), x, m)[0][0]
    want = plain.predict(plain.prepare_params(params), x, m)[0][0]
    assert torch.equal(got, want)
    jwant = jdet.predict(jdet.prepare_params(jdet.init_params(jax.random.key(0))), jnp.asarray(x),
                         jnp.asarray(m))[0][0]
    close(got, jwant, "f32")


def test_vit_l14_detector_geometry():
    """ViT-L/14 at 224: 257 tokens, kept layers (0, 4, ..., 20), a 16-head
    width-1024 decoder; DINOv2 "ViT-B/16" maps to B/14 (257 tokens)."""
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-L/14", "decode_mode": "stride",
                              "decode_stride": 4, "out_dim": [2], "losses": ["auc_roc"],
                              "op_mode": {"temporal_position": 1, "compute_int8": 1}})
    det = Detector(cfg, num_frames=20, device="cpu")
    assert det.vit_cfg.num_tokens == 257 and det.layer_indices == (0, 4, 8, 12, 16, 20)
    assert (det.decoder_cfg.width, det.decoder_cfg.heads) == (1024, 16) and det.compute_int8
    dcfg = Detector.get_default_config()
    dcfg.merge_from_other_cfg({"foundation": "dinov2", "decode_mode": "index",
                               "decode_indices": list(range(6, 12)), "out_dim": [2]})
    ddet = Detector(dcfg, num_frames=20, device="cpu")
    assert ddet.vit_cfg is tdino.DINOV2_B14 and ddet.vit_cfg.num_tokens == 257
    assert ddet.transform.std == (0.229, 0.224, 0.225)
