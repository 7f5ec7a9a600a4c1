"""The port's int8 serving path (op_mode compute_int8, the W8A8 tower, and
kv_dtype "int8_rows", the per-row int8 K/V export) on the CPU against the
JAX package: the quantisers, the W8A8 product, the whole int8 block and the
int8 last_only layer against their Pallas kernels in interpret mode, the
int8 K/V decoder attention, clip_vision_kv and Detector.predict.

Tolerances, with their reasons:
* the weight quantisation and _quant_kv_rows: exactly equal (same formula,
  one IEEE operation per step in both frameworks);
* _quant_rows: scales exactly equal, int8 values within 1 on at most 1e-5 of
  the elements (the quotient 127 / s may round apart);
* the W8A8 dot and linear_w8a8: 1e-6 relative (exact integer sums on both
  sides, then the same f32 dequant);
* a whole int8 block or tower: 1e-2 of the output's maximum. A value on a
  rounding boundary of a quantiser can flip by one quantum, which moves that
  operand by 1/127 = 7.9e-3 of its row maximum;
* int8 K/V exported by a whole tower: within 1 on at most 1e-3 of the
  elements; logits within 1e-2 absolute (they are L2-normalised to norm 5);
* the int8 K/V decoder attention: the JAX VJP suite's rtol 2e-4, atol 2e-5
  against the XLA composition with f32 queries (it dequantises in the query
  dtype, f32, as the port does); 1e-2 of the maximum against the Pallas
  kernel, which rounds the dequantised K, the scale, k + pos and the PV
  weights to bf16;
* bf16 activations: 1e-2 of the maximum, about two bf16 ulps (the encoder
  softmax rounds at other points, see test_torch_port_bf16.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import layers as jl
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu.ops.decoder_attention import dual_activation_attention as jdual
from dfd_clip_tpu.ops.pallas_decoder_attention import fused_decoder_attention as jfused_dec
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import layers as tl
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import encoder_block as eb
from dfd_clip_tpu_torch.ops import int8 as ti
from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention

REL = 1e-2
W, HEADS, D, TOKENS, FRAMES = 64, 4, 16, 5, 4


def rel_err(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def int8_flips(got, want):
    """(largest |difference|, share of elements that differ) of int8 arrays."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d > 0).mean()


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(11)

    def lin(i, o):
        return {"w": (i ** -0.5 * rng.standard_normal((i, o))).astype(np.float32),
                "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.3 * rng.standard_normal(W)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(W)).astype(np.float32)}

    return {"h": rng.standard_normal((FRAMES, TOKENS, W)).astype(np.float32),
            "ln1": ln(), "ln2": ln(),
            "attn": {"in_proj": lin(W, 3 * W), "out_proj": lin(W, W)},
            "mlp": {"c_fc": lin(W, 4 * W), "c_proj": lin(4 * W, W)}}


# -- the quantisers and the W8A8 product ---------------------------------------------

@pytest.mark.parametrize("source", ["tower", "draw_768x2304"])
def test_prepare_int8_params_matches_jax(source):
    """int8 weights and scales exactly equal; the port stores wq as (N, K)."""
    if source == "tower":
        cfg = jvit.ARCHITECTURES["ViT-Test"]
        params = jax.tree_util.tree_map(np.asarray,
                                        jvit.init_clip_vision(jax.random.key(3), cfg))
        want = jvit.prepare_int8_params(jx(params))["blocks"]
        got = tvit.prepare_int8_params(params_from_jax(params))["blocks"]
        for path in (("attn", "in_proj"), ("attn", "out_proj"), ("mlp", "c_fc"),
                     ("mlp", "c_proj")):
            for layer, bp in enumerate(got):
                gp, wp = bp[path[0]][path[1]], want[path[0]][path[1]]
                assert gp["wq"].dtype == torch.int8
                np.testing.assert_array_equal(gp["wq"].t().numpy(), np.asarray(wp["wq"][layer]))
                np.testing.assert_array_equal(gp["ws"].numpy(), np.asarray(wp["ws"][layer]))
        return
    w = (0.03 * np.random.default_rng(1).standard_normal((768, 2304))).astype(np.float32)
    jq, js = jpa.quantize_weight(jnp.asarray(w))
    tq, ts = ti.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.t().numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_kv_rows_matches_jax():
    """bf16 rows (the export's K/V columns): int8 values and scales equal."""
    rows = jnp.asarray(3 * np.random.default_rng(2).standard_normal((4000, 768)), jnp.bfloat16)
    jq, js = jpa._quant_kv_rows(rows)
    tq, ts = ti.quant_kv_rows_plain(torch.from_numpy(np.array(rows.astype(jnp.float32)))
                                    .bfloat16())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_rows_matches_jax():
    y = (3 * np.random.default_rng(3).standard_normal((4000, 768))).astype(np.float32)
    jq, js = jpa._quant_rows(jnp.asarray(y))
    tq, ts = ti.quant_rows_plain(torch.from_numpy(y))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    worst, share = int8_flips(tq.numpy(), jq)
    assert worst <= 1 and share <= 1e-5, (worst, share)


@pytest.mark.parametrize("width", [3072, 4096])
def test_quant_rows_matches_jax_wide(width):
    """_quant_rows at the MLP intermediate's widths (ViT-B/16 and ViT-L/14):
    scales equal, int8 values within 1 on at most 1e-5 of the elements."""
    y = (3 * np.random.default_rng(width).standard_normal((600, width))).astype(np.float32)
    jq, js = jpa._quant_rows(jnp.asarray(y))
    tq, ts = ti.quant_rows_plain(torch.from_numpy(y))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    worst, share = int8_flips(tq.numpy(), jq)
    assert worst <= 1 and share <= 1e-5, (worst, share)


def test_export_kv_rows8_matches_jax_with_pad_rows():
    """The int8_rows K/V export (export_kv_rows8's plain route: 5 frames of 9
    tokens, CLS dropped, 3 pad rows) against _quant_kv_rows of each frame's
    kept rows, the pad rows and pad scales zero as _write_kv_export writes
    them: values and scales equal."""
    frames, tokens, w, pad = 5, 9, 256, 3
    x = jnp.asarray(3 * np.random.default_rng(4).standard_normal((frames * tokens, 3 * w)),
                    jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    kq, vq, ks, vs = ti.export_kv_rows8(xt[:, w: 2 * w], xt[:, 2 * w:], frames, tokens, 1, pad)
    for got_q, got_s, cols in ((kq, ks, slice(w, 2 * w)), (vq, vs, slice(2 * w, 3 * w))):
        rows = x[:, cols].reshape(frames, tokens, w)[:, 1:]
        jq, js = jpa._quant_kv_rows(rows)
        np.testing.assert_array_equal(got_q[:, : tokens - 1].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(got_s[:, : tokens - 1].numpy(), np.asarray(js))
        assert got_q.shape == (frames, tokens - 1 + pad, w)
        assert not got_q[:, tokens - 1:].any() and not got_s[:, tokens - 1:].any()


@pytest.mark.parametrize("k", [768, 3072])
def test_w8a8_dot_matches_jax(k):
    """K = 3072 sums past 2^24, where an f32 accumulate would not be exact."""
    rng = np.random.default_rng(k)
    y = rng.standard_normal((300, k)).astype(np.float32)
    w = (k ** -0.5 * rng.standard_normal((k, 256))).astype(np.float32)
    yq, ys = jpa._quant_rows(jnp.asarray(y))
    wq, ws = jpa.quantize_weight(jnp.asarray(w))
    want = jpa._w8a8_dot(yq, ys, wq, ws)
    got = ti.w8a8_dot_plain(*(torch.from_numpy(np.array(a)) for a in (yq, ys)),
                            torch.from_numpy(np.array(wq)).t(), torch.from_numpy(np.array(ws)))
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("prequantised", [False, True])
def test_linear_w8a8_matches_jax(prequantised):
    rng = np.random.default_rng(4)
    p = {"w": (0.05 * rng.standard_normal((W, 3 * W))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(3 * W)).astype(np.float32)}
    x = rng.standard_normal((2, 7, W)).astype(np.float32)
    pj, pt = jx(p), th(p)
    if prequantised:
        wq, ws = jpa.quantize_weight(pj["w"])
        pj = {**pj, "wq": wq, "ws": ws}
        pt = {**pt, "wq": torch.from_numpy(np.array(wq)).t().contiguous(),
              "ws": torch.from_numpy(np.array(ws))}
    want = jl.linear_w8a8(pj, jnp.asarray(x))
    got = tl.linear_w8a8(pt, torch.from_numpy(x))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


# -- the whole int8 block and the int8 last_only layer --------------------------------

BLOCK_CASES = {  # name: (export, stacked, kv_pad, kv_rows8)
    "no_export": (False, False, 0, False),
    "export": (True, False, 0, False),
    "stacked_pad": (True, True, 4, False),
    "rows8": (True, False, 0, True),
    "stacked_pad_rows8": (True, True, 4, True),
}


def _stacks(kv_rows8, kv_pad, jax_side):
    t_out = TOKENS - 1 + kv_pad
    if jax_side:
        dt = jnp.int8 if kv_rows8 else jnp.float32
        return (jnp.zeros((3, FRAMES, t_out, W), dt), jnp.zeros((3, FRAMES, t_out, W), dt), 1, 3)
    dt = torch.int8 if kv_rows8 else torch.float32
    return (torch.full((3, FRAMES, t_out, W), 7, dtype=dt),
            torch.full((3, FRAMES, t_out, W), 7, dtype=dt), 1, 3)


def _compare_outputs(got, want, kv_rows8, stacked, tol):
    assert len(got) == len(want)
    for i, (g, w_) in enumerate(zip(got, want)):
        g = g[1] if stacked and i in (1, 2) else g
        w_ = np.asarray(w_[1] if stacked and i in (1, 2) else w_)
        assert tuple(g.shape) == w_.shape, (i, tuple(g.shape), w_.shape)
        if kv_rows8 and i in (1, 2):
            assert g.dtype == torch.int8
            worst, share = int8_flips(g.numpy(), w_)
            assert worst <= 1 and share <= 1e-3, (i, worst, share)
        else:
            assert rel_err(g, w_.astype(np.float32)) <= tol, i


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_encoder_block_int8_matches_pallas(block, case):
    """fused_encoder_block_plain vs the Pallas kernel interpreted, in f32
    (observed: within 2.2e-7 of the maximum, the int8 K/V equal)."""
    export, stacked, kv_pad, rows8 = BLOCK_CASES[case]
    j, t = jx(block), th(block)
    kw = dict(export=export, drop_cls=True, kv_pad=kv_pad, kv_rows8=rows8)
    want = jpa.fused_encoder_block(j["h"], j["ln1"], j["attn"], j["ln2"], j["mlp"], HEADS, D,
                                   int8_gemm=True,
                                   export_into=_stacks(rows8, kv_pad, True) if stacked else None,
                                   **kw)
    into = _stacks(rows8, kv_pad, False) if stacked else None
    got = eb.fused_encoder_block(t["h"], t["ln1"], t["attn"], t["ln2"], t["mlp"], HEADS, D,
                                 export_into=into, **kw)
    if not export:
        assert rel_err(got, want) <= REL
        return
    _compare_outputs(got, want, rows8, stacked, REL)
    if stacked:   # the other slots are untouched, the pad rows and pad scales zero
        assert (into[0][0] == 7).all() and (into[0][2] == 7).all()
        assert (into[0][1, :, TOKENS - 1:] == 0).all() and (into[1][1, :, TOKENS - 1:] == 0).all()
        if rows8:
            assert (got[3][:, TOKENS - 1:] == 0).all() and (got[4][:, TOKENS - 1:] == 0).all()


@pytest.mark.parametrize("rows8", [False, True], ids=["bf16_export", "rows8"])
def test_int8_last_only_matches_pallas(block, rows8):
    j, t = jx(block), th(block)
    want = jpa.fused_encoder_attn_block(j["h"], j["ln1"], j["attn"], HEADS, D, drop_cls=True,
                                        last_only=True, int8_gemm=True, kv_rows8=rows8,
                                        kv_pad=4, export_into=_stacks(rows8, 4, True))
    into = _stacks(rows8, 4, False)
    got = eb.fused_encoder_attn_block(t["h"], t["ln1"], t["attn"], HEADS, D, drop_cls=True,
                                      last_only=True, int8_gemm=True, kv_rows8=rows8,
                                      kv_pad=4, export_into=into)
    assert len(got) == len(want) == (4 if rows8 else 2)
    for i, (g, w_) in enumerate(zip(got, want)):
        g = g[1] if i < 2 else g
        w_ = np.asarray(w_[1] if i < 2 else w_)
        assert tuple(g.shape) == w_.shape
        if rows8 and i < 2:
            worst, share = int8_flips(g.numpy(), w_)
            assert worst <= 1 and share <= 1e-3, (i, worst, share)
        else:
            assert rel_err(g, w_.astype(np.float32)) <= REL, i


def test_fused_encoder_block_int8_bf16_close_to_pallas(block):
    """bf16 activations: within 1e-2 of the maximum (observed 6.8e-3)."""
    j, t = jx(block), th(block)
    want = jpa.fused_encoder_block(jnp.asarray(block["h"], jnp.bfloat16), j["ln1"], j["attn"],
                                   j["ln2"], j["mlp"], HEADS, D, export=True, drop_cls=True,
                                   int8_gemm=True)
    got = eb.fused_encoder_block(t["h"].bfloat16(), t["ln1"], t["attn"], t["ln2"], t["mlp"],
                                 HEADS, D, export=True, drop_cls=True)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel_err(g, np.asarray(w_.astype(jnp.float32))) <= REL


def test_int8_split_forms_raise(block):
    """The int8 split pair is ported (tests/test_torch_port_wide.py holds it
    against its Pallas kernels): on the CPU both halves run their plain
    versions. So does the bf16 whole-block form (ported since;
    tests/test_torch_port_variants.py holds it), and an unknown int8
    attention mode raises."""
    t = th(block)
    got = eb.fused_encoder_attn_block(t["h"], t["ln1"], t["attn"], HEADS, D, int8_gemm=True)
    assert torch.equal(got, eb.fused_encoder_attn_block_plain(t["h"], t["ln1"], t["attn"], HEADS,
                                                              D, int8_gemm=True))
    got = eb.fused_encoder_mlp_block(t["h"], t["ln2"], t["mlp"], int8_gemm=True)
    assert torch.equal(got, eb.fused_encoder_mlp_block_plain(t["h"], t["ln2"], t["mlp"],
                                                             int8_gemm=True))
    args = (t["h"], t["ln1"], t["attn"], t["ln2"], t["mlp"], HEADS, D)
    assert torch.equal(eb.fused_encoder_block(*args, int8_gemm=False),
                       eb.fused_encoder_block_plain(*args, int8_gemm=False))
    with pytest.raises(ValueError):
        eb.fused_encoder_block(*args, int8_attn="int8")


# -- the int8 K/V decoder attention ---------------------------------------------------

@pytest.fixture(scope="module")
def int8_kv():
    rng = np.random.default_rng(5)
    b, l, h, d = 3, 3 * 200, 4, 64
    kv = {s: (rng.standard_normal((2, b, l, h, d))).astype(np.float32) for s in ("k", "v")}
    q = {s: rng.standard_normal((b, 1, h, d)).astype(np.float32) for s in ("qs", "qc")}
    out = dict(q)
    for s in ("k", "v"):
        rows = jnp.asarray(kv[s].reshape(2, b, l, h * d), jnp.bfloat16)
        qv, sc = jpa._quant_kv_rows(rows)
        out[s] = np.asarray(qv).reshape(2, b, l, h, d)
        out[s + "_scale"] = np.asarray(sc)                     # (2, B, L, 1)
    out["pos"] = (0.1 * rng.standard_normal((l, h, d))).astype(np.float32)
    mask = np.ones((b, l), bool)
    mask[1, 400:] = False
    mask[2] = False
    out["mask"] = mask
    return out


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_int8_kv_decoder_attention_matches_jax(int8_kv, reference):
    a = int8_kv
    if reference == "xla":
        want = jdual(*(jnp.asarray(a[s]) for s in ("qs", "qc", "k", "v", "mask")),
                     num_frames=3, temporal_pos=jnp.asarray(a["pos"]), layer=1,
                     k_scale=jnp.asarray(a["k_scale"]), v_scale=jnp.asarray(a["v_scale"]))
        qdt = torch.float32
    else:
        want = jfused_dec(*(jnp.asarray(a[s], jnp.bfloat16) for s in ("qs", "qc")),
                          *(jnp.asarray(a[s]) for s in ("k", "v", "mask")),
                          temporal_pos=jnp.asarray(a["pos"], jnp.bfloat16), layer=1,
                          k_scale=jnp.asarray(a["k_scale"]), v_scale=jnp.asarray(a["v_scale"]))
        qdt = torch.bfloat16
    got = fused_decoder_attention(
        *(torch.from_numpy(a[s]).to(qdt) for s in ("qs", "qc")),
        *(torch.from_numpy(a[s]) for s in ("k", "v", "mask")),
        torch.from_numpy(a["pos"]).to(qdt), layer=1,
        k_scale=torch.from_numpy(a["k_scale"]), v_scale=torch.from_numpy(a["v_scale"]))
    assert got.dtype == qdt
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.asarray(got[2].float()) == 0)          # fully masked sample
    if reference == "xla":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    else:
        assert rel_err(got, want) <= REL
    # the partials form on int8_rows K/V (the token-sharded attention's
    # input), normalised by the merge, gives the same output
    from dfd_clip_tpu_torch.ops.decoder_attention import merge_decoder_partials_plain

    parts = fused_decoder_attention(
        *(torch.from_numpy(a[s]).to(qdt) for s in ("qs", "qc")),
        *(torch.from_numpy(a[s]) for s in ("k", "v", "mask")),
        torch.from_numpy(a["pos"]).to(qdt), layer=1, partials=True,
        k_scale=torch.from_numpy(a["k_scale"]), v_scale=torch.from_numpy(a["v_scale"]))
    normalised = merge_decoder_partials_plain([parts], normalise=True)
    assert np.all(normalised[2].numpy() == 0)
    if reference == "xla":
        np.testing.assert_allclose(normalised.numpy(), want, rtol=2e-4, atol=2e-5)
    else:
        assert rel_err(normalised, want) <= REL


# -- the tower and the detector ---------------------------------------------------------

@pytest.mark.parametrize("int8,rows8", [(True, False), (True, True), (False, True)],
                         ids=["compute_int8", "compute_int8+rows8", "rows8"])
def test_clip_vision_kv_int8_matches_jax(rng, monkeypatch, int8, rows8):
    """keep (0, 2): layer 0 a whole block (or the split pair without
    compute_int8) with export, layer 1 without, layer 2 last_only; drop_cls,
    pad_tokens."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    cfg = jvit.ARCHITECTURES["ViT-Test"]
    params = jax.tree_util.tree_map(np.asarray, jvit.init_clip_vision(jax.random.key(3), cfg))
    x = rng.standard_normal((FRAMES, 3, cfg.input_resolution, cfg.input_resolution)) \
        .astype(np.float32)
    kw = dict(keep_layers=(0, 2), drop_cls=True, pad_tokens=True, compute_int8=int8,
              kv_int8_rows=rows8)
    want = jvit.clip_vision_kv(jvit.prepare_int8_params(jx(params)), jnp.asarray(x), cfg,
                               compute_dtype=jnp.float32, **kw)
    got = tvit.clip_vision_kv(tvit.prepare_int8_params(params_from_jax(params)),
                              torch.from_numpy(x), tvit.ARCHITECTURES["ViT-Test"],
                              compute_dtype=torch.float32, **kw)
    assert sorted(got) == sorted(want)
    for s in got:
        w_ = np.asarray(want[s])
        assert tuple(got[s].shape) == w_.shape, s
        if rows8 and s in ("k", "v"):
            worst, share = int8_flips(got[s].numpy(), w_)
            assert worst <= 1 and share <= 1e-3, (s, worst, share)
        else:
            assert rel_err(got[s], w_) <= REL, s
    assert (got["k"][:, :, 4:] == 0).all()                  # pad rows
    if rows8:
        assert (got["k_scale"][:, :, 4:] == 0).all()


def tiny_int8_port_detector(op_mode):
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"], "op_mode": op_mode})
    det = Detector(cfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    det.vit_cfg = tiny
    det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
    det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width, heads=tiny.heads)
    return det


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8_rows"])
def test_detector_predict_int8_matches_jax(rng, monkeypatch, kv_dtype):
    """The whole slice on the tiny_detector weights, Pallas kernels
    interpreted on the JAX side (DFD_ATTENTION_BACKEND=pallas picks the
    whole block for compute_int8; DFD_DEC_STACK=force the boundary chain)."""
    from fixtures import tiny_detector

    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    monkeypatch.setenv("DFD_DEC_STACK", "force")
    op_mode = {"temporal_position": 1, "compute_int8": 1, "kv_dtype": kv_dtype}
    jdet = tiny_detector(num_frames=4, op_mode=op_mode)
    jparams = jdet.init_params(jax.random.key(0))
    tdet = tiny_int8_port_detector(op_mode)
    tparams = tdet.prepare_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    enc = tparams["encoder"]["blocks"][1]["mlp"]["c_fc"]
    assert enc["wq"].dtype == torch.int8 and enc["ws"].dtype == torch.float32
    x = rng.integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    want, _ = jdet.predict(jdet.prepare_params(jparams), jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    assert np.abs(got[0].float().numpy() - np.asarray(want[0])).max() <= REL
