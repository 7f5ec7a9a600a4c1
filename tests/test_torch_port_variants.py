"""The encoder's alternative kernel paths of the port on the CPU against the
JAX package: the int8 encoder attention against ``_attn_int8_cols`` called
directly, the bf16 whole block (DFD_FUSED_BLOCK=full) and the int8 whole
block with int8 attention (DFD_INT8_ATTN) against their Pallas kernels in
interpret mode, the whole-encoder tower against JAX's (DFD_MEGAKERNEL=1,
interpreted), clip_vision_kv's ``block`` / ``tower`` / ``int8_attn`` gate
against JAX with the matching environment, and Detector.predict with the
tower. Inputs come from numpy with fixed seeds.

Tolerances, with their reasons:
* f32, int8 attention: ``TOL_F32`` (1e-4) of the output's maximum, with a
  quantisation-tie allowance. The port subtracts the row maximum before the
  exp, the TPU kernel does not (ROADMAP queue 3), so P differs by f32
  rounding; a P value within that rounding of a half-integer step of
  _quant_rows can round to the neighbouring int8 value, which moves the
  outputs of that row by up to one quantum, 1/127 of the row's largest P
  times |V|. Such rows are counted: at most ``TIE_SHARE`` of the rows may
  exceed TOL_F32, and none may exceed ``TOL_TIE`` (2e-2). In whole blocks
  and towers a tie flip in the attention feeds the next _quant_rows, so
  their f32 holds use the same allowance over output rows.
* f32, everything else: TOL_F32 of the maximum (sums in another order).
* bf16: ``TOL_BF16`` (1e-2) of the maximum, about two bf16 ulps. The two
  softmaxes round their probabilities to bf16 at other scales (the port's
  are exp(l - max), the TPU's exp(l)) in the bf16 attention and in the
  "qk" mode's PV.
* The tower pads tokens to a multiple of 8 on the TPU; with int8 attention
  "1" its per-channel V scale also takes the pad rows, whose V is LN(0)'s
  projection, ln_1's shift through W_v plus b_v. The tower tests keep those
  two at zero so the pad rows are zero and JAX's scale is the unpadded one
  the port computes (ROADMAP queue 3 records the difference). With them
  nonzero the port's tower is held to JAX's per-layer int8 blocks, which
  do not pad (test_int8_attention_tower_matches_jax_per_layer_blocks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu.ops import pallas_tower as jpt
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models.detector import Detector, EncoderKernels
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import attention as tatt
from dfd_clip_tpu_torch.ops import encoder_block as eb
from dfd_clip_tpu_torch.ops import tower as ttower

TOL_F32, TOL_TIE, TIE_SHARE, TOL_BF16 = 1e-4, 2e-2, 0.1, 1e-2
FRAMES = 4


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def assert_close_ties(got, want):
    """TOL_F32 of the maximum on all but TIE_SHARE of the rows (last axis),
    TOL_TIE on every row (the int8 tie allowance of the module note)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    rows = (np.abs(got - want) / scale).reshape(-1, got.shape[-1]).max(-1)
    assert rows.max() <= TOL_TIE, rows.max()
    assert (rows > TOL_F32).mean() <= TIE_SHARE, ((rows > TOL_F32).mean(), rows.max())


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def block_params(rng, w, pad_safe=False):
    """One block's f32 params with LayerNorms and biases off their init
    values; ``pad_safe`` keeps ln_1's shift and the V bias at zero (module
    note)."""
    def lin(i, o):
        return {"w": (i ** -0.5 * rng.standard_normal((i, o))).astype(np.float32),
                "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.3 * rng.standard_normal(w)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(w)).astype(np.float32)}

    p = {"ln_1": ln(), "ln_2": ln(),
         "attn": {"in_proj": lin(w, 3 * w), "out_proj": lin(w, w)},
         "mlp": {"c_fc": lin(w, 4 * w), "c_proj": lin(4 * w, w)}}
    if pad_safe:
        p["ln_1"]["bias"][:] = 0
        p["attn"]["in_proj"]["b"][2 * w:] = 0
    return p


# -- the int8 encoder attention -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["1", "qk"])
@pytest.mark.parametrize("tokens", [17, 197, 257])
def test_attn_int8_cols_plain_matches_jax(tokens, mode, dtype):
    """attn_int8_cols_plain against _attn_int8_cols (a plain jnp function)
    on the same arrays, 3 frames of 17, 197 (ViT-B/16) and 257 (ViT-L/14)
    tokens, 4 heads of 64."""
    frames, heads, d = 3, 4, 64
    w = heads * d
    x = np.random.default_rng(21).standard_normal((frames, tokens, 3 * w)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    want = np.stack([np.concatenate([np.asarray(c) for c in jpa._attn_int8_cols(
        xj[f], heads, d, d ** -0.5, qk_only=mode == "qk")], -1) for f in range(frames)])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = tatt.attn_int8_cols_plain(xt.reshape(frames * tokens, 3 * w), frames, tokens, heads,
                                    d, qk_only=mode == "qk").reshape(frames, tokens, w)
    assert got.dtype == torch.float32
    if dtype == "bf16" and mode == "qk":
        assert rel_err(got, want) <= TOL_BF16
    else:
        assert_close_ties(got, want)


@pytest.mark.parametrize("consumers", [2, 3])
def test_s8_attention_geometry(consumers):
    """The int8 attention's schedule (_cuda.s8_attention_geometry, the
    mirror of csrc/attention_s8_hopper.cuh's): at 1 to 2049 tokens the
    launch's shared memory fits a block (232,448 bytes) and is the same at
    every token count; an item's key blocks stay resident up to 640 tokens
    (one load a block, a slot a query tile) and are walked twice by each
    group of ``consumers`` tiles above (two loads a block a group)."""
    smem = set()
    for tokens in range(1, 2050):
        g = _cuda.s8_attention_geometry(tokens, consumers)
        blocks = -(-tokens // 64)
        assert g["key_blocks"] == blocks
        smem.add(g["smem"])
        if tokens <= 640:
            assert g["resident"] and g["loads"] == blocks and g["slots"] == blocks
        else:
            groups = -(-blocks // consumers)
            assert not g["resident"]
            assert g["loads"] == 2 * groups * blocks and g["slots"] == groups * consumers
    assert len(smem) == 1 and smem.pop() <= _cuda.SMEM_LIMIT
    # the ring's 160 KB, 2 x 8 KB Q buffers a consumer, 5 KB of scales, the
    # 4 KB of partial maxima, the barriers and 1 KB of alignment
    assert _cuda.s8_attention_geometry(577, 3)["smem"] == 223648
    assert _cuda.s8_attention_geometry(577, _cuda.S8_CONSUMERS)["smem"] == 207232


def test_encoder_attention_int8_on_cpu_is_its_plain_version():
    """On a CPU tensor the wrapper takes its plain version and counts no
    launch."""
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((2 * 9, 3 * 128))
                         .astype(np.float32)).bfloat16()
    _cuda.reset_launches()
    for qk in (False, True):
        got = tatt.encoder_attention_int8(x, 2, 9, 2, 64, qk_only=qk)
        assert torch.equal(got, tatt.attn_int8_cols_plain(x, 2, 9, 2, 64, qk_only=qk))
    assert _cuda.launches() == {}


# -- the whole blocks ---------------------------------------------------------------

W, HEADS, D, TOKENS = 64, 4, 16, 5
BLOCK_CASES = {  # name: (export, stacked, kv_pad, kv_rows8)
    "no_export": (False, False, 0, False),
    "export": (True, False, 0, False),
    "stacked": (True, True, 0, False),
    "stacked_pad": (True, True, 4, False),
    "rows8": (True, False, 0, True),
}


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(23)
    p = block_params(rng, W)
    p["h"] = rng.standard_normal((FRAMES, TOKENS, W)).astype(np.float32)
    return p


def _stacks(kv_rows8, kv_pad, jax_side):
    t_out = TOKENS - 1 + kv_pad
    if jax_side:
        dt = jnp.int8 if kv_rows8 else jnp.float32
        return (jnp.zeros((3, FRAMES, t_out, W), dt), jnp.zeros((3, FRAMES, t_out, W), dt), 1, 3)
    dt = torch.int8 if kv_rows8 else torch.float32
    return (torch.full((3, FRAMES, t_out, W), 7, dtype=dt),
            torch.full((3, FRAMES, t_out, W), 7, dtype=dt), 1, 3)


def _block_pair(block, *, int8_gemm, case, int8_attn="0"):
    export, stacked, kv_pad, rows8 = BLOCK_CASES[case]
    j, t = jx(block), th(block)
    kw = dict(export=export, drop_cls=True, kv_pad=kv_pad, kv_rows8=rows8)
    want = jpa.fused_encoder_block(j["h"], j["ln_1"], j["attn"], j["ln_2"], j["mlp"], HEADS, D,
                                   int8_gemm=int8_gemm,
                                   export_into=_stacks(rows8, kv_pad, True) if stacked else None,
                                   **kw)
    into = _stacks(rows8, kv_pad, False) if stacked else None
    got = eb.fused_encoder_block(t["h"], t["ln_1"], t["attn"], t["ln_2"], t["mlp"], HEADS, D,
                                 export_into=into, int8_gemm=int8_gemm, int8_attn=int8_attn, **kw)
    if not export:
        return [got], [want], into
    got, want = list(got), list(want)
    if stacked:   # the written slot
        got[1:3], want[1:3] = [g[1] for g in got[1:3]], [w_[1] for w_ in want[1:3]]
    if rows8:     # dequantised K/V
        got[1:3] = [g.float() * s for g, s in zip(got[1:3], got[3:5])]
        want[1:3] = [np.asarray(w_, np.float32) * np.asarray(s) for w_, s in zip(want[1:3],
                                                                                want[3:5])]
    return got, want, into


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_encoder_block_bf16_form_matches_pallas(block, case):
    """The bf16 whole block (int8_gemm=False) against _make_full_block_kernel
    interpreted, in f32: h, K, V (and the int8_rows scales)."""
    got, want, into = _block_pair(block, int8_gemm=False, case=case)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert rel_err(g, w_) <= TOL_F32
    if into is not None:   # other slots untouched, the pad rows zero
        assert (into[0][0] == 7).all() and (into[0][2] == 7).all()
        assert (into[0][1, :, TOKENS - 1:] == 0).all()


def test_fused_encoder_block_bf16_activations_close_to_pallas(block):
    """bf16 activations: within TOL_BF16 of the maximum."""
    j, t = jx(block), th(block)
    kw = dict(export=True, drop_cls=True, int8_gemm=False)
    want = jpa.fused_encoder_block(jnp.asarray(block["h"], jnp.bfloat16), j["ln_1"], j["attn"],
                                   j["ln_2"], j["mlp"], HEADS, D, **kw)
    got = eb.fused_encoder_block(t["h"].bfloat16(), t["ln_1"], t["attn"], t["ln_2"], t["mlp"],
                                 HEADS, D, **kw)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel_err(g, w_) <= TOL_BF16


@pytest.mark.parametrize("case", ["no_export", "stacked_pad", "rows8"])
@pytest.mark.parametrize("mode", ["1", "qk"])
def test_fused_encoder_block_int8_attention_matches_pallas(block, monkeypatch, mode, case):
    """The int8 whole block with int8_attn against the phase-major Pallas
    kernel with DFD_INT8_ATTN, in f32 (tie allowance of the module note)."""
    monkeypatch.setenv("DFD_INT8_ATTN", mode)
    got, want, _ = _block_pair(block, int8_gemm=True, case=case, int8_attn=mode)
    for g, w_ in zip(got, want):
        assert_close_ties(g, w_)


def test_int8_attention_is_ignored_by_the_bf16_block(block):
    """As in the JAX kernel (int8_attn applies with int8_gemm only)."""
    t = th(block)
    args = (t["h"], t["ln_1"], t["attn"], t["ln_2"], t["mlp"], HEADS, D)
    assert torch.equal(eb.fused_encoder_block(*args, int8_gemm=False, int8_attn="1"),
                       eb.fused_encoder_block(*args, int8_gemm=False))
    with pytest.raises(ValueError):
        eb.fused_encoder_block(*args, int8_attn="2")


# -- the tower ----------------------------------------------------------------------

TOWER_CASES = {  # name: (int8_gemm, int8_attn, drop_cls)
    "bf16": (False, "0", True),
    "bf16_cls": (False, "0", False),
    "int8": (True, "0", True),
    "int8_cls": (True, "0", False),
    "int8_attn1": (True, "1", True),
    "int8_attn1_cls": (True, "1", False),
    "int8_qk": (True, "qk", True),
    "int8_qk_cls": (True, "qk", False),
}


@pytest.fixture(scope="module")
def tower_io():
    """A 3-layer ViT-Test-Wide-sized tower (width 256, 4 heads of 64), 4
    frames of 5 tokens, the per-layer blocks and their stacked JAX form."""
    rng = np.random.default_rng(24)
    blocks = [block_params(rng, 256, pad_safe=True) for _ in range(3)]
    h = rng.standard_normal((FRAMES, TOKENS, 256)).astype(np.float32)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                                     *blocks)
    return h, blocks, stacked


@pytest.mark.parametrize("case", list(TOWER_CASES))
def test_tower_plain_matches_jax_tower(tower_io, monkeypatch, case):
    """fused_encoder_tower_plain against pallas_tower.fused_encoder_tower
    interpreted, keep (1, 2), in f32."""
    int8, attn, drop_cls = TOWER_CASES[case]
    h, blocks, stacked = tower_io
    monkeypatch.setenv("DFD_INT8_ATTN", attn)
    want = jpt.fused_encoder_tower(jnp.asarray(h), stacked, 4, 64, keep=(1, 2),
                                   drop_cls=drop_cls, int8_gemm=int8)
    _cuda.reset_launches()
    got = ttower.fused_encoder_tower(torch.from_numpy(h), [th(b) for b in blocks], 4, 64,
                                     keep=(1, 2), drop_cls=drop_cls, int8_gemm=int8,
                                     int8_attn=attn)
    assert _cuda.launches() == {}   # a CPU tensor runs the plain version
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == (2, FRAMES, TOKENS - drop_cls, 256)
        assert_close_ties(g, w_)


def test_tower_needs_a_contiguous_keep(tower_io):
    h, blocks, _ = tower_io
    with pytest.raises(ValueError):
        ttower.fused_encoder_tower(torch.from_numpy(h), [th(b) for b in blocks], 4, 64,
                                   keep=(0, 2))


# the tower's chunk at the three geometries of the tower paths, 320 frames:
# (tokens, frames a chunk)
TOWER_CHUNKS = {"vit_b16": (197, 320), "vit_l14": (257, 255), "vit_l14_336": (577, 113)}


@pytest.mark.parametrize("geometry", list(TOWER_CHUNKS))
def test_tower_chunk_is_the_batch_up_to_its_row_bound(geometry):
    """ops/_cuda.py tower_chunk: the whole batch, up to TOWER_MAX_ROWS rows a
    chunk; the grid barriers a launch follow from it (TOWER_STAGES a layer
    below the last, TOWER_LAST_STAGES for it, per chunk)."""
    tokens, chunk = TOWER_CHUNKS[geometry]
    assert _cuda.tower_chunk(320, tokens) == chunk
    assert chunk == 320 or chunk * tokens <= _cuda.TOWER_MAX_ROWS < (chunk + 1) * tokens
    assert _cuda.tower_chunk(chunk - 1, tokens) == chunk - 1
    layers = 12
    for int8 in (False, True):
        per_layer = len(_cuda.TOWER_STAGES[int8])
        assert _cuda.tower_barriers(320, chunk, layers, int8) == -(-320 // chunk) * (
            per_layer * (layers - 1) + len(_cuda.TOWER_LAST_STAGES))


# -- the gate of clip_vision_kv -------------------------------------------------------

GATE_CASES = [(int8, block, tower, attn, (1, 2))
              for int8 in (True, False)
              for block in ("auto", "full", "split")
              for tower in (False, True)
              for attn in (("0", "1", "qk") if int8 else ("0",))]
GATE_CASES += [(False, "auto", False, "1", (1, 2)),   # int8_attn is ignored in bf16
               (False, "full", True, "qk", (1, 2)),
               (False, "auto", True, "0", (0, 2)),    # a keep the tower cannot take
               (True, "auto", True, "1", (0, 2))]


def _gate_env(monkeypatch, block, tower, attn):
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    monkeypatch.setenv("DFD_FUSED_BLOCK", block)
    monkeypatch.setenv("DFD_MEGAKERNEL", "1" if tower else "0")
    monkeypatch.setenv("DFD_INT8_ATTN", attn)


@pytest.fixture(scope="module")
def vit_io():
    cfg = jvit.ARCHITECTURES["ViT-Test"]
    params = jax.tree_util.tree_map(np.asarray, jvit.init_clip_vision(jax.random.key(3), cfg))
    x = np.random.default_rng(25).standard_normal((FRAMES, 3, 32, 32)).astype(np.float32)
    return cfg, params, x


@pytest.mark.parametrize("int8,block,tower,attn,keep", GATE_CASES,
                         ids=["-".join(["int8" if c[0] else "bf16", c[1],
                                        "tower" if c[2] else "layers", c[3],
                                        "keep" + "".join(map(str, c[4]))])
                              for c in GATE_CASES])
def test_clip_vision_kv_gate_matches_jax(vit_io, monkeypatch, int8, block, tower, attn, keep):
    """Each block / tower / int8_attn choice against JAX with the matching
    DFD_FUSED_BLOCK / DFD_MEGAKERNEL / DFD_INT8_ATTN (Pallas interpreted),
    f32, pad_tokens on: the tower's export is unpadded, the per-layer
    forms' padded; keep (0, 2) leaves the tower unused in both."""
    cfg, params, x = vit_io
    _gate_env(monkeypatch, block, tower, attn)
    kw = dict(keep_layers=keep, drop_cls=True, pad_tokens=True, compute_int8=int8)
    want = jvit.clip_vision_kv(jvit.prepare_int8_params(jx(params)), jnp.asarray(x), cfg,
                               compute_dtype=jnp.float32, **kw)
    got = tvit.clip_vision_kv(tvit.prepare_int8_params(params_from_jax(params)),
                              torch.from_numpy(x), tvit.ARCHITECTURES["ViT-Test"],
                              compute_dtype=torch.float32, block=block, tower=tower,
                              int8_attn=attn, **kw)
    p = 4 if tower and keep == (1, 2) else 8
    for s in ("k", "v"):
        assert tuple(got[s].shape) == (2, FRAMES, p, cfg.heads, cfg.head_dim)
        assert_close_ties(got[s], want[s])


def test_clip_vision_kv_rejects_unknown_choices(vit_io):
    cfg, params, x = vit_io
    args = (params_from_jax(params), torch.from_numpy(x), tvit.ARCHITECTURES["ViT-Test"])
    with pytest.raises(ValueError):
        tvit.clip_vision_kv(*args, block="whole")
    with pytest.raises(ValueError):
        tvit.clip_vision_kv(*args, int8_attn="yes")


# -- the detector ---------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "compute_int8"])
def test_detector_predict_with_the_tower_matches_jax(monkeypatch, int8):
    """The tiny detector with keep (1, 2), JAX's megakernel (DFD_MEGAKERNEL=1,
    Pallas interpreted) against EncoderKernels(tower=True), f32: the decoder
    reads the unpadded export (patch_valid stays the 4 patches)."""
    from fixtures import tiny_detector

    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    monkeypatch.setenv("DFD_MEGAKERNEL", "1")
    monkeypatch.setenv("DFD_DEC_STACK", "force")
    op_mode = {"temporal_position": 1, "compute_int8": int(int8)}
    jdet = tiny_detector(num_frames=4, decode_indices=[1, 2], op_mode=op_mode)
    jparams = jdet.init_params(jax.random.key(0))
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [1, 2],
                              "out_dim": [2], "losses": ["auc_roc"], "op_mode": op_mode})
    tdet = Detector(cfg, num_frames=4, compute_dtype=torch.float32, device="cpu",
                    encoder_kernels=EncoderKernels(tower=True))
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    tdet.vit_cfg = tiny
    tdet.transform = dataclasses.replace(tdet.transform, size=tiny.input_resolution)
    tdet.decoder_cfg = dataclasses.replace(tdet.decoder_cfg, width=tiny.width, heads=tiny.heads)
    tparams = tdet.prepare_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    x = np.random.default_rng(26).integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    kv = tdet.encode_kv(tparams, tdet.preprocess(torch.from_numpy(x)), pad_tokens=True)
    assert kv["k"].shape[3] == tiny.num_patches          # the tower's unpadded export
    want, _ = jdet.predict(jdet.prepare_params(jparams), jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    assert np.abs(got[0].float().numpy() - np.asarray(want[0])).max() <= TOL_F32 * 5


def test_int8_attention_tower_matches_jax_per_layer_blocks(monkeypatch):
    """The port's tower with int8 attention "1" on blocks whose ln_1 shift
    and V bias are nonzero (so the JAX tower's pad rows would carry V, see
    the module note) against JAX's per-layer int8 whole block with
    DFD_INT8_ATTN=1 and its int8 last_only layer, which do not pad: keep
    (1, 2), 5 tokens, in f32 (the tie allowance of the module note)."""
    monkeypatch.setenv("DFD_INT8_ATTN", "1")
    rng = np.random.default_rng(27)
    blocks = [block_params(rng, 256) for _ in range(3)]
    for b in blocks:
        assert np.abs(b["ln_1"]["bias"]).min() > 0
        assert np.abs(b["attn"]["in_proj"]["b"][512:]).min() > 0
    h = rng.standard_normal((FRAMES, TOKENS, 256)).astype(np.float32)
    j = [jx(b) for b in blocks]
    x = jpa.fused_encoder_block(jnp.asarray(h), j[0]["ln_1"], j[0]["attn"], j[0]["ln_2"],
                                j[0]["mlp"], 4, 64, int8_gemm=True)
    x, k1, v1 = jpa.fused_encoder_block(x, j[1]["ln_1"], j[1]["attn"], j[1]["ln_2"], j[1]["mlp"],
                                        4, 64, export=True, drop_cls=True, int8_gemm=True)
    k2, v2 = jpa.fused_encoder_attn_block(x, j[2]["ln_1"], j[2]["attn"], 4, 64, drop_cls=True,
                                          last_only=True, int8_gemm=True)
    shape = (FRAMES, TOKENS - 1, 256)
    want = [np.stack([np.asarray(a).reshape(shape), np.asarray(b).reshape(shape)])
            for a, b in ((k1, k2), (v1, v2))]
    got = ttower.fused_encoder_tower(torch.from_numpy(h), [th(b) for b in blocks], 4, 64,
                                     keep=(1, 2), drop_cls=True, int8_gemm=True, int8_attn="1")
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == (2,) + shape
        assert_close_ties(g, w_)
