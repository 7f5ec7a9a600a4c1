"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes the flagship run of chip_smoke.py does not reach (rows and
columns that are not tile multiples, short token counts, a short decoder
stream, the decoder attention's partials form and backward at token counts
that are not tile multiples, a whole tiny detector, the same detector with
patch_indices (L = 9 gathered keys, bf16 and int8 K/V) and a tiny trainer), and
the int8 kernels: gemm_s8 at ragged M and N with each epilogue, quant_rows
and layer_norm_quant on strided views, the int8 K/V export with pad rows,
the int8 K/V decoder attention at a ragged L, and a whole int8 block; and
the 257-token towers: both encoder-attention entries at 17 to 320 tokens
with 12 and 16 heads (the separate entry on strided views of one packed
buffer and on contiguous tensors), the token limit, the int8 split pair at
width 1024, and tiny DINOv2 and ViT-L-class detectors; and the encoder's
alternative paths: the int8 encoder attention at 17, 197 and 257 tokens in
both modes, gemm's f32 forms and layer_norm_rows on f32 rows, the bf16 whole
block, the whole-encoder tower (3 layers at ViT-B/16 width, bf16 and int8
with each int8 attention mode, 25 frames: a chunk of 21 and a short one;
and int8 at ViT-L/14 width, 257 tokens) against the per-layer kernel chain
and the plain version, and a tower grid that cannot be co-resident, which
raises; and the 577-token slice: both attention entries and outputs at 321,
577 and 1025 tokens, the attention entries' limits, and the decoder
attention at L = 11,520; and the tools' kernels: the study
attention in each numerics mode and the chained GEMM's two entries
(bit-equal to each other); and the ViT-L int8 ladder: the int8 attention at
321, 577 and 1025 tokens in both modes, the tower at ViT-L/14@336px's width
and 577 tokens in each int8 attention mode, and the co-residency refusal at
577 tokens; and the int8 attention's one TMA / int8 wgmma kernel at
ViT-L/14's 16 heads and on 24 frames (more than two work items to each
persistent block, resident and re-staged key blocks), and quant_rows at
the paths' widths, 768 to 4096, and past a block's row (8200); and the
encoder attention's one
TMA / wgmma kernel: both entries and both outputs at 1 to 1025 tokens
(single and ragged key blocks, the narrow last block, an odd number of
query tiles, the K/V ring resident and refilled) with 12 and 16 heads, on
2 frames and on 24 (several work items to each persistent block), and
the pitches and head widths it refuses; and the two GEMMs' persistent
TMA / wgmma kernels: every epilogue form at a ragged tile (M = 200, N =
136, bf16 K % 64 == 32), at M = 40,000 on the clustered 128 x 256 tiles
(several tiles to each block, an odd panel count), at the decoder's M = 16
and with a row pitch larger than K, the K/V export through the qkv
weight's column view into a stacked slot, gemm_s8 bit for bit against
w8a8_dot_plain in every form without QuickGELU, QuickGELU where its
exponential overflows, and the unaligned starts and pitches both refuse;
and the int8 MLP's c_fc with its rows quantised on chip (gemm_s8_quant):
bit for bit gemm_s8's QuickGELU form followed by quant_rows, at a ragged M
with a longer row pitch, at ViT-L/14's c_fc with several row panels to each
cluster, and at clusters of 2 and 1 CTAs, with CTAs of 512 and 384
columns; and the decoder attention split over chunks of L in all three
forms (normalised bf16, partials, int8 K/V with per-token scales) at L = 1,
one past a chunk, 4,000 and 11,520 with 12 and 16 heads, a fully masked
sample and a fully masked chunk, two calls bit-equal; and the persistent
layer_norm_quant in both input types at 1, 7, 8 and 9 rows and widths 64
to 1024 on strided rows.

Marked ``cuda``; every test skips without a card. Run on a machine with one:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q --noconftest

Tolerance: max|kernel - plain| <= 2e-2 x max|plain| in bf16 (a few bf16
ulps of rounding-order difference), 5e-2 for a whole bf16 predict against
the f32 plain path (1e-1 for parameter updates after a bf16 forward) and for
a 3-layer tower against its plain version (three layers of rounding-order
difference), and exact zeros where the contract says zero. With int8
attention the tower runs the per-layer kernels' own block bodies, so against
their chain it is held at 1e-3 with at least 99 % of the values equal; with
bf16 attention (int8 attention "0") its attention body (wmma or mma.sync)
sums in another order than the per-layer TMA / wgmma kernel, which moves
values by bf16 ulps (and int8 quantisers across a step) from the first layer
on, so that chain holds it at 2e-2. The int8 kernels repeat their
plain versions' f32 operations in order: gemm_s8's f32 outputs within 1e-5
of the maximum; int8 values within 1 on at most 1e-3 of the elements (a
LayerNorm sum taken in another order can move a value across a rounding
boundary) and scales within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max()).item()


def randn(gen, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=gen)


# The GEMMs' geometries (csrc/gemm_hopper.cuh): (frames, tokens) of M rows,
# K, the export width w (N = 3w with the export, else 136), and the extra
# row pitch of A. "ragged": M = 200 (not a multiple of the 128-row tile),
# N = 136 (a ragged column tile), K = 96 (K % 64 == 32: a zero-filled depth
# tile); "multi": M = 40,000 (313 row panels, an odd count, so one cluster's
# pair is half empty) at N = 768 on the 128 x 256 tiles in clusters, several
# tiles to each persistent block; "m16": the decoder boundary's M = 16 on
# the 128 x 64 tiles; "pitch": A a view whose rows are 8 values longer.
GEMM_GEOMETRIES = {
    "ragged": dict(frames=8, tokens=25, k=96, w=64, n=136, pad=0),
    "multi": dict(frames=160, tokens=250, k=768, w=256, n=768, pad=0),
    "m16": dict(frames=2, tokens=8, k=768, w=256, n=768, pad=0),
    "pitch": dict(frames=8, tokens=25, k=96, w=64, n=136, pad=8),
}


def gemm_rows(gen, dev, m, k, pad, dtype=torch.bfloat16):
    """A (m, k) bf16 operand, a view with ``pad`` more values a row when
    pad > 0."""
    full = randn(gen, m, k + pad).to(dev, dtype)
    return full[:, :k] if pad else full


@pytest.mark.parametrize("geo", list(GEMM_GEOMETRIES))
@pytest.mark.parametrize("mode", ["bias_f32", "bias_bf16_gelu", "residual", "export"])
def test_gemm_epilogues_ragged(dev, mode, geo):
    """Each bf16 epilogue at each geometry of GEMM_GEOMETRIES; the export
    through the qkv weight's K/V column view (row pitch 3w, col_off = w) into
    slot 1 of stacked buffers: pad rows zero, slot 0 untouched."""
    from dfd_clip_tpu_torch.ops import _cuda

    g = GEMM_GEOMETRIES[geo]
    gen = torch.Generator().manual_seed(0)
    frames, tokens, w, k = g["frames"], g["tokens"], g["w"], g["k"]
    m = frames * tokens
    n = 3 * w if mode == "export" else g["n"]
    a = gemm_rows(gen, dev, m, k, g["pad"])
    b = randn(gen, k, n, scale=k ** -0.5).to(dev, torch.bfloat16)
    bias = randn(gen, n, scale=0.1).to(dev)
    acc = a.float() @ b.float()
    if mode == "bias_f32":
        got, want = _cuda.gemm(a, b, bias), (acc + bias).to(torch.bfloat16)
    elif mode == "bias_bf16_gelu":
        got = _cuda.gemm(a, b, bias, bias_after_cast=True, gelu=True)
        v = (acc.to(torch.bfloat16) + bias.to(torch.bfloat16)).float()
        want = (v * torch.sigmoid(1.702 * v)).to(torch.bfloat16)
    elif mode == "residual":
        res = randn(gen, m, n).to(dev, torch.bfloat16)
        got = _cuda.gemm(a, b, bias, residual=res)
        want = res + (acc + bias).to(torch.bfloat16)
    else:
        t_out = tokens - 1 + 8
        kbuf = torch.full((2, frames, t_out, w), float("nan"), device=dev, dtype=torch.bfloat16)
        vbuf = torch.full_like(kbuf, float("nan"))
        _cuda.gemm(a, b[:, w:], bias[w:], store=False, col_off=w,
                   export=(kbuf[1], vbuf[1], tokens, t_out, 1, w))
        rows = (acc + bias).to(torch.bfloat16).reshape(frames, tokens, n)[:, 1:]
        assert torch.equal(kbuf[1, :, tokens - 1:], torch.zeros_like(kbuf[1, :, tokens - 1:]))
        assert torch.equal(vbuf[1, :, tokens - 1:], torch.zeros_like(vbuf[1, :, tokens - 1:]))
        assert torch.isnan(kbuf[0]).all() and torch.isnan(vbuf[0]).all()   # other slots untouched
        assert rel_err(kbuf[1, :, : tokens - 1], rows[..., w: 2 * w]) <= REL
        assert rel_err(vbuf[1, :, : tokens - 1], rows[..., 2 * w:]) <= REL
        return
    assert rel_err(got, want) <= REL


def test_gemm_refuses_unaligned_operands(dev):
    """The GEMMs read A and the weight through tensor maps, which need
    16-byte aligned starts and row pitches: a bf16 A whose rows are 100
    values apart (200 bytes), a bf16 A starting 2 bytes in, an int8 A whose
    rows are 776 bytes apart and an int8 weight starting 1 byte in raise
    before anything is launched."""
    from dfd_clip_tpu_torch.ops import _cuda

    bias = torch.zeros(64, device=dev)
    b = torch.zeros(96, 64, device=dev, dtype=torch.bfloat16)
    buf = torch.zeros(32, 100, device=dev, dtype=torch.bfloat16)
    _cuda.reset_launches()
    with pytest.raises(ValueError, match="16 bytes"):
        _cuda.gemm(buf[:, :96], b, bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _cuda.gemm(buf[:, 1:97], b, bias)
    q = torch.zeros(32, 776, device=dev, dtype=torch.int8)
    wq = torch.zeros(64, 769, device=dev, dtype=torch.int8)
    scale = torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        _cuda.gemm_s8(q[:, :768], scale, wq[:, :768].contiguous(), torch.ones(64, device=dev), bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _cuda.gemm_s8(q[:, :768].contiguous(), scale, wq.reshape(-1)[1: 1 + 64 * 768].view(64, 768),
                      torch.ones(64, device=dev), bias)
    assert _cuda.launches() == {}


def test_layer_norm_rows_ragged(dev):
    from dfd_clip_tpu_torch.models.layers import layer_norm
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(1)
    x = randn(gen, 37, 200).to(dev, torch.bfloat16)
    ln = {"scale": randn(gen, 200).to(dev), "bias": randn(gen, 200).to(dev)}
    got = _cuda.layer_norm_rows(x, ln["scale"], ln["bias"])
    assert rel_err(got, layer_norm(ln, x)) <= REL


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("entry", ["packed", "separate"])
@pytest.mark.parametrize("tokens", [5, 17, 197, 321, 577, 1025])
def test_encoder_attention_token_counts(dev, tokens, entry, out):
    """Both entries and both outputs, 3 frames of 2 heads, one kernel at
    every token count (the _cuda entries count nothing themselves), against
    plain_attention."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.attention import plain_attention_qkv

    gen = torch.Generator().manual_seed(2)
    frames, heads = 3, 2
    w = heads * 64
    qkv = randn(gen, frames * tokens, 3 * w).to(dev, torch.bfloat16)
    odt = torch.float32 if out == "f32" else torch.bfloat16
    _cuda.reset_launches()
    if entry == "packed":
        got = _cuda.encoder_attention_packed(qkv, frames, tokens, heads, 64, odt)
    else:
        q, k, v = (s.reshape(frames, tokens, heads, 64) for s in qkv.split(w, dim=-1))
        got = _cuda.encoder_attention_separate(q, k, v, odt)
    assert _cuda.launches() == {}
    want = plain_attention_qkv(qkv.reshape(frames, tokens, -1), heads, 64, out_dtype=odt)
    assert got.dtype == odt
    assert rel_err(got, want.reshape(frames * tokens, -1)) <= REL


def test_fused_decoder_attention_short_stream(dev):
    from dfd_clip_tpu_torch.models.decoder import token_mask
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import (
        fused_decoder_attention,
        fused_decoder_attention_plain,
    )

    gen = torch.Generator().manual_seed(3)
    b, h, t, p = 3, 2, 3, 16
    l = t * p
    q = randn(gen, b, 2 * h * 64).to(dev, torch.bfloat16)
    qs, qc = q[:, : h * 64].reshape(b, 1, h, 64), q[:, h * 64:].reshape(b, 1, h, 64)
    k = randn(gen, 2, b, l, h, 64).to(dev, torch.bfloat16)
    v = randn(gen, 2, b, l, h, 64).to(dev, torch.bfloat16)
    pos = randn(gen, l, h, 64, scale=0.1).to(dev, torch.bfloat16)
    frames = torch.ones(b, t, dtype=torch.bool, device=dev)
    frames[1, 2:] = False
    frames[2] = False
    mask = token_mask(frames, p, 13)
    got = fused_decoder_attention(qs, qc, k, v, mask, pos, layer=1)
    want = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer=1)
    assert rel_err(got, want) <= REL
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_tiny_wide_detector_predict_on_card(dev):
    """ViT-Test-Wide (head_dim 64) end to end through the kernels, against
    the same params through the plain versions in f32 on the CPU."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.ops import _cuda

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2]})
    tiny = clip_vit.ARCHITECTURES["ViT-Test-Wide"]

    def build(device, dtype):
        det = Detector(cfg, num_frames=4, compute_dtype=dtype, device=device)
        det.vit_cfg = tiny
        det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width,
                                              heads=tiny.heads)
        return det

    card, cpu = build(dev, torch.bfloat16), build("cpu", torch.float32)
    params = cpu.init_params(torch.Generator().manual_seed(4))
    x = np.random.default_rng(0).integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    _cuda.reset_launches()
    got = card.predict(card.prepare_params(params), x, m)[0][0]
    assert _cuda.launches().get("fused_decoder_attention") == 2
    want = cpu.predict(cpu.prepare_params(params), x, m)[0][0]
    assert rel_err(got.cpu(), want) <= 5e-2     # bf16 through 3 layers vs f32


@pytest.mark.parametrize("kv_dtype", ["auto", "int8_rows"])
def test_tiny_wide_detector_patch_indices_on_card(dev, kv_dtype):
    """Detector.predict with patch_indices on the card: 3 frames x 3 of
    ViT-Test-Wide's 4 patches a kept layer, L = 9 keys (not a multiple of
    8) into the decoder attention kernel (its int8 K/V form with int8_rows),
    against the same gather through the plain versions in f32 on the CPU."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.ops import _cuda

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "op_mode": {"kv_dtype": kv_dtype}})
    tiny = clip_vit.ARCHITECTURES["ViT-Test-Wide"]

    def build(device, dtype):
        det = Detector(cfg, num_frames=3, compute_dtype=dtype, device=device)
        det.vit_cfg = tiny
        det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width,
                                              heads=tiny.heads)
        return det

    card, cpu = build(dev, torch.bfloat16), build("cpu", torch.float32)
    params = cpu.init_params(torch.Generator().manual_seed(6))
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(4, 3, replace=False) for _ in range(2)])
    x = rng.integers(0, 256, (2, 3, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 3, [True, True, False]])
    _cuda.reset_launches()
    got = card.predict(card.prepare_params(params), x, m, patch_indices=idx)[0][0]
    counter = "fused_decoder_attention" + ("_int8" if kv_dtype == "int8_rows" else "")
    assert _cuda.launches().get(counter) == 2
    want = cpu.predict(cpu.prepare_params(params), x, m, patch_indices=idx)[0][0]
    assert rel_err(got.cpu(), want) <= 5e-2     # bf16 through 3 layers vs f32


def decoder_inputs(dev, gen, b, h, l, stacked):
    """Queries as views of one (B, 2HD) row (the decoder's layout), K/V
    stacked or not, pos, and a mask with sample 1 partly and the last
    sample fully masked."""
    q = randn(gen, b, 2 * h * 64).to(dev, torch.bfloat16)
    qs, qc = q[:, : h * 64].reshape(b, 1, h, 64), q[:, h * 64:].reshape(b, 1, h, 64)
    shape = ((2,) if stacked else ()) + (b, l, h, 64)
    k = randn(gen, *shape, scale=0.5).to(dev, torch.bfloat16)
    v = randn(gen, *shape).to(dev, torch.bfloat16)
    pos = randn(gen, l, h, 64, scale=0.1).to(dev, torch.bfloat16)
    mask = torch.ones(b, l, dtype=torch.bool, device=dev)
    mask[1, l // 3:] = False
    mask[b - 1] = False
    return qs, qc, k, v, pos, mask


DEC_GEOMETRIES = [(2, 77, True, True), (4, 200, False, True), (12, 130, True, False)]


@pytest.mark.parametrize("geo", DEC_GEOMETRIES, ids=["h2-l77-stacked", "h4-l200", "h12-nopos"])
def test_decoder_attention_partials_ragged(dev, geo):
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import (
        fused_decoder_attention,
        fused_decoder_attention_plain,
    )

    h, l, stacked, with_pos = geo
    qs, qc, k, v, pos, mask = decoder_inputs(dev, torch.Generator().manual_seed(5), 3, h, l,
                                             stacked)
    pos = pos if with_pos else None
    layer = 1 if stacked else None
    got = fused_decoder_attention(qs, qc, k, v, mask, pos, layer, partials=True)
    want = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer, partials=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g[:2], w[:2]) <= REL
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    assert torch.equal(got[1][2, 0], torch.zeros_like(got[1][2, 0]))
    assert torch.equal(got[1][2, 1], torch.full_like(got[1][2, 1], -1e30))


# the backward's geometries: (heads, L, stacked, with pos); L around one
# 96-token tile (_cuda.BWD_TILE) and at the train shape's 4,000
BWD_GEOMETRIES = DEC_GEOMETRIES + [(h, l, True, True) for h in (2, 12, 16)
                                   for l in (1, 63, 64, 65, 95, 96, 97, 4000)]


def decoder_bwd_args(dev, gen, b, h, l, stacked, with_pos):
    """decoder_inputs with the forward's stats from the plain partials and a
    random cotangent: the backward's arguments."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention_plain

    qs, qc, k, v, pos, mask = decoder_inputs(dev, gen, b, h, l, stacked)
    pos = pos if with_pos else None
    layer = 1 if stacked else None
    o_sc, st = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, h, 64) / denom.clamp_min(1e-30)[..., None]
    ct = randn(gen, b, 1, h, 64).to(dev, torch.bfloat16)
    return (qs, qc, k, v, mask, pos, layer, denom, mx, o_s, ct)


def check_bwd(args, dead=()):
    """The kernel against its plain version (each leaf within REL of its
    max; a leaf that is identically 0 in the plain version, dq_smax over a
    single token, whose softmax has no gradient, within 1e-6), dq exactly 0
    for the samples in ``dead``, two calls bit-equal."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention_bwd import (
        fused_decoder_attention_bwd,
        fused_decoder_attention_bwd_plain,
    )

    got = fused_decoder_attention_bwd(*args)
    again = fused_decoder_attention_bwd(*args)
    want = fused_decoder_attention_bwd_plain(*args)
    assert (got[2] is None) == (args[5] is None)
    for g, a, w in zip(got, again, want):
        if w is not None:
            assert g.dtype == torch.float32
            if w.abs().max().item() == 0:
                assert g.abs().max().item() <= 1e-6
            else:
                assert rel_err(g, w) <= REL
            assert torch.equal(g, a)
    for b in dead:
        assert torch.equal(got[0][b], torch.zeros_like(got[0][b]))
        assert torch.equal(got[1][b], torch.zeros_like(got[1][b]))
    return got


@pytest.mark.parametrize("geo", BWD_GEOMETRIES,
                         ids=["h2-l77-stacked", "h4-l200", "h12-nopos"]
                         + [f"h{h}-l{l}" for h, l, _, _ in BWD_GEOMETRIES[3:]])
def test_decoder_attention_bwd_ragged(dev, geo):
    """dq_smax, dq_coda and dpos against _bwd_math on the same stats (from
    the plain partials): L of one token, around the 96-token tile and at
    4,000, 2 to 16 heads, with and without pos, stacked slot and plain K/V;
    the fully masked sample's dq is exactly 0; two calls are bit-equal."""
    h, l, stacked, with_pos = geo
    check_bwd(decoder_bwd_args(dev, torch.Generator().manual_seed(6), 3, h, l, stacked,
                               with_pos), dead=(2,))


@pytest.mark.parametrize("l", [200, 4000])
def test_decoder_attention_bwd_masked_tiles(dev, l):
    """A sample masked over whole tiles but not all of them (tiles 1 and 2
    of sample 0, every tile of sample 1 past the first, a ragged run in
    sample 2): the producer skips those (sample, tile) pairs, and the
    result still holds; dpos of tokens masked in every sample is 0."""
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(7)
    args = decoder_bwd_args(dev, gen, 4, 12, l, True, True)
    mask, tile = args[4], _cuda.BWD_TILE
    mask[:] = True
    mask[0, tile: 3 * tile] = False
    mask[1, tile:] = False
    mask[2, 5: 2 * tile + 7] = False
    mask[3] = False
    args = decoder_bwd_args_from(args)
    got = check_bwd(args, dead=(3,))
    dead_tok = ~mask.any(0)
    if dead_tok.any():
        assert torch.equal(got[2][dead_tok], torch.zeros_like(got[2][dead_tok]))


def decoder_bwd_args_from(args):
    """args with the stats recomputed for their (edited) mask."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention_plain

    qs, qc, k, v, mask, pos, layer, _, _, _, ct = args
    b, _, h, _ = qs.shape
    o_sc, st = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, h, 64) / denom.clamp_min(1e-30)[..., None]
    return (qs, qc, k, v, mask, pos, layer, denom, mx, o_s, ct)


@pytest.mark.parametrize("gain", [4.0, 8.0])
def test_decoder_attention_bwd_saturated_coda(dev, gain):
    """CoDA logits far into tanh's saturation (the CoDA query scaled by
    ``gain``): 1 - tanh^2 cancels there, so an approximate tanh moves
    dq_coda and dpos well past the hold; the kernel keeps them within REL."""
    gen = torch.Generator().manual_seed(10)
    args = decoder_bwd_args(dev, gen, 3, 12, 4000, True, True)
    qs, qc = args[0], args[1]
    qc.copy_((gain * qc.float()).bfloat16())
    lc = torch.einsum("bhd,blhd->blh", qc[:, 0].float() * 0.125, args[2][1].float()
                      + args[5].float()[None])
    assert (lc.abs() > 3).float().mean().item() > 0.1
    check_bwd(decoder_bwd_args_from(args), dead=(2,))


@pytest.mark.parametrize("b", [2, 16, 40])
def test_decoder_attention_bwd_batches(dev, b):
    """Batches of two samples, of 16 and of 40 (more than a pass holds:
    _cuda.bwd_geometry's group, so the later passes add to dpos), at L =
    300 and 12 heads."""
    from dfd_clip_tpu_torch.ops import _cuda

    geo = _cuda.bwd_geometry(b, 300, 12, torch.cuda.get_device_properties(0).multi_processor_count)
    assert geo["passes"] == -(-b // geo["group"])
    args = decoder_bwd_args(dev, torch.Generator().manual_seed(8), b, 12, 300, True, True)
    check_bwd(args, dead=(b - 1,) if b > 2 else ())


def test_decoder_attention_bwd_one_kernel(dev):
    """One CUDA kernel a call (torch.profiler's device rows), counted once;
    dq written in the queries' bf16 when asked, equal to the f32 result
    rounded; the ticket counters are left zeroed."""
    from torch.profiler import ProfilerActivity, profile

    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.fused_decoder_attention_bwd import fused_decoder_attention_bwd

    args = decoder_bwd_args(dev, torch.Generator().manual_seed(9), 12, 12, 4000, True, True)
    want = fused_decoder_attention_bwd(*args)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = fused_decoder_attention_bwd(*args, dq_dtype=torch.bfloat16)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_cpu_time_total == 0
            and (getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total) > 0]
    assert sum(e.count for e in rows) == 1
    assert _cuda.launches() == {"fused_decoder_attention_bwd": 1}
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())
    assert torch.equal(got[2], want[2])
    ticket = _cuda.bwd_ticket(0, torch._C._cuda_getCurrentRawStream(0), 12)
    assert int(ticket.abs().sum()) == 0


def test_tiny_wide_trainer_on_card(dev):
    """Two steps of a ViT-Test-Wide (head_dim 64) Trainer through the
    kernels, against the same steps through the plain versions in f32 on
    the CPU: per-step losses and every trainable leaf."""
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.models.weights import to_numpy_tree
    from dfd_clip_tpu_torch.ops import _cuda

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"]})
    tiny = clip_vit.ARCHITECTURES["ViT-Test-Wide"]

    def build(device, dtype):
        det = Detector(cfg, num_frames=4, compute_dtype=dtype, device=device)
        det.vit_cfg = tiny
        det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width,
                                              heads=tiny.heads)
        tcfg = Trainer.get_default_config()
        tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 0.5})
        params = det.init_params(torch.Generator().manual_seed(4))
        return Trainer(tcfg, det, {}, params=params, device=device)

    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8), np.array([0, 1]),
             np.array([[True] * 4, [True, True, False, False]]), ["raw", "raw"],
             np.ones(2, np.float32), np.zeros(2, np.int64))
    card, cpu = build(dev, torch.bfloat16), build("cpu", torch.float32)
    start = _leaves(to_numpy_tree(cpu.trainable))
    _cuda.reset_launches()
    for trainer in (card, cpu):
        for _ in range(2):
            trainer.train_step([("t", trainer.prepare_batch(batch))])
    assert _cuda.launches().get("fused_decoder_attention_bwd") == 4
    assert _cuda.launches().get("fused_decoder_attention") == 4
    assert rel_err(torch.from_numpy(card.batch_losses["t"]),
                   torch.from_numpy(cpu.batch_losses["t"])) <= 5e-2
    # each leaf's update (trained - initial) within 1e-1 of its largest
    # entry: the card's gradients come through bf16 activations
    for g, w, s0 in zip(_leaves(to_numpy_tree(card.trainable)),
                        _leaves(to_numpy_tree(cpu.trainable)), start):
        assert rel_err(torch.from_numpy(g - s0), torch.from_numpy(w - s0)) <= 1e-1


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- the int8 kernels -------------------------------------------------------------------

def int8_close(got, want, share=1e-3):
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() <= share


def quantised(gen, dev, m, k, n):
    """A (M, K) int8 with row scales, a (N, K) int8 weight with (1, N)
    scales and an f32 bias, from the plain quantisers."""
    from dfd_clip_tpu_torch.ops.int8 import quant_rows_plain, quantize_weight

    aq, a_s = quant_rows_plain(randn(gen, m, k))
    wq, ws = quantize_weight(randn(gen, k, n, scale=k ** -0.5))
    return (aq.to(dev), a_s.reshape(-1).to(dev), wq.to(dev), ws.to(dev),
            randn(gen, n, scale=0.1).to(dev))


# gemm_s8's geometries: as GEMM_GEOMETRIES, with K a multiple of 64 (768,
# or 3072 for the GELU case) and the pitch case's int8 rows 16 bytes longer.
S8_GEOMETRIES = {
    "ragged": dict(frames=8, tokens=25, w=64, n=136, pad=0),
    "multi": dict(frames=160, tokens=250, w=256, n=768, pad=0),
    "m16": dict(frames=2, tokens=8, w=256, n=768, pad=0),
    "pitch": dict(frames=8, tokens=25, w=64, n=136, pad=16),
}


def s8_rows(aq, pad):
    """aq (M, K) int8 as a view whose rows are ``pad`` bytes longer."""
    if not pad:
        return aq
    full = torch.zeros(aq.shape[0], aq.shape[1] + pad, device=aq.device, dtype=torch.int8)
    full[:, : aq.shape[1]] = aq
    return full[:, : aq.shape[1]]


@pytest.mark.parametrize("geo", list(S8_GEOMETRIES))
@pytest.mark.parametrize("case", ["k768_bf16", "k3072_f32_gelu", "res_f32_to_bf16",
                                  "res_bf16_to_f32", "export"])
def test_gemm_s8_ragged(dev, case, geo):
    """Each W8A8 epilogue at each geometry of S8_GEOMETRIES (N = 3 x w with
    the K/V export through the weight's row view wq[w:], col_off = w, into
    slot 1 of stacked buffers: pad rows zero, slot 0 untouched)."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import w8a8_dot_plain

    g = S8_GEOMETRIES[geo]
    gen = torch.Generator().manual_seed(10)
    frames, tokens, w = g["frames"], g["tokens"], g["w"]
    m, k = frames * tokens, 3072 if case == "k3072_f32_gelu" else 768
    n = 3 * w if case == "export" else g["n"]
    aq, a_s, wq, ws, bias = quantised(gen, dev, m, k, n)
    v = w8a8_dot_plain(aq, a_s[:, None], wq, ws) + bias
    aq = s8_rows(aq, g["pad"])
    if case == "k768_bf16":
        got, want = _cuda.gemm_s8(aq, a_s, wq, ws, bias), v.to(torch.bfloat16)
    elif case == "k3072_f32_gelu":
        got = _cuda.gemm_s8(aq, a_s, wq, ws, bias, gelu=True, out_dtype=torch.float32)
        want = v * torch.sigmoid(1.702 * v)
    elif case == "res_f32_to_bf16":
        res = randn(gen, m, n).to(dev)
        got = _cuda.gemm_s8(aq, a_s, wq, ws, bias, residual=res)
        want = (res + v).to(torch.bfloat16)
    elif case == "res_bf16_to_f32":
        res = randn(gen, m, n).to(dev, torch.bfloat16)
        got = _cuda.gemm_s8(aq, a_s, wq, ws, bias, residual=res, out_dtype=torch.float32)
        want = res.float() + v
    else:
        t_out = tokens - 1 + 8
        kbuf = torch.full((2, frames, t_out, w), float("nan"), device=dev, dtype=torch.bfloat16)
        vbuf = torch.full_like(kbuf, float("nan"))
        _cuda.gemm_s8(aq, a_s, wq[w:], ws[:, w:], bias[w:], store=False, col_off=w,
                      export=(kbuf[1], vbuf[1], tokens, t_out, 1, w))
        rows = v.to(torch.bfloat16).reshape(frames, tokens, n)[:, 1:]
        assert torch.equal(kbuf[1, :, tokens - 1:], torch.zeros_like(kbuf[1, :, tokens - 1:]))
        assert torch.equal(vbuf[1, :, tokens - 1:], torch.zeros_like(vbuf[1, :, tokens - 1:]))
        assert torch.isnan(kbuf[0]).all() and torch.isnan(vbuf[0]).all()   # other slots untouched
        assert torch.equal(kbuf[1, :, : tokens - 1], rows[..., w: 2 * w])
        assert torch.equal(vbuf[1, :, : tokens - 1], rows[..., 2 * w:])
        return
    assert got.dtype == want.dtype
    assert rel_err(got, want) <= (1e-5 if got.dtype == torch.float32 else REL)


# gemm_s8_quant's geometries: (M, K, N, extra bytes of A's row pitch).
# "ragged": M = 200 (not a multiple of the 64-row panel) at ViT-B/16's c_fc
# (N = 3072: 8 CTAs of 384 columns), A a view with longer rows; "vit_l":
# ViT-L/14's c_fc (N = 4096: 8 CTAs of 512) at M = 40,000 (625 panels,
# several to each cluster); "narrow": the width-256 int8 block's c_fc (2
# CTAs of 512); "lone": N = 384, one CTA of 384, K = 192 (a zero-filled
# depth tile).
QUANT_GEOMETRIES = {
    "ragged": (200, 768, 3072, 16),
    "vit_l": (40000, 1024, 4096, 0),
    "narrow": (68, 256, 1024, 0),
    "lone": (130, 192, 384, 0),
}


@pytest.mark.parametrize("geo", list(QUANT_GEOMETRIES))
def test_gemm_s8_quant_bit_equal(dev, geo):
    """gemm_s8_quant runs gemm_s8's QuickGELU epilogue and quant_rows'
    quantiser, the row maximum taken across the cluster: its values and
    scales equal that pair's bit for bit; against its plain version
    (torch.sigmoid for expf) at the quantisers' hold."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import w8a8_gelu_quant_plain

    m, k, n, pad = QUANT_GEOMETRIES[geo]
    gen = torch.Generator().manual_seed(18)
    aq, a_s, wq, ws, bias = quantised(gen, dev, m, k, n)
    aq = s8_rows(aq, pad)
    _cuda.reset_launches()
    q, s = _cuda.gemm_s8_quant(aq, a_s, wq, ws, bias)
    assert _cuda.launches() == {"gemm_s8_quant": 1}
    assert q.shape == (m, n) and q.dtype == torch.int8 and s.shape == (m,)
    q2, s2 = _cuda.quant_rows(_cuda.gemm_s8(aq, a_s, wq, ws, bias, gelu=True,
                                            out_dtype=torch.float32))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    qp, sp = w8a8_gelu_quant_plain(aq, a_s[:, None], wq, ws, bias)
    int8_close(q, qp)
    assert rel_err(s, sp.reshape(-1)) <= 1e-5


def test_gemm_gelu_saturates(dev):
    """QuickGELU's reciprocal takes no slow path: where 1 + exp(-1.702 v)
    overflows (v down to about -1000 here) both GEMMs give v x 0, finite,
    as the plain versions do."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import w8a8_dot_plain

    gen = torch.Generator().manual_seed(12)
    m, k, n = 300, 768, 264
    a = randn(gen, m, k, scale=30.0).to(dev, torch.bfloat16)
    b = randn(gen, k, n, scale=k ** -0.5).to(dev, torch.bfloat16)
    bias = randn(gen, n, scale=0.1).to(dev)
    v = a.float() @ b.float() + bias
    assert v.min().item() < -100
    got = _cuda.gemm(a, b, bias, gelu=True)
    assert rel_err(got, (v * torch.sigmoid(1.702 * v)).to(torch.bfloat16)) <= REL
    aq = torch.randint(-127, 128, (m, k), generator=gen).to(torch.int8).to(dev)
    wq = torch.randint(-127, 128, (n, k), generator=gen).to(torch.int8).to(dev)
    a_s = (torch.rand(m, generator=gen) + 2.0).to(dev)
    ws = (torch.rand(1, n, generator=gen) + 2.0).to(dev)
    v = w8a8_dot_plain(aq, a_s[:, None], wq, ws) + bias
    assert v.min().item() < -100
    got = _cuda.gemm_s8(aq, a_s, wq, ws, bias, gelu=True, out_dtype=torch.float32)
    assert rel_err(got, v * torch.sigmoid(1.702 * v)) <= 1e-5


@pytest.mark.parametrize("geo", ["ragged", "multi", "m16"])
@pytest.mark.parametrize("form", ["plain_bf16", "plain_f32", "res_f32_to_bf16", "res_f32_to_f32",
                                  "res_bf16_to_bf16", "res_bf16_to_f32", "res_after_cast"])
def test_gemm_s8_bit_equal(dev, form, geo):
    """gemm_s8 repeats w8a8_dot_plain's operations (an exact product, then
    acc * (a_s / 127) * (w_s / 127) + bias and the residual in the kernel's
    order, none fused), so every form without QuickGELU equals the plain
    version bit for bit, in bf16 and f32 outputs."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import w8a8_dot_plain

    g = S8_GEOMETRIES[geo]
    gen = torch.Generator().manual_seed(11)
    m, k, n = g["frames"] * g["tokens"], 768, g["n"]
    aq, a_s, wq, ws, bias = quantised(gen, dev, m, k, n)
    v = w8a8_dot_plain(aq, a_s[:, None], wq, ws) + bias
    out = torch.float32 if form.endswith("f32") else torch.bfloat16
    res = None
    if form.startswith("res_f32"):
        res = randn(gen, m, n).to(dev)
    elif form.startswith("res_bf16") or form == "res_after_cast":
        res = randn(gen, m, n).to(dev, torch.bfloat16)
    after = form == "res_after_cast"
    got = _cuda.gemm_s8(aq, a_s, wq, ws, bias, out_dtype=out, residual=res,
                        residual_after_cast=after)
    if res is None:
        want = v.to(out)
    elif after:
        want = (res.float() + v.to(torch.bfloat16).float()).to(out)
    else:
        want = (res.float() + v).to(out)
    assert got.dtype == out
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_rows_strided(dev, dtype):
    """The K columns of a packed (37, 3 x 768) row block: a strided view."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import quant_rows_plain

    x = randn(torch.Generator().manual_seed(11), 37, 3 * 768, scale=3.0).to(dev, dtype)
    view = x[:, 768: 2 * 768]
    q, s = _cuda.quant_rows(view)
    q_p, s_p = quant_rows_plain(view)
    int8_close(q, q_p)
    assert rel_err(s, s_p.reshape(-1)) <= 1e-5


@pytest.mark.parametrize("width", [768, 1024, 3072, 4096, 8192, 8200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_rows_widths(dev, dtype, width):
    """quant_rows at the paths' widths (the attention output 768 / 1024, the
    MLP intermediate 3072 / 4096: a block of threads a row, the row read
    once), at the widest row a block holds (8192) and past it (8200: a warp
    a row, read twice), 301 rows of a view with 8 more values a row."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import quant_rows_plain

    x = randn(torch.Generator().manual_seed(width), 301, width + 8, scale=3.0).to(dev, dtype)
    view = x[:, :width]
    q, s = _cuda.quant_rows(view)
    q_p, s_p = quant_rows_plain(view)
    int8_close(q, q_p)
    assert rel_err(s, s_p.reshape(-1)) <= 1e-5


def test_quant_rows_kv_export_pad_rows(dev):
    """The int8_rows export of 4 frames x 5 tokens (CLS dropped, 4 pad rows)
    into slot 1 of a stacked buffer, from strided bf16 K/V column views."""
    from dfd_clip_tpu_torch.ops.int8 import export_kv_rows8

    frames, tokens, w = 4, 5, 256
    xf = randn(torch.Generator().manual_seed(12), frames * tokens, 3 * w).to(dev, torch.bfloat16)
    kacc = torch.full((2, frames, 8, w), 7, dtype=torch.int8, device=dev)
    vacc = torch.full_like(kacc, 7)
    got = export_kv_rows8(xf[:, w: 2 * w], xf[:, 2 * w:], frames, tokens, 1, 4,
                          (kacc[1], vacc[1]))
    want = export_kv_rows8(xf[:, w: 2 * w].cpu(), xf[:, 2 * w:].cpu(), frames, tokens, 1, 4)
    for g, w_ in zip(got[:2], want[:2]):
        int8_close(g.cpu(), w_)
    for g, w_ in zip(got[2:], want[2:]):
        assert rel_err(g.cpu(), w_) <= 1e-5
        assert torch.equal(g[:, 4:], torch.zeros_like(g[:, 4:]))
    assert (kacc[0] == 7).all() and torch.equal(kacc[1, :, 4:], torch.zeros_like(kacc[1, :, 4:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_quant_strided(dev, dtype):
    """LN + _quant_rows on rows of stride 1024 (a (37, 1024) block's first
    768 columns), f32 (the hmid input) and bf16 (the h input)."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import layer_norm_f32, quant_rows_plain

    gen = torch.Generator().manual_seed(13)
    x = randn(gen, 37, 1024, scale=2.0).to(dev, dtype)[:, :768]
    ln = {"scale": (1 + randn(gen, 768, scale=0.3)).to(dev),
          "bias": randn(gen, 768, scale=0.1).to(dev)}
    q, s = _cuda.layer_norm_quant(x, ln["scale"], ln["bias"])
    q_p, s_p = quant_rows_plain(layer_norm_f32(ln, x))
    int8_close(q, q_p)
    assert rel_err(s, s_p.reshape(-1)) <= 1e-5


def test_int8_kv_decoder_attention_ragged_l(dev):
    """int8 K/V with per-row scales at slot 1 of a 2-slot stack, L = 77,
    one sample partly and one fully masked."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import (
        fused_decoder_attention,
        fused_decoder_attention_plain,
    )
    from dfd_clip_tpu_torch.ops.int8 import quant_kv_rows_plain

    gen = torch.Generator().manual_seed(14)
    b, h, l = 3, 2, 77
    qs, qc, k, v, pos, mask = decoder_inputs(dev, gen, b, h, l, True)
    (kq, ks), (vq, vs) = (quant_kv_rows_plain(t.reshape(2, b, l, h * 64)) for t in (k, v))
    kq, vq = kq.reshape(k.shape), vq.reshape(v.shape)
    got = fused_decoder_attention(qs, qc, kq, vq, mask, pos, 1, k_scale=ks, v_scale=vs)
    want = fused_decoder_attention_plain(qs, qc, kq, vq, mask, pos, 1, k_scale=ks, v_scale=vs)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= REL
    assert torch.equal(got[b - 1], torch.zeros_like(got[b - 1]))


def test_fused_encoder_block_int8_on_card(dev):
    """A whole int8 block (width 256, 4 heads of 64, 17 tokens, 4 frames)
    with the stacked int8_rows export, against its plain version."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    gen = torch.Generator().manual_seed(15)
    w, frames, tokens = 256, 4, 17
    cfg = dataclasses.replace(clip_vit.ARCHITECTURES["ViT-Test-Wide"], layers=1)
    blk = clip_vit.prepare_int8_params(clip_vit.init_clip_vision(gen, cfg))["blocks"][0]
    blk = {k: {kk: ({n: t.to(dev) for n, t in vv.items()} if isinstance(vv, dict)
                    else vv.to(dev)) for kk, vv in v.items()} for k, v in blk.items()}
    h = randn(gen, frames, tokens, w).to(dev, torch.bfloat16)
    outs = []
    for fn in (eb.fused_encoder_block, eb.fused_encoder_block_plain):
        into = (torch.zeros(2, frames, 24, w, dtype=torch.int8, device=dev),
                torch.zeros(2, frames, 24, w, dtype=torch.int8, device=dev), 1, 2)
        outs.append(fn(h, blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"], 4, 64, export=True,
                       drop_cls=True, export_into=into, kv_rows8=True, kv_pad=8))
    got, want = outs
    assert rel_err(got[0], want[0]) <= REL
    for i in (1, 2):
        int8_close(got[i][1], want[i][1])
    for i in (3, 4):
        assert rel_err(got[i], want[i]) <= 1e-5


@pytest.mark.parametrize("last_only", [False, True], ids=["export", "last_only"])
def test_bf16_attn_block_kv_rows8_on_card(dev, last_only):
    """The bf16 split pair's int8_rows export (kv_dtype "int8_rows" without
    compute_int8): width 256, 17 tokens, 4 frames, slot 1 of 2, 7 pad rows."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    gen = torch.Generator().manual_seed(16)
    w, frames, tokens = 256, 4, 17
    cfg = dataclasses.replace(clip_vit.ARCHITECTURES["ViT-Test-Wide"], layers=1)
    blk = clip_vit.init_clip_vision(gen, cfg)["blocks"][0]
    ln = {k: t.to(dev) for k, t in blk["ln_1"].items()}
    attn = {k: {"w": p["w"].to(dev, torch.bfloat16), "b": p["b"].to(dev)}
            for k, p in blk["attn"].items()}
    h = randn(gen, frames, tokens, w).to(dev, torch.bfloat16)
    outs = []
    for fn in (eb.fused_encoder_attn_block, eb.fused_encoder_attn_block_plain):
        into = (torch.zeros(2, frames, 23, w, dtype=torch.int8, device=dev),
                torch.zeros(2, frames, 23, w, dtype=torch.int8, device=dev), 1, 2)
        outs.append(fn(h, ln, attn, 4, 64, export=not last_only, last_only=last_only,
                       drop_cls=True, export_into=into, kv_rows8=True, kv_pad=7))
    got, want = outs
    if not last_only:
        assert rel_err(got[0], want[0]) <= REL
        got, want = got[1:], want[1:]
    for i in (0, 1):
        int8_close(got[i][1], want[i][1])
        assert torch.equal(got[i][1, :, tokens - 1:], torch.zeros_like(got[i][1, :, tokens - 1:]))
    for i in (2, 3):
        assert rel_err(got[i], want[i]) <= 1e-5


# -- the 257-token towers ----------------------------------------------------------------

@pytest.mark.parametrize("frames", [2, 24])
@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("tokens", [1, 17, 64, 65, 197, 257, 320, 321, 577, 1025])
@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("entry", ["packed", "separate_views", "separate_contiguous"])
def test_encoder_attention_entries(dev, entry, heads, tokens, out, frames):
    """Both entries of csrc/encoder_attention.cu and both outputs against
    plain_attention: the bf16 output through the wrappers the towers call,
    each counted under its own name; the f32 output through the int8
    block's packed entry (counted as encoder_attention) and through the
    separate entry (which counts nothing itself). 2 frames give each
    persistent block one work item (a (frame, head)) at most; 24 frames more
    than two to every block (one a SM), so query tiles are dealt across
    items and the ring refills item after item."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ops.encoder_block import encoder_attention

    if frames > 2:
        assert frames * heads > 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(tokens + heads)
    w = heads * 64
    odt = torch.float32 if out == "f32" else torch.bfloat16
    qkv = randn(gen, frames, tokens, 3 * w).to(dev, torch.bfloat16)
    q, k, v = (s.reshape(frames, tokens, heads, 64) for s in qkv.split(w, dim=-1))
    want = att.plain_attention(q, k, v, out_dtype=odt)
    if entry == "separate_contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _cuda.reset_launches()
    if entry == "packed" and out == "bf16":
        got, name = att.fused_encoder_attention_qkv(qkv, heads, 64), "fused_encoder_attention_qkv"
    elif entry == "packed":
        got = encoder_attention(qkv.reshape(frames * tokens, -1), frames, tokens, heads, 64,
                                out_dtype=odt)
        name = "encoder_attention"
    elif out == "bf16":
        got, name = att.fused_encoder_attention(q, k, v), "fused_encoder_attention"
    else:
        got, name = _cuda.encoder_attention_separate(q, k, v, odt), None
    assert _cuda.launches() == ({name: 1} if name else {})
    assert got.dtype == odt
    assert rel_err(got.reshape(want.shape), want) <= REL


def test_encoder_attention_limits(dev):
    """head_dim 32 and q/k/v of different row pitches raise; 321 tokens run
    the bf16 attention (one kernel at every count) and take the streamed
    kernels in the int8 attention and the tower (a tower without layers
    raises for that alone)."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ops.encoder_block import encoder_attention

    qkv = torch.zeros(2, 321, 3 * 128, device=dev, dtype=torch.bfloat16)
    assert att.fused_encoder_attention_qkv(qkv, 2, 64).shape == (2, 321, 128)
    assert encoder_attention(qkv.reshape(642, -1), 2, 321, 2, 64).shape == (642, 128)
    assert att.encoder_attention_int8(qkv.reshape(642, -1), 2, 321, 2, 64).shape == (642, 128)
    assert _cuda.tower_grid(321, True, "1") > 0 and _cuda.tower_grid(321, False, "0") > 0
    with pytest.raises(ValueError, match="layers"):
        _cuda.encoder_tower(qkv[..., :128].contiguous(), [], 2, first=0, lo=1, int8=False)
    with pytest.raises(ValueError):
        att.fused_encoder_attention_qkv(qkv[:, :17], 4, 32)
    q = qkv[:, :17, :128].reshape(2, 17, 2, 64)
    with pytest.raises(ValueError, match="pitch"):
        att.fused_encoder_attention(q, q.contiguous(), q)


def test_encoder_attention_refuses_unaligned_rows(dev):
    """The kernel's tensor maps need 16-byte aligned bases and row pitches,
    and its tiles a head of 64: a pitch of 388 bf16 (776 bytes), a start 2
    bytes off and head_dim 32 raise before anything is launched."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    buf = torch.zeros(2, 17, 388, device=dev, dtype=torch.bfloat16)
    q, k, v = (buf[..., i * 128: (i + 1) * 128].reshape(2, 17, 2, 64) for i in range(3))
    _cuda.reset_launches()
    with pytest.raises(ValueError, match="16 bytes"):
        att.fused_encoder_attention(q, k, v)
    q, k, v = (buf[..., 1 + i * 128: 1 + (i + 1) * 128].reshape(2, 17, 2, 64) for i in range(3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        att.fused_encoder_attention(q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        _cuda.encoder_attention_packed(torch.zeros(34, 3 * 128, device=dev, dtype=torch.bfloat16),
                                       2, 17, 4, 32)
    assert _cuda.launches() == {}


def _to(tree, dev, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, dev, dtype if k == "w" else None) for k, v in tree.items()}
    return tree.to(dev) if dtype is None or tree.dtype == torch.int8 else tree.to(dev, dtype)


@pytest.mark.parametrize("form", ["export_stacked", "rows8_stacked", "plain", "mlp"])
def test_int8_split_pair_width_1024(dev, form):
    """The int8 split pair at width 1024, 16 heads, 257 tokens, 2 frames,
    against its plain versions on the same card inputs; the attention half
    also at 321 tokens."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    gen = torch.Generator().manual_seed(17)
    cfg = dataclasses.replace(clip_vit.VIT_L14, layers=1)
    blk = clip_vit.prepare_int8_params(clip_vit.init_clip_vision(gen, cfg))["blocks"][0]
    for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                blk["mlp"]["c_proj"]):
        lin["b"] = randn(gen, *lin["b"].shape, scale=0.05)
    blk = _to(blk, dev, torch.bfloat16)
    frames, tokens, w = 2, 257, 1024
    h = randn(gen, frames, tokens, w).to(dev, torch.bfloat16)
    if form == "mlp":
        got = eb.fused_encoder_mlp_block(h, blk["ln_2"], blk["mlp"], int8_gemm=True)
        want = eb.fused_encoder_mlp_block_plain(h, blk["ln_2"], blk["mlp"], int8_gemm=True)
        assert rel_err(got, want) <= REL
        return
    rows8 = form == "rows8_stacked"
    outs = []
    for fn in (eb.fused_encoder_attn_block, eb.fused_encoder_attn_block_plain):
        into = None
        if form != "plain":
            kv_dt = torch.int8 if rows8 else torch.bfloat16
            into = (torch.zeros(2, frames, 256, w, dtype=kv_dt, device=dev),
                    torch.zeros(2, frames, 256, w, dtype=kv_dt, device=dev), 1, 2)
        outs.append(fn(h, blk["ln_1"], blk["attn"], 16, 64, export=form != "plain",
                       drop_cls=True, export_into=into, int8_gemm=True, kv_rows8=rows8))
    got, want = outs
    if form == "plain":
        assert rel_err(got, want) <= REL
        return
    assert rel_err(got[0], want[0]) <= REL
    for i in (1, 2):
        if rows8:
            int8_close(got[i][1], want[i][1])
        else:
            assert rel_err(got[i][1], want[i][1]) <= REL
    # above 320 tokens the attention stage is the same kernel
    from dfd_clip_tpu_torch.ops import _cuda

    h321 = randn(gen, 1, 321, w).to(dev, torch.bfloat16)
    _cuda.reset_launches()
    got = eb.fused_encoder_attn_block(h321, blk["ln_1"], blk["attn"], 16, 64, int8_gemm=True)
    assert _cuda.launches().get("encoder_attention") == 1
    want = eb.fused_encoder_attn_block_plain(h321, blk["ln_1"], blk["attn"], 16, 64,
                                             int8_gemm=True)
    assert rel_err(got, want) <= REL


TINY_TOWERS = {  # name: (foundation, width, heads, op_mode, launches)
    "dinov2": ("dinov2", 128, 2, {}, {"fused_encoder_attention": 2}),
    "vit_l_class_bf16": ("clip", 1024, 16, {}, {"fused_encoder_attention_qkv": 2}),
    "vit_l_class_int8": ("clip", 1024, 16, {"compute_int8": 1},
                         {"fused_encoder_attn_block": 3, "fused_encoder_mlp_block": 2}),
}


@pytest.mark.parametrize("tower", list(TINY_TOWERS))
def test_tiny_wide_tower_predict_on_card(dev, tower):
    """A 3-layer tower of head_dim 64 (keep 0 and 2) end to end through the
    kernels, against the same params through the plain versions in bf16 on
    the CPU."""
    from dfd_clip_tpu_torch.models import clip_vit
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.ops import _cuda

    foundation, width, heads, op_mode, launches = TINY_TOWERS[tower]
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"foundation": foundation, "decode_mode": "index",
                              "decode_indices": [0, 2], "out_dim": [2],
                              "op_mode": {"temporal_position": 1, **op_mode}})
    patch = 14 if foundation == "dinov2" else 16
    tiny = clip_vit.ViTConfig(input_resolution=2 * patch, patch_size=patch, width=width,
                              layers=3, heads=heads, output_dim=32)

    def build(device):
        det = Detector(cfg, num_frames=4, compute_dtype=torch.bfloat16, device=device)
        det.vit_cfg = tiny
        det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
        det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=width, heads=heads)
        return det

    card, cpu = build(dev), build("cpu")
    params = cpu.init_params(torch.Generator().manual_seed(4))
    x = np.random.default_rng(0).integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    _cuda.reset_launches()
    got = card.predict(card.prepare_params(params), x, m)[0][0]
    counts = _cuda.launches()
    assert {k: counts.get(k, 0) for k in launches} == launches
    want = cpu.predict(cpu.prepare_params(params), x, m)[0][0]
    assert rel_err(got.cpu(), want) <= 5e-2


# -- the encoder's alternative paths --------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "qk"])
@pytest.mark.parametrize("tokens", [17, 197, 257, 321, 577, 1025])
def test_encoder_attention_int8_on_card(dev, tokens, mode):
    """csrc/encoder_attention_s8.cu against attn_int8_cols_plain on the same
    card inputs, 3 frames of 12 heads, counted under its own name (one
    kernel at every token count: the item's key blocks resident up to 640
    tokens, re-staged above). The plain version repeats the f32
    operations; a P value on a rounding boundary may still quantise one step
    apart (sums in another order), so besides the 2e-2 bound at most 2 % of
    the rows may differ by more than 1e-4."""
    _int8_attention_case(dev, tokens, 12, 3, mode)


def _int8_attention_case(dev, tokens, heads, frames, mode):
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import attention as att

    gen = torch.Generator().manual_seed(tokens)
    qkv = randn(gen, frames * tokens, 3 * heads * 64).to(dev, torch.bfloat16)
    _cuda.reset_launches()
    got = att.encoder_attention_int8(qkv, frames, tokens, heads, 64, qk_only=mode == "qk")
    assert _cuda.launches() == {"encoder_attention_int8": 1}
    want = att.attn_int8_cols_plain(qkv, frames, tokens, heads, 64, qk_only=mode == "qk")
    assert got.dtype == torch.float32 and got.shape == (frames * tokens, heads * 64)
    assert rel_err(got, want) <= REL
    rows = ((got - want).abs().amax(-1) / want.abs().max()).cpu()
    assert (rows > 1e-4).float().mean().item() <= 2e-2


@pytest.mark.parametrize("mode", ["1", "qk"])
@pytest.mark.parametrize("tokens,heads,frames", [(257, 16, 3), (197, 12, 24), (577, 16, 24),
                                                 (1025, 12, 24)])
def test_encoder_attention_int8_items_on_card(dev, tokens, heads, frames, mode):
    """The int8 attention at ViT-L/14's 16 heads, and on 24 frames: more than
    two work items, (frame, head) pairs, to each persistent block (one a SM),
    so that query tiles are dealt across items and the ring refills item
    after item, resident (197, 577 tokens) and re-staged (1025). Held as
    above."""
    if frames > 3:
        assert frames * heads > 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    _int8_attention_case(dev, tokens, heads, frames, mode)


@pytest.mark.parametrize("geo", list(GEMM_GEOMETRIES))
@pytest.mark.parametrize("form", ["f32_out_bf16_residual", "f32_residual"])
def test_gemm_wide_forms_ragged(dev, form, geo):
    """The bf16 whole block's two products: an f32 output with the bf16 h
    added in f32 (out-projection), and the f32 hmid added before the one
    bf16 rounding (c_proj); at each geometry of GEMM_GEOMETRIES."""
    from dfd_clip_tpu_torch.ops import _cuda

    g = GEMM_GEOMETRIES[geo]
    gen = torch.Generator().manual_seed(30)
    m, k, n = g["frames"] * g["tokens"], g["k"], g["n"]
    a = gemm_rows(gen, dev, m, k, g["pad"])
    b = randn(gen, k, n, scale=k ** -0.5).to(dev, torch.bfloat16)
    bias = randn(gen, n, scale=0.1).to(dev)
    acc = a.float() @ b.float() + bias
    if form == "f32_out_bf16_residual":
        res = randn(gen, m, n).to(dev, torch.bfloat16)
        got = _cuda.gemm(a, b, bias, residual=res, residual_before_cast=True,
                         out_dtype=torch.float32)
        assert got.dtype == torch.float32
        want = res.float() + acc
    else:
        res = randn(gen, m, n).to(dev)
        got = _cuda.gemm(a, b, bias, residual=res)
        assert got.dtype == torch.bfloat16
        want = (res + acc).to(torch.bfloat16)
    assert rel_err(got, want) <= (1e-5 if got.dtype == torch.float32 else REL)


def test_layer_norm_rows_f32_rows(dev):
    from dfd_clip_tpu_torch.models.layers import layer_norm
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(31)
    x = randn(gen, 37, 200, scale=3.0).to(dev)
    ln = {"scale": randn(gen, 200).to(dev), "bias": randn(gen, 200).to(dev)}
    got = _cuda.layer_norm_rows(x, ln["scale"], ln["bias"])
    assert got.dtype == torch.bfloat16
    assert rel_err(got, layer_norm(ln, x).to(torch.bfloat16)) <= REL


def _flagship_blocks(gen, dev, layers, int8, width=768):
    """``layers`` ViT-B/16-width blocks (12 heads of 64) with LayerNorms and
    biases off their init values, on the card (bf16 weights, and the int8
    ones with ``int8``)."""
    from dfd_clip_tpu_torch.models import clip_vit

    cfg = dataclasses.replace(clip_vit.VIT_B16, width=width, heads=width // 64, layers=layers)
    params = clip_vit.init_clip_vision(gen, cfg)
    for blk in params["blocks"]:
        for ln in (blk["ln_1"], blk["ln_2"]):
            ln["scale"].add_(randn(gen, width, scale=0.1))
            ln["bias"].add_(randn(gen, width, scale=0.1))
        for lin in (blk["attn"]["in_proj"], blk["attn"]["out_proj"], blk["mlp"]["c_fc"],
                    blk["mlp"]["c_proj"]):
            lin["b"].add_(randn(gen, *lin["b"].shape, scale=0.02))
    if int8:
        params = clip_vit.prepare_int8_params(params)
    return [_to(b, dev, torch.bfloat16) for b in params["blocks"]]


def test_fused_encoder_block_bf16_on_card(dev):
    """The bf16 whole block (width 256, 4 heads, 17 tokens, 5 frames) with
    the stacked export and 7 pad rows, against its plain version."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import encoder_block as eb

    gen = torch.Generator().manual_seed(32)
    (blk,) = _flagship_blocks(gen, dev, 1, False, width=256)
    frames, tokens, w = 5, 17, 256
    h = randn(gen, frames, tokens, w).to(dev, torch.bfloat16)
    outs = []
    _cuda.reset_launches()
    for fn in (eb.fused_encoder_block, eb.fused_encoder_block_plain):
        into = (torch.full((2, frames, 23, w), float("nan"), dtype=torch.bfloat16, device=dev),
                torch.full((2, frames, 23, w), float("nan"), dtype=torch.bfloat16, device=dev),
                1, 2)
        outs.append(fn(h, blk["ln_1"], blk["attn"], blk["ln_2"], blk["mlp"], 4, 64, export=True,
                       drop_cls=True, export_into=into, int8_gemm=False, kv_pad=7))
    counts = _cuda.launches()
    assert counts["fused_encoder_block"] == 1 and counts["gemm"] == 4
    got, want = outs
    assert rel_err(got[0], want[0]) <= REL
    for i in (1, 2):
        assert rel_err(got[i][1], want[i][1]) <= REL
        assert torch.isnan(got[i][0].float()).all()
        assert torch.equal(got[i][1, :, tokens - 1:], torch.zeros_like(got[i][1, :, tokens - 1:]))


TOWER_MODES = {  # name: (int8_gemm, int8_attn, width, tokens, frames, chunk)
    "bf16": (False, "0", 768, 197, 334, 332),
    "int8": (True, "0", 768, 197, 334, 332),
    "int8_attn1": (True, "1", 768, 197, 334, 332),
    "int8_qk": (True, "qk", 768, 197, 334, 332),
    "vit_l_int8_attn1": (True, "1", 1024, 257, 257, 255),   # JAX's gate takes int8 ViT-L too
    # ViT-L/14@336px: the int8 attention's streamed body, chunks of 113 and 2
    "vit_l336_int8": (True, "0", 1024, 577, 115, 113),
    "vit_l336_int8_attn1": (True, "1", 1024, 577, 115, 113),
    "vit_l336_int8_qk": (True, "qk", 1024, 577, 115, 113),
}


@pytest.mark.parametrize("mode", list(TOWER_MODES))
def test_tower_on_card(dev, mode):
    """A 3-layer tower, keep (1, 2), at ViT-B/16 width (12 heads, 197
    tokens, 334 frames: one chunk of 332 and a short one of 2), at ViT-L/14
    width (16 heads, 257 tokens, 257 frames: 255 and 2) and at
    ViT-L/14@336px's (577 tokens, 115 frames: 113 and 2). One launch, against
    the per-layer kernel chain (whole blocks and last_only), whose bodies
    the tower's stages run, held to 1e-3 of the max with 99 % of the values
    equal in every mode, and against its plain version."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import encoder_block as eb
    from dfd_clip_tpu_torch.ops import tower

    int8, attn, w, tokens, frames, chunk = TOWER_MODES[mode]
    heads = w // 64
    gen = torch.Generator().manual_seed(33)
    blocks = _flagship_blocks(gen, dev, 3, int8, width=w)
    assert _cuda.tower_chunk(frames, tokens) == chunk
    h = randn(gen, frames, tokens, w).to(dev, torch.bfloat16)
    _cuda.reset_launches()
    k, v = tower.fused_encoder_tower(h, blocks, heads, 64, keep=(1, 2), drop_cls=True,
                                     int8_gemm=int8, int8_attn=attn)
    assert _cuda.launches() == {"fused_encoder_tower": 1}
    assert k.shape == v.shape == (2, frames, tokens - 1, w)
    # the per-layer kernels
    kc = torch.empty_like(k)
    vc = torch.empty_like(v)
    h1 = eb.fused_encoder_block(h, blocks[0]["ln_1"], blocks[0]["attn"], blocks[0]["ln_2"],
                                blocks[0]["mlp"], heads, 64, int8_gemm=int8, int8_attn=attn)
    h2, _, _ = eb.fused_encoder_block(h1, blocks[1]["ln_1"], blocks[1]["attn"],
                                      blocks[1]["ln_2"], blocks[1]["mlp"], heads, 64,
                                      export=True, drop_cls=True, export_into=(kc, vc, 0, 2),
                                      int8_gemm=int8, int8_attn=attn)
    eb.fused_encoder_attn_block(h2, blocks[2]["ln_1"], blocks[2]["attn"], heads, 64,
                                drop_cls=True, last_only=True, export_into=(kc, vc, 1, 2),
                                int8_gemm=int8)
    for got, chain in ((k, kc), (v, vc)):
        assert rel_err(got, chain) <= 1e-3
        assert (got == chain).float().mean().item() >= 0.99
    kp, vp = tower.fused_encoder_tower_plain(h, blocks, heads, 64, keep=(1, 2), drop_cls=True,
                                             int8_gemm=int8, int8_attn=attn)
    assert rel_err(k, kp) <= 5e-2 and rel_err(v, vp) <= 5e-2


@pytest.mark.parametrize("tokens,int8,attn", [(17, False, "0"), (577, True, "0"),
                                              (577, True, "1"), (577, True, "qk")])
def test_tower_grid_that_cannot_be_co_resident_raises(dev, tokens, int8, attn):
    """A grid larger than the co-resident one is refused before launch: no
    fallback, nothing runs, nothing is counted; at 17 tokens in bf16 and at
    577 (the streamed attention stages) in each int8 attention mode."""
    from dfd_clip_tpu_torch.ops import _cuda, tower

    gen = torch.Generator().manual_seed(34)
    blocks = _flagship_blocks(gen, dev, 2, int8, width=256)
    h = randn(gen, 2, tokens, 256).to(dev, torch.bfloat16)
    co_resident = _cuda.tower_grid(tokens, int8, attn)
    assert co_resident >= torch.cuda.get_device_properties(dev).multi_processor_count
    layers = [tower._layer(b, torch.bfloat16, int8) for b in blocks]
    _cuda.reset_launches()
    with pytest.raises(RuntimeError, match="co-resident"):
        _cuda.encoder_tower(h, layers, 4, first=0, lo=1, int8=int8, attn=attn,
                            grid=co_resident + 1)
    torch.cuda.synchronize()
    assert _cuda.launches() == {}
    k, _ = _cuda.encoder_tower(h, layers, 4, first=0, lo=1, int8=int8, attn=attn,
                               grid=co_resident)
    assert torch.isfinite(k.float()).all()


# -- the 577-token slice and the tools' kernels ---------------------------------------------

def test_decoder_attention_at_vit_l14_336(dev):
    """The serving decoder attention over ViT-L/14@336px's export: 16 heads,
    L = 20 x 576 = 11,520 keys, slot 3 of a 6-layer stack, one sample partly
    and one fully masked."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import (
        fused_decoder_attention,
        fused_decoder_attention_plain,
    )

    qs, qc, k, v, pos, mask = decoder_inputs(dev, torch.Generator().manual_seed(40), 4, 16,
                                             11520, False)
    k = torch.stack([k] * 6)
    v = torch.stack([v] * 6)
    got = fused_decoder_attention(qs, qc, k, v, mask, pos, layer=3)
    want = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer=3)
    assert rel_err(got[:3], want[:3]) <= 1e-2
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("frames", [1, 3, 133])
@pytest.mark.parametrize("tokens", [1, 5, 16, 17, 64, 65, 197, 256])
@pytest.mark.parametrize("mode", ["f32", "bf16", "diet", "diet_nomax"])
def test_study_attention_modes(dev, mode, tokens, frames):
    """csrc/study_attention.cu in each numerics mode against its plain
    version, 12 heads: one key block or several, the N = 16 tail (17, 65,
    197), whole blocks (16, 64, 256), the f32 mode's ragged bands; 133
    frames is more work items than SMs, so each persistent block takes
    several; counted."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import study_attention as sa

    gen = torch.Generator().manual_seed(41 + tokens + frames)
    q, k, v = (randn(gen, frames, tokens, 12, 64).to(dev, torch.bfloat16) for _ in range(3))
    _cuda.reset_launches()
    got = sa.study_attention(q, k, v, mode)
    assert _cuda.launches() == {"study_attention": 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert rel_err(got, sa.study_attention_plain(q, k, v, mode)) <= REL
    with pytest.raises(ValueError):
        sa.study_attention(q, k, v, "tf32")


@pytest.mark.parametrize("rows,width,layers", [
    (1000, 768, 3), (64, 128, 1), (333, 256, 12),
    (127, 768, 2), (128, 768, 2), (129, 768, 2),   # a 128-row panel's and a cluster's edges
    (320, 384, 3),      # 3 panels: the second cluster of two holds one
    (129, 640, 2),      # a half-empty third column tile
    # more units than co-resident clusters: a CTA's next unit starts while its
    # last layer is being stored (narrow widths: one or two tiles a layer)
    (20000, 128, 2), (40000, 128, 5), (40000, 256, 3), (40000, 384, 2),
    (63040, 768, 12),   # the probe's shape
])
def test_gemm_chain_entries(dev, rows, width, layers):
    """The probe's two entries are bit-equal, and within REL of the plain
    chain; ragged row counts (not multiples of 128), panels and clusters cut
    at their edges, widths whose last 256-column tile is half empty, CTAs
    that walk several units at narrow widths, the probe's full shape;
    counted. The megakernel's launch geometry (read from the kernel's
    source through chain_geometry) covers the rows."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import gemm_chain as gc

    geo = _cuda.chain_geometry(rows, width, layers)
    assert geo["panels"] == -(-rows // 128) and geo["units"] == -(-geo["panels"] // 2)
    assert geo["tiles"] == -(-width // 256)
    assert geo["grid"] == 2 * min(geo["units"], geo["clusters"])
    assert geo["smem"] <= _cuda.SMEM_LIMIT
    assert (geo["units"] > geo["clusters"]) == (rows >= 20000)
    gen = torch.Generator().manual_seed(42 + rows)
    h = randn(gen, rows, width).to(dev, torch.bfloat16)
    ws = randn(gen, layers, width, width, scale=width ** -0.5).to(dev, torch.bfloat16)
    _cuda.reset_launches()
    a = gc.gemm_chain_per_layer(h, ws)
    b = gc.gemm_chain_megakernel(h, ws)
    assert _cuda.launches() == {"gemm_chain_per_layer": layers, "gemm_chain_megakernel": 1}
    assert torch.equal(a, b)
    assert rel_err(b, gc.gemm_chain_plain(h, ws)) <= REL
    with pytest.raises(ValueError):
        _cuda.gemm_chain(h[:, :96].contiguous(), ws[:, :96, :96].contiguous())
    with pytest.raises(ValueError):
        _cuda.gemm_chain_layer(h[:, :96].contiguous(), ws[0, :96, :96].contiguous())


# -- the decoder attention split over chunks of L; the persistent layer_norm_quant --------

@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("l", [1, 65, 4000, 11520])
@pytest.mark.parametrize("form", ["bf16", "partials", "int8"])
def test_decoder_attention_split(dev, form, l, heads):
    """csrc/decoder_attention.cu (chunks of 64 tokens, then their merge in
    chunk order) against its plain version at slot 1 of a stack: L = 1
    (one ragged chunk), 65 (one past a chunk), ViT-B's 4,000 and ViT-L@336's
    11,520; sample 1 partly masked, the second chunk masked in every sample
    where L has one, the last sample fully masked (exact 0; partials 0, 0,
    -1e30); int8 K/V with scales that differ across tokens. Two calls are
    bit-equal (the merge order is fixed)."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import (
        fused_decoder_attention,
        fused_decoder_attention_plain,
    )
    from dfd_clip_tpu_torch.ops.int8 import quant_kv_rows_plain

    b = 3
    gen = torch.Generator().manual_seed(50 + l + heads)
    qs, qc, k, v, pos, mask = decoder_inputs(dev, gen, b, heads, l, True)
    chunk = _cuda.decoder_split(l, heads)["chunk"]
    mask[:, chunk: 2 * chunk] = False
    kw = dict(partials=form == "partials")
    if form == "int8":
        rows = [t * (1 + randn(gen, 2, b, l, 1, 1, scale=0.5).abs().to(dev)) for t in (k, v)]
        (kq, ks), (vq, vs) = (quant_kv_rows_plain(t.reshape(2, b, l, heads * 64).float())
                              for t in rows)
        k, v = kq.reshape(k.shape), vq.reshape(v.shape)
        kw = dict(k_scale=ks, v_scale=vs)
        assert l == 1 or ks[1, 0].std().item() > 0
    _cuda.reset_launches()
    got = fused_decoder_attention(qs, qc, k, v, mask, pos, 1, **kw)
    again = fused_decoder_attention(qs, qc, k, v, mask, pos, 1, **kw)
    assert _cuda.launches() == {("fused_decoder_attention_int8" if form == "int8"
                                 else "fused_decoder_attention"): 2}
    want = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, 1, **kw)
    if form == "partials":
        (o_sc, st), (o_p, st_p) = got, want
        assert torch.equal(o_sc, again[0]) and torch.equal(st, again[1])
        assert rel_err(o_sc[: b - 1], o_p[: b - 1]) <= 1e-2
        assert rel_err(st[: b - 1], st_p[: b - 1]) <= 1e-2
        assert torch.equal(o_sc[b - 1], torch.zeros_like(o_sc[b - 1]))
        assert torch.equal(st[b - 1, 0], torch.zeros_like(st[b - 1, 0]))
        assert torch.equal(st[b - 1, 1], torch.full_like(st[b - 1, 1], -1e30))
    else:
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        assert rel_err(got[: b - 1], want[: b - 1]) <= 1e-2
        assert torch.equal(got[b - 1], torch.zeros_like(got[b - 1]))


@pytest.mark.parametrize("width", [64, 256, 768, 1024])
@pytest.mark.parametrize("rows", [1, 7, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_quant_rows(dev, dtype, rows, width):
    """The persistent layer_norm_quant (one warp a row, scale and shift in
    registers, the next row in flight) on rows of a view 8 values wider than
    the row, f32 (LN2's hmid) and bf16 (LN1's h), against its plain route:
    fewer rows than a block's warps, one more, and widths of 1 to 4
    256-wide chunks."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops.int8 import layer_norm_f32, quant_rows_plain

    gen = torch.Generator().manual_seed(60 + rows + width)
    x = randn(gen, rows, width + 8, scale=2.0).to(dev, dtype)[:, :width]
    ln = {"scale": (1 + randn(gen, width, scale=0.3)).to(dev),
          "bias": randn(gen, width, scale=0.1).to(dev)}
    _cuda.reset_launches()
    q, s = _cuda.layer_norm_quant(x, ln["scale"], ln["bias"])
    assert _cuda.launches() == {"layer_norm_quant": 1}
    q_p, s_p = quant_rows_plain(layer_norm_f32(ln, x))
    int8_close(q, q_p)
    assert rel_err(s, s_p.reshape(-1)) <= 1e-5


TOL_DECODER = 1e-2   # chip_smoke.py's hold of the decoder against its plain version


@pytest.mark.parametrize("rows", [1, 12, 16, 17])
@pytest.mark.parametrize("width", [64, 256, 768, 1024])
@pytest.mark.parametrize("form", ["first", "middle", "last"])
def test_decoder_boundary_one_launch(dev, form, width, rows):
    """decoder_boundary on the card: one launch of csrc/decoder_boundary.cu a
    call in each form, at the test configurations' and the models' decoder
    widths and at 1, 12, 16 and 17 rows (a partial 16-row tile, one tile, one
    past it); held against decoder_boundary_plain at TOL_DECODER and, link
    by link, against the six-launch chain of gemm and layer_norm_rows that it
    replaced, each link fed the kernel's own input: the two keep the same
    rounding points and differ only in the f32 order of a product's sums, so
    at least 99 % of the values are bit-equal (all but one below 200
    values) and the rest within one bf16 ulp of their row's largest
    magnitude (two after QuickGELU: tools/bench_decoder_boundary.py's
    chain_links). (End to end, a value that an early link rounds the other way
    moves its row's LayerNorm and so a few per cent of that row's later
    values by an ulp: chip_smoke.py prints that share.) Two calls give the
    same bits."""
    from dfd_clip_tpu_torch.ops import _cuda
    from dfd_clip_tpu_torch.ops import decoder_stack as ds
    from dfd_clip_tpu_torch.tools.bench_decoder_boundary import form_args, hold_links

    gen = torch.Generator().manual_seed(70 + width + rows)
    bf = torch.bfloat16

    def lin(k, n):
        return {"w": randn(gen, k, n, scale=k ** -0.5).to(dev, bf),
                "b": randn(gen, n, scale=0.05).to(dev)}

    def ln():
        return {"scale": (1 + randn(gen, width, scale=0.3)).to(dev),
                "bias": randn(gen, width, scale=0.1).to(dev)}

    tail = {"attn_out_proj": lin(width, width), "ln_2": ln(),
            "mlp": {"c_fc": lin(width, 4 * width), "c_proj": lin(4 * width, width)}}
    query = {"ln_1": ln(), "in_proj": lin(width, 2 * width)}
    x = randn(gen, rows, width).to(dev, bf)
    o = randn(gen, rows, width).to(dev, bf)
    args = form_args(form, x, o, tail, query)
    _cuda.reset_launches()
    got = ds.decoder_boundary(*args)
    assert _cuda.launches() == {"decoder_boundary": 1}
    again = ds.decoder_boundary(*args)
    want = ds.decoder_boundary_plain(*args)
    for g, a, p in zip(got, again, want):
        if p is None:   # the absent half
            assert g is None and a is None
            continue
        assert g.dtype == bf and g.shape == p.shape and torch.equal(g, a)
        assert rel_err(g, p) <= TOL_DECODER
    differ, total = hold_links(got, args)
    assert differ <= max(1, total // 100), f"{differ} of {total} values differ"


@pytest.mark.parametrize("width", [32, 64, 384, 768, 1024, 1536])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 63040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_rows_persistent(dev, dtype, rows, width):
    """The persistent layer_norm_rows (a warp a row, the row and, up to 1024
    values, scale and shift in registers, the next row in flight) on rows of
    a view 8 values wider than the row, f32 (the bf16 whole block's hmid) and
    bf16: fewer rows than a block's warps, one more, ViT-B/16's 63,040 rows,
    and widths of 1 to 6 256-wide chunks with a masked last chunk (32, 64,
    384, 1536), against layers.layer_norm."""
    from dfd_clip_tpu_torch.models.layers import layer_norm
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(80 + rows % 97 + width)
    x = randn(gen, rows, width + 8, scale=2.0).to(dev, dtype)[:, :width]
    ln = {"scale": (1 + randn(gen, width, scale=0.3)).to(dev),
          "bias": randn(gen, width, scale=0.1).to(dev)}
    _cuda.reset_launches()
    got = _cuda.layer_norm_rows(x, ln["scale"], ln["bias"])
    assert _cuda.launches() == {"layer_norm_rows": 1}
    assert got.dtype == torch.bfloat16 and got.shape == (rows, width)
    assert rel_err(got, layer_norm(ln, x).to(torch.bfloat16)) <= REL
