"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes the flagship run of chip_smoke.py does not reach (rows and
columns that are not tile multiples, short token counts, a short decoder
stream, the decoder attention's partials form and backward at token counts
that are not tile multiples, a whole tiny detector and a tiny trainer).

Marked ``cuda``; every test skips without a card. Run on a machine with one:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q --noconftest

Tolerance: max|kernel - plain| <= 2e-2 x max|plain| in bf16 (a few bf16
ulps of rounding-order difference), 5e-2 for a whole bf16 predict against
the f32 plain path (1e-1 for parameter updates after a bf16 forward), and
exact zeros where the contract says zero.
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


@pytest.mark.parametrize("mode", ["bias_f32", "bias_bf16_gelu", "residual", "export"])
def test_gemm_epilogues_ragged(dev, mode):
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(0)
    frames, tokens, w = 8, 25, 64
    m, k = frames * tokens, 96                     # M = 200: not a multiple of 128
    n = 3 * w if mode == "export" else 136         # N = 136: a ragged column tile
    a = randn(gen, m, k).to(dev, torch.bfloat16)
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
        assert torch.isnan(kbuf[0]).all()          # other slots untouched
        assert rel_err(kbuf[1, :, : tokens - 1], rows[..., w: 2 * w]) <= REL
        assert rel_err(vbuf[1, :, : tokens - 1], rows[..., 2 * w:]) <= REL
        return
    assert rel_err(got, want) <= REL


def test_layer_norm_rows_ragged(dev):
    from dfd_clip_tpu_torch.models.layers import layer_norm
    from dfd_clip_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(1)
    x = randn(gen, 37, 200).to(dev, torch.bfloat16)
    ln = {"scale": randn(gen, 200).to(dev), "bias": randn(gen, 200).to(dev)}
    got = _cuda.layer_norm_rows(x, ln["scale"], ln["bias"])
    assert rel_err(got, layer_norm(ln, x)) <= REL


@pytest.mark.parametrize("tokens", [5, 17, 197])
def test_encoder_attention_token_counts(dev, tokens):
    from dfd_clip_tpu_torch.ops.attention import plain_attention_qkv
    from dfd_clip_tpu_torch.ops.encoder_block import encoder_attention

    gen = torch.Generator().manual_seed(2)
    frames, heads = 3, 2
    qkv = randn(gen, frames * tokens, 3 * heads * 64).to(dev, torch.bfloat16)
    got = encoder_attention(qkv, frames, tokens, heads, 64)
    want = plain_attention_qkv(qkv.reshape(frames, tokens, -1), heads, 64)
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


@pytest.mark.parametrize("geo", DEC_GEOMETRIES, ids=["h2-l77-stacked", "h4-l200", "h12-nopos"])
def test_decoder_attention_bwd_ragged(dev, geo):
    """dq_smax, dq_coda and dpos against _bwd_math on the same stats (from
    the plain partials): L not a multiple of the 64-token tile, 2 to 12
    heads, with and without pos, stacked slot and plain K/V; the fully
    masked sample's dq is exactly 0."""
    from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention_plain
    from dfd_clip_tpu_torch.ops.fused_decoder_attention_bwd import (
        fused_decoder_attention_bwd,
        fused_decoder_attention_bwd_plain,
    )

    h, l, stacked, with_pos = geo
    gen = torch.Generator().manual_seed(6)
    qs, qc, k, v, pos, mask = decoder_inputs(dev, gen, 3, h, l, stacked)
    pos = pos if with_pos else None
    layer = 1 if stacked else None
    o_sc, st = fused_decoder_attention_plain(qs, qc, k, v, mask, pos, layer, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(3, h, 64) / denom.clamp_min(1e-30)[..., None]
    ct = randn(gen, 3, 1, h, 64).to(dev, torch.bfloat16)
    args = (qs, qc, k, v, mask, pos, layer, denom, mx, o_s, ct)
    got = fused_decoder_attention_bwd(*args)
    want = fused_decoder_attention_bwd_plain(*args)
    assert (got[2] is None) == (pos is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32
            assert rel_err(g, w) <= REL
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    assert torch.equal(got[1][2], torch.zeros_like(got[1][2]))


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
