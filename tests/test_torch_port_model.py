"""The PyTorch port's model path (dfd_clip_tpu_torch on the CPU) against the
JAX package: clip_vision_kv, apply_decoder, Detector.predict and the
per-video scoring loop, each against the XLA composition and against the
Pallas kernels in interpret mode (DFD_ATTENTION_BACKEND=pallas, and
DFD_DEC_STACK=force for the decoder's boundary chain).

Tolerance: atol = rtol = 1e-4 in float32 (conftest sets the JAX matmul
precision to "highest"), except where a test states otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import decoder as jdec
from dfd_clip_tpu_torch.config import CN
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import decoder as tdec
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.scoring import resolve_deepfake_task, score_frames
from dfd_clip_tpu_torch.serve import Scorer

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def use_backend(monkeypatch, reference):
    if reference == "pallas":
        monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
        monkeypatch.setenv("DFD_DEC_STACK", "force")
    else:
        monkeypatch.setenv("DFD_ATTENTION_BACKEND", "xla")
        monkeypatch.setenv("DFD_DEC_STACK", "0")


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["ViT-Test", "ViT-Test-Wide"])
@pytest.mark.parametrize("pad_tokens", [False, True])
def test_clip_vision_kv_matches_jax(rng, monkeypatch, reference, arch, pad_tokens):
    """keep_layers (0, 1): the last kept layer runs last_only and layer 2 is
    skipped; drop_cls; pad_tokens zero-pads 4 patches to 8 rows."""
    use_backend(monkeypatch, reference)
    cfg = jvit.ARCHITECTURES[arch]
    params = jvit.init_clip_vision(jax.random.key(3), cfg)
    x = rng.standard_normal((3, 3, cfg.input_resolution, cfg.input_resolution)).astype(np.float32)
    keep = (0, 1)
    want = jvit.clip_vision_kv(params, jnp.asarray(x), cfg, compute_dtype=jnp.float32,
                               keep_layers=keep, drop_cls=True, pad_tokens=pad_tokens)
    got = tvit.clip_vision_kv(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                              torch.from_numpy(x), tvit.ARCHITECTURES[arch],
                              compute_dtype=torch.float32, keep_layers=keep, drop_cls=True,
                              pad_tokens=pad_tokens)
    for s in ("k", "v"):
        assert tuple(got[s].shape) == want[s].shape
        close(got[s], want[s])
    if pad_tokens:
        assert torch.equal(got["k"][:, :, 4:], torch.zeros_like(got["k"][:, :, 4:]))


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("global_prediction", [False, True])
def test_apply_decoder_matches_jax(rng, monkeypatch, reference, global_prediction):
    """Padded export (P = 8 rows, 5 real: patch_valid), one sample with a
    masked frame, temporal position on."""
    use_backend(monkeypatch, reference)
    cfg = jdec.DecoderConfig(width=128, heads=2, num_frames=3, layer_indices=(0, 1),
                             out_dims=(2, 3), global_prediction=global_prediction)
    params = jdec.init_decoder(jax.random.key(0), cfg)
    kvs = {s: rng.standard_normal((2, 2, 3, 8, 2, 64)).astype(np.float32) for s in ("k", "v")}
    m = np.array([[True, True, True], [True, True, False]])
    want_logits, want_feat = jdec.apply_decoder(
        params, {s: jnp.asarray(a) for s, a in kvs.items()}, jnp.asarray(m), cfg,
        patch_valid=5)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    got_logits, got_feat = tdec.apply_decoder(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        {s: torch.from_numpy(a) for s, a in kvs.items()}, torch.from_numpy(m), tcfg,
        patch_valid=5)
    close(got_feat, want_feat)
    assert len(got_logits) == len(want_logits) == 2
    for g, w in zip(got_logits, want_logits):
        close(g, w)


def tiny_port_detector(num_frames: int = 4) -> Detector:
    """The port's counterpart of tests/fixtures.py:tiny_detector."""
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"]})
    det = Detector(cfg, num_frames=num_frames, compute_dtype=torch.float32, device="cpu")
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    det.vit_cfg = tiny
    det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
    det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width, heads=tiny.heads)
    return det


@pytest.fixture(scope="module")
def detectors():
    from fixtures import tiny_detector

    jdet = tiny_detector(num_frames=4)
    jparams = jdet.init_params(jax.random.key(0))
    tdet = tiny_port_detector(num_frames=4)
    tparams = tdet.prepare_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return jdet, jparams, tdet, tparams


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_detector_predict_matches_jax(rng, monkeypatch, detectors, reference, uint8):
    """The whole slice on the tiny_detector weights: float frames, and uint8
    frames of another size through preprocess (bicubic resize + crop)."""
    use_backend(monkeypatch, reference)
    jdet, jparams, tdet, tparams = detectors
    if uint8:
        x = rng.integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
    else:
        x = rng.standard_normal((2, 4, 3, 32, 32)).astype(np.float32)
    m = np.array([[True] * 4, [True, True, False, False]])
    want, _ = jdet.predict(jparams, jnp.asarray(x), jnp.asarray(m))
    got, _ = tdet.predict(tparams, x, m)
    assert len(got) == len(want) == 1
    close(got[0], want[0])
    close(torch.linalg.vector_norm(got[0], dim=-1), np.full(2, 5.0))


def test_score_frames_matches_jax_windowing(rng, detectors):
    """score_frames on one decoded frame array (13 frames: three 4-frame
    windows, the last frame dropped) against the same windowing, padding to
    batch_size 2 and mean softmax P(fake) computed over JAX predict."""
    jdet, jparams, tdet, tparams = detectors
    frames = rng.integers(0, 256, (13, 40, 48, 3), dtype=np.uint8)
    shapes = []

    def port_predict(p, x, m):
        shapes.append(x.shape)
        return tdet.predict(p, x, m)[0][0]

    got = score_frames(frames, port_predict, tparams, num_frames=4, batch_size=2)
    assert len(shapes) == 2 and len(set(shapes)) == 1, shapes

    chw = frames.transpose(0, 3, 1, 2)
    clips = np.stack([chw[i: i + 4] for i in (0, 4, 8)])
    logits = []
    for i in (0, 2):
        x = clips[i: i + 2]
        valid = len(x)
        x = np.concatenate([x, np.repeat(x[-1:], 2 - valid, 0)])
        out = jdet.predict(jparams, jnp.asarray(x), jnp.ones((2, 4), bool))[0][0]
        logits.append(np.asarray(out)[:valid])
    p = jax.nn.softmax(jnp.asarray(np.concatenate(logits)), axis=-1)
    assert got == pytest.approx(float(p[:, 1].mean()), abs=1e-5)


def test_scorer_answers_requests(rng, detectors):
    _, _, tdet, tparams = detectors
    scorer = Scorer(tdet, tparams, batch_size=2)
    for n in (5, 8, 13):
        s = scorer.score_frames(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        assert 0.0 <= s <= 1.0
    with pytest.raises(ValueError):
        scorer.score_frames(np.zeros((3, 32, 32, 3), np.uint8))


def test_resolve_deepfake_task_matches_jax():
    from dfd_clip_tpu import scoring as jscoring
    from dfd_clip_tpu.config import CN as JCN

    cases = [{"data": {"train": [{"category": "rPPG"}, {"category": "Deepfake"}]}},
             {"data": {"train": [{"category": "Deepfake"}]}}, {}]
    for c in cases:
        assert resolve_deepfake_task(CN(c, new_allowed=True)) == \
            jscoring.resolve_deepfake_task(JCN(c, new_allowed=True))


def test_config_merges_like_jax():
    from dfd_clip_tpu.models.detector import Detector as JDetector

    over = {"decode_mode": "index", "decode_indices": [6, 7], "out_dim": [2],
            "op_mode": {"temporal_position": 0, "global_prediction": 1}}
    got = Detector.get_default_config().merge_from_other_cfg(over)
    want = JDetector.get_default_config().merge_from_other_cfg(over)
    assert got.to_dict() == want.to_dict()
    assert got.op_mode.get("global_prediction") == 1 and got.get("missing", 3) == 3
