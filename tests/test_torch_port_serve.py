"""The port's serving entry (dfd_clip_tpu_torch.serve and what it reaches) on
the CPU against the JAX package: the synthetic video backend, score_video,
the checkpoint layout both ways (params_to_jax / params_from_jax, a
port-written best_weights.pt read by JAX's load_model_params), the CLIP and
DINOv2 torch-checkpoint converters, Scorer.from_run_dir against JAX's
serve.Scorer on one run directory, the HTTP handler's endpoints and codes,
yuv420_to_rgb, and Detector.predict with patch_indices.

Both packages run the ViT-Test geometry in float32 (both Scorers and both
inference.main build their Detector with the default compute dtype, which
these tests set to float32; conftest sets the JAX matmul precision to
"highest"), the JAX side through its XLA compositions. Tolerances:
* synthetic frames, the checkpoint trees and the converters' arrays:
  exactly equal;
* the DINOv2 positional embedding resized to another grid: within 1e-6 (the
  same f32 weights, summed in another order);
* P(fake) and predict logits: atol = rtol = 1e-4; with compute_int8 and
  int8_rows K/V, logits within 1e-2 (a quantiser's rounding boundary moves
  a value by one quantum; tests/test_torch_port_int8.py);
* yuv420_to_rgb: within 1 everywhere, at least 99.9 % of the values equal
  (a product summed in another order can cross a .5 rounding boundary).
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfd_clip_tpu.config import CN as JCN
from dfd_clip_tpu.models import detector as jdetector
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu_torch.data import video as tvideo
from dfd_clip_tpu_torch.models import weights as tweights
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.serve import Scorer, make_handler

TOL = dict(rtol=1e-4, atol=1e-4)
MODEL = {"foundation": "clip", "architecture": "ViT-Test", "decode_mode": "index",
         "decode_indices": [0, 2], "out_dim": [2], "losses": ["auc_roc"]}
NUM_FRAMES, CLIP_DURATION = 4, 1.0


def jax_f32(mp):
    """JAX's Scorer and inference.main build their Detector with the default
    compute dtype: float32 here, and the XLA compositions."""
    mp.setattr(jdetector.Detector.__init__, "__defaults__", (jnp.float32,))
    mp.setenv("DFD_ATTENTION_BACKEND", "xla")
    mp.setenv("DFD_DEC_STACK", "0")


def port_f32(mp):
    """The port's Scorer constructors and inference.main build their
    Detector with the default compute dtype: float32 here."""
    mp.setattr(Detector.__init__, "__defaults__",
               (torch.float32, *Detector.__init__.__defaults__[1:]))


def jax_params(seed: int = 1):
    cfg = jdetector.Detector.get_default_config().merge_from_other_cfg(MODEL)
    det = jdetector.Detector(cfg, NUM_FRAMES, compute_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, det.init_params(jax.random.key(seed)))


def write_run_dir(root: Path, eval_sets=(), seed: int = 1) -> dict:
    """A training run's directory as JAX's main.py leaves it: setting.yaml
    (the ViT-Test model, ``model.pretrained`` a framework-native encoder
    pickle, ``data.eval`` = ``eval_sets``), best_weights.pt with the decoder.
    Returns the JAX params (numpy)."""
    root.mkdir(parents=True, exist_ok=True)
    params = jax_params(seed)
    jweights.save_params(str(root / "encoder.pt"), {"backbone": params["encoder"]})
    jweights.save_params(str(root / "best_weights.pt"),
                         {"trainable": {"decoder": params["decoder"]}, "steps": 0})
    setting = {"data": {"num_frames": NUM_FRAMES, "clip_duration": CLIP_DURATION,
                        "train": [{"name": "FFPP", "category": "Deepfake"}],
                        "eval": list(eval_sets)},
               "model": {**MODEL, "pretrained": str(root / "encoder.pt")}}
    (root / "setting.yaml").write_text(yaml.safe_dump(setting))
    return params


def assert_trees_equal(got, want, where="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, (int, float)):
        assert got == want, where
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        w = np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (where, g.shape, w.shape, g.dtype)
        assert np.array_equal(g, w), where


# -- the synthetic backend and score_video -----------------------------------

@pytest.mark.parametrize("url", ["synthetic://7?fps=25&duration=3&size=40",
                                 "synthetic://123456?fps=29.97&duration=1.97&size=224"])
def test_synthetic_frames_equal_jax(url):
    from dfd_clip_tpu.data import video as jvideo

    times = list(np.arange(0, 1.9, 0.13))
    got_b, want_b = tvideo.backend_for_path(url), jvideo.backend_for_path(url)
    assert got_b.probe(url).__dict__ == want_b.probe(url).__dict__
    got, want = got_b.read_frames(url, times), want_b.read_frames(url, times)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)


def test_video_backends_by_name():
    """"auto" resolves to the native decoder where it can be built, else
    (for want of the toolchain, the one error "native" then raises) to
    opencv; synthetic URLs take the synthetic backend whatever is asked;
    an unknown name raises."""
    from dfd_clip_tpu_torch.data.native_video import NativeToolchainMissing

    try:
        native = tvideo.get_backend("native")
    except NativeToolchainMissing:
        native = None
    want = tvideo.OpenCVBackend if native is None else tvideo.NativeBackend
    assert isinstance(tvideo.get_backend(), want)
    assert tvideo.backend_name() == want.__name__
    assert isinstance(tvideo.backend_for_path("synthetic://1", "opencv"),
                      tvideo.SyntheticBackend)
    assert isinstance(tvideo.backend_for_path("/x.avi", "opencv"), tvideo.OpenCVBackend)
    with pytest.raises(ValueError):
        tvideo.get_backend("ffmpeg")


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX predict_fn, params) and (port predict_fn, params) of one
    ViT-Test detector."""
    from test_torch_port_model import tiny_port_detector

    from fixtures import tiny_detector

    jdet = tiny_detector(num_frames=NUM_FRAMES)
    jparams = jdet.init_params(jax.random.key(2))
    tdet = tiny_port_detector(num_frames=NUM_FRAMES)
    tparams = tdet.prepare_params(tweights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    jpredict = jax.jit(lambda p, x, m: jdet.predict(p, x, m)[0][0])
    return (jpredict, jparams), (lambda p, x, m: tdet.predict(p, x, m)[0][0], tparams)


@pytest.mark.parametrize("url,duration", [
    ("synthetic://5?fps=25&duration=3&size=40", 1.0),
    # 49 frames (round(1.97 x 25)); the times 1.95 s and later map to index
    # 49 and are dropped by the backend's own time-to-index rule
    ("synthetic://6?fps=25&duration=1.97&size=32", 0.2),
])
def test_score_video_matches_jax(monkeypatch, tiny_pair, url, duration):
    from dfd_clip_tpu import scoring as jscoring
    from dfd_clip_tpu_torch import scoring as tscoring

    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "xla")
    monkeypatch.setenv("DFD_DEC_STACK", "0")
    (jpredict, jparams), (tpredict, tparams) = tiny_pair
    kw = dict(num_frames=NUM_FRAMES, clip_duration=duration, batch_size=3)
    want = jscoring.score_video(url, jpredict, jparams, **kw)
    got = tscoring.score_video(url, tpredict, tparams, **kw)
    np.testing.assert_allclose(got, want, **TOL)


# -- checkpoints ---------------------------------------------------------------

def test_params_to_jax_round_trip():
    """JAX tree -> port -> JAX and port -> JAX -> port, exactly; a whole
    checkpoint's nesting ({"trainable": ..., "steps": n}) converts too."""
    want = jax_params(3)
    port = tweights.params_from_jax(want)
    assert_trees_equal(tweights.params_to_jax(port), want)
    assert_trees_equal(tweights.params_from_jax(tweights.params_to_jax(port)), port)
    state = tweights.params_to_jax({"trainable": {"decoder": port["decoder"]},
                                    "backbone": port["encoder"], "steps": 7})
    assert_trees_equal(state, {"trainable": {"decoder": want["decoder"]},
                               "backbone": want["encoder"], "steps": 7})


def test_port_checkpoint_read_by_jax(tmp_path):
    """A best_weights.pt the port writes is what JAX's load_model_params
    reads into the same arrays, and the port's load_model_params into the
    same params."""
    from inference import load_model_params as jload

    from dfd_clip_tpu_torch.inference import load_model_params as tload

    want = jax_params(4)
    port = tweights.params_from_jax(want)
    tweights.save_params(str(tmp_path / "best_weights.pt"),
                         {"trainable": {"decoder": port["decoder"]}, "steps": 0})
    cfg = jdetector.Detector.get_default_config().merge_from_other_cfg(MODEL)
    jdet = jdetector.Detector(cfg, NUM_FRAMES, compute_dtype=jnp.float32)
    jdet.pretrained_encoder = want["encoder"]
    got = jax.tree_util.tree_map(np.asarray, jload(jdet, str(tmp_path), "best"))
    assert_trees_equal(got, want)

    tdet = Detector(Detector.get_default_config().merge_from_other_cfg(MODEL), NUM_FRAMES,
                    compute_dtype=torch.float32, device="cpu")
    tdet.pretrained_encoder = port["encoder"]
    assert_trees_equal(tload(tdet, str(tmp_path), "best"), port)


def dinov2_state_dict(width=32, layers=2, patch=14, grid=2, seed=1):
    """A DINOv2 state dict in Meta's naming (tests/test_weights.py's)."""
    torch.manual_seed(seed)
    sd = {"patch_embed.proj.weight": torch.randn(width, 3, patch, patch),
          "patch_embed.proj.bias": torch.randn(width), "cls_token": torch.randn(1, 1, width),
          "mask_token": torch.randn(1, width),
          "pos_embed": torch.randn(1, grid * grid + 1, width),
          "norm.weight": torch.randn(width), "norm.bias": torch.randn(width)}
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": torch.randn(width), f"{b}.norm1.bias": torch.randn(width),
            f"{b}.attn.qkv.weight": torch.randn(3 * width, width),
            f"{b}.attn.qkv.bias": torch.randn(3 * width),
            f"{b}.attn.proj.weight": torch.randn(width, width),
            f"{b}.attn.proj.bias": torch.randn(width), f"{b}.ls1.gamma": torch.randn(width),
            f"{b}.norm2.weight": torch.randn(width), f"{b}.norm2.bias": torch.randn(width),
            f"{b}.mlp.fc1.weight": torch.randn(4 * width, width),
            f"{b}.mlp.fc1.bias": torch.randn(4 * width),
            f"{b}.mlp.fc2.weight": torch.randn(width, 4 * width),
            f"{b}.mlp.fc2.bias": torch.randn(width), f"{b}.ls2.gamma": torch.randn(width)})
    return sd


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_clip_converter_matches_jax(tmp_path, rng, prefix):
    from test_weights import _tiny_clip_state_dict

    from dfd_clip_tpu_torch.models import clip_vit as tvit

    torch.manual_seed(0)
    path = str(tmp_path / "clip.pt")
    torch.save(_tiny_clip_state_dict(rng, prefix=prefix), path)
    want, want_cfg = jweights.load_clip_visual(path)
    got, got_cfg = tweights.load_clip_visual(path)
    assert isinstance(got_cfg, tvit.ViTConfig)
    assert got_cfg.__dict__ == want_cfg.__dict__
    assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("src_grid,res", [(2, 28), (2, 56), (4, 28)],
                         ids=["same_grid", "grow_2_to_4", "shrink_4_to_2"])
def test_dinov2_converter_matches_jax(tmp_path, src_grid, res):
    from dfd_clip_tpu.models import clip_vit as jvit
    from dfd_clip_tpu_torch.models import clip_vit as tvit

    path = str(tmp_path / "dinov2.pth")
    torch.save(dinov2_state_dict(grid=src_grid), path)
    geo = dict(input_resolution=res, patch_size=14, width=32, layers=2, heads=2, output_dim=32)
    want = jax.tree_util.tree_map(np.asarray, jweights.load_dinov2(path, jvit.ViTConfig(**geo)))
    got = tweights.load_dinov2(path, tvit.ViTConfig(**geo))
    pos, want_pos = got.pop("positional_embedding"), want.pop("positional_embedding")
    assert pos.shape == want_pos.shape == ((res // 14) ** 2 + 1, 32)
    np.testing.assert_allclose(pos, want_pos, rtol=0, atol=0 if res // 14 == src_grid else 1e-6)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("foundation", ["clip", "dinov2"])
def test_load_pretrained_encoder_torch_checkpoint_matches_jax(tmp_path, rng, foundation):
    """model.pretrained a torch checkpoint: both packages convert it; the
    port's encoder is params_from_jax of JAX's."""
    from main import load_pretrained_encoder as jload

    from dfd_clip_tpu_torch.inference import load_pretrained_encoder as tload
    from test_weights import _tiny_clip_state_dict

    path = str(tmp_path / "foundation.pt")
    if foundation == "clip":
        torch.manual_seed(0)
        torch.save(_tiny_clip_state_dict(rng, width=64, layers=3), path)
    else:
        torch.save(dinov2_state_dict(grid=2), path)
    cfg = {"foundation": foundation, "architecture": "ViT-Test", "decode_mode": "index",
           "decode_indices": [0, 1], "out_dim": [2], "pretrained": path}
    jcfg = jdetector.Detector.get_default_config().merge_from_other_cfg(cfg)
    jdet = jdetector.Detector(jcfg, NUM_FRAMES, compute_dtype=jnp.float32)
    jwrap = JCN(new_allowed=True)
    jwrap.model = jcfg
    jload(jdet, jwrap)
    from dfd_clip_tpu_torch.config import CN

    tcfg = Detector.get_default_config().merge_from_other_cfg(cfg)
    tdet = Detector(tcfg, NUM_FRAMES, compute_dtype=torch.float32, device="cpu")
    twrap = CN(new_allowed=True)
    twrap.model = tcfg
    tload(tdet, twrap)
    assert_trees_equal(tdet.pretrained_encoder, tweights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdet.pretrained_encoder)))


# -- the run-directory Scorer and its HTTP handler ------------------------------

@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    """One run directory; JAX's serve.Scorer and the port's
    Scorer.from_run_dir (CPU, float32, opencv) on it."""
    import serve as jserve

    root = tmp_path_factory.mktemp("run")
    write_run_dir(root)
    with pytest.MonkeyPatch.context() as mp:
        jax_f32(mp)
        port_f32(mp)
        mp.setenv("DFD_VIDEO_BACKEND", "opencv")
        want = jserve.Scorer(str(root), batch_size=2)
        got = Scorer.from_run_dir(str(root), batch_size=2, device="cpu",
                                  video_backend="opencv")
        yield root, want, got


def test_scorer_from_run_dir_matches_jax(scorers):
    root, want, got = scorers
    assert got.model.device.type == "cpu" and got.clip_duration == CLIP_DURATION
    assert got.task == 0 and got.batch_size == 2
    for url in ("synthetic://11?fps=25&duration=3&size=48",
                "synthetic://12?fps=30&duration=2&size=32"):
        np.testing.assert_allclose(got.score_video(url), want.score_video(url), **TOL)


def post(port, endpoint, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{endpoint}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_http_handler_endpoints(scorers):
    """/healthz, /score_path on a cv2-written video and on a synthetic://
    path, /score with the video's bytes, 404 for an unknown endpoint, 400
    with an error string for a missing video; each P(fake) within 1e-4 of
    JAX's Scorer on the same video."""
    from fixtures import write_video

    root, want, got = scorers
    vid = str(root / "probe.avi")
    write_video(vid, 60, fps=25.0, size=48, seed=42)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(got))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404 and "error" in json.loads(e.value.read())

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DFD_VIDEO_BACKEND", "opencv")
            jax_f32(mp)
            p_file = want.score_video(vid)
        syn = "synthetic://3?fps=25&duration=2&size=32"
        p_syn = want.score_video(syn)
        for endpoint, body, p in (
                ("/score_path", json.dumps({"path": vid}).encode(), p_file),
                ("/score", Path(vid).read_bytes(), p_file),
                ("/score_path", json.dumps({"path": syn}).encode(), p_syn)):
            status, payload = post(port, endpoint, body)
            assert status == 200 and sorted(payload) == ["p_fake"]
            np.testing.assert_allclose(payload["p_fake"], p, **TOL)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/score_path", json.dumps({"path": "/nonexistent.avi"}).encode())
        assert e.value.code == 400
        assert isinstance(json.loads(e.value.read())["error"], str)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/nope", b"{}")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


# -- yuv420_to_rgb and predict(patch_indices) ------------------------------------

@pytest.mark.parametrize("full_range", [True, False], ids=["full", "limited"])
def test_yuv420_to_rgb_matches_jax(rng, full_range):
    from dfd_clip_tpu.ops.image_ops import yuv420_to_rgb as jyuv
    from dfd_clip_tpu_torch.ops.image_ops import yuv420_to_rgb as tyuv

    y = rng.integers(0, 256, (3, 64, 48), dtype=np.uint8)
    u = rng.integers(0, 256, (3, 32, 24), dtype=np.uint8)
    v = rng.integers(0, 256, (3, 32, 24), dtype=np.uint8)
    want = np.asarray(jyuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), full_range))
    got = tyuv(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v), full_range)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (3, 3, 64, 48)
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("kv_dtype", ["auto", "int8_rows"])
def test_predict_patch_indices_matches_jax(rng, monkeypatch, kv_dtype):
    """Three of ViT-Test's 4 patches a kept layer (L = 4 frames x 3 = 12
    keys, not a multiple of 8), chosen per layer; the f32 export, and
    compute_int8 with int8_rows K/V (their scales gathered alike) against
    the Pallas kernels interpreted, as tests/test_torch_port_int8.py runs
    them."""
    from test_torch_port_int8 import tiny_int8_port_detector

    from fixtures import tiny_detector

    int8 = kv_dtype == "int8_rows"
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas" if int8 else "xla")
    monkeypatch.setenv("DFD_DEC_STACK", "force" if int8 else "0")
    op_mode = {"temporal_position": 1}
    if int8:
        op_mode.update(compute_int8=1, kv_dtype="int8_rows")
    jdet = tiny_detector(num_frames=NUM_FRAMES, op_mode=op_mode)
    jparams = jdet.init_params(jax.random.key(5))
    tdet = tiny_int8_port_detector(op_mode)
    tparams = tdet.prepare_params(tweights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    idx = np.stack([rng.choice(4, 3, replace=False) for _ in range(2)])
    x = rng.integers(0, 256, (2, NUM_FRAMES, 3, 40, 48), dtype=np.uint8)
    m = np.array([[True] * 4, [True, True, False, False]])
    want, _ = jdet.predict(jdet.prepare_params(jparams), jnp.asarray(x), jnp.asarray(m),
                           patch_indices=jnp.asarray(idx))
    got, _ = tdet.predict(tparams, x, m, patch_indices=idx)
    full, _ = tdet.predict(tparams, x, m)
    assert not torch.allclose(got[0], full[0])       # the gather changed the keys
    if int8:
        assert np.abs(got[0].float().numpy() - np.asarray(want[0])).max() <= 1e-2
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
