"""The port's encoder-analysis CLIs (python -m dfd_clip_tpu_torch.tools.analysis)
against the JAX package's tools/analysis.py on the CPU: the tower's
q/k/v/out export against JAX's ``_export_qkv_out`` (on the XLA composition
and with the Pallas attention interpreted), each subcommand's pickle
against JAX's on the same fixture tree, weights (a synthetic CLIP checkpoint
under misc/), seed and arguments at atol = rtol = 1e-4, the guide map fed to
the port's Detector, and ``--device cuda`` raising without a card. Each
package runs in a working directory of its own under the test's
``tmp_path`` (the video-table cache is relative to it).
"""

import pickle
import sys
from os import path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, path.join(path.dirname(path.dirname(__file__)), "tools"))

import analysis as janalysis  # noqa: E402
from dfd_clip_tpu.models import clip_vit as jvit  # noqa: E402
from dfd_clip_tpu_torch.models import clip_vit as tvit  # noqa: E402
from dfd_clip_tpu_torch.models.weights import params_from_jax  # noqa: E402
from dfd_clip_tpu_torch.tools import analysis as tanalysis  # noqa: E402
from fixtures import make_ffpp_tree  # noqa: E402
from test_torch_port_zero_shot import vit_sd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRID, LAYERS = 2, 3   # ViT-Test: 32 px / patch 16, 3 layers


@pytest.fixture(scope="module")
def ffpp_root(tmp_path_factory):
    return make_ffpp_tree(str(tmp_path_factory.mktemp("ffpp")))


@pytest.fixture
def workdirs(tmp_path, monkeypatch):
    """tmp_path/jax and tmp_path/port, each with misc/ViT-Test.pt (one
    synthetic CLIP checkpoint, heads inferred as width // 64)."""
    sd = vit_sd(np.random.default_rng(5), tvit.ARCHITECTURES["ViT-Test"])
    dirs = {}
    for side in ("jax", "port"):
        (tmp_path / side / "misc").mkdir(parents=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / side / "misc" / "ViT-Test.pt")
        dirs[side] = tmp_path / side
    return dirs


def common(root):
    return ["--root", root, "--arch", "ViT-Test", "--types", "REAL", "DF",
            "--num-frames", "4", "--clip-duration", "2"]


def run_both(monkeypatch, workdirs, argv_of):
    """JAX's main, then the port's (``--device cpu``), each in its own
    directory; ``argv_of(side_dir)`` builds the arguments."""
    monkeypatch.chdir(workdirs["jax"])
    janalysis.main(argv_of(workdirs["jax"]))
    monkeypatch.chdir(workdirs["port"])
    tanalysis.main(argv_of(workdirs["port"]) + ["--device", "cpu"])


def load(p):
    with open(p, "rb") as f:
        return pickle.load(f)


def assert_close_trees(got, want):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(g, w):
        assert np.shape(a) == np.shape(b)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_extract_features_matches_jax(rng, monkeypatch, reference):
    """The port's export (f32 on the CPU) against JAX's jitted
    _export_qkv_out, on the XLA composition and with the Pallas attention
    kernel interpreted."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    cfg = jvit.ARCHITECTURES["ViT-Test"]
    params = jvit.init_clip_vision(jax.random.key(4), cfg)
    frames = rng.integers(0, 256, (4, 3, 40, 48), dtype=np.uint8)
    jax.clear_caches()
    try:
        want = janalysis.extract_features(params, cfg, jnp.asarray(frames))
    finally:
        jax.clear_caches()
    got = tanalysis.extract_features(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                            params)),
                                     tvit.ARCHITECTURES["ViT-Test"], frames)
    assert set(got) == set(want) == set(tanalysis.SUBJECTS)
    for s in got:
        assert got[s].dtype == np.float32 and got[s].shape == (LAYERS, 4, GRID * GRID, 64)
        np.testing.assert_allclose(got[s], want[s], **TOL)


def test_kv_dist_matches_jax(ffpp_root, workdirs, monkeypatch):
    run_both(monkeypatch, workdirs, lambda d: ["kv-dist", *common(ffpp_root), "--index", "1",
                                               "--patch-loc", "0,1", "--out-dir",
                                               str(d / "out")])
    got = load(workdirs["port"] / "out" / "kv_distribution.pickle")
    want = load(workdirs["jax"] / "out" / "kv_distribution.pickle")
    assert set(got) == {"c23"}
    assert got["c23"]["similarity"]["q"][0].shape == (GRID, 4 * GRID)
    assert_close_trees(got, want)


def test_semantic_patches_matches_jax(ffpp_root, workdirs, monkeypatch):
    run_both(monkeypatch, workdirs, lambda d: ["semantic-patches", *common(ffpp_root),
                                               "--num-samples", "3", "--subjects", "k", "out",
                                               "--out", str(d / "sem.pickle")])
    got, want = load(workdirs["port"] / "sem.pickle"), load(workdirs["jax"] / "sem.pickle")
    assert set(got) == {"k", "out"} and set(got["k"]) == set(tanalysis.SEMANTIC_LOCATIONS)
    assert len(got["k"]["eyes"]) == LAYERS and got["k"]["eyes"][0].shape == (64,)
    assert_close_trees(got, want)


def test_augment_impact_and_comb_impact_match_jax(ffpp_root, workdirs, monkeypatch):
    settings = ["dev-mode+force-rgb", "compression", "any"]
    run_both(monkeypatch, workdirs, lambda d: ["augment-impact", *common(ffpp_root),
                                               "--compressions", "raw", "c23",
                                               "--settings", *settings, "--num-samples", "2",
                                               "--out-dir", str(d)])
    for s in settings:
        got, want = load(workdirs["port"] / f"{s}.pickle"), load(workdirs["jax"] / f"{s}.pickle")
        assert set(got) == {"k", "v"} and len(got["k"]) == LAYERS
        assert got["k"][0].shape == (GRID, GRID) and got["k"][0].dtype == np.float32
        assert_close_trees(got, want)
    run_both(monkeypatch, workdirs, lambda d: [
        "comb-impact", "--inputs", *[str(d / f"{s}.pickle") for s in settings],
        "--weights", "0.5", "0.25", "1.0", "--invert-last", "--complement",
        "--out", str(d / "guide_map.pickle")])
    got = load(workdirs["port"] / "guide_map.pickle")
    assert_close_trees(got, load(workdirs["jax"] / "guide_map.pickle"))
    for s in ("k", "v"):
        for m in got[s]:
            assert m.dtype == np.float64
            np.testing.assert_allclose(m.sum(), 1.0, rtol=1e-9)


def test_comb_impact_refuses_a_map_that_sums_to_zero(ffpp_root, tmp_path, monkeypatch):
    """A named augmentation's two draws of one clip are equal (the datasets'
    randomness is keyed by index), so its maps are 0. comb-impact refuses
    them and writes no guide map, where 0 / 0 would give a NaN prior."""
    monkeypatch.chdir(tmp_path)
    setting = "dev-mode+force-rgb"
    tanalysis.main(["augment-impact", *common(ffpp_root), "--device", "cpu", "--settings",
                    setting, "--num-samples", "1", "--out-dir", str(tmp_path)])
    maps = load(tmp_path / f"{setting}.pickle")
    assert all(not m.any() for s in ("k", "v") for m in maps[s])
    guide = tmp_path / "guide_map.pickle"
    with pytest.raises(SystemExit, match="cannot be a sampling prior"):
        tanalysis.main(["comb-impact", "--inputs", str(tmp_path / f"{setting}.pickle"),
                        "--weights", "1.0", "--out", str(guide), "--device", "cpu"])
    assert not guide.exists()


def test_guide_map_feeds_the_port_detector(ffpp_root, tmp_path, monkeypatch):
    """The port's comb-impact output is a prior for the port Detector's
    patch_mask type "guide"."""
    from test_torch_port_multirank import port_detector

    monkeypatch.chdir(tmp_path)
    common_args = [*common(ffpp_root), "--device", "cpu"]
    tanalysis.main(["augment-impact", *common_args, "--settings", "any", "--num-samples", "1",
                    "--out-dir", str(tmp_path)])
    guide = str(tmp_path / "guide_map.pickle")
    tanalysis.main(["comb-impact", "--inputs", str(tmp_path / "any.pickle"), "--weights", "1.0",
                    "--out", guide, "--device", "cpu"])
    det = port_detector(train_mode={"patch_mask": {"type": "guide", "ratio": 0.5,
                                                   "path": guide}})
    assert det.guide_map is not None and len(det.guide_map["v"]) == LAYERS
    idx = np.asarray(det.sample_patch_indices(np.random.default_rng(0)))
    assert idx.size and (idx >= 0).all() and (idx < GRID * GRID).all()


def test_default_device_is_the_card(ffpp_root, tmp_path, monkeypatch):
    """--device defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tanalysis.main(["kv-dist", *common(ffpp_root), "--out-dir", str(tmp_path)])
    assert not (tmp_path / "kv_distribution.pickle").exists()


def test_corrupt_clip_is_resampled_and_a_kernel_error_is_not(ffpp_root, tmp_path,
                                                           monkeypatch):
    """A decode failure (the video backends' IOError) is resampled; an
    error from the tower is never caught."""
    monkeypatch.chdir(tmp_path)
    real_fetch = tanalysis.fetch_clip
    calls = []

    def flaky(ds, idx):
        calls.append(idx)
        if len(calls) == 1:
            raise IOError("decode failure at frame 0")
        return real_fetch(ds, idx)

    monkeypatch.setattr(tanalysis, "fetch_clip", flaky)
    argv = ["semantic-patches", *common(ffpp_root), "--num-samples", "2", "--device", "cpu",
            "--out", str(tmp_path / "sem.pickle")]
    tanalysis.main(argv)
    assert len(calls) == 2 and (tmp_path / "sem.pickle").exists()

    def broken(*a, **k):
        raise RuntimeError("encoder_attention_packed: CUDA error 700 at launch")

    monkeypatch.setattr(tvit, "encoder_self_attention_qkv", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tanalysis.main(argv)
