"""The port's evaluation entry (dfd_clip_tpu_torch.inference and what it
reaches) on the CPU against the JAX package: the metric calculators, the
DataLoader's index streams, the FFPP / CDF / DFDC items and video-table
caches on cv2-written fixture trees, and inference.main against JAX's
inference.main on one run directory in both modalities.

Both packages run ViT-Test in float32 through the opencv backend (JAX's
Detector with its default compute dtype set to float32 and its XLA
compositions; conftest sets the JAX matmul precision to "highest"). Each
test chdirs into its tmp_path: the video-table cache is CWD-relative.
Tolerances: metrics, index streams, dataset items and caches exactly equal;
inference.main's per-video (or per-clip) probabilities within 1e-4 with
equal labels, and its report exactly what JAX's metrics give on the port's
stats.
"""

import argparse
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from dfd_clip_tpu.data import datasets as jds
from dfd_clip_tpu.data.loader import DataLoader as JLoader
from dfd_clip_tpu.utils import metrics as jmetrics
from dfd_clip_tpu_torch.data import datasets as tds
from dfd_clip_tpu_torch.data.loader import DataLoader as TLoader
from dfd_clip_tpu_torch.utils import metrics as tmetrics

from fixtures import make_cdf_tree, make_ffpp_tree, write_video


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["accuracy", "roc_auc", "mse", "rmse"])
def test_metrics_equal_jax(rng, name):
    """Three batches, ties in the scores (roc_auc's average ranks), a
    140-bin distribution head for rmse; compute() twice (it resets)."""
    got, want = getattr(tmetrics, name)(), getattr(jmetrics, name)()
    for _ in range(2):
        for n in (7, 1, 12):
            if name == "rmse":
                probs = rng.dirichlet(np.ones(140), n)
                labels = rng.uniform(0, 139, n)
            elif name == "mse":
                probs = rng.standard_normal((n, 3))
                labels = rng.standard_normal((n, 3))
            else:
                probs = np.round(rng.dirichlet(np.ones(2), n), 1)   # ties
                labels = rng.integers(0, 2, n)
            for calc in (got, want):
                calc.add_batch(probs.argmax(-1) if probs.ndim == 2 else None, probs, labels)
        assert got.compute() == want.compute()
    assert tmetrics.METRICS.keys() == jmetrics.METRICS.keys()


# -- the loader ------------------------------------------------------------------

class Items:
    """A map-style dataset of (index, index / 2, flag) items that records
    the epochs it is told."""

    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(2, i, np.int64), i / 2, bool(i % 2)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def stream(loader, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([[np.asarray(part).tolist() for part in batch] for batch in loader])
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=3),
    dict(batch_size=4, shuffle=True, seed=5, drop_last=True),
    dict(batch_size=2, shuffle=True, seed=1, num_shards=3, shard_index=2),
    dict(batch_size=5, shuffle=True, num_workers=2, num_shards=2, shard_index=0),
    dict(batch_size=1, collate_fn=lambda b: b[0]),
], ids=["plain", "shuffle_drop_last", "shards", "workers", "collate_fn"])
def test_loader_streams_equal_jax(kw):
    got_ds, want_ds = Items(23), Items(23)
    got, want = TLoader(got_ds, **kw), JLoader(want_ds, **kw)
    assert len(got) == len(want)
    assert stream(got) == stream(want)
    got.set_position(4, 2)
    want.set_position(4, 2)
    assert stream(got, 1) == stream(want, 1)
    assert got_ds.epochs == want_ds.epochs == [0, 1, 4]


# -- datasets ----------------------------------------------------------------------

def make_dfdc_tree(root: str, n_videos: int = 3, duration_s: float = 3.0) -> str:
    """DFDC layout: videos/<name>.avi and csv_files/test.csv rows
    '<name>.avi <label>'."""
    rows = []
    for i in range(2 * n_videos):
        write_video(f"{root}/videos/v{i}.avi", int(duration_s * 25), 25.0, 48, seed=200 + i)
        rows.append(f"v{i}.avi {i % 2}")
    Path(root, "csv_files").mkdir(parents=True, exist_ok=True)
    Path(root, "csv_files", "test.csv").write_text("\n".join(rows))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {"ffpp": make_ffpp_tree(str(base / "ffpp")), "cdf": make_cdf_tree(str(base / "cdf")),
            "dfdc": make_dfdc_tree(str(base / "dfdc"))}


def dataset_cfg(cls, root, **over):
    cfg = cls.get_default_config()
    cfg.root_dir = root
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def assert_items_equal(got, want, where="item"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_items_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), where
    else:
        assert got == want, where


CASES = {
    "ffpp_pack": ("FFPP", "ffpp", "test", dict(types=["REAL", "DF"], pack=1)),
    "ffpp_pair": ("FFPP", "ffpp", "test",
                  dict(types=["REAL", "DF"], compressions=["raw", "c23"], pair=1)),
    "ffpp_train_speed": ("FFPP", "ffpp", "train", dict(types=["REAL", "DF"])),
    "ffpp_contrast": ("FFPP", "ffpp", "train", dict(types=["REAL", "DF"], contrast=1)),
    "ffpp_contrast_pair": ("FFPP", "ffpp", "train",
                           dict(types=["REAL", "DF"], contrast=1, contrast_pair=1)),
    "cdf": ("CDF", "cdf", "test", {}),
    "cdf_pack": ("CDF", "cdf", "test", dict(pack=1)),
    "dfdc_pack": ("DFDC", "dfdc", "test", dict(pack=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_items_equal_jax(tmp_path, monkeypatch, trees, case):
    """Every item (and, unpacked, the collated batch) equals JAX's; the
    video-table caches have JAX's file names and pickle contents."""
    name, tree, split, over = CASES[case]
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    kw = dict(split=split, index=1, seed=3)
    made = {}
    for pkg, mod, extra in (("jax", jds, {}), ("port", tds, {"video_backend": "opencv"})):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        cls = getattr(mod, name)
        made[pkg] = cls(dataset_cfg(cls, trees[tree], **over), 4, 1.0, **kw, **extra)
    got, want = made["port"], made["jax"]
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_items_equal(got[i], want[i], f"{case}[{i}]")
    if not got.pack:
        batch = [got[i] for i in range(min(3, len(got)))]
        assert_items_equal(got.collate_fn(batch), want.collate_fn(batch), f"{case} batch")
    caches = {pkg: sorted((tmp_path / pkg / ".cache/dfd-clip/videos").iterdir())
              for pkg in made}
    assert [p.name for p in caches["port"]] == [p.name for p in caches["jax"]]
    for a, b in zip(caches["port"], caches["jax"]):
        assert pickle.loads(a.read_bytes()) == pickle.loads(b.read_bytes())


@pytest.mark.parametrize("over", [dict(ssl_fake=1), dict(augmentation="normal")],
                         ids=["ssl_fake", "augmentation"])
def test_ffpp_training_augmentation_raises(tmp_path, monkeypatch, trees, over):
    """data/augment.py is not ported: FFPP's ssl_fake and any training
    augmentation raise; the test split ignores augmentation, as in JAX."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="augment"):
        tds.FFPP(dataset_cfg(tds.FFPP, trees["ffpp"], **over), 4, 1.0, split="train",
                 video_backend="opencv")
    if "augmentation" in over:
        tds.FFPP(dataset_cfg(tds.FFPP, trees["ffpp"], **over), 4, 1.0, split="test",
                 video_backend="opencv")


# -- inference.main ---------------------------------------------------------------

def eval_set(name, root, **over):
    return {"name": name, "category": "Deepfake", "root_dir": root, **over}


@pytest.mark.parametrize("modality", ["video", "clip"])
def test_inference_main_matches_jax(tmp_path, monkeypatch, trees, modality):
    """One run directory (FFPP's REAL/DF raw and CDF in setting.yaml, a
    second CDF and DFDC through --aux_file), JAX's inference.main and the
    port's on copies of it, batch 3 (short batches padded)."""
    import shutil

    import inference as jinf
    import yaml

    from dfd_clip_tpu_torch import inference as tinf
    from test_torch_port_serve import jax_f32, port_f32, write_run_dir

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("API_TOKEN", raising=False)   # JAX's run notifies nobody
    monkeypatch.delenv("CHAT_ID", raising=False)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    jax_f32(monkeypatch)
    port_f32(monkeypatch)
    run = tmp_path / "run_jax"
    write_run_dir(run, [eval_set("FFPP", trees["ffpp"], types=["REAL", "DF"]),
                        eval_set("CDF", trees["cdf"]),
                        {"name": "FFPP", "category": "rPPG", "root_dir": "/nowhere"}])
    aux = tmp_path / "aux.yaml"
    aux.write_text(yaml.safe_dump({"data": {"eval": [eval_set("CDF", trees["cdf"]),
                                                     eval_set("DFDC", trees["dfdc"])]}}))
    shutil.copytree(run, tmp_path / "run_port")
    common = ["--batch_size", "3", "--modality", modality, "--aux_file", str(aux)]
    jargs = argparse.Namespace(artifacts_dir=str(run), batch_size=3, aux_file=str(aux),
                               weight_mode="best", modality=modality, num_workers=0,
                               test=False, cfg_name="setting")
    want_report = jinf.main(jargs)
    got_report = tinf.main(tinf.parse_args([str(tmp_path / "run_port"), *common,
                                            "--num_workers", "2", "--device", "cpu",
                                            "--video_backend", "opencv"]))

    def outputs(root):
        (report,) = root.glob(f"report_*_best_{modality}.json")
        (stats,) = root.glob(f"stats_*_best_{modality}.pickle")
        return json.loads(report.read_text()), pickle.loads(stats.read_bytes())

    got_file, got_stats = outputs(tmp_path / "run_port")
    want_file, want_stats = outputs(run)
    assert got_file == got_report and want_file == want_report
    assert sorted(got_stats) == sorted(want_stats) == ["CDF", "CDF#2", "DFDC", "FFPP"]
    for key, want in want_stats.items():
        got = got_stats[key]
        assert got["label"] == want["label"] and len(got["label"]) > 0
        np.testing.assert_allclose(got["prob"], want["prob"], rtol=1e-4, atol=1e-4)
        # JAX's metrics, sentinel batch included, on the port's stats
        p1 = np.asarray(got["prob"])
        probs = np.stack([1.0 - p1, p1], -1)
        labels = np.asarray(got["label"])
        acc, auc = jmetrics.accuracy(), jmetrics.roc_auc()
        acc.add_batch(probs.argmax(-1), probs, labels)
        auc.add_batch(None, probs, labels)
        acc.add_batch(np.array([0, 1]), None, np.array([0, 1]))
        auc.add_batch(None, np.array([[1.0, 0.0], [0.0, 1.0]]), np.array([0, 1]))
        assert got_report[key] == {"accuracy": round(acc.compute()["accuracy"], 3),
                                   "roc_auc": round(auc.compute()["roc_auc"], 3)}
    n_clips = sum(len(s["label"]) for s in got_stats.values())
    assert n_clips > 2 * len(got_stats) if modality == "clip" else n_clips == 8 + 6 + 6 + 6
