"""The port's training CLI (dfd_clip_tpu_torch.main) on the CPU: tests/
test_e2e.py's configuration plus a K/V adapter and normal+frame
augmentation, ``--device cpu``, writes the run directory's four artefacts
(and checkpoints); JAX's inference.main reads that directory and agrees
with the port's inference.main per video; two runs with one seed give
equal weights; the CLI refuses what it does not port and defaults to the
card.

The frozen encoder comes from ``model.pretrained`` (a framework-native
pickle in the JAX layout), so both packages' inference read the same
tower. Both score in float32 (JAX's XLA compositions). Tolerance: per-video
P(fake) within 1e-5, equal labels; the two runs' weights bit-equal.
"""

import argparse
import json
import pickle
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_ffpp_tree
from test_torch_port_serve import jax_f32, port_f32

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import weights as jweights

ADAPTER = {"type": "normal", "struct": {"type": "768-x-768", "x": 32}}


def write_config(tmp_path, root, project=None, **system):
    jweights.save_params(str(tmp_path / "encoder.pt"), {"backbone": jax.tree_util.tree_map(
        np.asarray, jvit.init_clip_vision(jax.random.key(5), jvit.ARCHITECTURES["ViT-Test"]))})
    ffpp = {"name": "FFPP", "category": "Deepfake", "root_dir": root, "types": ["REAL", "DF"],
            "compressions": ["raw"]}
    metrics = [{"name": "deepfake/ffpp", "types": ["accuracy", "roc_auc"]}]
    cfg = {
        "system": {"mixed_precision": "no", "seed": 0, "deterministic_training": True,
                   "training_eval_interval": 2, "evaluation_interval": 2, **system},
        "tracking": {"enabled": True, "directory": str(tmp_path / "logs"),
                     "project_name": project, "main_metric": "deepfake/ffpp/roc_auc",
                     "compare_fn": "max"},
        "model": {"name": "Detector", "foundation": "clip", "architecture": "ViT-Test",
                  "decode_mode": "index", "decode_indices": [0, 2], "out_dim": [2],
                  "losses": ["auc_roc"], "dropout": 0.5, "adapter": ADAPTER,
                  "pretrained": str(tmp_path / "encoder.pt")},
        "trainer": {"name": "Trainer", "batch_size": 2, "num_workers": 0,
                    "learning_rate": 1e-2, "max_steps": 4, "checkpoint_interval": 2,
                    "metrics": metrics},
        "evaluator": {"name": "Evaluator", "batch_size": 4, "num_workers": 0,
                      "metrics": metrics},
        "data": {"num_frames": 4, "clip_duration": 2,
                 "train": [{**ffpp, "augmentation": "normal+frame", "contrast": 1}],
                 "eval": [ffpp]},
    }
    path = tmp_path / "e2e.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("API_TOKEN", raising=False)   # nobody is notified
    monkeypatch.delenv("CHAT_ID", raising=False)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    return tmp_path, make_ffpp_tree(str(tmp_path / "ffpp"), compressions=("raw",))


def run_main(cfg):
    from dfd_clip_tpu_torch import main as tmain

    return tmain.main(tmain.parse_args(["--cfg", cfg, "--device", "cpu",
                                        "--video_backend", "opencv"]))


def test_main_writes_the_run_directory_and_both_inferences_read_it(env, monkeypatch):
    """The run directory under tracking.directory holds setting.yaml,
    best_weights.pt, last_weights.pt (with the adapter), metrics.jsonl
    (training and evaluation lines) and checkpoints/ (steps 2 and 4); JAX's
    inference.main and the port's read it and agree per video."""
    import inference as jinf

    from dfd_clip_tpu_torch import inference as tinf

    tmp_path, root = env
    run = run_main(write_config(tmp_path, root, project="e2e"))
    assert run.startswith(str(tmp_path / "logs" / "e2e"))
    names = {p.name for p in (tmp_path / "logs").glob("e2e/*/*")}
    assert {"setting.yaml", "best_weights.pt", "last_weights.pt", "metrics.jsonl",
            "checkpoints"} <= names
    setting = yaml.safe_load(open(f"{run}/setting.yaml"))
    assert setting["model"]["adapter"]["struct"]["type"] == "768-x-768"
    last = jweights.load_params(f"{run}/last_weights.pt")
    assert last["steps"] == 4 and set(last["trainable"]) == {"decoder", "adapter"}
    lines = [json.loads(s) for s in open(f"{run}/metrics.jsonl")]
    assert any("evaluator/metric/deepfake/ffpp/roc_auc" in r for r in lines)
    assert any("trainer/loss/deepfake/ffpp" in r for r in lines)
    assert sorted(p.name for p in (tmp_path / "logs").glob("e2e/*/checkpoints/*")) == [
        "step_00000002", "step_00000004"]

    jax_f32(monkeypatch)
    port_f32(monkeypatch)
    shutil.copytree(run, tmp_path / "run_port")   # each inference writes its own stats
    common = dict(batch_size=3, aux_file=None, weight_mode="best", modality="video",
                  num_workers=0, test=False, cfg_name="setting")
    want = jinf.main(argparse.Namespace(artifacts_dir=run, **common))
    got = tinf.main(tinf.parse_args([str(tmp_path / "run_port"), "--batch_size", "3",
                                     "--num_workers", "0", "--device", "cpu",
                                     "--video_backend", "opencv"]))
    assert sorted(got) == sorted(want) == ["FFPP"]
    (a,), (b,) = (list(Path(d).glob("stats_*_best_video.pickle"))
                  for d in (tmp_path / "run_port", run))
    a, b = (pickle.loads(p.read_bytes())["FFPP"] for p in (a, b))
    assert a["label"] == b["label"] and len(a["label"]) == 8
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=1e-5, atol=1e-5)


def test_two_runs_with_one_seed_are_equal(env):
    """version_0 and version_1 (no project name) from one configuration:
    equal last and best weights, bit for bit."""
    tmp_path, root = env
    cfg = write_config(tmp_path, root)
    runs = [run_main(cfg), run_main(cfg)]
    assert [r.rsplit("/", 1)[1] for r in runs] == ["version_0", "version_1"]
    for name in ("last_weights.pt", "best_weights.pt"):
        a, b = (jweights.load_params(f"{r}/{name}") for r in runs)
        leaves_a, leaves_b = (jax.tree_util.tree_leaves(t) for t in (a, b))
        assert len(leaves_a) == len(leaves_b) > 0
        for x, y in zip(leaves_a, leaves_b):
            np.testing.assert_array_equal(x, y)


def test_main_refuses_what_it_does_not_port_and_defaults_to_the_card(env, monkeypatch):
    """A registry name neither package has raises NotImplementedError; the
    port's registry names exactly root main.py's ten classes; without
    --device the card, which a machine without one lacks."""
    import main as jmain

    from dfd_clip_tpu_torch import main as tmain

    tmp_path, root = env
    cfg = yaml.safe_load(open(write_config(tmp_path, root)))
    cfg["trainer"]["name"] = "SSLTrainer"
    assert "SSLTrainer" not in jmain.REGISTRY
    (tmp_path / "unknown.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="SSLTrainer"):
        run_main(str(tmp_path / "unknown.yaml"))
    assert sorted(tmain.REGISTRY) == sorted(jmain.REGISTRY)
    assert tmain.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain.main(tmain.parse_args(["--cfg", str(tmp_path / "e2e.yaml")]))
