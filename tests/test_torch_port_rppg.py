"""The cross-task mix in the PyTorch port: data/datasets.py RPPG against the
JAX package's on a MAHNOB-HCI-layout tree (Metas/*/meta.pickle,
Measures/*/data.pickle and cv2-written cropped_faces/<comp>/ videos, as
preprocessing/rppg.py lays them out), then a two-task Trainer (RPPG's
kl_div head of 140 bins and FFPP's auc_roc head) against JAX's Trainer,
in normal and in teacher mode, and the port's main on a config of
configs/cross-task/mix.yaml's shape.

Both packages read the videos through opencv and run ViT-Test in float32
(decode layers 0 and 2, 4 frames, dropout 0). Tolerances: items and
batches byte-equal; the trainers' losses and leaves atol = rtol = 1e-4
(the model hold of tests/test_torch_port_model.py).
"""

import json
import os
import pickle
from os import path
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from dfd_clip_tpu.data import datasets as jds
from dfd_clip_tpu.engine.trainer import Trainer as JTrainer
from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu.runtime import MeshRuntime
from dfd_clip_tpu_torch.data import datasets as tds
from dfd_clip_tpu_torch.engine.trainer import Trainer
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.runtime import OneProcess

from fixtures import make_ffpp_tree, write_video
from test_torch_port_train_modes import detectors

TOL = dict(rtol=1e-4, atol=1e-4)
T = 4
ROOT = Path(__file__).resolve().parents[1]


class QuietOneProcess(OneProcess):
    def print(self, *a, **k):
        pass


def make_hci_tree(root: str, n_sessions: int = 6, fps: float = 25.0, comps=("c23",)) -> str:
    """Sessions of 4 to 6 seconds, each with its meta and measures pickles
    (bpm measures every 2 s, a first one before the video begins) and a
    64-pixel cropped video per compression."""
    hr_freq = 256.0
    for i in range(n_sessions):
        sid = str(10 + i)
        duration = 4.0 + (i % 3)
        session_dir = path.join(root, "Sessions", sid)
        os.makedirs(session_dir, exist_ok=True)
        video_path = path.join(session_dir, "cam.avi")
        for comp in comps:
            write_video(video_path.replace("Sessions", path.join("cropped_faces", comp)),
                        int(duration * fps), fps=fps, size=64, seed=50 + i)
        meta = {"session_dir": session_dir, "video_path": video_path,
                "bdf_path": path.join(session_dir, "ecg.bdf"),
                "session_video_sample_freq": fps, "session_video_beg_sample": 0,
                "flag_video_beg_sample": int(fps * (i % 2)) // 5,
                "session_hr_sample_freq": hr_freq, "flag_hr_beg_sample": 13 * i,
                "duration": duration}
        for folder, name, obj in (
                ("Metas", "meta.pickle", meta),
                ("Measures", "data.pickle",
                 {"idx": [int(hr_freq * t) for t in (0.5, 2.5, 4.5, 6.5, 8.5)],
                  "data": [{"bpm": 55.0 + 7 * j + 3 * i} for j in range(5)]})):
            os.makedirs(path.join(root, folder, sid), exist_ok=True)
            with open(path.join(root, folder, sid, name), "wb") as f:
                pickle.dump(obj, f)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("mix")
    return (make_hci_tree(str(base / "hci")),
            make_ffpp_tree(str(base / "ffpp"), compressions=("raw",)))


@pytest.fixture
def mix_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "xla")
    monkeypatch.setenv("DFD_DEC_STACK", "0")
    return tmp_path


def rppg(mod, root, split="train", **over):
    cfg = mod.RPPG.get_default_config()
    cfg.merge_from_other_cfg({"root_dir": root, "category": "rPPG", "compressions": ["c23"],
                              "runtime": False, "train_ratio": 0.8, **over})
    extra = {"video_backend": "opencv"} if mod is tds else {}
    return mod.RPPG(cfg, T, 2, split=split, index=0, seed=0, **extra)


def ffpp(mod, root):
    cfg = mod.FFPP.get_default_config()
    cfg.merge_from_other_cfg({"root_dir": root, "types": ["REAL", "DF"], "compressions": ["raw"],
                              "category": "Deepfake"})
    extra = {"video_backend": "opencv"} if mod is tds else {}
    return mod.FFPP(cfg, T, 2, split="train", index=1, seed=0, **extra)


@pytest.mark.parametrize("case", [
    {"split": "train"}, {"split": "val"}, {"split": "train", "label_type": "num"},
    {"split": "train", "runtime": True, "label_dim": 180, "scale": 0.5}],
    ids=["train_dist", "val", "num", "runtime_fallback"])
def test_rppg_items_and_batches_equal_jax(mix_env, trees, case):
    """The seeded session split, each clip's frames, label (a Gaussian over
    label_dim bins at bpm - 41, or bpm - 41) and mask, then a collated
    batch's six fields; runtime 1 without heartpy / pyedflib falls back to
    the Measures files in both."""
    hci, _ = trees
    over = dict(case)
    split = over.pop("split")
    want, got = rppg(jds, hci, split, **over), rppg(tds, hci, split, **over)
    assert len(got) == len(want) > 0
    assert [m["session_dir"] for m in got.session_metas] == \
        [m["session_dir"] for m in want.session_metas]
    assert got.stack_session_clips == want.stack_session_clips
    assert not got.runtime_labels and not want.runtime_labels
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g[0].dtype == w[0].dtype == np.uint8 and g[0].tobytes() == w[0].tobytes()
        assert np.asarray(g[1]).dtype == np.asarray(w[1]).dtype
        assert np.asarray(g[1]).tobytes() == np.asarray(w[1]).tobytes()
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3] == 0
    items = [0, len(want) - 1]
    gb, wb = got.collate_fn([got[i] for i in items]), want.collate_fn([want[i] for i in items])
    for a, b in zip(gb, wb):
        if isinstance(b, list):
            assert a == b == ["raw", "raw"]
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def run_pair(mode, hci, ffpp_root):
    """JAX's and the port's two-task Trainer from the same parameters, three
    steps of a ten-step schedule (both stopped by a callback): each step's
    per-task losses, then the trainers."""
    over = {"out_dim": [140, 2], "losses": ["kl_div", "auc_roc"]}
    jdet, tdet = detectors(**over)
    cfg = {"max_steps": 10, "batch_size": 2, "num_workers": 0, "learning_rate": 1.0,
           "mode": mode}
    if mode == "teacher":
        cfg["mode_params"] = {"teach_at": 1, "ema_ratio": 0.5}
    jcfg, tcfg = JTrainer.get_default_config(), Trainer.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    jtr = JTrainer(jcfg, MeshRuntime(devices=jax.devices()[:1]), jdet,
                   [rppg(jds, hci), ffpp(jds, ffpp_root)], seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, {**jtr.frozen, **jtr.trainable}))
    ttr = Trainer(tcfg, QuietOneProcess("cpu"), tdet, [rppg(tds, hci), ffpp(tds, ffpp_root)],
                  seed=0, params=params)

    class Stop(Exception):
        pass

    losses = {"jax": [], "port": []}
    for pkg, tr in (("jax", jtr), ("port", ttr)):
        tr.add_callback("on_batch_end", lambda t, pkg=pkg: losses[pkg].append(
            {k: np.asarray(v).copy() for k, v in t.batch_losses.items()}))

        def stop(t):
            if t.steps == 3:
                raise Stop
        tr.add_callback("on_batch_end", stop)
        with pytest.raises(Stop):
            tr.run()
    return jtr, ttr, losses


@pytest.mark.parametrize("mode", ["normal", "teacher"])
def test_two_task_trainer_matches_jax(mix_env, trees, mode):
    """Each step draws an RPPG batch (soft labels) and an FFPP batch; the
    losses of both tasks at every step, then every trainable leaf (the
    teacher's too, in teacher mode, which labels the other task after step
    1)."""
    jtr, ttr, losses = run_pair(mode, *trees)
    assert ttr.steps == jtr.steps == 3
    assert len(losses["port"]) == 3
    for g, w in zip(losses["port"], losses["jax"]):
        assert set(g) == set(w) == {"rppg/rppg", "deepfake/ffpp"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    trees_ = [(ttr.snapshot_model_state()["trainable"], jtr.trainable)]
    if mode == "teacher":
        assert ttr.teaching and jtr.teaching
        trees_.append((jax.tree_util.tree_map(lambda t: t.detach().numpy(), ttr.teacher),
                       jtr.teacher))
    for got, want in trees_:
        gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_main_on_a_mix_config(mix_env, trees):
    """The port's main on configs/cross-task/mix.yaml at ViT-Test size (the
    roots, sizes, steps and intervals changed): both tasks train, the
    evaluation reports the rPPG loss and deepfake/ffpp accuracy and
    roc_auc, and the run directory holds its artefacts. rppg/rppg rmse is
    not reported, as in the JAX package: its rmse takes bpm labels, and the
    recipe's are "dist" distributions (the shapes do not broadcast, and
    compute_metrics skips the metric)."""
    from dfd_clip_tpu_torch import main as tmain

    hci, ffpp_root = trees
    jweights.save_params(str(mix_env / "encoder.pt"), {"backbone": jax.tree_util.tree_map(
        np.asarray, jvit.init_clip_vision(jax.random.key(5), jvit.ARCHITECTURES["ViT-Test"]))})
    cfg = yaml.safe_load((ROOT / "configs" / "cross-task" / "mix.yaml").read_text())
    cfg["system"].update(mixed_precision="no", evaluation_interval=2, training_eval_interval=2)
    cfg["tracking"]["directory"] = str(mix_env / "logs")
    cfg["model"].update(architecture="ViT-Test", decode_indices=[0, 2], dropout=0.0,
                        pretrained=str(mix_env / "encoder.pt"))
    cfg["model"]["adapter"]["struct"]["x"] = 32
    cfg["trainer"].update(max_steps=2, batch_size=2, num_workers=0)
    cfg["evaluator"].update(batch_size=4, num_workers=0)
    cfg["data"].update(num_frames=T, clip_duration=2)
    for d in cfg["data"]["train"] + cfg["data"]["eval"]:
        d["root_dir"] = hci if d["name"] == "RPPG" else ffpp_root
        if d["name"] == "FFPP":
            d.update(types=["REAL", "DF"], compressions=["raw"])
    (mix_env / "mix.yaml").write_text(yaml.safe_dump(cfg))
    run = tmain.main(tmain.parse_args(["--cfg", str(mix_env / "mix.yaml"), "--device", "cpu",
                                       "--video_backend", "opencv"]))
    names = {p.name for p in Path(run).iterdir()}
    assert {"setting.yaml", "best_weights.pt", "last_weights.pt", "metrics.jsonl"} <= names
    lines = [json.loads(s) for s in open(f"{run}/metrics.jsonl")]
    (ev,) = [r for r in lines if "evaluator/loss/rppg/rppg" in r]
    assert ev["step"] == 2 and "evaluator/metric/rppg/rppg/rmse" not in ev
    for key in ("evaluator/loss/rppg/rppg", "evaluator/metric/deepfake/ffpp/accuracy",
                "evaluator/metric/deepfake/ffpp/roc_auc"):
        assert np.isfinite(ev[key])
    assert any("trainer/loss/rppg/rppg" in r and "trainer/loss/deepfake/ffpp" in r
               for r in lines)
    last = jweights.load_params(f"{run}/last_weights.pt")
    assert last["steps"] == 2 and set(last["trainable"]) == {"decoder", "adapter"}
