"""The port's training engine (dfd_clip_tpu_torch/engine, utils/tracking.py,
runtime.OneProcess) on the CPU against the JAX package: the callbacks on
the same agent state, train-state checkpoints (save, keep, restore, the
refusal of foreign pickles), the Evaluator's losses and logits with a
ragged tail, the datasets-built Trainer with a K/V adapter over three steps
against JAX's Trainer from the same parameters, a resumed run against an
uninterrupted one, the profiler window's trace, the Tracker's JSONL and
the logging helpers.

Both packages run ViT-Test in float32 through the opencv backend on a
cv2-written FFPP tree (JAX's XLA compositions; conftest sets its matmul
precision to "highest"). Tolerances: callbacks, checkpoints and the resumed
run exactly equal; the Evaluator and the Trainer atol = rtol = 1e-4 (the
model hold of tests/test_torch_port_train.py).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.config import CN as JCN
from dfd_clip_tpu.data import datasets as jds
from dfd_clip_tpu.engine import callbacks as jcb
from dfd_clip_tpu.engine.evaluator import Evaluator as JEvaluator
from dfd_clip_tpu.engine.trainer import Trainer as JTrainer
from dfd_clip_tpu.runtime import MeshRuntime
from dfd_clip_tpu_torch.config import CN
from dfd_clip_tpu_torch.data import datasets as tds
from dfd_clip_tpu_torch.engine import callbacks as tcb
from dfd_clip_tpu_torch.engine.checkpoint import TrainStateCheckpointer
from dfd_clip_tpu_torch.engine.evaluator import Evaluator
from dfd_clip_tpu_torch.engine.trainer import Trainer
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.runtime import OneProcess
from dfd_clip_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from dfd_clip_tpu_torch.utils.tracking import Tracker

from fixtures import make_ffpp_tree
from test_torch_port_adapter import tiny_detectors

TOL = dict(rtol=1e-4, atol=1e-4)
METRICS = [{"name": "deepfake/ffpp", "types": ["accuracy", "roc_auc"]}]


class JaxOneDevice:
    """The JAX callbacks' and Evaluator's runtime surface, on the host."""
    is_main_process = True
    process_index = 0
    data_parallel = 1

    def gather_for_metrics(self, tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    def shard_batch(self, tree, specs=None):
        return {k: jnp.asarray(v) for k, v in tree.items()}

    def to_host(self, x):
        return np.asarray(x)

    def print(self, *a, **k):
        pass


class QuietOneProcess(OneProcess):
    def print(self, *a, **k):
        pass


class Stop(Exception):
    pass


def stop_at(step):
    """A callback that stops a run once it has taken ``step`` steps."""
    def stop(t):
        if t.steps == step:
            raise Stop
    return stop


# -- callbacks ----------------------------------------------------------------

def agent(pkg, tracker, runtime):
    cn = JCN if pkg == "jax" else CN
    return SimpleNamespace(config=SimpleNamespace(metrics=[cn(m) for m in METRICS]),
                           runtime=runtime, tracker=tracker, steps=0,
                           training_eval_interval=2, main_metric="deepfake/ffpp/roc_auc",
                           compare_fn="max", current_lr=lambda: 0.5,
                           snapshot_model_state=lambda: {"steps": 0})


def test_callbacks_match_jax(tmp_path):
    """init / update (a padded batch trimmed by batch_valid) / compute
    metrics, update_trackers and cache_best_model on the same batches: the
    same computed metrics and losses, best metric, tracker lines and
    timers' keys."""
    from dfd_clip_tpu.utils.tracking import Tracker as JTracker

    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, 2)).astype(np.float32), rng.integers(0, 2, 4),
                rng.random(4).astype(np.float32), np.array([True, True, True, i == 0]))
               for i in range(3)]
    agents = {"jax": agent("jax", JTracker(str(tmp_path / "jax")), JaxOneDevice()),
              "port": agent("port", Tracker(str(tmp_path / "port")), QuietOneProcess("cpu"))}
    for (pkg, a), cb in zip(agents.items(), (jcb, tcb)):
        cb.init_metrics(a)
        for step, (logits, labels, losses, valid) in enumerate(batches, 1):
            a.batch_logits, a.batch_labels = {"deepfake/ffpp": logits}, {"deepfake/ffpp": labels}
            a.batch_losses = {"deepfake/ffpp": losses}
            a.batch_valid = {"deepfake/ffpp": valid}
            a.steps = step
            cb.update_metrics(a)
            cb.compute_metrics(a)
            cb.update_trackers(a)
            if step % 2 == 0:
                cb.cache_best_model(a)
    want, got = agents["jax"], agents["port"]
    assert got.computed_metrics == want.computed_metrics
    assert got.compute_losses == want.compute_losses
    assert got.best_main_metric == want.best_main_metric
    lines = {pkg: [json.loads(s) for s in (tmp_path / pkg / "metrics.jsonl").read_text()
                   .splitlines()] for pkg in agents}
    strip = [[{k: v for k, v in r.items() if k != "time"} for r in lines[p]] for p in agents]
    assert strip[0] == strip[1] and len(strip[1]) == 2


def test_tracker_and_logging_helpers(tmp_path, monkeypatch):
    """Tracker: a JSONL line a log call (step, time, values), no wandb run
    without the package; SmoothedValue's window and MetricLogger's lines;
    the completion notice sends nothing without its two credentials."""
    import urllib.request

    from dfd_clip_tpu_torch.utils import notify

    def refuse(*a, **k):
        raise AssertionError("the notice must not be sent")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    notify.send_to_telegram("done")
    notify.send_to_telegram("done", token="t")
    notify.send_to_telegram("done", chat_id="c")
    tr = Tracker(str(tmp_path / "run"), enabled=True, project="p")
    tr.log({"lr": 0.1}, step=3)
    tr.log({"loss": 2.0}, step=4)
    tr.finish()
    rows = [json.loads(s) for s in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r.get("lr"), r.get("loss")) for r in rows] == [(3, 0.1, None),
                                                                       (4, None, 2.0)]
    sv = SmoothedValue(window_size=2)
    for v in (1.0, 2.0, 4.0):
        sv.update(v)
    assert (sv.median, sv.avg, sv.global_avg, sv.max, sv.value) == (4.0, 3.0, 7.0 / 3, 4.0, 4.0)
    out = []
    log = MetricLogger(output=out.append)
    for _ in log.log_every(range(3), 2, header="h"):
        log.update(loss=1.0)
    assert out[0].startswith("h  [0/3]") and "loss" in out[1] and "Total time" in out[-1]


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_save_keep_restore(tmp_path):
    """keep=2 leaves the newest two steps; restore_latest gives the newest
    arrays and aux back equal and checks them against a template; a pickle
    naming anything but numpy's array classes is refused."""
    import pickle

    ck = TrainStateCheckpointer(str(tmp_path / "ck"), keep=2)
    assert ck.restore_latest() is None and ck.list_steps() == []
    tree = {"trainable": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "opt_state": {"state": {0: {"momentum_buffer": np.ones(3)}},
                          "param_groups": [{"lr": 0.1, "params": [0]}]}, "teacher": None}
    for step in (1, 2, 3, 4):
        ck.save(step, {**tree, "step_tag": np.int64(step)}, {"teaching": False})
    assert ck.list_steps() == [3, 4]
    arrays, aux = ck.restore_latest({"trainable": tree["trainable"], "opt_state": None,
                                     "teacher": None, "step_tag": None})
    assert aux == {"teaching": False, "step": 4} and int(arrays["step_tag"]) == 4
    np.testing.assert_array_equal(arrays["trainable"]["w"], tree["trainable"]["w"])
    with pytest.raises(ValueError):
        ck.restore_latest({"trainable": {"w": np.zeros(2)}, "opt_state": None, "teacher": None,
                           "step_tag": None})
    (tmp_path / "ck" / "step_00000004" / "aux.pkl").write_bytes(pickle.dumps(SimpleNamespace))
    with pytest.raises(pickle.UnpicklingError):
        ck.restore_latest()


# -- Evaluator and Trainer against JAX's ------------------------------------------

@pytest.fixture(scope="module")
def ffpp_tree(tmp_path_factory):
    return make_ffpp_tree(str(tmp_path_factory.mktemp("engine") / "ffpp"),
                          compressions=("raw",))


def ffpp(mod, root, split, **over):
    cfg = mod.FFPP.get_default_config()
    cfg.merge_from_other_cfg({"root_dir": root, "types": ["REAL", "DF"], "compressions": ["raw"],
                              "category": "Deepfake", **over})
    extra = {"video_backend": "opencv"} if mod is tds else {}
    return mod.FFPP(cfg, 4, 1.0, split=split, index=0, seed=0, **extra)


def trainer_cfgs(**over):
    base = {"max_steps": 10, "batch_size": 2, "num_workers": 0, "learning_rate": 1.0,
            "metrics": METRICS, **over}
    j, t = JTrainer.get_default_config(), Trainer.get_default_config()
    j.merge_from_other_cfg(base)
    t.merge_from_other_cfg(base)
    return j, t


@pytest.fixture
def engine_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "xla")
    monkeypatch.setenv("DFD_DEC_STACK", "0")
    return tmp_path


def test_evaluator_matches_jax(engine_env, ffpp_tree):
    """Each batch's losses, logits, labels and valid rows: batch 3 over 32
    clips, so the last batch is two clips padded to three."""
    jdet, tdet = tiny_detectors("768-x-768")
    jparams = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))
    jparams["adapter"] = jax.tree_util.tree_map(
        lambda a: np.asarray(0.2 * np.random.default_rng(1).standard_normal(a.shape),
                             np.float32), jparams["adapter"])
    ecfg = {"batch_size": 3, "num_workers": 0, "metrics": METRICS}
    seen = {"jax": [], "port": []}

    def record(pkg):
        return lambda e: seen[pkg].append(
            {k: np.asarray(getattr(e, k)["deepfake/ffpp"]).copy()
             for k in ("batch_losses", "batch_logits", "batch_labels", "batch_valid")})

    jev = JEvaluator(JCN(ecfg), JaxOneDevice(), [ffpp(jds, ffpp_tree, "val")])
    jev.add_callback("on_batch_end", record("jax"))
    trainable, frozen = jdet.partition_params(jax.tree_util.tree_map(jnp.asarray, jparams))
    jev.run(SimpleNamespace(model=jdet, total_tasks=1, trainable=trainable, frozen=frozen,
                            steps=0))
    tev = Evaluator(CN(ecfg), OneProcess("cpu"), [ffpp(tds, ffpp_tree, "val")])
    tev.add_callback("on_batch_end", record("port"))
    _, tcfg = trainer_cfgs()
    tev.run(Trainer(tcfg, tdet, {}, params=params_from_jax(jparams), device="cpu"))
    assert len(seen["port"]) == len(seen["jax"]) == 11
    assert seen["port"][-1]["batch_valid"].tolist() == [True, True, False]
    for got, want in zip(seen["port"], seen["jax"]):
        for k in ("batch_labels", "batch_valid"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("batch_losses", "batch_logits"):
            np.testing.assert_allclose(got[k], want[k], **TOL)


def test_trainer_with_adapter_matches_jax(engine_env, ffpp_tree):
    """JAX's Trainer(config, runtime, model, datasets) and the port's, on
    FFPP training sets through normal+frame (equal items), from the same
    parameters (JAX's init carried across), three steps of a ten-step
    schedule at dropout 0 (both stopped by a callback; optax's OneCycle
    needs four steps or more): each step's losses and then every trainable
    leaf, the adapter's included."""
    jdet, tdet = tiny_detectors("768-x-768")
    jcfg, tcfg = trainer_cfgs()
    over = {"augmentation": "normal+frame"}
    jtr = JTrainer(jcfg, MeshRuntime(devices=jax.devices()[:1]), jdet,
                   [ffpp(jds, ffpp_tree, "train", **over)], seed=0)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {**jtr.frozen, **jtr.trainable}))
    ttr = Trainer(tcfg, QuietOneProcess("cpu"), tdet, [ffpp(tds, ffpp_tree, "train", **over)],
                  seed=0, params=params)
    start = ttr.snapshot_model_state()["trainable"]
    losses = {"jax": [], "port": []}
    for pkg, tr in (("jax", jtr), ("port", ttr)):
        tr.add_callback("on_batch_end", lambda t, pkg=pkg: losses[pkg].append(
            np.asarray(t.batch_losses["deepfake/ffpp"]).copy()))
        tr.add_callback("on_batch_end", stop_at(3))
        with pytest.raises(Stop):
            tr.run()
    assert ttr.steps == jtr.steps == 3 and len(losses["port"]) == 3
    for g, w in zip(losses["port"], losses["jax"]):
        np.testing.assert_allclose(g, w, **TOL)
    got = ttr.snapshot_model_state()["trainable"]
    want = jax.tree_util.tree_map(np.asarray, jtr.trainable)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    moved = 0.0
    for a, b, s in zip(*(jax.tree_util.tree_leaves(t) for t in (got, want, start))):
        np.testing.assert_allclose(a, b, **TOL)
        moved = max(moved, float(np.abs(b - s).max()))
    assert moved > 100 * TOL["atol"]
    for leaf in jax.tree_util.tree_leaves(got["adapter"]):
        assert np.isfinite(leaf).all()


def test_resumed_run_equals_uninterrupted(engine_env, ffpp_tree):
    """A run stopped after step 2 (its checkpoint written) and a new Trainer
    resumed from checkpoints/ to step 4 end with the uninterrupted run's
    parameters, optimizer state and dropout generator, bit for bit; the
    prefetch thread is gone after each run, the stopped one included."""
    import threading

    _, tdet = tiny_detectors("768-x-768", dropout=0.5)
    _, tcfg = trainer_cfgs(max_steps=4, checkpoint_interval=2, learning_rate=0.5)
    over = {"augmentation": "normal+frame"}

    def trainer(ckdir):
        cfg = tcfg.merge_from_other_cfg({"checkpoint_dir": str(engine_env / ckdir)})
        return Trainer(cfg, QuietOneProcess("cpu"), tdet,
                       [ffpp(tds, ffpp_tree, "train", **over)], seed=3)

    whole = trainer("whole")
    whole.run()
    first = trainer("resumed")
    first.add_callback("on_batch_end", stop_at(2))
    with pytest.raises(Stop):
        first.run()
    assert not any(t.name == "trainer-prefetch" for t in threading.enumerate())
    second = trainer("resumed")
    assert second.start_step == 2
    second.run()
    assert not any(t.name == "trainer-prefetch" for t in threading.enumerate())
    assert second.steps == whole.steps == 4
    for a, b in zip(jax.tree_util.tree_leaves(second.snapshot_model_state()),
                    jax.tree_util.tree_leaves(whole.snapshot_model_state())):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(second.gen.get_state(), whole.gen.get_state())
    for a, b in zip(jax.tree_util.tree_leaves(second._checkpoint_arrays()["opt_state"]),
                    jax.tree_util.tree_leaves(whole._checkpoint_arrays()["opt_state"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profiler_callback_writes_a_trace(engine_env, ffpp_tree):
    """make_profiler_callbacks over steps [1, 3) of a two-step run: the
    end-of-training hook closes the window and writes a Chrome trace."""
    _, tdet = tiny_detectors("768-x-768")
    _, tcfg = trainer_cfgs(max_steps=2)
    tr = Trainer(tcfg, QuietOneProcess("cpu"), tdet, [ffpp(tds, ffpp_tree, "train")], seed=0)
    cb = tcb.make_profiler_callbacks(str(engine_env / "profile"), 1, 3)
    tr.add_callback("on_batch_start", cb)
    tr.add_callback("on_training_end", cb)
    tr.run()
    (trace,) = (engine_env / "profile").glob("trace_1_3.json")
    assert json.loads(trace.read_text())["traceEvents"]
