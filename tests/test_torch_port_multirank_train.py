"""The port's training side on two ranks (see test_torch_port_multirank.py
for the jobs and tolerances): the "stats" job at (data 2, seq 1), a step
of a 768-bn adapter Detector against one process and JAX's mesh and a
CompInvTrainer step against one process, each statistic over the global
batch; the "train" job at (data 2, seq 1) and then
(1, 2) on one Gloo group. One Trainer step against the port's
one-process step on the global batch and against JAX's train step with its
batch sharded over a mesh of the same layout (the spmd kernels
interpreted), and at dropout 0.5 against the port's one-process step; the
dispatch's trainable Function at each seq width; a kv_dtype "int8"
predict at (2, 1) against one process; the Evaluator's gathered logits
paired with their own labels
across a ragged tail, against a one-process evaluation; inference.main on
two ranks against one process on a copy of the run directory.
"""

import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dfd_clip_tpu.engine import optim as joptim
from dfd_clip_tpu.models.detector import Detector as JDetector
from dfd_clip_tpu.runtime import mesh as jmesh_rt
from dfd_clip_tpu_torch.engine.evaluator import Evaluator
from dfd_clip_tpu_torch.engine.trainer import Trainer
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.runtime import OneProcess
from test_torch_port_multirank import STEP_TOL, jax_detector, jax_mesh, port_detector
from torch_multirank_jobs import ClipSet, grads_of, run_job


# -- job "train" ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_job(tmp_path_factory):
    from fixtures import make_cdf_tree
    from test_torch_port_serve import write_run_dir

    rng = np.random.default_rng(1)
    work = tmp_path_factory.mktemp("train")
    _, params = jax_detector(4)
    a = {"params": params,
         "x": rng.integers(0, 256, (4, 4, 3, 40, 48), dtype=np.uint8),
         "label": np.array([0, 1, 1, 0], np.int64),
         "m": np.ones((4, 4), bool)}
    a["m"][1, 2:] = False
    # 10 clips, labels sorted, so that a batch mixes ranks' labels; the global
    # batch of 6 (2 ranks) or 3 leaves a ragged tail
    a["ex"] = rng.integers(0, 256, (10, 4, 3, 40, 48), dtype=np.uint8)
    a["elabel"] = np.array([0] * 5 + [1] * 5, np.int64)
    a["em"] = np.ones((10, 4), bool)
    a["em"][3, 1:] = False
    run = work / "run"
    write_run_dir(run, [{"name": "CDF", "category": "Deepfake",
                         "root_dir": make_cdf_tree(str(work / "cdf"))}])
    a["bn_cfg"] = dict(struct_type="768-bn", inner_dim=32, width=64, num_layers=2,
                       num_frames=4, patches=4)
    a["bn_batches"] = [{s: rng.standard_normal((2, 3, 4, 4, 4, 16)).astype(np.float32)
                        for s in ("k", "v")} for _ in range(4)]
    a["run_dir"] = str(run)
    shutil.copytree(run, work / "run_one")
    results = run_job("train", 2, work, a)
    return a, results, work


def one_process_trainer(a, batch_size=4, **over):
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 1.0, "batch_size": batch_size,
                               "num_workers": 0})
    return Trainer(tcfg, OneProcess("cpu"), port_detector(**over), [],
                   params=params_from_jax(a["params"]))


def global_batch(a):
    return (a["x"], a["label"], a["m"], ["raw"] * 4, np.ones(4), np.zeros(4, np.int64))


def jax_step(a, dp, sp):
    """JAX's train step (task 0, SGD + OneCycle over max_steps x dp) with the
    batch sharded over a (dp, sp) mesh, the spmd kernels interpreted."""
    jdet, _ = jax_detector(4)
    mesh = jax_mesh(dp, sp)
    trainable, frozen = jdet.partition_params(jax.tree_util.tree_map(jnp.asarray, a["params"]))
    opt = joptim.build_optimizer(jdet.optimizer_spec(), joptim.one_cycle_schedule(1.0, 10 * dp))

    def loss_fn(tr, x, y, m):
        losses, _, _ = jdet.forward({**frozen, **tr}, x, [y], m, train=True, single_task=0)
        return losses[0].mean()

    x = jax.device_put(a["x"], NamedSharding(mesh, P("data", "seq")))
    y, m = (jax.device_put(a[k], NamedSharding(mesh, P("data"))) for k in ("label", "m"))
    _, g = jax.jit(jax.value_and_grad(loss_fn))(trainable, x, y, m)
    updates, _ = opt.update(g, opt.init(trainable), trainable)
    return jax.tree_util.tree_map(np.asarray, optax.apply_updates(trainable, updates))


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=["data2", "seq2"])
def test_trainer_step_matches_one_process_and_jax(train_job, monkeypatch, layout):
    a, results, _ = train_job
    dp, sp = layout
    res = [r[f"sp{sp}"] for r in results]
    assert res[0]["frames"] == 4 // sp                      # seq ranks keep their frames
    trainer = one_process_trainer(a)
    trainer.train_step([("task0", trainer.prepare_batch(global_batch(a)))])
    want = trainer.snapshot_model_state()["trainable"]
    np.testing.assert_allclose(np.concatenate([r["loss"] for r in res[::sp]]),
                               trainer.batch_losses["task0"], **STEP_TOL)
    monkeypatch.setenv("DFD_SPMD_PALLAS", "1")
    prev = jmesh_rt.current_mesh()
    try:
        jwant = jax_step(a, dp, sp)
    finally:
        jmesh_rt.set_current_mesh(prev)
    start = jax.tree_util.tree_leaves({k: v for k, v in a["params"].items() if k != "encoder"})
    moved = 0.0
    for r in res:
        got = jax.tree_util.tree_leaves(r["trainable"])
        assert len(got) == len(start)
        for g, w, j, s0 in zip(got, jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(jwant), start):
            np.testing.assert_allclose(g, w, **STEP_TOL)
            np.testing.assert_allclose(g, j, **STEP_TOL)
            moved = max(moved, float(np.abs(g - s0).max()))
    assert moved > 100 * STEP_TOL["atol"]                   # the step moved the parameters
    for x, y in zip(jax.tree_util.tree_leaves(res[0]["trainable"]),
                    jax.tree_util.tree_leaves(res[1]["trainable"])):
        np.testing.assert_array_equal(x, y)                 # every rank took one step


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=["data2", "seq2"])
def test_trainer_step_at_dropout_matches_one_process(train_job, layout):
    """At dropout 0.5 each rank draws the decoder's masks for the global
    batch from the one seeded stream and keeps its rows: the ranks' step is
    the one-process step on the global batch, masks included."""
    a, results, _ = train_job
    _, sp = layout
    res = [r[f"sp{sp}"]["dropout"] for r in results]
    trainer = one_process_trainer(a, dropout=0.5)
    trainer.train_step([("task0", trainer.prepare_batch(global_batch(a)))])
    want = jax.tree_util.tree_leaves(trainer.snapshot_model_state()["trainable"])
    np.testing.assert_allclose(np.concatenate([r["loss"] for r in res[::sp]]),
                               trainer.batch_losses["task0"], **STEP_TOL)
    plain = one_process_trainer(a)                          # the same step at dropout 0
    plain.train_step([("task0", plain.prepare_batch(global_batch(a)))])
    assert not np.allclose(plain.batch_losses["task0"], trainer.batch_losses["task0"],
                           **STEP_TOL)                      # the masks changed the step
    for r in res:
        got = jax.tree_util.tree_leaves(r["trainable"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **STEP_TOL)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=["data2", "seq2"])
def test_dispatch_shards_only_across_seq_ranks(train_job, layout):
    """dual_activation_attention in training takes the sharded Function only
    at a seq width above 1; at (2, 1) a rank holds whole clips and runs the
    one-rank Function."""
    _, results, _ = train_job
    _, sp = layout
    want = "_ShardedAttentionBackward" if sp > 1 else "_TrainableAttentionBackward"
    assert [r[f"sp{sp}"]["dispatch_fn"] for r in results] == [want, want]


def test_kv_int8_scales_span_the_data_ranks(train_job):
    """kv_dtype "int8" at (2, 1): each rank quantises its clips' K/V with the
    per-(layer, head) maxima taken over both ranks' clips, so the gathered
    logits are the one-process predict's on the global batch."""
    a, results, _ = train_job
    det = port_detector(op_mode={"kv_dtype": "int8"})
    want = det.predict(det.prepare_params(params_from_jax(a["params"])), a["x"], a["m"])[0][0]
    got = np.concatenate([r["sp1"]["kv_int8"] for r in results])
    np.testing.assert_allclose(got, want.numpy(), **STEP_TOL)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=["data2", "seq2"])
def test_evaluator_pairs_labels_with_logits(train_job, layout):
    """The ranks' gathered rows (padding dropped) are the one-process
    evaluation's, in order, and each loss is the cross-entropy of its own
    (logit, label) pair."""
    a, results, _ = train_job
    _, sp = layout
    trainer = one_process_trainer(a)
    trainer.train_step([("task0", trainer.prepare_batch(global_batch(a)))])
    ecfg = Evaluator.get_default_config()
    ecfg.merge_from_other_cfg({"batch_size": 3, "num_workers": 0})
    ev = Evaluator(ecfg, trainer.runtime, [ClipSet(a["ex"], a["elabel"], a["em"])])
    seen = {"losses": [], "logits": [], "labels": []}

    def collect(agent):
        keep = agent.batch_valid["deepfake/ffpp"]
        seen["losses"].append(agent.batch_losses["deepfake/ffpp"][keep])
        seen["logits"].append(agent.batch_logits["deepfake/ffpp"][keep])
        seen["labels"].append(agent.batch_labels["deepfake/ffpp"][keep])

    ev.add_callback("on_batch_end", collect)
    ev.run(trainer)
    want = {k: np.concatenate(v) for k, v in seen.items()}
    for r in results:
        got = r[f"sp{sp}"]["eval"]
        np.testing.assert_array_equal(got["labels"], a["elabel"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["logits"], want["logits"], **STEP_TOL)
        z = got["logits"] - got["logits"].max(-1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
        ce = -logp[np.arange(len(got["labels"])), got["labels"]]
        np.testing.assert_allclose(ce, got["losses"], rtol=1e-5, atol=1e-5)


def test_two_rank_inference_matches_one_process(train_job, monkeypatch):
    """inference.main on two ranks (each scoring every other video, the
    probabilities gathered by gather_ragged) against one process on a copy
    of the run directory: the same report, the same (label, P(fake)) pairs."""
    from dfd_clip_tpu_torch import inference as tinf
    from test_torch_port_serve import port_f32

    a, results, work = train_job
    monkeypatch.chdir(work)
    port_f32(monkeypatch)
    want = tinf.main(tinf.parse_args([str(work / "run_one"), "--batch_size", "3",
                                      "--modality", "video", "--num_workers", "0",
                                      "--device", "cpu", "--video_backend", "opencv"]))
    assert results[0]["report"] == want and results[1]["report"] == {}

    def pairs(root):
        (stats,) = root.glob("stats_*_best_video.pickle")
        s = pickle.loads(stats.read_bytes())["CDF"]
        return sorted(zip(s["label"], s["prob"]))

    got, ref = pairs(Path(a["run_dir"])), pairs(work / "run_one")
    assert [g[0] for g in got] == [r[0] for r in ref] and len(got) == 6
    np.testing.assert_allclose([g[1] for g in got], [r[1] for r in ref], rtol=1e-6, atol=1e-7)


def test_bn_calibration_sums_over_ranks(train_job):
    """calibrate_bn_stats with each rank's half of the batches and the
    runtime's SUM: both ranks hold the statistics one process computes over
    every batch (f64 sums, added in another order)."""
    from dfd_clip_tpu_torch.models import adapter as adapter_lib

    a, results, _ = train_job
    cfg = adapter_lib.AdapterConfig(**a["bn_cfg"])
    params = adapter_lib.init_adapter(torch.Generator().manual_seed(0), cfg)
    want = adapter_lib.calibrate_bn_stats(params, a["bn_batches"], cfg)["blocks"]
    for res in results:
        for got, blk in zip(res["bn"], want):
            for s in ("k", "v"):
                for stat in ("mean", "var"):
                    np.testing.assert_allclose(got[s][stat], blk[s]["bn"][stat].numpy(),
                                               rtol=1e-6, atol=1e-7)


# -- job "stats": statistics of the global batch ------------------------------------------

BN_ADAPTER = {"type": "normal", "struct": {"type": "768-bn"}}
COMPINV_CFG = {"architecture": "ViT-Test", "decode_mode": "index", "decode_indices": [0, 2],
               "adapter": {"struct": {"type": "768-x-768", "x": 32}}}


def jax_bn_detector():
    cfg = JDetector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0, 2], "out_dim": [2], "losses": ["auc_roc"],
                              "adapter": BN_ADAPTER})
    return JDetector(cfg, num_frames=4, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def stats_job(tmp_path_factory):
    """Inputs of the "stats" job: a 768-bn Detector's params (its adapter's
    leaves and BN affine drawn at random) with a batch of 4 clips, and a
    CompInvEncoder's (768-x-768 adapter) with 4 raw / c23 pairs."""
    from dfd_clip_tpu_torch.models import CompInvEncoder
    from dfd_clip_tpu_torch.models.weights import params_to_jax

    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(np.asarray, jax_bn_detector().init_params(jax.random.key(2)))
    params["adapter"] = jax.tree_util.tree_map(
        lambda x: (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32), params["adapter"])
    a = {"bn_adapter": BN_ADAPTER, "bn_params": params,
         "x": rng.integers(0, 256, (4, 4, 3, 40, 48), dtype=np.uint8),
         "label": np.array([0, 1, 1, 0], np.int64), "m": np.ones((4, 4), bool),
         "compinv_cfg": COMPINV_CFG,
         "ci_x": rng.integers(0, 256, (8, 4, 3, 40, 48), dtype=np.uint8),
         "ci_m": np.ones((8, 4), bool),
         "ci_comps": np.array(["raw", "c23", "c23", "raw", "raw", "c23", "c23", "raw"])}
    ccfg = CompInvEncoder.get_default_config()
    ccfg.merge_from_other_cfg(COMPINV_CFG)
    enc = CompInvEncoder(ccfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    a["ci_params"] = params_to_jax(enc.init_params(torch.Generator().manual_seed(3)))
    a["ci_params"]["adapter"] = jax.tree_util.tree_map(
        lambda x: (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32),
        a["ci_params"]["adapter"])
    return a, run_job("stats", 2, tmp_path_factory.mktemp("stats"), a)


def test_bn_adapter_statistics_span_the_data_ranks(stats_job):
    """A Trainer step of a Detector with a 768-bn adapter at (data 2, seq 1):
    its training statistics (mean and biased variance over batch, patches
    and width a frame channel) are the global batch's, so the ranks' losses
    and leaves are one process's step on the global batch and JAX's with
    the batch sharded over a (2, 1) mesh."""
    a, results = stats_job
    trainer = Trainer(_tcfg(4), OneProcess("cpu"), port_detector(adapter=BN_ADAPTER), [],
                      params=params_from_jax(a["bn_params"]))
    trainer.train_step([("task0", trainer.prepare_batch(
        (a["x"], a["label"], a["m"], ["raw"] * 4, np.ones(4), np.zeros(4, np.int64))))])
    want = trainer.snapshot_model_state()["trainable"]
    np.testing.assert_allclose(np.concatenate([r["bn"]["loss"] for r in results]),
                               trainer.batch_losses["task0"], **STEP_TOL)
    for r in results:
        for gg, wg in zip(r["bn"]["grads"], grads_of(trainer), strict=True):
            assert (gg is None) == (wg is None)
            if gg is not None:
                np.testing.assert_allclose(gg, wg, **STEP_TOL)

    jdet = jax_bn_detector()
    mesh = jax_mesh(2, 1)
    trainable, frozen = jdet.partition_params(jax.tree_util.tree_map(jnp.asarray,
                                                                     a["bn_params"]))
    opt = joptim.build_optimizer(jdet.optimizer_spec(), joptim.one_cycle_schedule(1.0, 20))

    def loss_fn(tr, x, y, m):
        losses, _, _ = jdet.forward({**frozen, **tr}, x, [y], m, train=True, single_task=0)
        return losses[0].mean()

    x = jax.device_put(a["x"], NamedSharding(mesh, P("data")))
    y, m = (jax.device_put(a[k], NamedSharding(mesh, P("data"))) for k in ("label", "m"))
    prev = jmesh_rt.current_mesh()
    try:
        _, g = jax.jit(jax.value_and_grad(loss_fn))(trainable, x, y, m)
    finally:
        jmesh_rt.set_current_mesh(prev)
    updates, _ = opt.update(g, opt.init(trainable), trainable)
    jwant = jax.tree_util.tree_map(np.asarray, optax.apply_updates(trainable, updates))
    start = jax.tree_util.tree_leaves(trainable)
    moved = 0.0
    for r in results:
        got = jax.tree_util.tree_leaves(r["bn"]["trainable"])
        assert len(got) == len(jax.tree_util.tree_leaves(jwant))
        for gl, w, j, s0 in zip(got, jax.tree_util.tree_leaves(want),
                                jax.tree_util.tree_leaves(jwant), start):
            np.testing.assert_allclose(gl, w, **STEP_TOL)
            np.testing.assert_allclose(gl, j, **STEP_TOL)
            moved = max(moved, float(np.abs(gl - np.asarray(s0)).max()))
    assert moved > 100 * STEP_TOL["atol"]


def _tcfg(batch_size):
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 1.0, "batch_size": batch_size,
                               "num_workers": 0})
    return tcfg


def test_compinv_loss_spans_the_data_ranks(stats_job):
    """A CompInvTrainer step at (data 2, seq 1), two pairs a rank: recon and
    match are the global batch's (the difference maps summed over both
    ranks' pairs before the norm) on both ranks, and the adapter's leaves
    are one process's step on the 4 pairs."""
    from dfd_clip_tpu_torch.engine.trainer import CompInvTrainer
    from dfd_clip_tpu_torch.models import CompInvEncoder

    a, results = stats_job
    ccfg = CompInvEncoder.get_default_config()
    ccfg.merge_from_other_cfg(COMPINV_CFG)
    enc = CompInvEncoder(ccfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    ctcfg = CompInvTrainer.get_default_config()
    ctcfg.merge_from_other_cfg({"max_steps": 10, "num_workers": 0, "learning_rate": 1.0,
                                "batch_size": 8})
    ctr = CompInvTrainer(ctcfg, OneProcess("cpu"), enc, [], params=params_from_jax(a["ci_params"]))
    ctr.train_step([("task0", ctr.prepare_batch((a["ci_x"], np.zeros(8), a["ci_m"],
                                                 list(a["ci_comps"]))))])
    want = jax.tree_util.tree_leaves(ctr.snapshot_model_state()["trainable"])
    start = jax.tree_util.tree_leaves(a["ci_params"]["adapter"])
    moved = 0.0
    for r in results:
        for k in ("recon", "match"):
            np.testing.assert_allclose(r["compinv"][k], ctr.batch_losses[k], **STEP_TOL)
        for gg, wg in zip(r["compinv"]["grads"], grads_of(ctr), strict=True):
            assert (gg is None) == (wg is None)
            if gg is not None:
                np.testing.assert_allclose(gg, wg, **STEP_TOL)   # the global loss's gradient
        got = jax.tree_util.tree_leaves(r["compinv"]["trainable"])
        assert len(got) == len(want) == len(start)
        for gl, w, s0 in zip(got, want, start):
            np.testing.assert_allclose(gl, w, **STEP_TOL)
            moved = max(moved, float(np.abs(gl - s0).max()))
    assert moved > 100 * STEP_TOL["atol"]
