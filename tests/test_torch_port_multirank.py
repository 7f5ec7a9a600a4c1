"""The port on several ranks (dfd_clip_tpu_torch.runtime.MeshRuntime over
torch.distributed, Gloo on the CPU) against JAX's mesh path and against the
port on one process.

Jobs of real ranks, each spawned once (tests/torch_multirank_jobs.py: a
FileStore under the test's directory, no TCP port), whose results
module-scoped fixtures read (the "train" job's tests are in
test_torch_port_multirank_train.py, the "ssl" job's in
test_torch_port_multirank_ssl.py):

* "spmd", 4 ranks at (data 2, seq 2): ops/spmd.py's token-sharded decoder
  attention (stacked slots 0 and 1, unstacked, through the
  dual_activation_attention dispatch, int8_rows K/V) and the sharded
  trainable Function's gradients, against JAX's spmd_decoder_attention and
  jax.grad of spmd_decoder_attention_trainable on a (2, 2) mesh of the
  conftest's CPU devices (Pallas interpreted) and against the port's
  one-rank Function; Detector.predict on each rank's clips x frames against
  JAX's shard_map predict (DFD_SPMD_PALLAS=1); 3 frames on 2 seq ranks on
  the one-rank path; gather_ragged over 3 / 0 / 2 / 1 rows,
  broadcast_str, gather_for_metrics;
* "train", 2 ranks at (2, 1) then (1, 2): one Trainer step against the
  port's one-process step on the global batch and JAX's train step with
  its batch sharded over a mesh of the same layout, and at dropout 0.5
  against the port's one-process step (its masks drawn for the global
  batch); the dispatch's trainable Function at each seq width; a kv_dtype
  "int8" predict at (2, 1) against one process; the Evaluator's
  gathered logits paired with their own labels (a ragged tail) against a
  one-process evaluation; inference.main on two ranks against one process.

Tolerances: rtol 2e-4, atol 2e-5 for the attention and its gradients (the
JAX VJP suite's, ROADMAP queue 3's partials tolerance); int8_rows K/V
against JAX at JAX's own int8_rows spmd tolerance (tests/test_spmd.py:
rtol 2e-2, atol 2e-3: the TPU kernel rounds each dequantised row to bf16,
the port's keeps it in f32) and against the port's one-rank kernel at 2e-4
/ 2e-5; atol = rtol = 1e-4 for predict and the train step, in f32 (the
port's f32 model tolerance), at dropout 0 against JAX (whose masks come
from another generator) and at 0.5 against the port's one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dfd_clip_tpu.models.detector import Detector as JDetector
from dfd_clip_tpu.ops import spmd as jspmd
from dfd_clip_tpu.ops.decoder_attention_vjp import (
    spmd_decoder_attention_trainable as j_trainable,
)
from dfd_clip_tpu.runtime import mesh as jmesh_rt
from dfd_clip_tpu.runtime.mesh import MeshRuntime as JMeshRuntime
from dfd_clip_tpu_torch.models.detector import Detector
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops.decoder_attention_vjp import fused_decoder_attention_trainable
from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention
from torch_multirank_jobs import run_job

VJP_TOL = dict(rtol=2e-4, atol=2e-5)
INT8_JAX_TOL = dict(rtol=2e-2, atol=2e-3)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_mesh(dp: int, sp: int):
    return JMeshRuntime(devices=jax.devices()[:dp * sp], seq_parallel=sp).mesh


def jax_detector(num_frames: int, seed: int = 0):
    cfg = JDetector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0, 2], "out_dim": [2],
                              "losses": ["auc_roc"]})
    det = JDetector(cfg, num_frames=num_frames, compute_dtype=jnp.float32)
    return det, jax.tree_util.tree_map(np.asarray, det.init_params(jax.random.key(seed)))


def port_detector(num_frames: int = 4, **over):
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0, 2], "out_dim": [2], "losses": ["auc_roc"],
                              **over})
    return Detector(cfg, num_frames=num_frames, compute_dtype=torch.float32, device="cpu")


def quant_rows(x):
    s = np.maximum(np.abs(x).reshape(*x.shape[:3], -1).max(-1, keepdims=True) / 127.0, 1e-8)
    return (np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8),
            s.astype(np.float32))


# -- job "spmd" -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spmd_job(tmp_path_factory):
    rng = np.random.default_rng(0)
    b, h, d, t, p = 4, 4, 64, 4, 8
    l = t * p
    f32 = np.float32
    a = {"qs": (20.0 * rng.standard_normal((b, 1, h, d))).astype(f32),
         "qc": (20.0 * rng.standard_normal((b, 1, h, d))).astype(f32),
         "k": rng.standard_normal((2, b, l, h, d)).astype(f32),
         "v": rng.standard_normal((2, b, l, h, d)).astype(f32),
         "pos": (0.2 * rng.standard_normal((l, h, d))).astype(f32),
         "r": rng.standard_normal((b, 1, h, d)).astype(f32),
         # unit-scale queries for int8_rows and the gradients, as JAX's tests
         # of those forms (tests/test_spmd.py:192-260) take them
         "uqs": rng.standard_normal((b, 1, h, d)).astype(f32),
         "uqc": rng.standard_normal((b, 1, h, d)).astype(f32)}
    mask = np.ones((b, l), bool)
    mask[1, p:] = False          # seq rank 1 holds no valid token of sample 1
    mask[2, : 3 * p] = False     # nor seq rank 0 of sample 2
    mask[3] = False              # a fully masked sample
    a["mask"] = mask
    a["kq"], a["ks"] = quant_rows(a["k"])
    a["vq"], a["vs"] = quant_rows(a["v"])
    jdet, a["det_params"] = jax_detector(4)
    jdet3, a["det3_params"] = jax_detector(3, seed=1)
    a["x"] = rng.integers(0, 255, (4, 4, 3, 32, 32), np.uint8)
    a["m"] = np.ones((4, 4), bool)
    a["m"][0, 2:] = False        # a ragged clip: seq rank 1 holds none of its frames
    a["x3"] = rng.integers(0, 255, (3, 3, 3, 32, 32), np.uint8)
    a["m3"] = np.ones((3, 3), bool)
    results = run_job("spmd", 4, tmp_path_factory.mktemp("spmd"), a)
    return a, results, (jdet, jdet3)


def row_major(results, key, sub=None):
    """The (data, seq) ranks' ``key`` outputs: rows from seq index 0, in data
    order, after checking that each seq row agrees bit for bit."""
    parts = []
    for d in range(2):
        got = [results[2 * d + s][key] if sub is None else results[2 * d + s][key][sub]
               for s in range(2)]
        np.testing.assert_array_equal(got[0], got[1])   # one value across a seq row
        parts.append(got[0])
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def mesh22():
    prev = jmesh_rt.current_mesh()
    mesh = jax_mesh(2, 2)
    yield mesh
    jmesh_rt.set_current_mesh(prev)


def test_ranks_sit_where_jax_puts_its_devices(spmd_job):
    _, results, _ = spmd_job
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("form", ["stacked0", "stacked1", "flat", "dispatch"])
def test_spmd_decoder_attention_matches_jax(spmd_job, mesh22, form):
    a, results, _ = spmd_job
    layer = {"stacked0": 0, "stacked1": 1, "flat": None, "dispatch": 1}[form]
    k, v = (jnp.asarray(a[s]) for s in ("k", "v"))
    if layer is None:
        k, v = k[1], v[1]
    want = jspmd.spmd_decoder_attention(
        *(jnp.asarray(a[s]) for s in ("qs", "qc")), k, v, jnp.asarray(a["mask"]),
        jnp.asarray(a["pos"]), layer, mesh22)
    got = (row_major(results, "plain", layer) if form.startswith("stacked")
           else row_major(results, form))
    np.testing.assert_allclose(got, np.asarray(want), **VJP_TOL)
    assert np.all(got[3] == 0)   # the fully masked sample


def test_spmd_decoder_attention_int8_rows(spmd_job, mesh22):
    a, results, _ = spmd_job
    got = row_major(results, "int8")
    want = jspmd.spmd_decoder_attention(
        *(jnp.asarray(a[s]) for s in ("uqs", "uqc", "kq", "vq", "mask", "pos")), 1, mesh22,
        k_scale=jnp.asarray(a["ks"]), v_scale=jnp.asarray(a["vs"]))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **INT8_JAX_TOL)
    one_rank = fused_decoder_attention(
        *(torch.from_numpy(a[s]) for s in ("uqs", "uqc", "kq", "vq", "mask", "pos")), layer=1,
        k_scale=torch.from_numpy(a["ks"]), v_scale=torch.from_numpy(a["vs"]))
    np.testing.assert_allclose(got, one_rank.numpy(), **VJP_TOL)


def test_int8_rows_training_stays_on_the_one_rank_path(spmd_job):
    """JAX's exclusion: int8_rows K/V train off the sharded path. A rank
    that calls the trainable attention on its whole int8 stream runs no
    collective and gets the one-process result."""
    from dfd_clip_tpu_torch.ops.decoder_attention import dual_activation_attention

    a, results, _ = spmd_job
    want = dual_activation_attention(
        *(torch.from_numpy(a[s]) for s in ("uqs", "uqc", "kq", "vq", "mask")),
        temporal_pos=torch.from_numpy(a["pos"]), layer=1, differentiable=True,
        k_scale=torch.from_numpy(a["ks"]), v_scale=torch.from_numpy(a["vs"]))
    for res in results:
        assert res["int8_train_traffic"] == {}
        np.testing.assert_array_equal(res["int8_train"], want.detach().numpy())


def sharded_grads(a, results):
    """The ranks' gradients as whole arrays: the queries' rows from seq index
    0 (equal across each seq row), pos summed over the data ranks (each row
    sums its own over seq), K/V assembled from every rank's block."""
    l = a["mask"].shape[1]
    grads = {n: row_major(results, "grads", n) for n in ("q_smax", "q_coda")}
    grads["pos"] = sum(results[2 * d]["grads"]["pos"] for d in range(2))
    for n in ("k", "v"):
        whole = np.zeros_like(a[n])
        for r, res in enumerate(results):
            d, s = divmod(r, 2)
            whole[:, 2 * d:2 * d + 2, s * l // 2:(s + 1) * l // 2] = res["grads"][n]
        grads[n] = whole
    return grads


def test_spmd_trainable_grads_match_jax(spmd_job, mesh22):
    a, results, _ = spmd_job
    got = sharded_grads(a, results)
    for s in range(2):   # each seq row's pos gradient is the whole row's
        np.testing.assert_array_equal(results[s]["grads"]["pos"], results[0]["grads"]["pos"])
    mask, r = jnp.asarray(a["mask"]), jnp.asarray(a["r"])

    def loss(qs, qc, pos, k, v):
        return jnp.sum(j_trainable(qs, qc, k, v, mask, pos, 1, mesh22) * r)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a[s]) for s in ("uqs", "uqc", "pos", "k", "v")))
    for name, w in zip(("q_smax", "q_coda", "pos", "k", "v"), want):
        np.testing.assert_allclose(got[name], np.asarray(w), **VJP_TOL, err_msg=name)
    assert np.abs(got["k"]).max() > 0


def test_spmd_trainable_grads_match_one_rank(spmd_job):
    a, results, _ = spmd_job
    got = sharded_grads(a, results)
    leaves = {n: torch.from_numpy(a[s]).requires_grad_()
              for n, s in (("q_smax", "uqs"), ("q_coda", "uqc"), ("pos", "pos"), ("k", "k"),
                           ("v", "v"))}
    out = fused_decoder_attention_trainable(leaves["q_smax"], leaves["q_coda"], leaves["k"],
                                            leaves["v"], torch.from_numpy(a["mask"]),
                                            leaves["pos"], 1)
    np.testing.assert_allclose(row_major(results, "train_out"), out.detach().numpy(), **VJP_TOL)
    (out * torch.from_numpy(a["r"])).sum().backward()
    for name, x in leaves.items():
        np.testing.assert_allclose(got[name], x.grad.numpy(), **VJP_TOL, err_msg=name)


def test_spmd_predict_matches_jax_mesh(spmd_job, mesh22, monkeypatch):
    """Each rank's (2 clips, 2 frames): logits equal across a seq row, the
    token-sharded attention taken (its collectives counted), against JAX's
    shard_map predict on the same layout."""
    a, results, (jdet, _) = spmd_job
    monkeypatch.setenv("DFD_SPMD_PALLAS", "1")
    xs = jax.device_put(a["x"], NamedSharding(mesh22, P("data", "seq")))
    ms = jax.device_put(a["m"], NamedSharding(mesh22, P("data")))
    want = jax.jit(lambda p, x, m: jdet.predict(p, x, m)[0][0])(a["det_params"], xs, ms)
    np.testing.assert_allclose(row_major(results, "predict"), np.asarray(want), **STEP_TOL)
    for res in results:   # 2 blocks: one MAX and one SUM each over the seq row
        traffic = res["predict_traffic"]
        assert set(traffic) == {"all_reduce_max seq", "all_reduce_sum seq"}, traffic
        assert traffic["all_reduce_max seq"] == 2 * 2 * 4 * 4   # blocks x B x H x f32


def test_indivisible_frames_take_the_one_rank_path(spmd_job):
    """3 frames on 2 seq ranks: each rank decodes the whole clips, no
    collective runs, and the logits are the one-process port's bit for bit
    (and JAX's at 1e-4)."""
    a, results, (_, jdet3) = spmd_job
    det3 = port_detector(3)
    params = det3.prepare_params(params_from_jax(a["det3_params"]))
    want = det3.predict(params, a["x3"], a["m3"])[0][0].numpy()
    for res in results:
        assert res["predict3_traffic"] == {}
        np.testing.assert_array_equal(res["predict3"], want)
    jwant = jdet3.predict(a["det3_params"], a["x3"], a["m3"])[0][0]
    np.testing.assert_allclose(want, np.asarray(jwant), **STEP_TOL)


def test_gathers_and_broadcast(spmd_job):
    _, results, _ = spmd_job
    counts = (3, 0, 2, 1)
    want_x = np.concatenate([np.arange(2 * n, dtype=np.float32).reshape(n, 2) + 100 * r
                             for r, n in enumerate(counts)])
    want_label = np.concatenate([np.full(n, r) for r, n in enumerate(counts)])
    for res in results:
        np.testing.assert_array_equal(res["ragged"]["x"], want_x)
        np.testing.assert_array_equal(res["ragged"]["label"], want_label)
        assert res["broadcast"] == "run-of-rank-0"
        p, flags, scalar = res["metrics"]   # seq index 0 speaks for its row, data order
        np.testing.assert_array_equal(p["p"], np.array([0, 1, 10, 11], np.float32))
        np.testing.assert_array_equal(flags["flag"], np.array([True, False, True, True]))
        assert flags["flag"].dtype == bool
        np.testing.assert_array_equal(scalar, np.array([0, 1], np.float32))
