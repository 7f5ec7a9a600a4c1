"""Sinkhorn-Knopp and KoLeo over two ranks' global batch (the "sk" and
"koleo" jobs: KoLeo's value and feature gradients, and an SSL step with it,
against one process on the global batch and JAX's koleo_loss), SSL
pretraining on two ranks with ``fsdp: 1`` (the counterpart of JAX's
tests/test_multihost.py::test_two_process_ssl_fsdp_checkpoint), and the
runtime's pieces that need no second rank: the card as every runtime's
default device, KeySeq, device.sync / timed, the launcher's variables.

The "ssl" job (tests/torch_multirank_jobs.py: two Gloo ranks over a
FileStore) trains the tiny SSL config (ViT-Test, batch 1 a rank) for 2
steps with ``fsdp: 0`` and again with ``fsdp: 1``, which keeps each
shardable leaf as the rank's slice and checkpoints at step 2, then builds
a third trainer that resumes from that checkpoint. Held: the sharded run
equal to the replicated one at 1e-5 (the same steps; the gradient's norm
and sums are taken in another order), the resumed trainer at step 2 with
the optimizer's count, its gathered student bit-equal to the run's, and
the same checksum on both ranks.
"""

import numpy as np
import pytest
import torch

from dfd_clip_tpu_torch.engine.optim import named_leaves
from torch_multirank_jobs import run_job, ssl_trainer

SSL_TOL = dict(rtol=1e-5, atol=1e-5)
CONFIG = {"arch": "ViT-Test", "batch_size": 1, "max_steps": 2, "out_dim": 64,
          "n_local_crops": 2, "local_size": 14, "warmup_steps": 1,
          "warmup_teacher_temp_steps": 1, "freeze_last_layer_steps": 1}


@pytest.fixture(scope="module")
def ssl_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("ssl")
    return run_job("ssl", 2, work, {"config": CONFIG, "ckpt_dir": str(work / "ckpt")})


def test_fsdp_step_equals_replicated_step(ssl_job):
    for res in ssl_job:
        for k in ("dino", "ibot", "koleo", "total"):
            assert np.isfinite(res["fsdp1_metrics"][k])
            assert res["fsdp1_metrics"][k] == pytest.approx(res["fsdp0_metrics"][k], rel=1e-5)
        for (path, a), (_, b) in zip(named_leaves(res["fsdp1"]), named_leaves(res["fsdp0"])):
            np.testing.assert_allclose(a, b, **SSL_TOL, err_msg=str(path))
    for (path, a), (_, b) in zip(named_leaves(ssl_job[0]["fsdp1"]),
                                 named_leaves(ssl_job[1]["fsdp1"])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))   # one model on both ranks


def test_fsdp_holds_slices(ssl_job):
    """The leaves whose leading axis 2 divides are held as halves; the
    gathered leaves have the whole shape. Each held tensor (student,
    teacher, Adam moments) owns storage of its own size: no slice is a view
    that keeps its whole leaf alive."""
    for res in ssl_job:
        for storage, own in res["storage"]:
            assert storage == own
    n_sharded, n_leaves, local = ssl_job[0]["sharded_leaves"]
    assert 0 < n_sharded < n_leaves
    whole = [a.shape for _, a in named_leaves(ssl_job[0]["fsdp1"])]
    halves = sum(1 for lo, wh in zip(local, whole)
                 if tuple(lo) != tuple(wh) and lo[0] * 2 == wh[0] and lo[1:] == wh[1:])
    assert halves == n_sharded
    assert all(tuple(lo) == tuple(wh) for lo, wh in zip(local, whole)
               if not (lo[0] * 2 == wh[0] and tuple(lo) != tuple(wh)))


def test_fsdp_checkpoint_resume(ssl_job):
    for res in ssl_job:
        assert res["start_step"] == 2 and res["opt_count"] == 2
        for (path, a), (_, b) in zip(named_leaves(res["resumed"]), named_leaves(res["fsdp1"])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert ssl_job[0]["checksum"] == ssl_job[1]["checksum"]
    assert np.isfinite(ssl_job[0]["checksum"])


@pytest.fixture(scope="module")
def sk_job(tmp_path_factory):
    """The "sk" job's inputs: 2 crops of 4 images' CLS logits and 5 patches'
    logits (K = 16) at a temperature that keeps every exp above f32's
    subnormals (where the order of a sum would show), masks that differ
    between the ranks' images (one image with no masked patch)."""
    rng = np.random.default_rng(3)
    a = {"cls": rng.standard_normal((2, 4, 16)).astype(np.float32),
         "patch": rng.standard_normal((2, 4, 5, 16)).astype(np.float32),
         "mask": rng.random((2, 4, 5)) < 0.4, "temp": 0.5}
    a["mask"][:, 0] = True
    a["mask"][1, 3] = False
    return a, run_job("sk", 2, tmp_path_factory.mktemp("sk"), a)


def test_sinkhorn_knopp_spans_the_global_batch(sk_job):
    """Sinkhorn-Knopp at (data 2, seq 1), each rank holding 2 of the 4
    images of both crops: the ranks' assignments put together are one
    process's over the global batch and JAX's with the batch sharded over a
    (2, 1) mesh, CLS and masked patches alike; one rank's own batch alone
    gives other assignments."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dfd_clip_tpu.ssl import losses as jlosses
    from dfd_clip_tpu_torch.ssl import losses
    from test_torch_port_multirank import jax_mesh

    a, res = sk_job
    k = a["cls"].shape[-1]
    got_cls = np.concatenate([r["cls"] for r in res], axis=1)
    got_patch = np.concatenate([r["patch"] for r in res], axis=1)
    cls, patch, mask = (torch.from_numpy(np.ascontiguousarray(a[n])) for n in ("cls", "patch",
                                                                              "mask"))
    want_cls = losses.sinkhorn_knopp(cls.reshape(-1, k), a["temp"]).reshape(2, 4, k)
    want_patch = losses.sinkhorn_knopp_masked(patch.reshape(8, 5, k), mask.reshape(8, 5),
                                              a["temp"]).reshape(2, 4, 5, k)
    np.testing.assert_allclose(got_cls, want_cls.numpy(), **SSL_TOL)
    np.testing.assert_allclose(got_patch, want_patch.numpy(), **SSL_TOL)

    mesh = jax_mesh(2, 1)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("data")))   # noqa: E731
    jcls = jax.jit(jlosses.sinkhorn_knopp)(put(a["cls"].reshape(-1, k)), a["temp"])
    jpatch = jax.jit(jlosses.sinkhorn_knopp_masked)(put(a["patch"].reshape(8, 5, k)),
                                                    put(a["mask"].reshape(8, 5)), a["temp"])
    np.testing.assert_allclose(got_cls, np.asarray(jcls).reshape(2, 4, k), **SSL_TOL)
    np.testing.assert_allclose(got_patch, np.asarray(jpatch).reshape(2, 4, 5, k), **SSL_TOL)

    local = losses.sinkhorn_knopp(cls[:, :2].reshape(-1, k), a["temp"]).reshape(2, 2, k)
    assert not np.allclose(local.numpy(), got_cls[:, :2], **SSL_TOL)
    assert np.isfinite(got_patch).all() and (got_patch[~a["mask"]] == 0).all()


KOLEO_CONFIG = {"arch": "ViT-Test", "batch_size": 2, "max_steps": 2, "out_dim": 64,
                "n_local_crops": 2, "local_size": 14, "warmup_steps": 0,
                "warmup_teacher_temp_steps": 0, "freeze_last_layer_steps": 0}


@pytest.fixture(scope="module")
def koleo_job(tmp_path_factory):
    """The "koleo" job's inputs: 6 features of 8 lanes (3 a rank), and a
    global batch of 4 images (2 a rank) of both global crops, the local
    crops and the block masks, for one SSL step at (data 2, seq 1)."""
    rng = np.random.default_rng(5)
    a = {"features": np.random.default_rng(6).standard_normal((6, 8)).astype(np.float32),
         "globals": rng.standard_normal((2, 4, 3, 28, 28)).astype(np.float32),
         "locals": rng.standard_normal((2, 4, 3, 14, 14)).astype(np.float32),
         "masks": rng.random((2, 4, 4)) < 0.5, "config": KOLEO_CONFIG}
    return a, run_job("koleo", 2, tmp_path_factory.mktemp("koleo"), a)


def test_koleo_spans_the_global_batch(koleo_job):
    """Each rank's KoLeo is the mean over its own rows of the distance to
    the nearest neighbour over the global batch: the ranks' mean equals one
    process's value and JAX's koleo_loss on the whole batch, and the ranks'
    feature gradients put together are the global loss's times the data
    width (the trainers divide the ranks' summed gradients by it), a row
    that is another rank's neighbour included; the rank's own batch alone
    gives another value."""
    import jax

    from dfd_clip_tpu.ssl import losses as jlosses
    from dfd_clip_tpu_torch.ssl import losses

    a, res = koleo_job
    f = torch.from_numpy(a["features"]).requires_grad_()
    want = losses.koleo_loss(f)
    want.backward()
    got = np.mean([r["value"] for r in res])
    assert got == pytest.approx(want.item(), rel=1e-5)
    jval, jgrad = jax.value_and_grad(jlosses.koleo_loss)(a["features"])
    assert got == pytest.approx(float(jval), rel=1e-5)
    grads = np.concatenate([r["grad"] for r in res]) / len(res)
    np.testing.assert_allclose(grads, f.grad.numpy(), **SSL_TOL)
    np.testing.assert_allclose(grads, np.asarray(jgrad), **SSL_TOL)
    # the neighbours cross the ranks, so the gather's backward carries weight
    fn = a["features"] / np.linalg.norm(a["features"], axis=-1, keepdims=True)
    sim = fn @ fn.T - 2 * np.eye(6)
    assert (sim[:3].argmax(-1) >= 3).any() and (sim[3:].argmax(-1) < 3).any()
    local = float(losses.koleo_loss(torch.from_numpy(a["features"][:3])))
    assert local != pytest.approx(res[0]["value"], rel=1e-3)


def test_koleo_step_equals_one_process_step(koleo_job):
    """One SSL step at (data 2, seq 1), 2 images a rank, against one process
    on the same 4 images: the ranks' mean of each metric (KoLeo included)
    equals the one-process value, and so does every gradient the optimizer
    took (the ranks' mean), at 1e-5, the towers in f32 so that only the
    order of sums differs. The gradients are what is held, not the student
    after the step: the first Adam step moves a leaf by about lr x the sign
    of its gradient, so a gradient within rounding of 0 moves it by lr
    either way (1 value in 4 M differs by 1.5e-5)."""
    from dfd_clip_tpu_torch.runtime import OneProcess

    from torch_multirank_jobs import record_grads

    a, res = koleo_job
    one = ssl_trainer(OneProcess("cpu"), {**a["config"], "batch_size": 4})
    grads = record_grads(one)
    metrics = one.train_step(*(torch.from_numpy(a[k]) for k in ("globals", "locals", "masks")), 0)
    for k in ("dino", "ibot", "koleo", "total"):
        got = np.mean([r["metrics"][k] for r in res])
        assert np.isfinite(got) and got == pytest.approx(float(metrics[k]), rel=1e-5), k
    assert 0 < float(metrics["koleo"]) < 5   # finite distances, not -log(eps)
    paths = [p for p, _ in named_leaves(one.student)]
    for r in res:
        assert len(r["grads"]) == len(grads) == len(paths)
        for path, g, want in zip(paths, r["grads"], grads):
            np.testing.assert_allclose(g, want, **SSL_TOL, err_msg=str(path))


def test_runtime_without_a_device_is_the_card():
    """OneProcess and MeshRuntime built without a device take the card, and
    without one they raise: they never land on the CPU."""
    from dfd_clip_tpu_torch.runtime import MeshRuntime, OneProcess

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for build in (OneProcess, MeshRuntime):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert OneProcess("cpu").device == torch.device("cpu")


def test_keyseq_streams():
    """runtime.prng.KeySeq (JAX's KeySeq): each next() a fresh generator,
    the stream reproducible from its seed, fold_in not advancing it."""
    from dfd_clip_tpu_torch.runtime import KeySeq

    a, b = KeySeq(3), KeySeq(3)
    draws = [torch.rand(4, generator=a.next()) for _ in range(3)]
    assert all(torch.equal(d, torch.rand(4, generator=b())) for d in draws)
    assert not torch.equal(draws[0], draws[1])
    f1, f2 = (torch.rand(4, generator=a.fold_in(7)) for _ in range(2))
    assert torch.equal(f1, f2)
    assert not torch.equal(f1, torch.rand(4, generator=a.fold_in(8)))
    assert torch.equal(torch.rand(4, generator=a.next()), torch.rand(4, generator=b.next()))


def test_device_sync_and_timed_without_a_card():
    """device.sync returns its tree (nothing to wait for on the host);
    device.timed measures on the card only, and raises without one."""
    from dfd_clip_tpu_torch.device import sync, timed

    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    assert sync(tree) is tree
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="on the card"):
        timed(torch.ones, 2)


def test_launch_reads_the_launchers_variables(monkeypatch):
    """runtime.launch: torchrun's and SLURM's variables (the first host of
    SLURM's node list, through scontrol), nothing without either, and
    initialize() starting nothing then."""
    from dfd_clip_tpu_torch.runtime import launch

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_JOB_NODELIST", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    assert launch.torchrun_env() is None and launch.slurm_env() is None
    assert launch.initialize("gloo") is False
    assert launch.local_rank() == 0 and launch.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert launch.torchrun_env() == {"init_method": "env://", "world_size": 8, "rank": 3}
    assert launch.local_rank() == 1
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_NTASKS", "16")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "node[07-08]")
    calls = []

    def scontrol(cmd, text):
        calls.append(cmd)
        return "node07\nnode08\n"

    monkeypatch.setattr(launch.subprocess, "check_output", scontrol)
    assert launch.slurm_env() == {"init_method": f"tcp://node07:{launch.DEFAULT_PORT}",
                                  "world_size": 16, "rank": 5}
    assert calls == [["scontrol", "show", "hostnames", "node[07-08]"]]
    with pytest.raises(ValueError, match="world_size and rank"):
        launch.initialize("gloo", init_method="file:///nowhere")
