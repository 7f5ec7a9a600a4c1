"""Rank programs for tests/test_torch_port_multirank*.py, and ``run_job``,
which spawns them.

    python tests/torch_multirank_jobs.py <job> <rank> <world> <workdir>

Each process is one rank of a Gloo process group over a FileStore under
``workdir`` (no TCP port), runs one job of the port (dfd_clip_tpu_torch;
nothing of JAX) on the CPU, reads its inputs from ``<workdir>/<job>_in.pkl``
(written by the test, numpy) and writes ``<workdir>/<job>_<rank>.pkl``.
"""

from __future__ import annotations

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dfd_clip_tpu_torch.runtime import MeshRuntime, launch  # noqa: E402

JOB_TIMEOUT = 300   # seconds a job's ranks may take


def run_job(job: str, world: int, workdir: Path, inputs: dict) -> list:
    """Spawn ``world`` ranks of ``job`` and return their results in rank
    order; a rank that fails, or a job past JOB_TIMEOUT, fails the caller
    with the ranks' logs."""
    import time

    with open(workdir / f"{job}_in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    logs = [workdir / f"{job}_{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), job,
                                           str(r), str(world), str(workdir)], cwd=str(workdir),
                                          stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + JOB_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{log.read_text()[-4000:]}"
    results = []
    for r in range(world):
        with open(workdir / f"{job}_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def t(a):
    return torch.from_numpy(np.array(a))


def tiny_detector(num_frames: int = 4, **over):
    """The port's Detector on the ViT-Test tower, f32 on the CPU."""
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0, 2], "out_dim": [2],
                              "losses": ["auc_roc"], **over})
    return Detector(cfg, num_frames=num_frames, compute_dtype=torch.float32, device="cpu")


# -- job "spmd": 4 ranks, (data 2, seq 2) ------------------------------------------------

def job_spmd(rt_args, a):
    from dfd_clip_tpu_torch.models.weights import params_from_jax
    from dfd_clip_tpu_torch.ops import spmd
    from dfd_clip_tpu_torch.ops.decoder_attention import dual_activation_attention
    from dfd_clip_tpu_torch.ops.decoder_attention_vjp import spmd_decoder_attention_trainable

    rt = MeshRuntime(seq_parallel=2, **rt_args)
    out = {"coords": (rt.data_index, rt.seq_index)}
    b, l = a["mask"].shape
    rows = rt.rows(b)
    toks = slice(rt.seq_index * l // 2, (rt.seq_index + 1) * l // 2)

    def loc(x, stacked=True):
        x = t(x)
        return (x[:, rows, toks] if stacked else x[rows, toks]).contiguous()

    qs, qc = t(a["qs"])[rows], t(a["qc"])[rows]
    k, v, mask, pos = loc(a["k"]), loc(a["v"]), loc(a["mask"], False), t(a["pos"])
    out["plain"] = {layer: spmd.spmd_decoder_attention(qs, qc, k, v, mask, pos, layer, rt).numpy()
                    for layer in (0, 1)}
    out["flat"] = spmd.spmd_decoder_attention(qs, qc, k[1].contiguous(), v[1].contiguous(), mask,
                                              pos, None, rt).numpy()
    out["dispatch"] = dual_activation_attention(qs, qc, k, v, mask, temporal_pos=pos,
                                                layer=1).numpy()
    # int8_rows K/V and the trainable form on unit-scale queries, as JAX's own
    # tests of those forms take them
    uqs, uqc = t(a["uqs"])[rows], t(a["uqc"])[rows]
    out["int8"] = spmd.spmd_decoder_attention(
        uqs, uqc, loc(a["kq"]), loc(a["vq"]), mask, pos, 1, rt, k_scale=loc(a["ks"]),
        v_scale=loc(a["vs"])).numpy()

    # int8_rows K/V in training stay on the one-rank path (a rank holding the
    # whole stream): no collective
    rt.traffic.clear()
    out["int8_train"] = dual_activation_attention(
        t(a["uqs"]), t(a["uqc"]), t(a["kq"]), t(a["vq"]), t(a["mask"]), temporal_pos=pos,
        layer=1, differentiable=True, k_scale=t(a["ks"]), v_scale=t(a["vs"])).detach().numpy()
    out["int8_train_traffic"] = dict(rt.traffic)

    # the trainable form: grads of sum(out * r) in the queries, pos and K/V
    leaves = {"q_smax": uqs.clone().requires_grad_(), "q_coda": uqc.clone().requires_grad_(),
              "pos": pos.clone().requires_grad_(), "k": k.clone().requires_grad_(),
              "v": v.clone().requires_grad_()}
    o = spmd_decoder_attention_trainable(leaves["q_smax"], leaves["q_coda"], leaves["k"],
                                         leaves["v"], mask, leaves["pos"], 1, rt)
    (o * t(a["r"])[rows]).sum().backward()
    out["grads"] = {n: x.grad.numpy() for n, x in leaves.items()}
    out["train_out"] = o.detach().numpy()

    # Detector.predict: this rank's clips x frames
    det = tiny_detector()
    params = det.prepare_params(params_from_jax(a["det_params"]))
    frames = rt.frames(a["x"].shape[1])
    rt.traffic.clear()
    logits, _ = det.predict(params, a["x"][rows][:, frames], a["m"][rows][:, frames])
    out["predict"] = logits[0].numpy()
    out["predict_traffic"] = dict(rt.traffic)
    # 3 frames do not split over 2 seq ranks: the whole clips, the one-rank path
    det3 = tiny_detector(num_frames=3)
    params3 = det3.prepare_params(params_from_jax(a["det3_params"]))
    rt.traffic.clear()
    out["predict3"] = det3.predict(params3, a["x3"], a["m3"])[0][0].numpy()
    out["predict3_traffic"] = dict(rt.traffic)

    n = (3, 0, 2, 1)[rt.process_index]
    mine = np.arange(2 * n, dtype=np.float32).reshape(n, 2) + 100 * rt.process_index
    out["ragged"] = rt.gather_ragged({"x": mine, "label": np.full(n, rt.process_index)})
    out["broadcast"] = rt.broadcast_str(f"run-of-rank-{rt.process_index}")
    out["metrics"] = rt.gather_for_metrics(
        ({"p": np.arange(2, dtype=np.float32) + 10 * rt.data_index},
         {"flag": np.array([True, rt.data_index == 1])}, np.float32(rt.data_index)))
    return out


# -- job "train": 2 ranks, (2, 1) then (1, 2) ---------------------------------------------

class ClipSet:
    """In-memory clips with the datasets' six-field items."""
    category, name = "deepfake", "ffpp"

    def __init__(self, x, labels, masks):
        from dfd_clip_tpu_torch.data.loader import default_collate

        self.x, self.labels, self.masks = x, labels, masks
        self.collate_fn = default_collate

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.x[i], int(self.labels[i]), self.masks[i], "raw", 1.0, 0


def job_train(rt_args, a):
    from dfd_clip_tpu_torch import inference as tinf
    from dfd_clip_tpu_torch.engine.evaluator import Evaluator
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.models.weights import params_from_jax, to_numpy_tree
    from dfd_clip_tpu_torch.ops.decoder_attention import dual_activation_attention

    out = {}
    for sp in (1, 2):
        rt = MeshRuntime(seq_parallel=sp, **rt_args)
        tcfg = Trainer.get_default_config()
        tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 1.0,
                                   "batch_size": a["x"].shape[0] // rt.data_parallel,
                                   "num_workers": 0})
        trainer = Trainer(tcfg, rt, tiny_detector(), [], params=params_from_jax(a["params"]))
        rows = rt.rows(a["x"].shape[0])
        n = rows.stop - rows.start
        batch = (a["x"][rows], a["label"][rows], a["m"][rows], ["raw"] * n, np.ones(n),
                 np.zeros(n, np.int64))
        prepared = trainer.prepare_batch(batch)
        trainer.train_step([("task0", prepared)])
        res = {"trainable": to_numpy_tree(trainer.trainable),
               "loss": trainer.batch_losses["task0"], "frames": prepared["x"].shape[1]}
        # the same step at dropout 0.5: the masks drawn for the global batch
        drop = Trainer(tcfg, rt, tiny_detector(dropout=0.5), [],
                       params=params_from_jax(a["params"]))
        drop.train_step([("task0", drop.prepare_batch(batch))])
        res["dropout"] = {"trainable": to_numpy_tree(drop.trainable),
                          "loss": drop.batch_losses["task0"]}
        # the dispatch in training: the sharded Function only at a seq width
        # above 1 (2 local tokens a frame, the whole embedding the row's)
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 1, 2, 16, generator=g, requires_grad=True)
        kv = torch.randn(2, 8, 2, 16, generator=g)
        pos = torch.randn(8 * sp, 2, 16, generator=g)
        o = dual_activation_attention(q, q, kv, kv, torch.ones(2, 8, dtype=torch.bool),
                                      temporal_pos=pos, differentiable=True)
        res["dispatch_fn"] = type(o.grad_fn).__name__
        if sp == 1:   # kv_dtype int8 on (2, 1): its scales over both ranks' clips
            det8 = tiny_detector(op_mode={"kv_dtype": "int8"})
            res["kv_int8"] = det8.predict(det8.prepare_params(params_from_jax(a["params"])),
                                          a["x"][rows], a["m"][rows])[0][0].numpy()

        ecfg = Evaluator.get_default_config()
        ecfg.merge_from_other_cfg({"batch_size": 3, "num_workers": 0})
        ev = Evaluator(ecfg, rt, [ClipSet(a["ex"], a["elabel"], a["em"])])
        seen = {"losses": [], "logits": [], "labels": []}

        def collect(agent):
            los, lg, y, valid = rt.gather_for_metrics(
                (agent.batch_losses, agent.batch_logits, agent.batch_labels, agent.batch_valid))
            keep = np.asarray(valid["deepfake/ffpp"])
            seen["losses"].append(np.asarray(los["deepfake/ffpp"])[keep])
            seen["logits"].append(np.asarray(lg["deepfake/ffpp"])[keep])
            seen["labels"].append(np.asarray(y["deepfake/ffpp"])[keep])

        ev.add_callback("on_batch_end", collect)
        ev.run(trainer)
        res["eval"] = {k: np.concatenate(v) for k, v in seen.items()}
        out[f"sp{sp}"] = res
        rt.deactivate()

    # the 768-bn calibration with each rank's half of the batches, its counts
    # and sums added over the two ranks
    from dfd_clip_tpu_torch.models import adapter as adapter_lib

    rt = MeshRuntime(**rt_args)
    cfg = adapter_lib.AdapterConfig(**a["bn_cfg"])
    params = adapter_lib.init_adapter(torch.Generator().manual_seed(0), cfg)
    bn = adapter_lib.calibrate_bn_stats(params, a["bn_batches"][rt.process_index::2], cfg,
                                        rt.all_reduce_)
    out["bn"] = [{s: {k: v.numpy() for k, v in blk[s]["bn"].items()} for s in ("k", "v")}
                 for blk in bn["blocks"]]
    rt.deactivate()

    # inference.main on two ranks, the Detector in f32 as the one-process run's
    Detector.__init__.__defaults__ = (torch.float32, *Detector.__init__.__defaults__[1:])
    out["report"] = tinf.main(tinf.parse_args([a["run_dir"], "--batch_size", "3",
                                               "--modality", "video", "--num_workers", "0",
                                               "--device", "cpu", "--video_backend", "opencv"]))
    return out


# -- job "ssl": 2 ranks, fsdp 0 and 1, checkpoint and resume ------------------------------

class Images:
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.random.default_rng(i).integers(0, 255, (64, 64, 3), dtype=np.uint8)


def job_ssl(rt_args, a):
    from dfd_clip_tpu_torch.engine.optim import named_leaves
    from dfd_clip_tpu_torch.ssl import SSLTrainer

    rt = MeshRuntime(**rt_args)
    out = {}

    def trainer(**over):
        cfg = SSLTrainer.get_default_config()
        cfg.merge_from_other_cfg({**a["config"], **over})
        return SSLTrainer(cfg, rt, Images(), device="cpu")

    plain = trainer(fsdp=0)
    out["fsdp0_metrics"] = plain.run()
    out["fsdp0"] = rt.materialize(plain.student)
    sharded = trainer(fsdp=1, checkpoint_interval=a["config"]["max_steps"],
                      checkpoint_dir=a["ckpt_dir"])
    flags = [f for _, f in named_leaves(sharded.sharded)]
    local = [x.shape for _, x in named_leaves(sharded.student)]
    out["fsdp1_metrics"] = sharded.run()
    # each held tensor's storage against its own bytes: a slice keeps no whole leaf alive
    held = [x for tree in (sharded.student, sharded.teacher) for _, x in named_leaves(tree)]
    held += sharded.optimizer.mu + sharded.optimizer.nu
    out["storage"] = [(x.untyped_storage().nbytes(), x.numel() * x.element_size())
                      for x in held]
    out["fsdp1"] = rt.materialize(sharded.student, sharded.sharded)
    out["sharded_leaves"] = (sum(flags), len(flags), local)
    resumed = trainer(fsdp=1, checkpoint_interval=a["config"]["max_steps"],
                      checkpoint_dir=a["ckpt_dir"])
    out["start_step"] = resumed.start_step
    whole = rt.materialize(resumed.student, resumed.sharded)
    out["resumed"] = whole
    out["checksum"] = float(sum(np.float64(np.sum(x)) for _, x in named_leaves(whole)))
    out["opt_count"] = resumed.optimizer.count
    return out


# -- job "sk": 2 ranks, (data 2, seq 1): Sinkhorn-Knopp over the global batch ------------

def job_sk(rt_args, a):
    """Each rank's images of both crops: the CLS assignment and the masked
    patches' (the masked form's count summed over the ranks)."""
    from dfd_clip_tpu_torch.ssl import losses

    rt = MeshRuntime(**rt_args)
    rows = rt.rows(a["cls"].shape[1])
    two, k = a["cls"].shape[0], a["cls"].shape[-1]
    cls = t(a["cls"][:, rows]).reshape(-1, k)
    patch = t(a["patch"][:, rows]).reshape(-1, *a["patch"].shape[2:])
    mask = t(a["mask"][:, rows]).reshape(-1, a["mask"].shape[-1])
    out = {"cls": losses.sinkhorn_knopp(cls, a["temp"], layout=rt).reshape(two, -1, k).numpy(),
           "patch": losses.sinkhorn_knopp_masked(patch, mask, a["temp"], layout=rt)
           .reshape(two, -1, *a["patch"].shape[2:]).numpy()}
    rt.deactivate()
    return out


# -- job "koleo": 2 ranks, (data 2, seq 1): KoLeo over the global batch ------------------

def ssl_trainer(runtime, config: dict):
    """An SSLTrainer of the tiny config on the CPU (the same seeded student
    on every rank and in one process), its towers in f32: in bf16 a batch
    of 2 and one of 4 round apart."""
    from dfd_clip_tpu_torch.ssl import SSLTrainer

    cfg = SSLTrainer.get_default_config()
    cfg.merge_from_other_cfg(config)
    trainer = SSLTrainer(cfg, runtime, Images(), device="cpu")
    trainer.meta.compute_dtype = torch.float32
    return trainer


def record_grads(trainer) -> list:
    """A list that holds, after each step, the gradients the trainer's
    optimizer took (on several ranks: their mean over the ranks)."""
    seen, step = [], trainer.optimizer.step

    def recorded(grads, *args, **kw):
        seen[:] = [g.detach().numpy().copy() for g in grads]
        return step(grads, *args, **kw)

    trainer.optimizer.step = recorded
    return seen


def job_koleo(rt_args, a):
    """The rank's rows of a global batch: KoLeo's value and its gradient in
    the rank's features, then one SSL step on the rank's images of both
    crops (its metrics, the gradients its optimizer took and the student
    after it)."""
    from dfd_clip_tpu_torch.ssl import losses

    rt = MeshRuntime(**rt_args)
    rows = rt.rows(a["features"].shape[0])
    f = t(a["features"][rows]).requires_grad_()
    value = losses.koleo_loss(f, layout=rt)
    value.backward()
    out = {"value": float(value), "grad": f.grad.numpy().copy()}
    rows = rt.rows(a["globals"].shape[1])
    trainer = ssl_trainer(rt, a["config"])
    out["grads"] = record_grads(trainer)
    metrics = trainer.train_step(t(a["globals"][:, rows]), t(a["locals"][:, rows]),
                                 t(a["masks"][:, rows]), 0)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["student"] = rt.materialize(trainer.student)
    rt.deactivate()
    return out


def grads_of(trainer) -> list:
    """The trainable leaves' gradients of the last step (as the optimizer
    took them: the mean over the ranks), in named_leaves order; None for a
    leaf the loss does not read (the BN running statistics)."""
    from dfd_clip_tpu_torch.engine.optim import named_leaves

    return [None if x.grad is None else x.grad.detach().numpy().copy()
            for _, x in named_leaves(trainer.trainable)]


# -- job "stats": 2 ranks, (data 2, seq 1): steps whose statistics span the batch -----------

def job_stats(rt_args, a):
    """A Trainer step of a Detector with a 768-bn adapter (its training
    statistics over the global batch) and a CompInvTrainer step (its loss
    maps summed over the global batch's pairs), each on the rank's rows."""
    from dfd_clip_tpu_torch.engine.trainer import CompInvTrainer, Trainer
    from dfd_clip_tpu_torch.models import CompInvEncoder
    from dfd_clip_tpu_torch.models.weights import params_from_jax, to_numpy_tree

    rt = MeshRuntime(**rt_args)
    out = {}
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 1.0,
                               "batch_size": a["x"].shape[0] // rt.data_parallel,
                               "num_workers": 0})
    trainer = Trainer(tcfg, rt, tiny_detector(adapter=a["bn_adapter"]), [],
                      params=params_from_jax(a["bn_params"]))
    rows = rt.rows(a["x"].shape[0])
    n = rows.stop - rows.start
    batch = (a["x"][rows], a["label"][rows], a["m"][rows], ["raw"] * n, np.ones(n),
             np.zeros(n, np.int64))
    trainer.train_step([("task0", trainer.prepare_batch(batch))])
    out["bn"] = {"trainable": to_numpy_tree(trainer.trainable),
                 "loss": trainer.batch_losses["task0"], "grads": grads_of(trainer)}

    ccfg = CompInvEncoder.get_default_config()
    ccfg.merge_from_other_cfg(a["compinv_cfg"])
    enc = CompInvEncoder(ccfg, num_frames=a["ci_x"].shape[1], compute_dtype=torch.float32,
                         device="cpu")
    ctcfg = CompInvTrainer.get_default_config()
    ctcfg.merge_from_other_cfg({"max_steps": 10, "num_workers": 0, "learning_rate": 1.0,
                                "batch_size": a["ci_x"].shape[0] // rt.data_parallel})
    ctr = CompInvTrainer(ctcfg, rt, enc, [], params=params_from_jax(a["ci_params"]))
    rows = rt.rows(a["ci_x"].shape[0])
    n = rows.stop - rows.start
    ctr.train_step([("task0", ctr.prepare_batch((a["ci_x"][rows], np.zeros(n), a["ci_m"][rows],
                                                 list(a["ci_comps"][rows]))))])
    out["compinv"] = {"trainable": to_numpy_tree(ctr.trainable), "grads": grads_of(ctr),
                      **{k: ctr.batch_losses[k] for k in ("recon", "match")}}
    rt.deactivate()
    return out


JOBS = {"spmd": job_spmd, "train": job_train, "ssl": job_ssl, "sk": job_sk,
        "koleo": job_koleo, "stats": job_stats}


def main() -> None:
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    launch.initialize("gloo", init_method=f"file://{workdir}/{job}_store", world_size=world,
                      rank=rank)
    with open(Path(workdir) / f"{job}_in.pkl", "rb") as f:
        inputs = pickle.load(f)
    try:
        out = JOBS[job]({"device": "cpu", "backend": "gloo"}, inputs)
        with open(Path(workdir) / f"{job}_{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        launch.shutdown()


if __name__ == "__main__":
    main()
