"""SSL pretraining in the port (dfd_clip_tpu_torch.ssl on the CPU, plain
versions) against the JAX package (dfd_clip_tpu.ssl) on the same numpy
inputs, with the weights carried across: every loss, the schedules, the
optimizer against its optax chain across the prototype freeze window and
its labels leaf by leaf, ``forward_loss`` and its gradients against
``jax.grad`` in both centerings, the host side (multi-crop augmentation,
block masks, samplers) byte for byte, two ``SSLTrainer`` steps against
JAX's ``SSLTrainer``, checkpoint and resume, and the training CLI with a
teacher that JAX's ``load_params`` and ``dinov2_forward`` read.

Tolerances, with their reasons:
* the losses: f32 within 1e-6 relative (the same f32 operations, sums in
  other orders over at most 64 values a row);
* the schedules: within 1e-6 of the schedule's scale (its largest
  endpoint): the port computes in float64, optax in f32, whose own error
  near the cosine's end (1 + cos(pi p) cancels) is 2e-5 of the value there
  but under 1e-8 of the scale;
* the optimizer over 3 steps: every parameter within 1e-6 (relative to the
  leaf's largest value, absolute 1e-7): Adam's moments and the global norm
  sum in other orders;
* ``forward_loss``: f32 loss and metrics within 1e-4 relative, each
  gradient leaf within a relative L2 of 1e-4 (the towers' f32 sums in other
  orders, through softmaxes at temperatures 0.04 and 0.1); bf16 within a
  relative L2 of 5e-2 a leaf and 1e-2 on the loss (the towers round
  activations to bf16 at other points: GELU, LayerNorm's cast, the
  attention's probabilities);
* two trainer steps (bf16 towers, drop path 0): each step's losses within
  2e-2 relative;
* resume: bit-equal on the CPU.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfd_clip_tpu.models import dinov2_vit as jdino
from dfd_clip_tpu.runtime import MeshRuntime
from dfd_clip_tpu.ssl import augmentations as jaug
from dfd_clip_tpu.ssl import losses as jloss
from dfd_clip_tpu.ssl import samplers as jsamplers
from dfd_clip_tpu.ssl import schedules as jsched
from dfd_clip_tpu.ssl.masking import BlockMaskGenerator as JMasks
from dfd_clip_tpu.ssl.meta_arch import SSLConfig as JSSLConfig
from dfd_clip_tpu.ssl.meta_arch import SSLMetaArch as JSSLMetaArch
from dfd_clip_tpu.ssl.train import SSLTrainer as JSSLTrainer
from dfd_clip_tpu_torch import ssl_train
from dfd_clip_tpu_torch.engine.optim import named_leaves
from dfd_clip_tpu_torch.models import dinov2_vit as tdino
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.runtime import OneProcess
from dfd_clip_tpu_torch.ssl import augmentations as taug
from dfd_clip_tpu_torch.ssl import losses as tloss
from dfd_clip_tpu_torch.ssl import samplers as tsamplers
from dfd_clip_tpu_torch.ssl import schedules as tsched
from dfd_clip_tpu_torch.ssl.masking import BlockMaskGenerator as TMasks
from dfd_clip_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch
from dfd_clip_tpu_torch.ssl.train import FROZEN_LEAVES, SSLTrainer

ARCH = jdino.ARCHITECTURES["ViT-Test"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- losses ------------------------------------------------------------------------------

@pytest.fixture
def logits():
    """Prototype logits at the heads' scale (cosines times last_g = 1), where
    exp(logits / 0.04) keeps every prototype's column sum above 0."""
    rng = np.random.default_rng(0)
    return {"s": (0.3 * rng.standard_normal((4, 5, 64))).astype(np.float32),
            "t": (0.3 * rng.standard_normal((2, 5, 64))).astype(np.float32),
            "c": (0.1 * rng.standard_normal(64)).astype(np.float32),
            "sp": (0.3 * rng.standard_normal((6, 9, 64))).astype(np.float32),
            "tp": (0.3 * rng.standard_normal((6, 9, 64))).astype(np.float32),
            "mask": rng.random((6, 9)) < 0.4}


@pytest.mark.parametrize("sinkhorn", [False, True], ids=["centering", "sinkhorn_knopp"])
def test_dino_and_ibot_losses_match_jax(logits, sinkhorn):
    L = logits
    temp = 0.04
    tp_d = tp_i = jtp_d = jtp_i = None
    if sinkhorn:
        jtp_d = jloss.sinkhorn_knopp(jnp.asarray(L["t"].reshape(10, 64)), temp).reshape(2, 5, 64)
        tp_d = tloss.sinkhorn_knopp(t(L["t"].reshape(10, 64)), temp).reshape(2, 5, 64)
        close(tp_d, jtp_d, 1e-6, "sinkhorn_knopp")
        jtp_i = jloss.sinkhorn_knopp_masked(jnp.asarray(L["tp"]), jnp.asarray(L["mask"]), temp)
        tp_i = tloss.sinkhorn_knopp_masked(t(L["tp"]), t(L["mask"]), temp)
        close(tp_i, jtp_i, 1e-6, "sinkhorn_knopp_masked")
    want, wc = jloss.dino_loss(jnp.asarray(L["s"]), jnp.asarray(L["t"]), jnp.asarray(L["c"]),
                               0.1, temp, teacher_probs=jtp_d)
    got, gc = tloss.dino_loss(t(L["s"]), t(L["t"]), t(L["c"]), 0.1, temp, teacher_probs=tp_d)
    close(got, want, 1e-6, "dino_loss")
    close(gc, wc, 1e-6, "dino center")
    close(tloss.update_center(t(L["c"]), gc, 0.9),
          jloss.update_center(jnp.asarray(L["c"]), wc, 0.9), 1e-6, "update_center")
    want, wc = jloss.ibot_patch_loss(jnp.asarray(L["sp"]), jnp.asarray(L["tp"]),
                                     jnp.asarray(L["mask"]), jnp.asarray(L["c"]), 0.1, temp,
                                     teacher_probs=jtp_i)
    got, gc = tloss.ibot_patch_loss(t(L["sp"]), t(L["tp"]), t(L["mask"]), t(L["c"]), 0.1, temp,
                                    teacher_probs=tp_i)
    close(got, want, 1e-6, "ibot_patch_loss")
    close(gc, wc, 1e-6, "ibot center")


def test_empty_mask_and_koleo_match_jax(logits):
    L = logits
    empty = np.zeros((6, 9), bool)
    got = tloss.sinkhorn_knopp_masked(t(L["tp"]), t(empty), 0.04)
    assert torch.count_nonzero(got) == 0 and torch.isfinite(got).all()
    loss, _ = tloss.ibot_patch_loss(t(L["sp"]), t(L["tp"]), t(empty), t(L["c"]), 0.1, 0.04)
    assert loss.item() == 0.0
    feats = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    close(tloss.koleo_loss(t(feats)), jloss.koleo_loss(jnp.asarray(feats)), 1e-6, "koleo")


# -- schedules and the optimizer ---------------------------------------------------------

def test_schedules_match_jax():
    for args in [(0.004, 1e-6, 100, 10, 0.0, 0), (0.07, 0.07, 50, 20, 0.04, 0),
                 (1.0, 0.0, 100, 10, 0.0, 5), (0.04, 0.4, 7, 0, 0.0, 0)]:
        js, ts = jsched.cosine_with_warmup(*args), tsched.cosine_with_warmup(*args)
        scale = max(abs(args[0]), abs(args[1]), abs(args[4]))
        for step in (0, 1, 3, 5, 9, 10, 11, 50, 99, 100, 150):
            assert abs(ts(step) - float(js(step))) <= 1e-6 * scale, (args, step)
    assert tsched.sqrt_lr_scaling(0.004, 256) == jsched.sqrt_lr_scaling(0.004, 256)


@functools.lru_cache(maxsize=None)
def _jax_init(out_dim: int):
    cfg = JSSLConfig(arch=ARCH, out_dim=out_dim, ibot_out_dim=out_dim, local_size=14,
                     n_local_crops=2, head_hidden_dim=32, head_bottleneck_dim=16)
    student, teacher, centers = jax.jit(JSSLMetaArch(cfg).init_params)(jax.random.key(0))
    return cfg, jax.tree_util.tree_map(np.asarray, (student, teacher, centers))


def _jax_student(out_dim=16):
    """JAX's SSLMetaArch init (config, (student, teacher, centers)) as
    numpy; a fresh copy of one cached draw."""
    cfg, trees = _jax_init(out_dim)
    return cfg, jax.tree_util.tree_map(np.copy, trees)


def test_optimizer_labels_match_jax_leaf_by_leaf():
    _, (student, _, _) = _jax_student()
    want = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(
                jsched._param_labels(student, ARCH.layers),
                is_leaf=lambda x: isinstance(x, tuple))[0]}
    port = params_from_jax(student)
    got = tsched.param_labels(port)
    assert len(got) == len(named_leaves(port))
    for path, lab in got:
        key = tuple(str(p) for p in path if not ("blocks" in path and p == path[
            path.index("blocks") + 1]))
        assert lab == want[key], (path, lab, want[key])
    labs = dict(got)
    assert labs[("backbone", "positional_embedding")] == (0, False, True)
    assert labs[("backbone", "blocks", 1, "ls1")] == (1, True, False)
    assert labs[("dino_head", "last_v")] == (2, False, False)


def test_optimizer_matches_optax_across_the_freeze_window():
    """Three steps with freeze_last_layer_steps 2: steps 0 and 1 zero the
    prototype layers' gradients and updates (the JAX train step's two
    multiplications by ``live``), step 2 moves them."""
    _, (student, _, _) = _jax_student()
    lr = jsched.cosine_with_warmup(0.05, 1e-3, 10, 2)
    wd = jsched.cosine_with_warmup(0.04, 0.4, 10)
    jopt = jsched.build_ssl_optimizer(student, lr, wd, n_layers=ARCH.layers)
    jp = jax.tree_util.tree_map(jnp.asarray, student)
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    tp = params_from_jax(student)
    topt = tsched.SSLOptimizer(tp, tsched.cosine_with_warmup(0.05, 1e-3, 10, 2),
                               tsched.cosine_with_warmup(0.04, 0.4, 10), n_layers=ARCH.layers)
    rng = np.random.default_rng(3)
    for step in range(3):
        # a norm above the clip on step 1 (scale 1), below on the others
        scale = 1.0 if step == 1 else 1e-3
        grads = jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), student)
        live = float(step >= 2)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        for head in ("dino_head", "ibot_head"):
            for leaf in ("last_v", "last_g"):
                jg[head][leaf] = jg[head][leaf] * live
        upd, jstate = update(jg, jstate, jp)
        for head in ("dino_head", "ibot_head"):
            for leaf in ("last_v", "last_g"):
                upd[head][leaf] = upd[head][leaf] * live
        jp = optax.apply_updates(jp, upd)
        tg = [g for _, g in named_leaves(params_from_jax(grads))]
        hold = ()
        if not live:
            tg = [torch.zeros_like(g) if p in FROZEN_LEAVES else g
                  for p, g in zip(topt.paths, tg)]
            hold = FROZEN_LEAVES
        topt.step(tg, hold)
        assert topt.count == step + 1
        want = dict(named_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jp))))
        for path, got in named_leaves(tp):
            w = want[path].numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=max(1e-6 * np.abs(w).max(), 1e-7), err_msg=str(path))
        moved = not np.array_equal(tp["dino_head"]["last_v"].numpy(), student["dino_head"]["last_v"])
        assert moved == (step >= 2)


# -- the meta-architecture ------------------------------------------------------------------

@pytest.mark.parametrize("centering", ["centering", "sinkhorn_knopp"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_loss_and_grads_match_jax(centering, dtype):
    jcfg, (student, teacher, centers) = _jax_student(32)
    jcfg = dataclasses.replace(jcfg, centering=centering)
    rng = np.random.default_rng(4)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32), teacher)
    centers = {"dino": (0.1 * rng.standard_normal(32)).astype(np.float32),
               "ibot": (0.1 * rng.standard_normal(32)).astype(np.float32)}
    g = rng.standard_normal((2, 2, 3, 28, 28)).astype(np.float32)
    loc = rng.standard_normal((2, 2, 3, 14, 14)).astype(np.float32)
    masks = rng.random((2, 2, 4)) < 0.5
    masks[0, 0] = False    # an image with no masked patch
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmeta = JSSLMetaArch(jcfg, compute_dtype=jdt)

    def loss_fn(s):
        total, (metrics, new_c) = jmeta.forward_loss(
            s, jax.tree_util.tree_map(jnp.asarray, teacher),
            jax.tree_util.tree_map(jnp.asarray, centers), jnp.asarray(g), jnp.asarray(loc),
            jnp.asarray(masks), jnp.asarray(0.05))
        return total, (metrics, new_c)

    (jtotal, (jm, jc)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, student))

    tcfg = SSLConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    ts = params_from_jax(student)
    leaves = [x.requires_grad_() for _, x in named_leaves(ts)]
    total, (metrics, new_c) = SSLMetaArch(tcfg, tdt).forward_loss(
        ts, params_from_jax(teacher), params_from_jax(centers), t(g), t(loc), t(masks), 0.05)
    grads = torch.autograd.grad(total, leaves)
    loss_tol, grad_tol = (1e-4, 1e-4) if dtype == "f32" else (1e-2, 5e-2)
    for k in ("dino", "ibot", "koleo", "total"):
        close(metrics[k].detach(), jm[k], loss_tol, k)
    for k in ("dino", "ibot"):
        close(new_c[k].detach(), jc[k], loss_tol, f"center {k}")
    want = dict(named_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))))
    for (path, _), gr in zip(named_leaves(ts), grads):
        err = rel_l2(gr.numpy(), want[path].numpy())
        assert err <= grad_tol, f"{path}: rel L2 {err:.3e} > {grad_tol:g}"


# -- host side ------------------------------------------------------------------------------

def test_augmentation_masks_and_samplers_byte_equal():
    img = np.random.default_rng(5).integers(0, 255, (64, 80, 3), dtype=np.uint8)
    ja = jaug.MultiCropAugmentation(global_size=28, local_size=14, n_local=3)
    ta = taug.MultiCropAugmentation(global_size=28, local_size=14, n_local=3)
    jr, tr = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(4):
        want, got = ja(img, jr), ta(img, tr)
        for k in ("global", "local"):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    jm, tm = JMasks(7, 0.1, 0.5), TMasks(7, 0.1, 0.5)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(tm.batch_masks(9, 0.5, tr), jm.batch_masks(9, 0.5, jr))
    for kw in ({}, {"shard_index": 1, "num_shards": 3}, {"advance": 11}):
        a, b = iter(tsamplers.ShardedInfiniteSampler(7, seed=3, **kw)), iter(
            jsamplers.ShardedInfiniteSampler(7, seed=3, **kw))
        assert [next(a) for _ in range(30)] == [next(b) for _ in range(30)]
        a, b = iter(tsamplers.InfiniteSampler(7, seed=3, **kw)), iter(
            jsamplers.InfiniteSampler(7, seed=3, **kw))
        assert [next(a) for _ in range(30)] == [next(b) for _ in range(30)]
    es, je = tsamplers.EpochSampler(9, 5, seed=2), jsamplers.EpochSampler(9, 5, seed=2)
    es.set_epoch(1)
    je.set_epoch(1)
    assert list(es) == list(je) and len(es) == len(je)


# -- the trainer ----------------------------------------------------------------------------

class Images:
    def __init__(self, n=16, size=64):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.default_rng(i).integers(0, 255, (self.size, self.size, 3),
                                                 dtype=np.uint8)


def tiny_config(**over) -> dict:
    cfg = {"arch": "ViT-Test", "batch_size": 2, "max_steps": 2, "out_dim": 64,
           "n_local_crops": 2, "local_size": 14, "warmup_steps": 1,
           "warmup_teacher_temp_steps": 1, "freeze_last_layer_steps": 1}
    cfg.update(over)
    return cfg


def port_trainer(tmp_path=None, params=None, **over) -> SSLTrainer:
    cfg = SSLTrainer.get_default_config()
    cfg.merge_from_other_cfg(tiny_config(**over))
    if tmp_path is not None:
        cfg.checkpoint_dir = str(tmp_path)
    return SSLTrainer(cfg, OneProcess("cpu"), Images(), device="cpu", params=params)


def recorded(trainer, attr):
    """Wrap ``trainer``'s step function to record each step's metrics."""
    seen = []
    fn = getattr(trainer, attr)

    def wrapped(*args):
        out = fn(*args)
        seen.append({k: float(v) for k, v in out[-1].items()})
        return out

    def wrapped_port(*args):
        out = fn(*args)
        seen.append({k: float(v) for k, v in out.items()})
        return out

    setattr(trainer, attr, wrapped if attr == "_step_fn" else wrapped_port)
    return seen


def test_trainer_steps_match_jax():
    """Two steps from the same params and data (batch 2, two local crops,
    the prototype layers frozen on step 0): each step's losses."""
    jcfg = JSSLTrainer.get_default_config()
    jcfg.merge_from_other_cfg(tiny_config())
    jtr = JSSLTrainer(jcfg, MeshRuntime(devices=jax.devices()[:1]), Images())
    params = [params_from_jax(jax.tree_util.tree_map(np.asarray, p))
              for p in (jtr.student, jtr.teacher, jtr.centers)]
    want = recorded(jtr, "_step_fn")
    jtr.run()
    tr = port_trainer(params=params)
    got = recorded(tr, "train_step")
    tr.run()
    assert len(got) == len(want) == 2
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("dino", "ibot", "koleo", "total"):
            assert np.isfinite(g[k])
            assert g[k] == pytest.approx(w[k], rel=2e-2, abs=1e-6), (s, k, g[k], w[k])


class _Stop(Exception):
    pass


def test_trainer_resume_is_bit_equal(tmp_path):
    """A run of 4 steps against a run stopped after step 2's checkpoint and
    resumed to 4 (as tests/test_ssl.py:195-233 resumes JAX's): the resumed
    trainer starts at the checkpoint's step with the optimizer's count and
    ends on the uninterrupted run's student, teacher and centers (drop path
    0.1, so its per-step generator is exercised too)."""
    over = dict(max_steps=4, checkpoint_interval=2, drop_path_rate=0.1)
    whole = port_trainer(tmp_path / "a", **over)
    whole.run()
    first = port_trainer(tmp_path / "b", **over)
    step_fn = first.train_step

    def stop_at_2(g, loc, m, step):
        if step == 2:
            raise _Stop
        return step_fn(g, loc, m, step)

    first.train_step = stop_at_2
    with pytest.raises(_Stop):
        first.run()
    assert first.checkpointer.list_steps() == [2]
    resumed = port_trainer(tmp_path / "b", **over)
    assert resumed.start_step == 2 and resumed.optimizer.count == 2
    resumed.run()
    for name in ("student", "teacher", "centers"):
        for (path, a), (_, b) in zip(named_leaves(getattr(whole, name)),
                                     named_leaves(getattr(resumed, name))):
            assert torch.equal(a, b), (name, path)


def test_freeze_window_holds_the_prototypes():
    tr = port_trainer(max_steps=3, freeze_last_layer_steps=2)
    before = {h: tr.student[h]["last_v"].detach().clone() for h in ("dino_head", "ibot_head")}
    seen = []
    step_fn = tr.train_step

    def wrapped(g, loc, m, step):
        out = step_fn(g, loc, m, step)
        seen.append({h: torch.equal(tr.student[h]["last_v"], before[h]) for h in before})
        return out

    tr.train_step = wrapped
    tr.run()
    assert seen == [{"dino_head": True, "ibot_head": True}] * 2 + [
        {"dino_head": False, "ibot_head": False}]


def test_ssl_train_cli_teacher_read_by_jax(tmp_path):
    """python -m dfd_clip_tpu_torch.ssl_train --synthetic 8 --device cpu:
    setting.yaml and teacher_backbone.pt; JAX's load_params and
    dinov2_forward give the port's CLS from that file (f32, 1e-5)."""
    from dfd_clip_tpu.models import weights as jweights

    out = tmp_path / "run"
    args = ssl_train.parse_args([
        "--synthetic", "8", "--device", "cpu", "--arch", "ViT-Test", "--out_dim", "64",
        "--local_size", "14", "--n_local_crops", "2", "--batch_size", "2", "--steps", "2",
        "--out_dir", str(out)])
    trainer = ssl_train.main(args)
    assert (out / "setting.yaml").is_file()
    state = jweights.load_params(str(out / "teacher_backbone.pt"))
    x = np.random.default_rng(8).standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jdino.dinov2_forward(jax.tree_util.tree_map(jnp.asarray, state["backbone"]),
                                jnp.asarray(x), ARCH, jnp.float32)["cls"]
    got = tdino.dinov2_forward(trainer.teacher["backbone"], t(x), ARCH, torch.float32)["cls"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with open(out / "teacher_backbone.pt", "rb") as f:
        assert set(pickle.load(f)) == {"backbone"}
