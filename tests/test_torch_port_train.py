"""The PyTorch port's training slice (dfd_clip_tpu_torch on the CPU, plain
versions) against the JAX package: the decoder attention's ``partials``
form and its backward against the Pallas kernels in interpret mode, the
autograd Function against autograd and jax.grad, the OneCycle schedule and
the optimizers against optax, and Detector.forward plus the Trainer against
a JAX train step built like bench.py's.

Tolerance: the JAX VJP suite's rtol 2e-4, atol 2e-5 for the attention and
its gradients; atol = rtol = 1e-4 for the whole train step (the port's f32
model tolerance, tests/test_torch_port_model.py); 1e-5 for the optimizers
and the schedule, whose arithmetic is elementwise but ordered differently
(AdamW's square root and division, optax's cosine in float32). All of it in
float32 (conftest sets JAX's matmul precision to "highest").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfd_clip_tpu.engine import optim as joptim
from dfd_clip_tpu.models import detector as jdetector
from dfd_clip_tpu.ops.decoder_attention import dual_activation_attention as jdual
from dfd_clip_tpu.ops.pallas_decoder_attention import (
    fused_decoder_attention as j_fused_dec,
    fused_decoder_attention_bwd as j_fused_bwd,
)
from dfd_clip_tpu_torch.engine import optim
from dfd_clip_tpu_torch.engine.trainer import Trainer
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import detector as tdetector
from dfd_clip_tpu_torch.models.decoder import token_mask
from dfd_clip_tpu_torch.models.weights import params_from_jax, to_numpy_tree
from dfd_clip_tpu_torch.ops.decoder_attention import dual_activation_attention
from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention
from dfd_clip_tpu_torch.ops.fused_decoder_attention_bwd import fused_decoder_attention_bwd

VJP_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or VJP_TOL))


def t(a):
    return torch.from_numpy(np.array(a))


# -- the decoder attention: partials, backward, Function -------------------------

DEC_CASES = {
    # 8-aligned export rows with patch_valid < patches, head_dim 64
    "pad_rows_d64": dict(heads=2, d=64, t=3, p=24, patch_valid=21),
    # L = 5 x 13 = 65 tokens: not a multiple of any tile
    "ragged_d16": dict(heads=4, d=16, t=5, p=13, patch_valid=None),
}


def dec_inputs(rng, b, nsel, h, d, t_, p, patch_valid):
    l = t_ * p
    qs, qc = (rng.standard_normal((b, 1, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((nsel, b, l, h, d)).astype(np.float32) for _ in range(2))
    pos = (0.1 * rng.standard_normal((l, h, d))).astype(np.float32)
    frames = np.ones((b, t_), bool)
    frames[1, t_ // 2 + 1:] = False        # sample 1: its last frames masked
    frames[-1] = False                     # the last sample: fully masked
    mask = token_mask(torch.from_numpy(frames), p, patch_valid).numpy()
    return qs, qc, k, v, pos, mask


@pytest.mark.parametrize("case", list(DEC_CASES))
def test_partials_match_pallas_interpret(rng, case):
    """Stacked K/V read at slot 1, temporal_pos, a partly and a fully masked
    sample: numerator, CoDA output, denominator and maximum; the fully
    masked sample gives 0, 0 and -1e30."""
    c = DEC_CASES[case]
    qs, qc, k, v, pos, mask = dec_inputs(rng, 3, 3, c["heads"], c["d"], c["t"], c["p"],
                                         c["patch_valid"])
    want_o, want_st = j_fused_dec(*(jnp.asarray(a) for a in (qs, qc, k, v)), jnp.asarray(mask),
                                  temporal_pos=jnp.asarray(pos), layer=1, partials=True)
    got_o, got_st = fused_decoder_attention(*(t(a) for a in (qs, qc, k, v, mask, pos)),
                                            layer=1, partials=True)
    assert got_o.dtype == got_st.dtype == torch.float32
    close(got_o, want_o)
    close(got_st, want_st)
    assert torch.equal(got_o[2], torch.zeros_like(got_o[2]))
    assert torch.equal(got_st[2, 0], torch.zeros_like(got_st[2, 0]))
    assert torch.equal(got_st[2, 1], torch.full_like(got_st[2, 1], -1e30))


@pytest.mark.parametrize("with_pos", [True, False], ids=["pos", "no_pos"])
def test_plain_backward_matches_pallas_interpret(rng, with_pos):
    """The flagship head geometry (H=12, D=64), shrunk in B and L; the stats
    come from the JAX partials forward, the cotangent is random. The fully
    masked sample's dq is exactly 0."""
    b, h, d, t_, p = 3, 12, 64, 3, 8
    qs, qc, k, v, pos, mask = dec_inputs(rng, b, 2, h, d, t_, p, None)
    ct = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    jpos = jnp.asarray(pos) if with_pos else None
    jargs = [jnp.asarray(a) for a in (qs, qc, k, v)]
    o_sc, st = j_fused_dec(*jargs, jnp.asarray(mask), temporal_pos=jpos, layer=0, partials=True)
    denom, mx = st[:, 0], st[:, 1]
    o_s = o_sc[:, 0].reshape(b, h, d) / jnp.maximum(denom, 1e-30)[..., None]
    want = j_fused_bwd(*jargs, jnp.asarray(mask), jpos, 0, denom, mx, o_s, jnp.asarray(ct))
    got = fused_decoder_attention_bwd(*(t(a) for a in (qs, qc, k, v, mask)),
                                      t(pos) if with_pos else None, 0,
                                      *(t(a) for a in (denom, mx, o_s, ct)))
    assert (got[2] is None) == (not with_pos)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32
            close(g, w)
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    assert torch.equal(got[1][2], torch.zeros_like(got[1][2]))


@pytest.mark.parametrize("reference", ["autograd", "jax"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_function_grads_match(rng, monkeypatch, reference, stacked):
    """Gradients of sum(out * r) through the trainable Function, for the
    queries, pos AND K/V, against autograd through the plain composition and
    against jax.grad of the JAX trainable path (Pallas partials forward and
    backward in interpret mode). Stacked: both slots feed the loss, so the
    K/V cotangents accumulate across slots."""
    b, h, d, t_, p = 3, 4, 32, 5, 8
    qs, qc, k, v, pos, mask = dec_inputs(rng, b, 2, h, d, t_, p, None)
    if not stacked:
        k, v = k[0], v[0]
    r = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    layers = (0, 1) if stacked else (None,)

    def port_grads(differentiable):
        leaves = [t(a).clone().requires_grad_(True) for a in (qs, qc, k, v, pos)]
        total = 0.0
        for layer in layers:
            out = dual_activation_attention(*leaves[:4], t(mask), temporal_pos=leaves[4],
                                            layer=layer, differentiable=differentiable)
            total = total + (out * t(r)).sum()
        return torch.autograd.grad(total, leaves)

    got = port_grads(True)
    if reference == "autograd":
        want = port_grads(False)
    else:
        monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
        monkeypatch.setenv("DFD_DEC_VJP", "1")

        def loss(qs_, qc_, k_, v_, pos_):
            total = 0.0
            for layer in layers:
                out = jdual(qs_, qc_, k_, v_, jnp.asarray(mask), num_frames=t_,
                            temporal_pos=pos_, layer=layer, differentiable=True)
                total = total + jnp.sum(out * r)
            return total

        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (qs, qc, k, v, pos)))
    for g, w, name in zip(got, want, ("q_smax", "q_coda", "k", "v", "pos")):
        close(g, w, err_msg=name, **VJP_TOL)
    sample = 1 if stacked else 0
    assert torch.equal(got[2].select(sample, 2), torch.zeros_like(got[2].select(sample, 2)))
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))


def test_decoder_per_layer_kv_grads_match_jax(rng, monkeypatch):
    """apply_decoder in training on per-layer K/V lists (the adapter's form:
    each block's attention reads its own tensor, layer None, and hands back
    its own dK/dV) against jax.grad of JAX's apply_decoder on the stacked
    export (its trainable attention: the Pallas kernels interpreted, dK/dV
    from its einsums), w.r.t. K/V and the temporal embedding; the port's
    stacked form gives the same cotangents. One sample partly and one fully
    masked; the fully masked sample's dK/dV are exactly 0."""
    from dfd_clip_tpu.models import decoder as jdec
    from dfd_clip_tpu_torch.models import decoder as tdec

    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    monkeypatch.setenv("DFD_DEC_VJP", "1")
    cfg = jdec.DecoderConfig(width=128, heads=2, num_frames=3, layer_indices=(0, 1),
                             out_dims=(2,))
    params = jax.tree_util.tree_map(np.asarray, jdec.init_decoder(jax.random.key(2), cfg))
    kvs = {s: rng.standard_normal((2, 3, 3, 5, 2, 64)).astype(np.float32) for s in ("k", "v")}
    m = np.array([[True, True, True], [True, True, False], [False, False, False]])
    r = rng.standard_normal((3, 2)).astype(np.float32)

    def jloss(kv, pos):
        p_ = {**jax.tree_util.tree_map(jnp.asarray, params), "positional_embedding": pos}
        logits, _ = jdec.apply_decoder(p_, kv, jnp.asarray(m), cfg, train=True)
        return jnp.sum(logits[0] * r)

    want_kv, want_pos = jax.grad(jloss, argnums=(0, 1))(
        {s: jnp.asarray(a) for s, a in kvs.items()}, jnp.asarray(params["positional_embedding"]))
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))

    def port_grads(per_layer):
        tparams = params_from_jax(params)
        pos = tparams["positional_embedding"].requires_grad_(True)
        if per_layer:
            leaves = {s: [t(a[i]).requires_grad_(True) for i in range(2)] for s, a in kvs.items()}
            flat = leaves["k"] + leaves["v"]
        else:
            leaves = {s: t(a).requires_grad_(True) for s, a in kvs.items()}
            flat = [leaves["k"], leaves["v"]]
        logits, _ = tdec.apply_decoder(tparams, leaves, torch.from_numpy(m), tcfg, train=True)
        grads = torch.autograd.grad((logits[0] * t(r)).sum(), flat + [pos])
        if per_layer:
            return {"k": torch.stack(grads[:2]), "v": torch.stack(grads[2:4])}, grads[-1]
        return {"k": grads[0], "v": grads[1]}, grads[-1]

    for per_layer in (True, False):
        got_kv, got_pos = port_grads(per_layer)
        for s in ("k", "v"):
            close(got_kv[s], want_kv[s], err_msg=f"d{s}", **VJP_TOL)
            assert torch.equal(got_kv[s][:, 2], torch.zeros_like(got_kv[s][:, 2]))
        close(got_pos, want_pos, err_msg="dpos", **VJP_TOL)


def test_function_forward_matches_plain(rng):
    """The partials-reconstructed forward equals the plain forward."""
    qs, qc, k, v, pos, mask = dec_inputs(rng, 3, 2, 4, 32, 5, 8, None)
    args = [t(a) for a in (qs, qc, k, v, mask)]
    got = dual_activation_attention(*args, temporal_pos=t(pos), layer=1, differentiable=True)
    want = dual_activation_attention(*args, temporal_pos=t(pos), layer=1)
    close(got, want.numpy())


# -- schedule and optimizers -------------------------------------------------------

def test_one_cycle_schedule_matches_optax():
    max_lr, total = 2.5e-3, 100
    ours = optim.one_cycle_schedule(max_lr, total)
    theirs = joptim.one_cycle_schedule(max_lr, total)
    steps = range(total + 5)
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=1e-5, atol=1e-6 * max_lr)
    assert ours(0) == pytest.approx(max_lr / 25) and ours(30) == pytest.approx(max_lr)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_matches_optax(name):
    """Three updates with the OneCycle rate, weight decay 0.01 on every leaf
    but the BatchNorm statistics (the decay mask as parameter groups)."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((4, 3)), "proj": [rng.standard_normal(3)],
            "adapter": {"bn": {"mean": rng.standard_normal(3), "var": rng.random(3),
                               "scale": rng.standard_normal(3)}}}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                    tree) for _ in range(3)]
    spec = {"name": name, "weight_decay": 0.01}
    schedule = optim.one_cycle_schedule(0.5, 10)
    jopt = joptim.build_optimizer(spec, joptim.one_cycle_schedule(0.5, 10))
    jparams, state = jax.tree_util.tree_map(jnp.asarray, tree), None
    state = jopt.init(jparams)
    params = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True), tree)
    opt = optim.build_optimizer(spec, schedule, params)
    for step, g in enumerate(grads):
        updates, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, leaf), gl in zip(optim.named_leaves(params), jax.tree_util.tree_leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        for a, b in zip(jax.tree_util.tree_leaves(to_numpy_tree(params)),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# -- losses, Detector.forward and the Trainer --------------------------------------

@pytest.mark.parametrize("loss", ["auc_roc", "auc_roc_soft", "kl_div", "mse"])
def test_losses_match_jax(rng, loss):
    """Per-sample losses: cross-entropy on class indices and on soft
    targets, KL with a zero target entry, the 140-bin expectation error."""
    logits = rng.standard_normal((4, 140 if loss == "mse" else 3)).astype(np.float32)
    if loss == "auc_roc":
        y = np.array([0, 2, 1, 2], np.int32)
    elif loss == "mse":
        y = (100 * rng.random(4)).astype(np.float32)
    else:
        y = rng.dirichlet(np.ones(3), 4).astype(np.float32)
        y[0, 1] = 0.0
    name = loss.removesuffix("_soft")
    got = tdetector.LOSSES[name]()(t(logits), t(y))
    want = jdetector.LOSSES[name]()(jnp.asarray(logits), jnp.asarray(y))
    close(got, want, **STEP_TOL)


def tiny_detectors(**overrides):
    """The JAX tests' tiny_detector (ViT-Test, decode layers 0 and 2) and the
    port's same configuration, in f32 on the CPU."""
    from fixtures import tiny_detector

    jdet = tiny_detector(num_frames=4, **overrides)
    cfg = tdetector.Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2], **overrides})
    tdet = tdetector.Detector(cfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    tdet.vit_cfg = tiny
    tdet.transform = dataclasses.replace(tdet.transform, size=tiny.input_resolution)
    tdet.decoder_cfg = dataclasses.replace(tdet.decoder_cfg, width=tiny.width, heads=tiny.heads)
    return jdet, tdet


TWO_TASKS = {"out_dim": [2, 3], "losses": ["auc_roc", "kl_div"]}


def task_batches(rng, n_steps):
    """Per step, one six-field batch for task 0 (class labels) and one for
    task 1 (soft labels); sample 1 of each has its last frames masked."""
    out = []
    for _ in range(n_steps):
        m = np.ones((2, 4), bool)
        m[1, 2:] = False
        rnd = []
        for task, label in ((0, np.array([0, 1], np.int32)),
                            (1, rng.dirichlet(np.ones(3), 2).astype(np.float32))):
            x = rng.integers(0, 256, (2, 4, 3, 40, 48), dtype=np.uint8)
            rnd.append((f"task{task}", (x, label, m, ["raw", "c23"], np.ones(2, np.float32),
                                        np.full(2, task))))
        out.append(rnd)
    return out


def port_trainer(tdet, jparams, max_steps=10, **cfg):
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": max_steps, "learning_rate": 1.0, **cfg})
    return Trainer(tcfg, tdet, {}, params=params_from_jax(jparams), device="cpu")


def test_trainer_matches_jax_train_steps(rng):
    """Three steps of two tasks each (gradients summed across the tasks)
    through the port's Trainer, against value_and_grad of the JAX
    Detector.forward per task, summed, then the optax SGD + OneCycle update:
    per-step losses, then every trainable leaf after 3 steps."""
    jdet, tdet = tiny_detectors(**TWO_TASKS)
    jparams = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))
    trainable, frozen = jdet.partition_params(jax.tree_util.tree_map(jnp.asarray, jparams))
    opt = joptim.build_optimizer(jdet.optimizer_spec(), joptim.one_cycle_schedule(1.0, 10))
    state = opt.init(trainable)

    def grad_fn(task):
        def loss_fn(tr, x, y, m):
            labels = [y if i == task else None for i in range(2)]
            losses, _, _ = jdet.forward({**frozen, **tr}, x, labels, m, train=True,
                                        single_task=task)
            return losses[task].mean()
        return jax.jit(jax.value_and_grad(loss_fn))

    grad_fns = [grad_fn(0), grad_fn(1)]
    trainer = port_trainer(tdet, jparams)
    start = to_numpy_tree(trainer.trainable)
    for rnd in task_batches(rng, 3):
        total = None
        want_losses = []
        for task, (_, batch) in enumerate(rnd):
            x, y, m = (jnp.asarray(a) for a in batch[:3])
            loss, g = grad_fns[task](trainable, x, y, m)
            want_losses.append(float(loss))
            total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
        updates, state = opt.update(total, state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        trainer.train_step([(name, trainer.prepare_batch(batch)) for name, batch in rnd])
        got_losses = [trainer.batch_losses[f"task{i}"].mean() for i in range(2)]
        np.testing.assert_allclose(got_losses, want_losses, **STEP_TOL)
    assert trainer.steps == 3
    got, want = trainer.snapshot_model_state()["trainable"], jax.tree_util.tree_map(
        np.asarray, trainable)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    moved = 0.0
    for a, b, s in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(start)):
        np.testing.assert_allclose(a, b, **STEP_TOL)
        moved = max(moved, float(np.abs(b - s).max()))
    assert moved > 100 * STEP_TOL["atol"]        # the steps did move the parameters


def test_detector_forward_losses_match_jax(rng):
    """Eval and train forward (dropout 0) losses per task, with nerf_raw's
    per-sample scale on the train losses."""
    jdet, tdet = tiny_detectors(**TWO_TASKS, train_mode={"nerf_raw": -1})
    jparams = jdet.init_params(jax.random.key(1))
    tparams = tdet.prepare_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    (_, (x, y0, m, _, _, _)), (_, (_, y1, _, _, _, _)) = task_batches(rng, 1)[0]
    comp = np.array([True, False])
    for train in (False, True):
        want = jdet.forward(jparams, jnp.asarray(x), [jnp.asarray(y0), jnp.asarray(y1)],
                            jnp.asarray(m), jnp.asarray(comp), train=train)
        got = tdet.forward(tparams, x, [t(y0), t(y1)], m, t(comp), train=train)
        assert len(got) == (3 if train else 2)
        for g, w in zip(got[0], want[0]):
            close(g, w, **STEP_TOL)
        for g, w in zip(got[1], want[1]):
            close(g, w, **STEP_TOL)


def test_nan_loss_aborts_before_the_update(rng):
    """A non-finite loss raises before the optimizer step: every parameter
    and the step count stay as they were."""
    jdet, tdet = tiny_detectors(**TWO_TASKS)
    jparams = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))
    trainer = port_trainer(tdet, jparams)
    rnd = task_batches(rng, 1)[0]
    name, (x, y, m, comps, speed, index) = rnd[1]
    y = y.copy()
    y[0, 0] = np.nan
    before = trainer.snapshot_model_state()["trainable"]
    with pytest.raises(FloatingPointError, match="task1"):
        trainer.train_step([(n, trainer.prepare_batch(b))
                            for n, b in (rnd[0], (name, (x, y, m, comps, speed, index)))])
    assert trainer.steps == 0
    for a, b in zip(jax.tree_util.tree_leaves(trainer.snapshot_model_state()["trainable"]),
                    jax.tree_util.tree_leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_teacher_mode_run(rng):
    """run() over two cycling loaders in teacher mode: 4 steps, the teacher
    is the EMA of the trainable leaves after every step, teaching starts
    after teach_at steps, and the rate of the last step is schedule(3)."""
    jdet, tdet = tiny_detectors(**TWO_TASKS)
    jparams = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))
    trainer = port_trainer(tdet, jparams, max_steps=4, mode="teacher",
                           mode_params={"teach_at": 1, "ema_ratio": 0.25})
    rounds = task_batches(rng, 2)
    trainer.loaders = {f"task{i}": [rnd[i][1] for rnd in rounds] for i in range(2)}
    seen = []
    step = trainer.train_step

    def spy(round_batches):
        teacher = trainer.snapshot_model_state()["trainable"] if not seen else seen[-1][1]
        teaching = trainer.teaching
        step(round_batches)
        s = jax.tree_util.tree_leaves(trainer.snapshot_model_state()["trainable"])
        ema = [0.75 * a + 0.25 * b for a, b in zip(jax.tree_util.tree_leaves(teacher), s)]
        got = jax.tree_util.tree_leaves(to_numpy_tree(trainer.teacher))
        for a, b in zip(got, ema):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        seen.append((teaching, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(teacher), got)))

    trainer.train_step = spy
    trainer.run()
    assert trainer.steps == 4
    assert [s[0] for s in seen] == [False, False, True, True]
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(trainer.schedule(3))
    for losses in trainer.batch_losses.values():
        assert np.isfinite(losses).all()
