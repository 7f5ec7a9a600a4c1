"""The Detector's remaining options in the port (dfd_clip_tpu_torch on the
CPU, plain versions) against the JAX package on the same numpy inputs, with
the weights carried across: kv_dtype "int8" (per-(layer, head) scales), the
factorised decoder attention (attn_mode "frame", "temporal" and both),
aug_query, training with compute_int8 and with int8_rows K/V, giant2's
SwiGLU FFN (ViT-Test-SwiGLU), the Trainer's pristine frozen tree beside its
prepared one, and the training CLI plus both inferences on an attn_mode
recipe.

Tolerances, with their reasons:
* kv_int8: the int8 values exactly equal and the scales within rtol 1e-6
  (one absmax and one division a value, the same K/V export on both sides);
  the dequantised K/V within rtol 1e-6 (one multiply);
* the factorised attention: the JAX VJP suite's rtol 2e-4, atol 2e-5 (f32
  compositions summed in other orders);
* the decoder with aug_query: 1e-4 relative and absolute, the port's f32
  model tolerance (tests/test_torch_port_model.py);
* Trainer steps: the train slice's rtol = atol = 1e-4
  (tests/test_torch_port_train.py); the int8 steps also run JAX's Pallas
  kernels in interpret mode, whose arithmetic the port's plain versions
  repeat. With int8_rows K/V the decoder computes in bf16 (JAX's rule),
  where JAX's XLA composition rounds the scaled queries and the affinities
  to bf16 and the port's trainable Function keeps them in f32: the losses
  within 1e-2, about two bf16 ulps, as tests/test_torch_port_int8.py holds
  bf16 activations, and each leaf's update over the three steps within a
  relative L2 of 1e-1, chip_smoke.py's per-leaf hold of a bf16 route
  against another (TOL_TRAIN_GRAD; read 2.1e-2 at most here);
* dinov2_kv on the SwiGLU tower: f32 within rtol 2e-4, atol 2e-5, bf16
  within 1e-2 of the max (exact GELU and SiLU round at other points);
* the CLI's run directory read by both inferences: per-video P(fake) within
  1e-5, as tests/test_torch_port_main.py.
"""

import argparse
import dataclasses
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from dfd_clip_tpu.engine import optim as joptim
from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import decoder as jdecoder
from dfd_clip_tpu.models import dinov2_vit as jdino
from dfd_clip_tpu.ops.decoder_attention import dual_activation_attention as jdual
from dfd_clip_tpu_torch.engine.trainer import Trainer
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import decoder as tdecoder
from dfd_clip_tpu_torch.models import dinov2_vit as tdino
from dfd_clip_tpu_torch.models.decoder import token_mask
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops.decoder_attention import dual_activation_attention

from test_torch_port_train import STEP_TOL, VJP_TOL, task_batches, tiny_detectors

FRAMES = 4
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
LEAF_BF16 = 1e-1


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- kv_dtype "int8" ------------------------------------------------------------------

@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_clip_vision_kv_int8_matches_jax(rng, monkeypatch, reference):
    """keep (0, 2), drop_cls, the 8-row pad: JAX's XLA composition or its
    fused kernels interpreted, then its per-(layer, head) quantisation."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    cfg = jvit.ARCHITECTURES["ViT-Test"]
    params = to_np(jvit.init_clip_vision(jax.random.key(3), cfg))
    x = rng.standard_normal((FRAMES, 3, 32, 32)).astype(np.float32)
    kw = dict(keep_layers=(0, 2), drop_cls=True, pad_tokens=True, kv_int8=True)
    want = jvit.clip_vision_kv(jx(params), jnp.asarray(x), cfg, compute_dtype=jnp.float32, **kw)
    got = tvit.clip_vision_kv(params_from_jax(params), torch.from_numpy(x),
                              tvit.ARCHITECTURES["ViT-Test"], compute_dtype=torch.float32, **kw)
    assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
    for s in ("k", "v"):
        assert got[s].dtype == torch.int8 and tuple(got[s].shape) == want[s].shape
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]))
        assert tuple(got[f"{s}_scale"].shape) == want[f"{s}_scale"].shape == (2, 4)
        np.testing.assert_allclose(got[f"{s}_scale"].numpy(), np.asarray(want[f"{s}_scale"]),
                                   rtol=1e-6, atol=0)
    assert (got["k"][:, :, 4:] == 0).all()                  # pad rows quantise to 0


def test_detector_dequantised_kv_int8_matches_jax(rng):
    """Detector.encode_kv with kv_dtype "int8": the export dequantised in the
    compute dtype, (Lsel, B, T, P, H, D)."""
    op_mode = {"temporal_position": 1, "kv_dtype": "int8"}
    jdet, tdet = tiny_detectors(out_dim=[2], losses=["auc_roc"], op_mode=op_mode)
    jparams = jdet.init_params(jax.random.key(0))
    tparams = tdet.prepare_params(params_from_jax(to_np(jparams)))
    x = rng.standard_normal((2, FRAMES, 3, 32, 32)).astype(np.float32)
    want = jdet.encode_kv(jparams, jnp.asarray(x), pad_tokens=True)
    got = tdet.encode_kv(tparams, torch.from_numpy(x), pad_tokens=True)
    for s in ("k", "v"):
        assert tuple(got[s].shape) == want[s].shape == (2, 2, FRAMES, 8, 4, 16)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), rtol=1e-6, atol=0)
    # predict end to end on the same weights
    m = np.array([[True] * FRAMES, [True, True, False, False]])
    (want_l,), _ = jdet.predict(jparams, jnp.asarray(x), jnp.asarray(m))
    (got_l,), _ = tdet.predict(tparams, x, m)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **STEP_TOL)


# -- the factorised decoder attention ------------------------------------------------------

ATTN_MODES = {"frame": ("frame",), "temporal": ("temporal",),
              "temporal+frame": ("temporal", "frame")}


@pytest.mark.parametrize("gather", [False, True], ids=["pad196", "patch_indices"])
@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_factorised_attention_matches_jax(rng, mode, gather):
    """Stacked K/V read at slot 1, temporal_pos, a fully masked frame and a
    fully masked sample, at f32: the export's layout with its 196 -> 200 pad
    rows masked, or a patch_indices gather of 49 patches a frame (all real),
    as JAX's reshape by num_frames sees them."""
    b, t, h, d = 3, 3, 2, 16
    p, valid = (49, None) if gather else (200, 196)
    l = t * p
    qs, qc = (rng.standard_normal((b, 1, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, b, l, h, d)).astype(np.float32) for _ in range(2))
    pos = (0.1 * rng.standard_normal((l, h, d))).astype(np.float32)
    frames = np.ones((b, t), bool)
    frames[1, 1] = False                   # sample 1: its middle frame masked
    frames[2] = False                      # sample 2: fully masked
    mask = token_mask(torch.from_numpy(frames), p, valid).numpy()
    want = jdual(*(jnp.asarray(a) for a in (qs, qc, k, v, mask)), num_frames=t,
                 attn_mode=ATTN_MODES[mode], temporal_pos=jnp.asarray(pos), layer=1)
    got = dual_activation_attention(*(torch.from_numpy(a) for a in (qs, qc, k, v, mask)),
                                    num_frames=t, attn_mode=ATTN_MODES[mode],
                                    temporal_pos=torch.from_numpy(pos), layer=1)
    assert torch.isfinite(got).all() and (got[2] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VJP_TOL)


def test_factorised_attention_needs_a_mode_and_frames(rng):
    qs = torch.zeros(1, 1, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    mask = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="num_frames"):
        dual_activation_attention(qs, qs, k, k, mask, attn_mode=("frame",))
    with pytest.raises(ValueError, match="'frame' or 'temporal'"):
        dual_activation_attention(qs, qs, k, k, mask, num_frames=2, attn_mode=("spatial",))


# -- aug_query ------------------------------------------------------------------------------

@pytest.mark.parametrize("global_prediction", [False, True], ids=["last", "global"])
@pytest.mark.parametrize("attn_mode", [(), ("temporal", "frame")], ids=["softmax", "factorised"])
def test_decoder_aug_query_matches_jax(rng, global_prediction, attn_mode):
    """apply_decoder with aug_query (its (blocks - 1, W) offsets drawn away
    from their zero init) on padded stacked K/V, inference and the train
    composition (dropout 0): task logits and the video feature."""
    cfg = dict(width=64, heads=4, num_frames=FRAMES, layer_indices=(0, 1, 2), out_dims=(2, 3),
               attn_mode=attn_mode, aug_query=True, global_prediction=global_prediction)
    jcfg, tcfg = jdecoder.DecoderConfig(**cfg), tdecoder.DecoderConfig(**cfg)
    params = to_np(jdecoder.init_decoder(jax.random.key(2), jcfg))
    assert params["aug_query"].shape == (2, 64) and not params["aug_query"].any()
    params["aug_query"] = (0.5 * rng.standard_normal((2, 64))).astype(np.float32)
    tparams = params_from_jax(params)
    assert sorted(tparams) == sorted(tdecoder.init_decoder(torch.Generator(), tcfg))
    k, v = (rng.standard_normal((3, 2, FRAMES, 8, 4, 16)).astype(np.float32) for _ in range(2))
    m = np.array([[True] * FRAMES, [True, True, False, False]])
    for train in (False, True):
        want = jdecoder.apply_decoder(jx(params), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                      jnp.asarray(m), jcfg, train=train, patch_valid=5)
        got = tdecoder.apply_decoder(tparams, {"k": torch.from_numpy(k),
                                               "v": torch.from_numpy(v)},
                                     torch.from_numpy(m), tcfg, train=train, patch_valid=5)
        for g, w in zip([*got[0], got[1]], [*want[0], want[1]]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **STEP_TOL)


# -- Trainer steps with the options -----------------------------------------------------------

STEP_OPTIONS = {
    "compute_int8": {"op_mode": {"temporal_position": 1, "compute_int8": 1}},
    "int8_rows": {"op_mode": {"temporal_position": 1, "compute_int8": 1,
                              "kv_dtype": "int8_rows"}},
    "attn_mode": {"op_mode": {"temporal_position": 1, "attn_mode": "temporal+frame"}},
    "aug_query": {"op_mode": {"temporal_position": 1, "aug_query": 1}},
}


@pytest.mark.parametrize("option", list(STEP_OPTIONS))
def test_trainer_steps_with_options_match_jax(rng, monkeypatch, option):
    """Three single-task steps through the port's Trainer against JAX's
    value_and_grad of Detector.forward (its prepared frozen tree, as its
    Trainer feeds it) and the optax SGD + OneCycle update: each step's
    loss, then every trainable leaf. The int8 options run JAX's fused
    kernels interpreted (DFD_ATTENTION_BACKEND=pallas), the forms the
    port's plain versions repeat; aug_query's offsets are drawn away from
    their zero init first."""
    if option.startswith("int8") or option == "compute_int8":
        monkeypatch.setenv("DFD_ATTENTION_BACKEND", "pallas")
    jdet, tdet = tiny_detectors(out_dim=[2], losses=["auc_roc"], **STEP_OPTIONS[option])
    jparams = to_np(jdet.init_params(jax.random.key(0)))
    if option == "aug_query":
        jparams["decoder"]["aug_query"] = (0.5 * rng.standard_normal((1, 64))).astype(
            np.float32)
    trainable, frozen = jdet.partition_params(jx(jparams))
    frozen_run = jdet.prepare_params(frozen)
    opt = joptim.build_optimizer(jdet.optimizer_spec(), joptim.one_cycle_schedule(1.0, 10))
    state = opt.init(trainable)

    def loss_fn(tr, x, y, m):
        losses, _, _ = jdet.forward({**frozen_run, **tr}, x, [y], m, train=True, single_task=0)
        return losses[0].mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    tcfg = Trainer.get_default_config()
    tcfg.merge_from_other_cfg({"max_steps": 10, "learning_rate": 1.0})
    trainer = Trainer(tcfg, tdet, {}, params=params_from_jax(jparams), device="cpu")
    for rnd in task_batches(rng, 3):
        name, batch = rnd[0]
        loss, g = grad_fn(trainable, *(jnp.asarray(a) for a in batch[:3]))
        updates, state = opt.update(g, state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        trainer.train_step([(name, trainer.prepare_batch(batch))])
        np.testing.assert_allclose(trainer.batch_losses[name].mean(), float(loss),
                                   **(BF16_TOL if option == "int8_rows" else STEP_TOL))
    got, want = trainer.snapshot_model_state()["trainable"], to_np(trainable)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    start = jax.tree_util.tree_leaves(jdet.partition_params(jparams)[0])
    for a, b, s0 in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), start):
        if option == "int8_rows":   # each leaf's update, relative L2
            assert np.linalg.norm(a - b) <= LEAF_BF16 * np.linalg.norm(b - s0)
        else:
            np.testing.assert_allclose(a, b, **STEP_TOL)


def test_trainer_prequantizes_frozen_tower_once():
    """The port of tests/test_int8_e2e.py::test_trainer_prequantizes_frozen_
    tower_once: with compute_int8 the steps read a once-prepared frozen tree
    (``frozen_run``: int8 ``wq`` / f32 ``ws`` beside each block weight); the
    pristine ``frozen`` -- and so a snapshot with the frozen tree -- never
    holds them. In bf16 ``frozen_run`` is the placed tree, still without
    them, and ``frozen`` keeps the given f32 weights on the host."""
    for op_mode, int8 in (({"temporal_position": 1, "compute_int8": 1}, True),
                          ({"temporal_position": 1}, False)):
        jdet, tdet = tiny_detectors(out_dim=[2], losses=["auc_roc"], op_mode=op_mode)
        jparams = to_np(jdet.init_params(jax.random.key(0)))
        trainer = Trainer(Trainer.get_default_config(), tdet, {},
                          params=params_from_jax(jparams), device="cpu")
        prepped = trainer.frozen_run["encoder"]["blocks"][0]["attn"]["in_proj"]
        assert ("wq" in prepped and "ws" in prepped) == int8
        if int8:
            assert prepped["wq"].dtype == torch.int8 and prepped["ws"].dtype == torch.float32
        pristine = trainer.frozen["encoder"]["blocks"][0]["attn"]["in_proj"]
        assert "wq" not in pristine and pristine["w"].device.type == "cpu"
        np.testing.assert_array_equal(pristine["w"].numpy(),
                                      jparams["encoder"]["blocks"]["attn"]["in_proj"]["w"][0])

        def leaf_keys(tree, out):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    out.add(k)
                    leaf_keys(v, out)
            elif isinstance(tree, list):
                for v in tree:
                    leaf_keys(v, out)
            return out

        snap = trainer.snapshot_model_state(include_frozen=True)
        assert "frozen" in snap and "wq" not in leaf_keys(snap, set())


# -- giant2's SwiGLU FFN ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dinov2_kv_swiglu_matches_jax(rng, dtype):
    """ViT-Test-SwiGLU, keep (0, 1), drop_cls, LayerScale off its ones."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        dtype]
    jcfg, tcfg = jdino.ARCHITECTURES["ViT-Test-SwiGLU"], tdino.ARCHITECTURES["ViT-Test-SwiGLU"]
    assert tcfg.swiglu_hidden == jcfg.swiglu_hidden == 88
    params = to_np(jdino.init_dinov2(jax.random.key(9), jcfg))
    rs = np.random.default_rng(1)
    for key in ("ls1", "ls2"):
        params["blocks"][key] = (1 + 0.5 * rs.standard_normal(
            params["blocks"][key].shape)).astype(np.float32)
    tparams = params_from_jax(params)
    assert tparams["blocks"][1]["mlp"]["w12"]["w"].shape == (32, 176)
    x = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jdino.dinov2_kv(jx(params), jnp.asarray(x), jcfg, compute_dtype=jdt,
                           keep_layers=(0, 1), drop_cls=True)
    got = tdino.dinov2_kv(tparams, torch.from_numpy(x), tcfg, compute_dtype=tdt,
                          keep_layers=(0, 1), drop_cls=True)
    y = rng.standard_normal((5, 32)).astype(np.float32)
    mlp = params["blocks"]["mlp"]
    ffn_want = jdino.apply_ffn(jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), mlp),
                               jnp.asarray(y).astype(jdt))
    ffn_got = tdino.apply_ffn(tparams["blocks"][1]["mlp"], torch.from_numpy(y).to(tdt))
    for g, w in [(got["k"], want["k"]), (got["v"], want["v"]), (ffn_got, ffn_want)]:
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, **VJP_TOL)
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


def test_swiglu_detector_keeps_the_decoder_mlp_random():
    """A DINOv2 Detector on a SwiGLU tower: the decoder's blocks copy the
    kept layers' LayerNorms but keep their own random MLP (the tower has no
    c_fc / c_proj to seed it with), as JAX's init_decoder does."""
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"foundation": "dinov2", "architecture": "ViT-Test-SwiGLU",
                              "decode_mode": "index", "decode_indices": [0, 1],
                              "out_dim": [2], "losses": ["auc_roc"]})
    det = Detector(cfg, num_frames=FRAMES, compute_dtype=torch.float32, device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    blk, enc = params["decoder"]["blocks"][1], params["encoder"]["blocks"][1]
    assert set(blk["mlp"]) == {"c_fc", "c_proj"} and blk["mlp"]["c_fc"]["w"].shape == (32, 128)
    assert torch.equal(blk["ln_2"]["scale"], enc["ln_2"]["scale"])
    x = torch.randint(0, 256, (2, FRAMES, 3, 28, 28), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    (logits,), _ = det.predict(det.prepare_params(params), x, torch.ones(2, FRAMES, dtype=bool))
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()


# -- the training CLI and both inferences on an attn_mode recipe ---------------------------------

def test_main_and_inference_with_attn_mode(tmp_path, monkeypatch):
    """tests/test_e2e.py:198-230 on the port: the training CLI trains the
    ViT-Test fixture with op_mode attn_mode "temporal+frame" (no adapter),
    its setting.yaml keeps the option, and JAX's inference.main and the
    port's read the run directory to the same per-video P(fake)."""
    import inference as jinf

    from dfd_clip_tpu_torch import inference as tinf
    from fixtures import make_ffpp_tree
    from test_torch_port_main import run_main, write_config
    from test_torch_port_serve import jax_f32, port_f32

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("API_TOKEN", raising=False)
    monkeypatch.delenv("CHAT_ID", raising=False)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    root = make_ffpp_tree(str(tmp_path / "ffpp"), compressions=("raw",))
    path = write_config(tmp_path, root, project="attn")
    cfg = yaml.safe_load(open(path))
    cfg["model"].pop("adapter")
    cfg["model"]["op_mode"] = {"temporal_position": 1, "attn_mode": "temporal+frame"}
    cfg["trainer"]["checkpoint_interval"] = 0
    Path(path).write_text(yaml.safe_dump(cfg))
    run = run_main(path)
    setting = yaml.safe_load(open(f"{run}/setting.yaml"))
    assert setting["model"]["op_mode"]["attn_mode"] == "temporal+frame"

    jax_f32(monkeypatch)
    port_f32(monkeypatch)
    shutil.copytree(run, tmp_path / "run_port")
    want = jinf.main(argparse.Namespace(artifacts_dir=run, batch_size=3, aux_file=None,
                                        weight_mode="best", modality="video", num_workers=0,
                                        test=False, cfg_name="setting"))
    got = tinf.main(tinf.parse_args([str(tmp_path / "run_port"), "--batch_size", "3",
                                     "--num_workers", "0", "--device", "cpu",
                                     "--video_backend", "opencv"]))
    assert sorted(got) == sorted(want) == ["FFPP"]
    (a,), (b,) = (list(Path(d).glob("stats_*_best_video.pickle"))
                  for d in (tmp_path / "run_port", run))
    a, b = (pickle.loads(p.read_bytes())["FFPP"] for p in (a, b))
    assert a["label"] == b["label"] and len(a["label"]) == 8
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=1e-5, atol=1e-5)
    assert np.isfinite(got["FFPP"]["roc_auc"])


def test_port_dataclass_fields_match_jax():
    """The port's DecoderConfig and ViTConfig carry JAX's fields, so the
    options reach the same places."""
    assert [f.name for f in dataclasses.fields(tdecoder.DecoderConfig)] == \
        [f.name for f in dataclasses.fields(jdecoder.DecoderConfig)]
    assert [f.name for f in dataclasses.fields(tvit.ViTConfig)] == \
        [f.name for f in dataclasses.fields(jvit.ViTConfig)]
    for arch in ("ViT-g/14", "ViT-Test-SwiGLU"):
        assert dataclasses.asdict(tdino.ARCHITECTURES[arch]) == \
            dataclasses.asdict(jdino.ARCHITECTURES[arch])
