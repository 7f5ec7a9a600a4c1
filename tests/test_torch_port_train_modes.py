"""The Detector's training modes in the PyTorch port against the JAX package,
on the CPU at ViT-Test geometry (decode layers 0 and 2, 4 frames, float32,
dropout 0): train_mode.compression ("sync" over a 768-x-768 adapter's
per-layer K/V, "feature-match" on the video feature with
global_prediction), temporal "ranking" (the trainable ranking_proj) and
"triplet", op_mode.ema_frame, patch_mask "batch" / "sample" / "guide" (a
guide pickle under tmp_path) and auc_roc with class weights and label
smoothing: each mode's task and auxiliary losses and the gradient of
their sum with respect to every trainable leaf against jax.grad; then the
Trainer's host extras (patch indices, triplets) against JAX's Trainer
from one seed, and their speed ordering.

Tolerance: atol = rtol = 1e-4 (the model hold of
tests/test_torch_port_model.py); the host extras exactly equal.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.engine.trainer import Trainer as JTrainer
from dfd_clip_tpu.runtime import MeshRuntime
from dfd_clip_tpu_torch.engine.optim import named_leaves
from dfd_clip_tpu_torch.engine.trainer import Trainer, order_triplets
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import detector as tdetector
from dfd_clip_tpu_torch.models.weights import params_from_jax

from fixtures import tiny_detector

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 4, 4
ADAPTER = {"type": "normal", "struct": {"type": "768-x-768", "x": 32}}


def detectors(**overrides):
    """JAX's tiny_detector with ``overrides`` and the port's same
    configuration on ViT-Test, f32, on the CPU."""
    jdet = tiny_detector(num_frames=T, **overrides)
    cfg = tdetector.Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"], **overrides})
    tdet = tdetector.Detector(cfg, num_frames=T, compute_dtype=torch.float32, device="cpu")
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    tdet.vit_cfg = tiny
    tdet.transform = dataclasses.replace(tdet.transform, size=tiny.input_resolution)
    tdet.decoder_cfg = dataclasses.replace(tdet.decoder_cfg, width=tiny.width, heads=tiny.heads)
    if tdet.adapter_cfg is not None:
        tdet.adapter_cfg = dataclasses.replace(tdet.adapter_cfg, width=tiny.width,
                                               patches=tiny.num_patches, inner_dim=32)
        assert dataclasses.asdict(tdet.adapter_cfg) == dataclasses.asdict(jdet.adapter_cfg)
    return jdet, tdet


def random_params(jdet, rng):
    """JAX's init with the adapter (when there is one) and the decoder's
    LayerNorms drawn at random, so no mode's loss or gradient is trivial."""
    params = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))

    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[0] == "adapter" or "ln_1" in keys or "ln_2" in keys:
            return (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def batch(rng):
    x = rng.integers(0, 256, (B, T, 3, 40, 48), dtype=np.uint8)
    m = np.ones((B, T), bool)
    m[1, 3:] = False
    return {"x": x, "m": m, "labels": np.array([0, 1, 1, 0], np.int32),
            "comp": np.array([True, False, False, True]),
            "speed": np.array([0.9, 0.55, 1.0, 0.7], np.float32)}


def flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def losses_and_grads(jdet, tdet, params, b, **extras):
    """(JAX, port): each a dict of the losses ("task" and the auxiliary
    ones) and the flat gradients of their sum over the trainable leaves."""
    jx = {k: (None if v is None else jnp.asarray(v)) for k, v in extras.items()}
    trainable, frozen = jdet.partition_params(jax.tree_util.tree_map(jnp.asarray, params))

    def loss_fn(tr):
        task, _, other = jdet.forward({**frozen, **tr}, jnp.asarray(b["x"]),
                                      [jnp.asarray(b["labels"])], jnp.asarray(b["m"]),
                                      jnp.asarray(b["comp"]), jnp.asarray(b["speed"]),
                                      train=True, single_task=0, **jx)
        total = task[0].mean() + sum(v.mean() for v in other.values())
        return total, {"task": task[0], **other}

    jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(trainable)
    want = ({k: np.asarray(v) for k, v in jlosses.items()}, flat(jgrads))

    ttrain, tfrozen = tdet.partition_params(params_from_jax(params))
    leaves = [(p, t.requires_grad_(True)) for p, t in named_leaves(ttrain)]
    tx = {k: (None if v is None else torch.from_numpy(np.asarray(v))) for k, v in extras.items()}
    task, _, other = tdet.forward({**tfrozen, **ttrain}, b["x"], [torch.from_numpy(b["labels"])],
                                  b["m"], torch.from_numpy(b["comp"]),
                                  torch.from_numpy(b["speed"]), train=True, single_task=0, **tx)
    total = task[0].mean() + sum(v.mean() for v in other.values())
    grads = torch.autograd.grad(total, [t for _, t in leaves], allow_unused=True)
    got = ({"task": task[0].detach().numpy(), **{k: v.detach().numpy() for k, v in other.items()}},
           {".".join(map(str, p)): (np.zeros(t.shape, np.float32) if g is None else g.numpy())
            for (p, t), g in zip(leaves, grads)})
    return want, got


def hold(want, got, aux_keys):
    (wl, wg), (gl, gg) = want, got
    assert set(gl) == set(wl) == {"task", *aux_keys}
    for k in wl:
        np.testing.assert_allclose(gl[k], wl[k], err_msg=k, **TOL)
    assert set(gg) == set(wg)
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], err_msg=k, **TOL)


GUIDE = "guide"
MODES = {
    "compression_sync": ({"adapter": ADAPTER, "train_mode": {"compression": "sync"}},
                         ("recon", "match")),
    "compression_feature_match": ({"train_mode": {"compression": "feature-match"},
                                   "op_mode": {"global_prediction": 1}}, ("recon", "match")),
    "ranking": ({"train_mode": {"temporal": "ranking"}}, ("speed/rank",)),
    "triplet": ({"train_mode": {"temporal": "triplet"}}, ("speed/triplet",)),
    "ema_frame": ({"op_mode": {"ema_frame": 0.5}}, ()),
    "patch_mask_batch": ({"train_mode": {"patch_mask": {"type": "batch", "ratio": 0.5}}}, ()),
    "patch_mask_sample": ({"train_mode": {"patch_mask": {"type": "sample", "ratio": 0.5}}}, ()),
    "patch_mask_guide": ({"train_mode": {"patch_mask": {"type": "guide", "ratio": 0.5,
                                                        "path": GUIDE}}}, ()),
    "auc_roc_weight_smoothing": ({"losses": [{"name": "auc_roc",
                                              "args": {"weight": [0.3, 1.7],
                                                       "label_smoothing": 0.1}}]}, ()),
}


def guide_map(tmp_path, rng) -> str:
    """A guide pickle: {"v": {encoder layer: (P,) probabilities}}."""
    probs = {layer: (lambda p: p / p.sum())(rng.random(4) + 0.1) for layer in (0, 1, 2)}
    path = tmp_path / "guide.pkl"
    path.write_bytes(pickle.dumps({"v": probs}))
    return str(path)


def configured(mode, tmp_path, rng):
    over, aux = MODES[mode]
    if mode == "patch_mask_guide":
        over = {"train_mode": {"patch_mask": {**over["train_mode"]["patch_mask"],
                                              "path": guide_map(tmp_path, rng)}}}
    return over, aux


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_losses_and_gradients_match_jax(mode, tmp_path, rng):
    over, aux = configured(mode, tmp_path, rng)
    jdet, tdet = detectors(**over)
    params = random_params(jdet, rng)
    b = batch(rng)
    extras = {}
    if mode.startswith("patch_mask"):
        idx = jdet.sample_patch_indices(np.random.default_rng(5))
        np.testing.assert_array_equal(tdet.sample_patch_indices(np.random.default_rng(5)), idx)
        assert idx.shape == (2, 2)
        extras["patch_indices"] = idx
    if mode == "triplet":
        tri = np.random.default_rng(6).choice(B, 3, replace=False)[None].repeat(2, 0)
        tri[1] = tri[1][::-1]
        extras["triplet_indices"] = order_triplets(tri, b["speed"])
    if mode == "ranking":
        assert params["ranking_proj"].shape == (64, 1)
    want, got = losses_and_grads(jdet, tdet, params, b, **extras)
    hold(want, got, aux)
    if mode == "ranking":
        assert np.abs(got[1]["ranking_proj"]).max() > 1e-3
    if mode == "compression_sync":
        assert max(np.abs(g).max() for k, g in got[1].items() if k.startswith("adapter")) > 1e-4


def test_ema_frame_decodes_one_frame(rng):
    """ema_frame collapses the clip before the tower: the decoder sees T = 1
    and only the temporal embedding's first row gets a gradient."""
    jdet, tdet = detectors(op_mode={"ema_frame": 0.5})
    params = random_params(jdet, rng)
    want, got = losses_and_grads(jdet, tdet, params, batch(rng))
    pos = got[1]["decoder.positional_embedding"]
    assert np.abs(pos[0]).max() > 0 and not pos[1:].any()
    np.testing.assert_allclose(pos, want[1]["decoder.positional_embedding"], **TOL)


def test_host_extras_match_jax(rng):
    """From one seed JAX's Trainer._host_extras and the port's draw the same
    patch indices and triplets, in the same order, round after round; the
    port orders each triple by speed as JAX's loop does."""
    over = {"train_mode": {"patch_mask": {"type": "sample", "ratio": 0.5},
                           "temporal": "triplet"}}
    jdet, tdet = detectors(**over)
    cfg = {"max_steps": 4, "batch_size": 2, "num_workers": 0}
    jcfg, tcfg = JTrainer.get_default_config(), Trainer.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    jtr = JTrainer(jcfg, MeshRuntime(devices=jax.devices()[:1]), jdet, [], seed=3)
    ttr = Trainer(tcfg, tdet, {}, seed=3, device="cpu",
                  params=params_from_jax(jax.tree_util.tree_map(
                      np.asarray, {**jtr.frozen, **jtr.trainable})))
    speeds = rng.random(6).astype(np.float32)
    for bsz in (6, 3, 6):
        (jp, jt), (tp, tt) = jtr._host_extras(bsz), ttr._host_extras(bsz)
        np.testing.assert_array_equal(tp, np.asarray(jp))
        np.testing.assert_array_equal(tt, np.asarray(jt))
        assert tt.shape == (min({6: 20, 3: 1}[bsz], 10), 3)
        s = speeds[:bsz]
        want = np.take_along_axis(np.asarray(jt), np.argsort(-s[np.asarray(jt)], axis=1), axis=1)
        np.testing.assert_array_equal(order_triplets(tt, s), want)
        assert (np.diff(s[order_triplets(tt, s)], axis=1) <= 0).all()
    with pytest.raises(ValueError, match="triplet"):
        ttr._host_extras(2)
