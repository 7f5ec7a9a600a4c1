"""The PyTorch port's K/V adapter (dfd_clip_tpu_torch/models/adapter.py) and
the Detector's adapter path against the JAX package, on the CPU at ViT-Test
geometry: every struct type's apply_adapter in evaluation and in training at
dropout 0, the 768-bn batch and running statistics, calibrate_bn_stats,
init_adapter's tree, Detector.predict with an adapter (the unpadded export)
and the gradients of a decoder loss with respect to the adapter and decoder
leaves against jax.grad, the z0 adapter's zero gradients, and the adapter
subtree through params_to_jax / params_from_jax / save_params.

Tolerance: rtol 1e-5 (atol 1e-6) in float32 for the adapter alone, atol =
rtol = 1e-4 (the model hold of tests/test_torch_port_model.py) through the
detector; exact where the contract says zero.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import adapter as jadapter
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu_torch.models import adapter as tadapter
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import detector as tdetector
from dfd_clip_tpu_torch.models import weights as tweights
from dfd_clip_tpu_torch.models.weights import params_from_jax, params_to_jax, to_numpy_tree

ADAPTER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
NSEL, B, T, P, H, D = 2, 3, 4, 4, 4, 16


def adapter_cfgs(struct, dropout=0.0):
    kw = dict(struct_type=struct, inner_dim=32, width=H * D, num_layers=NSEL,
              dropout=dropout, num_frames=T, patches=P)
    return jadapter.AdapterConfig(**kw), tadapter.AdapterConfig(**kw)


def random_leaves(tree, rng):
    """The tree with every leaf replaced by seeded random values of its
    shape (variances positive), so no struct's output is trivial."""
    def leaf(path, x):
        x = np.asarray(x)
        if path and getattr(path[-1], "key", None) == "var":
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def kv_arrays(rng):
    return {s: rng.standard_normal((NSEL, B, T, P, H, D)).astype(np.float32) for s in ("k", "v")}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("struct", jadapter.STRUCT_TYPES)
def test_apply_adapter_matches_jax(rng, struct, train):
    """Each struct's output, stacked K/V in, per-layer lists out (stacked
    here for the comparison), at dropout 0; 768-bn reads its batch
    statistics in training and the stored running ones in evaluation."""
    jcfg, tcfg = adapter_cfgs(struct)
    params = random_leaves(jax.tree_util.tree_map(np.asarray,
                                                  jadapter.init_adapter(jax.random.key(1), jcfg)),
                           rng)
    kvs = kv_arrays(rng)
    want = jadapter.apply_adapter(jax.tree_util.tree_map(jnp.asarray, params),
                                  {s: jnp.asarray(a) for s, a in kvs.items()}, jcfg, train=train)
    got = tadapter.apply_adapter(params_from_jax(params),
                                 {s: torch.from_numpy(a) for s, a in kvs.items()}, tcfg,
                                 train=train)
    for s in ("k", "v"):
        assert isinstance(got[s], list) and len(got[s]) == NSEL
        np.testing.assert_allclose(torch.stack(got[s]).numpy(), np.asarray(want[s]),
                                   **ADAPTER_TOL)


def test_bn_statistics_train_and_eval_differ(rng):
    """768-bn: training normalises with the batch's statistics, evaluation
    with the stored running ones, so the two outputs differ; each matches
    its JAX counterpart (test above)."""
    _, tcfg = adapter_cfgs("768-bn")
    params = tadapter.init_adapter(torch.Generator().manual_seed(0), tcfg)
    kvs = {s: torch.from_numpy(a) for s, a in kv_arrays(rng).items()}
    train = tadapter.apply_adapter(params, kvs, tcfg, train=True)
    evaluation = tadapter.apply_adapter(params, kvs, tcfg, train=False)
    assert not torch.allclose(train["k"][0], evaluation["k"][0])


def test_calibrate_bn_stats_matches_jax(rng):
    """The running statistics from two batches of raw exports."""
    jcfg, tcfg = adapter_cfgs("768-bn")
    params = random_leaves(jax.tree_util.tree_map(np.asarray,
                                                  jadapter.init_adapter(jax.random.key(2), jcfg)),
                           rng)
    batches = [kv_arrays(rng), kv_arrays(rng)]
    want = jadapter.calibrate_bn_stats(jax.tree_util.tree_map(jnp.asarray, params),
                                       [{s: jnp.asarray(a) for s, a in b.items()}
                                        for b in batches], jcfg)
    got = tadapter.calibrate_bn_stats(params_from_jax(params),
                                      [{s: torch.from_numpy(a) for s, a in b.items()}
                                       for b in batches], tcfg)
    for i in range(NSEL):
        for s in ("k", "v"):
            for stat in ("mean", "var"):
                np.testing.assert_allclose(got["blocks"][i][s]["bn"][stat].numpy(),
                                           np.asarray(want["blocks"][i][s]["bn"][stat]),
                                           rtol=1e-5, atol=1e-6)
    other = tadapter.init_adapter(torch.Generator().manual_seed(0), adapter_cfgs("linear")[1])
    assert tadapter.calibrate_bn_stats(other, batches, adapter_cfgs("linear")[1]) is other
    with pytest.raises(ValueError):
        tadapter.calibrate_bn_stats(params_from_jax(params), [], tcfg)


@pytest.mark.parametrize("struct", jadapter.STRUCT_TYPES)
def test_init_adapter_tree(struct):
    """The same tree, leaf shapes and dtype as JAX's init_adapter; z0's
    ln.scale and fc2.w are zeros, linear's fc1 the identity."""
    jcfg, tcfg = adapter_cfgs(struct)
    want = jax.tree_util.tree_map(np.asarray, jadapter.init_adapter(jax.random.key(0), jcfg))
    got = to_numpy_tree(tadapter.init_adapter(torch.Generator().manual_seed(0), tcfg))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    for blk in got["blocks"]:
        for s in ("k", "v"):
            br = blk[s]
            if struct == "768-x-768-z0":
                assert not br["ln"]["scale"].any() and not br["fc2"]["w"].any()
                assert br["fc1"]["w"].any()
            if struct == "linear":
                np.testing.assert_array_equal(br["fc1"]["w"], np.eye(H * D, dtype=np.float32))


@pytest.mark.parametrize("struct", ["768-x-768-nln", "768-bn"])
def test_adapter_subtree_through_the_checkpoint_layout(tmp_path, struct, rng):
    """params_to_jax / params_from_jax carry the adapter subtree both ways
    bit for bit (nln's (P, X) LayerNorm and 768-bn's mean / var are the odd
    shapes); save_params writes what JAX's load_params reads, and the
    port's load_adapter_checkpoint reads it back (bare and under
    "adapter"), refusing a shape that is not the template's."""
    jcfg, tcfg = adapter_cfgs(struct)
    tree = random_leaves(jax.tree_util.tree_map(np.asarray,
                                                jadapter.init_adapter(jax.random.key(3), jcfg)),
                         rng)
    port = params_from_jax({"adapter": tree})
    back = params_to_jax(port)["adapter"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    file = tmp_path / "adapter.pt"
    tweights.save_params(str(file), {"adapter": port["adapter"]})
    loaded = jweights.load_params(str(file))
    for a, b in zip(jax.tree_util.tree_leaves(loaded["adapter"]), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    template = tadapter.init_adapter(torch.Generator().manual_seed(0), tcfg)
    got = tweights.load_adapter_checkpoint(str(file), template)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "bare.pt", "wb") as f:
        pickle.dump(tree, f)
    tweights.load_adapter_checkpoint(str(tmp_path / "bare.pt"), template)
    wrong = tadapter.init_adapter(torch.Generator().manual_seed(0),
                                  dataclasses.replace(tcfg, num_frames=T + 1, patches=P + 1))
    with pytest.raises(ValueError):
        tweights.load_adapter_checkpoint(str(file), wrong)


# -- the Detector's adapter path ------------------------------------------------------

def tiny_detectors(struct, **overrides):
    """JAX's tiny_detector (ViT-Test, decode layers 0 and 2, inner 32) with
    an adapter of ``struct``, and the port's same configuration, f32 CPU."""
    from fixtures import tiny_detector

    adapter = {"type": "normal", "struct": {"type": struct, "x": 32}}
    jdet = tiny_detector(num_frames=T, adapter=adapter, **overrides)
    cfg = tdetector.Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"], "adapter": adapter,
                              **overrides})
    tdet = tdetector.Detector(cfg, num_frames=T, compute_dtype=torch.float32, device="cpu")
    tiny = tvit.ARCHITECTURES["ViT-Test"]
    tdet.vit_cfg = tiny
    tdet.transform = dataclasses.replace(tdet.transform, size=tiny.input_resolution)
    tdet.decoder_cfg = dataclasses.replace(tdet.decoder_cfg, width=tiny.width, heads=tiny.heads)
    tdet.adapter_cfg = dataclasses.replace(tdet.adapter_cfg, width=tiny.width,
                                           patches=tiny.num_patches, inner_dim=32)
    assert dataclasses.asdict(tdet.adapter_cfg) == dataclasses.asdict(jdet.adapter_cfg)
    return jdet, tdet


def detector_params(jdet, rng, randomise=True):
    params = jax.tree_util.tree_map(np.asarray, jdet.init_params(jax.random.key(0)))
    if randomise:
        params["adapter"] = random_leaves(params["adapter"], rng)
    return params


def clip_batch(rng):
    x = rng.integers(0, 256, (B, T, 3, 40, 48), dtype=np.uint8)
    m = np.ones((B, T), bool)
    m[1, 2:] = False
    return x, m


@pytest.mark.parametrize("struct", ["768-x-768", "768-x-768-nln", "768-bn"])
def test_detector_predict_with_adapter_matches_jax(rng, struct):
    """Logits and the adapted features (with_adapt_features) of
    Detector.predict with an adapter: the unpadded export (P = 4 rows, no
    patch_valid) through the adapter into the decoder."""
    jdet, tdet = tiny_detectors(struct)
    params = detector_params(jdet, rng)
    x, m = clip_batch(rng)
    want, wf = jdet.predict(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                            jnp.asarray(m), with_adapt_features=True)
    got, gf = tdet.predict(params_from_jax(params), x, m, with_adapt_features=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MODEL_TOL)
    for s in ("k", "v"):
        assert [tuple(f.shape) for f in gf["adapt"][s]] == [(B, T, P, H, D)] * NSEL
        np.testing.assert_allclose(torch.stack(gf["adapt"][s]).numpy(),
                                   np.asarray(wf["adapt"][s]), **MODEL_TOL)
    _, plain = tiny_detectors(struct)
    plain.adapter_cfg = None
    with pytest.raises(ValueError):
        plain.predict(params_from_jax(params), x, m, with_adapt_features=True)


def loss_grads(jdet, tdet, params, x, m, labels):
    """Gradients of the train-mode loss (dropout 0) with respect to the
    trainable leaves, through JAX's Detector.forward under jax.grad and the
    port's under autograd."""
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    trainable, frozen = jdet.partition_params(jparams)

    def loss_fn(tr):
        losses, _, _ = jdet.forward({**frozen, **tr}, jnp.asarray(x), [jnp.asarray(labels)],
                                    jnp.asarray(m), train=True, single_task=0)
        return losses[0].mean()

    want = jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(trainable))
    tparams = params_from_jax(params)
    ttrain, tfrozen = tdet.partition_params(tparams)
    leaves = [(p, t.requires_grad_(True)) for p, t in
              tdetector_leaves(ttrain)]
    losses, _, _ = tdet.forward({**tfrozen, **ttrain}, x, [torch.from_numpy(labels)], m,
                                train=True, single_task=0)
    grads = torch.autograd.grad(losses[0].mean(), [t for _, t in leaves])
    got = {".".join(map(str, p)): g.numpy() for (p, _), g in zip(leaves, grads)}
    return got, want


def tdetector_leaves(tree):
    from dfd_clip_tpu_torch.engine.optim import named_leaves

    return named_leaves(tree)


def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("struct", ["768-x-768", "768-x-768-nln"])
def test_adapter_and_decoder_gradients_match_jax(rng, struct):
    """Every adapter and decoder leaf's gradient of a train-mode decoder loss
    (dropout 0), through the trainable attention's dK/dV into the adapter,
    against jax.grad."""
    jdet, tdet = tiny_detectors(struct)
    params = detector_params(jdet, rng)
    x, m = clip_batch(rng)
    labels = np.array([0, 1, 1], np.int32)
    got, want = loss_grads(jdet, tdet, params, x, m, labels)
    want = flat(want)
    assert set(got) == set(want)
    adapter_moved = 0.0
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], err_msg=key, **MODEL_TOL)
        if key.startswith("adapter"):
            adapter_moved = max(adapter_moved, float(np.abs(g).max()))
    assert adapter_moved > 1e-3          # the adapter does get a gradient


def test_z0_adapter_gradients_are_zero(rng):
    """At the z0 init (ln.scale = 0, fc2.w = 0) every adapter leaf's
    gradient is exactly 0 in both packages (only weight decay moves fc1),
    while the decoder's are not."""
    jdet, tdet = tiny_detectors("768-x-768-z0")
    params = detector_params(jdet, rng, randomise=False)
    x, m = clip_batch(rng)
    got, want = loss_grads(jdet, tdet, params, x, m, np.array([0, 1, 1], np.int32))
    want = flat(want)
    for key, g in got.items():
        if key.startswith("adapter"):
            assert not g.any() and not want[key].any(), key
    assert any(np.abs(g).max() > 0 for k, g in got.items() if k.startswith("decoder"))


def test_pretrained_frozen_adapter_partition(tmp_path, rng):
    """adapter.type "pretrain" reads adapter.path into init_params; with
    adapter.frozen the adapter moves to the frozen half, as in JAX."""
    jdet, _ = tiny_detectors("768-x-768")
    tree = random_leaves(detector_params(jdet, rng, randomise=False)["adapter"], rng)
    with open(tmp_path / "adapter.pt", "wb") as f:
        pickle.dump({"adapter": tree}, f)
    pre = {"type": "pretrain", "frozen": 1, "path": str(tmp_path / "adapter.pt"),
           "struct": {"type": "768-x-768", "x": 32}}
    cfg = tdetector.Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0, 2],
                              "out_dim": [2], "losses": ["auc_roc"], "adapter": pre,
                              "architecture": "ViT-Test"})
    tdet = tdetector.Detector(cfg, num_frames=T, compute_dtype=torch.float32, device="cpu")
    tdet.adapter_cfg = dataclasses.replace(tdet.adapter_cfg, inner_dim=32)
    params = tdet.init_params(torch.Generator().manual_seed(0))
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy_tree(params["adapter"])),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    trainable, frozen = tdet.partition_params(params)
    assert "adapter" in frozen and "adapter" not in trainable
