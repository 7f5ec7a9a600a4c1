"""The CompInv adapter pretrainer in the PyTorch port (models/adapter.py
CompInvEncoder, engine/trainer.py CompInvTrainer, engine/evaluator.py
CompInvEvaluator, main.py on the recipe) against the JAX package, on the
CPU at ViT-Test geometry (decode layers 0 and 2, 4 frames, float32,
dropout 0, a 768-x-768 adapter of inner width 32): CompInvEncoder.forward
in modes 0 and 1 and the adapter's gradients against jax.grad; four
CompInvTrainer steps on an FFPP pair tree (pair 1: each item's raw and c23
clips, interleaved) against JAX's CompInvTrainer from the same parameters,
then CompInvEvaluator's losses batch by batch; a 768-bn run's calibrated
BatchNorm statistics; the port's main on the recipe's shape writes the
run directory (JAX's main refuses the recipe); both packages'
load_adapter_checkpoint read an {"adapter": ...} file and refuse a
CompInv run's own snapshot.

Tolerance: atol = rtol = 1e-4 (the model hold of
tests/test_torch_port_model.py); the evaluator's batch count and keys
exactly equal.
"""

import argparse
import dataclasses
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfd_clip_tpu.config import CN as JCN
from dfd_clip_tpu.data import datasets as jds
from dfd_clip_tpu.engine import CompInvEvaluator as JEvaluator
from dfd_clip_tpu.engine import CompInvTrainer as JTrainer
from dfd_clip_tpu.models import CompInvEncoder as JEncoder
from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu.runtime import MeshRuntime
from dfd_clip_tpu_torch.config import CN
from dfd_clip_tpu_torch.data import datasets as tds
from dfd_clip_tpu_torch.engine import CompInvEvaluator, CompInvTrainer
from dfd_clip_tpu_torch.engine.optim import named_leaves
from dfd_clip_tpu_torch.models import CompInvEncoder
from dfd_clip_tpu_torch.models import adapter as tadapter
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import weights as tweights
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.runtime import OneProcess

from fixtures import make_ffpp_tree
from test_torch_port_adapter import random_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
T = 4
ROOT = Path(__file__).resolve().parents[1]


class QuietOneProcess(OneProcess):
    def print(self, *a, **k):
        pass


def encoders(mode=1, struct="768-x-768"):
    """JAX's CompInvEncoder and the port's on ViT-Test, f32 (the port's on
    the CPU), decode layers 0 and 2, adapter inner width 32."""
    over = {"decode_mode": "index", "decode_indices": [0, 2], "mode": mode,
            "adapter": {"struct": {"type": struct, "x": 32}}}
    jcfg = JEncoder.get_default_config()
    jcfg.merge_from_other_cfg(over)
    jenc = JEncoder(jcfg, num_frames=T, compute_dtype=jnp.float32)
    jenc.vit_cfg = jvit.ARCHITECTURES["ViT-Test"]
    jenc.adapter_cfg = dataclasses.replace(jenc.adapter_cfg, width=64, patches=4, inner_dim=32)
    tcfg = CompInvEncoder.get_default_config()
    tcfg.merge_from_other_cfg(over)
    tenc = CompInvEncoder(tcfg, num_frames=T, compute_dtype=torch.float32, device="cpu")
    tenc.vit_cfg = tvit.ARCHITECTURES["ViT-Test"]
    tenc.adapter_cfg = dataclasses.replace(tenc.adapter_cfg, width=64, patches=4, inner_dim=32)
    assert dataclasses.asdict(tenc.adapter_cfg) == dataclasses.asdict(jenc.adapter_cfg)
    return jenc, tenc


def params_of(jenc, rng):
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(0)))
    params["adapter"] = random_leaves(params["adapter"], rng)
    return params


def clips(rng, b=4):
    x = rng.integers(0, 256, (b, T, 3, 40, 48), dtype=np.uint8)
    return x, np.array([True, False, False, True][:b])


@pytest.mark.parametrize("mode", [0, 1])
def test_forward_matches_jax(mode, rng):
    """recon and match of interleaved pairs (the second pair c23 first); mode
    1's recon is 0 in both."""
    jenc, tenc = encoders(mode)
    params = params_of(jenc, rng)
    x, comp = clips(rng)
    want = jax.jit(lambda p, v, c: jenc.forward(p, v, c, train=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(comp))
    got = tenc.forward(params_from_jax(params), x, torch.from_numpy(comp), train=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **TOL)
    assert got[1].item() > 0
    assert (got[0].item() == 0) == (mode == 1)
    kv_a, kv_raw = tenc.predict(params_from_jax(params), x)
    assert [tuple(f.shape) for f in kv_a["k"]] == [(4, T, 4, 4, 16)] * 2
    assert tuple(kv_raw["v"].shape) == (2, 4, T, 4, 4, 16)


def test_adapter_gradients_match_jax(rng):
    """Every adapter leaf's gradient of mode 0's recon + match."""
    jenc, tenc = encoders(mode=0)
    params = params_of(jenc, rng)
    x, comp = clips(rng)
    trainable, frozen = jenc.partition_params(jax.tree_util.tree_map(jnp.asarray, params))

    def loss_fn(tr):
        recon, match = jenc.forward({**frozen, **tr}, jnp.asarray(x), jnp.asarray(comp))
        return recon + match

    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(trainable))
    ttrain, tfrozen = tenc.partition_params(params_from_jax(params))
    leaves = [t.requires_grad_(True) for _, t in named_leaves(ttrain)]
    recon, match = tenc.forward({**tfrozen, **ttrain}, x, torch.from_numpy(comp))
    grads = torch.autograd.grad(recon + match, leaves)
    wl = jax.tree_util.tree_leaves(want)
    assert len(wl) == len(grads) and set(ttrain) == {"adapter"}
    for g, w in zip(grads, wl):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert max(float(g.abs().max()) for g in grads) > 1e-3


# -- the trainer and evaluator -----------------------------------------------------

@pytest.fixture(scope="module")
def pair_tree(tmp_path_factory):
    return make_ffpp_tree(str(tmp_path_factory.mktemp("compinv") / "ffpp"))


@pytest.fixture
def compinv_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", "xla")
    return tmp_path


def pairs(mod, root, split):
    """FFPP of the recipe: c23 listed, pair 1 (each item's raw and c23)."""
    cfg = mod.FFPP.get_default_config()
    cfg.merge_from_other_cfg({"root_dir": root, "types": ["REAL", "DF"], "compressions": ["c23"],
                              "category": "Deepfake", "pair": 1})
    extra = {"video_backend": "opencv"} if mod is tds else {}
    return mod.FFPP(cfg, T, 1.0, split=split, index=0, seed=0, **extra)


def trainers(struct, steps, root):
    jenc, tenc = encoders(mode=0, struct=struct)
    cfg = {"max_steps": steps, "batch_size": 2, "num_workers": 0, "learning_rate": 1e-2}
    jcfg, tcfg = JTrainer.get_default_config(), CompInvTrainer.get_default_config()
    jcfg.merge_from_other_cfg(cfg)
    tcfg.merge_from_other_cfg(cfg)
    jtr = JTrainer(jcfg, MeshRuntime(devices=jax.devices()[:1]), jenc,
                   [pairs(jds, root, "train")], seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, {**jtr.frozen, **jtr.trainable}))
    ttr = CompInvTrainer(tcfg, QuietOneProcess("cpu"), tenc, [pairs(tds, root, "train")],
                         seed=0, params=params)
    return jtr, ttr


def test_trainer_and_evaluator_match_jax(compinv_env, pair_tree):
    """Four steps (batch 2: four clips, two pairs) from the same parameters:
    each step's recon and match, lr = schedule(step), then every adapter
    leaf; then CompInvEvaluator over the validation pairs round robin, the
    same losses batch by batch and the final empty round."""
    jtr, ttr = trainers("768-x-768", 4, pair_tree)
    start = ttr.snapshot_model_state()["trainable"]
    seen = {"jax": [], "port": []}
    for pkg, tr in (("jax", jtr), ("port", ttr)):
        tr.add_callback("on_batch_end", lambda t, pkg=pkg: seen[pkg].append(
            (float(np.asarray(t.batch_losses["recon"])), float(np.asarray(t.batch_losses["match"])),
             t.current_lr())))
        tr.run()
    assert ttr.steps == jtr.steps == 4 and len(seen["port"]) == 4
    for i, (g, w) in enumerate(zip(seen["port"], seen["jax"])):
        np.testing.assert_allclose(g[:2], w[:2], **TOL)
        assert g[2] == ttr.schedule(i + 1)
    got = ttr.snapshot_model_state()
    assert set(got) == {"trainable", "steps"} and got["steps"] == 4
    want = jax.tree_util.tree_map(np.asarray, jtr.trainable)
    moved = 0.0
    for a, b, s in zip(*(jax.tree_util.tree_leaves(t) for t in (got["trainable"], want, start))):
        np.testing.assert_allclose(a, b, **TOL)
        moved = max(moved, float(np.abs(a - s).max()))
    assert moved > 100 * TOL["atol"]

    ecfg = {"batch_size": 2, "num_workers": 0}
    batches = {"jax": [], "port": []}
    jev = JEvaluator(JCN(ecfg), MeshRuntime(devices=jax.devices()[:1]),
                     [pairs(jds, pair_tree, "val")])
    tev = CompInvEvaluator(CN(ecfg), QuietOneProcess("cpu"), [pairs(tds, pair_tree, "val")])
    for pkg, ev, tr in (("jax", jev, jtr), ("port", tev, ttr)):
        ev.add_callback("on_batch_end", lambda e, pkg=pkg: batches[pkg].append(
            {k: float(np.asarray(v)) for k, v in e.batch_losses.items()}))
        ev.run(tr)
    assert len(batches["port"]) == len(batches["jax"]) == len(tev.dataloaders["deepfake/ffpp"]) + 1
    assert batches["port"][-1] == {} and all(batches["port"][:-1])
    for g, w in zip(batches["port"], batches["jax"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_bn_calibration_matches_jax(compinv_env, pair_tree):
    """A four-step 768-bn run (optax's OneCycle needs four steps or more):
    the running statistics calibrated at its end from the next eight
    batches' raw exports equal JAX's."""
    jtr, ttr = trainers("768-bn", 4, pair_tree)
    jtr.run()
    ttr.run()
    for i in range(2):
        for s in ("k", "v"):
            for stat in ("mean", "var"):
                got = ttr.trainable["adapter"]["blocks"][i][s]["bn"][stat].numpy()
                want = np.asarray(jtr.trainable["adapter"]["blocks"][i][s]["bn"][stat])
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
                assert not np.allclose(got, {"mean": 0.0, "var": 1.0}[stat])


# -- the CLI and the adapter checkpoint ---------------------------------------------

def compinv_config(tmp_path, root):
    """configs/comp-inv-encoder/deepfake.yaml at ViT-Test size: the roots,
    types, sizes, steps, intervals and tracking directory changed (its
    model config has no ``pretrained`` key: the tower is a random draw)."""
    cfg = yaml.safe_load((ROOT / "configs" / "comp-inv-encoder" / "deepfake.yaml").read_text())
    cfg["system"].update(mixed_precision="no", evaluation_interval=2, training_eval_interval=2)
    cfg["tracking"]["directory"] = str(tmp_path / "logs")
    cfg["model"].update(architecture="ViT-Test", decode_mode="index", decode_indices=[0, 2])
    cfg["model"]["adapter"]["struct"]["x"] = 32
    cfg["trainer"].update(max_steps=4, batch_size=2, num_workers=0)
    cfg["evaluator"].update(batch_size=2, num_workers=0)
    cfg["data"].update(num_frames=T, clip_duration=1)
    for d in cfg["data"]["train"] + cfg["data"]["eval"]:
        d.update(root_dir=root, types=["REAL", "DF"])
    path = tmp_path / "compinv.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_main_on_the_recipe_writes_the_run_directory(compinv_env, pair_tree):
    """The port's main on the CompInv recipe (whose model config names no
    foundation) trains four steps, evaluates loss/match at steps 2 and 4
    and writes setting.yaml, best_weights.pt and last_weights.pt in JAX's
    {"trainable": {"adapter"}, "steps"} layout and metrics.jsonl; JAX's
    main refuses the same file where it reads model.foundation."""
    import main as jmain

    from dfd_clip_tpu_torch import main as tmain

    cfg = compinv_config(compinv_env, pair_tree)
    run = tmain.main(tmain.parse_args(["--cfg", cfg, "--device", "cpu",
                                       "--video_backend", "opencv"]))
    names = {p.name for p in (compinv_env / "logs").glob("comp-inv/*/*")}
    assert {"setting.yaml", "best_weights.pt", "last_weights.pt", "metrics.jsonl"} <= names
    last = jweights.load_params(f"{run}/last_weights.pt")
    assert last["steps"] == 4 and set(last["trainable"]) == {"adapter"}
    lines = [json.loads(s) for s in open(f"{run}/metrics.jsonl")]
    evals = [r["step"] for r in lines if "compinvevaluator/loss/match" in r]
    assert evals == [2, 4]
    assert any("compinvtrainer/loss/recon" in r for r in lines)
    with pytest.raises(AttributeError, match="foundation"):
        jmain.main(argparse.Namespace(cfg=cfg, debug=False, test=False))


def test_adapter_checkpoint_readers_agree(tmp_path, rng):
    """An {"adapter": ...} file (what save_params writes of a trained
    adapter) is read by both packages' load_adapter_checkpoint, equal to
    the tree; a CompInv run's own snapshot ({"trainable": {"adapter"},
    "steps"}) is refused by both."""
    jenc, tenc = encoders()
    tree = random_leaves(jax.tree_util.tree_map(
        np.asarray, jenc.init_params(jax.random.key(1))["adapter"]), rng)
    template = tadapter.init_adapter(torch.Generator().manual_seed(0), tenc.adapter_cfg)
    tweights.save_params(str(tmp_path / "adapter.pt"), {"adapter": params_from_jax(tree)})
    tweights.save_params(str(tmp_path / "best_weights.pt"),
                         {"trainable": {"adapter": params_from_jax(tree)}, "steps": 4})
    got = tweights.load_adapter_checkpoint(str(tmp_path / "adapter.pt"), template)
    want = jweights.load_adapter_checkpoint(str(tmp_path / "adapter.pt"),
                                            jax.tree_util.tree_map(jnp.asarray, tree))
    for a, b, c in zip(*(jax.tree_util.tree_leaves(t) for t in
                         (tweights.to_numpy_tree(got), want, tree))):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError):
        tweights.load_adapter_checkpoint(str(tmp_path / "best_weights.pt"), template)
    with pytest.raises(ValueError):
        jweights.load_adapter_checkpoint(str(tmp_path / "best_weights.pt"),
                                         jax.tree_util.tree_map(jnp.asarray, tree))
    assert pickle.loads((tmp_path / "best_weights.pt").read_bytes())["steps"] == 4
