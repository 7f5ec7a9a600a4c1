"""The int8 AUROC gates (the port of tests/test_int8_e2e.py:47-250): a
model trained in bf16 and scored with the W8A8 encoder must keep its
ranking, on two cv2-written FFPP fixture trees (tests/test_learning.py's
make_separable_ffpp_tree and make_adversarial_ffpp_tree, written here with
the same numpy draws):

* separable: trained in bf16 (30 steps, lr 3e-3, batch 16, 4-frame clips of
  2 s), scored bf16 / ``compute_int8`` / ``compute_int8`` + ``int8_rows``:
  each AUROC > 0.9, each int8 score within 0.05 of bf16. The training goes
  through the decoder attention's trainable Function (its kernels on the
  card), so this is also the JAX package's decoder-VJP learning gate;
* adversarial (60 steps): bf16 in (0.72, 0.999), both int8 forms >= bf16 -
  0.02;
* the whole-encoder tower with int8 attention "1" (``compute_int8``,
  ``EncoderKernels(tower=True, int8_attn="1")``) scoring a bf16-trained
  model on the separable tree: > 0.9 and within 0.05 (a model of its own
  when its detector keeps other layers);
* trained with ``compute_int8``, scored int8 and bf16: > 0.9 and within 0.05.

A model is scored with another Detector by swapping the Trainer's model and
preparing its frozen tree anew from the pristine one (``Trainer.frozen``),
as the JAX gate swaps the model over its pristine frozen tree.

    python -m dfd_clip_tpu_torch.tools.int8_gates [--device cuda|cpu] [--work DIR]

runs the four gates on the flagship (CLIP ViT-B/16, keep 6-11, bf16 on the
card; on the CPU the JAX tests' tiny tower in f32) and prints each AUROC.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from os import path
from typing import Callable, Dict

import numpy as np

# the JAX gates' training (tests/test_int8_e2e.py) and thresholds
STEPS, ADVERSARIAL_STEPS, LR, BATCH, NUM_FRAMES, CLIP_SECONDS = 30, 60, 3e-3, 16, 4, 2
LEARNED, ADVERSARIAL_LEARNED, SATURATED = 0.9, 0.72, 0.999
CLOSE, ADVERSARIAL_DROP = 0.05, 0.02
EVAL_BATCH = 4


def _write(p: str, frames, fps: float, size: int, quality=None) -> None:
    import cv2

    os.makedirs(path.dirname(p), exist_ok=True)
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), fps, (size, size))
    if quality is not None:
        w.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)
    for f in frames:
        w.write(f)
    w.release()


def _splits(root: str, ids_of: Dict[str, tuple]) -> None:
    os.makedirs(path.join(root, "splits"), exist_ok=True)
    for s, ids in ids_of.items():
        with open(path.join(root, "splits", f"{s}.json"), "w") as f:
            json.dump([[a, b] for a, b in zip(ids[0::2], ids[1::2])], f)


def make_separable_ffpp_tree(root: str, fps=25.0, duration_s=4.0, size=64) -> str:
    """REAL videos dark textures, fakes bright (a signal a frozen random
    encoder's features carry): tests/test_learning.py's tree."""
    ids = ("000", "001", "002", "003")
    pairs = [f"{a}_{b}" for a, b in zip(ids[0::2], ids[1::2])]
    pairs += [f"{b}_{a}" for a, b in zip(ids[0::2], ids[1::2])]
    n = int(duration_s * fps)
    for t, names, lo in (("real", ids, 20), ("DF", pairs, 160)):
        for seed, name in enumerate(names):
            rng = np.random.default_rng(seed + (0 if t == "real" else 100))
            base = rng.integers(lo, lo + 70, (size, size, 3), np.uint8)
            _write(path.join(root, t, "raw", "videos", f"{name}.avi"),
                   (np.roll(base, f, axis=0) for f in range(n)), fps, size)
    _splits(root, {s: ids for s in ("train", "val", "test")})
    return root


def make_adversarial_ffpp_tree(root: str, fps=25.0, duration_s=4.0, size=64) -> str:
    """Near-boundary brightness levels interleaved across the classes in the
    test split (a perfect brightness ranker reaches ~0.81), disjoint train /
    test identities, the test split re-encoded at MJPG quality 30 against
    95: tests/test_learning.py's tree."""
    train_ids, test_ids = ("000", "001", "002", "003"), ("004", "005", "006", "007")
    levels = {"train": {"real": (70, 90, 110, 130), "DF": (110, 130, 150, 170)},
              "test": {"real": (80, 100, 120, 140), "DF": (105, 125, 145, 165)}}

    def frames(rng, lo):
        base = rng.integers(lo - 10, lo + 10, (size, size, 3)).astype(np.uint8)
        for f in range(int(duration_s * fps)):
            noisy = base.astype(np.int16) + rng.integers(-12, 13, base.shape)
            yield np.roll(np.clip(noisy, 0, 255).astype(np.uint8), f, axis=0)

    for split, ids, quality, seed0 in (("train", train_ids, 95, 0), ("test", test_ids, 30, 50)):
        pairs = [f"{a}_{b}" for a, b in zip(ids[0::2], ids[1::2])]
        pairs += [f"{b}_{a}" for a, b in zip(ids[0::2], ids[1::2])]
        for kind, names, off in (("real", ids, 0), ("DF", pairs, 100)):
            for s, name in enumerate(names):
                rng = np.random.default_rng(seed0 + off + s)
                _write(path.join(root, kind, "raw", "videos", f"{name}.avi"),
                       frames(rng, levels[split][kind][s % 4]), fps, size, quality)
    _splits(root, {"train": train_ids, "val": test_ids, "test": test_ids})
    return root


def _ffpp(root: str, split: str, runtime, **over):
    from ..data.datasets import FFPP

    cfg = FFPP.get_default_config()
    cfg.merge_from_other_cfg({"root_dir": root, "types": ["REAL", "DF"],
                              "category": "deepfake", "random_speed": 0, **over})
    return FFPP(cfg, num_frames=NUM_FRAMES, clip_duration=CLIP_SECONDS, runtime=runtime,
                split=split, index=0, video_backend="opencv")


def _metrics():
    from ..config import CN

    return [CN({"name": "deepfake/ffpp", "types": ["roc_auc"]})]


def train(det, root: str, runtime, steps: int):
    """A Trainer over the tree's train split (lr 3e-3, batch 16, no
    workers), run for ``steps`` steps."""
    from ..engine.trainer import Trainer

    cfg = Trainer.get_default_config()
    cfg.merge_from_other_cfg({"max_steps": steps, "batch_size": BATCH, "num_workers": 0,
                              "learning_rate": LR})
    cfg.metrics = _metrics()
    trainer = Trainer(cfg, runtime, det, [_ffpp(root, "train", runtime)])
    trainer.run()
    return trainer


def auroc(trainer, det, root: str, runtime) -> float:
    """The test split's ROC AUC of the trainer's parameters scored by
    ``det``: the Trainer's model swapped for ``det`` and its frozen tree
    prepared by ``det`` from the pristine one."""
    from ..engine.callbacks import compute_metrics, init_metrics, update_metrics
    from ..engine.evaluator import Evaluator

    trainer.model = det
    trainer.frozen_run = det.prepare_params(trainer.frozen)
    cfg = Evaluator.get_default_config()
    cfg.merge_from_other_cfg({"batch_size": EVAL_BATCH, "num_workers": 0})
    cfg.metrics = _metrics()
    ev = Evaluator(cfg, runtime, [_ffpp(root, "test", runtime, augmentation="none")])
    ev.add_callback("on_evaluation_start", init_metrics)
    ev.add_callback("on_batch_end", update_metrics)
    ev.add_callback("on_evaluation_end", compute_metrics, training_eval_interval=1)
    ev.run(trainer)
    return float(ev.computed_metrics["metric/deepfake/ffpp/roc_auc"])


INT8 = {"compute_int8": 1}
ROWS8 = {"compute_int8": 1, "kv_dtype": "int8_rows"}


def run_gates(factory: Callable, work: str, runtime, log=print) -> Dict[str, dict]:
    """The four gates. ``factory(op_mode, tower)`` builds a Detector with
    ``op_mode`` added to {"temporal_position": 1}; with ``tower`` the one the
    tower gate trains and scores (its whole-encoder tower with int8
    attention "1" when ``op_mode`` has compute_int8). Returns each gate's
    AUROCs and the failures (a list of messages, empty when all hold)."""
    sep = make_separable_ffpp_tree(path.join(work, "separable"))
    adv = make_adversarial_ffpp_tree(path.join(work, "adversarial"))
    out: Dict[str, dict] = {}
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    base = train(factory({}, False), sep, runtime, STEPS)
    g = {"bf16": auroc(base, factory({}, False), sep, runtime),
         "int8": auroc(base, factory(INT8, False), sep, runtime),
         "int8_rows": auroc(base, factory(ROWS8, False), sep, runtime)}
    out["separable"] = g
    log(f"  separable: {g}")
    for k, v in g.items():
        check(v > LEARNED, f"separable {k} AUROC {v:.4f} <= {LEARNED}")
    for k in ("int8", "int8_rows"):
        check(abs(g["bf16"] - g[k]) < CLOSE, f"separable {k} {g[k]:.4f} vs bf16 {g['bf16']:.4f}")

    tr = train(factory({}, False), adv, runtime, ADVERSARIAL_STEPS)
    g = {"bf16": auroc(tr, factory({}, False), adv, runtime),
         "int8": auroc(tr, factory(INT8, False), adv, runtime),
         "int8_rows": auroc(tr, factory(ROWS8, False), adv, runtime)}
    out["adversarial"] = g
    log(f"  adversarial: {g}")
    check(ADVERSARIAL_LEARNED < g["bf16"] < SATURATED,
          f"adversarial bf16 AUROC {g['bf16']:.4f} outside ({ADVERSARIAL_LEARNED}, {SATURATED})")
    for k in ("int8", "int8_rows"):
        check(g[k] >= g["bf16"] - ADVERSARIAL_DROP,
              f"adversarial {k} {g[k]:.4f} below bf16 {g['bf16']:.4f} - {ADVERSARIAL_DROP}")

    tower_det = factory({}, True)
    if tower_det.layer_indices != factory({}, False).layer_indices:
        tr = train(tower_det, sep, runtime, STEPS)
        g = {"bf16": auroc(tr, factory({}, True), sep, runtime)}
    else:   # the separable gate's model
        tr, g = base, {"bf16": out["separable"]["bf16"]}
    g["tower_int8_attn"] = auroc(tr, factory(INT8, True), sep, runtime)
    out["tower"] = g
    log(f"  tower: {g}")
    check(g["bf16"] > LEARNED, f"tower gate bf16 AUROC {g['bf16']:.4f} <= {LEARNED}")
    check(g["tower_int8_attn"] > LEARNED,
          f"tower int8 attention AUROC {g['tower_int8_attn']:.4f} <= {LEARNED}")
    check(abs(g["bf16"] - g["tower_int8_attn"]) < CLOSE,
          f"tower int8 attention {g['tower_int8_attn']:.4f} vs bf16 {g['bf16']:.4f}")

    tr = train(factory(INT8, False), sep, runtime, STEPS)
    g = {"int8": auroc(tr, factory(INT8, False), sep, runtime),
         "bf16": auroc(tr, factory({}, False), sep, runtime)}
    out["int8_trained"] = g
    log(f"  int8_trained: {g}")
    for k, v in g.items():
        check(v > LEARNED, f"int8-trained model scored {k}: AUROC {v:.4f} <= {LEARNED}")
    check(abs(g["int8"] - g["bf16"]) < CLOSE, f"int8-trained {g['int8']:.4f} vs {g['bf16']:.4f}")
    out["failures"] = failures
    return out


def flagship_factory(device: str):
    """The gates' detectors over 4-frame clips: on the card the flagship
    (CLIP ViT-B/16 at 224 pixels, keep 6-11, out_dim [2], bf16; its keep is
    contiguous, so the tower gate scores the separable gate's model); on the
    CPU the JAX tests' tiny_detector (ViT-Test, keep 0 and 2, f32; the tower
    gate trains its own, keeping 1 and 2)."""
    import torch

    from ..models import clip_vit
    from ..models.detector import Detector, EncoderKernels

    cpu = device == "cpu"

    def factory(op_mode: dict, tower: bool):
        cfg = Detector.get_default_config()
        keep = ([1, 2] if tower else [0, 2]) if cpu else list(range(6, 12))
        cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": keep,
                                  "out_dim": [2], "losses": ["auc_roc"],
                                  "op_mode": {"temporal_position": 1, **op_mode}})
        kernels = EncoderKernels(tower=True, int8_attn="1") if tower and op_mode else \
            EncoderKernels()
        det = Detector(cfg, num_frames=NUM_FRAMES,
                       compute_dtype=torch.float32 if cpu else torch.bfloat16, device=device,
                       encoder_kernels=kernels)
        if cpu:
            tiny = clip_vit.ARCHITECTURES["ViT-Test"]
            det.vit_cfg = tiny
            det.transform = dataclasses.replace(det.transform, size=tiny.input_resolution)
            det.decoder_cfg = dataclasses.replace(det.decoder_cfg, width=tiny.width,
                                                  heads=tiny.heads)
        return det

    return factory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--work", default=None, help="where the trees go (default: a temporary "
                                                 "directory)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..runtime import OneProcess

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out = run_gates(flagship_factory(dev.type), args.work or tmp, OneProcess(dev.type))
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
