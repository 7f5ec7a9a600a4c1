"""Per-video evaluation of a training run (counterpart of inference.py), and
the loading of a run's weights that the HTTP Scorer (serve.py) shares.

    python -m dfd_clip_tpu_torch.inference <run_dir> [--modality video|clip]
        [--weight_mode best|last] [--batch_size N] [--aux_file cfg.yaml]
        [--num_workers N] [--test] [--cfg_name setting] [--device cuda|cpu]
        [--video_backend auto|opencv|synthetic]

Reads the run's ``<cfg_name>.yaml`` and ``<weight_mode>_weights.pt``, packs
every clip_duration-second clip of every test video of each Deepfake
dataset in ``data.eval`` (and in ``--aux_file``'s), scores them through
``Detector.predict`` in batches of ``--batch_size`` (a short batch padded by
repeating its last clip) and averages the clips' softmax per video
(``--modality video``) or keeps them per clip (``clip``). Writes
``report_<ts>_<mode>_<modality>.json`` (accuracy, roc_auc per dataset) and
``stats_*.pickle`` (labels and P(fake)) into the run directory, after adding
the reference's [0, 1] sentinel batch to both metrics (reference
inference.py:159-160). One process: ``runtime.OneProcess`` stands in for
the JAX package's MeshRuntime. The run goes on the card unless ``--device
cpu`` is given; without a card it raises. Nothing is sent anywhere when it
ends.
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
import warnings
from collections import deque
from datetime import datetime
from os import path

import numpy as np
import torch

from .config import CN
from .data import CDF, DFDC, FFPP
from .data.loader import DataLoader
from .device import prefetch_iter, resolve_device
from .models import weights as weights_lib
from .models.detector import Detector
from .runtime import OneProcess
from .utils import metrics as metrics_lib

REGISTRY = {"FFPP": FFPP, "CDF": CDF, "DFDC": DFDC}


def load_pretrained_encoder(model, config) -> None:
    """Set ``model.pretrained_encoder`` (the port's encoder params) from the
    first checkpoint found: ``config.model.pretrained``, then the
    foundation's file under ``misc/``. A framework-native pickle
    (``{"backbone": tree}`` or a bare tree with ``blocks``, in the JAX
    layout) is read as it is; anything else as a CLIP or DINOv2 torch
    checkpoint. Without one it warns and the encoder starts random."""
    candidates = []
    if "pretrained" in config.model and config.model.pretrained:
        candidates.append(config.model.pretrained)
    if config.model.foundation == "clip":
        name = config.model.architecture.replace("/", "-").replace("@", "-")
        candidates += [f"misc/{name}.pt", f"misc/{name}.npz"]
    elif config.model.foundation == "farl":
        candidates += ["misc/FaRL-Base-Patch16-LAIONFace20M-ep64.pth", "misc/farl.pth"]
    elif config.model.foundation == "dinov2":
        candidates += ["misc/dinov2_vitb14_pretrain.pth"]
    for c in candidates:
        if not path.isfile(c):
            continue
        tree = None
        try:
            state = weights_lib.load_params(c)
            if isinstance(state, dict):
                state = state.get("backbone", state)
                if isinstance(state, dict) and "blocks" in state:
                    tree = state
        except Exception:   # not a pickle: a torch checkpoint
            tree = None
        if tree is None:
            if config.model.foundation in ("clip", "farl"):
                tree, _ = weights_lib.load_clip_visual(c)
            else:
                tree = weights_lib.load_dinov2(c, model.vit_cfg)
        model.pretrained_encoder = weights_lib.params_from_jax(tree)
        logging.info("Loaded pretrained encoder weights from %s", c)
        return
    logging.warning(
        "No pretrained encoder checkpoint found (%s); using random init. "
        "Place converted weights under misc/ for real runs.", candidates)


def load_model_params(model: Detector, root: str, weight_mode: str):
    """Random params (seed 0) on the pretrained encoder, with the
    checkpoint's ``trainable`` subtree (or the whole state) and ``frozen``
    subtree laid over them. Unprepared: the caller runs
    ``model.prepare_params``."""
    params = model.init_params(torch.Generator().manual_seed(0),
                               encoder_params=getattr(model, "pretrained_encoder", None))
    state = weights_lib.load_params(path.join(root, f"{weight_mode}_weights.pt"))
    trainable = state["trainable"] if isinstance(state, dict) and "trainable" in state else state
    params.update(weights_lib.params_from_jax(trainable))
    if isinstance(state, dict) and "frozen" in state:
        params.update(weights_lib.params_from_jax(state["frozen"]))
    return params


def get_config(cfg_file: str, args) -> CN:
    import yaml

    with open(cfg_file) as f:
        preset = CN(yaml.safe_load(f), new_allowed=True)

    C = CN(new_allowed=True)
    # the Deepfake head's index: first appearance in data.train (the
    # training rule); setting files without data.train take the Deepfake
    # entry's position in data.eval (the reference's rule)
    try:
        cats = list(dict.fromkeys(d.category for d in preset.data.train))
        C.target_task = cats.index("Deepfake")
    except (AttributeError, KeyError, ValueError):
        C.target_task = next(i for i, d in enumerate(preset.data.eval)
                             if d.category == "Deepfake")

    aux = None
    if args.aux_file:
        with open(args.aux_file) as f:
            aux = CN(yaml.safe_load(f), new_allowed=True)

    C.data = CN()
    C.data.num_frames = preset.data.num_frames
    C.data.clip_duration = preset.data.clip_duration
    C.data.datasets = [
        REGISTRY[d.name].get_default_config().merge_from_other_cfg(d)
        for d in list(preset.data.eval) + (list(aux.data.eval) if aux else [])
        if d.category == "Deepfake"
    ]
    for cfg in C.data.datasets:
        cfg.scale = 0.1 if args.test else 1.0

    C.model = Detector.get_default_config().merge_from_other_cfg(preset.model)
    return C


def main(args):
    device = resolve_device(args.device)
    root = args.artifacts_dir
    cfg_file = path.join(root, f"{args.cfg_name}.yaml")
    if not path.isfile(cfg_file):
        raise SystemExit(
            f"no {args.cfg_name}.yaml in {root} — pass a training run directory "
            "(or --cfg_name for a differently named config)")
    if not path.isfile(path.join(root, f"{args.weight_mode}_weights.pt")):
        raise SystemExit(f"no {args.weight_mode}_weights.pt in {root} (--weight_mode best|last)")
    config = get_config(cfg_file, args)
    runtime = OneProcess()

    report, stats = {}, {}
    model = Detector(config.model, config.data.num_frames, device=device)
    wrapper = CN(new_allowed=True)
    wrapper.model = config.model
    load_pretrained_encoder(model, wrapper)
    params = runtime.replicate(model.prepare_params(
        load_model_params(model, root, args.weight_mode)))

    n = args.batch_size

    def predict(x, m):
        return model.predict(params, x, m)[0][config.target_task]

    for ds_cfg in config.data.datasets:
        ds_cfg.pack = 1
        test_dataset = REGISTRY[ds_cfg.name](
            ds_cfg, config.data.num_frames, config.data.clip_duration, runtime=runtime,
            split="test", index=config.target_task, video_backend=args.video_backend)
        # a second entry of one dataset class (two CDF roots through
        # --aux_file) gets its own key instead of overwriting the first's
        ds_key, n_dup = ds_cfg.name, 2
        while ds_key in stats:
            ds_key = f"{ds_cfg.name}#{n_dup}"
            n_dup += 1
        stats[ds_key] = {"label": [], "prob": []}
        loader = DataLoader(test_dataset, batch_size=1, num_workers=args.num_workers,
                            collate_fn=lambda b: b[0], num_shards=runtime.num_processes,
                            shard_index=runtime.process_index)
        logging.info("Dataset %s initialized with %d samples", type(test_dataset).__name__,
                     len(test_dataset))
        accuracy_calc, roc_auc_calc = metrics_lib.accuracy(), metrics_lib.roc_auc()

        def sub_batches():
            """(label, [(clips, masks, n_valid)]) a video, each batch padded
            to ``n`` clips."""
            for i, data in enumerate(loader):
                clips, label, masks = data[0], data[1], data[2]
                if isinstance(clips, list) and len(clips) == 0:
                    logging.error("Sample Index: %d has no clips, skipping...", i)
                    continue
                clips, masks = np.stack(clips), np.stack(masks)
                parts = []
                for j in range(0, len(clips), n):
                    x, m = clips[j: j + n], masks[j: j + n]
                    n_valid = x.shape[0]
                    if n_valid < n:
                        x = np.concatenate([x, np.repeat(x[-1:], n - n_valid, 0)])
                        m = np.concatenate([m, np.repeat(m[-1:], n - n_valid, 0)])
                    parts.append((x, m, n_valid))
                yield label, parts

        def place(item):
            label, parts = item
            return label, [(torch.as_tensor(x).to(device), torch.as_tensor(m).to(device), nv)
                           for x, m, nv in parts]

        local_probs, local_labels = [], []

        def drain(label, outs):
            logits = np.concatenate([o.float().cpu().numpy()[:nv] for o, nv in outs])
            p = _softmax(logits)
            if args.modality == "clip":
                local_probs.append(p)
                local_labels.append(np.asarray(label))
            elif args.modality == "video":
                local_probs.append(p.mean(0, keepdims=True))
                local_labels.append(np.asarray([label[0]]))
            else:
                raise NotImplementedError(args.modality)

        # a few videos' predictions in flight; the oldest is read back first
        pending: deque = deque()
        for label, parts in prefetch_iter(sub_batches(), place):
            pending.append((label, [(predict(xd, md), nv) for xd, md, nv in parts]))
            if len(pending) >= 3:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())

        pred_prob, labels = runtime.gather_ragged((
            np.concatenate(local_probs) if local_probs else np.zeros((0, 2), np.float32),
            np.concatenate(local_labels) if local_labels else np.zeros((0,), np.int64),
        ))
        pred_label = pred_prob.argmax(-1)
        stats[ds_key]["label"] += labels.tolist()
        stats[ds_key]["prob"] += pred_prob[:, 1].tolist()

        if runtime.is_main_process:
            accuracy_calc.add_batch(pred_label, pred_prob, labels)
            roc_auc_calc.add_batch(pred_label, pred_prob, labels)
            # sentinel batch (reference inference.py:159-160)
            accuracy_calc.add_batch(np.array([0, 1]), None, np.array([0, 1]))
            roc_auc_calc.add_batch(None, np.array([[1.0, 0.0], [0.0, 1.0]]), np.array([0, 1]))
            accuracy = round(accuracy_calc.compute()["accuracy"], 3)
            roc_auc = round(roc_auc_calc.compute()["roc_auc"], 3)
            logging.info("accuracy: %s, roc_auc: %s", accuracy, roc_auc)
            report[ds_key] = {"accuracy": accuracy, "roc_auc": roc_auc}

    if runtime.is_main_process:
        stem = f"{datetime.now().strftime('%m%dT%H%M')}_{args.weight_mode}_{args.modality}"
        with open(path.join(root, f"report_{stem}.json"), "w") as f:
            json.dump(report, f, sort_keys=True, indent=4, separators=(",", ": "))
        with open(path.join(root, f"stats_{stem}.pickle"), "wb") as f:
            pickle.dump(stats, f)
    return report


def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Per-video deepfake evaluation of a training run (PyTorch/CUDA port).")
    parser.add_argument("artifacts_dir", type=str, help="Directory with model artifacts")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--aux_file", type=str, default=None)
    parser.add_argument("--weight_mode", type=str, default="best")
    parser.add_argument("--modality", type=str, default="video")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--cfg_name", type=str, default="setting")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default: raises without a card) or cpu")
    parser.add_argument("--video_backend", type=str, default="auto",
                        choices=("auto", "opencv", "synthetic"))
    return parser.parse_args(argv)


if __name__ == "__main__":
    warnings.filterwarnings(action="ignore")
    logging.basicConfig(level="INFO")
    main(parse_args())
