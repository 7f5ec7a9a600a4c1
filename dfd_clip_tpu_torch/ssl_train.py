"""SSL (DINOv2-style) pretraining CLI (counterpart of the repository's
ssl_train.py).

    python -m dfd_clip_tpu_torch.ssl_train --data_dir /path/to/images --cfg configs/ssl/base.yaml
    python -m dfd_clip_tpu_torch.ssl_train --synthetic 1000 --steps 100      # smoke
        [--device cuda|cpu]

Trains ``ssl.SSLTrainer`` on an image folder (every image under it,
recursively) or on N synthetic images, with the JAX CLI's flags and YAML,
and writes into ``--out_dir``: ``setting.yaml``, ``log.rank0.txt``,
``checkpoints/`` (with ``checkpoint_interval``) and ``teacher_backbone.pt``,
the teacher's backbone as ``{"backbone": ...}`` through
``models.weights.save_params``, which the JAX package's
``weights.load_params`` and this package's ``ssl_eval`` read. The run goes
on the card unless ``--device cpu`` is given; without a card it raises.
The runtime is ``runtime.MeshRuntime``: launched by torchrun or SLURM it
runs one rank a card (``cuda:<LOCAL_RANK>``, NCCL; Gloo with ``--device
cpu``), each drawing its own images, with ``fsdp: 1`` sharding the leaves
over the ranks (ssl/train.py); rank 0 writes the files. ``main`` returns
the trainer.
"""

from __future__ import annotations

import argparse
import logging
import os
from glob import glob

import numpy as np

from .device import resolve_device
from .models import weights as weights_lib
from .runtime import MeshRuntime, launch
from .ssl import SSLTrainer
from .utils.logging import setup_logging
from .utils.tracking import Tracker


class ImageFolder:
    """Recursive image-folder dataset -> HWC uint8 RGB."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str):
        self.paths = sorted(p for p in glob(os.path.join(root, "**", "*"), recursive=True)
                            if p.lower().endswith(self.EXTS))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        import cv2

        img = cv2.imread(self.paths[i], cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot read {self.paths[i]}")
        return img[..., ::-1]  # BGR -> RGB


class SyntheticImages:
    """N random 256 x 256 RGB images, image i from numpy seed i."""

    def __init__(self, n: int, size: int = 256):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return r.integers(0, 255, (self.size, self.size, 3), dtype=np.uint8)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DINOv2-style SSL pretraining (CUDA)")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic images instead of data_dir")
    parser.add_argument("--cfg", type=str, default=None, help="YAML overrides")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--arch", type=str, default=None)
    parser.add_argument("--out_dim", type=int, default=None)
    parser.add_argument("--local_size", type=int, default=None)
    parser.add_argument("--n_local_crops", type=int, default=None)
    parser.add_argument("--out_dir", type=str, default="logs/ssl")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(args) -> SSLTrainer:
    device = resolve_device(launch.local_device(args.device))
    backend = "nccl" if device.type == "cuda" else "gloo"
    launch.initialize(backend)
    runtime = MeshRuntime(device=device, backend=backend)
    cfg = SSLTrainer.get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.steps is not None:
        cfg.max_steps = args.steps
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    for name in ("arch", "out_dim", "local_size", "n_local_crops"):
        if getattr(args, name) is not None:
            setattr(cfg, name, getattr(args, name))
    if not cfg.checkpoint_dir or cfg.checkpoint_dir == "ssl_checkpoints":
        cfg.checkpoint_dir = os.path.join(args.out_dir, "checkpoints")

    if args.synthetic:
        dataset = SyntheticImages(args.synthetic)
    elif args.data_dir:
        dataset = ImageFolder(args.data_dir)
    else:
        raise SystemExit("one of --data_dir / --synthetic is required")

    os.makedirs(args.out_dir, exist_ok=True)
    setup_logging(args.out_dir, rank=runtime.process_index)
    tracker = Tracker(args.out_dir, enabled=False)
    if runtime.is_main_process:
        with open(os.path.join(args.out_dir, "setting.yaml"), "w") as f:
            f.write(cfg.dump())

    trainer = SSLTrainer(cfg, runtime, dataset, tracker=tracker, device=device)
    metrics = trainer.run()
    runtime.print("final:", metrics)
    # the teacher's backbone: the evaluation-ready weights (dinov2 convention),
    # gathered whole by every rank, written by rank 0
    teacher = trainer.teacher_whole()
    if runtime.is_main_process:
        weights_lib.save_params(os.path.join(args.out_dir, "teacher_backbone.pt"),
                                {"backbone": teacher["backbone"]})
    runtime.barrier("teacher saved")
    runtime.print(f"teacher backbone saved to {args.out_dir}/teacher_backbone.pt")
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main(parse_args())
