"""SSL backbone evaluation CLI: kNN / linear probe / probe grid / logistic
regression (counterpart of the repository's ssl_eval.py).

    python -m dfd_clip_tpu_torch.ssl_eval --weights logs/ssl/teacher_backbone.pt \\
        --train_dir data/train --test_dir data/test --mode knn linear linear-grid logreg \\
        [--arch ViT-B/14] [--device cuda|cpu]

Reads a backbone checkpoint in the JAX layout (``{"backbone": ...}`` as
``ssl_train`` writes it, or a bare backbone tree), labelled image folders
(one subdirectory a class, resized to ``--size`` by cv2's bicubic),
extracts CLS features through ``dinov2_forward`` on the device (the encoder
attention kernel on the card) and prints and returns the chosen modes'
top-1 accuracies. The card unless ``--device cpu``; without a card it
raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from glob import glob

import numpy as np

from .device import resolve_device
from .models import weights as weights_lib
from .models.dinov2_vit import ARCHITECTURES
from .ssl import evals
from .ssl.augmentations import IMAGENET_MEAN, IMAGENET_STD


def load_labeled_folder(root: str, size: int):
    """class-per-subdir -> (images (N, 3, S, S) f32 normalized, labels, classes)."""
    import cv2

    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    images, labels = [], []
    for ci, cname in enumerate(classes):
        for p in sorted(glob(os.path.join(root, cname, "*"))):
            img = cv2.imread(p, cv2.IMREAD_COLOR)
            if img is None:
                continue
            img = cv2.resize(img[..., ::-1], (size, size), interpolation=cv2.INTER_CUBIC)
            f = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            images.append(f.transpose(2, 0, 1))
            labels.append(ci)
    return np.stack(images), np.asarray(labels), classes


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="SSL backbone evaluation (CUDA)")
    parser.add_argument("--weights", required=True, type=str)
    parser.add_argument("--arch", default="ViT-B/14")
    parser.add_argument("--train_dir", required=True, type=str)
    parser.add_argument("--test_dir", required=True, type=str)
    parser.add_argument("--mode", nargs="+", default=["knn"],
                        choices=["knn", "linear", "linear-grid", "logreg"])
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--knn_k", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(args) -> dict:
    device = resolve_device(args.device)
    arch = ARCHITECTURES[args.arch]
    state = weights_lib.load_params(args.weights)
    backbone = weights_lib.params_from_jax(state["backbone"] if "backbone" in state else state)
    backbone = weights_lib.to_device(backbone, device)

    train_x, train_y, classes = load_labeled_folder(args.train_dir, args.size)
    test_x, test_y, _ = load_labeled_folder(args.test_dir, args.size)
    logging.info("train %s, test %s, %d classes", train_x.shape, test_x.shape, len(classes))
    train_f = evals.extract_features(backbone, arch, train_x)
    test_f = evals.extract_features(backbone, arch, test_x)

    results = {}
    if "knn" in args.mode:
        pred = evals.knn_classify(train_f, train_y, test_f, k=args.knn_k,
                                  num_classes=len(classes), device=device)
        results["knn_top1"] = float((pred == test_y).mean())
    if "linear" in args.mode:
        _, predict = evals.train_linear_probe(train_f, train_y, len(classes), device=device)
        results["linear_top1"] = float((predict(test_f) == test_y).mean())
    if "linear-grid" in args.mode:
        _, predict, grid_report = evals.train_linear_probe_grid(train_f, train_y, len(classes),
                                                                device=device)
        results["linear_grid_top1"] = float((predict(test_f) == test_y).mean())
        results["linear_grid_best"] = grid_report["best"]
    if "logreg" in args.mode:
        predict = evals.train_logistic_regression(train_f, train_y, len(classes), device=device)
        results["logreg_top1"] = float((predict(test_f) == test_y).mean())
    print(results)
    return results


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main(parse_args())
