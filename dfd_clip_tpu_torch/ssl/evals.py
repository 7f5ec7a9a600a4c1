"""SSL evaluation suite (counterpart of dfd_clip_tpu/ssl/evals.py;
dinov2/eval/{knn.py, linear.py, log_regression.py}): feature extraction,
kNN, the linear probe and its grid, logistic regression, and the
multi-dataset test.

Features come from ``dinov2_forward`` under ``torch.no_grad`` on the
backbone's device, so on the card each batch runs the encoder attention
kernel once a block. The classifiers run on ``device`` (the card by
default; ``device="cpu"`` explicitly) as torch optimizers that mirror the
JAX package's optax chains: ``add_decayed_weights`` + SGD with momentum 0.9
on a cosine decay is ``torch.optim.SGD`` with ``weight_decay`` and the
learning rate set to the schedule's value before each step; ``optax.adam``
is ``torch.optim.Adam``. The grid's vmapped SGD is written out over the
stacked (members, D, C) weights. Classifier weights start at zero, as the
JAX package's do, so no initial draw is needed.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import dinov2_vit
from ..models.clip_vit import ViTConfig


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks: Sequence[int] = (1, 5),
                  averaging: str = "micro", num_classes: Optional[int] = None) -> Dict[str, float]:
    """Top-k accuracy with the reference's averaging modes
    (dinov2/eval/metrics.py:21-114): "micro" (mean accuracy), "macro" (the
    unweighted mean over the classes seen of each class's accuracy) and
    "per-class" (one entry a class). Rows labelled < 0 (pad rows) are
    dropped."""
    labels = np.asarray(labels)
    valid = labels >= 0
    logits, labels = np.asarray(logits)[valid], labels[valid]
    if num_classes is None:
        num_classes = logits.shape[-1]
    out: Dict[str, float] = {}
    kmax = min(max(ks), logits.shape[-1])
    top = np.argsort(-logits, axis=-1)[:, :kmax]
    for k in ks:
        k_eff = min(k, logits.shape[-1])
        hit = (top[:, :k_eff] == labels[:, None]).any(axis=-1)
        if averaging == "micro":
            out[f"top-{k}"] = float(hit.mean()) if len(hit) else 0.0
            continue
        per_class = np.full((num_classes,), np.nan)
        for c in np.unique(labels):
            per_class[c] = float(hit[labels == c].mean())
        if averaging == "macro":
            seen = ~np.isnan(per_class)
            out[f"top-{k}"] = float(per_class[seen].mean()) if seen.any() else 0.0
        elif averaging == "per-class":
            for c in range(num_classes):
                if not np.isnan(per_class[c]):
                    out[f"top-{k}_class{c}"] = per_class[c]
        else:
            raise ValueError(f"unknown averaging {averaging!r}")
    return out


@torch.no_grad()
def _cls(params, arch: ViTConfig, x: np.ndarray, compute_dtype) -> np.ndarray:
    """One batch's CLS features on the backbone's device, as numpy."""
    x = torch.from_numpy(np.ascontiguousarray(x)).to(params["conv1"]["w"].device)
    return dinov2_vit.dinov2_forward(params, x, arch, compute_dtype)["cls"].cpu().numpy()


def extract_features(backbone_params, arch: ViTConfig, images: np.ndarray, batch_size: int = 64,
                     compute_dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """CLS features (N, W) of (N, 3, S, S) f32 normalized images, in
    batches of ``batch_size`` on the backbone's device; a short last batch
    is padded with its last image (dropped from the output) when there is
    more than one batch, as the JAX package pads it."""
    n = len(images)
    if n == 0:
        raise ValueError("extract_features got an empty image set (empty eval split?)")
    feats = []
    for i in range(0, n, batch_size):
        x = images[i: i + batch_size]
        valid = x.shape[0]
        if valid < batch_size and n > batch_size:
            x = np.concatenate([x, np.repeat(x[-1:], batch_size - valid, 0)])
        feats.append(_cls(backbone_params, arch, x, compute_dtype)[:valid])
    return np.concatenate(feats)


def extract_features_enumerated(backbone_params, arch: ViTConfig, dataset,
                                transform: Optional[Callable] = None, batch_size: int = 64,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Features over an (image, target) dataset through the
    enumerated-targets adapter: samples transformed host-side, batches
    padded to one shape (pad label -1), each feature row scattered into the
    (N, W) output by its enumerated index. Returns (features, labels)."""
    from .data_adapters import DatasetWithEnumeratedTargets, pad_and_collate

    ds = DatasetWithEnumeratedTargets(dataset)
    n = len(ds)
    if n == 0:
        raise ValueError("extract_features_enumerated got an empty dataset")
    feats = labels = None
    for i in range(0, n, batch_size):
        batch = [ds[j] for j in range(i, min(i + batch_size, n))]
        if transform is not None:
            batch = [(transform(img), t) for img, t in batch]
        x, idxs, ys = pad_and_collate(batch, batch_size if n > batch_size else None)
        out = _cls(backbone_params, arch, x.astype(np.float32), compute_dtype)
        if feats is None:
            feats = np.zeros((n, out.shape[-1]), out.dtype)
            labels = np.full((n,), -1, np.int64)
        valid = ys >= 0
        feats[idxs[valid]] = out[valid]
        labels[idxs[valid]] = ys[valid]
    return feats, labels


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    """An array or tensor as a ``dtype`` tensor on ``device``."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def knn_classify(train_feats: np.ndarray, train_labels: np.ndarray, test_feats: np.ndarray,
                 k: int = 20, temperature: float = 0.07, num_classes: Optional[int] = None,
                 device="cuda") -> np.ndarray:
    """Weighted cosine-kNN vote (dinov2/eval/knn.py semantics)."""
    dev = resolve_device(device)
    num_classes = num_classes or int(train_labels.max()) + 1
    k = min(k, len(train_feats))

    def normalize(f):
        return f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)

    tr, te = _t(normalize(train_feats), dev), _t(normalize(test_feats), dev)
    labels = _t(train_labels, dev, torch.int64)
    topv, topi = torch.topk(te @ tr.T, k, dim=-1)
    w = torch.exp(topv / temperature)
    onehot = F.one_hot(labels[topi], num_classes).float()
    return (w[..., None] * onehot).sum(1).argmax(-1).cpu().numpy()


def _predictor(w: torch.Tensor, b: torch.Tensor) -> Callable[[np.ndarray], np.ndarray]:
    def predict(feats: np.ndarray) -> np.ndarray:
        return (_t(feats, w.device) @ w + b).argmax(-1).cpu().numpy()

    return predict


def train_linear_probe(train_feats: np.ndarray, train_labels: np.ndarray, num_classes: int,
                       lr: float = 0.01, epochs: int = 50, batch_size: int = 256,
                       weight_decay: float = 0.0, seed: int = 0, device="cuda"
                       ) -> Tuple[Dict, Callable]:
    """SGD linear classifier on frozen features (dinov2/eval/linear.py's
    probe, one configuration): momentum 0.9, weight decay coupled into the
    gradient, a cosine decay of the learning rate over every step, the
    epochs' permutations from ``np.random.default_rng(seed)``. Returns
    (params, predict_fn)."""
    dev = resolve_device(device)
    w = torch.zeros(train_feats.shape[1], num_classes, device=dev, requires_grad=True)
    b = torch.zeros(num_classes, device=dev, requires_grad=True)
    total_steps = max(1, epochs * ((len(train_feats) + batch_size - 1) // batch_size))
    opt = torch.optim.SGD([w, b], lr=lr, momentum=0.9, weight_decay=weight_decay)
    x_all, y_all = _t(train_feats, dev), _t(train_labels, dev, torch.int64)
    rng = np.random.default_rng(seed)
    n, count = len(train_feats), 0
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - n % batch_size or n, batch_size):
            idx = torch.from_numpy(order[i: i + batch_size]).to(dev)
            for g in opt.param_groups:   # optax.cosine_decay_schedule(lr, total_steps)
                g["lr"] = lr * 0.5 * (1 + math.cos(math.pi * min(count, total_steps)
                                                   / total_steps))
            opt.zero_grad()
            F.cross_entropy(x_all[idx] @ w + b, y_all[idx]).backward()
            opt.step()
            count += 1
    w, b = w.detach(), b.detach()
    return {"w": w, "b": b}, _predictor(w, b)


def train_logistic_regression(train_feats: np.ndarray, train_labels: np.ndarray,
                              num_classes: int, l2: float = 1e-4, steps: int = 500,
                              lr: float = 0.1, device="cuda") -> Callable:
    """Full-batch Adam logistic regression with an L2 penalty on the weights
    (replaces cuML's logistic regression, dinov2/eval/log_regression.py)."""
    dev = resolve_device(device)
    x, y = _t(train_feats, dev), _t(train_labels, dev, torch.int64)
    w = torch.zeros(x.shape[1], num_classes, device=dev, requires_grad=True)
    b = torch.zeros(num_classes, device=dev, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        (F.cross_entropy(x @ w + b, y) + l2 * w.square().sum()).backward()
        opt.step()
    return _predictor(w.detach(), b.detach())


def train_linear_probe_grid(
    train_feats: np.ndarray, train_labels: np.ndarray, num_classes: int,
    lrs: Optional[np.ndarray] = None, weight_decays: Optional[np.ndarray] = None,
    val_fraction: float = 0.1, epochs: int = 50, batch_size: int = 256, seed: int = 0,
    val_feats: Optional[np.ndarray] = None, val_labels: Optional[np.ndarray] = None,
    eval_period_epochs: int = 0, checkpoint_path: Optional[str] = None,
    metrics_path: Optional[str] = None, schedule_epochs: Optional[int] = None, device="cuda",
) -> Tuple[Dict, Callable, Dict]:
    """A grid of linear classifiers over (lr, weight_decay) trained together
    (dinov2/eval/linear.py's AllClassifiers, :429): each member an
    independent (w, b) with momentum-0.9 SGD and its own base learning rate
    on a shared cosine decay, the weight decay added to the gradient. The
    member with the best held-out accuracy (``val_feats`` / ``val_labels``,
    or a ``val_fraction`` split of the train features) is returned as
    (params, predict_fn, report). ``eval_period_epochs`` logs the grid's
    accuracies every N epochs (``report["history"]``, one JSONL line each to
    ``metrics_path``); ``checkpoint_path`` saves the grid and its momenta
    (.npz) at each evaluation and resumes from an existing file, replaying
    the permutation stream; ``schedule_epochs`` fixes the cosine's horizon
    (default ``epochs``). The JAX package's file format and selection."""
    dev = resolve_device(device)
    if lrs is None:
        lrs = np.array([1e-3, 3e-3, 1e-2, 3e-2, 1e-1], np.float32)
    if weight_decays is None:
        weight_decays = np.array([0.0, 1e-4], np.float32)
    grid = [(float(lr), float(wd)) for lr in lrs for wd in weight_decays]
    g = len(grid)
    lr_arr = torch.tensor([p[0] for p in grid], device=dev)
    wd_arr = torch.tensor([p[1] for p in grid], device=dev)

    rng = np.random.default_rng(seed)
    n = len(train_feats)
    if val_feats is not None:
        xs, ys, vx, vy = train_feats, train_labels, val_feats, val_labels
    else:
        order = rng.permutation(n)
        n_val = max(1, int(n * val_fraction))
        val_idx, tr_idx = order[:n_val], order[n_val:]
        xs, ys = train_feats[tr_idx], train_labels[tr_idx]
        vx, vy = train_feats[val_idx], train_labels[val_idx]
    d = train_feats.shape[1]
    w = torch.zeros(g, d, num_classes, device=dev)
    b = torch.zeros(g, num_classes, device=dev)
    mw, mb = torch.zeros_like(w), torch.zeros_like(b)
    steps_per_epoch = max(1, (len(xs) + batch_size - 1) // batch_size)
    horizon = epochs if schedule_epochs is None else schedule_epochs
    if horizon < epochs:
        raise ValueError(f"schedule_epochs={horizon} must cover epochs={epochs}")
    total_steps = horizon * steps_per_epoch

    start_epoch = 0
    if checkpoint_path and os.path.isfile(checkpoint_path):
        ck = np.load(checkpoint_path)
        w, b, mw, mb = (_t(ck[k], dev) for k in ("w", "b", "mw", "mb"))
        start_epoch = int(ck["epoch"])
        for _ in range(start_epoch):
            rng.permutation(len(xs))
    xs_t, ys_t = _t(xs, dev), _t(ys, dev, torch.int64)
    vx_t, vy_t = _t(vx, dev), _t(vy, dev, torch.int64)

    def step(x, y, t):
        nonlocal w, b, mw, mb
        wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
        logits = torch.einsum("nd,gdc->gnc", x, wg) + bg[:, None, :]
        # the members' mean losses summed: each member's gradient is its own
        loss = F.cross_entropy(logits.reshape(-1, num_classes), y.repeat(g),
                               reduction="none").reshape(g, -1).mean(-1).sum()
        gw, gb = torch.autograd.grad(loss, (wg, bg))
        gw = gw + wd_arr[:, None, None] * w
        mw, mb = 0.9 * mw + gw, 0.9 * mb + gb
        lr_t = lr_arr * (0.5 * (1.0 + math.cos(math.pi * t / total_steps)))
        w = w - lr_t[:, None, None] * mw
        b = b - lr_t[:, None] * mb

    def grid_val_acc() -> torch.Tensor:
        logits = torch.einsum("nd,gdc->gnc", vx_t, w) + b[:, None, :]
        return (logits.argmax(-1) == vy_t[None]).float().mean(-1)

    def save_ck(epoch):
        tmp = checkpoint_path + ".tmp.npz"
        np.savez(tmp, w=w.cpu().numpy(), b=b.cpu().numpy(), mw=mw.cpu().numpy(),
                 mb=mb.cpu().numpy(), epoch=epoch)
        os.replace(tmp, checkpoint_path)

    history = []
    inner = range(0, len(xs) - len(xs) % batch_size or len(xs), batch_size)
    t = start_epoch * len(inner)
    for ep in range(start_epoch, epochs):
        ep_order = rng.permutation(len(xs))
        for i in inner:
            idx = torch.from_numpy(ep_order[i: i + batch_size]).to(dev)
            step(xs_t[idx], ys_t[idx], t)
            t += 1
        if eval_period_epochs and (ep + 1) % eval_period_epochs == 0 and ep + 1 < epochs:
            acc = grid_val_acc().cpu().numpy()
            bi = int(np.argmax(acc))
            rec = {"epoch": ep + 1, "best": f"lr{grid[bi][0]:g}_wd{grid[bi][1]:g}",
                   "best_acc": float(acc[bi]),
                   "members": {f"lr{lr:g}_wd{wd:g}": float(acc[i])
                               for i, (lr, wd) in enumerate(grid)}}
            history.append(rec)
            if metrics_path:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if checkpoint_path:
                save_ck(ep + 1)

    val_acc = grid_val_acc().cpu().numpy()
    best = int(np.argmax(val_acc))
    best_params = {"w": w[best], "b": b[best]}
    report = {f"lr{lr:g}_wd{wd:g}": float(val_acc[i]) for i, (lr, wd) in enumerate(grid)}
    report["best"] = f"lr{grid[best][0]:g}_wd{grid[best][1]:g}"
    if eval_period_epochs:
        report["history"] = history
    if checkpoint_path:
        save_ck(epochs)
    return best_params, _predictor(best_params["w"], best_params["b"]), report


def test_on_datasets(probe_params: Dict, datasets: Mapping[str, Tuple[np.ndarray, np.ndarray]],
                     ks: Sequence[int] = (1,), averaging: str = "micro",
                     class_mappings: Optional[Mapping[str, np.ndarray]] = None,
                     metrics_path: Optional[str] = None) -> Dict[str, float]:
    """The selected probe on several test feature sets
    (dinov2/eval/linear.py:429-462): ``datasets`` maps a name to (features,
    labels), pad rows labelled -1 are ignored, ``class_mappings[name]``
    restricts / reorders the logit columns. Returns {f"{name}_top-k":
    percent} and appends one JSONL record a dataset to ``metrics_path``."""
    w = probe_params["w"]
    dev = w.device if torch.is_tensor(w) else torch.device("cpu")
    w, b = _t(w, dev), _t(probe_params["b"], dev)
    results: Dict[str, float] = {}
    for name, (feats, labels) in datasets.items():
        logits = (_t(feats, w.device) @ w + b).cpu().numpy()
        if class_mappings and name in class_mappings:
            logits = logits[:, np.asarray(class_mappings[name])]
        accs = topk_accuracy(logits, labels, ks=ks, averaging=averaging)
        for k, v in accs.items():
            results[f"{name}_{k}"] = 100.0 * v
        if metrics_path:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"dataset": name, **accs}) + "\n")
    return results


# a library function named test_*: keep pytest from collecting it where a
# test module imports it
test_on_datasets.__test__ = False
