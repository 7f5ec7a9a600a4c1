"""The SSL evaluation suite in the port (dfd_clip_tpu_torch.ssl.evals and
data_adapters on the CPU) against the JAX package's on the same numpy
inputs: top-k accuracy in every averaging, feature extraction (plain and
enumerated) through ``dinov2_forward`` with the weights carried across,
kNN, the linear probe, logistic regression, the probe grid (its periodic
evaluation, checkpoint and resume, an external validation set), the
multi-dataset test, the data adapters and transforms, and the evaluation
CLI (``python -m dfd_clip_tpu_torch.ssl_eval --device cpu``) against the
repository's ssl_eval.py on cv2-written labelled folders.

Tolerances, with their reasons:
* top-k accuracy, the adapters and the transforms: equal (the same numpy
  and cv2 code);
* features: f32 within 1e-5 (the tower's f32 sums in other orders);
* kNN: the same predictions (one cosine product and a top-k);
* the linear probe, the grid and logistic regression, from zero weights on
  the same permutations: weights within 1e-4 of their largest value (f32
  products and the momentum / Adam arithmetic in other orders over tens of
  steps), the same predictions and, for the grid, the same accuracies and
  the same selected member;
* the CLI: the same results, both on the card's default (bf16) tower run on
  the CPU by each package, whose ties on these separable folders would
  need a 2e-2 move of a feature to flip.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssl_eval as jssl_eval
from dfd_clip_tpu.models import dinov2_vit as jdino
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu.ssl import data_adapters as jad
from dfd_clip_tpu.ssl import evals as jevals
from dfd_clip_tpu_torch import ssl_eval
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ssl import data_adapters as tad
from dfd_clip_tpu_torch.ssl import evals as tevals

ARCH = jdino.ARCHITECTURES["ViT-Test"]


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((3, 16)) * 5
    feats = np.concatenate([centers[c] + rng.standard_normal((60, 16)) for c in range(3)])
    labels = np.repeat(np.arange(3), 60)
    order = rng.permutation(len(feats))
    return feats[order].astype(np.float32), labels[order]


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


@pytest.mark.parametrize("averaging", ["micro", "macro", "per-class"])
def test_topk_accuracy_matches_jax(averaging):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((40, 6))
    labels = rng.integers(-1, 6, 40)
    assert tevals.topk_accuracy(logits, labels, (1, 3), averaging) == \
        jevals.topk_accuracy(logits, labels, (1, 3), averaging)


@pytest.fixture(scope="module")
def backbone():
    jp = jax.tree_util.tree_map(np.asarray, jdino.init_dinov2(jax.random.key(0), ARCH))
    return jp, params_from_jax(jp)


def test_extract_features_match_jax(backbone):
    jp, tp = backbone
    x = np.random.default_rng(2).standard_normal((7, 3, 28, 28)).astype(np.float32)
    want = jevals.extract_features(jax.tree_util.tree_map(jnp.asarray, jp), ARCH, x,
                                   batch_size=3, compute_dtype=jnp.float32)
    got = tevals.extract_features(tp, ARCH, x, batch_size=3, compute_dtype=torch.float32)
    assert got.shape == want.shape == (7, ARCH.width)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _ListDataset:
    def __init__(self, items):
        self._items = items

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self):
        return len(self._items)

    def get_target(self, i):
        return self._items[i][1]


def test_extract_features_enumerated_and_adapters_match_jax(backbone):
    jp, tp = backbone
    rng = np.random.default_rng(3)
    items = [(rng.standard_normal((3, 28, 28)).astype(np.float32), i % 2 if i != 3 else None)
             for i in range(5)]
    want = jevals.extract_features_enumerated(jax.tree_util.tree_map(jnp.asarray, jp), ARCH,
                                              _ListDataset(items), batch_size=2,
                                              compute_dtype=jnp.float32)
    got = tevals.extract_features_enumerated(tp, ARCH, _ListDataset(items), batch_size=2,
                                             compute_dtype=torch.float32)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    tds, jds = tad.DatasetWithEnumeratedTargets(_ListDataset(items)), \
        jad.DatasetWithEnumeratedTargets(_ListDataset(items))
    assert [tds[i][1] for i in range(5)] == [jds[i][1] for i in range(5)]
    assert tds.get_target(2) == jds.get_target(2)
    for a, b in zip(tad.pad_and_collate([tds[0], tds[2]], 4),
                    jad.pad_and_collate([jds[0], jds[2]], 4)):
        np.testing.assert_array_equal(a, b)


def test_transforms_byte_equal():
    img = np.random.default_rng(4).integers(0, 255, (90, 120, 3), np.uint8)
    te = tad.make_classification_eval_transform(resize_size=64, crop_size=56)
    je = jad.make_classification_eval_transform(resize_size=64, crop_size=56)
    assert te(img).tobytes() == je(img).tobytes()
    tt = tad.make_classification_train_transform(crop_size=32, rng=np.random.default_rng(5))
    jt = jad.make_classification_train_transform(crop_size=32, rng=np.random.default_rng(5))
    for _ in range(3):
        assert tt(img).tobytes() == jt(img).tobytes()


def test_knn_and_logistic_regression_match_jax(blobs):
    feats, labels = blobs
    np.testing.assert_array_equal(
        tevals.knn_classify(feats[:120], labels[:120], feats[120:], k=5, device="cpu"),
        jevals.knn_classify(feats[:120], labels[:120], feats[120:], k=5))
    tpred = tevals.train_logistic_regression(feats[:120], labels[:120], 3, steps=100,
                                             device="cpu")
    jpred = jevals.train_logistic_regression(feats[:120], labels[:120], 3, steps=100)
    np.testing.assert_array_equal(tpred(feats[120:]), jpred(feats[120:]))
    assert (tpred(feats[120:]) == labels[120:]).mean() > 0.9


def test_linear_probe_matches_jax(blobs):
    feats, labels = blobs
    tp, tpred = tevals.train_linear_probe(feats[:120], labels[:120], 3, epochs=6,
                                          batch_size=32, weight_decay=1e-3, device="cpu")
    jp, jpred = jevals.train_linear_probe(feats[:120], labels[:120], 3, epochs=6,
                                          batch_size=32, weight_decay=1e-3)
    for k in ("w", "b"):
        close(tp[k].numpy(), np.asarray(jp[k]), 1e-4, k)
    np.testing.assert_array_equal(tpred(feats[120:]), jpred(feats[120:]))


def test_probe_grid_matches_jax_with_periodic_eval_and_resume(blobs, tmp_path):
    """The grid against JAX's (its report, history, selection and weights),
    then a run stopped at epoch 4 on the full run's horizon and resumed:
    the uninterrupted run's weights (as tests/test_ssl_evals_depth.py:79
    holds JAX's)."""
    feats, labels = blobs
    kw = dict(num_classes=3, epochs=8, batch_size=64, seed=0,
              lrs=np.array([1e-2, 1e-1], np.float32),
              weight_decays=np.array([0.0, 1e-2], np.float32), eval_period_epochs=2)
    tpath, jpath = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    tp, tpred, trep = tevals.train_linear_probe_grid(feats, labels, metrics_path=tpath,
                                                     device="cpu", **kw)
    jp, jpred, jrep = jevals.train_linear_probe_grid(feats, labels, metrics_path=jpath, **kw)
    assert trep == jrep and open(tpath).read() == open(jpath).read()
    for k in ("w", "b"):
        close(tp[k].numpy(), np.asarray(jp[k]), 1e-4, k)
    np.testing.assert_array_equal(tpred(feats), jpred(feats))

    ck = str(tmp_path / "probe.npz")
    tevals.train_linear_probe_grid(feats, labels, checkpoint_path=ck, device="cpu",
                                   **{**kw, "epochs": 4, "eval_period_epochs": 4,
                                      "schedule_epochs": 8})
    rp, _, rrep = tevals.train_linear_probe_grid(feats, labels, checkpoint_path=ck,
                                                 device="cpu", **kw)
    np.testing.assert_allclose(rp["w"].numpy(), tp["w"].numpy(), rtol=1e-6, atol=1e-7)
    assert rrep["best"] == trep["best"]


def test_probe_grid_external_val_and_test_on_datasets_match_jax(blobs, tmp_path):
    feats, labels = blobs
    kw = dict(num_classes=3, epochs=5, batch_size=64, val_feats=feats[120:],
              val_labels=labels[120:])
    tp, _, trep = tevals.train_linear_probe_grid(feats[:120], labels[:120], device="cpu", **kw)
    jp, _, jrep = jevals.train_linear_probe_grid(feats[:120], labels[:120], **kw)
    assert trep == jrep
    sets = {"blobA": (feats[120:150], labels[120:150]),
            "blobB": (feats[150:], np.where(np.arange(30) < 3, -1, labels[150:]))}
    mapping = {"blobB": np.array([2, 0, 1])}
    tpath, jpath = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    got = tevals.test_on_datasets(tp, sets, ks=(1, 2), class_mappings=mapping,
                                  metrics_path=tpath)
    want = jevals.test_on_datasets(jp, sets, ks=(1, 2), class_mappings=mapping,
                                   metrics_path=jpath)
    assert got == want and open(tpath).read() == open(jpath).read()


def _write_folders(root, n_train=4, n_test=2, size=40):
    """Three classes told apart by colour, cv2-written PNGs."""
    import cv2

    rng = np.random.default_rng(9)
    colours = [(200, 40, 40), (40, 200, 40), (40, 40, 200)]
    for split, n in (("train", n_train), ("test", n_test)):
        for c, col in enumerate(colours):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                img = np.clip(np.array(col)[None, None] + rng.normal(0, 20, (size, size, 3)),
                              0, 255).astype(np.uint8)
                cv2.imwrite(str(d / f"{i}.png"), img)
    return root / "train", root / "test"


def test_ssl_eval_cli_matches_jax(tmp_path, monkeypatch):
    """python -m dfd_clip_tpu_torch.ssl_eval --device cpu on a backbone that
    the port's save_params wrote, beside the repository's ssl_eval.py on
    the same file: the same folder arrays and the same results in every
    mode."""
    from dfd_clip_tpu_torch.models.weights import save_params

    train, test = _write_folders(tmp_path)
    jp = jax.tree_util.tree_map(np.asarray, jdino.init_dinov2(jax.random.key(1), ARCH))
    weights = str(tmp_path / "teacher_backbone.pt")
    save_params(weights, {"backbone": params_from_jax(jp)})
    assert set(jweights.load_params(weights)) == {"backbone"}
    tx, ty, tc = ssl_eval.load_labeled_folder(str(train), 28)
    jx, jy, jc = jssl_eval.load_labeled_folder(str(train), 28)
    assert tx.tobytes() == jx.tobytes() and (ty == jy).all() and tc == jc
    argv = ["--weights", weights, "--arch", "ViT-Test", "--train_dir", str(train),
            "--test_dir", str(test), "--size", "28", "--knn_k", "3",
            "--mode", "knn", "linear", "linear-grid", "logreg"]
    got = ssl_eval.main(ssl_eval.parse_args(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["ssl_eval.py"] + argv)
    want = jssl_eval.main()
    assert set(got) == {"knn_top1", "linear_top1", "linear_grid_top1", "linear_grid_best",
                        "logreg_top1"}
    assert got == want, json.dumps({"port": got, "jax": want})
