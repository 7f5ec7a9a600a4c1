"""Metric calculators (the port's own copy of dfd_clip_tpu/utils/metrics.py):
dependency-free NumPy ``accuracy``, ``roc_auc``, ``mse`` and ``rmse`` with
the ``add_batch(pred_labels, pred_probs, labels)`` / ``compute()``
protocol. ``roc_auc`` scores P(class 1); ``rmse`` measures the expectation
of a distribution head against scalar labels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class accuracy:
    def __init__(self):
        self.correct = 0
        self.total = 0

    def add_batch(self, pred_labels, pred_probs, labels):
        pred_labels = np.asarray(pred_labels)
        labels = np.asarray(labels)
        self.correct += int((pred_labels == labels).sum())
        self.total += len(labels)

    def compute(self) -> Dict[str, float]:
        value = self.correct / max(self.total, 1)
        self.correct = 0
        self.total = 0
        return {"accuracy": value}


class roc_auc:
    """AUROC via the rank-statistic (Mann-Whitney U) formulation with ties."""

    def __init__(self):
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def add_batch(self, pred_labels, pred_probs, labels):
        probs = np.asarray(pred_probs, np.float64)
        self.scores.append(probs[:, 1])
        self.labels.append(np.asarray(labels))

    def compute(self) -> Dict[str, float]:
        scores = np.concatenate(self.scores)
        labels = np.concatenate(self.labels).astype(bool)
        self.scores, self.labels = [], []
        n_pos = int(labels.sum())
        n_neg = len(labels) - n_pos
        if n_pos == 0 or n_neg == 0:
            return {"roc_auc": float("nan")}
        order = np.argsort(scores, kind="mergesort")
        ranks = np.empty(len(scores), np.float64)
        sorted_scores = scores[order]
        # average ranks for ties
        i = 0
        while i < len(scores):
            j = i
            while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
                j += 1
            ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
            i = j + 1
        auc = (ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
        return {"roc_auc": float(auc)}


class mse:
    """Elementwise mean squared error over (possibly multi-dim) targets."""

    def __init__(self):
        self.sq_sum = 0.0
        self.count = 0

    def add_batch(self, pred_labels, pred_probs, labels):
        diff = np.asarray(pred_probs, np.float64) - np.asarray(labels, np.float64)
        self.sq_sum += float(np.square(diff).sum())
        self.count += diff.size

    def compute(self) -> Dict[str, float]:
        value = self.sq_sum / max(self.count, 1)
        self.sq_sum, self.count = 0.0, 0
        return {"mse": value}


class rmse:
    """sqrt(mean((E[probs] - label)^2)) for a binned distribution head
    (reference src/callbacks/metrics.py:6-27)."""

    def __init__(self):
        self.expects: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def add_batch(self, pred_labels, pred_probs, labels):
        probs = np.asarray(pred_probs, np.float64)
        bins = np.arange(probs.shape[1], dtype=np.float64)
        self.expects.append(probs @ bins)
        self.labels.append(np.asarray(labels, np.float64))

    def compute(self) -> Dict[str, float]:
        expects = np.concatenate(self.expects)
        labels = np.concatenate(self.labels)
        self.expects, self.labels = [], []
        value = float(np.sqrt(np.sum(np.square(expects - labels) / len(expects))))
        return {"rmse": value}


METRICS = {"accuracy": accuracy, "roc_auc": roc_auc, "mse": mse, "rmse": rmse}
