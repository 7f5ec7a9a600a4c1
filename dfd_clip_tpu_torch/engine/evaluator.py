"""Evaluator (counterpart of dfd_clip_tpu/engine/evaluator.py:Evaluator;
reference src/evaluator.py).

A no-grad pass over each evaluation DataLoader with the trainer's current
parameters (``Trainer.eval_params``: the trainable leaves placed as the
model's prepare_params places them, over the frozen ones), one
``Detector.forward`` per batch in inference mode for the batch's task. A
ragged tail batch is padded to the full batch by repeating its last clip,
so every batch keeps one shape, and ``batch_valid`` marks the padding rows,
which update_metrics (engine/callbacks.py) drops. The callback events are
JAX's: on_evaluation_start / end, on_batch_start / end. On a multi-rank
runtime each rank predicts its rows of the padded global batch (and its
seq share of the frames where the trainer keeps only those), and its
``batch_labels`` and ``batch_valid`` are those same rows, so that the
metric gather pairs every logit with its own label.

``CompInvEvaluator`` (counterpart of JAX's) runs a CompInvTrainer's
parameters over its loaders round robin, one batch of each loader a
round (full batches only), recording each batch's recon and match losses
("loss/recon", "loss/match" in the metrics), until every loader is spent;
as in the JAX package the last round, which finds every loader spent,
still fires on_batch_start / end with no losses.
"""

from __future__ import annotations

import numpy as np
import torch

from .callbacks import CallbackMixin


class Evaluator(CallbackMixin):
    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "Evaluator"
        C.num_workers = 4
        C.batch_size = 16
        C.metrics = []
        return C

    def __init__(self, config, runtime, datasets, tracker=None):
        from ..data.loader import DataLoader

        self._init_callbacks()
        self.config = config
        self.runtime = runtime
        self.tracker = tracker
        self.dataloaders = {
            f"{ds.category}/{ds.name}": DataLoader(
                ds, batch_size=config.batch_size * runtime.data_parallel, shuffle=False,
                num_workers=config.num_workers, collate_fn=ds.collate_fn, drop_last=False)
            for ds in datasets}

    def snapshot_model_state(self, include_frozen: bool = False):
        return self.trainer.snapshot_model_state(include_frozen)

    def run(self, trainer) -> None:
        self.trigger_callbacks("on_evaluation_start")
        self.steps = trainer.steps
        self.trainer = trainer
        self.batch_num = 0
        self.total_tasks = trainer.total_tasks
        model, to_host = trainer.model, self.runtime.to_host
        params = trainer.eval_params()
        full = self.config.batch_size * self.runtime.data_parallel
        for name, loader in self.dataloaders.items():
            for batch in loader:
                self.trigger_callbacks("on_batch_start")
                frames, label, mask, _comps, _speed, index = batch
                task = int(np.asarray(index).reshape(-1)[0])
                x, y, m = np.asarray(frames), np.asarray(label), np.asarray(mask)
                n = x.shape[0]
                pad = full - n if n < full else 0
                if pad:   # the ragged tail to the full batch: one batch shape
                    x, y, m = (np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                               for a in (x, y, m))
                cut = ("x", "m") if trainer.frame_slice(x.shape[1]) is not None else ()
                arrays = self.runtime.shard_batch({"x": x, "label": y, "m": m}, frames=cut)
                rows = self.runtime.rows(full)
                labels = [arrays["label"] if i == task else None
                          for i in range(self.total_tasks)]
                with torch.no_grad():
                    losses, logits = model.forward(params, arrays["x"], labels,
                                                   arrays["m"].bool(), train=False,
                                                   single_task=task)
                self.batch_losses = {name: to_host(losses[task])}
                self.batch_logits = {name: to_host(logits[task])}
                self.batch_labels = {name: y[rows]}
                self.batch_valid = {name: (np.arange(full) < n)[rows]}
                self.batch_num += 1
                valid = self.batch_valid[name]
                self.batch_loss_info = (f"{np.mean(self.batch_losses[name][valid]):.6f}({name}) "
                                        if valid.any() else f"-({name}) ")
                self.trigger_callbacks("on_batch_end")
        self.trigger_callbacks("on_evaluation_end")


class CompInvEvaluator(CallbackMixin):
    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "CompInvEvaluator"
        C.num_workers = 4
        C.batch_size = 16
        C.metrics = []
        return C

    def __init__(self, config, runtime, datasets, tracker=None):
        from ..data.loader import DataLoader

        self._init_callbacks()
        self.config = config
        self.runtime = runtime
        self.tracker = tracker
        self.dataloaders = {
            f"{ds.category}/{ds.name}": DataLoader(
                ds, batch_size=config.batch_size * runtime.data_parallel, shuffle=False,
                num_workers=config.num_workers, collate_fn=ds.collate_fn, drop_last=True)
            for ds in datasets}

    def snapshot_model_state(self, include_frozen: bool = False):
        return self.trainer.snapshot_model_state(include_frozen)

    def run(self, trainer) -> None:
        self.trigger_callbacks("on_evaluation_start")
        self.steps = trainer.steps
        self.trainer = trainer
        self.batch_num = 0
        model, to_host = trainer.model, self.runtime.to_host
        params = trainer.eval_params()
        iterators = {name: iter(dl) for name, dl in self.dataloaders.items()}
        while iterators:
            self.trigger_callbacks("on_batch_start")
            self.batch_losses, self.batch_logits, self.batch_labels = {}, {}, {}
            for name in list(iterators):
                try:
                    batch = next(iterators[name])
                except StopIteration:
                    iterators.pop(name)
                    continue
                arrays = self.runtime.shard_batch(
                    {"x": np.asarray(batch[0]), "c": np.asarray([c == "raw" for c in batch[3]])})
                with torch.no_grad():
                    recon, match = model.forward(params, arrays["x"], arrays["c"], train=False)
                self.batch_losses["recon"] = to_host(recon)
                self.batch_losses["match"] = to_host(match)
            self.batch_num += 1
            self.batch_loss_info = ",".join(f"{np.mean(v):.6f}({n}) "
                                            for n, v in self.batch_losses.items())
            self.trigger_callbacks("on_batch_end")
        self.trigger_callbacks("on_evaluation_end")
