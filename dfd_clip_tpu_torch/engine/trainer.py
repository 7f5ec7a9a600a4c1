"""Step-based multi-task trainer (counterpart of
dfd_clip_tpu/engine/trainer.py:Trainer).

Each step draws one collated batch from every task's loader, computes that
task's loss on it and back-propagates it, so the gradients of one step are
summed across its task batches, then takes one optimizer step: the
reference's "zero_grad -> backward per task -> single optimizer.step()". A
non-finite loss aborts the step before the optimizer touches a parameter.

The frozen encoder is placed on the device once, with its matrices in the
compute dtype; the trainable leaves stay f32 master weights that the
decoder casts per call (an SGD update of lr x g ~ 1e-6 would vanish in
bf16). Teacher mode (``mode: teacher``) keeps an EMA copy of the trainable
leaves, p_t = (1 - r) p_t + r p_s after each step, whose predictions become
soft labels for the other tasks once ``teach_at`` steps have passed.

Loaders are ``{name: iterable of collated batches}`` in the JAX package's
six-field form ``(frames uint8 (B, T, 3, H, W), label, mask (B, T),
comps, speed, index)``, ``index`` holding the batch's task index. Video
decoding, checkpointing, callbacks, the prefetch thread and the evaluator
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import optim
from ..device import resolve_device
from ..models import weights as weights_lib


def _merge(trainable: Dict, frozen: Dict) -> Dict:
    return {**frozen, **trainable}


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in optim.named_leaves(tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


class Trainer:
    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "Trainer"
        C.max_steps = 100
        C.learning_rate = 1e-3
        C.mode = "normal"
        C.mode_params = CN(new_allowed=True)
        C.lr_scheduler = "one_cycle"
        return C

    def __init__(self, config, model, loaders: Dict[str, Iterable], *,
                 params: Optional[Dict] = None, seed: int = 0, device="cuda"):
        """``params``: initial parameters (CPU tensors, e.g. carried across
        with ``params_from_jax``); by default ``model.init_params`` from
        ``seed``. ``device`` must be the model's."""
        if config.mode not in ("normal", "teacher"):
            raise ValueError(f"unknown trainer mode {config.mode!r}")
        if config.mode == "teacher" and not 0 <= config.mode_params.teach_at <= config.max_steps:
            raise ValueError("mode_params.teach_at must lie in [0, max_steps]")
        if config.lr_scheduler != "one_cycle":
            raise NotImplementedError(config.lr_scheduler)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model runs on {model.device}, the trainer on {self.device}")
        self.config = config
        self.mode = config.mode
        self.model = model
        self.loaders = dict(loaders)
        self.total_tasks = len(model.config.out_dim)
        self.schedule = optim.one_cycle_schedule(config.learning_rate, config.max_steps)

        if params is None:
            params = model.init_params(torch.Generator().manual_seed(seed))
        trainable, frozen = model.partition_params(params)
        self.frozen = model.prepare_params(frozen)
        self.trainable = _map(lambda t: t.detach().to(self.device, torch.float32)
                              .clone().requires_grad_(True), trainable)
        self.optimizer = optim.build_optimizer(model.optimizer_spec(), self.schedule,
                                               self.trainable)
        self.teacher = (_map(lambda t: t.detach().clone(), self.trainable)
                        if self.mode == "teacher" else None)
        self.teaching = False
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.batch_losses: Dict[str, np.ndarray] = {}   # name -> the last step's losses

    # -- helpers ----------------------------------------------------------------
    def current_lr(self) -> float:
        return float(self.schedule(min(self.steps, self.config.max_steps)))

    def snapshot_model_state(self, include_frozen: bool = False):
        state = {"trainable": weights_lib.to_numpy_tree(self.trainable), "steps": self.steps}
        if include_frozen:
            state["frozen"] = weights_lib.to_numpy_tree(self.frozen)
        return state

    def prepare_batch(self, batch) -> Dict:
        """A collated six-field batch -> tensors on the device and its task."""
        frames, label, mask, comps, _speed, index = batch
        dev = self.device
        return {
            "x": torch.as_tensor(np.asarray(frames)).to(dev),
            "label": torch.as_tensor(np.asarray(label)).to(dev),
            "m": torch.as_tensor(np.asarray(mask)).to(dev).bool(),
            "comp_is_raw": torch.as_tensor(np.asarray([c == "raw" for c in comps])).to(dev),
            "task": int(np.asarray(index).reshape(-1)[0]),
        }

    def _next_batch(self, iterators, name):
        try:
            return next(iterators[name])
        except StopIteration:
            iterators[name] = iter(self.loaders[name])
            try:
                return next(iterators[name])
            except StopIteration:
                raise RuntimeError(f"loader {name!r} yields no batches") from None

    def _task_loss(self, batch: Dict) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        task_index, labels = batch["task"], batch["label"]
        if self.teaching:
            # teacher soft labels under no_grad (predict's own), never
            # inference mode: the loss saves them for its backward
            t_logits, _ = self.model.predict(_merge(self.teacher, self.frozen),
                                             batch["x"], batch["m"])
            y = [labels if i == task_index else torch.softmax(t_logits[i], dim=-1)
                 for i in range(self.total_tasks)]
            single_task = None
        else:
            y = [labels if i == task_index else None for i in range(self.total_tasks)]
            single_task = task_index
        task_losses, _, other = self.model.forward(
            _merge(self.trainable, self.frozen), batch["x"], y, batch["m"],
            batch["comp_is_raw"], train=True, single_task=single_task, gen=self.gen)
        if self.teaching:
            main = sum(loss.mean() for loss in task_losses)
        else:
            main = task_losses[task_index].mean()
        main = main + sum(v.mean() for v in other.values())
        return main, task_losses

    # -- the loop ----------------------------------------------------------------
    def train_step(self, round_batches: List[Tuple[str, Dict]]) -> None:
        """One optimizer step over one prepared batch per task."""
        self.optimizer.zero_grad(set_to_none=True)
        self.batch_losses = {}
        for name, batch in round_batches:
            loss, task_losses = self._task_loss(batch)
            loss.backward()
            self.batch_losses[name] = task_losses[batch["task"]].detach().cpu().numpy()
        # before the optimizer: an abort leaves the last good parameters
        for name, losses in self.batch_losses.items():
            if not np.isfinite(losses).all():
                raise FloatingPointError(f"NaN/Inf loss for '{name}' at step {self.steps + 1}")
        lr = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.teacher is not None:
            r = self.config.mode_params.ema_ratio
            with torch.no_grad():
                for t, s in zip(_leaves(self.teacher), _leaves(self.trainable)):
                    t.mul_(1.0 - r).add_(s, alpha=r)
        self.steps += 1
        if self.mode == "teacher" and not self.teaching \
                and self.config.mode_params.teach_at < self.steps:
            self.teaching = True

    def run(self) -> None:
        """Train until ``max_steps``, one batch of every loader per step."""
        iterators = {name: iter(loader) for name, loader in self.loaders.items()}
        while self.steps < self.config.max_steps:
            self.train_step([(name, self.prepare_batch(self._next_batch(iterators, name)))
                             for name in self.loaders])
