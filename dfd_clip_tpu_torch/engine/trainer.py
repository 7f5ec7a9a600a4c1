"""Step-based multi-task trainer (counterpart of
dfd_clip_tpu/engine/trainer.py:Trainer).

Each step draws one collated batch from every task's loader, computes that
task's loss on it and back-propagates it, so the gradients of one step are
summed across its task batches, then takes one optimizer step: the
reference's "zero_grad -> backward per task -> single optimizer.step()". A
non-finite loss aborts the step before the optimizer touches a parameter.

The frozen encoder is placed on the device once, with its matrices in the
compute dtype; the trainable leaves (the decoder and, with one, the
adapter) stay f32 master weights that the model casts per call (an SGD
update of lr x g ~ 1e-6 would vanish in bf16). Teacher mode (``mode:
teacher``) keeps an EMA copy of the trainable leaves, p_t = (1 - r) p_t + r
p_s after each step, whose predictions become soft labels for the other
tasks once ``teach_at`` steps have passed. Inference-mode predictions (the
teacher's, the Evaluator's) read ``eval_params()``, the trainable leaves
placed as ``Detector.prepare_params`` places them.

Two constructors:

* JAX's surface, ``Trainer(config, runtime, model, datasets, tracker=None,
  seed=0)``: a shuffled DataLoader a dataset (``trainer.batch_size``
  clips, ``num_workers``, the dataset's collate, drop_last), named
  ``<category>/<name>``, on the runtime's device; the callback events
  (on_training_start / end, on_batch_start / end) that engine/callbacks.py
  and main.py register on; a prefetch thread that reads and places the
  next round of task batches while the current step runs, and joins when
  ``run`` returns or raises; checkpoint and resume every
  ``checkpoint_interval`` steps (engine/checkpoint.py: the trainable
  leaves, the optimizer's state, the teacher, the dropout generator and the
  host RNG), a resumed run continuing the loaders' streams where the saved
  step left them (``set_position``);
* ``Trainer(config, model, loaders, params=None, seed=0, device="cuda")``:
  ``loaders`` is ``{name: iterable of collated batches}``, ``params`` the
  initial parameters (CPU tensors, e.g. carried across with
  ``params_from_jax``).

Batches are the JAX package's six-field form ``(frames uint8 (B, T, 3, H,
W), label, mask (B, T), comps, speed, index)``, ``index`` holding the
batch's task index. Dropout draws come from one ``torch.Generator`` on the
device seeded with ``seed``; they are not JAX's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import optim
from .callbacks import CallbackMixin
from ..models import weights as weights_lib
from ..runtime import OneProcess


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


def _state_to_numpy(tree):
    """An optimizer state_dict (or any nesting of tensors and plain values)
    with its tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_state_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _state_from_numpy(tree):
    """The inverse of _state_to_numpy, as CPU tensors: the optimizer's
    load_state_dict moves each to where its parameter's policy puts it
    (AdamW's step count stays on the CPU)."""
    if isinstance(tree, dict):
        return {k: _state_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_state_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


class Trainer(CallbackMixin):
    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "Trainer"
        C.max_steps = 100
        C.num_workers = 4
        C.batch_size = 16
        C.learning_rate = 1e-3
        C.metrics = []
        C.mode = "normal"
        C.mode_params = CN(new_allowed=True)
        C.lr_scheduler = "one_cycle"
        # train-state checkpointing (0 = off; dir defaults to ./checkpoints)
        C.checkpoint_interval = 0
        C.checkpoint_dir = ""
        C.checkpoint_keep = 3
        return C

    def __init__(self, config, *args, tracker=None, seed: int = 0,
                 params: Optional[Dict] = None, device=None):
        """``Trainer(config, runtime, model, datasets, tracker=None, seed=0)``
        or ``Trainer(config, model, loaders, params=None, seed=0,
        device="cuda")`` (see the module note). ``device`` (second form)
        must be the model's."""
        if hasattr(args[0], "shard_batch"):   # JAX's surface
            runtime, model, datasets, *rest = args
            if len(rest) > 2:
                raise TypeError("Trainer(config, runtime, model, datasets, tracker, seed)")
            tracker = rest[0] if rest else tracker
            seed = rest[1] if len(rest) > 1 else seed
            loaders = None
        else:
            model, loaders = args
            runtime = OneProcess(device if device is not None else "cuda")
            datasets = ()
        if config.mode not in ("normal", "teacher"):
            raise ValueError(f"unknown trainer mode {config.mode!r}")
        if config.mode == "teacher" and not 0 <= config.mode_params.teach_at <= config.max_steps:
            raise ValueError("mode_params.teach_at must lie in [0, max_steps]")
        if config.lr_scheduler != "one_cycle":
            raise NotImplementedError(config.lr_scheduler)
        from ..device import resolve_device

        self.device = resolve_device(runtime.device)
        if model.device != self.device:
            raise ValueError(f"the model runs on {model.device}, the trainer on {self.device}")
        self._init_callbacks()
        self.config = config
        self.mode = config.mode
        self.runtime = runtime
        self.model = model
        self.tracker = tracker
        self.total_tasks = len(model.config.out_dim)
        self.host_rng = np.random.default_rng(seed + runtime.process_index)
        # the step count of the schedule scales with the data-parallel width
        self.schedule = optim.one_cycle_schedule(config.learning_rate,
                                                 config.max_steps * runtime.data_parallel)

        if params is None:
            params = model.init_params(torch.Generator().manual_seed(seed),
                                       encoder_params=getattr(model, "pretrained_encoder",
                                                              None))
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
        self.batch_logits: Dict[str, np.ndarray] = {}
        self.batch_labels: Dict[str, np.ndarray] = {}

        if loaders is None:
            from ..data.loader import DataLoader

            # batch_size is per data-parallel replica; the loader emits the
            # global batch
            loaders = {f"{ds.category}/{ds.name}": DataLoader(
                ds, batch_size=config.batch_size * runtime.data_parallel, shuffle=True,
                num_workers=config.num_workers, collate_fn=ds.collate_fn, drop_last=True,
                seed=seed) for ds in datasets}
        self.loaders = dict(loaders)

        self.start_step = 0
        self.checkpointer = None
        if config.get("checkpoint_interval", 0):
            from .checkpoint import TrainStateCheckpointer

            self.checkpointer = TrainStateCheckpointer(config.checkpoint_dir or "checkpoints",
                                                       keep=config.get("checkpoint_keep", 3))
            restored = self.checkpointer.restore_latest(
                {"trainable": weights_lib.to_numpy_tree(self.trainable), "opt_state": None,
                 "teacher": None, "dropout_gen": None})
            if restored is not None:
                self._restore(*restored)

    # -- checkpoint and resume -------------------------------------------------------
    def _checkpoint_arrays(self) -> Dict:
        return {
            "trainable": weights_lib.to_numpy_tree(self.trainable),
            "opt_state": _state_to_numpy(self.optimizer.state_dict()),
            "teacher": (weights_lib.to_numpy_tree(self.teacher)
                        if self.teacher is not None else None),
            "dropout_gen": self.gen.get_state().numpy(),
        }

    def _restore(self, arrays: Dict, aux: Dict) -> None:
        with torch.no_grad():
            for t, a in zip(_leaves(self.trainable), _leaves(arrays["trainable"])):
                t.copy_(torch.from_numpy(np.array(a)))
            if self.teacher is not None and arrays.get("teacher") is not None:
                for t, a in zip(_leaves(self.teacher), _leaves(arrays["teacher"])):
                    t.copy_(torch.from_numpy(np.array(a)))
        self.optimizer.load_state_dict(_state_from_numpy(arrays["opt_state"]))
        self.gen.set_state(torch.from_numpy(np.array(arrays["dropout_gen"])))
        self.start_step = self.steps = int(aux["step"])
        self.teaching = bool(aux.get("teaching", False))
        self.host_rng = np.random.default_rng()
        self.host_rng.bit_generator.state = aux["host_rng_state"]

    def _maybe_checkpoint(self) -> None:
        interval = self.config.get("checkpoint_interval", 0)
        if not self.checkpointer or not interval or self.steps % interval:
            return
        if self.runtime.is_main_process:
            self.checkpointer.save(self.steps, self._checkpoint_arrays(),
                                   {"teaching": self.teaching,
                                    "host_rng_state": self.host_rng.bit_generator.state})

    # -- helpers ----------------------------------------------------------------
    def current_lr(self) -> float:
        return float(self.schedule(min(self.steps,
                                       self.config.max_steps * self.runtime.data_parallel)))

    def snapshot_model_state(self, include_frozen: bool = False):
        state = {"trainable": weights_lib.to_numpy_tree(self.trainable), "steps": self.steps}
        if include_frozen:
            state["frozen"] = weights_lib.to_numpy_tree(self.frozen)
        return state

    def eval_params(self, trainable: Optional[Dict] = None) -> Dict:
        """The parameters an inference-mode prediction reads: ``trainable``
        (default the live leaves), detached and placed as the model's
        prepare_params places them, over the frozen ones."""
        trainable = self.trainable if trainable is None else trainable
        return _merge(self.model.prepare_params(_map(lambda t: t.detach(), trainable)),
                      self.frozen)

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

    def _host_extras(self, batch_size: int):
        """Per-step host-sampled index arrays (patch mask, triplets): none
        while ``train_mode.patch_mask`` and ``temporal`` are not ported (the
        Detector raises on both)."""
        return None, None

    def _next_batch(self, iterators, name):
        try:
            return next(iterators[name])
        except StopIteration:
            iterators[name] = iter(self.loaders[name])
            try:
                return next(iterators[name])
            except StopIteration:
                raise RuntimeError(f"loader {name!r} yields no batches") from None

    def _task_loss(self, batch: Dict):
        """(the step's loss, per-task losses, per-task logits, targets)."""
        task_index, labels = batch["task"], batch["label"]
        if self.teaching:
            # teacher soft labels under no_grad (predict's own), never
            # inference mode: the loss saves them for its backward
            t_logits, _ = self.model.predict(self.eval_params(self.teacher), batch["x"],
                                             batch["m"])
            y = [labels if i == task_index else torch.softmax(t_logits[i], dim=-1)
                 for i in range(self.total_tasks)]
            single_task = None
        else:
            y = [labels if i == task_index else None for i in range(self.total_tasks)]
            single_task = task_index
        task_losses, task_logits, other = self.model.forward(
            _merge(self.trainable, self.frozen), batch["x"], y, batch["m"],
            batch["comp_is_raw"], train=True, single_task=single_task, gen=self.gen)
        if self.teaching:
            main = sum(loss.mean() for loss in task_losses)
        else:
            main = task_losses[task_index].mean()
        main = main + sum(v.mean() for v in other.values())
        return main, task_losses, task_logits, y

    # -- the loop ----------------------------------------------------------------
    def train_step(self, round_batches: List[Tuple[str, Dict]]) -> None:
        """One optimizer step over one prepared batch per task."""
        self.optimizer.zero_grad(set_to_none=True)
        self.batch_losses, self.batch_logits, self.batch_labels = {}, {}, {}
        to_host = self.runtime.to_host
        for name, batch in round_batches:
            self._host_extras(batch["x"].shape[0])
            loss, task_losses, task_logits, y = self._task_loss(batch)
            loss.backward()
            task = batch["task"]
            self.batch_losses[name] = to_host(task_losses[task])
            self.batch_logits[name] = to_host(task_logits[task])
            self.batch_labels[name] = to_host(y[task])
        self.batch_loss_info = ",".join(f"{np.mean(v):.6f}({n}) "
                                        for n, v in self.batch_losses.items())
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
        """Train from ``start_step`` until ``max_steps``, one batch of every
        loader per step, the next round read and placed on the device by a
        prefetch thread while the current step runs."""
        self.trigger_callbacks("on_training_start")
        self.steps = self.start_step
        if self.steps >= self.config.max_steps:
            self.trigger_callbacks("on_training_end")
            return
        if self.start_step:
            # resume the data stream, not just the parameters: every step
            # draws one batch a loader, so the step count fixes the position
            for dl in self.loaders.values():
                per_epoch = len(dl) if hasattr(dl, "set_position") else 0
                if per_epoch > 0:
                    dl.set_position(self.start_step // per_epoch, self.start_step % per_epoch)
        iterators = {name: iter(dl) for name, dl in self.loaders.items()}
        rounds: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def produce():
            try:
                while not stop.is_set():
                    batch_round = [(name, self.prepare_batch(self._next_batch(iterators, name)))
                                   for name in self.loaders]
                    while not stop.is_set():
                        try:
                            rounds.put(("ok", batch_round), timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except Exception as e:   # handed to the loop, which raises it
                rounds.put(("err", e))

        producer = threading.Thread(target=produce, name="trainer-prefetch", daemon=True)
        producer.start()
        try:
            while True:
                self.trigger_callbacks("on_batch_start")
                kind, batch_round = rounds.get()
                if kind == "err":
                    raise batch_round
                self.train_step(batch_round)
                self._maybe_checkpoint()
                self.trigger_callbacks("on_batch_end")
                if self.steps >= self.config.max_steps:
                    self.trigger_callbacks("on_training_end")
                    return
        finally:
            stop.set()
            # drain so a blocked put returns, then join: a thread still inside
            # a decode when the interpreter exits aborts the process
            while True:
                try:
                    rounds.get_nowait()
                except queue.Empty:
                    break
            producer.join(timeout=60)
            if producer.is_alive():
                raise RuntimeError("the trainer's prefetch thread did not stop")
            for it in iterators.values():   # the loaders' own reader threads stop too
                close = getattr(it, "close", None)
                if close is not None:
                    close()
