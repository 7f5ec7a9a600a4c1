"""Step-based multi-task trainer (counterpart of
dfd_clip_tpu/engine/trainer.py:Trainer).

Each step draws one collated batch from every task's loader, computes that
task's loss on it and back-propagates it, so the gradients of one step are
summed across its task batches, then takes one optimizer step: the
reference's "zero_grad -> backward per task -> single optimizer.step()". A
non-finite loss aborts the step before the optimizer touches a parameter.

The frozen tree is prepared for the device once, into ``frozen_run``
(``Detector.prepare_params``: its matrices in the compute dtype, and with
``compute_int8`` the tower's int8 ``wq`` / f32 ``ws`` beside them), which
every step and every evaluation reads; ``frozen`` stays the pristine tree
on the host, as the JAX trainer keeps it (trainer.py:40-50), so that
snapshots never see the runtime-only leaves and the card holds the tower
once. The trainable leaves (the decoder and, with one, the
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
device seeded with ``seed``; they are not JAX's. The host extras of a task
batch (``_host_extras``: ``train_mode.patch_mask``'s patch indices, then
``temporal: triplet``'s triples, ``min(C(B, 3), 10)`` of them, each
ordered fastest to slowest by the batch's speeds) come from the host RNG
in the JAX package's order, so they equal JAX's from one seed; the
auxiliary losses the Detector returns join the step's loss and
``batch_losses``.

On a multi-rank runtime (runtime.MeshRuntime) every rank draws the same
global index stream and decodes only its data index's rows of each batch
(the loader's ``rows``); where the model takes frame shards
(``Detector.takes_frame_shards``) and the seq width divides the clip, a
rank also keeps only its seq share of the frames (trainer.py:283-298).
After the backward every trainable gradient is all-reduced (one packed
SUM over the world, with a flag for a non-finite loss on any rank) and
divided by the world size before the step, so every rank takes the same
step, on the global batch's gradient. Checkpoints are written by rank 0
between barriers; each rank's host RNG is ``seed + process_index``, and
on resume rank 0 restores its saved state while the others re-derive
theirs from (seed + rank, step).

``CompInvTrainer`` (counterpart of JAX's CompInvTrainer) pretrains the
compression-invariant adapter of a ``CompInvEncoder``: AdamW over the
adapter (the encoder frozen) on the OneCycle schedule, each task batch of
a step one update of recon + match, the same constructors, callbacks and
prefetch thread, no train-state checkpoints (JAX's has none), and at the
end of a "768-bn" run the BatchNorm running statistics calibrated from the
next batches' raw exports.
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
from ..ops import spmd
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


def order_triplets(triplets: np.ndarray, speeds: np.ndarray) -> np.ndarray:
    """Each (R, 3) row of batch indices reordered fastest to slowest by the
    batch's ``speeds`` (numpy's argsort, as the JAX trainer orders them)."""
    order = np.argsort(-np.asarray(speeds)[triplets], axis=1)
    return np.take_along_axis(triplets, order, axis=1)


class _StepLoop(CallbackMixin):
    """What both trainers share: their two constructors' arguments, the
    loaders, the parameters on the device, and the loop that runs
    ``train_step`` on one round of task batches a step, the next round read
    and placed by a prefetch thread that reads exactly the rounds the run
    takes (so the loaders stand after the last step's batches when the
    loop ends) and is joined when ``run`` returns or raises."""

    def _setup(self, config, args, tracker, seed, params, device) -> None:
        if hasattr(args[0], "shard_batch"):   # JAX's surface
            runtime, model, datasets, *rest = args
            if len(rest) > 2:
                raise TypeError(f"{type(self).__name__}(config, runtime, model, datasets, "
                                f"tracker, seed)")
            tracker = rest[0] if rest else tracker
            seed = rest[1] if len(rest) > 1 else seed
            loaders = None
        else:
            model, loaders = args
            runtime = OneProcess(device if device is not None else "cuda")
            datasets = ()
        from ..device import resolve_device, same_device

        self.device = resolve_device(runtime.device)
        if not same_device(model.device, self.device):
            raise ValueError(f"the model runs on {model.device}, the trainer on {self.device}")
        self._init_callbacks()
        self.config = config
        self.runtime = runtime
        self.model = model
        self.tracker = tracker
        self.steps = 0
        self.start_step = 0
        # the step count of the schedule scales with the data-parallel width
        self.schedule = optim.one_cycle_schedule(config.learning_rate,
                                                 config.max_steps * runtime.data_parallel)
        if params is None:
            params = model.init_params(torch.Generator().manual_seed(seed),
                                       encoder_params=getattr(model, "pretrained_encoder",
                                                              None))
        trainable, frozen = model.partition_params(params)
        self.frozen = _map(lambda t: t.detach().cpu(), frozen)
        self.frozen_run = model.prepare_params(frozen)
        self.trainable = _map(lambda t: t.detach().to(self.device, torch.float32)
                              .clone().requires_grad_(True), trainable)
        self.optimizer = optim.build_optimizer(model.optimizer_spec(), self.schedule,
                                               self.trainable)
        if loaders is None:
            from ..data.loader import DataLoader

            # batch_size is per data-parallel replica; the loader draws the
            # global batch and decodes this rank's rows of it
            full = config.batch_size * runtime.data_parallel
            rows = runtime.rows(full) if runtime.num_processes > 1 else None
            loaders = {f"{ds.category}/{ds.name}": DataLoader(
                ds, batch_size=full, shuffle=True, num_workers=config.num_workers,
                collate_fn=ds.collate_fn, drop_last=True, seed=seed, rows=rows)
                for ds in datasets}
        self.loaders = dict(loaders)
        self.batch_losses: Dict[str, np.ndarray] = {}   # name -> the last step's losses
        self.batch_logits: Dict[str, np.ndarray] = {}
        self.batch_labels: Dict[str, np.ndarray] = {}

    def frame_slice(self, t: int) -> Optional[slice]:
        """This rank's frames of a clip of ``t``, when it keeps only those: on
        a seq width above 1 that divides ``t`` (``spmd.encoder_shapes_ok``),
        for a model whose clips may be split (``takes_frame_shards``)."""
        rt = self.runtime
        takes = getattr(self.model, "takes_frame_shards", lambda: False)()
        if rt.num_processes == 1 or rt.seq_parallel == 1 or not takes \
                or not spmd.encoder_shapes_ok(rt.data_parallel, t, rt) \
                or t != self.model.num_frames:
            return None
        return rt.frames(t)

    def _sync_grads(self, finite: bool) -> bool:
        """Every trainable gradient as its mean over the world (one SUM of a
        packed buffer, with a non-finite flag at its end); returns whether
        every rank's losses were finite. One rank: nothing to do."""
        rt = self.runtime
        if rt.num_processes == 1:
            return finite
        leaves = [t for t in _leaves(self.trainable) if t.grad is not None]
        flag = torch.tensor([0.0 if finite else 1.0], device=self.device)
        packed = torch.cat([t.grad.reshape(-1) for t in leaves] + [flag])
        rt.all_reduce_(packed, "sum")
        packed[:-1] /= rt.num_processes
        offset = 0
        for t in leaves:
            n = t.grad.numel()
            t.grad.copy_(packed[offset:offset + n].view_as(t.grad))
            offset += n
        return bool(packed[-1].item() == 0)

    def current_lr(self) -> float:
        return float(self.schedule(min(self.steps,
                                       self.config.max_steps * self.runtime.data_parallel)))

    def eval_params(self, trainable: Optional[Dict] = None) -> Dict:
        """The parameters an inference-mode prediction reads: ``trainable``
        (default the live leaves), detached and placed as the model's
        prepare_params places them, over ``frozen_run``."""
        trainable = self.trainable if trainable is None else trainable
        return _merge(self.model.prepare_params(_map(lambda t: t.detach(), trainable)),
                      self.frozen_run)

    def _next_batch(self, iterators, name):
        try:
            return next(iterators[name])
        except StopIteration:
            iterators[name] = iter(self.loaders[name])
            try:
                return next(iterators[name])
            except StopIteration:
                raise RuntimeError(f"loader {name!r} yields no batches") from None

    def _after_step(self) -> None:
        """Runs after each step's update, before on_batch_end."""

    def _before_end(self, iterators) -> None:
        """Runs once the last step is taken, before on_training_end, with
        the loaders' iterators standing after that step's batches."""

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
        remaining = self.config.max_steps - self.start_step

        def produce():
            try:
                for _ in range(remaining):
                    batch_round = [(name, self.prepare_batch(self._next_batch(iterators, name)))
                                   for name in self.loaders]
                    while not stop.is_set():
                        try:
                            rounds.put(("ok", batch_round), timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:   # handed to the loop, which raises it
                rounds.put(("err", e))

        producer = threading.Thread(target=produce, name="trainer-prefetch", daemon=True)
        producer.start()
        try:
            try:
                while True:
                    self.trigger_callbacks("on_batch_start")
                    kind, batch_round = rounds.get()
                    if kind == "err":
                        raise batch_round
                    self.train_step(batch_round)
                    self._after_step()
                    self.trigger_callbacks("on_batch_end")
                    if self.steps >= self.config.max_steps:
                        break
            finally:
                stop.set()
                # drain so a blocked put returns, then join: a thread still
                # inside a decode when the interpreter exits aborts the process
                while True:
                    try:
                        rounds.get_nowait()
                    except queue.Empty:
                        break
                producer.join(timeout=60)
                if producer.is_alive():
                    raise RuntimeError("the trainer's prefetch thread did not stop")
            self._before_end(iterators)
            self.trigger_callbacks("on_training_end")
        finally:
            for it in iterators.values():   # the loaders' own reader threads stop too
                close = getattr(it, "close", None)
                if close is not None:
                    close()


class Trainer(_StepLoop):
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
        if config.mode not in ("normal", "teacher"):
            raise ValueError(f"unknown trainer mode {config.mode!r}")
        if config.mode == "teacher" and not 0 <= config.mode_params.teach_at <= config.max_steps:
            raise ValueError("mode_params.teach_at must lie in [0, max_steps]")
        if config.lr_scheduler != "one_cycle":
            raise NotImplementedError(config.lr_scheduler)
        self._setup(config, args, tracker, seed, params, device)
        self.seed = seed
        self.mode = config.mode
        self.total_tasks = len(self.model.config.out_dim)
        self.host_rng = np.random.default_rng(seed + self.runtime.process_index)
        self.teacher = (_map(lambda t: t.detach().clone(), self.trainable)
                        if self.mode == "teacher" else None)
        self.teaching = False
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

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
        rt = self.runtime
        if rt.is_main_process:
            self.host_rng = np.random.default_rng()
            self.host_rng.bit_generator.state = aux["host_rng_state"]
        else:   # only rank 0's stream is saved: the others re-derive theirs
            self.host_rng = np.random.default_rng(
                (self.seed + rt.process_index) * 1_000_003 + self.start_step)

    def _maybe_checkpoint(self) -> None:
        interval = self.config.get("checkpoint_interval", 0)
        if not self.checkpointer or not interval or self.steps % interval:
            return
        self.runtime.barrier("checkpoint start")
        if self.runtime.is_main_process:
            self.checkpointer.save(self.steps, self._checkpoint_arrays(),
                                   {"teaching": self.teaching,
                                    "host_rng_state": self.host_rng.bit_generator.state})
        self.runtime.barrier("checkpoint end")

    # -- helpers ----------------------------------------------------------------
    def snapshot_model_state(self, include_frozen: bool = False):
        state = {"trainable": weights_lib.to_numpy_tree(self.trainable), "steps": self.steps}
        if include_frozen:
            state["frozen"] = weights_lib.to_numpy_tree(self.frozen)
        return state

    def prepare_batch(self, batch) -> Dict:
        """A collated six-field batch -> tensors on the device and its task."""
        frames, label, mask, comps, speed, index = batch
        dev = self.device
        fs = self.frame_slice(np.asarray(frames).shape[1])
        if fs is not None:   # this rank's seq share of the frames
            frames, mask = np.asarray(frames)[:, fs], np.asarray(mask)[:, fs]
        return {
            "x": torch.as_tensor(np.asarray(frames)).to(dev),
            "label": torch.as_tensor(np.asarray(label)).to(dev),
            "m": torch.as_tensor(np.asarray(mask)).to(dev).bool(),
            "comp_is_raw": torch.as_tensor(np.asarray([c == "raw" for c in comps])).to(dev),
            "speed": torch.as_tensor(np.asarray(speed, np.float32)).to(dev),
            "task": int(np.asarray(index).reshape(-1)[0]),
        }

    def _host_extras(self, batch_size: int):
        """A task batch's host-drawn index arrays, from ``host_rng`` in the JAX
        trainer's order: ``train_mode.patch_mask``'s (Lsel, num_select) patch
        indices, then ``temporal: triplet``'s min(C(B, 3), 10) triples of
        distinct rows (unordered; train_step orders them by speed). None for
        a mode that is off."""
        from math import comb

        tm = self.model.config.train_mode
        patch_indices = self.model.sample_patch_indices(self.host_rng)
        triplets = None
        if "temporal" in tm and tm.temporal == "triplet":
            rounds = min(comb(batch_size, 3), 10)
            if rounds == 0:
                raise ValueError("train_mode.temporal='triplet' needs a global batch of >= 3 "
                                 f"clips to sample a speed triplet, got {batch_size} (raise "
                                 "trainer.batch_size)")
            triplets = np.stack([self.host_rng.choice(batch_size, 3, replace=False)
                                 for _ in range(rounds)])
        return patch_indices, triplets

    def _task_loss(self, batch: Dict, patch_indices=None, triplets=None):
        """(the step's loss, per-task losses, per-task logits, targets,
        auxiliary losses)."""
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
            _merge(self.trainable, self.frozen_run), batch["x"], y, batch["m"],
            batch["comp_is_raw"], batch.get("speed"), train=True, single_task=single_task,
            gen=self.gen, patch_indices=patch_indices, triplet_indices=triplets)
        if self.teaching:
            main = sum(loss.mean() for loss in task_losses)
        else:
            main = task_losses[task_index].mean()
        main = main + sum(v.mean() for v in other.values())
        return main, task_losses, task_logits, y, other

    # -- the loop ----------------------------------------------------------------
    def train_step(self, round_batches: List[Tuple[str, Dict]]) -> None:
        """One optimizer step over one prepared batch per task."""
        self.optimizer.zero_grad(set_to_none=True)
        self.batch_losses, self.batch_logits, self.batch_labels = {}, {}, {}
        to_host = self.runtime.to_host
        for name, batch in round_batches:
            patch_indices, triplets = self._host_extras(batch["x"].shape[0])
            if triplets is not None:
                triplets = order_triplets(triplets, to_host(batch["speed"]))
            loss, task_losses, task_logits, y, other = self._task_loss(batch, patch_indices,
                                                                       triplets)
            loss.backward()
            task = batch["task"]
            self.batch_losses[name] = to_host(task_losses[task])
            self.batch_logits[name] = to_host(task_logits[task])
            self.batch_labels[name] = to_host(y[task])
            for k, v in other.items():
                self.batch_losses[k] = to_host(v)
        self.batch_loss_info = ",".join(f"{np.mean(v):.6f}({n}) "
                                        for n, v in self.batch_losses.items())
        # before the optimizer: an abort leaves the last good parameters
        bad = [n for n, losses in self.batch_losses.items() if not np.isfinite(losses).all()]
        if not self._sync_grads(not bad):
            where = f"'{bad[0]}'" if bad else "another rank's batch"
            raise FloatingPointError(f"NaN/Inf loss for {where} at step {self.steps + 1}")
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

    def _after_step(self) -> None:
        self._maybe_checkpoint()


class CompInvTrainer(_StepLoop):
    """The adapter pretrainer's loop (counterpart of JAX's CompInvTrainer;
    reference src/trainer.py:206-316): each task batch of a step is one
    AdamW update of the adapter on recon + match, the learning rate of the
    n-th update schedule(n) (optax's count), a non-finite loss aborting
    before the update."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.name = "CompInvTrainer"
        C.max_steps = 100
        C.num_workers = 4
        C.batch_size = 16
        C.learning_rate = 1e-3
        C.metrics = []
        return C

    def __init__(self, config, *args, tracker=None, seed: int = 0,
                 params: Optional[Dict] = None, device=None):
        """``CompInvTrainer(config, runtime, model, datasets, tracker=None,
        seed=0)`` or ``CompInvTrainer(config, model, loaders, params=None,
        seed=0, device="cuda")``, as Trainer; ``model`` a CompInvEncoder."""
        self._setup(config, args, tracker, seed, params, device)
        self.host_rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.updates = 0   # optimizer updates taken (one a task batch)

    def snapshot_model_state(self, include_frozen: bool = False):
        """{"trainable": {"adapter": ...}, "steps": n}, JAX's layout."""
        return {"trainable": weights_lib.to_numpy_tree(self.trainable), "steps": self.steps}

    def prepare_batch(self, batch) -> Dict:
        """A collated six-field batch -> its frames and compression flags on
        the device."""
        frames, _label, _mask, comps = batch[:4]
        return {"x": torch.as_tensor(np.asarray(frames)).to(self.device),
                "comp_is_raw": torch.as_tensor(np.asarray([c == "raw" for c in comps]))
                .to(self.device)}

    def train_step(self, round_batches: List[Tuple[str, Dict]]) -> None:
        """One step: an update for each task batch of the round."""
        self.batch_losses, self.batch_logits, self.batch_labels = {}, {}, {}
        to_host = self.runtime.to_host
        for name, batch in round_batches:
            self.optimizer.zero_grad(set_to_none=True)
            recon, match = self.model.forward(_merge(self.trainable, self.frozen_run), batch["x"],
                                              batch["comp_is_raw"], train=True, gen=self.gen)
            (recon + match).backward()
            self.batch_losses["recon"] = to_host(recon)
            self.batch_losses["match"] = to_host(match)
            bad = [k for k, v in self.batch_losses.items() if not np.isfinite(v).all()]
            if not self._sync_grads(not bad):
                where = f"'{bad[0]}'" if bad else "another rank's batch"
                raise FloatingPointError(f"NaN/Inf loss {where} of '{name}' at step "
                                         f"{self.steps + 1}")
            lr = float(self.schedule(self.updates))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.updates += 1
        self.steps += 1
        self.batch_loss_info = ",".join(f"{np.mean(v):.6f}({n}) "
                                        for n, v in self.batch_losses.items())

    def _before_end(self, iterators) -> None:
        self._maybe_calibrate_bn(iterators)

    def _maybe_calibrate_bn(self, iterators, n_batches: int = 8) -> None:
        """"768-bn" adapters: fill the evaluation-time BatchNorm running
        statistics from the raw encoder exports of the first loader's next
        ``n_batches`` batches (adapter.calibrate_bn_stats)."""
        cfg = self.model.adapter_cfg
        if cfg.struct_type != "768-bn":
            return
        from ..models import adapter as adapter_lib

        name = next(iter(self.loaders))
        params = self.eval_params()

        def raw_kv_batches():
            for _ in range(n_batches):
                x = self.prepare_batch(self._next_batch(iterators, name))["x"]
                with torch.no_grad():
                    _, kv_raw = self.model.predict(params, x, train=False)
                yield kv_raw

        reduce_sum = self.runtime.all_reduce_ if self.runtime.num_processes > 1 else None
        adapter = adapter_lib.calibrate_bn_stats(self.trainable["adapter"], raw_kv_batches(), cfg,
                                                 reduce_sum)
        self.trainable = {**self.trainable, "adapter": adapter}
