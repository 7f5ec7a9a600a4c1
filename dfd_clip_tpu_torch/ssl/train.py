"""SSL training loop (counterpart of dfd_clip_tpu/ssl/train.py;
dinov2/train/train.py:135-314).

One train step: the student forward on the masked global crops and the
local crops, the DINO / iBOT / KoLeo loss, its gradient, the SSL optimizer
(ssl/schedules.py: clip, Adam, scheduled weight decay, layerwise decay),
the teacher's EMA and the loss centers. During the first
``freeze_last_layer_steps`` steps both the gradients and the updates of
the heads' prototype layers (``last_v`` / ``last_g``) are zeroed, as the
JAX step does (train.py:147-178): a zeroed gradient alone would still let
the weight decay move them. Around the step: the cosine schedules, a
one-batch prefetch thread (host multi-crop augmentation and block masks,
then the copy to the device, overlap the previous step), the NaN abort,
the tracker, and train-state checkpoints every ``checkpoint_interval``
steps through engine/checkpoint.py (student, teacher, centers, the
optimizer's moments and step count, and the host RNG's state).

A checkpoint saves the host RNG's state as it was right after the saved
step's batch was made, which the prefetch thread records with each batch;
the JAX loop saves the state when it checkpoints, by which time its
producer may have drawn the next batch. So a resumed run here draws the
crops that the uninterrupted run drew.

One process drives one device (runtime.OneProcess), so ``fsdp: 1`` places
every leaf whole: what the JAX package's P('data') gives over a data axis of
size 1. Sharding the leaves across cards waits for the port's multi-GPU
runtime.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CN
from ..device import resolve_device
from ..engine.optim import named_leaves
from ..models.clip_vit import ViTConfig
from ..models.weights import to_device, to_numpy_tree
from . import schedules as sched_lib
from .augmentations import MultiCropAugmentation
from .masking import BlockMaskGenerator
from .meta_arch import SSLConfig, SSLMetaArch
from .samplers import ShardedInfiniteSampler

# the prototype layers that the freeze window holds (both heads)
FROZEN_LEAVES = tuple((head, leaf) for head in ("dino_head", "ibot_head")
                      for leaf in ("last_v", "last_g"))


class SSLTrainer:
    @staticmethod
    def get_default_config():
        C = CN()
        C.name = "SSLTrainer"
        C.arch = "ViT-B/14"
        C.ffn_layer = ""   # override: "mlp" | "swiglufused"
        C.centering = "centering"  # or "sinkhorn_knopp"
        C.out_dim = 65536
        C.batch_size = 32          # per data-parallel replica
        C.max_steps = 1000
        C.warmup_steps = 100
        C.freeze_last_layer_steps = 30
        C.lr = 0.004               # scaled by sqrt(global_batch/1024)
        C.final_lr = 1.0e-6
        C.weight_decay = 0.04
        C.final_weight_decay = 0.4
        C.teacher_momentum = 0.992
        C.final_teacher_momentum = 1.0
        C.teacher_temp = 0.07
        C.warmup_teacher_temp = 0.04
        C.warmup_teacher_temp_steps = 300
        C.n_local_crops = 8
        C.local_size = 98
        C.mask_ratio_min = 0.1
        C.mask_ratio_max = 0.5
        C.mask_sample_prob = 0.5
        C.layerwise_decay = 0.9
        C.drop_path_rate = 0.0
        C.remat = 0  # rematerialise the student's blocks in the backward
        C.fsdp = 0   # one process: leaves placed whole either way (module note)
        C.checkpoint_interval = 0
        C.checkpoint_dir = "ssl_checkpoints"
        C.seed = 0
        return C

    def __init__(self, config, runtime, dataset, tracker=None, arch: Optional[ViTConfig] = None,
                 device="cuda", params: Optional[tuple] = None):
        """dataset: map-style, ``dataset[i]`` an HWC uint8 RGB image.
        ``params``: the initial (student, teacher, centers) as CPU tensors
        (e.g. carried across with ``params_from_jax``); else drawn from a
        generator seeded with ``config.seed``."""
        from ..models.dinov2_vit import ARCHITECTURES

        self.config, self.runtime, self.dataset, self.tracker = config, runtime, dataset, tracker
        self.device = resolve_device(device)
        vit_cfg = arch or ARCHITECTURES[config.arch]
        if config.get("ffn_layer", ""):
            import dataclasses

            vit_cfg = dataclasses.replace(vit_cfg, ffn_layer=config.ffn_layer)
        self.ssl_cfg = SSLConfig(
            arch=vit_cfg, out_dim=config.out_dim, ibot_out_dim=config.out_dim,
            local_size=config.local_size, n_local_crops=config.n_local_crops,
            drop_path_rate=config.get("drop_path_rate", 0.0),
            remat=bool(config.get("remat", 0)), centering=config.get("centering", "centering"))
        self.meta = SSLMetaArch(self.ssl_cfg)
        if params is None:
            params = self.meta.init_params(torch.Generator().manual_seed(config.seed))
        self.student, self.teacher, self.centers = (to_device(t, self.device) for t in params)
        self.leaves = [t.requires_grad_() for _, t in named_leaves(self.student)]

        global_batch = config.batch_size * runtime.data_parallel
        lr = sched_lib.sqrt_lr_scaling(config.lr, global_batch)
        self.lr_schedule = sched_lib.cosine_with_warmup(lr, config.final_lr, config.max_steps,
                                                        config.warmup_steps)
        self.wd_schedule = sched_lib.cosine_with_warmup(
            config.weight_decay, config.final_weight_decay, config.max_steps)
        self.momentum_schedule = sched_lib.cosine_with_warmup(
            config.teacher_momentum, config.final_teacher_momentum, config.max_steps)
        self.temp_schedule = sched_lib.cosine_with_warmup(
            config.teacher_temp, config.teacher_temp, config.max_steps,
            warmup_steps=config.warmup_teacher_temp_steps, start=config.warmup_teacher_temp)
        self.optimizer = sched_lib.SSLOptimizer(self.student, self.lr_schedule,
                                                self.wd_schedule, n_layers=vit_cfg.layers,
                                                layerwise_decay=config.layerwise_decay)
        self.frozen = [i for i, p in enumerate(self.optimizer.paths) if p in FROZEN_LEAVES]

        self.augment = MultiCropAugmentation(global_size=vit_cfg.input_resolution,
                                             local_size=config.local_size,
                                             n_local=config.n_local_crops)
        self.mask_gen = BlockMaskGenerator(vit_cfg.grid, config.mask_ratio_min,
                                           config.mask_ratio_max)
        self.host_rng = np.random.default_rng(config.seed + runtime.process_index)

        self.checkpointer = None
        self.start_step = 0
        if config.checkpoint_interval:
            from ..engine.checkpoint import TrainStateCheckpointer

            self.checkpointer = TrainStateCheckpointer(config.checkpoint_dir)
            restored = self.checkpointer.restore_latest(self._arrays())
            if restored is not None:
                self._restore(*restored)

    # -- checkpoint and resume -------------------------------------------------------
    def _arrays(self) -> Dict:
        opt = self.optimizer.state_dict()
        return to_numpy_tree({"student": self.student, "teacher": self.teacher,
                              "centers": self.centers,
                              "opt_state": {"mu": opt["mu"], "nu": opt["nu"]}}) \
            | {"opt_count": opt["count"]}

    @torch.no_grad()
    def _restore(self, arrays: Dict, aux: Dict) -> None:
        for name in ("student", "teacher", "centers"):
            for (_, t), (_, a) in zip(named_leaves(getattr(self, name)),
                                      named_leaves(arrays[name])):
                t.copy_(torch.from_numpy(np.asarray(a)))
        self.optimizer.load_state_dict({**arrays["opt_state"], "count": arrays["opt_count"]})
        self.start_step = aux["step"]
        self.host_rng.bit_generator.state = aux["host_rng_state"]

    # -- the step ----------------------------------------------------------------------
    def _drop_path_gen(self, step: int) -> Optional[torch.Generator]:
        """The step's stochastic-depth generator, seeded from (seed + 1,
        step) so that a resumed run draws the same masks."""
        if self.ssl_cfg.drop_path_rate <= 0.0:
            return None
        seed = int(np.random.SeedSequence([self.config.seed + 1, step]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, global_crops: torch.Tensor, local_crops: Optional[torch.Tensor],
                   patch_masks: torch.Tensor, step: int) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the device; returns the step's
        metrics (dino, ibot, koleo, total) as 0-d tensors."""
        total, (metrics, new_centers) = self.meta.forward_loss(
            self.student, self.teacher, self.centers, global_crops, local_crops, patch_masks,
            self.temp_schedule(step), gen=self._drop_path_gen(step))
        grads = list(torch.autograd.grad(total, self.leaves))
        hold = ()
        if step < self.config.get("freeze_last_layer_steps", 0):
            for i in self.frozen:
                grads[i] = torch.zeros_like(grads[i])
            hold = FROZEN_LEAVES
        self.optimizer.step(grads, hold)
        self.meta.ema_update(self.teacher, self.student, self.momentum_schedule(step))
        self.centers = {k: v.detach() for k, v in new_centers.items()}
        return {k: v.detach() for k, v in metrics.items()}

    # -- the host side -------------------------------------------------------------
    def _next_batch(self, batch_size: int):
        """Sample images, multi-crop augment them, draw the block masks."""
        n = len(self.dataset)
        idx = [next(self._sampler_iter) % n for _ in range(batch_size)]
        globals_, locals_ = [], []
        for i in idx:
            crops = self.augment(self.dataset[i], self.host_rng)
            globals_.append(crops["global"])
            locals_.append(crops["local"])
        g = np.stack([np.stack([s[c] for s in globals_]) for c in range(2)])
        loc = None
        if self.config.n_local_crops:
            loc = np.stack([np.stack([s[c] for s in locals_])
                            for c in range(self.config.n_local_crops)])
        masks = np.stack([self.mask_gen.batch_masks(batch_size, self.config.mask_sample_prob,
                                                    self.host_rng) for _ in range(2)])
        return g, loc, masks

    def _place(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if a is None else torch.from_numpy(a).to(self.device)

    def run(self) -> Dict[str, float]:
        cfg = self.config
        global_batch = cfg.batch_size * self.runtime.data_parallel
        if global_batch % self.runtime.num_processes:
            raise ValueError(f"global batch {global_batch} not divisible by"
                             f" {self.runtime.num_processes} processes")
        batch = global_batch // self.runtime.num_processes
        # on resume, the sampler skips the items the saved steps consumed
        self._sampler_iter = iter(ShardedInfiniteSampler(
            max(len(self.dataset), 1), seed=cfg.seed, shard_index=self.runtime.process_index,
            num_shards=self.runtime.num_processes, advance=self.start_step * batch))

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def producer():
            try:
                while not stop.is_set():
                    g, loc, masks = self._next_batch(batch)
                    item = (self._place(g), self._place(loc), self._place(masks),
                            self.host_rng.bit_generator.state)
                    while not stop.is_set():
                        try:
                            q.put(("ok", item), timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except Exception as e:
                q.put(("err", e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            return self._run_loop(q)
        finally:
            stop.set()
            while True:   # drain so a blocked put observes stop
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30.0)

    def _run_loop(self, q) -> Dict[str, float]:
        cfg = self.config
        last: Dict[str, float] = {}
        for step in range(self.start_step, cfg.max_steps):
            kind, item = q.get()
            if kind == "err":
                raise item
            # the host RNG's state right after this step's batch was made
            g, loc, masks, rng_state = item
            metrics = self.train_step(g, loc, masks, step)
            last = {k: float(v) for k, v in metrics.items()}
            if not np.isfinite(last["total"]):
                raise FloatingPointError(f"NaN/Inf loss at step {step}: {last}")
            if self.tracker is not None and step % 10 == 0:
                self.tracker.log({f"ssl/{k}": v for k, v in last.items()}, step=step)
            if self.checkpointer and (step + 1) % cfg.checkpoint_interval == 0:
                self.checkpointer.save(step + 1, self._arrays(),
                                       {"host_rng_state": rng_state})
            if step % 10 == 0:
                self.runtime.print(f"ssl step {step}: {last}")
        return last

