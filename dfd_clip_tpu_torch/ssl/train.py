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

On a multi-rank runtime (runtime.MeshRuntime) each rank draws its own
images (the sampler's shard), every leaf's gradient is the mean over the
ranks, the loss centers are averaged over them (the reference's
all-reduced batch center), and ``fsdp: 1`` is JAX's ``_shard_params``
(train.py:212-224): each student and teacher leaf whose leading axis the
data width divides is held as this rank's slice of that axis, and so are
its Adam moments. ``ops/spmd.py:data_gather`` all-gathers the whole leaf
where the step uses it, and its backward sums the gradient over the ranks
(an all-reduce, then this rank's slice: Gloo has no reduce-scatter to lean
on); every other leaf is replicated and its gradient all-reduced. The
clip's global norm adds the slices' squares over the ranks. Checkpoints
gather the leaves (``MeshRuntime.materialize``, which every rank calls) and
rank 0 writes them between barriers; on resume rank 0 restores its host
RNG state and the others re-derive theirs as (seed + rank) * 1_000_003 +
step (train.py:201-210). One rank: every leaf whole, as before, whatever
``fsdp`` says. Sinkhorn-Knopp centering and KoLeo span the global batch
(ssl/losses.py).
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
from ..models.weights import to_device
from ..ops.spmd import data_gather
from . import schedules as sched_lib
from .augmentations import MultiCropAugmentation
from .masking import BlockMaskGenerator
from .meta_arch import SSLConfig, SSLMetaArch
from .samplers import ShardedInfiniteSampler

# the prototype layers that the freeze window holds (both heads)
FROZEN_LEAVES = tuple((head, leaf) for head in ("dino_head", "ibot_head")
                      for leaf in ("last_v", "last_g"))


def _map2(fn, tree, flags):
    """``fn(leaf, flag)`` over a tree and a tree of flags beside it."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, flags[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, f) for v, f in zip(tree, flags)]
    return fn(tree, flags)


def _flags(tree, dp: int):
    """JAX's _shard_params rule: a leaf is sharded over the data axis when
    its leading axis is at least the data width and divisible by it."""
    if isinstance(tree, dict):
        return {k: _flags(v, dp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flags(v, dp) for v in tree]
    return tree.ndim >= 1 and tree.shape[0] >= dp and tree.shape[0] % dp == 0


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
        student, teacher, centers = params
        self.multi = runtime.num_processes > 1
        self.sharded = _flags(student, runtime.data_parallel) \
            if self.multi and config.get("fsdp", 0) else None
        if self.sharded is not None:   # this rank's slice of each sharded leaf
            student, teacher = (_map2(self._slice, t, self.sharded) for t in (student, teacher))
        self.student, self.teacher, self.centers = (to_device(t, self.device)
                                                    for t in (student, teacher, centers))
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

    # -- placement -------------------------------------------------------------------
    def _slice(self, t, sharded: bool):
        """This rank's rows of a whole leaf (tensor or array) when sharded,
        as a copy of its own: the whole leaf's storage is not kept alive."""
        if not sharded:
            return t
        part = t[self.runtime.rows(t.shape[0])]
        return part.clone() if torch.is_tensor(part) else part.copy()

    def _whole(self, tree, grad: bool = False):
        """``tree`` (student- or teacher-shaped) with every sharded leaf
        gathered whole; ``grad``: differentiably (``data_gather``)."""
        if self.sharded is None:
            return tree

        def one(t, sharded):
            if not sharded:
                return t
            if grad:
                return data_gather(t, self.runtime)
            return torch.cat(self.runtime.all_gather(t.detach().contiguous(), "data"))

        return _map2(one, tree, self.sharded)

    def teacher_whole(self) -> Dict:
        """The teacher with every leaf whole, as host tensors (copies). A
        collective on several ranks: every rank calls it."""
        whole = self.runtime.materialize(self.teacher, self.sharded)
        return _map2(lambda a, _: torch.from_numpy(a), whole, whole)

    # -- checkpoint and resume -------------------------------------------------------
    def _arrays(self) -> Dict:
        """The train state, every leaf whole, as numpy (a collective on
        several ranks: every rank calls it)."""
        rt, opt = self.runtime, self.optimizer.state_dict()
        flat = [f for _, f in named_leaves(self.sharded)] if self.sharded is not None else None
        return {"student": rt.materialize(self.student, self.sharded),
                "teacher": rt.materialize(self.teacher, self.sharded),
                "centers": rt.materialize(self.centers),
                "opt_state": {m: rt.materialize(opt[m], flat) for m in ("mu", "nu")},
                "opt_count": opt["count"]}

    @torch.no_grad()
    def _restore(self, arrays: Dict, aux: Dict) -> None:
        for name in ("student", "teacher", "centers"):
            whole = arrays[name]
            if name != "centers" and self.sharded is not None:
                whole = _map2(self._slice, whole, self.sharded)
            for (_, t), (_, a) in zip(named_leaves(getattr(self, name)), named_leaves(whole)):
                t.copy_(torch.from_numpy(np.asarray(a)))
        opt_state = arrays["opt_state"]
        if self.sharded is not None:
            flat = [f for _, f in named_leaves(self.sharded)]
            opt_state = {m: [self._slice(np.asarray(a), f) for a, f in zip(opt_state[m], flat)]
                         for m in ("mu", "nu")}
        self.optimizer.load_state_dict({**opt_state, "count": arrays["opt_count"]})
        self.start_step = aux["step"]
        rt = self.runtime
        if rt.is_main_process:
            self.host_rng.bit_generator.state = aux["host_rng_state"]
        else:   # only rank 0's stream is saved: the others re-derive theirs
            self.host_rng = np.random.default_rng(
                (self.config.seed + rt.process_index) * 1_000_003 + self.start_step)

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
        with torch.no_grad():
            teacher = self._whole(self.teacher)
        total, (metrics, new_centers) = self.meta.forward_loss(
            self._whole(self.student, grad=True), teacher, self.centers, global_crops,
            local_crops, patch_masks, self.temp_schedule(step), gen=self._drop_path_gen(step))
        del teacher
        grads = list(torch.autograd.grad(total, self.leaves))
        hold = ()
        if step < self.config.get("freeze_last_layer_steps", 0):
            for i in self.frozen:
                grads[i] = torch.zeros_like(grads[i])
            hold = FROZEN_LEAVES
        norm = self._mean_over_ranks(grads) if self.multi else None
        self.optimizer.step(grads, hold, norm=norm)
        self.meta.ema_update(self.teacher, self.student, self.momentum_schedule(step))
        self.centers = {k: v.detach() for k, v in new_centers.items()}
        if self.multi:
            for v in self.centers.values():   # the ranks' batch centers, averaged
                self.runtime.all_reduce_(v, "sum").div_(self.runtime.num_processes)
        return {k: v.detach() for k, v in metrics.items()}

    def _mean_over_ranks(self, grads) -> torch.Tensor:
        """Each gradient (in place) as its mean over the ranks: a sharded
        leaf's slice was summed by ``data_gather``, the replicated ones are
        summed here in one packed all-reduce. Returns the global norm of
        the mean gradient (the slices' squares summed over the ranks), or
        None when no leaf is sharded."""
        rt = self.runtime
        flags = ([f for _, f in named_leaves(self.sharded)] if self.sharded is not None
                 else [False] * len(grads))
        rep = [g for g, f in zip(grads, flags) if not f]
        if rep:
            packed = rt.all_reduce_(torch.cat([g.reshape(-1) for g in rep]), "sum")
            offset = 0
            for g in rep:
                g.copy_(packed[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        torch._foreach_div_(grads, float(rt.num_processes))
        if not any(flags):
            return None   # whole gradients: the optimizer's own norm
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        flags_t = torch.tensor(flags, device=sq.device)
        shard_sq = rt.all_reduce_(sq[flags_t].sum().reshape(1), "sum", "data")
        return torch.sqrt(shard_sq[0] + sq[~flags_t].sum())

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
                arrays = self._arrays()   # every rank gathers, rank 0 writes
                self.runtime.barrier("checkpoint start")
                if self.runtime.is_main_process:
                    self.checkpointer.save(step + 1, arrays, {"host_rng_state": rng_state})
                self.runtime.barrier("checkpoint end")
            if step % 10 == 0:
                self.runtime.print(f"ssl step {step}: {last}")
        return last

