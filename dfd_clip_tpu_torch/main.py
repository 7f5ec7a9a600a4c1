"""Training CLI (counterpart of the repository's main.py).

    python -m dfd_clip_tpu_torch.main --cfg configs/deepfake/deepfake.yaml
        [--debug] [--test] [--device cuda|cpu]
        [--video_backend auto|native|opencv|synthetic]

Reads the JAX package's YAML schema (class-name reflection for the model,
trainer, evaluator and datasets: root main.py's ten classes, so the
deepfake, CompInv adapter pretraining and cross-task recipes of
``configs/`` all run), makes the run directory where the JAX
CLI makes it (the repository root joined with ``tracking.directory``, an
absolute directory as it is; ``<prefix>_<n>`` without a project name, else
``<project>/<MMDDTHHMM>``), writes ``setting.yaml`` there, builds the
Detector (with the foundation's checkpoint from ``misc/`` when there is
one, else a random draw and a warning: nothing is downloaded) or the
CompInvEncoder, the training and evaluation datasets, the trainer and the
evaluator the YAML names, registers the callbacks, and trains. The run directory then holds ``setting.yaml``,
``best_weights.pt`` and ``last_weights.pt`` (the JAX layout, which this
package's and the JAX package's inference.main both read, with
``tracking.enabled``), ``metrics.jsonl``, per-rank logs, ``checkpoints/``
with ``trainer.checkpoint_interval`` and ``profile/`` with
``system.profile_steps``. ``main`` returns the run directory.

The runtime is ``runtime.MeshRuntime`` over ``torch.distributed``: launched
by torchrun (``torchrun --nproc_per_node N -m dfd_clip_tpu_torch.main
--cfg ...``) or under SLURM it runs one rank a card, ``cuda:<LOCAL_RANK>``,
on NCCL (Gloo with ``--device cpu``), laid out (data, seq) by
``system.seq_parallel``; launched alone it is one process, as before. The
run directory's name comes from rank 0 (``broadcast_str``), which alone
writes setting.yaml. The run goes on the card unless ``--device cpu`` is
given; without a card it raises. The completion notice (utils/notify.py)
goes nowhere: its credentials are arguments, and the port reads none from
the environment.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import warnings
from datetime import datetime, timedelta
from pathlib import Path

import torch

from .config import CN
from .data import CDF, DFDC, FFPP, RPPG
from .data.video import backend_name
from .device import resolve_device
from .engine.callbacks import (cache_best_model, compute_metrics, end_timer, init_metrics,
                               start_timer, update_metrics, update_trackers)
from .engine.evaluator import CompInvEvaluator, Evaluator
from .engine.trainer import CompInvTrainer, Trainer
from .inference import load_pretrained_encoder
from .models import weights as weights_lib
from .models.adapter import CompInvEncoder
from .models.detector import Detector
from .runtime import MeshRuntime, launch
from .utils.notify import send_to_telegram
from .utils.tracking import Tracker

REPO_ROOT = Path(__file__).resolve().parents[1]
PROJECT_DIR = None

# class-name reflection registry (the reference's globals(); main.py:71-97)
REGISTRY = {
    "Detector": Detector,
    "CompInvEncoder": CompInvEncoder,
    "Trainer": Trainer,
    "CompInvTrainer": CompInvTrainer,
    "Evaluator": Evaluator,
    "CompInvEvaluator": CompInvEvaluator,
    "FFPP": FFPP,
    "CDF": CDF,
    "DFDC": DFDC,
    "RPPG": RPPG,
}


def _registered(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(f"{name} is not a registered class (the port's main takes "
                                  f"{', '.join(REGISTRY)})")
    return REGISTRY[name]


def get_config(params):
    C = CN()

    # system
    C.system = CN()
    C.system.mixed_precision = "bf16"  # no | bf16 (fp16 maps to bf16)
    C.system.seed = 0
    C.system.deterministic_training = False
    C.system.training_eval_interval = 10
    C.system.evaluation_interval = 10
    C.system.seq_parallel = 1
    C.system.profile_steps = []  # [start, end) torch.profiler trace window

    # tracking
    C.tracking = CN()
    C.tracking.enabled = False
    C.tracking.directory = "logs"
    C.tracking.project_name = None
    C.tracking.default_project_prefix = "version"
    C.tracking.tool = "wandb"
    C.tracking.main_metric = "deepfake/ffpp/roc_auc"
    C.tracking.compare_fn = "max"

    C.model = CN(new_allowed=True)
    C.trainer = CN(new_allowed=True)
    C.evaluator = CN(new_allowed=True)

    C.data = CN()
    C.data.num_frames = 50
    C.data.clip_duration = 10
    C.data.train = []
    C.data.eval = []

    if params.cfg is not None:
        if not os.path.isfile(params.cfg):
            raise SystemExit(f"config file not found: {params.cfg}")
        C.merge_from_file(params.cfg)
        C.model = _registered(C.model.name).get_default_config().merge_from_other_cfg(C.model)
        C.trainer = _registered(C.trainer.name).get_default_config().merge_from_other_cfg(
            C.trainer)
        C.evaluator = _registered(C.evaluator.name).get_default_config().merge_from_other_cfg(
            C.evaluator)
        C.data.train = [_registered(d.name).get_default_config().merge_from_other_cfg(d)
                        for d in C.data.train]
        C.data.eval = [_registered(d.name).get_default_config().merge_from_other_cfg(d)
                       for d in C.data.eval]

    if params.test:
        C.tracking.directory = "logs"
        C.tracking.project_name = "test"

    for d_eval in C.data.eval:
        if "name" not in d_eval:
            raise ValueError("every data.eval entry needs a name")
    return C


def register_trainer_callbacks(config, trainer, **kwargs):
    def evaluation_proxy(trainer):
        if trainer.steps % trainer.evaluation_interval:
            return
        kwargs["evaluator"].run(trainer)

    def save_model(trainer):
        evaluator = kwargs["evaluator"]
        if getattr(evaluator, "best_model_state", None):
            weights_lib.save_params(os.path.join(PROJECT_DIR, "best_weights.pt"),
                                    evaluator.best_model_state)
        # always the final weights, even when no evaluation ran
        last = getattr(evaluator, "last_model_state", None) or trainer.snapshot_model_state()
        weights_lib.save_params(os.path.join(PROJECT_DIR, "last_weights.pt"), last)
        if not getattr(evaluator, "best_model_state", None):
            weights_lib.save_params(os.path.join(PROJECT_DIR, "best_weights.pt"), last)

    timer_events = ["training", "epoch", "batch"]
    trainer.add_callback("on_training_start", lambda _: None,
                         timer={evt: 0 for evt in timer_events})
    for event in timer_events:
        trainer.add_callback(f"on_{event}_start", start_timer)
        trainer.add_callback(f"on_{event}_end", end_timer)

    trainer.add_callback("on_batch_end", update_metrics)
    if trainer.runtime.is_main_process:
        trainer.add_callback("on_training_start", init_metrics)
        trainer.add_callback("on_batch_end", compute_metrics,
                             training_eval_interval=config.system.training_eval_interval)

    if config.tracking.enabled and trainer.runtime.is_main_process:
        trainer.add_callback("on_batch_end", update_trackers)
        trainer.add_callback("on_training_end", save_model)

    trainer.add_callback(
        "on_batch_end",
        lambda t: t.runtime.print(f"{t.steps} | loss {t.batch_loss_info}, "
                                  f"{t.batch_duration:.2f}s"))
    trainer.add_callback(
        "on_training_end",
        lambda t: t.runtime.print(
            f"training completed in {timedelta(seconds=t.training_duration)}"))

    trainer.add_callback("on_batch_end", evaluation_proxy,
                         evaluation_interval=config.system.evaluation_interval)


def register_evaluator_callbacks(config, evaluator, **kwargs):
    def clear_current_main_metrics(evaluator):
        evaluator.current_main_metrics = []

    timer_events = ["evaluation", "dataloader"]
    evaluator.add_callback("on_evaluation_start", lambda _: None,
                           timer={evt: 0 for evt in timer_events})
    evaluator.add_callback("on_evaluation_start",
                           lambda e: e.runtime.print("evaluation start"))
    for event in timer_events:
        evaluator.add_callback(f"on_{event}_start", start_timer)
        evaluator.add_callback(f"on_{event}_end", end_timer)

    evaluator.add_callback("on_batch_end", update_metrics)
    if evaluator.runtime.is_main_process:
        evaluator.add_callback("on_evaluation_start", init_metrics)
        evaluator.add_callback("on_evaluation_end", compute_metrics, training_eval_interval=1)

    if config.tracking.enabled and evaluator.runtime.is_main_process:
        evaluator.add_callback("on_evaluation_end", update_trackers)
        evaluator.add_callback("on_evaluation_start", clear_current_main_metrics,
                               main_metric=config.tracking.main_metric,
                               compare_fn=config.tracking.compare_fn,
                               current_main_metrics=[])
        evaluator.add_callback("on_evaluation_end", cache_best_model,
                               best_model_state=None, last_model_state=None)

    evaluator.add_callback(
        "on_batch_end",
        lambda e: e.runtime.print(f"{e.steps}.{e.batch_num} | loss {e.batch_loss_info}"))
    evaluator.add_callback(
        "on_evaluation_end",
        lambda e: e.runtime.print(f"evaluation completed in {e.evaluation_duration:.2f}"))


def resolve_compute_dtype(mixed_precision: str) -> torch.dtype:
    if mixed_precision in ("bf16", "fp16"):
        return torch.bfloat16
    return torch.float32


def init_runtime(config, device="cuda"):
    """The runtime on ``device`` (the launcher's process group started
    first, when there is one: NCCL for cards, Gloo for the CPU), the run
    directory (made, setting.yaml written), logging into it and the run's
    Tracker."""
    global PROJECT_DIR
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    launch.initialize(backend)
    runtime = MeshRuntime(seq_parallel=config.system.seq_parallel, device=device,
                          backend=backend)

    project_name = config.tracking.default_project_prefix
    tracking_root = os.path.join(REPO_ROOT, config.tracking.directory)
    if config.tracking.project_name is None:
        version = 0
        while os.path.isdir(os.path.join(tracking_root, f"{project_name}_{version}")):
            version += 1
        project_name = f"{project_name}_{version}"
        PROJECT_DIR = os.path.join(tracking_root, project_name)
    else:
        project_name = re.sub("/", "_", config.tracking.project_name)
        PROJECT_DIR = os.path.join(tracking_root, project_name,
                                   datetime.now().strftime("%m%dT%H%M"))
    PROJECT_DIR = runtime.broadcast_str(PROJECT_DIR)
    project_name = runtime.broadcast_str(project_name)

    os.makedirs(PROJECT_DIR, exist_ok=True)
    if runtime.is_main_process:
        with open(os.path.join(PROJECT_DIR, "setting.yaml"), "w") as f:
            f.write(config.dump())

    from .utils.logging import setup_logging

    setup_logging(PROJECT_DIR, rank=runtime.process_index)
    tracker = Tracker(PROJECT_DIR, enabled=config.tracking.enabled, project=project_name)
    return runtime, tracker


def category_index_map(train_cfgs) -> dict:
    """Task index = FIRST-APPEARANCE order of categories in data.train, the
    order the YAML's losses / out_dim encode (the reference's
    ``enumerate(set(...))`` is hash-ordered; first appearance is the
    intent)."""
    return {cat: i for i, cat in enumerate(dict.fromkeys(cfg.category for cfg in train_cfgs))}


def main(params):
    global PROJECT_DIR
    device = resolve_device(launch.local_device(getattr(params, "device", "cuda")))
    backend = getattr(params, "video_backend", "auto")
    config = get_config(params)
    runtime, tracker = init_runtime(config, device)
    runtime.print(config.dump())
    runtime.print(f"Video files decode through {backend_name(backend)}")

    model = _registered(config.model.name)(
        config.model, num_frames=config.data.num_frames,
        compute_dtype=resolve_compute_dtype(config.system.mixed_precision), device=device)
    load_pretrained_encoder(model, config)

    category_index = category_index_map(config.data.train)
    runtime.print("Task Indices:")
    for k, v in category_index.items():
        runtime.print(f"\t- {k} => {v}")

    train_datasets = [
        _registered(cfg.name)(cfg, config.data.num_frames, config.data.clip_duration,
                              runtime=runtime, split="train", index=category_index[cfg.category],
                              seed=config.system.seed, video_backend=backend)
        for cfg in config.data.train
    ]
    for ds in train_datasets:
        runtime.print(f"Training Dataset {type(ds).__name__.upper()} initialized with "
                      f"{len(ds)} samples\n")
    eval_datasets = [
        _registered(cfg.name)(cfg, config.data.num_frames, config.data.clip_duration,
                              runtime=runtime, split="val",
                              index=category_index.get(cfg.category, 0),
                              seed=config.system.seed, video_backend=backend)
        for cfg in config.data.eval
    ]
    for ds in eval_datasets:
        runtime.print(f"Evaluation Dataset {type(ds).__name__.upper()} initialized with "
                      f"{len(ds)} samples\n")

    if config.trainer.get("checkpoint_interval", 0) and not config.trainer.get("checkpoint_dir",
                                                                               ""):
        config.trainer.checkpoint_dir = os.path.join(PROJECT_DIR, "checkpoints")
    trainer = _registered(config.trainer.name)(config.trainer, runtime, model, train_datasets,
                                               tracker=tracker, seed=config.system.seed)
    evaluator = _registered(config.evaluator.name)(config.evaluator, runtime, eval_datasets,
                                                   tracker=tracker)
    register_trainer_callbacks(config, trainer, evaluator=evaluator)
    register_evaluator_callbacks(config, evaluator)

    if config.system.profile_steps:
        from .engine.callbacks import make_profiler_callbacks

        start, end = config.system.profile_steps
        profile_cb = make_profiler_callbacks(os.path.join(PROJECT_DIR, "profile"), start, end)
        trainer.add_callback("on_batch_start", profile_cb)
        trainer.add_callback("on_training_end", profile_cb)   # a window reaching the end

    trainer.run()

    if config.tracking.enabled:
        tracker.finish()
        # the run directory takes the wandb run's name, as the reference's
        # does (main.py:272-277), when wandb ran
        if tracker.run_name and trainer.runtime.is_main_process:
            wandb_dir = os.path.join(os.path.dirname(PROJECT_DIR), tracker.run_name)
            if not os.path.exists(wandb_dir):
                logging.info("Rename directory: %s -> %s", PROJECT_DIR, wandb_dir)
                os.rename(PROJECT_DIR, wandb_dir)
                PROJECT_DIR = wandb_dir
        # a no-op here: the port reads no credentials from the environment
        send_to_telegram(f"Training Completed, Result Location: {PROJECT_DIR}")
    return PROJECT_DIR


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Deepfake detector with foundation models (PyTorch/CUDA port).")
    parser.add_argument("--cfg", type=str, default=None, help="YAML configuration file")
    parser.add_argument("--debug", action="store_true", help="Debugging Mode")
    parser.add_argument("--test", action="store_true", help="Testing Mode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default: raises without a card) or cpu")
    parser.add_argument("--video_backend", type=str, default="auto",
                        choices=("auto", "native", "opencv", "synthetic"))
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    if not args.debug:
        logging.basicConfig(level="INFO")
        warnings.filterwarnings(action="ignore")
    else:
        logging.basicConfig(level="DEBUG")
    main(args)
