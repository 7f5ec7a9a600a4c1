"""Callback/event system + the stock callbacks (the port's copy of
dfd_clip_tpu/engine/callbacks.py).

Same event surface as the reference (src/trainer.py:88-96,
src/callbacks/{timer,metrics,tracking}.py): callbacks are plain functions
invoked with the agent (trainer/evaluator); ``add_callback`` stashes extra
kwargs as agent attributes; ``agent.event`` names the current event. The
profiler window runs ``torch.profiler`` (the card's kernels when one is
present) and writes a Chrome trace under the run directory.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict

import numpy as np

from ..utils import metrics as metrics_lib


class CallbackMixin:
    def _init_callbacks(self) -> None:
        self.callbacks: Dict[str, list] = defaultdict(list)
        self.event = ""

    def add_callback(self, onevent: str, callback: Callable, **kwargs: Any) -> None:
        self.callbacks[onevent].append(callback)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def trigger_callbacks(self, onevent: str) -> None:
        self.event = onevent
        for callback in self.callbacks.get(onevent, []):
            callback(self)


# -- timers (reference src/callbacks/timer.py) ---------------------------------

def start_timer(agent) -> None:
    for name in agent.timer:
        if name in agent.event:
            agent.timer[name] = time.time()


def end_timer(agent) -> None:
    for name in agent.timer:
        if name in agent.event:
            setattr(agent, f"{name}_duration", time.time() - agent.timer[name])


# -- metrics (reference src/callbacks/metrics.py) ------------------------------

def init_metrics(agent) -> None:
    agent.calcs = {
        cfg.name: {setup: metrics_lib.METRICS[setup]() for setup in cfg.types}
        for cfg in agent.config.metrics
    }
    agent.losses = {}


def update_metrics(agent) -> None:
    pred_labels = {n: np.argmax(np.asarray(l), axis=-1) for n, l in agent.batch_logits.items()}
    pred_probs = {n: _softmax_np(np.asarray(l)) for n, l in agent.batch_logits.items()}

    # batch_valid (evaluator ragged tails) rides THROUGH the gather: local
    # shard shapes must match across processes or the allgather deadlocks,
    # so padding rows are dropped after gathering, never before
    pred_labels, pred_probs, batch_labels, batch_losses, batch_valid = (
        agent.runtime.gather_for_metrics(
            (pred_labels, pred_probs, agent.batch_labels, agent.batch_losses,
             getattr(agent, "batch_valid", {}))
        )
    )

    if not agent.runtime.is_main_process:
        return

    def trim(name, arr):
        arr = np.asarray(arr)
        return arr[np.asarray(batch_valid[name])] if name in batch_valid else arr

    for name, labels in batch_labels.items():
        if name not in agent.calcs:
            continue
        for metric in agent.calcs[name].values():
            metric.add_batch(
                pred_labels=trim(name, pred_labels[name]),
                pred_probs=trim(name, pred_probs[name]),
                labels=trim(name, labels),
            )
    for name, loss in batch_losses.items():
        # a scalar loss (CompInv's recon / match, a train step's auxiliary
        # losses) is one value; the JAX package's len() refuses it
        vals = np.atleast_1d(trim(name, loss))
        if len(vals):
            agent.losses.setdefault(name, []).append(float(np.mean(vals)))


def compute_metrics(agent) -> None:
    if agent.steps % agent.training_eval_interval:
        return
    agent.compute_losses = {}
    agent.computed_metrics = {}

    for lname in getattr(agent, "calcs", {}):
        for mname, metric in agent.calcs[lname].items():
            try:
                agent.computed_metrics[f"metric/{lname}/{mname}"] = metric.compute()[mname]
            except (ValueError, IndexError):
                pass  # nothing accumulated for this task yet
    for lname in list(getattr(agent, "losses", {})):
        vals = agent.losses[lname]
        if vals:
            agent.compute_losses[f"loss/{lname}"] = sum(vals) / len(vals)
            vals.clear()

    agent.runtime.print({**agent.compute_losses, **agent.computed_metrics})

    if getattr(agent, "tracker", None) is not None:
        prefix = type(agent).__name__.lower()
        agent.tracker.log(
            {
                **{f"{prefix}/{k}".lower(): v for k, v in agent.compute_losses.items()},
                **{f"{prefix}/{k}".lower(): v for k, v in agent.computed_metrics.items()},
            },
            step=agent.steps,
        )


def _softmax_np(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


# -- profiling: a torch.profiler trace window ----------------------------------

def make_profiler_callbacks(trace_dir: str, start_step: int, end_step: int):
    """Trace steps [start_step, end_step) with torch.profiler (the host and,
    with a card, its kernels) into ``trace_dir``/trace_<start>_<end>.json, a
    Chrome trace. Register the returned fn on 'on_batch_start' AND
    'on_training_end' — the end-of-training hook flushes a trace whose
    window reaches the final step (no later batch ever starts, so the
    step-count check alone would lose the profile data)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    state = {"prof": None}

    def on_event(agent):
        step = getattr(agent, "steps", 0)
        ending = getattr(agent, "event", "") == "on_training_end"
        prof = state["prof"]
        if prof is not None and (step >= end_step or ending):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  f"trace_{start_step}_{end_step}.json"))
            state["prof"] = None
        elif prof is None and not ending and step == start_step:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            state["prof"] = profile(activities=activities)
            state["prof"].start()

    return on_event


# -- tracking (reference src/callbacks/tracking.py) -----------------------------

def update_trackers(agent) -> None:
    if agent.steps % agent.training_eval_interval:
        return
    if getattr(agent, "tracker", None) is not None and hasattr(agent, "current_lr"):
        agent.tracker.log({"lr": float(agent.current_lr())}, step=agent.steps)


def cache_best_model(agent) -> None:
    """Track best/last model snapshots by the main-metric regex
    (reference src/callbacks/tracking.py:24-41)."""
    target = [
        v for name, v in agent.computed_metrics.items() if re.search(agent.main_metric, name)
    ]
    if target:
        main_metric = sum(target) / max(len(target), 1)
        current_best = getattr(agent, "best_main_metric", main_metric)
        compare = max if agent.compare_fn == "max" else min
        if compare(main_metric, current_best) == main_metric:
            agent.runtime.print(
                f'best model updated with "{agent.main_metric}" of',
                main_metric,
                f"(past SOTA: {current_best})",
            )
            agent.best_main_metric = main_metric
            agent.best_model_state = agent.snapshot_model_state()
    agent.last_model_state = agent.snapshot_model_state()
