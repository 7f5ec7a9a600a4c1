"""Experiment tracking (the port's copy of dfd_clip_tpu/utils/tracking.py).

First-party JSONL tracker (``metrics.jsonl`` in the run directory, always
written) with optional wandb passthrough when the package imports and
tracking is enabled (reference main.py:311-315 semantics), in wandb's
offline mode: the port sends nothing over the network.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, project_dir: str, enabled: bool = False, project: str = ""):
        self.project_dir = project_dir
        self.enabled = enabled
        self.path = os.path.join(project_dir, "metrics.jsonl")
        self._wandb = None
        self.run_name: Optional[str] = None
        if enabled:
            try:
                import wandb  # type: ignore
            except ImportError:
                wandb = None
            if wandb is not None:
                # offline: the run is kept under ./wandb for `wandb sync`;
                # nothing is sent from the training process
                self._wandb = wandb
                wandb.init(project=project or "dfd-clip-tpu", mode="offline")
                self.run_name = wandb.run.name

    def log(self, values: Dict[str, Any], step: int) -> None:
        os.makedirs(self.project_dir, exist_ok=True)
        record = {"step": step, "time": time.time(), **values}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(values, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
