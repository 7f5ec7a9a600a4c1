"""Train-state checkpointing and resume (counterpart of
dfd_clip_tpu/engine/checkpoint.py, with its API: ``save``,
``restore_latest``, ``list_steps``, ``keep``).

The JAX package saves through Orbax; the port keeps its own format, a
directory ``step_<n>`` under the checkpoint directory holding two pickles:
``arrays.pkl``, a tree of numpy arrays (the trainer's trainable leaves, the
torch optimizer's ``state_dict`` with its tensors as arrays, the teacher,
the dropout generator's state), and ``aux.pkl``, small plain metadata (the
step, the teacher flag, the host numpy RNG's state). A save writes
``step_<n>.tmp`` and renames it, then keeps the newest ``keep`` steps.

Unpickling can run code, so ``restore_latest`` reads only what this
framework writes: its unpickler resolves numpy's array and dtype classes
and nothing else, and refuses every other global a pickle names.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
from typing import Any, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# the globals a numpy-array pickle names (numpy 1.x and 2.x module paths)
_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}


class _ArraysOnly(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED or (module == "numpy" and name.endswith("DType")) \
                or (module.startswith("numpy.dtypes") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint names {module}.{name}: only numpy arrays and "
                                     "plain Python values are read back")


def _load(path: str) -> Any:
    with open(path, "rb") as f:
        return _ArraysOnly(f).load()


def _check_template(got: Any, want: Any, where: str = "") -> None:
    """Raise unless ``got`` has ``want``'s nesting and leaf shapes (leaves of
    ``want`` that are None are not checked)."""
    if want is None:
        return
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint: keys differ at {where or 'the root'}")
        for k in want:
            _check_template(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint: lengths differ at {where}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_template(g, w, f"{where}[{i}]")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"checkpoint: shape {np.shape(got)} at {where}, expected "
                         f"{np.shape(want)}")


class TrainStateCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def list_steps(self):
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def save(self, step: int, arrays: Any, aux: dict) -> None:
        """arrays: a tree of numpy arrays (and plain values); aux: small
        plain metadata."""
        path = self._step_dir(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.pkl"), "wb") as f:
            pickle.dump(arrays, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(tmp, "aux.pkl"), "wb") as f:
            pickle.dump({**aux, "step": step}, f, protocol=pickle.HIGHEST_PROTOCOL)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        steps = self.list_steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore_latest(self, template: Any = None) -> Optional[Tuple[Any, dict]]:
        """(arrays, aux) of the newest step, or None without one. With
        ``template`` (a tree like the saved arrays), the restored tree's
        nesting and shapes are checked against it."""
        steps = self.list_steps()
        if not steps:
            return None
        path = self._step_dir(steps[-1])
        arrays = _load(os.path.join(path, "arrays.pkl"))
        aux = _load(os.path.join(path, "aux.pkl"))
        _check_template(arrays, template)
        logger.info("restored checkpoint at step %d from %s", aux["step"], path)
        return arrays, aux
