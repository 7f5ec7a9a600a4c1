"""Parameters carried across from the JAX package (counterpart of the
framework-native checkpoint half of dfd_clip_tpu/models/weights.py).

Checkpoints are pickled pure-numpy pytrees (``best_weights.pt`` /
``last_weights.pt``). ``params_from_jax`` turns such a tree -- or a JAX
``Detector.init_params`` tree converted to numpy -- into the port's params:

* ``encoder.conv1.w`` HWIO (p, p, 3, W) -> OIHW (W, 3, p, p);
* the encoder's layer-stacked ``blocks`` leaves (L, ...) -> a list of L
  per-layer dicts;
* every other leaf, linear ``w`` (in, out) included, keeps its layout.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch


def load_params(path: str) -> Any:
    """Read a framework-native checkpoint. Unpickling runs code: load only
    checkpoints this framework wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _to_torch(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def encoder_from_jax(enc: dict) -> dict:
    out = _to_torch({k: v for k, v in enc.items() if k != "blocks"})
    out["conv1"]["w"] = out["conv1"]["w"].permute(3, 2, 0, 1).contiguous()
    blocks = _to_torch(enc["blocks"])
    n_layers = len(next(iter(blocks["ln_1"].values())))
    out["blocks"] = [_unstack(blocks, i) for i in range(n_layers)]
    return out


def params_from_jax(tree: Any) -> Any:
    """JAX params (numpy leaves) -> the port's params (CPU tensors)."""
    if "conv1" in tree:
        return encoder_from_jax(tree)
    out = {k: _to_torch(v) for k, v in tree.items() if k != "encoder"}
    if "encoder" in tree:
        out["encoder"] = encoder_from_jax(tree["encoder"])
    return out


def to_numpy_tree(tree: Any) -> Any:
    """The port's params (tensors on any device) -> numpy leaves in the same
    nesting: for every non-encoder leaf the inverse of ``params_from_jax``.
    The arrays are copies, never views of the live parameters. bf16 leaves
    come back as float32 (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
