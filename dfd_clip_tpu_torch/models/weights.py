"""Checkpoints and pretrained weights (counterpart of
dfd_clip_tpu/models/weights.py).

Checkpoints are pickled pure-numpy pytrees in the JAX package's layout
(``best_weights.pt`` / ``last_weights.pt``), so either package reads what
the other writes. ``params_from_jax`` turns such a tree -- or a JAX
``Detector.init_params`` tree converted to numpy -- into the port's params,
``params_to_jax`` is its inverse, and ``save_params`` pickles the port's
params in the JAX layout:

* ``encoder.conv1.w`` HWIO (p, p, 3, W) -> OIHW (W, 3, p, p);
* the encoder's layer-stacked ``blocks`` leaves (L, ...) -> a list of L
  per-layer dicts;
* every other leaf, linear ``w`` (in, out) included, keeps its layout.

A CLIP encoder tree and a DINOv2 one (``conv1.b``, the blocks' LayerScale
``ls1``/``ls2``, ``mask_token`` and ``ln_post``, no ``ln_pre``) convert
alike.

The foundation converters read pretrained PyTorch checkpoints: OpenAI CLIP's
visual tower (plain state dicts, ``{"state_dict": ...}`` wrappers and
TorchScript archives) and Meta's DINOv2 state dicts, whose positional
embedding is resized to the working grid by the JAX package's
antialiased bicubic (jax.image.resize). Each gives the JAX package's numpy
tree; ``params_from_jax`` then makes it the port's encoder.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

from .clip_vit import ViTConfig

Params = Dict[str, Any]


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


def encoder_to_jax(enc: dict) -> dict:
    """The port's encoder -> the JAX package's numpy layout: ``conv1.w``
    OIHW -> HWIO and the per-layer ``blocks`` list stacked to (L, ...)."""
    out = to_numpy_tree({k: v for k, v in enc.items() if k != "blocks"})
    out["conv1"]["w"] = np.ascontiguousarray(out["conv1"]["w"].transpose(2, 3, 1, 0))
    out["blocks"] = _stack(to_numpy_tree(enc["blocks"]))
    return out


def _stack(blocks: list) -> Any:
    """Per-layer trees -> one tree of (L, ...) arrays."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def params_to_jax(tree: Any) -> Any:
    """The port's params, or any nesting of them (a checkpoint's
    ``{"trainable": ..., "steps": n}``), -> numpy leaves in the JAX
    package's layout: each encoder (a dict holding ``conv1``) through
    ``encoder_to_jax``, every other tensor as ``to_numpy_tree`` gives it,
    other leaves as they are. The inverse of ``params_from_jax``."""
    if isinstance(tree, dict):
        if "conv1" in tree:
            return encoder_to_jax(tree)
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return to_numpy_tree(tree) if torch.is_tensor(tree) else tree


def save_params(path: str, tree: Any) -> None:
    """Pickle ``params_to_jax(tree)``: a checkpoint the JAX package's
    ``load_params`` (and ``inference.load_model_params``) reads."""
    with open(path, "wb") as f:
        pickle.dump(params_to_jax(tree), f, protocol=pickle.HIGHEST_PROTOCOL)


# -- pretrained PyTorch checkpoints (the JAX package's numpy layout) -------------

def _load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint as numpy f32 arrays: plain state dicts, wrapped
    ``{"state_dict": ...}`` checkpoints and TorchScript archives (the format
    OpenAI ships CLIP in)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.detach().float().numpy() for k, v in obj.items() if hasattr(v, "numpy")}


def _lin(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    """torch Linear (out, in) -> (in, out)."""
    p: Params = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _qkv(sd: Dict[str, np.ndarray], weight: str, bias: str) -> Params:
    return {"w": np.ascontiguousarray(sd[weight].T), "b": sd[bias]}


def _hwio(w: np.ndarray) -> np.ndarray:
    """torch conv OIHW -> HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def convert_clip_visual(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> Params:
    """OpenAI CLIP state dict (``visual.*`` or bare) -> the JAX package's
    clip_vit params."""
    pre = "visual." if any(k.startswith("visual.") for k in sd) else ""
    blocks = []
    for i in range(cfg.layers):
        b = f"{pre}transformer.resblocks.{i}"
        blocks.append({
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "attn": {"in_proj": _qkv(sd, f"{b}.attn.in_proj_weight", f"{b}.attn.in_proj_bias"),
                     "out_proj": _lin(sd, f"{b}.attn.out_proj")},
            "ln_2": _ln(sd, f"{b}.ln_2"),
            "mlp": {"c_fc": _lin(sd, f"{b}.mlp.c_fc"), "c_proj": _lin(sd, f"{b}.mlp.c_proj")},
        })
    params: Params = {
        "conv1": {"w": _hwio(sd[f"{pre}conv1.weight"])},
        "class_embedding": sd[f"{pre}class_embedding"],
        "positional_embedding": sd[f"{pre}positional_embedding"],
        "ln_pre": _ln(sd, f"{pre}ln_pre"),
        "blocks": _stack(blocks),
    }
    # the pooled zero-shot head: the K/V export never reads it
    if f"{pre}ln_post.weight" in sd:
        params["ln_post"] = _ln(sd, f"{pre}ln_post")
    if f"{pre}proj" in sd:
        params["proj"] = sd[f"{pre}proj"]
    return params


def infer_clip_vit_config(sd: Dict[str, np.ndarray]) -> ViTConfig:
    """The tower's geometry from a CLIP state dict (head_dim 64)."""
    pre = "visual." if any(k.startswith("visual.") for k in sd) else ""
    width, _, patch, _ = sd[f"{pre}conv1.weight"].shape
    n_layers = len({k.split(".")[3 if pre else 2] for k in sd
                    if f"{pre}transformer.resblocks" in k})
    grid = int(round((sd[f"{pre}positional_embedding"].shape[0] - 1) ** 0.5))
    return ViTConfig(input_resolution=grid * patch, patch_size=patch, width=width,
                     layers=n_layers, heads=width // 64,
                     output_dim=sd[f"{pre}proj"].shape[1] if f"{pre}proj" in sd else width)


def load_clip_visual(path: str) -> tuple:
    """(JAX-layout params, ViTConfig) of a CLIP checkpoint's visual tower."""
    sd = _load_torch_state_dict(path)
    cfg = infer_clip_vit_config(sd)
    return convert_clip_visual(sd, cfg), cfg


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel (a = -0.5), jax.image's bicubic."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of jax.image.resize's antialiased bicubic along
    one axis (jax._src.image.scale.compute_weight_mat): the kernel is
    stretched by the scale when shrinking."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = _keys_cubic(x / max(inv_scale, 1.0))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _interpolate_pos_embed(pos: np.ndarray, target_grid: int) -> np.ndarray:
    """(1 + S^2, w) -> (1 + g^2, w): the spatial part resized bicubically."""
    n_tok, w = pos.shape
    src_grid = int(round((n_tok - 1) ** 0.5))
    if src_grid == target_grid:
        return pos
    grid = pos[1:].reshape(src_grid, src_grid, w).astype(np.float32)
    wts = _resize_weights(src_grid, target_grid)
    grid = np.einsum("ijc,ia,jb->abc", grid, wts, wts)
    return np.concatenate([pos[:1], grid.reshape(-1, w)], axis=0)


def convert_dinov2(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> Params:
    """DINOv2 pretrain state dict -> the JAX package's dinov2_vit params, the
    positional embedding resized to ``cfg``'s grid."""
    blocks = []
    for i in range(cfg.layers):
        b = f"blocks.{i}"
        if f"{b}.mlp.w12.weight" in sd:   # fused-SwiGLU checkpoints (giant2)
            mlp = {"w12": _lin(sd, f"{b}.mlp.w12"), "w3": _lin(sd, f"{b}.mlp.w3")}
        else:
            mlp = {"c_fc": _lin(sd, f"{b}.mlp.fc1"), "c_proj": _lin(sd, f"{b}.mlp.fc2")}
        blocks.append({
            "ln_1": _ln(sd, f"{b}.norm1"),
            "attn": {"in_proj": _qkv(sd, f"{b}.attn.qkv.weight", f"{b}.attn.qkv.bias"),
                     "out_proj": _lin(sd, f"{b}.attn.proj")},
            "ls1": sd[f"{b}.ls1.gamma"],
            "ln_2": _ln(sd, f"{b}.norm2"),
            "mlp": mlp,
            "ls2": sd[f"{b}.ls2.gamma"],
        })
    pos = sd["pos_embed"]
    return {
        "conv1": {"w": _hwio(sd["patch_embed.proj.weight"]), "b": sd["patch_embed.proj.bias"]},
        "class_embedding": sd["cls_token"].reshape(-1),
        "mask_token": (sd["mask_token"].reshape(-1) if "mask_token" in sd
                       else np.zeros((cfg.width,), np.float32)),
        "positional_embedding": _interpolate_pos_embed(pos.reshape(pos.shape[-2], -1),
                                                       cfg.grid),
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "norm"),
    }


def load_dinov2(path: str, cfg: ViTConfig) -> Params:
    return convert_dinov2(_load_torch_state_dict(path), cfg)
