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

A CLIP text tree (its ``blocks`` stacked likewise -> a list) and a CLIP
ResNet tree (each convolution's ``w`` HWIO -> OIHW) convert too.

A CLIP encoder tree and a DINOv2 one (``conv1.b``, the blocks' LayerScale
``ls1``/``ls2``, ``mask_token`` and ``ln_post``, no ``ln_pre``) convert
alike, and so do the SSL trees (student / teacher with their ``backbone``
and heads, the centers): each dict holding ``conv1`` is an encoder.

The foundation converters read pretrained PyTorch checkpoints: OpenAI CLIP's
visual tower (plain state dicts, ``{"state_dict": ...}`` wrappers and
TorchScript archives), its ResNet tower and its text tower, Meta's DINOv2
state dicts, whose positional embedding is resized to the working grid by
the JAX package's antialiased bicubic (jax.image.resize), and the reference
Detector's decoder. Each gives the JAX package's numpy tree;
``params_from_jax`` then makes it the port's.
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


def clip_text_from_jax(tree: dict) -> dict:
    """A JAX clip_text tree -> the port's: the layer-stacked ``blocks``
    leaves (L, ...) -> a list of L per-layer dicts."""
    out = _to_torch({k: v for k, v in tree.items() if k != "blocks"})
    blocks = _to_torch(tree["blocks"])
    n_layers = len(next(iter(blocks["ln_1"].values())))
    out["blocks"] = [_unstack(blocks, i) for i in range(n_layers)]
    return out


def clip_resnet_from_jax(tree: Any) -> Any:
    """A JAX clip_resnet tree -> the port's: every convolution's ``w`` HWIO
    (k, k, I, O) -> OIHW (O, I, k, k), the layout ``F.conv2d`` reads."""
    if isinstance(tree, dict):
        if set(tree) == {"w"} and np.ndim(tree["w"]) == 4:
            return {"w": torch.from_numpy(np.ascontiguousarray(
                np.asarray(tree["w"]).transpose(3, 2, 0, 1)))}
        return {k: clip_resnet_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clip_resnet_from_jax(v) for v in tree]
    return _to_torch(tree)


def params_from_jax(tree: Any) -> Any:
    """JAX params (numpy leaves) -> the port's params (CPU tensors): every
    dict holding ``conv1`` (a Detector's ``encoder``, an SSL tree's
    ``backbone``, a bare backbone) through ``encoder_from_jax``, a CLIP text
    tree (``token_embedding``) through ``clip_text_from_jax``, a CLIP ResNet
    tree (``stem``) through ``clip_resnet_from_jax``, every other leaf as it
    is."""
    if "conv1" in tree:
        return encoder_from_jax(tree)
    if "token_embedding" in tree:
        return clip_text_from_jax(tree)
    if "stem" in tree:
        return clip_resnet_from_jax(tree)
    return {k: params_from_jax(v) if isinstance(v, dict) else _to_torch(v)
            for k, v in tree.items()}


def to_device(tree: Any, device) -> Any:
    """A copy of the port's params (any nesting of dicts and lists of
    tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


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


def load_adapter_checkpoint(path: str, template: Any) -> Any:
    """A CompInvEncoder run's adapter weights (the JAX package's pickled
    numpy tree, bare or under ``"adapter"``; src/models.py:472-478) as the
    port's adapter params, each leaf's shape checked against ``template``
    (``init_adapter``'s tree)."""
    state = load_params(path)
    if isinstance(state, dict) and "adapter" in state:
        state = state["adapter"]

    def check(got, want, where):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"adapter checkpoint: keys differ at {where or 'the root'}")
            for k in want:
                check(got[k], want[k], f"{where}.{k}")
        elif isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"adapter checkpoint: lengths differ at {where}")
            for i, (g, w) in enumerate(zip(got, want)):
                check(g, w, f"{where}[{i}]")
        elif tuple(np.shape(got)) != tuple(want.shape):
            raise ValueError(f"adapter shape mismatch at {where}: {np.shape(got)} vs "
                             f"{tuple(want.shape)}")

    check(state, template, "")
    return _to_torch(state)


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
    blocks = [_block(sd, f"{pre}transformer.resblocks.{i}") for i in range(cfg.layers)]
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


def _block(sd: Dict[str, np.ndarray], b: str) -> Params:
    """A CLIP residual block (``{b}.ln_1`` ... ``{b}.mlp.c_proj``)."""
    return {
        "ln_1": _ln(sd, f"{b}.ln_1"),
        "attn": {"in_proj": _qkv(sd, f"{b}.attn.in_proj_weight", f"{b}.attn.in_proj_bias"),
                 "out_proj": _lin(sd, f"{b}.attn.out_proj")},
        "ln_2": _ln(sd, f"{b}.ln_2"),
        "mlp": {"c_fc": _lin(sd, f"{b}.mlp.c_fc"), "c_proj": _lin(sd, f"{b}.mlp.c_proj")},
    }


def convert_clip_resnet(sd: Dict[str, np.ndarray]) -> Params:
    """OpenAI CLIP RN state dict (``visual.*`` or a bare ModifiedResNet) ->
    the JAX package's clip_resnet params (convolutions HWIO)."""
    pre = "visual." if any(k.startswith("visual.") for k in sd) else ""

    def conv(prefix: str) -> Params:
        return {"w": _hwio(sd[f"{prefix}.weight"])}

    def bnp(prefix: str) -> Params:
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}

    params: Params = {"stem": {f"{kind}{i}": (conv if kind == "conv" else bnp)(
        f"{pre}{kind}{i}") for i in (1, 2, 3) for kind in ("conv", "bn")}}
    for stage in range(1, 5):
        blocks = []
        while f"{pre}layer{stage}.{len(blocks)}.conv1.weight" in sd:
            base = f"{pre}layer{stage}.{len(blocks)}"
            blk = {f"{kind}{i}": (conv if kind == "conv" else bnp)(f"{base}.{kind}{i}")
                   for i in (1, 2, 3) for kind in ("conv", "bn")}
            # the downsample Sequential: "-1" avgpool (no params), "0" conv, "1" bn
            if f"{base}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": conv(f"{base}.downsample.0"),
                                     "bn": bnp(f"{base}.downsample.1")}
            blocks.append(blk)
        params[f"layer{stage}"] = blocks
    ap = f"{pre}attnpool"
    params["attnpool"] = {"positional_embedding": sd[f"{ap}.positional_embedding"],
                          **{k: _lin(sd, f"{ap}.{k}")
                             for k in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return params


def convert_clip_text(sd: Dict[str, np.ndarray]) -> Params:
    """OpenAI CLIP state dict (its text half) -> the JAX package's clip_text
    params (blocks layer-stacked)."""
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("transformer.resblocks."))
    return {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": _stack([_block(sd, f"transformer.resblocks.{i}") for i in range(n_layers)]),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
        "logit_scale": np.asarray(sd.get("logit_scale", np.float32(2.6592))),
    }


def convert_reference_decoder(sd: Dict[str, np.ndarray], cfg) -> Params:
    """The reference Detector's decoder state dict (its ``decoder.*`` keys,
    prefix stripped) -> the JAX package's decoder params; ``cfg`` a
    DecoderConfig:

    * the dual in_proj's columns are per-head [smax | coda] pairs there and
      [all smax | all coda], head-major, here: permuted;
    * ``transformer.augment_query_{i}`` (width,) stack to (blocks - 1, width);
    * ``proj{t}x{dim}[_L{layer}]`` become the nested task projection list."""
    w, h, d = cfg.width, cfg.heads, cfg.head_dim

    def dual_in_proj(prefix: str) -> Params:
        wt = sd[f"{prefix}.weight"].T.reshape(w, h, 2, d)
        bt = sd[f"{prefix}.bias"].reshape(h, 2, d)
        return {"w": np.concatenate([wt[:, :, 0].reshape(w, w), wt[:, :, 1].reshape(w, w)],
                                    axis=1),
                "b": np.concatenate([bt[:, 0].reshape(w), bt[:, 1].reshape(w)])}

    blocks = []
    for i in range(cfg.num_blocks):
        b = f"transformer.resblocks.{i}"
        blocks.append({
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "attn": {"in_proj": dual_in_proj(f"{b}.attn.in_proj"),
                     "out_proj": _lin(sd, f"{b}.attn.out_proj")},
            "ln_2": _ln(sd, f"{b}.ln_2"),
            "mlp": {"c_fc": _lin(sd, f"{b}.mlp.c_fc"), "c_proj": _lin(sd, f"{b}.mlp.c_proj")},
        })
    params: Params = {"class_embedding": sd["class_embedding"], "ln_pre": _ln(sd, "ln_pre"),
                      "ln_post": _ln(sd, "ln_post"), "blocks": blocks}
    if cfg.temporal_position:
        params["positional_embedding"] = sd["positional_embedding"]
    if cfg.aug_query:
        params["aug_query"] = np.stack([sd[f"transformer.augment_query_{i}"]
                                        for i in range(cfg.num_blocks - 1)])
    params["task_projections"] = [
        [sd[f"proj{t}x{dim}_L{layer}"] for layer in cfg.layer_indices]
        if cfg.global_prediction else [sd[f"proj{t}x{dim}"]]
        for t, dim in enumerate(cfg.out_dims)]
    return params


def infer_clip_resnet_config(sd: Dict[str, np.ndarray]):
    """The RN geometry of a CLIP state dict (the reference's build_model
    counts and widths)."""
    from .clip_resnet import ResNetConfig

    pre = "visual." if any(k.startswith("visual.") for k in sd) else ""
    layers = tuple(len({k.split(".")[2 if pre else 1] for k in sd
                        if k.startswith(f"{pre}layer{s}.")}) for s in (1, 2, 3, 4))
    width = sd[f"{pre}conv1.weight"].shape[0] * 2   # the stem's conv1 is width // 2
    spacial = int(round((sd[f"{pre}attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
    return ResNetConfig(layers=layers, width=width, heads=width * 32 // 64,
                        input_resolution=spacial * 32,
                        output_dim=sd[f"{pre}attnpool.c_proj.weight"].shape[0])


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


def load_clip_text(path: str) -> Params:
    """The JAX-layout clip_text params of a CLIP checkpoint's text half."""
    return convert_clip_text(_load_torch_state_dict(path))


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


def _resize_weights(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(in, out) f32 weights of jax.image.resize's bicubic along one axis
    (jax._src.image.scale.compute_weight_mat): antialiased (the converter's
    resize) the kernel is stretched by the scale when shrinking; without
    (dinov2_vit._pos_embed_for's) it is not."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = _keys_cubic(x / (max(inv_scale, 1.0) if antialias else 1.0))
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
