"""The encoder-analysis CLIs (the port of tools/analysis.py), with the same
subcommands, arguments and pickle layouts:

  kv-dist          per-layer q/k/v/out temporal-variance heatmaps and
                   patch-similarity (cosine-attention) ribbons for one clip;
  semantic-patches mean q/k/v/out embeddings at named face regions over N
                   random clips -> misc/semantic_patches.pickle;
  augment-impact   per-layer per-patch KL divergence between two draws of
                   one clip (a named augmentation), a c23/raw pair
                   ("compression") or two clips ("any"), averaged over N
                   samples -> misc/<setting>.pickle;
  comb-impact      the impact pickles min-max normalised per layer,
                   weighted and combined (optionally in the reference's
                   complement form), each map renormalised to sum 1 ->
                   misc/guide_map.pickle, the prior the Detector's
                   patch_mask type "guide" reads. A combined map whose
                   sum is not a positive number is refused: it has no
                   such prior (a named augmentation's maps are all 0, as
                   its two draws of one index are equal).

    python -m dfd_clip_tpu_torch.tools.analysis kv-dist --root data/ffpp \\
        --video 193_030 --patch-loc 1,7 --out-dir analysis/ [--device cpu]

The tower is the frozen CLIP encoder: misc/<arch>.pt under the working
directory when present (weights.load_clip_visual), else a random init
seeded 0 (not the JAX package's draws; the maps are then structurally valid
and semantically meaningless). Its forward (``export_qkv_out``) is one
loop of the ViT's composition block (``clip_vit.block_qkv`` and
``block_tail``: LN1, the packed in-projection, the encoder attention, the
out-projection, LN2 and the MLP), exporting q, k and v (the
in-projection's column blocks) and the block output, CLS dropped. ``--device`` (default
``cuda``, which raises without a card) places it: on the card it runs in
bf16, the attention through the packed encoder attention kernel
(csrc/encoder_attention.cu) and the LayerNorms through the row kernel; on
the CPU in f32 through their plain versions. matplotlib is imported only
for ``--figures``.

A sample whose clip cannot be decoded is resampled, as the JAX tool does,
and so is augment-impact's sample of a clip without the compression it
compares: only the video backends' decode failures
(data.video.DECODE_ERRORS) and that missing member are caught, around the
dataset read alone.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import sys
from os import makedirs, path
from typing import Dict, Sequence

import numpy as np
import torch

from ..data.video import DECODE_ERRORS, backend_name
from ..models import clip_vit

logger = logging.getLogger("analysis")

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# 14x14-grid face-region patch coordinates (row, col), the reference's
# kv-distribution-visualize notebook (aligned-crop geometry)
SEMANTIC_LOCATIONS = {
    "eyes": [[4, 3], [4, 4], [4, 9], [4, 10]],
    "nose": [[7, 6], [6, 6], [5, 6]],
    "lips": [[10, 5], [10, 6], [10, 7]],
    "eyebrows": [[2, 3], [2, 4], [3, 4], [3, 5], [3, 8], [3, 9], [2, 9], [2, 10]],
    "skin": [[0, 6], [0, 7], [1, 6], [1, 7], [7, 3], [7, 4], [7, 10], [7, 11],
             [11, 6], [11, 7], [12, 6], [12, 7]],
}

SUBJECTS = ("q", "k", "v", "out")


# -- the tower with its q/k/v/out export --------------------------------------------

def tower_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the attention kernel's input), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_encoder(arch: str, device: torch.device):
    """(params on ``device``, cfg): misc/<arch>.pt when present, else a
    random init seeded 0. Matrix weights (``w``, ``conv1``) are held in the
    tower's dtype, everything else in f32."""
    from ..models import weights as weights_lib

    name = arch.replace("/", "-").replace("@", "-")
    for cand in (f"misc/{name}.pt", f"misc/{name}.npz"):
        if path.isfile(cand):
            tree, cfg = weights_lib.load_clip_visual(cand)
            params = weights_lib.params_from_jax(tree)
            logger.info("Loaded encoder weights from %s", cand)
            break
    else:
        cfg = clip_vit.ARCHITECTURES[arch]
        logger.warning("No converted checkpoint for %s under misc/; using RANDOM init: maps "
                       "will be structurally valid but semantically meaningless.", arch)
        params = clip_vit.init_clip_vision(torch.Generator().manual_seed(0), cfg)
    dtype = tower_dtype(device)

    def place(tree, key=""):
        if isinstance(tree, dict):
            return {k: place(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v) for v in tree]
        return tree.to(device=device, dtype=dtype if key == "w" else torch.float32)

    return place(params), cfg


def embed(params, frames_u8: torch.Tensor, cfg: clip_vit.ViTConfig) -> torch.Tensor:
    """uint8 (F, 3, H, W) on the tower's device -> the first block's input
    (F, T, W) in the tower's dtype."""
    from ..ops import image_ops

    x = image_ops.resize_crop_normalize(frames_u8, cfg.input_resolution, CLIP_MEAN, CLIP_STD)
    return clip_vit.embed_patches(params, x, cfg, tower_dtype(frames_u8.device))


def tower_block(bp, h: torch.Tensor, cfg: clip_vit.ViTConfig) -> Dict[str, torch.Tensor]:
    """One block on h (F, T, W): {"q", "k", "v"} (the in-projection's column
    blocks) and "out" (the block output, the next block's input), CLS
    kept."""
    w = h.shape[-1]
    qkv = clip_vit.block_qkv(bp, h)
    h = clip_vit.block_tail(bp, h, qkv, cfg)
    return {"q": qkv[..., :w], "k": qkv[..., w:2 * w], "v": qkv[..., 2 * w:], "out": h}


@torch.no_grad()
def export_qkv_out(params, frames_u8: torch.Tensor, cfg: clip_vit.ViTConfig,
                   subjects: Sequence[str] = SUBJECTS) -> Dict[str, torch.Tensor]:
    """uint8 (F, 3, H, W) on the tower's device -> {subject: (L, F, P, W)}
    in the tower's dtype, CLS dropped."""
    h = embed(params, frames_u8, cfg)
    f, t, w = h.shape
    out = {s: torch.empty((cfg.layers, f, t - 1, w), dtype=h.dtype, device=h.device)
           for s in subjects}
    for i, bp in enumerate(params["blocks"]):
        exports = tower_block(bp, h, cfg)
        h = exports["out"]
        for s in subjects:
            out[s][i] = exports[s][:, 1:]
    return out


def extract_features(params, cfg, frames_u8, subjects=SUBJECTS,
                     device: torch.device = torch.device("cpu")) -> Dict[str, np.ndarray]:
    """Host {subject: (L, F, P, W) float32} for one clip's uint8 frames."""
    frames = torch.as_tensor(np.asarray(frames_u8)).to(device)
    return {s: v.float().cpu().numpy()
            for s, v in export_qkv_out(params, frames, cfg, tuple(subjects)).items()}


# -- dataset plumbing -----------------------------------------------------------------

def build_dataset(args, augmentation, *, pair=False, types=None):
    from ..data.datasets import FFPP

    c = FFPP.get_default_config()
    c.root_dir = args.root
    c.types = list(types or args.types)
    c.compressions = list(args.compressions)
    c.augmentation = augmentation
    c.pair = int(pair)
    c.random_speed = 0
    return FFPP(c, args.num_frames, args.clip_duration, transform=None, split="train",
                seed=args.seed)


def fetch_clip(ds, idx):
    """{comp: (F, 3, H, W) uint8} for clip ``idx`` (a fresh augmentation
    draw each call)."""
    return ds.get_dict(idx, block=True)["frames"]


class MissingMember(LookupError):
    """A sampled clip has no member of the compression asked for (a raw
    video of a dataset that lists raw and c23)."""


def first_frame(frames, comp):
    """(1, 3, H, W): frame 0 of the clip's ``comp`` member."""
    if comp not in frames:
        raise MissingMember(f"the clip has no {comp} member")
    return frames[comp][:1]


# what augment-impact resamples: a clip that cannot be decoded, or one
# without the member it compares
RESAMPLED = DECODE_ERRORS + (MissingMember,)


def locate_video(ds, video_name):
    """The first clip index of a named video."""
    for vid_idx, entry in enumerate(ds.video_list):
        if entry[2] == video_name:   # (df_type, comp, name, clips)
            return 0 if vid_idx == 0 else ds.stack_video_clips[vid_idx - 1]
    raise SystemExit(f"video {video_name!r} not in the dataset index")


def _grid(cfg):
    return cfg.input_resolution // cfg.patch_size


# -- figures ----------------------------------------------------------------------------

def save_heat_grid(maps, title, out_png, ncols=None):
    """maps: {row_label: [2D arrays]} -> one PNG grid."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nrows = len(maps)
    ncols = ncols or max(len(v) for v in maps.values())
    fig, axes = plt.subplots(nrows, ncols, figsize=(2.2 * ncols, 2.4 * nrows), squeeze=False)
    for r, (label, row) in enumerate(maps.items()):
        for c in range(ncols):
            ax = axes[r][c]
            if c < len(row):
                ax.imshow(row[c])
                ax.set_title(f"{label} L{c}", fontsize=7)
            ax.set_xticks(())
            ax.set_yticks(())
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    logger.info("wrote %s", out_png)


# -- subcommands ------------------------------------------------------------------------

def cmd_kv_dist(args):
    params, cfg = load_encoder(args.arch, args.dev)
    g = _grid(cfg)
    ds = build_dataset(args, args.augmentation)
    idx = locate_video(ds, args.video) if args.video else args.index
    frames = fetch_clip(ds, idx)

    makedirs(args.out_dir, exist_ok=True)
    result = {}
    for comp, clip_u8 in frames.items():
        feats = extract_features(params, cfg, clip_u8, args.subjects, args.dev)
        n_frames = next(iter(feats.values())).shape[1]
        # temporal variance a patch: var over frames, mean over width
        variance = {s: [f.var(axis=0).mean(axis=-1).reshape(g, g) for f in feats[s]]
                    for s in args.subjects}
        # patch similarity: cosine to frame 0's reference patch / sqrt(W),
        # softmax over patches a frame -> a (grid, F * grid) ribbon
        r, c = args.patch_loc
        loc = r * g + c
        similarity = {}
        for s in args.subjects:
            ribbons = []
            for f in feats[s]:   # (F, P, W)
                ref = f[0, loc]
                sim = (f @ ref) / (np.linalg.norm(f, axis=-1) * np.linalg.norm(ref) + 1e-8)
                sim = sim / np.sqrt(f.shape[-1])
                e = np.exp(sim - sim.max(axis=-1, keepdims=True))
                att = e / e.sum(axis=-1, keepdims=True)   # (F, P)
                ribbons.append(att.reshape(-1, g, g).transpose(1, 0, 2).reshape(g, -1))
            similarity[s] = ribbons
        result[comp] = {"variance": variance, "similarity": similarity}

        if args.figures:
            save_heat_grid(variance, f"{comp}: temporal variance (clip {idx})",
                           path.join(args.out_dir, f"kv_variance_{comp}.png"))
            for s in args.subjects:
                save_heat_grid({f"L{i}": [rb] for i, rb in enumerate(similarity[s])},
                               f"{comp}-{s}: patch ({r},{c}) similarity",
                               path.join(args.out_dir, f"kv_similarity_{comp}_{s}.png"),
                               ncols=1)
        logger.info("%s: %d frames, %d layers", comp, n_frames, cfg.layers)

    out_pkl = path.join(args.out_dir, "kv_distribution.pickle")
    with open(out_pkl, "wb") as f:
        pickle.dump(result, f)
    print(f"kv-dist: wrote {out_pkl}"
          + (f" + figures under {args.out_dir}" if args.figures else ""))


def cmd_semantic_patches(args):
    params, cfg = load_encoder(args.arch, args.dev)
    g = _grid(cfg)
    # region coordinates are on the 14x14 grid; rescaled for other grids
    locations = {k: sorted({min(r * g // 14, g - 1) * g + min(c * g // 14, g - 1)
                            for r, c in v})
                 for k, v in SEMANTIC_LOCATIONS.items()}
    ds = build_dataset(args, args.augmentation)
    rng = np.random.default_rng(args.seed)

    sums = {s: {k: None for k in locations} for s in args.subjects}
    count = 0
    for i in range(args.num_samples):
        idx = int(rng.integers(0, len(ds)))
        try:
            frames = fetch_clip(ds, idx)
        except DECODE_ERRORS as e:   # a corrupt clip: resample
            logger.warning("sample %d (clip %d) failed: %s", i, idx, e)
            continue
        first = frames[args.compressions[0]][:1]   # frame 0 only
        feats = extract_features(params, cfg, first, args.subjects, args.dev)
        for s in args.subjects:
            for name, locs in locations.items():
                region = feats[s][:, 0, locs].mean(axis=1)   # (L, W)
                prev = sums[s][name]
                sums[s][name] = region if prev is None else prev + region
        count += 1
        if (i + 1) % 20 == 0:
            logger.info("semantic-patches: %d/%d", i + 1, args.num_samples)

    if count == 0:
        raise SystemExit("no sample decoded successfully")
    out = {s: {k: [sums[s][k][l] / count for l in range(cfg.layers)] for k in locations}
           for s in args.subjects}
    makedirs(path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"semantic-patches: {count} samples -> {args.out}")


def _kl_map(a, b, g):
    """Per-patch KL(log_softmax(a) || log_softmax(b)) over width: a, b
    (P, W) -> (g, g) (torch kl_div(la, lb, log_target=True))."""
    def logsoft(x):
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    la, lb = logsoft(a), logsoft(b)
    return (np.exp(lb) * (lb - la)).mean(axis=-1).reshape(g, g)


def cmd_augment_impact(args):
    params, cfg = load_encoder(args.arch, args.dev)
    g = _grid(cfg)
    rng = np.random.default_rng(args.seed)
    makedirs(args.out_dir, exist_ok=True)

    for setting in args.settings:
        # a named augmentation: one clip, two draws; "any": two random clips;
        # "compression": one draw replayed across a c23/raw pair
        pair = setting == "compression"
        aug = "normal+frame" if setting in ("any", "compression") else setting
        ds = build_dataset(args, aug, pair=pair)
        acc = {s: np.zeros((cfg.layers, g, g), np.float64) for s in ("k", "v")}
        count = 0
        while count < args.num_samples:
            try:
                if pair:
                    frames = fetch_clip(ds, int(rng.integers(0, len(ds))))
                    d1, d2 = first_frame(frames, "c23"), first_frame(frames, "raw")
                elif setting == "any":
                    d1 = first_frame(fetch_clip(ds, int(rng.integers(0, len(ds)))), "c23")
                    d2 = first_frame(fetch_clip(ds, int(rng.integers(0, len(ds)))), "c23")
                else:
                    idx = int(rng.integers(0, len(ds)))
                    d1 = first_frame(fetch_clip(ds, idx), "c23")
                    d2 = first_frame(fetch_clip(ds, idx), "c23")
            except RESAMPLED as e:
                logger.warning("%s: sample failed: %s", setting, e)
                continue
            f1 = extract_features(params, cfg, d1, ("k", "v"), args.dev)
            f2 = extract_features(params, cfg, d2, ("k", "v"), args.dev)
            for s in ("k", "v"):
                for l in range(cfg.layers):
                    acc[s][l] += _kl_map(f1[s][l, 0], f2[s][l, 0], g)
            count += 1
            if count % 50 == 0:
                logger.info("%s: %d/%d", setting, count, args.num_samples)

        out = {s: [np.asarray(acc[s][l] / count, np.float32) for l in range(cfg.layers)]
               for s in ("k", "v")}
        out_pkl = path.join(args.out_dir, f"{setting}.pickle")
        with open(out_pkl, "wb") as f:
            pickle.dump(out, f)
        print(f"augment-impact[{setting}]: {count} samples -> {out_pkl}")


def cmd_comb_impact(args):
    if len(args.weights) != len(args.inputs):
        raise SystemExit("--weights must match --inputs in length")
    data = []
    for file in args.inputs:
        with open(file, "rb") as f:
            data.append(pickle.load(f))
    layers_n = len(data[0]["k"])

    # per-(input, layer, subject) min-max normalisation
    for d in data:
        for s in ("k", "v"):
            for l in range(layers_n):
                m = np.asarray(d[s][l], np.float64)
                lo, hi = m.min(), m.max()
                d[s][l] = (m - lo) / (hi - lo) if hi > lo else m * 0.0
    if args.invert_last:
        d = data[-1]
        for s in ("k", "v"):
            d[s] = [1.0 - d[s][l] for l in range(layers_n)]

    combined = {}
    for s in ("k", "v"):
        maps = []
        for l in range(layers_n):
            m = sum(w * d[s][l] for w, d in zip(args.weights, data))
            if args.complement:   # the reference's (2 - weighted sum) / 2 form
                m = (2.0 - m) / 2.0
            # each map sums to 1: the float64 prior the patch sampler draws from
            total = float(np.sum(m))
            if not (np.isfinite(total) and total > 0):
                raise SystemExit(f"comb-impact: the combined {s} map of layer {l} sums to "
                                 f"{total}, so it cannot be a sampling prior; each input's "
                                 "maps of that layer are constant (a named augmentation's "
                                 "two draws of one clip are equal) or the weights cancel")
            maps.append(np.asarray(m, np.float64) / total)
        combined[s] = maps

    makedirs(path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(combined, f)
    if args.figures:
        save_heat_grid({s: combined[s] for s in ("k", "v")}, "guide map",
                       path.splitext(args.out)[0] + ".png")
    print(f"comb-impact: wrote {args.out} ({layers_n} layers, weights {args.weights})")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, dataset=True):
        sp.add_argument("--arch", default="ViT-B/16")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if dataset:
            sp.add_argument("--root", required=True, help="FFPP root dir")
            sp.add_argument("--types", nargs="+", default=["REAL", "NT", "DF", "FS", "F2F"])
            sp.add_argument("--compressions", nargs="+", default=["c23"])
            sp.add_argument("--num-frames", type=int, default=20)
            sp.add_argument("--clip-duration", type=int, default=5)

    sp = sub.add_parser("kv-dist", help="per-clip q/k/v/out maps")
    common(sp)
    sp.add_argument("--video", help="video name, e.g. 193_030")
    sp.add_argument("--index", type=int, default=0, help="clip index")
    sp.add_argument("--augmentation", default="none")
    sp.add_argument("--subjects", nargs="+", default=list(SUBJECTS), choices=list(SUBJECTS))
    sp.add_argument("--patch-loc", type=lambda s: tuple(map(int, s.split(","))),
                    default=(1, 7), help="row,col of the reference patch")
    sp.add_argument("--out-dir", default="analysis")
    sp.add_argument("--figures", action="store_true")
    sp.set_defaults(fn=cmd_kv_dist)

    sp = sub.add_parser("semantic-patches", help="mean region embeddings over N clips")
    common(sp)
    sp.add_argument("--augmentation", default="none")
    sp.add_argument("--subjects", nargs="+", default=list(SUBJECTS), choices=list(SUBJECTS))
    sp.add_argument("--num-samples", type=int, default=100)
    sp.add_argument("--out", default="misc/semantic_patches.pickle")
    sp.set_defaults(fn=cmd_semantic_patches)

    sp = sub.add_parser("augment-impact", help="per-layer KL impact maps per setting")
    common(sp)
    sp.add_argument("--settings", nargs="+",
                    default=["dev-mode+force-rgb", "dev-mode+force-hue",
                             "dev-mode+force-bright", "compression", "any"])
    sp.add_argument("--num-samples", type=int, default=1000)
    sp.add_argument("--out-dir", default="misc")
    sp.set_defaults(fn=cmd_augment_impact)

    sp = sub.add_parser("comb-impact", help="combine impact maps -> guide map")
    common(sp, dataset=False)
    sp.add_argument("--inputs", nargs="+", required=True)
    sp.add_argument("--weights", nargs="+", type=float, required=True)
    sp.add_argument("--invert-last", action="store_true",
                    help="use (1 - map) for the last input (the 'any' term)")
    sp.add_argument("--complement", action="store_true",
                    help="reference's (2 - sum)/2 combination form")
    sp.add_argument("--out", default="misc/guide_map.pickle")
    sp.add_argument("--figures", action="store_true")
    sp.set_defaults(fn=cmd_comb_impact)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ..device import resolve_device

    logging.basicConfig(level="INFO")
    args = parse_args(argv)
    args.dev = resolve_device(args.device)
    logging.info("Video files decode through %s", backend_name())
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
