"""Evaluation datasets (the port's own copy of the FFPP, CDF and DFDC half of
dfd_clip_tpu/data/datasets.py).

Items are raw uint8 CHW frame stacks; the Detector normalises them on the
card. Sampling follows the reference (src/datasets.py:636-662): per clip,
``offset = int(clip_index * clip_duration + clip_duration * shift_factor)``
seconds, ``stride = ((int(fps * clip_duration * speed) - 1) /
(num_frames - 1)) / fps``, frame i = the first frame with pts >= offset + i *
stride. Per-sample randomness is keyed on the stream position (seed, task
index, epoch, item index), as in the JAX package, so an item's content
equals the JAX package's for the same position.

Every dataset takes ``video_backend`` (data/video.py), the JAX package's
DFD_VIDEO_BACKEND as an argument. The video table is cached under
``./.cache/dfd-clip/videos/`` with the JAX package's file names and pickle
contents. Not ported yet, and raising NotImplementedError: FFPP's training
augmentation (``augmentation`` other than "none" on the train split) and
``ssl_fake``, which need data/augment.py; RPPG waits for the training CLI.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import pickle
from os import path, makedirs
from typing import Any, Dict, List

import numpy as np

from ..runtime import OneProcess
from .loader import default_collate
from .video import backend_for_path

logger = logging.getLogger(__name__)

CACHE_DIR = "./.cache/dfd-clip/videos"


def _runtime_or_default(runtime):
    return runtime if runtime is not None else OneProcess()


def _probe_video_table(root: str, subdir: str, vid_ext: str, cache_name: str,
                       runtime, video_backend: str = "auto") -> Dict[str, Dict[str, Any]]:
    """Scan a videos dir into {name: meta}, pickle-cached like the reference
    (src/datasets.py:420-472). Unlike the reference's cache key (class-type-
    comp only), the file name also carries a digest of (root, subdir,
    vid_ext): two datasets of the same class pointed at DIFFERENT roots
    must not share one table — the stale table's relative paths would be
    re-joined onto the new root (wrong lengths, missing files that the
    retry loop then masks as endless decode errors)."""
    import hashlib

    digest = hashlib.sha1(
        f"{path.abspath(root)}|{subdir}|{vid_ext}".encode()
    ).hexdigest()[:10]
    video_cache = path.expanduser(f"{CACHE_DIR}/{cache_name}-{digest}.pkl")
    if path.isfile(video_cache):
        with open(video_cache, "rb") as f:
            video_metas = pickle.load(f)
    else:
        video_metas = {}
        full = path.join(root, subdir)
        if path.isdir(full):
            for fname in sorted(os.listdir(full)):
                if vid_ext not in fname:
                    continue
                fpath = path.join(full, fname)
                try:
                    meta = backend_for_path(fpath, video_backend).probe(fpath)
                    video_metas[fname[: -len(vid_ext)]] = {
                        "fps": meta.fps,
                        "frames": round(meta.duration * meta.fps),
                        "duration": meta.duration,
                        "path": path.join(subdir, fname)[: -len(vid_ext)],
                    }
                except Exception as e:
                    print(f"Error Occur During Video Table Creation: {fpath} ({e})")
        if runtime.is_main_process:
            makedirs(path.dirname(video_cache), exist_ok=True)
            # atomic publish: another rank may poll isfile() concurrently
            tmp = f"{video_cache}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(video_metas, f)
            os.replace(tmp, video_cache)
    # absolute paths
    for idx in video_metas:
        video_metas[idx] = dict(video_metas[idx])
        video_metas[idx]["path"] = path.join(root, video_metas[idx]["path"]) + vid_ext
    return video_metas


def _read_clip_frames(vid_path: str, fps: float, offset: float, stride: float,
                      num_frames: int, video_backend: str = "auto") -> np.ndarray:
    """(T, H, W, 3) uint8 at the reference's seek times."""
    times = [offset + i * stride for i in range(num_frames)]
    return backend_for_path(vid_path, video_backend).read_frames(vid_path, times)


def _hwc_to_chw(frames: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frames.transpose(0, 3, 1, 2))


def _pad_and_mask(frames: np.ndarray, num_frames: int):
    n = len(frames)
    mask = np.array([True] * n + [False] * (num_frames - n))
    if n < num_frames:
        pad = np.zeros((num_frames - n, *frames.shape[1:]), frames.dtype)
        frames = np.concatenate([frames, pad])
    return frames, mask


class _SampleRNGMixin:
    """Stream-position-keyed sample randomness.

    The reference draws per-sample randomness (speed/shift factors,
    augmentation params, retry resampling) from process-global python/np RNGs
    (src/datasets.py:304-333), so a sample's content depends on the fetch
    HISTORY: worker thread interleaving reorders draws, and a checkpoint
    resume that skips ahead index-wise replays the RNG stream from the top —
    every post-resume sample decodes differently than in the uninterrupted
    run (the exact bug: resumed final weights drifted ~1e-5 on the toy e2e).

    Here every draw comes from a generator keyed on the STREAM POSITION
    (seed, task index, epoch, item index): content is a pure function of
    position — fetch-order independent (thread-safe without locks),
    bit-reproducible across kill/requeue, and still fresh every epoch. The
    DataLoader advertises the epoch via ``set_epoch`` at the top of each
    ``__iter__`` (data/loader.py), which ``set_position`` re-enters on
    resume.
    """

    def _init_sample_rng(self, seed: int, index: int) -> None:
        self._seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _sample_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                (self._seed, int(self.index), self._epoch, int(idx))
            )
        )


class FFPP(_SampleRNGMixin):
    """FaceForensics++ (reference src/datasets.py:227-734)."""

    TYPE_DIRS = {"REAL": "real/", "DF": "DF/", "FS": "FS/", "F2F": "F2F/", "NT": "NT/"}

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.category = "train"
        C.root_dir = "./datasets/ffpp/"
        C.vid_ext = ".avi"
        C.detection_level = "video"
        C.types = ["REAL", "DF", "F2F", "FS", "NT"]
        C.compressions = ["raw"]
        C.name = "FFPP"
        C.scale = 1.0
        C.pack = 0
        C.pair = 0
        C.contrast = 0
        C.ssl_fake = 0
        C.contrast_pair = 0
        C.augmentation = "none"
        C.random_speed = 1
        return C

    def __init__(self, config, num_frames, clip_duration, transform=None,
                 runtime=None, split="train", index=0, seed: int = 0,
                 video_backend: str = "auto", **_):
        assert 0 <= config.scale <= 1
        if config.ssl_fake:
            raise NotImplementedError("FFPP ssl_fake needs data/augment.py, not ported yet")
        if split == "train" and config.augmentation != "none":
            raise NotImplementedError(f"FFPP augmentation {config.augmentation!r} needs "
                                      "data/augment.py, not ported yet")
        runtime = _runtime_or_default(runtime)
        self.video_backend = video_backend
        self.category = config.category.lower()
        self.name = config.name.lower()
        self.root = path.expanduser(config.root_dir)
        self.vid_ext = config.vid_ext
        self.types = sorted(set(config.types), reverse=True)
        self.compressions = sorted(set(config.compressions), reverse=True)
        self.num_frames = num_frames
        self.clip_duration = clip_duration
        self.split = split
        self.random_speed = config.random_speed
        self.transform = transform
        self.index = index
        self.scale = config.scale
        self.pack = bool(config.pack)
        self.pair = bool(config.pair)
        self.contrast = bool(config.contrast)
        self.contrast_pair = bool(config.contrast_pair)

        self._init_sample_rng(seed, index)

        self._build_video_table(runtime)
        self._build_video_list(runtime)

    # -- table/list construction ----------------------------------------------
    def _build_video_table(self, runtime):
        self.video_table = {}
        for df_type in self.types:
            self.video_table[df_type] = {}
            for comp in self.compressions:
                subdir = path.join(self.TYPE_DIRS[df_type], f"{comp}/videos")
                self.video_table[df_type][comp] = _probe_video_table(
                    self.root, subdir, self.vid_ext,
                    f"{type(self).__name__}-{df_type}-{comp}", runtime, self.video_backend,
                )

    def _build_video_list(self, runtime):
        self.video_list = []
        with open(path.join(self.root, "splits", f"{self.split}.json")) as f:
            idxs = json.load(f)
        for df_type in self.types:
            for comp in self.compressions:
                comp_videos = []
                adj_idxs = (
                    [i for inner in idxs for i in inner]
                    if df_type == "REAL"
                    else ["_".join(idx) for idx in idxs]
                    + ["_".join(reversed(idx)) for idx in idxs]
                )
                for idx in adj_idxs:
                    if idx in self.video_table[df_type][comp]:
                        clips = int(
                            self.video_table[df_type][comp][idx]["duration"]
                            // self.clip_duration
                        )
                        if clips > 0:
                            comp_videos.append((df_type, comp, idx, clips))
                    else:
                        runtime.print(
                            f"Warning: video {path.join(self.root, self.TYPE_DIRS[df_type], comp, 'videos', idx)}"
                            " is missing from the processed dataset; skipping."
                        )
                self.video_list += comp_videos[: int(self.scale * len(comp_videos))]

        self.stack_video_clips = [0]
        self.real_clip_idx = {}
        for df_type, _, idx, i in self.video_list:
            self.stack_video_clips.append(self.stack_video_clips[-1] + i)
            if df_type == "REAL":
                self.real_clip_idx[idx] = [
                    self.stack_video_clips[-2],
                    self.stack_video_clips[-1] - 1,
                ]
        self.stack_video_clips.pop(0)

    def __len__(self):
        if not self.stack_video_clips:  # empty list/split: 0, not IndexError
            return 0
        return len(self.video_list) if self.pack else self.stack_video_clips[-1]

    def video_info(self, idx):
        video_idx = next(i for i, x in enumerate(self.stack_video_clips) if idx < x)
        return video_idx, *self.video_list[video_idx]

    def __getitem__(self, idx):
        if self.pack:
            start = 0 if idx == 0 else self.stack_video_clips[idx - 1]
            end = self.stack_video_clips[idx]
            frames, label, mask, speed = [], [], [], []
            for i in range(start, end):
                try:
                    result = self.get_dict(i, block=True)
                except Exception:
                    logger.warning("Cannot fetch clip for item index:%d", i)
                    continue
                for comp in result["frames"]:
                    frames.append(result["frames"][comp])
                    label.append(result["label"])
                    mask.append(result["mask"])
                    speed.append(result["speed"])
            return frames, label, mask, speed, self.index
        elif self.contrast:
            rng = self._sample_rng(idx)
            result = []
            if self.contrast_pair:
                assert len(self.real_clip_idx) > 0, "contrast_pair needs at least one real clip indexed before fakes"
                while True:
                    try:
                        vid_idx, df_type, _, vid_name, _ = self.video_info(idx)
                        if df_type == "REAL":
                            idx = int(rng.integers(0, len(self)))
                            continue
                        clip_offset = idx - (0 if vid_idx == 0 else self.stack_video_clips[vid_idx - 1])
                        auxi_idx = self.real_clip_idx[vid_name.split("_")[-1]][0] + clip_offset
                        result = [
                            self.get_dict(auxi_idx, block=True, rng=rng),
                            self.get_dict(idx, block=True, rng=rng),
                        ]
                    except Exception:
                        logger.debug("Cannot Form Contrastive Pair, Retry...")
                        idx = int(rng.integers(0, len(self)))
                        continue
                    else:
                        break
            else:
                _, df_type, _, _, _ = self.video_info(idx)
                main_label = df_type != "REAL"
                auxi_idx = int(rng.integers(0, len(self)))
                result.append(self.get_dict(idx, target_label=main_label, rng=rng))
                result.append(self.get_dict(auxi_idx, target_label=not main_label, rng=rng))

            return (
                *[[r[name] for r in result] for name in ("frames", "label", "mask", "speed")],
                [self.index] * 2,
            )
        else:
            result = self.get_dict(idx)
            return result["frames"], result["label"], result["mask"], result["speed"], self.index

    def get_dict(self, idx, block=False, target_label=None, rng=None):
        # rng is the stream-position generator (see _SampleRNGMixin); a
        # caller that draws several samples per item (contrast pairs)
        # threads one generator through so the pair is a single key.
        if rng is None:
            rng = self._sample_rng(idx)

        while True:
            try:
                video_idx, df_type, comp, video_name, clips = self.video_info(idx)

                if target_label is not None:
                    if target_label != (df_type != "REAL"):
                        idx = int(rng.integers(0, len(self)))
                        continue

                video_meta = self.video_table[df_type][comp][video_name]
                video_offset_duration = (
                    idx - (0 if video_idx == 0 else self.stack_video_clips[video_idx - 1])
                ) * self.clip_duration

                if self.split == "train" and self.random_speed:
                    video_speed_factor = float(rng.random()) * 0.5 + 0.5
                    video_shift_factor = float(rng.random()) * (1 - video_speed_factor)
                else:
                    video_speed_factor = 1.0
                    video_shift_factor = 0.0

                frames = {}
                for target_comp in ("raw", "c23"):
                    vid_path = video_meta["path"]
                    if target_comp not in vid_path:
                        if not self.pair:
                            continue
                        vid_path = vid_path.replace(comp, target_comp)

                    fps = video_meta["fps"]
                    offset = int(video_offset_duration + self.clip_duration * video_shift_factor)
                    clip_samples = int(fps * self.clip_duration * video_speed_factor)
                    stride = ((clip_samples - 1) / (self.num_frames - 1)) / fps

                    _frames = _read_clip_frames(vid_path, fps, offset, stride, self.num_frames,
                                                self.video_backend)
                    _frames = _hwc_to_chw(_frames)
                    if self.transform:
                        _frames = self.transform(_frames)
                    frames[target_comp] = _frames

                _, mask = _pad_and_mask(frames[comp], self.num_frames)
                for target_comp in list(frames):
                    frames[target_comp], _ = _pad_and_mask(frames[target_comp], self.num_frames)

                return {
                    "frames": frames,
                    "label": 0 if df_type == "REAL" else 1,
                    "mask": mask,
                    "speed": video_speed_factor,
                    "idx": idx,
                }
            except Exception as e:
                logger.error("Error occur: %s", e)
                if block:
                    raise
                idx = int(rng.integers(0, len(self)))

    def collate_fn(self, batch):
        """[frames, label, mask, comps, speed, index] with comp interleave
        (reference src/datasets.py:708-734)."""
        _frames, _label, _mask, _speed, _index = list(zip(*batch))

        if self.contrast:
            _frames = [i for l in _frames for i in l]
            _label = [i for l in _label for i in l]
            _mask = [i for l in _mask for i in l]
            _index = [i for l in _index for i in l]
            _speed = [i for l in _speed for i in l]

        num_comps = len(_frames[0].keys())
        frames, comps = [], []
        for _frame in _frames:
            for comp, clip in _frame.items():
                frames.append(clip)
                comps.append(comp)

        frames = np.stack(frames)
        mask = np.repeat(np.stack(_mask), num_comps, axis=0)
        label = np.repeat(np.asarray(_label, np.int64), num_comps, axis=0)
        index = np.repeat(np.asarray(_index, np.int64), num_comps, axis=0)
        speed = np.repeat(np.asarray(_speed, np.float32), num_comps, axis=0)
        return [frames, label, mask, comps, speed, index]


class _TestOnlyVideoDataset(_SampleRNGMixin):
    """Shared skeleton for the test-split-only datasets (CDF/DFDC)."""

    LABELS = ("REAL", "FAKE")

    def __init__(self, config, num_frames, clip_duration, transform=None,
                 runtime=None, split="test", index=0, seed: int = 0,
                 video_backend: str = "auto", **_):
        if split != "test":
            logger.warning("Dataset %s currently supports only the test split.",
                           type(self).__name__.upper())
            split = "test"
        assert 0 <= config.scale <= 1
        runtime = _runtime_or_default(runtime)
        self.video_backend = video_backend
        self.category = config.category.lower()
        self.name = config.name.lower()
        self.root = path.expanduser(config.root_dir)
        self.vid_ext = config.vid_ext
        self.num_frames = num_frames
        self.clip_duration = clip_duration
        self.transform = transform
        self.index = index
        self.scale = config.scale
        self.pack = bool(config.pack)
        self.split = split
        self._init_sample_rng(seed, index)

        self._build_video_table(runtime)
        self._build_video_list(runtime)

    def _build_video_table(self, runtime):
        self.video_table = {}
        for label in self.LABELS:
            self.video_table[label] = _probe_video_table(
                self.root, path.join(label, "videos"), self.vid_ext,
                f"{type(self).__name__}-{label}", runtime, self.video_backend,
            )

    def _csv_names(self, label: str) -> List[str]:
        raise NotImplementedError

    def _build_video_list(self, runtime):
        self.video_list = []
        for label in self.LABELS:
            _videos = []
            for filename in self._csv_names(label):
                name, _ = os.path.splitext(filename)
                if name in self.video_table[label]:
                    clips = int(self.video_table[label][name]["duration"] // self.clip_duration)
                    if clips > 0:
                        _videos.append((label, name, clips))
                else:
                    runtime.print(
                        f"Warning: video {path.join(self.root, label, 'videos', name)}"
                        " is missing from the processed dataset; skipping."
                    )
            self.video_list += _videos[: int(self.scale * len(_videos))]

        self.stack_video_clips = [0]
        for _, _, i in self.video_list:
            self.stack_video_clips.append(self.stack_video_clips[-1] + i)
        self.stack_video_clips.pop(0)

    def __len__(self):
        if not self.stack_video_clips:  # empty list/split: 0, not IndexError
            return 0
        return len(self.video_list) if self.pack else self.stack_video_clips[-1]

    def __getitem__(self, idx):
        if self.pack:
            start = 0 if idx == 0 else self.stack_video_clips[idx - 1]
            end = self.stack_video_clips[idx]
            frames, label, mask = [], [], []
            for i in range(start, end):
                try:
                    result = self.get_dict(i, block=True)
                except Exception:
                    logger.warning("Cannot fetch clip for item index:%d", i)
                    continue
                frames.append(result["frames"])
                label.append(result["label"])
                mask.append(result["mask"])
            return frames, label, mask, self.index
        result = self.get_dict(idx)
        return result["frames"], result["label"], result["mask"], self.index

    def _table_key(self, label: str) -> str:
        """The video table a video of ``label`` is listed in."""
        return label

    def get_dict(self, idx, block=False):
        rng = self._sample_rng(idx)
        while True:
            try:
                video_idx = next(i for i, x in enumerate(self.stack_video_clips) if idx < x)
                label, video_name, clips = self.video_list[video_idx]
                video_meta = self.video_table[self._table_key(label)][video_name]
                video_offset_duration = (
                    idx - (0 if video_idx == 0 else self.stack_video_clips[video_idx - 1])
                ) * self.clip_duration

                fps = video_meta["fps"]
                offset = int(video_offset_duration)
                clip_samples = int(fps * self.clip_duration)
                stride = ((clip_samples - 1) / (self.num_frames - 1)) / fps
                frames = _read_clip_frames(
                    video_meta["path"], fps, offset, stride, self.num_frames, self.video_backend
                )
                frames = _hwc_to_chw(frames)
                if self.transform:
                    frames = self.transform(frames)
                frames, mask = _pad_and_mask(frames, self.num_frames)
                return {
                    "frames": frames,
                    "label": 0 if label == "REAL" else 1,
                    "mask": mask,
                }
            except Exception as e:
                logger.error("Error occur: %s", e)
                if block:
                    raise
                idx = int(rng.integers(0, len(self)))

    def collate_fn(self, batch):
        """Emit the standard 6-field batch (comp 'raw', speed 1)."""
        if self.pack:
            return default_collate(batch)
        frames, label, mask, index = list(zip(*batch))
        n = len(frames)
        return [
            np.stack(frames),
            np.asarray(label, np.int64),
            np.stack(mask),
            ["raw"] * n,
            np.ones((n,), np.float32),
            np.asarray(index, np.int64),
        ]


class CDF(_TestOnlyVideoDataset):
    """Celeb-DF test set (reference src/datasets.py:1027-1238)."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.category = "CDF"
        C.root_dir = "./datasets/cdf/"
        C.vid_ext = ".avi"
        C.name = "CDF"
        C.scale = 1.0
        C.pack = 0
        return C

    def _csv_names(self, label: str) -> List[str]:
        names = []
        with open(path.join(self.root, "csv_files", f"{self.split}_{label.lower()}.csv")) as f:
            for row in csv.reader(f, delimiter=" "):
                if row:
                    names.append(row[0])
        return names


class DFDC(_TestOnlyVideoDataset):
    """DFDC test set (reference src/datasets.py:1241-1450)."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.category = "DFDC"
        C.root_dir = "./datasets/dfdc/"
        C.vid_ext = ".avi"
        C.name = "DFDC"
        C.scale = 1.0
        C.pack = 0
        return C

    def _build_video_table(self, runtime):
        self.video_table = {
            "ALL": _probe_video_table(
                self.root, "videos", self.vid_ext, f"{type(self).__name__}-ALL", runtime,
                self.video_backend,
            )
        }

    def _build_video_list(self, runtime):
        self.video_list = []
        rows = []
        with open(path.join(self.root, "csv_files", f"{self.split}.csv")) as f:
            for row in csv.reader(f, delimiter=" "):
                if row:
                    rows.append(row)
        _videos = []
        for filename, label in rows:
            name, _ = os.path.splitext(filename)
            if name in self.video_table["ALL"]:
                clips = int(self.video_table["ALL"][name]["duration"] // self.clip_duration)
                if clips > 0:
                    _videos.append(("REAL" if int(label) == 0 else "FAKE", name, clips))
            else:
                runtime.print(
                    f"Warning: video {path.join(self.root, 'videos', name)}"
                    " is missing from the processed dataset; skipping."
                )
        self.video_list = _videos[: int(self.scale * len(_videos))]

        self.stack_video_clips = [0]
        for _, _, i in self.video_list:
            self.stack_video_clips.append(self.stack_video_clips[-1] + i)
        self.stack_video_clips.pop(0)

    def _table_key(self, label: str) -> str:
        return "ALL"
