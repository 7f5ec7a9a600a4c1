"""Datasets (the port's own copy of dfd_clip_tpu/data/datasets.py: FFPP,
CDF, DFDC and RPPG).

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
contents. FFPP's training split runs data/augment.py's ClipAugmenter
(``augmentation``) and, with ``ssl_fake``, its elastic forgery, as the JAX
package does. RPPG reads the MAHNOB-HCI layout that
preprocessing/rppg.py writes (``Metas/*/meta.pickle``,
``Measures/*/data.pickle``, ``cropped_faces/<comp>/...`` videos) without
importing it.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
import pickle
from os import path, makedirs
from typing import Any, Dict, List

import numpy as np

from .augment import ClipAugmenter, ssl_fake_pipeline
from .loader import default_collate
from .video import backend_for_path

logger = logging.getLogger(__name__)

CACHE_DIR = "./.cache/dfd-clip/videos"


class _MainProcessGate:
    """What a dataset reads of a runtime (the main-process check and its
    print) when it is given none: it places nothing, so it needs no device."""
    is_main_process = True

    @staticmethod
    def print(*args, **kwargs):
        print(*args, **kwargs)


def _runtime_or_default(runtime):
    return runtime if runtime is not None else _MainProcessGate()


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
        self.ssl_fake = bool(config.ssl_fake)
        self.augmentation = ClipAugmenter(config.augmentation)
        self.ssl_pipeline = ssl_fake_pipeline() if self.ssl_fake else None

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
            if self.ssl_fake and rng.random() > 0.5:
                result.append(self.get_dict(idx, target_label=False, rng=rng))
                result.append(self.get_dict(result[-1]["idx"], target_label=False,
                                            make_fake=True, rng=rng))
            elif self.contrast_pair:
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

    def get_dict(self, idx, block=False, target_label=None, make_fake=False, rng=None):
        # rng is the stream-position generator (see _SampleRNGMixin); a
        # caller that draws several samples per item (contrast pairs)
        # threads one generator through so the pair is a single key.
        if make_fake and not (self.ssl_fake and target_label is False):
            raise ValueError("make_fake needs ssl_fake and a real target")
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
                replay: Dict[str, Any] = {}
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
                    if self.split == "train":
                        # one replay for both compressions of the pair
                        _frames, replay = self.augmentation(_frames, replay, rng)
                        if make_fake:
                            if "ssl_fake" not in replay:
                                replay["ssl_fake"] = self.ssl_pipeline.sample(rng)
                            _frames = np.stack([self.ssl_pipeline.apply(f, replay["ssl_fake"])
                                                for f in _frames])
                    _frames = _hwc_to_chw(_frames)
                    if self.transform:
                        _frames = self.transform(_frames)
                    frames[target_comp] = _frames

                _, mask = _pad_and_mask(frames[comp], self.num_frames)
                for target_comp in list(frames):
                    frames[target_comp], _ = _pad_and_mask(frames[target_comp], self.num_frames)

                return {
                    "frames": frames,
                    "label": 0 if (df_type == "REAL" and not make_fake) else 1,
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


class RPPG(_SampleRNGMixin):
    """MAHNOB-HCI heart-rate dataset (reference src/datasets.py:737-1024) over
    the offline artefacts of preprocessing/rppg.py: each session's
    ``Metas/<id>/meta.pickle`` summary and ``Measures/<id>/data.pickle`` bpm
    measures (``runtime: 1`` computes the bpm from the session's ECG with
    heartpy and pyedflib instead, when both import; without them it warns
    and reads the measures). Sessions split by a seeded shuffle (python's
    ``random.Random(777)``, the reference's split bit for bit); a clip's
    label is its bpm interpolated between the measures around its end:
    "dist", a Gaussian over ``label_dim`` bins at bpm - 41, or "num", bpm -
    41."""

    @staticmethod
    def get_default_config():
        from ..config import CN

        C = CN()
        C.category = "train"
        C.root_dir = "./datasets/hci/"
        C.detection_level = "video"
        C.train_ratio = 0.95
        C.scale = 1.0
        C.cropped_folder = "cropped_faces"
        C.meta_folder = "Metas"
        C.measure_folder = "Measures"
        C.name = "RPPG"
        C.compressions = ["raw"]
        C.runtime = True
        C.label_type = "dist"
        C.label_dim = 140
        return C

    def __init__(self, config, num_frames, clip_duration, transform=None,
                 runtime=None, split="train", index=0, seed: int = 0,
                 video_backend: str = "auto", **_):
        import random
        from glob import glob

        assert 0 <= config.scale <= 1
        assert 0 <= config.train_ratio <= 1
        assert 140 <= config.label_dim
        assert split in ("train", "val")
        assert config.label_type in ("num", "dist")

        self.video_backend = video_backend
        self.category = config.category.lower()
        self.name = config.name.lower()
        self.transform = transform
        self.num_frames = num_frames
        self.clip_duration = clip_duration
        self.index = index
        self.scale = config.scale
        self.compressions = list(config.compressions)
        self.cropped_folder = config.cropped_folder
        self.runtime_labels = bool(config.runtime)
        if self.runtime_labels:
            # without the optional packages the loader falls back to the
            # Measures files (a missing import inside get_dict would fail
            # every index, and the retry loop would never end)
            try:
                import heartpy  # noqa: F401
                import pyedflib  # noqa: F401
            except ImportError:
                logger.warning("RPPG runtime=1 but heartpy/pyedflib are not importable;"
                               " falling back to offline Measures labels")
                self.runtime_labels = False
        self.label_type = config.label_type
        self.label_dim = config.label_dim
        self._init_sample_rng(seed, index)

        rng = random.Random()
        rng.seed(777)
        session_dirs = sorted(glob(path.join(config.root_dir, "Sessions", "*")))
        rng.shuffle(session_dirs)
        if split == "train":
            target = session_dirs[: int(len(session_dirs) * config.train_ratio * self.scale)]
        else:
            target = session_dirs[int(len(session_dirs) * (
                (1 - config.train_ratio) * (1 - self.scale) + config.train_ratio)):]

        self.session_metas = []
        for session_dir in target:
            meta_path = path.join(
                session_dir.replace("Sessions", config.meta_folder or "Metas"), "meta.pickle")
            try:
                with open(meta_path, "rb") as f:
                    self.session_metas.append(pickle.load(f))
            except Exception as e:
                logger.debug("Error while loading meta pickle: %s", e)

        self.session_measures = []
        if not self.runtime_labels:
            metas, measures = [], []
            for meta in self.session_metas:
                try:
                    mp = path.join(meta["session_dir"].replace("Sessions", config.measure_folder),
                                   "data.pickle")
                    with open(mp, "rb") as f:
                        measures.append(pickle.load(f))
                    metas.append(meta)
                except Exception:
                    continue
            self.session_metas, self.session_measures = metas, measures

        self.session_clips = [int(m["duration"] // self.clip_duration)
                              for m in self.session_metas]
        self.stack_session_clips = [0]
        for c in self.session_clips:
            self.stack_session_clips.append(self.stack_session_clips[-1] + c)
        self.stack_session_clips.pop(0)

    def __len__(self):
        if not self.stack_session_clips:
            return 0
        return self.stack_session_clips[-1] * len(self.compressions)

    def _bpm_label(self, bpm: float):
        assert 41 <= bpm <= 180, f"bpm out of range: {bpm}"
        if self.label_type == "dist":
            k = np.arange(self.label_dim)
            return (1.0 / math.sqrt(2 * math.pi)
                    * np.exp(-np.square(k - (bpm - 41)) / 2.0)).astype(np.float32)
        return np.float32(bpm - 41)

    def get_dict(self, idx):
        rng = self._sample_rng(idx)
        while True:
            try:
                comp = self.compressions[int(idx // self.stack_session_clips[-1])]
                idx = idx % self.stack_session_clips[-1]
                session_idx = next(i for i, x in enumerate(self.stack_session_clips) if idx < x)
                meta = self.session_metas[session_idx]
                offset_duration = (idx - (0 if session_idx == 0
                                          else self.stack_session_clips[session_idx - 1])
                                   ) * self.clip_duration

                hr_freq = meta["session_hr_sample_freq"]
                hr_offset = meta["flag_hr_beg_sample"] + int(offset_duration * hr_freq)
                hr_end = hr_offset + int(hr_freq * self.clip_duration)

                if not self.runtime_labels:
                    sm = self.session_measures[session_idx]
                    mi = next(i for i, x in enumerate(sm["idx"]) if hr_end <= x)
                    # the reference asserts 0 < measure_idx: mi == 0 would
                    # interpolate against the last measure; the retry resamples
                    assert 0 < mi, f"clip precedes first measure (session {session_idx})"
                    ratio = (sm["idx"][mi] - hr_end) / (sm["idx"][mi] - sm["idx"][mi - 1])
                    bpm = ratio * sm["data"][mi - 1]["bpm"] + (1 - ratio) * sm["data"][mi]["bpm"]
                else:
                    bpm = self._runtime_bpm(meta, hr_offset, hr_end - hr_offset)

                label = self._bpm_label(bpm)

                vid_path = meta["video_path"].replace(
                    "Sessions",
                    path.join("Sessions" if not self.cropped_folder else self.cropped_folder,
                              comp))
                fps = meta["session_video_sample_freq"]
                offset = (int(meta["flag_video_beg_sample"] - meta["session_video_beg_sample"])
                          / fps + int(offset_duration))
                clip_samples = int(fps * self.clip_duration)
                stride = (clip_samples - 1) / (self.num_frames - 1) / fps
                frames = _read_clip_frames(vid_path, fps, offset, stride, self.num_frames,
                                           self.video_backend)
                frames = _hwc_to_chw(frames)
                if self.transform:
                    frames = self.transform(frames)
                frames, mask = _pad_and_mask(frames, self.num_frames)
                return {"frames": frames, "label": label, "mask": mask}
            except Exception as e:
                logger.error("Error occur: %s", e)
                idx = int(rng.integers(0, len(self)))

    def _runtime_bpm(self, meta, hr_offset: int, hr_samples: int) -> float:
        """The reference's ECG path (src/datasets.py:909-949): the most
        regular (least sdnn) of the three leads' heartpy measures in 41-180
        bpm. Needs pyedflib, heartpy and scipy."""
        import heartpy as hp  # type: ignore
        from pyedflib import highlevel as bdf_reader  # type: ignore
        from scipy.signal import resample

        signals, _, _ = bdf_reader.read_edf(meta["bdf_path"],
                                            ch_names=["EXG1", "EXG2", "EXG3", "Status"])
        candidates = []
        for ch in range(3):
            try:
                data = signals[ch][hr_offset: hr_offset + hr_samples]
                data = hp.filter_signal(data, cutoff=0.05,
                                        sample_rate=meta["session_hr_sample_freq"],
                                        filtertype="notch")
                data = (data - data.min()) / (data.max() - data.min()) * 3.4
                data = resample(data, len(data) * 4)
                _, measures = hp.process(hp.scale_data(data),
                                         meta["session_hr_sample_freq"] * 4)
                if not 41 <= measures["bpm"] <= 180:
                    continue
                if any(isinstance(v, float) and math.isnan(v) for v in measures.values()):
                    continue
                candidates.append(measures)
            except Exception:
                continue
        if not candidates:
            raise RuntimeError("Unable to process the ECG data")
        return sorted(candidates, key=lambda m: m["sdnn"])[0]["bpm"]

    def __getitem__(self, idx):
        result = self.get_dict(idx)
        return result["frames"], result["label"], result["mask"], self.index

    def collate_fn(self, batch):
        """The six-field batch (comps "raw", speed 1; the reference has no
        collate for RPPG)."""
        frames, label, mask, index = list(zip(*batch))
        n = len(frames)
        return [
            np.stack(frames),
            np.stack(label) if np.ndim(label[0]) else np.asarray(label, np.float32),
            np.stack(mask),
            ["raw"] * n,
            np.ones((n,), np.float32),
            np.asarray(index, np.int64),
        ]
