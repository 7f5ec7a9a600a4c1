"""Replayable host-side augmentation (the port's own copy of
dfd_clip_tpu/data/augment.py).

First-party replacement for the reference's albumentations ReplayCompose
pipelines (the reference's src/datasets.py:288-418): parameters are sampled
once into a ``replay`` record and applied identically to every frame of a
clip and to both members of a raw/c23 pair -- the property the training
recipe depends on. From the same ``np.random.Generator`` on the same uint8
frames it gives the JAX package's bytes.

Ops operate on HWC uint8 numpy frames. The compositions mirror the
reference's "normal" (sequence-level) and "frame" (low-magnitude per-frame)
pipelines plus the dev-mode force-* ablations and the ssl_fake
ElasticTransform forgery. ``cv2`` (and scipy for the elastic warp) is
imported inside the ops that need it, so importing the port needs neither.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Op:
    name = "op"

    def __init__(self, p: float = 1.0):
        self.p = p

    def sample(self, rng: np.random.Generator) -> Optional[Dict[str, Any]]:
        """None = inactive this draw."""
        if rng.random() >= self.p:
            return None
        return self._sample_params(rng)

    def _sample_params(self, rng) -> Dict[str, Any]:
        return {}

    def apply(self, img: np.ndarray, params: Dict[str, Any]) -> np.ndarray:
        raise NotImplementedError


class RGBShift(Op):
    name = "rgb_shift"

    def __init__(self, limit: float = 20, p: float = 0.3):
        super().__init__(p)
        self.limit = limit

    def _sample_params(self, rng):
        return {"shift": rng.uniform(-self.limit, self.limit, size=3)}

    def apply(self, img, params):
        out = img.astype(np.float32) + params["shift"][None, None, :]
        return np.clip(out, 0, 255).astype(np.uint8)


class HueSaturationValue(Op):
    name = "hsv"

    def __init__(self, hue_limit=0.3, sat_limit=0.3, val_limit=0.3, p: float = 0.3):
        super().__init__(p)
        self.limits = (hue_limit, sat_limit, val_limit)

    def _sample_params(self, rng):
        h, s, v = self.limits
        return {
            "hue": rng.uniform(-h, h),
            "sat": rng.uniform(-s, s),
            "val": rng.uniform(-v, v),
        }

    def apply(self, img, params):
        import cv2

        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = np.mod(hsv[..., 0] + params["hue"], 180.0)
        hsv[..., 1] = np.clip(hsv[..., 1] + params["sat"], 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + params["val"], 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class RandomBrightnessContrast(Op):
    name = "brightness_contrast"

    def __init__(self, brightness_limit=0.3, contrast_limit=0.3, p: float = 0.3):
        super().__init__(p)
        self.b = brightness_limit
        self.c = contrast_limit

    def _sample_params(self, rng):
        return {
            "alpha": 1.0 + rng.uniform(-self.c, self.c),
            "beta": rng.uniform(-self.b, self.b),
        }

    def apply(self, img, params):
        out = img.astype(np.float32) * params["alpha"] + params["beta"] * 255.0
        return np.clip(out, 0, 255).astype(np.uint8)


class ImageCompression(Op):
    name = "jpeg"

    def __init__(self, quality_lower=40, quality_upper=100, p: float = 0.5):
        super().__init__(p)
        self.lo, self.hi = quality_lower, quality_upper

    def _sample_params(self, rng):
        return {"quality": int(rng.integers(self.lo, self.hi + 1))}

    def apply(self, img, params):
        import cv2

        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, params["quality"]])
        if not ok:
            return img
        return cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]


class RandomDownScale(Op):
    """Downscale-then-restore quality degradation (reference
    src/datasets.py:196-224 — defined there but disabled in the default
    pipeline; available here for ablations)."""

    name = "downscale"

    def __init__(self, ratio_list=(2, 2), p: float = 0.3):
        super().__init__(p)
        self.ratio_list = list(ratio_list)

    def _sample_params(self, rng):
        return {"ratio": float(self.ratio_list[int(rng.integers(0, len(self.ratio_list)))])}

    def apply(self, img, params):
        import cv2

        h, w = img.shape[:2]
        r = params["ratio"]
        small = cv2.resize(img, (int(w / r), int(h / r)), interpolation=cv2.INTER_NEAREST)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


class HorizontalFlip(Op):
    name = "hflip"

    def __init__(self, p: float = 0.5):
        super().__init__(p)

    def apply(self, img, params):
        return img[:, ::-1]


class ElasticTransform(Op):
    """Elastic warp — the ssl_fake forgery op (src/datasets.py:401-418)."""

    name = "elastic"

    def __init__(self, alpha: float = 50.0, sigma: float = 6.0, p: float = 1.0):
        super().__init__(p)
        self.alpha = alpha
        self.sigma = sigma

    def _sample_params(self, rng):
        return {"seed": int(rng.integers(0, 2**31 - 1))}

    def apply(self, img, params):
        import cv2
        from scipy.ndimage import gaussian_filter

        h, w = img.shape[:2]
        r = np.random.default_rng(params["seed"])
        dx = gaussian_filter(r.uniform(-1, 1, (h, w)), self.sigma) * self.alpha
        dy = gaussian_filter(r.uniform(-1, 1, (h, w)), self.sigma) * self.alpha
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        map_x = (x + dx).astype(np.float32)
        map_y = (y + dy).astype(np.float32)
        return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT_101)


class Compose:
    """Replayable composition: sample() -> replay; apply(img, replay)."""

    def __init__(self, ops: Sequence[Op]):
        self.ops = list(ops)

    def sample(self, rng: np.random.Generator) -> List[Optional[Dict[str, Any]]]:
        return [op.sample(rng) for op in self.ops]

    def apply(self, img: np.ndarray, replay: List[Optional[Dict[str, Any]]]) -> np.ndarray:
        for op, params in zip(self.ops, replay):
            if params is not None:
                img = op.apply(img, params)
        return img


# -- the reference pipelines (src/datasets.py:288-418) --------------------------

def sequence_pipeline() -> Compose:
    return Compose([
        RGBShift(20, p=0.3),
        HueSaturationValue(0.3, 0.3, 0.3, p=0.3),
        RandomBrightnessContrast(0.3, 0.3, p=0.3),
        ImageCompression(40, 100, p=0.5),
        HorizontalFlip(p=0.5),
    ])


def frame_pipeline() -> Compose:
    return Compose([
        RGBShift(5, p=0.3),
        HueSaturationValue(0.05, 0.05, 0.05, p=0.3),
        RandomBrightnessContrast(0.05, 0.05, p=0.3),
        ImageCompression(80, 100, p=0.5),
    ])


def force_pipeline(kind: str) -> Compose:
    if kind == "force-rgb":
        return Compose([RGBShift(20, p=1.0)])
    if kind == "force-hue":
        return Compose([HueSaturationValue(0.3, 0.3, 0.3, p=1.0)])
    if kind == "force-bright":
        return Compose([RandomBrightnessContrast(0.3, 0.3, p=1.0)])
    raise NotImplementedError(kind)


def ssl_fake_pipeline() -> Compose:
    return Compose([ElasticTransform(alpha=50, sigma=6, p=1.0)])


class ClipAugmenter:
    """Frame + sequence augmentation with cross-compression replay
    (reference driver, src/datasets.py:368-399)."""

    def __init__(self, spec: str):
        parts = spec.split("+") if spec and spec != "none" else []
        self.sequence = None
        self.frame = None
        if "dev-mode" in parts:
            forced = [p for p in parts if p.startswith("force-")]
            if forced:
                self.sequence = force_pipeline(forced[0])
        else:
            if "normal" in parts:
                self.sequence = sequence_pipeline()
            if "frame" in parts:
                self.frame = frame_pipeline()
        if parts and self.sequence is None and self.frame is None:
            raise NotImplementedError(f"augmentation spec: {spec}")

    def __call__(self, frames: np.ndarray, replay: Dict[str, Any], rng: np.random.Generator):
        """frames: (T, H, W, 3) uint8. Mutates/extends ``replay`` so the same
        transforms replay across a raw/c23 pair."""
        frames = list(frames)
        if self.frame is not None:
            if "frame" in replay:
                assert len(replay["frame"]) == len(frames)
            else:
                replay["frame"] = [self.frame.sample(rng) for _ in frames]
            frames = [self.frame.apply(f, r) for f, r in zip(frames, replay["frame"])]
        if self.sequence is not None:
            if "video" not in replay:
                replay["video"] = self.sequence.sample(rng)
            frames = [self.sequence.apply(f, replay["video"]) for f in frames]
        return np.stack(frames), replay
