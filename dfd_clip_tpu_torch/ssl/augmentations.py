"""DINO multi-crop augmentation, host-side numpy / cv2 (the port's copy of
dfd_clip_tpu/ssl/augmentations.py; dinov2/data/augmentations.py:20-118):
two global crops (random-resized crop + flip + color jitter + blur /
solarize) and N local crops, normalized to ImageNet statistics, as CHW
float32 arrays. The same generator state gives the JAX package's crops byte
for byte. cv2 is imported by the functions that use it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _random_resized_crop(img: np.ndarray, size: int, scale, rng) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x = rng.integers(0, w - cw + 1)
            y = rng.integers(0, h - ch + 1)
            crop = img[y : y + ch, x : x + cw]
            return cv2.resize(crop, (size, size), interpolation=cv2.INTER_CUBIC)
    side = min(h, w)
    y, x = (h - side) // 2, (w - side) // 2
    return cv2.resize(img[y : y + side, x : x + side], (size, size),
                      interpolation=cv2.INTER_CUBIC)


def _color_jitter(img: np.ndarray, rng) -> np.ndarray:
    if rng.random() < 0.8:
        f = img.astype(np.float32)
        f = f * rng.uniform(0.6, 1.4)                       # brightness
        mean = f.mean(axis=(0, 1), keepdims=True)
        f = (f - mean) * rng.uniform(0.6, 1.4) + mean       # contrast
        gray = f.mean(axis=2, keepdims=True)
        f = (f - gray) * rng.uniform(0.6, 1.4) + gray       # saturation
        img = np.clip(f, 0, 255).astype(np.uint8)
    if rng.random() < 0.2:  # grayscale
        g = img.mean(axis=2, keepdims=True).astype(np.uint8)
        img = np.repeat(g, 3, axis=2)
    return img


def _gaussian_blur(img: np.ndarray, rng, p: float) -> np.ndarray:
    import cv2

    if rng.random() < p:
        sigma = rng.uniform(0.1, 2.0)
        img = cv2.GaussianBlur(img, (0, 0), sigma)
    return img


def _solarize(img: np.ndarray, rng, p: float) -> np.ndarray:
    if rng.random() < p:
        img = np.where(img >= 128, 255 - img, img).astype(np.uint8)
    return img


def _normalize_chw(img: np.ndarray) -> np.ndarray:
    f = img.astype(np.float32) / 255.0
    f = (f - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(f.transpose(2, 0, 1))


class MultiCropAugmentation:
    def __init__(self, global_size: int = 224, local_size: int = 96,
                 n_local: int = 8, global_scale=(0.32, 1.0),
                 local_scale=(0.05, 0.32)):
        self.global_size = global_size
        self.local_size = local_size
        self.n_local = n_local
        self.global_scale = global_scale
        self.local_scale = local_scale

    def __call__(self, img_rgb: np.ndarray, rng: np.random.Generator
                 ) -> Dict[str, List[np.ndarray]]:
        def flip(i):
            return i[:, ::-1] if rng.random() < 0.5 else i

        g1 = _color_jitter(flip(_random_resized_crop(
            img_rgb, self.global_size, self.global_scale, rng)), rng)
        g1 = _gaussian_blur(g1, rng, 1.0)
        g2 = _color_jitter(flip(_random_resized_crop(
            img_rgb, self.global_size, self.global_scale, rng)), rng)
        g2 = _solarize(_gaussian_blur(g2, rng, 0.1), rng, 0.2)
        locals_ = []
        for _ in range(self.n_local):
            lc = _color_jitter(flip(_random_resized_crop(
                img_rgb, self.local_size, self.local_scale, rng)), rng)
            lc = _gaussian_blur(lc, rng, 0.5)
            locals_.append(_normalize_chw(lc))
        return {
            "global": [_normalize_chw(g1), _normalize_chw(g2)],
            "local": locals_,
        }
