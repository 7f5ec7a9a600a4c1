"""Dataset adapters + classification transforms for the SSL eval suite (the
port's copy of dfd_clip_tpu/ssl/data_adapters.py; dinov2/data/adapters.py
and dinov2/data/transforms.py): host numpy + cv2 (imported by the functions
that use it), used by the eval feature-extraction path so enumerated /
ragged eval splits behave like the reference's.

* ``DatasetWithEnumeratedTargets`` — wraps any indexable dataset of
  (image, target) pairs so each sample returns (image, (index, target)):
  the index lets a distributed extraction scatter features into a global
  array regardless of shard order, and a None target becomes the index
  (reference adapters.py:12-28).
* ``make_classification_eval_transform`` / ``make_classification_train_
  transform`` — the torchvision presets re-done as host numpy functions
  (resize-shorter-side + center crop, or random-resized-crop + hflip),
  emitting CHW float32 normalized with the timm ImageNet constants
  (reference transforms.py:42-92).
* ``pad_and_collate`` — stacks a ragged final batch by repeating the last
  sample with label -1, the reference's _pad_and_collate
  (dinov2/eval/linear.py:36-42); metrics (evals.topk_accuracy) drop
  label<0 rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

# timm's constants, as the reference uses (transforms.py:42-44)
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


class DatasetWithEnumeratedTargets:
    """(image, target) dataset -> (image, (index, target)) dataset."""

    def __init__(self, dataset):
        self._dataset = dataset

    def get_image_data(self, index: int):
        return self._dataset.get_image_data(index)

    def get_target(self, index: int) -> Tuple[int, Any]:
        target = self._dataset.get_target(index)
        return (index, target)

    def __getitem__(self, index: int) -> Tuple[Any, Tuple[int, Any]]:
        image, target = self._dataset[index]
        target = index if target is None else target
        return image, (index, target)

    def __len__(self) -> int:
        return len(self._dataset)


def _to_chw_float(img: np.ndarray) -> np.ndarray:
    """HWC uint8 / float -> CHW float32 in [0, 1] (MaybeToTensor)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        return img  # already CHW
    return np.transpose(img, (2, 0, 1))


def make_normalize_transform(
    mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
    std: Sequence[float] = IMAGENET_DEFAULT_STD,
) -> Callable[[np.ndarray], np.ndarray]:
    mean_a = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std_a = np.asarray(std, np.float32).reshape(3, 1, 1)

    def normalize(chw: np.ndarray) -> np.ndarray:
        return (chw - mean_a) / std_a

    return normalize


def make_classification_eval_transform(
    *,
    resize_size: int = 256,
    crop_size: int = 224,
    mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
    std: Sequence[float] = IMAGENET_DEFAULT_STD,
) -> Callable[[np.ndarray], np.ndarray]:
    """Resize shorter side to resize_size (bicubic) + center crop + normalize
    (reference transforms.py:76-92). Input HWC uint8/float, output (3, S, S)
    float32."""
    import cv2

    normalize = make_normalize_transform(mean, std)

    def transform(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        h, w = img.shape[:2]
        scale = resize_size / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
        top = (nh - crop_size) // 2
        left = (nw - crop_size) // 2
        img = img[top : top + crop_size, left : left + crop_size]
        return normalize(_to_chw_float(img))

    return transform


def make_classification_train_transform(
    *,
    crop_size: int = 224,
    hflip_prob: float = 0.5,
    mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
    std: Sequence[float] = IMAGENET_DEFAULT_STD,
    rng: Optional[np.random.Generator] = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """RandomResizedCrop(scale 0.08-1.0, ratio 3/4-4/3, bicubic) + random
    hflip + normalize (reference transforms.py:56-73). Host randomness comes
    from the passed Generator."""
    import cv2

    rng = rng or np.random.default_rng(0)
    normalize = make_normalize_transform(mean, std)

    def transform(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(0.08, 1.0)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                crop = img[top : top + ch, left : left + cw]
                break
        else:  # torchvision's center-crop fallback
            s = min(h, w)
            top, left = (h - s) // 2, (w - s) // 2
            crop = img[top : top + s, left : left + s]
        crop = cv2.resize(crop, (crop_size, crop_size),
                          interpolation=cv2.INTER_CUBIC)
        if hflip_prob > 0 and rng.random() < hflip_prob:
            crop = crop[:, ::-1]
        return normalize(_to_chw_float(crop))

    return transform


def pad_and_collate(batch, batch_size: Optional[int] = None):
    """Stack (image, (index, label)) samples; pad a short batch by
    repeating the last sample with label -1 so every batch has one shape
    (reference _pad_and_collate, dinov2/eval/linear.py:36-42)."""
    images = [np.asarray(img) for img, _ in batch]
    idxs = [int(t[0]) for _, t in batch]
    labels = [int(t[1]) for _, t in batch]
    if batch_size is not None and len(batch) < batch_size:
        n_pad = batch_size - len(batch)
        images += [images[-1]] * n_pad
        idxs += [idxs[-1]] * n_pad
        labels += [-1] * n_pad
    return (np.stack(images), np.asarray(idxs, np.int64),
            np.asarray(labels, np.int64))
