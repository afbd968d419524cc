"""Paired image augmentation, crops, normalisation and the synthetic
low-light degradation, in numpy.

A copy of ``cv_diffusion_tpu/data/augment.py`` without cv2: the same
geometric transform is applied to both images of a pair, then both are
normalised to [-1, 1].

Train: RandomCrop(size) p=1 → HFlip p=.5 → VFlip p=.3 → Rotate(±15°) p=.3.
Eval:  CenterCrop(size).

:func:`rotate` is cv2's ``warpAffine`` convention (centre (w/2 − 0.5,
h/2 − 0.5), inverse map, bilinear, reflect-101 borders) computed in double
precision by the formula of ``native/dataloader.cc``'s ``rotate_u8``; cv2
rounds its map and weights to fixed point, so the two differ by at most 1
in the interior.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_crop_coords(rng: np.random.Generator, h: int, w: int,
                       size: int) -> Tuple[int, int]:
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return top, left


def center_crop_coords(h: int, w: int, size: int) -> Tuple[int, int]:
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    return (h - size) // 2, (w - size) // 2


def crop(img: np.ndarray, top: int, left: int, size: int) -> np.ndarray:
    return img[top:top + size, left:left + size]


def reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT_101 index folding."""
    period = 2 * n - 2 if n > 1 else 1
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate a uint8 [H, W, C] image by ``angle`` degrees about its centre:
    bilinear, reflect-101 borders, rounded half up."""
    h, w = img.shape[:2]
    a = angle * np.pi / 180.0
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    dy, dx = np.meshgrid(np.arange(h) - cy, np.arange(w) - cx, indexing="ij")
    sx = ca * dx - sa * dy + cx          # inverse map: dst → src
    sy = sa * dx + ca * dy + cy
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0r, x1r = reflect101(x0, w), reflect101(x0 + 1, w)
    y0r, y1r = reflect101(y0, h), reflect101(y0 + 1, h)
    src = img.astype(np.float64)
    v = (src[y0r, x0r] * (1 - fx) * (1 - fy) + src[y0r, x1r] * fx * (1 - fy)
         + src[y1r, x0r] * (1 - fx) * fy + src[y1r, x1r] * fx * fy)
    return np.floor(np.clip(v, 0.0, 255.0) + 0.5).astype(np.uint8)


def normalize(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [-1, 1] (Normalize(mean=.5, std=.5))."""
    return (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def paired_train_transform(rng: np.random.Generator, low: np.ndarray,
                           high: np.ndarray, size: int,
                           hflip_p: float = 0.5, vflip_p: float = 0.3,
                           rotate_p: float = 0.3,
                           rotate_limit: float = 15.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One geometric transform drawn from ``rng`` applied to both images,
    then normalised; pairs that differ in size are cut to the common area."""
    h, w = low.shape[:2]
    if high.shape[:2] != (h, w):
        h = min(h, high.shape[0])
        w = min(w, high.shape[1])
        low, high = low[:h, :w], high[:h, :w]

    top, left = random_crop_coords(rng, h, w, size)
    low = crop(low, top, left, size)
    high = crop(high, top, left, size)

    if rng.random() < hflip_p:
        low, high = low[:, ::-1], high[:, ::-1]
    if rng.random() < vflip_p:
        low, high = low[::-1], high[::-1]
    if rng.random() < rotate_p:
        angle = float(rng.uniform(-rotate_limit, rotate_limit))
        low = rotate(low, angle)
        high = rotate(high, angle)

    return normalize(low), normalize(high)


def paired_eval_transform(low: np.ndarray, high: np.ndarray, size: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """CenterCrop of the common area + normalize."""
    h = min(low.shape[0], high.shape[0])
    w = min(low.shape[1], high.shape[1])
    low, high = low[:h, :w], high[:h, :w]
    top, left = center_crop_coords(h, w, size)
    return (normalize(crop(low, top, left, size)),
            normalize(crop(high, top, left, size)))


def synthetic_low_light(rng: np.random.Generator, image_u8: np.ndarray,
                        gamma_range: Tuple[float, float] = (2.0, 5.0),
                        noise_level_range: Tuple[float, float] = (0.01, 0.05),
                        color_shift_p: float = 0.5) -> np.ndarray:
    """Random gamma darkening, gaussian noise, and with probability
    ``color_shift_p`` a per-channel colour scale; uint8 in, uint8 out."""
    img = image_u8.astype(np.float32) / 255.0
    gamma = rng.uniform(*gamma_range)
    dark = np.power(img, gamma)
    noise_level = rng.uniform(*noise_level_range)
    noisy = np.clip(dark + rng.normal(0, noise_level, dark.shape), 0, 1)
    if rng.random() < color_shift_p:
        scale = rng.uniform(0.8, 1.0, size=3)
        noisy = np.clip(noisy * scale, 0, 1)
    return (noisy * 255).astype(np.uint8)
