"""Crops, normalisation and the synthetic low-light degradation, in numpy.

A copy of the numpy parts of ``cv_diffusion_tpu/data/augment.py:29-121``
(no cv2: the rotation augmentation of the paired LOL pipeline is not
ported).
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


def crop(img: np.ndarray, top: int, left: int, size: int) -> np.ndarray:
    return img[top:top + size, left:left + size]


def normalize(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [-1, 1] (Normalize(mean=.5, std=.5))."""
    return (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


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
