"""Synthetic low-light dataset and the epoch batch loader, in numpy.

Counterpart of ``cv_diffusion_tpu/data/dataset.py:143-250``. The synthetic
dataset takes its normal-light images as a uint8 array [N, H, W, 3] instead
of a directory of image files (the port reads no image files); everything
else is the JAX dataset's: random crop, horizontal flip with probability
0.5, then the synthetic degradation, all from one ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from . import augment


class SyntheticLowLightDataset:
    """Synthetic (low, normal) pairs from normal-light uint8 images."""

    def __init__(self, images: np.ndarray, image_size: int = 256,
                 gamma_range: Tuple[float, float] = (2.0, 5.0),
                 noise_level_range: Tuple[float, float] = (0.01, 0.05),
                 seed: int = 0):
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3 or images.dtype != np.uint8:
            raise ValueError("images must be uint8 [N, H, W, 3], got "
                             f"{images.dtype} {images.shape}")
        if len(images) == 0:
            raise ValueError("no images")
        self.images = images
        self.image_size = image_size
        self.gamma_range = gamma_range
        self.noise_level_range = noise_level_range
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        normal = self.images[idx]
        top, left = augment.random_crop_coords(
            self._rng, normal.shape[0], normal.shape[1], self.image_size)
        normal = augment.crop(normal, top, left, self.image_size)
        if self._rng.random() < 0.5:
            normal = normal[:, ::-1]
        low = augment.synthetic_low_light(
            self._rng, normal, self.gamma_range, self.noise_level_range)
        return {"low_light": augment.normalize(low),
                "normal_light": augment.normalize(normal)}


def num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    if drop_last:
        return n // batch_size
    return (n + batch_size - 1) // batch_size


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool, drop_last: bool) -> Iterator[np.ndarray]:
    """Per-batch index arrays of one epoch."""
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, n, batch_size):
        idxs = order[start:start + batch_size]
        if drop_last and len(idxs) < batch_size:
            return
        yield idxs


class DataLoader:
    """Epoch iterator of stacked NHWC float32 [-1, 1] batches
    ``{"low_light", "normal_light"}``: per-epoch shuffle, ``drop_last`` for
    the train split, stable order for eval."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return num_batches(len(self.dataset), self.batch_size, self.drop_last)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for idxs in epoch_batches(len(self.dataset), self.batch_size,
                                  self._rng, self.shuffle, self.drop_last):
            items = [self.dataset[int(i)] for i in idxs]
            yield {key: np.stack([it[key] for it in items])
                   for key in ("low_light", "normal_light")}
