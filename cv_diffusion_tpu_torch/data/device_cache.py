"""Device-resident dataset cache: decode once, upload once, augment on the
device.

Counterpart of ``cv_diffusion_tpu/data/device_cache.py``. The host loaders
decode and augment every image every epoch and send float32 crops to the
device every step; for a dataset that fits in device memory (LOL's 485
training pairs of 400×600 take 698,400,000 bytes as uint8) this loader

* decodes every frame once on the host (``data/png.py``, sixteen files
  unfiltered together on each of several threads, or the native decoder
  where it is built) into one
  uint8 [N, H, W, 3] block, checking sizes on the host arrays;
* uploads each block once (uint8: a quarter of float32's bytes);
* assembles every batch on the device: gather of the crop windows by index
  (flips folded into the gather), normalisation (a 256-entry table of
  ``augment.normalize``, so bit for bit the host's), then the rotation
  (``device_augment.rotate_selected``) or the synthetic degradation.

The only host→device traffic of a batch is its index vector: the epoch's
order is drawn on the host (``dataset.epoch_batches``, as every loader) and
each batch's indices go up from pinned memory without a sync; every random
number of the augmentation is drawn on the device from a ``torch.Generator``
seeded ``(seed + epoch·1_000_003 + batch) & 0xFFFFFFFF``, the native
loaders' per-batch seed.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device_augment
from .augment import normalize as host_normalize
from .dataset import epoch_batches, num_batches
from .png import read_images


DECODE_CHUNK = 16       # files png.py unfilters together


def load_frames(paths: Sequence[str]) -> np.ndarray:
    """Decode ``paths`` to one uint8 [N, H, W, 3] block in host memory,
    with the native decoder where it is built (PNG, JPEG) and ``png.py``
    otherwise (``DECODE_CHUNK`` files unfiltered together, the chunks on up
    to eight threads). Raises if the frames differ in size."""
    from .native import decode_image, native_available

    if not paths:
        raise ValueError("no frames to cache")
    paths = [str(p) for p in paths]
    if native_available() and all(
            Path(p).suffix.lower() in (".png", ".jpg", ".jpeg") for p in paths):
        decoded = [decode_image(p) for p in paths]
    else:
        chunks = [paths[i:i + DECODE_CHUNK]
                  for i in range(0, len(paths), DECODE_CHUNK)]
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            decoded = [img for imgs in pool.map(read_images, chunks)
                       for img in imgs]
    frames: List[np.ndarray] = []
    for p, img in zip(paths, decoded):
        if frames and img.shape != frames[0].shape:
            raise ValueError(
                f"device cache needs uniform frame sizes: {paths[0]} is "
                f"{frames[0].shape}, {p} is {img.shape}; use a host loader "
                f"for mixed-size datasets")
        frames.append(img)
    return np.stack(frames)


class DeviceCacheLoader:
    """A DataLoader whose batches are assembled on the device.

    Yields ``{"low_light", "normal_light", "filenames"}`` like every other
    loader, the arrays float32 NHWC tensors on ``device``.

    Paired mode: ``low_paths`` + ``high_paths`` (index-aligned).
    Synthetic mode (``high_paths=None``): ``low_paths`` are normal-light
    frames, degraded on the device for each batch.
    """

    def __init__(self, low_paths: Sequence[str],
                 high_paths: Optional[Sequence[str]],
                 image_size: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, augment: bool = True,
                 gamma_range: Tuple[float, float] = (2.0, 5.0),
                 noise_level_range: Tuple[float, float] = (0.01, 0.05),
                 seed: int = 0, device="cuda"):
        self.synthetic = high_paths is None
        if not self.synthetic and len(low_paths) != len(high_paths):
            raise ValueError(f"low/high path count mismatch: "
                             f"{len(low_paths)} vs {len(high_paths)}")
        self.paths = [str(p) for p in low_paths]
        self.image_size = image_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.augment = augment
        self.gamma_range = tuple(gamma_range)
        self.noise_level_range = tuple(noise_level_range)
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._epoch = 0

        # every check on the host arrays, before the upload
        low_np = load_frames(self.paths)
        high_np = (None if self.synthetic
                   else load_frames([str(p) for p in high_paths]))
        frame_hw = low_np.shape[1:3]
        if min(frame_hw) < image_size:
            raise ValueError(f"frames {frame_hw} smaller than crop "
                             f"{image_size}")
        # paired crops take the same window from both blocks
        if high_np is not None and high_np.shape[1:3] != frame_hw:
            raise ValueError(
                f"paired device cache needs matching low/high frame sizes: "
                f"low {frame_hw}, high {high_np.shape[1:3]}; use a host "
                f"loader for mixed-resolution pairs")
        # normalisation as a 256-entry table made by the host's formula: a
        # CUDA division by a scalar multiplies by its reciprocal, which
        # differs from the host's float32 quotient in the last bit
        self._table = torch.from_numpy(
            host_normalize(np.arange(256, dtype=np.uint8))).to(self.device)
        self._low = torch.from_numpy(low_np).to(self.device)
        self._high = (None if high_np is None
                      else torch.from_numpy(high_np).to(self.device))
        self._names = [Path(p).name for p in self.paths]

    def nbytes(self) -> int:
        """Device memory held by the cache."""
        return sum(t.numel() * t.element_size()
                   for t in (self._low, self._high) if t is not None)

    def __len__(self) -> int:
        return num_batches(len(self.paths), self.batch_size, self.drop_last)

    def normalize(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 → float32 [-1, 1] on the device, bit for bit
        ``augment.normalize``."""
        return self._table[u8.long()]

    def _indices(self, idxs: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.asarray(idxs, np.int64))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def assemble(self, idxs: torch.Tensor, seed: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(low, normal) float32 [B, S, S, 3] of the cached frames ``idxs``
        (a tensor on the device), augmented from a generator seeded
        ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        _, h, w, _ = self._low.shape
        size = self.image_size
        b = idxs.shape[0]
        if self.augment:
            draws = device_augment.draw_paired(
                gen, b, h, w, size,
                **({"vflip_p": 0.0, "rotate_p": 0.0} if self.synthetic else {}))
        else:       # the eval path's centre crop
            zeros = torch.zeros(b, dtype=torch.long, device=self.device)
            no = torch.zeros(b, dtype=torch.bool, device=self.device)
            draws = {"tops": zeros + (h - size) // 2,
                     "lefts": zeros + (w - size) // 2, "hflip": no,
                     "vflip": no, "rotate": no,
                     "angles": torch.zeros(b, device=self.device)}

        def window(frames):
            crops = self.normalize(device_augment.crop_windows(frames, idxs,
                                                               draws, size))
            if self.augment and not self.synthetic:
                crops = device_augment.rotate_selected(crops, draws)
            return crops

        if self.synthetic:
            normal = window(self._low)
            low = device_augment.synthetic_low_light(
                gen, normal, self.gamma_range, self.noise_level_range)
            return low, normal
        return window(self._low), window(self._high)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self._epoch += 1
        for bi, idxs in enumerate(epoch_batches(
                len(self.paths), self.batch_size, self._rng, self.shuffle,
                self.drop_last)):
            seed = (self._seed + self._epoch * 1_000_003 + bi) & 0xFFFFFFFF
            low, high = self.assemble(self._indices(idxs), seed)
            yield {
                "low_light": low,
                "normal_light": high,
                "filenames": [self._names[i] for i in idxs],
            }
