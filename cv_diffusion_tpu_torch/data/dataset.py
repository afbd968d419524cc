"""Low-light datasets, the epoch batch loader and ``create_dataloaders``, in
numpy.

Counterpart of ``cv_diffusion_tpu/data/dataset.py``:

* :class:`LowLightDataset`: LOL-style paired ``root/{low,high}/`` images,
  with the same directory probing, sorted file lists, count-mismatch
  truncation, ``paired=False`` re-pairing and error messages;
* :class:`SyntheticLowLightDataset`: the synthetic degradation of
  normal-light images, from a directory as in JAX, or (the port's own form)
  from a uint8 array [N, H, W, 3];
* :class:`DataLoader` and :func:`create_dataloaders`, which routes each
  split to the Python, native (``data/native.py``) or device-cache
  (``data/device_cache.py``) loader as the JAX function does.

Files are decoded by ``data/png.py`` (PNG and BMP; JPEG only through the
native loader), where the JAX package uses Pillow.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from . import augment
from .png import read_image

EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_directory_structure(path: Path, max_depth: int = 2,
                              current_depth: int = 0) -> str:
    """Directory tree dump for error messages."""
    if current_depth >= max_depth:
        return ""
    lines: List[str] = []
    try:
        items = sorted(path.iterdir())
        for item in items[:10]:
            if item.is_dir():
                lines.append(f"  {item.name}/")
                if current_depth < max_depth - 1:
                    sub = _list_directory_structure(item, max_depth,
                                                    current_depth + 1)
                    lines.extend(f"    {s}" for s in sub.split("\n") if s.strip())
            else:
                lines.append(f"  {item.name}")
        if len(items) > 10:
            lines.append(f"  ... ({len(items) - 10} more items)")
    except OSError as e:
        lines.append(f"  (Error listing: {e})")
    return "\n".join(lines)


class LowLightDataset:
    """Paired low/normal-light images of a LOL-style directory."""

    def __init__(self, root: str, low_dir: str = "low",
                 high_dir: str = "high", image_size: int = 256,
                 augment_data: bool = True,
                 extensions: Tuple[str, ...] = EXTENSIONS,
                 paired: bool = True, seed: int = 0):
        self.root = Path(root)
        self.image_size = image_size
        self.augment = augment_data
        self.paired = paired
        self._rng = np.random.default_rng(seed)

        if not self.root.exists():
            raise FileNotFoundError(
                f"Dataset root directory not found: {self.root}\n"
                f"Expected structure: {self.root}/{{{low_dir},{high_dir}}}/*.png")

        # LOL directory-name probing, each side on its own
        low_path = self.root / low_dir
        high_path = self.root / high_dir
        if not low_path.exists():
            for alt in (low_dir, "low", "lowlight", "dark"):
                if (self.root / alt).exists():
                    low_path = self.root / alt
                    break
        if not high_path.exists():
            for alt in (high_dir, "high", "normal", "bright"):
                if (self.root / alt).exists():
                    high_path = self.root / alt
                    break
        for name, p, tried in (("Low", low_path, ["low", "lowlight", "dark"]),
                               ("High", high_path,
                                ["high", "normal", "bright"])):
            if not p.exists():
                raise FileNotFoundError(
                    f"{name}-light images directory not found: {p}\n"
                    f"Tried: {[str(self.root / d) for d in tried]}\n"
                    f"Current directory structure:\n"
                    f"{_list_directory_structure(self.root)}")

        self.low_images = sorted(
            f for f in low_path.iterdir()
            if f.is_file() and f.suffix.lower() in extensions)
        self.high_images = sorted(
            f for f in high_path.iterdir()
            if f.is_file() and f.suffix.lower() in extensions)
        if not self.low_images:
            raise ValueError(f"No images found in {low_path}\n"
                             f"Supported extensions: {extensions}")
        if not self.high_images:
            raise ValueError(f"No images found in {high_path}\n"
                             f"Supported extensions: {extensions}")
        if paired and len(self.low_images) != len(self.high_images):
            n = min(len(self.low_images), len(self.high_images))
            print(f"Warning: Image count mismatch: {len(self.low_images)} low "
                  f"vs {len(self.high_images)} high; using minimum: {n}")
            self.low_images = self.low_images[:n]
            self.high_images = self.high_images[:n]

    def __len__(self) -> int:
        return len(self.low_images)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        low = read_image(self.low_images[idx])
        if self.paired:
            high = read_image(self.high_images[idx])
        else:
            hi_idx = int(self._rng.integers(len(self.high_images)))
            high = read_image(self.high_images[hi_idx])

        if self.augment:
            low, high = augment.paired_train_transform(
                self._rng, low, high, self.image_size)
        else:
            low, high = augment.paired_eval_transform(
                low, high, self.image_size)
        return {"low_light": low, "normal_light": high,
                "filename": self.low_images[idx].name}


class SyntheticLowLightDataset:
    """Synthetic (low, normal) pairs from normal-light images: a random
    crop, a horizontal flip with probability 0.5, then the synthetic
    degradation, all from one ``np.random.Generator``.

    ``root`` is a directory of images (its ``.png``/``.jpg``/``.jpeg``
    files, sorted, as in JAX) or a uint8 array [N, H, W, 3] of the images
    themselves; ``images`` is the file list or the array."""

    def __init__(self, root: Union[str, Path, np.ndarray],
                 image_size: int = 256,
                 gamma_range: Tuple[float, float] = (2.0, 5.0),
                 noise_level_range: Tuple[float, float] = (0.01, 0.05),
                 extensions: Tuple[str, ...] = (".png", ".jpg", ".jpeg"),
                 seed: int = 0):
        self.image_size = image_size
        self.gamma_range = gamma_range
        self.noise_level_range = noise_level_range
        self._rng = np.random.default_rng(seed)
        if isinstance(root, (str, Path)):
            self.root = Path(root)
            if not self.root.is_dir():
                raise ValueError(f"Image directory not found: {self.root}")
            self.images = sorted(
                f for f in self.root.iterdir()
                if f.is_file() and f.suffix.lower() in extensions)
            if not self.images:
                raise ValueError(f"No images found in {self.root}\n"
                                 f"Supported extensions: {extensions}")
            return
        images = np.asarray(root)
        if images.ndim != 4 or images.shape[-1] != 3 or images.dtype != np.uint8:
            raise ValueError("images must be uint8 [N, H, W, 3], got "
                             f"{images.dtype} {images.shape}")
        if len(images) == 0:
            raise ValueError("no images")
        self.root = None
        self.images = images

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.root is None:
            normal, name = self.images[idx], f"{idx:05d}"
        else:
            normal, name = read_image(self.images[idx]), self.images[idx].name
        top, left = augment.random_crop_coords(
            self._rng, normal.shape[0], normal.shape[1], self.image_size)
        normal = augment.crop(normal, top, left, self.image_size)
        if self._rng.random() < 0.5:
            normal = normal[:, ::-1]
        low = augment.synthetic_low_light(
            self._rng, normal, self.gamma_range, self.noise_level_range)
        return {"low_light": augment.normalize(low),
                "normal_light": augment.normalize(normal),
                "filename": name}


def shard_files_by_process(files: List, process_id: int,
                           num_processes: int) -> List:
    """Strided per-process shard of a file list, truncated to equal length
    so that every process runs the same number of steps an epoch."""
    if num_processes <= 1:
        return list(files)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    n_per = len(files) // num_processes
    if n_per == 0:
        raise ValueError(f"cannot shard {len(files)} files across "
                         f"{num_processes} processes")
    return list(files)[process_id::num_processes][:n_per]


def num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    """The one ``len()`` formula of every loader."""
    if drop_last:
        return n // batch_size
    return (n + batch_size - 1) // batch_size


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool, drop_last: bool) -> Iterator[np.ndarray]:
    """Per-batch index arrays of one epoch: the one shuffle and drop_last
    of every loader."""
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
    ``{"low_light", "normal_light", "filenames"}``: per-epoch shuffle,
    ``drop_last`` for the train split, stable order for eval."""

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
            yield {
                "low_light": np.stack([it["low_light"] for it in items]),
                "normal_light": np.stack([it["normal_light"] for it in items]),
                "filenames": [it["filename"] for it in items],
            }


def _process_layout(shard_by_process: Optional[bool]) -> Tuple[bool, int, int]:
    """(shard?, processes, this process) from ``torch.distributed``; the
    port trains in one process, so a group of more than one is refused."""
    import torch.distributed as dist

    n_procs, pid = 1, 0
    if dist.is_available() and dist.is_initialized():
        n_procs, pid = dist.get_world_size(), dist.get_rank()
    if n_procs > 1 and shard_by_process is not False:
        raise NotImplementedError(
            f"create_dataloaders in a process group of {n_procs}: training "
            "over more than one process is not ported (ROADMAP queue 1 "
            "item 8)")
    return bool(shard_by_process), n_procs, pid


def create_dataloaders(train_root: str, val_root: Optional[str] = None,
                       batch_size: int = 8, image_size: int = 256,
                       use_synthetic: bool = False, seed: int = 0,
                       native: Optional[bool] = None, prefetch: int = 2,
                       num_threads: int = 0,
                       shard_by_process: Optional[bool] = None,
                       device_cache: bool = False, device="cuda",
                       **dataset_kwargs):
    """Train and optional val loaders, routed as the JAX function routes
    them:

    * ``native=None`` takes the C++ loader (``data/native.py``) when its
      library builds here and the Python loader otherwise; ``False`` forces
      Python; ``True`` requires the library and raises where it is absent.
      A split with a ``.bmp`` file or ``paired=False`` uses the Python loader
      (and raises under ``native=True``).
    * ``device_cache=True`` replaces the TRAIN loader with a
      :class:`~.device_cache.DeviceCacheLoader` on ``device``; the val
      loader stays on the host.
    * ``prefetch`` > 0 wraps the host loaders in a
      :class:`~.prefetch.PrefetchLoader`.
    * ``shard_by_process`` shards the train files over the processes of
      an initialised ``torch.distributed`` group: one process is all the
      port trains in, so a larger group raises.
    * ``dataset_kwargs`` go to the dataset constructor(s) that take them;
      a name that neither takes is a ``TypeError``.
    """
    from .native import (NativeDataLoader, NativeSyntheticDataLoader,
                         native_available, native_unavailable_reason)
    from .prefetch import PrefetchLoader

    use_native = native_available() if native is None else native
    if use_native and not native_available():
        raise RuntimeError(f"native loader requested but unavailable: "
                           f"{native_unavailable_reason()}")

    def _kwargs_for(cls):
        accepted = inspect.signature(cls.__init__).parameters
        return {k: v for k, v in dataset_kwargs.items() if k in accepted}

    _known = (set(inspect.signature(LowLightDataset.__init__).parameters) |
              set(inspect.signature(
                  SyntheticLowLightDataset.__init__).parameters))
    _unknown = set(dataset_kwargs) - _known
    if _unknown:
        raise TypeError(f"create_dataloaders: unknown dataset kwargs "
                        f"{sorted(_unknown)}")

    # The C++ pipeline decodes PNG/JPEG only and always pairs by index
    def _native_for(paths, paired_ok=True):
        reason = None
        if not paired_ok:
            reason = "paired=False (random high-image pairing)"
        elif not all(Path(p).suffix.lower() in (".png", ".jpg", ".jpeg")
                     for p in paths):
            reason = "non-PNG/JPEG files present"
        if reason is None:
            return use_native
        if native:
            raise RuntimeError(f"native loader requested but unsupported "
                               f"here: {reason}")
        if use_native:
            print(f"Note: using the Python loader ({reason})")
        return False

    do_shard, n_procs, pid = _process_layout(shard_by_process)
    paired = dataset_kwargs.get("paired", True)

    if use_synthetic:
        train_ds = SyntheticLowLightDataset(train_root, image_size=image_size,
                                            seed=seed,
                                            **_kwargs_for(
                                                SyntheticLowLightDataset))
        if do_shard:
            train_ds.images = shard_files_by_process(train_ds.images, pid,
                                                     n_procs)
        if device_cache:
            from .device_cache import DeviceCacheLoader
            train_loader = DeviceCacheLoader(
                [str(p) for p in train_ds.images], None, image_size,
                batch_size, shuffle=True, drop_last=True,
                gamma_range=train_ds.gamma_range,
                noise_level_range=train_ds.noise_level_range, seed=seed,
                device=device)
        elif _native_for(train_ds.images):
            train_loader = NativeSyntheticDataLoader(
                [str(p) for p in train_ds.images], image_size, batch_size,
                shuffle=True, drop_last=True,
                gamma_range=train_ds.gamma_range,
                noise_level_range=train_ds.noise_level_range, seed=seed,
                num_threads=num_threads)
        else:
            train_loader = DataLoader(train_ds, batch_size, shuffle=True,
                                      drop_last=True, seed=seed)
    else:
        train_ds = LowLightDataset(train_root, image_size=image_size,
                                   augment_data=True, seed=seed,
                                   **_kwargs_for(LowLightDataset))
        if do_shard:
            train_ds.low_images = shard_files_by_process(
                train_ds.low_images, pid, n_procs)
            train_ds.high_images = shard_files_by_process(
                train_ds.high_images, pid, n_procs)
        if device_cache:
            if not paired:
                raise ValueError("device_cache requires paired=True "
                                 "(random re-pairing happens per epoch on "
                                 "the host)")
            from .device_cache import DeviceCacheLoader
            train_loader = DeviceCacheLoader(
                [str(p) for p in train_ds.low_images],
                [str(p) for p in train_ds.high_images],
                image_size, batch_size, shuffle=True, drop_last=True,
                augment=True, seed=seed, device=device)
        elif _native_for(train_ds.low_images + train_ds.high_images,
                         paired_ok=paired):
            train_loader = NativeDataLoader(
                [str(p) for p in train_ds.low_images],
                [str(p) for p in train_ds.high_images],
                image_size, batch_size, shuffle=True, drop_last=True,
                augment=True, seed=seed, num_threads=num_threads)
        else:
            train_loader = DataLoader(train_ds, batch_size, shuffle=True,
                                      drop_last=True, seed=seed)

    val_loader = None
    if val_root is not None:
        val_ds = LowLightDataset(val_root, image_size=image_size,
                                 augment_data=False, seed=seed,
                                 **_kwargs_for(LowLightDataset))
        if _native_for(val_ds.low_images + val_ds.high_images,
                       paired_ok=paired):
            val_loader = NativeDataLoader(
                [str(p) for p in val_ds.low_images],
                [str(p) for p in val_ds.high_images],
                image_size, batch_size, shuffle=False, augment=False,
                seed=seed, num_threads=num_threads)
        else:
            val_loader = DataLoader(val_ds, batch_size, shuffle=False)

    if prefetch > 0:
        # the device cache's work is already queued on the device
        if not device_cache:
            train_loader = PrefetchLoader(train_loader, prefetch)
        if val_loader is not None:
            val_loader = PrefetchLoader(val_loader, prefetch)
    return train_loader, val_loader
