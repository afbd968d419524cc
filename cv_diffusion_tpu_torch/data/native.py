"""ctypes bindings of the C++ data pipeline (``csrc/dataloader.cc``).

Counterpart of ``cv_diffusion_tpu/data/native.py``: a GIL-free threaded C++
library decodes PNG/JPEG with libpng/libjpeg, applies the paired
augmentation and fills NumPy batch buffers. The port builds its own copy of
the source at first use, with one ``g++`` call into the git-ignored
``_build/`` (``ops/cuda_build.py::build_host``). Where the compiler or the
libpng/libjpeg headers are missing the library is unavailable:
:func:`native_available` is False, :func:`native_unavailable_reason` says
why, and every entry point raises with that reason.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..ops import cuda_build

SOURCE = cuda_build.source("dataloader.cc")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_LIB = None
_REASON: Optional[str] = None


def _declare(lib) -> None:
    u8p, fp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.cvdm_version.restype = ctypes.c_int
    lib.cvdm_decode_image.restype = ctypes.c_int
    lib.cvdm_decode_image.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.cvdm_load_pair_batch.restype = ctypes.c_int
    lib.cvdm_load_pair_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, fp, fp, u8p]
    lib.cvdm_load_synth_batch.restype = ctypes.c_int
    lib.cvdm_load_synth_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, fp, fp, u8p]
    lib.cvdm_rotate_u8.restype = ctypes.c_int
    lib.cvdm_rotate_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, u8p]


def _load_lib():
    """The library, built at the first call; None (and the reason kept)
    where it cannot be built."""
    global _LIB, _REASON
    if _LIB is None and _REASON is None:
        try:
            lib = ctypes.CDLL(cuda_build.build_host(SOURCE, LIBS).path)
            _declare(lib)
            _LIB = lib
        except (RuntimeError, OSError) as e:
            lines = [ln for ln in str(e).splitlines() if "error" in ln]
            _REASON = (lines[0] if lines else str(e).splitlines()[0]).strip()
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def native_unavailable_reason() -> Optional[str]:
    """Why the library could not be built here, or None where it was."""
    _load_lib()
    return _REASON


def _require():
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"the native data loader is unavailable: {_REASON}")
    return lib


def _c_paths(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_image(path: str) -> np.ndarray:
    """Decode a PNG/JPEG to an RGB uint8 array with the native decoder."""
    lib = _require()
    h, w = ctypes.c_int(), ctypes.c_int()
    cap = 32 * 1024 * 1024
    buf = np.empty((cap,), dtype=np.uint8)
    rc = lib.cvdm_decode_image(str(path).encode(), _ptr(buf), cap,
                               ctypes.byref(h), ctypes.byref(w))
    if rc == -2:  # buffer too small: retry exactly sized
        cap = h.value * w.value * 3
        buf = np.empty((cap,), dtype=np.uint8)
        rc = lib.cvdm_decode_image(str(path).encode(), _ptr(buf), cap,
                                   ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native decode failed for {path}")
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def rotate_u8(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """The native centre rotation (bilinear, reflect-101)."""
    lib = _require()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    dst = np.empty_like(img)
    rc = lib.cvdm_rotate_u8(_ptr(img), h, w, float(angle_deg), _ptr(dst))
    if rc != 0:
        raise ValueError(f"native rotate failed (rc={rc})")
    return dst


def _threads(n: int, num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(n, os.cpu_count() or 1)


def load_pair_batch(low_paths: List[str], high_paths: List[str], size: int,
                    seed: int, augment: bool, num_threads: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and transform a paired batch in C++ threads.

    Returns (low [n,S,S,3] f32 in [-1,1], high, failed-mask [n] uint8).
    """
    lib = _require()
    n = len(low_paths)
    if len(high_paths) != n:
        raise ValueError(f"low/high path count mismatch: {n} vs "
                         f"{len(high_paths)}")
    out_low = np.empty((n, size, size, 3), dtype=np.float32)
    out_high = np.empty((n, size, size, 3), dtype=np.float32)
    failed = np.zeros((n,), dtype=np.uint8)
    lib.cvdm_load_pair_batch(
        _c_paths(low_paths), _c_paths(high_paths), n, size,
        ctypes.c_uint64(seed), int(augment), _threads(n, num_threads),
        _ptr(out_low, ctypes.c_float), _ptr(out_high, ctypes.c_float),
        _ptr(failed))
    return out_low, out_high, failed


def load_synth_batch(paths: List[str], size: int, seed: int,
                     gamma_range=(2.0, 5.0), noise_level_range=(0.01, 0.05),
                     num_threads: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A synthetic-degradation batch in C++ threads."""
    lib = _require()
    n = len(paths)
    out_low = np.empty((n, size, size, 3), dtype=np.float32)
    out_high = np.empty((n, size, size, 3), dtype=np.float32)
    failed = np.zeros((n,), dtype=np.uint8)
    lib.cvdm_load_synth_batch(
        _c_paths(paths), n, size, ctypes.c_uint64(seed),
        gamma_range[0], gamma_range[1], noise_level_range[0],
        noise_level_range[1], _threads(n, num_threads),
        _ptr(out_low, ctypes.c_float), _ptr(out_high, ctypes.c_float),
        _ptr(failed))
    return out_low, out_high, failed


class _NativeEpochLoader:
    """The epoch scaffolding of both native loaders: per-epoch shuffle by
    ``dataset.epoch_batches``, a decorrelated per-batch seed, and an error
    for any item that failed."""

    def __init__(self, batch_size: int, shuffle: bool, drop_last: bool,
                 seed: int, num_threads: int):
        _require()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._epoch = 0

    def _items(self) -> List[str]:
        raise NotImplementedError

    def _load_batch(self, idxs, seed: int):
        raise NotImplementedError

    def __len__(self) -> int:
        from .dataset import num_batches

        return num_batches(len(self._items()), self.batch_size,
                           self.drop_last)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from .dataset import epoch_batches

        self._epoch += 1
        items = self._items()
        for bi, idxs in enumerate(epoch_batches(
                len(items), self.batch_size, self._rng,
                self.shuffle, self.drop_last)):
            low, high, failed = self._load_batch(
                idxs, self._seed + self._epoch * 1_000_003 + bi)
            if failed.any():
                bad = [items[idxs[i]] for i in np.nonzero(failed)[0]]
                raise IOError(f"native loader failed on: {bad}")
            yield {
                "low_light": low,
                "normal_light": high,
                "filenames": [os.path.basename(items[i]) for i in idxs],
            }


class NativeDataLoader(_NativeEpochLoader):
    """The paired loader on the C++ pipeline: the iteration contract of
    ``data.dataset.DataLoader`` (per-epoch shuffle, drop_last, NHWC float32
    batches), decode and augmentation GIL-free."""

    def __init__(self, low_paths: List[str], high_paths: List[str],
                 image_size: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, augment: bool = True,
                 seed: int = 0, num_threads: int = 0):
        if len(low_paths) != len(high_paths):
            raise ValueError(f"low/high path count mismatch: "
                             f"{len(low_paths)} vs {len(high_paths)}")
        super().__init__(batch_size, shuffle, drop_last, seed, num_threads)
        self.low_paths = [str(p) for p in low_paths]
        self.high_paths = [str(p) for p in high_paths]
        self.image_size = image_size
        self.augment = augment

    @classmethod
    def from_dataset_dir(cls, root: str, image_size: int, batch_size: int,
                         **kwargs) -> "NativeDataLoader":
        """From a LOL-style directory, found as the Python dataset finds
        it (directory probing, sorting, truncation)."""
        from .dataset import LowLightDataset

        ds = LowLightDataset(root, image_size=image_size, augment_data=False)
        return cls([str(p) for p in ds.low_images],
                   [str(p) for p in ds.high_images],
                   image_size, batch_size, **kwargs)

    def _items(self) -> List[str]:
        return self.low_paths

    def _load_batch(self, idxs, seed: int):
        return load_pair_batch(
            [self.low_paths[i] for i in idxs],
            [self.high_paths[i] for i in idxs],
            self.image_size, seed=seed, augment=self.augment,
            num_threads=self.num_threads)


class NativeSyntheticDataLoader(_NativeEpochLoader):
    """The synthetic-degradation loader on ``cvdm_load_synth_batch``:
    decode → crop/hflip → gamma/noise/colour degradation in C++ threads."""

    def __init__(self, paths: List[str], image_size: int, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 gamma_range=(2.0, 5.0), noise_level_range=(0.01, 0.05),
                 seed: int = 0, num_threads: int = 0):
        super().__init__(batch_size, shuffle, drop_last, seed, num_threads)
        self.paths = [str(p) for p in paths]
        self.image_size = image_size
        self.gamma_range = gamma_range
        self.noise_level_range = noise_level_range

    def _items(self) -> List[str]:
        return self.paths

    def _load_batch(self, idxs, seed: int):
        return load_synth_batch(
            [self.paths[i] for i in idxs], self.image_size, seed=seed,
            gamma_range=self.gamma_range,
            noise_level_range=self.noise_level_range,
            num_threads=self.num_threads)
