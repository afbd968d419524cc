"""The synthetic paired dataset of ``scripts/make_synthetic_dataset.py``, in
memory and in numpy alone.

A copy of that script's procedural scene generator (``:31-102``) and of its
``write_split`` random-number sequence (``:105-123``): one
``default_rng(seed)`` draws the scenes, which are shuffled with it, and
image i is degraded with ``default_rng(seed·1_000_003 + i)`` by
:func:`~.augment.synthetic_low_light`. :func:`make_split` returns the uint8
(low, high) pairs that the script would write as PNGs, without Pillow: the
value-noise texture's bilinear upsampling is :func:`resize_bilinear_u8`, a
copy of Pillow's 8-bit two-pass resampling. Only the procedural split
(``photo_fraction=0``, the script's validation split) is supported; the
photo crops need scikit-learn's sample images. :func:`write_split` writes
a split as the script does, as PNGs (``data/png.py``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from .augment import synthetic_low_light

PRECISION_BITS = 32 - 8 - 2     # Pillow's fixed point for 8-bit images


def _bilinear_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` with the triangle filter (support 1)
    and ``normalize_coeffs_8bpc``: per output pixel the first input index
    and the fixed-point weights [out, ksize] (zeros past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)   # C casts truncate
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = sum(w)   # Pillow adds the weights in this order
        w = [v / ww if ww != 0.0 else v for v in w]
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along axis 0, rounded and
    clipped to uint8 as ``clip8`` does."""
    xmins, kk = _bilinear_coeffs(img.shape[0], out_size)
    src = np.concatenate([img.astype(np.int64),
                          np.zeros((kk.shape[1],) + img.shape[1:], np.int64)])
    acc = np.full((out_size,) + img.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        w = kk[:, j].reshape((-1,) + (1,) * (img.ndim - 1))
        acc += src[xmins + j] * w
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BILINEAR)`` for
    a uint8 [H, W, C] array: the horizontal pass first (to uint8, as Pillow
    keeps an 8-bit intermediate image), then the vertical one; a pass whose
    size does not change is skipped, as in Pillow."""
    out = img
    if width != img.shape[1]:
        out = _resample_axis0(out.swapaxes(0, 1), width).swapaxes(0, 1)
    if height != img.shape[0]:
        out = _resample_axis0(out, height)
    return np.ascontiguousarray(out)


def _fourier_background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth coloured background from a few low-frequency components."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for _ in range(rng.integers(2, 5)):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.1, 0.4, 3)
        wave = np.sin(2 * np.pi * (fx * xx + fy * yy)[..., None]
                      + phase[None, None])
        img += amp[None, None] * wave
    return img


def _value_noise(rng: np.random.Generator, size: int, cells: int) -> np.ndarray:
    """A random grid upsampled bilinearly: cheap texture."""
    grid = rng.uniform(-1, 1, (cells, cells, 3)).astype(np.float32)
    u8 = ((grid + 1) * 127.5).astype(np.uint8)
    return np.asarray(resize_bilinear_u8(u8, size, size), np.float32) / 127.5 - 1.0


def _add_shapes(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(rng.integers(3, 9)):
        cy, cx = rng.uniform(0, size, 2)
        ry, rx = rng.uniform(size * 0.05, size * 0.35, 2)
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        dy, dx = yy - cy, xx - cx
        u = (ct * dx - st * dy) / rx
        v = (st * dx + ct * dy) / ry
        mask = (u * u + v * v) < 1.0
        color = rng.uniform(-0.9, 0.9, 3).astype(np.float32)
        alpha = rng.uniform(0.4, 1.0)
        img[mask] = (1 - alpha) * img[mask] + alpha * color[None]
    return img


def generate_scene(rng: np.random.Generator, size: int) -> np.ndarray:
    """One synthetic normal-light scene, uint8 RGB [size, size, 3]."""
    img = _fourier_background(rng, size)
    img += 0.3 * _value_noise(rng, size, int(rng.integers(4, 16)))
    img = _add_shapes(rng, img)
    # global exposure to a well-lit range
    img = np.tanh(img) * 0.5 + rng.uniform(0.45, 0.65)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_split(n: int, size: int, seed: int, photo_fraction: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``n`` (low, high) uint8 pairs [n, size, size, 3] that
    ``write_split(root, n, size, seed, photo_fraction=0.0)`` writes as
    ``low/{i:05d}.png`` and ``high/{i:05d}.png``."""
    if photo_fraction != 0.0:
        raise NotImplementedError(
            "photo crops need scikit-learn's sample images; only the "
            "procedural split (photo_fraction=0.0) is ported")
    rng = np.random.default_rng(seed)
    highs = [generate_scene(rng, size) for _ in range(n)]
    rng.shuffle(highs)
    lows = [synthetic_low_light(np.random.default_rng(seed * 1_000_003 + i), high)
            for i, high in enumerate(highs)]
    return np.stack(lows), np.stack(highs)


def write_split(root: Union[str, Path], n: int, size: int, seed: int) -> None:
    """``make_split(n, size, seed)`` written as ``root/low/{i:05d}.png`` and
    ``root/high/{i:05d}.png``: the decoded pixels of the script's
    ``write_split`` with ``photo_fraction=0`` (or with scikit-learn absent,
    where its photo crops yield nothing and draw nothing). The PNG bytes
    differ from Pillow's: another encoder."""
    from .png import write_png

    root = Path(root)
    low, high = make_split(n, size, seed)
    for i in range(n):
        write_png(root / "high" / f"{i:05d}.png", high[i])
        write_png(root / "low" / f"{i:05d}.png", low[i])
