"""Paired augmentation and the synthetic degradation on the batch's device,
in PyTorch.

Counterpart of ``cv_diffusion_tpu/data/device_augment.py``: one geometric
transform for both images of a pair (RandomCrop p=1, HFlip p=.5, VFlip
p=.3, Rotate(±15°) p=.3, bilinear with reflect-101 borders) on frames
already normalised to [-1, 1], and the synthetic low-light degradation.

Each function is a *draw* step, which takes every random number from an
explicit ``torch.Generator`` on the batch's device, and an *apply* step,
which takes those draws: the apply steps are held to JAX's on JAX's own
draws. JAX's per-sample ``lax.cond`` is a masked select over the batch, and
nothing is read back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Draws = Dict[str, torch.Tensor]


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 index folding."""
    period = 2 * n - 2 if n > 1 else 1
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def _rotate_bilinear(img: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate each [S, S, C] image of ``img`` [B, S, S, C] by its angle
    ([B], degrees) about the centre (S/2 − 0.5, S/2 − 0.5): inverse map,
    bilinear, reflect-101 borders, float32 as JAX computes it."""
    b, s, _, c = img.shape
    a = angle_deg.float() * (math.pi / 180.0)
    ca, sa = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
    ctr = s / 2.0 - 0.5
    r = torch.arange(s, dtype=torch.float32, device=img.device) - ctr
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    sx = ca * dx - sa * dy + ctr
    sy = sa * dx + ca * dy + ctr
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x0r, x1r = _reflect101(x0, s), _reflect101(x0 + 1, s)
    y0r, y1r = _reflect101(y0, s), _reflect101(y0 + 1, s)
    flat = img.reshape(b, s * s, c)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * s + xx).reshape(b, s * s, 1)
                            .expand(b, s * s, c)).reshape(b, s, s, c)

    return (at(y0r, x0r) * (1 - fx) * (1 - fy) + at(y0r, x1r) * fx * (1 - fy)
            + at(y1r, x0r) * (1 - fx) * fy + at(y1r, x1r) * fx * fy)


def _uniform(generator: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_paired(generator: torch.Generator, batch: int, h: int, w: int,
                size: int, hflip_p: float = 0.5, vflip_p: float = 0.3,
                rotate_p: float = 0.3, rotate_limit: float = 15.0) -> Draws:
    """The random numbers of :func:`paired_augment` for ``batch`` frames of
    h × w: crop corners, flip and rotate flags, angles."""
    dev = generator.device
    return {
        "tops": torch.randint(0, h - size + 1, (batch,), generator=generator,
                              device=dev),
        "lefts": torch.randint(0, w - size + 1, (batch,), generator=generator,
                               device=dev),
        "hflip": torch.rand(batch, generator=generator, device=dev) < hflip_p,
        "vflip": torch.rand(batch, generator=generator, device=dev) < vflip_p,
        "rotate": torch.rand(batch, generator=generator, device=dev) < rotate_p,
        "angles": _uniform(generator, (batch,), -rotate_limit, rotate_limit),
    }


def crop_windows(frames: torch.Tensor, idxs: torch.Tensor, draws: Draws,
                 size: int) -> torch.Tensor:
    """frames[idxs] cut to each pair's window, flips applied: [B, S, S, C]
    in the frames' dtype (a gather, so uint8 frames stay uint8)."""
    ar = torch.arange(size, device=frames.device)
    rows = draws["tops"][:, None] + torch.where(draws["vflip"][:, None],
                                                size - 1 - ar, ar)
    cols = draws["lefts"][:, None] + torch.where(draws["hflip"][:, None],
                                                 size - 1 - ar, ar)
    return frames[idxs[:, None, None], rows[:, :, None], cols[:, None, :]]


def apply_paired(low: torch.Tensor, high: torch.Tensor, draws: Draws,
                 size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`paired_augment` on given draws, for float frames [B, H, W, C]."""
    idxs = torch.arange(low.shape[0], device=low.device)
    return tuple(rotate_selected(crop_windows(x, idxs, draws, size), draws)
                 for x in (low, high))


def rotate_selected(crops: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The crops whose ``rotate`` flag is set rotated by their angle, the
    others as they are (both computed, one selected: no host sync)."""
    rotated = _rotate_bilinear(crops, draws["angles"])
    return torch.where(draws["rotate"][:, None, None, None], rotated, crops)


def paired_augment(generator: torch.Generator, low: torch.Tensor,
                   high: torch.Tensor, size: int, hflip_p: float = 0.5,
                   vflip_p: float = 0.3, rotate_p: float = 0.3,
                   rotate_limit: float = 15.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched paired augmentation, one transform per pair, for normalised
    float frames [B, H, W, C]; returns the crops [B, S, S, C]."""
    b, h, w, _ = low.shape
    draws = draw_paired(generator, b, h, w, size, hflip_p, vflip_p,
                        rotate_p, rotate_limit)
    return apply_paired(low, high, draws, size)


def paired_center_crop(low: torch.Tensor, high: torch.Tensor, size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval path's centre crop of [B, H, W, C] frames."""
    _, h, w, _ = low.shape
    top, left = (h - size) // 2, (w - size) // 2
    return (low[:, top:top + size, left:left + size],
            high[:, top:top + size, left:left + size])


def draw_synthetic(generator: torch.Generator, shape,
                   gamma_range: Tuple[float, float] = (2.0, 5.0),
                   noise_level_range: Tuple[float, float] = (0.01, 0.05),
                   color_shift_p: float = 0.5) -> Draws:
    """The random numbers of :func:`synthetic_low_light` for a batch of
    ``shape`` [B, S, S, 3]: gamma, noise level, noise, colour scale and its
    flag."""
    b = shape[0]
    dev = generator.device
    return {
        "gamma": _uniform(generator, (b, 1, 1, 1), *gamma_range),
        "noise_level": _uniform(generator, (b, 1, 1, 1), *noise_level_range),
        "noise": torch.randn(tuple(shape), generator=generator, device=dev),
        "scale": _uniform(generator, (b, 1, 1, 3), 0.8, 1.0),
        "color_shift": torch.rand((b, 1, 1, 1), generator=generator,
                                  device=dev) < color_shift_p,
    }


def apply_synthetic(normal: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The degradation of normal-light frames [B, S, S, 3] in [-1, 1] on
    given draws: gamma darkening, gaussian noise, the colour scale where
    flagged, each clipped to [0, 1], then quantized to 8 bits by flooring
    (the host's ``astype(uint8)`` and the C++ cast truncate) and mapped back
    to [-1, 1], clipped."""
    img01 = (normal + 1.0) * 0.5
    dark = torch.pow(img01.clamp(min=0.0), draws["gamma"])
    noisy = (dark + draws["noise"] * draws["noise_level"]).clamp(0.0, 1.0)
    noisy = torch.where(draws["color_shift"], noisy * draws["scale"],
                        noisy).clamp(0.0, 1.0)
    noisy = torch.floor(noisy * 255.0) / 255.0
    return (noisy * 2.0 - 1.0).clamp(-1.0, 1.0)


def synthetic_low_light(generator: torch.Generator, normal: torch.Tensor,
                        gamma_range: Tuple[float, float] = (2.0, 5.0),
                        noise_level_range: Tuple[float, float] = (0.01, 0.05),
                        color_shift_p: float = 0.5) -> torch.Tensor:
    """Degraded low-light frames in [-1, 1] for ``normal`` [B, S, S, 3]."""
    draws = draw_synthetic(generator, normal.shape, gamma_range,
                           noise_level_range, color_shift_p)
    return apply_synthetic(normal, draws)
