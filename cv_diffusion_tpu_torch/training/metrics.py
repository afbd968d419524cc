"""Image-quality metrics: PSNR, SSIM, MAE, MS-SSIM and GMSD.

A copy, formula for formula, of ``cv_diffusion_tpu/training/metrics.py``,
with the same layout: ``pred``/``target`` are [B, H, W, C] in
[0, ``max_val``], and each metric is a scalar averaged over the batch.
The window filters are depthwise VALID convolutions on a channels-first
view, in full float32: on the card TF32 is switched off first
(``device.pin_fp32``), since SSIM's E[x²] − µ² identity does not survive
TF32's 10-bit products (the JAX package uses ``Precision.HIGHEST`` for the
same reason).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import pin_fp32


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, weight: torch.Tensor, groups: int = 1) -> torch.Tensor:
    if x.is_cuda:
        pin_fp32()
    return F.conv2d(x, weight.to(x.device), groups=groups)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, VALID (an odd last row or column is dropped)."""
    return F.avg_pool2d(x, 2)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, per image (MSE floored at 1e-12),
    averaged over the batch."""
    mse = ((pred.float() - target.float()) ** 2).mean(dim=(1, 2, 3))
    mse = mse.clamp_min(1e-12)
    return (10.0 * torch.log10(max_val ** 2 / mse)).mean()


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (Wang et al. 2004): 11×11 gaussian window, σ = 1.5,
    C1 = (0.01·L)², C2 = (0.03·L)², VALID padding, channel-averaged."""
    return _ssim_cs(_nchw(pred), _nchw(target), max_val, kernel_size, sigma)[0]


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def _ssim_cs(pred: torch.Tensor, target: torch.Tensor, max_val: float,
             kernel_size: int, sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean SSIM, mean contrast-structure) of NCHW float32 images: the
    per-scale pieces MS-SSIM composes. The variances are clamped at 0."""
    c = pred.shape[1]
    kern = _gaussian_kernel(kernel_size, sigma)[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return _conv(x, kern, groups=c)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p, mu_t = filt(pred), filt(target)
    mu_p2, mu_t2, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p2 = (filt(pred * pred) - mu_p2).clamp_min(0.0)
    sigma_t2 = (filt(target * target) - mu_t2).clamp_min(0.0)
    sigma_pt = filt(pred * target) - mu_pt
    cs = (2 * sigma_pt + c2) / (sigma_p2 + sigma_t2 + c2)
    lum = (2 * mu_pt + c1) / (mu_p2 + mu_t2 + c1)
    return (lum * cs).mean(), cs.mean()


# Wang et al. 2003 scale weights (5 scales).
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
            kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003): contrast-structure at 5 dyadic
    scales (2× average pool between them), the luminance term at the
    coarsest, each floored at 1e-6 and raised to its weight. Needs H, W ≥
    11·2⁴ = 176 for the full 5 scales."""
    pred, target = _nchw(pred), _nchw(target)
    vals = []
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        ssim_mean, cs_mean = _ssim_cs(pred, target, max_val, kernel_size, sigma)
        last = i == len(_MSSSIM_WEIGHTS) - 1
        term = ssim_mean if last else cs_mean
        vals.append(term.clamp_min(1e-6) ** w)
        if not last:
            pred, target = _pool2(pred), _pool2(target)
    return torch.stack(vals).prod()


def gmsd(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Gradient-magnitude similarity deviation (Xue et al. 2013); LOWER is
    better. BT.601 luminance → 2× average pool → Prewitt gradient
    magnitudes (VALID) → similarity map (c = 0.0026) → per-image standard
    deviation, averaged over the batch."""
    def lum(x):
        x = x.float() / max_val
        if x.shape[-1] == 3:
            r, g, b = x[..., 0], x[..., 1], x[..., 2]
            return (0.299 * r + 0.587 * g + 0.114 * b)[:, None]
        return x.mean(dim=-1)[:, None]

    p, t = _pool2(lum(pred)), _pool2(lum(target))
    prewitt_x = torch.tensor([[1, 0, -1], [1, 0, -1], [1, 0, -1]],
                             dtype=torch.float32) / 3.0
    kern = torch.stack([prewitt_x, prewitt_x.T])[:, None]   # [2, 1, 3, 3]

    def grad_mag(x):
        g = _conv(x, kern)
        return torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2 + 1e-12)

    gm_p, gm_t = grad_mag(p), grad_mag(t)
    c = 0.0026  # T=170 on the [0,255]² scale (paper) → /255²
    gms = (2 * gm_p * gm_t + c) / (gm_p ** 2 + gm_t ** 2 + c)
    mean = gms.mean(dim=(1, 2), keepdim=True)
    return torch.sqrt(((gms - mean) ** 2).mean(dim=(1, 2))).mean()
