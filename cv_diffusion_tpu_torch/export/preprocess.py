"""Image pre/post-processing for serving, on the device.

Counterpart of ``cv_diffusion_tpu/export/preprocess.py`` with the same
aspect-preserving letterbox: ``scale = S / max(h, w)``, the image resized to
``round(h·scale) × round(w·scale)`` and centred on a zero S×S canvas with
``(S − n) // 2`` rows/columns of padding on the top/left. The resizes are
bilinear with half-pixel centres and no antialiasing (OpenCV's
``INTER_LINEAR``), computed in float32 on the device and rounded to uint8, in
place of the JAX package's host-side ``cv2.resize``. Layout is HWC / NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class PreprocessMeta:
    """What is needed to invert the preprocessing."""
    original_size: Tuple[int, int]          # (h, w)
    scale: Tuple[float, float]              # (scale_h, scale_w)
    pad: Tuple[int, int, int, int]          # top, bottom, left, right
    keep_aspect: bool


def resize_u8(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of a uint8 HWC image, rounded back to uint8."""
    x = image.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


class PreProcessor:
    """uint8 HWC image (numpy) → uint8 [1, S, S, 3] canvas on the device +
    metadata. Normalising to [-1, 1] is left to the caller."""

    def __init__(self, target_size: int = 256, keep_aspect: bool = True,
                 device="cuda"):
        self.target_size = target_size
        self.keep_aspect = keep_aspect
        self.device = torch.device(device)

    def __call__(self, image_u8: np.ndarray
                 ) -> Tuple[torch.Tensor, PreprocessMeta]:
        if image_u8.dtype != np.uint8 or image_u8.ndim != 3 or image_u8.shape[2] != 3:
            raise ValueError("expected a uint8 HWC image with 3 channels, got "
                             f"{image_u8.dtype} {image_u8.shape}")
        h, w = image_u8.shape[:2]
        s = self.target_size
        img = torch.from_numpy(np.ascontiguousarray(image_u8))
        if self.device.type == "cuda":
            # from pinned memory the copy is queued on the stream, without
            # waiting for the work already queued there (a pipelined batch's
            # earlier chunks)
            img = img.pin_memory().to(self.device, non_blocking=True)
        else:
            img = img.to(self.device)
        if not self.keep_aspect:
            canvas = resize_u8(img, s, s)
            return canvas[None], PreprocessMeta((h, w), (s / h, s / w),
                                                (0, 0, 0, 0), False)
        scale = s / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        top, left = (s - nh) // 2, (s - nw) // 2
        canvas = torch.zeros((s, s, 3), dtype=torch.uint8, device=self.device)
        canvas[top:top + nh, left:left + nw] = resize_u8(img, nh, nw)
        meta = PreprocessMeta((h, w), (scale, scale),
                              (top, s - nh - top, left, s - nw - left), True)
        return canvas[None], meta


class PostProcessor:
    """uint8 [S, S, 3] output on the device → uint8 HWC numpy image at the
    original size."""

    def __call__(self, output_u8: torch.Tensor,
                 meta: PreprocessMeta) -> np.ndarray:
        return self.on_device(output_u8, meta).cpu().numpy()

    @staticmethod
    def on_device(output_u8: torch.Tensor, meta: PreprocessMeta) -> torch.Tensor:
        """The padding cropped and the image resized back, on the output's
        device: uint8 [h, w, 3]."""
        img = output_u8
        if meta.keep_aspect:
            top, bottom, left, right = meta.pad
            img = img[top:img.shape[0] - bottom, left:img.shape[1] - right]
        h, w = meta.original_size
        return resize_u8(img, h, w)
