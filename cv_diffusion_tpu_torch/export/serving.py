"""End-to-end uint8 → uint8 serving.

Counterpart of ``ServingConfig`` and ``ServingPipeline`` in
``cv_diffusion_tpu/export/serving.py``: pre-process (letterbox to S×S),
normalise ``u8 / 127.5 − 1``, the LCM sampler, ``clip(x·127.5 + 127.5, 0,
255)`` cast to uint8 by truncation, post-process back to the input's size.
Everything from the canvas on runs on the device. As in the JAX package's
``load_serving_package``, serving routes linear attention through the
hand-written kernel. :meth:`ServingPipeline.from_artifact` serves a
committed artifact on its own weights (the fp32 path of
``load_serving_package``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import load_model_config, load_timesteps
from ..device import pin_fp32, resolve_device
from ..models.diffusion import LowLightDiffusion, create_model, enhance
from ..models.scheduler import LCMSchedule
from ..weights import load_state_dict_npz
from .preprocess import PostProcessor, PreProcessor

# the repository's root: ``artifacts/<name>/`` holds an artifact's JSON
# files, ``artifacts_torch/<name>.npz`` its weights in the port's format
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class ServingConfig:
    """Serving settings (the JAX ``ServingConfig`` without its XLA-only
    fields)."""

    image_size: int = 256
    num_inference_steps: int = 4
    batch_size: int = 1
    keep_aspect: bool = True
    seed: int = 0
    # renoise-free DDIM-style steps instead of the stochastic LCM step
    deterministic: bool = False
    # explicit descending grid (a distilled student's own, e.g. (739,));
    # None = the stock lcm_timesteps grid of num_inference_steps
    timesteps: Optional[tuple] = None


class ServingPipeline:
    """uint8 HWC image(s) in, uint8 HWC image(s) of the same size out."""

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 config: Optional[ServingConfig] = None, *, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            pin_fp32()
        self.config = config or ServingConfig(image_size=model.config.image_size)
        self.model = model.to(self.device).eval()
        self.schedule = schedule.to(self.device)
        self.pre = PreProcessor(self.config.image_size, self.config.keep_aspect,
                                self.device)
        self.post = PostProcessor()
        self._counter = 0

    @classmethod
    def from_config(cls, model_config_path: str, timesteps_path: str,
                    weights: Dict[str, torch.Tensor], device="cuda", *,
                    variant: Optional[str] = None,
                    image_size: Optional[int] = None,
                    **serving_overrides) -> "ServingPipeline":
        """A pipeline for an artifact's ``model_config.json`` and
        ``student_timesteps.json``, with ``weights`` (a state dict, e.g. from
        ``weights.init_weights`` or ``weights.state_dict_from_jax``) loaded
        with ``strict=True``. ``variant``/``image_size`` override the file's
        UNet widths and resolution; other keywords set ServingConfig
        fields."""
        cfg = load_model_config(model_config_path, variant, image_size)
        return cls._build(cfg, load_timesteps(timesteps_path), weights, device,
                          serving_overrides)

    @classmethod
    def from_artifact(cls, name: str, device="cuda", *,
                      use_pallas_irb: bool = False,
                      **serving_overrides) -> "ServingPipeline":
        """The committed artifact ``name`` on its own weights: the model
        and grid from ``artifacts/<name>/``'s ``model_config.json`` and
        ``student_timesteps.json``, the weights from
        ``artifacts_torch/<name>.npz`` (``weights.load_state_dict_npz``) of
        this repository. ``use_pallas_irb`` routes
        every stride-1 IRB through the fused kernel; other keywords set
        ServingConfig fields. Raises ``FileNotFoundError`` for an artifact
        whose weights file is not in the tree."""
        path = os.path.join(REPO_ROOT, "artifacts", name)
        npz = os.path.join(REPO_ROOT, "artifacts_torch", f"{name}.npz")
        if not os.path.isfile(npz):
            raise FileNotFoundError(
                f"{npz}: artifact {name!r} has no weights file in the port's "
                "format in this tree (only vreg1b_gt03_ema fits the copy "
                "limit; ROADMAP queue 1 item 1)")
        cfg = load_model_config(os.path.join(path, "model_config.json"))
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_pallas_irb=use_pallas_irb))
        grid = load_timesteps(os.path.join(path, "student_timesteps.json"))
        return cls._build(cfg, grid, load_state_dict_npz(npz, device), device,
                          serving_overrides)

    @classmethod
    def _build(cls, cfg, grid, weights, device, serving_overrides):
        model, schedule = create_model(cfg, device=device)
        model.load_state_dict(weights, strict=True)
        config = ServingConfig(image_size=cfg.image_size,
                               num_inference_steps=len(grid), timesteps=grid,
                               **serving_overrides)
        return cls(model, schedule, config, device=device)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        """Explicit seed → the same output for the same input; no seed →
        config.seed advanced by a per-call counter."""
        if seed is None:
            seed = self.config.seed + self._counter
            self._counter += 1
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run(self, canvas_u8: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        """uint8 [B, S, S, 3] → uint8 [B, S, S, 3], on the device."""
        low = canvas_u8.float() / 127.5 - 1.0
        out = enhance(self.model, self.schedule, low,
                      timesteps=self.config.timesteps,
                      num_inference_steps=self.config.num_inference_steps,
                      generator=generator,
                      deterministic=self.config.deterministic,
                      device=self.device)
        return (out * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)

    def __call__(self, image_u8: np.ndarray,
                 seed: Optional[int] = None) -> np.ndarray:
        """Enhance one uint8 HWC image."""
        canvas, meta = self.pre(image_u8)
        out = self._run(canvas, self._generator(seed))
        return self.post(out[0], meta)

    def batch(self, images: Sequence[np.ndarray],
              seed: Optional[int] = None) -> List[np.ndarray]:
        """Enhance a list of uint8 HWC images in device batches of
        ``config.batch_size`` (the last one padded with black canvases);
        with a seed, chunk i uses ``seed + i``. Outputs keep input order."""
        bs = max(1, self.config.batch_size)
        outs: List[np.ndarray] = []
        for chunk_idx, start in enumerate(range(0, len(images), bs)):
            pre = [self.pre(img) for img in images[start:start + bs]]
            x = torch.cat([canvas for canvas, _ in pre])
            if x.shape[0] < bs:
                x = torch.cat([x, x.new_zeros((bs - x.shape[0],) + x.shape[1:])])
            out = self._run(x, self._generator(
                None if seed is None else seed + chunk_idx))
            outs.extend(self.post(out[i], meta)
                        for i, (_, meta) in enumerate(pre))
        return outs
