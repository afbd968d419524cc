"""Conditional diffusion model and the LCM sampler.

Counterpart of ``cv_diffusion_tpu/models/diffusion.py`` (inference part):
:class:`LowLightDiffusion` wraps the UNet with concat (or ``add``)
conditioning, and :func:`enhance` runs the LCM sampler over a timestep grid
with the scheduler arithmetic in float32. Images at this API are NHWC, as in
the JAX package; the model runs NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import DiffusionConfig
from ..device import pin_fp32, resolve_device
from . import scheduler as sched
from .scheduler import LCMSchedule, make_schedule
from .unet import EfficientUNet


class ConditionEncoder(nn.Sequential):
    """Small conv encoder for ``add`` conditioning (reference
    ``condition_encoder``: conv → SiLU → conv)."""

    def __init__(self):
        super().__init__(nn.Conv2d(3, 32, 3, padding=1), nn.SiLU(),
                         nn.Conv2d(32, 3, 3, padding=1))


class LowLightDiffusion(nn.Module):
    """``forward(latents, low, timesteps)`` on NCHW tensors → the UNet's
    prediction."""

    def __init__(self, config: DiffusionConfig):
        super().__init__()
        if config.condition_mode not in ("concat", "add"):
            raise ValueError(f"Unknown condition mode: {config.condition_mode}")
        self.config = config
        self.unet = EfficientUNet(config.unet)
        self.condition_encoder = (ConditionEncoder()
                                  if config.condition_mode == "add" else None)

    def forward(self, latents: torch.Tensor, low_light: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        if self.condition_encoder is None:
            x = torch.cat([latents, low_light.to(latents.dtype)], dim=1)
        else:
            x = latents + self.condition_encoder(low_light)
        return self.unet(x, timesteps)


def create_model(config: DiffusionConfig, *, device="cuda"
                 ) -> Tuple[LowLightDiffusion, LCMSchedule]:
    """Build the model (PyTorch's default init, in eval mode) and its
    schedule on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32()
    with dev:
        model = LowLightDiffusion(config).eval()
    return model, make_schedule(config.scheduler).to(dev)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


@torch.inference_mode()
def enhance(model: LowLightDiffusion, schedule: LCMSchedule,
            low_light: torch.Tensor, *,
            timesteps: Optional[Sequence[int]] = None,
            num_inference_steps: Optional[int] = None,
            init_noise: Optional[torch.Tensor] = None,
            step_noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False,
            device="cuda") -> torch.Tensor:
    """LCM sampling. ``low_light`` [B, H, W, 3] in [-1, 1] → [B, H, W, 3] in
    [-1, 1].

    ``timesteps`` is the descending grid (a distilled student's own, e.g.
    ``[739]``); without it the stock ``lcm_timesteps`` grid of
    ``num_inference_steps`` (default: the config's) is used.
    ``init_noise`` [B, H, W, 3] and ``step_noise`` [steps, B, H, W, 3] are
    explicit noise; what is not given is drawn from ``generator``.
    ``deterministic`` takes renoise-free DDIM-style steps.
    """
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"the model is on {next(model.parameters()).device}, "
                         f"not on {dev}")
    cfg = model.config
    if timesteps is None:
        steps = num_inference_steps or cfg.num_inference_steps
        grid = sched.lcm_timesteps(steps, schedule.config.num_train_timesteps,
                                   schedule.config.original_inference_steps)
    else:
        grid = [int(t) for t in timesteps]
    prev = sched.prev_timesteps(grid)

    batch, height, width = low_light.shape[:3]
    shape = (batch, height, width, 3)
    if init_noise is None:
        init_noise = torch.randn(shape, generator=generator, device=dev)
    if step_noise is None:
        step_noise = torch.randn((len(grid),) + shape, generator=generator,
                                 device=dev)
    latents = _to_nchw(init_noise.to(dev, torch.float32))
    step_noise = step_noise.to(dev, torch.float32).permute(0, 1, 4, 2, 3).contiguous()
    low = _to_nchw(low_light.to(dev, torch.float32))

    for i, (t, prev_t) in enumerate(zip(grid, prev)):
        t_vec = torch.full((batch,), t, dtype=torch.int32, device=dev)
        pred = model(latents, low, t_vec).float()
        if deterministic:
            latents, _ = sched.ddim_step(schedule, pred, t, prev_t, latents)
        else:
            latents, _ = sched.step(schedule, pred, t, prev_t, latents,
                                    noise=step_noise[i])
    return latents.clamp(-1.0, 1.0).permute(0, 2, 3, 1)

