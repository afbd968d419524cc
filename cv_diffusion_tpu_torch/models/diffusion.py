"""Conditional diffusion model, its training loss, and the LCM sampler.

Counterpart of ``cv_diffusion_tpu/models/diffusion.py``:
:class:`LowLightDiffusion` wraps the UNet with concat (or ``add``)
conditioning, :func:`train_forward` and :func:`compute_loss` are the
training forward pass and loss, and :func:`enhance` runs the LCM sampler
over a timestep grid with the scheduler arithmetic in float32. Images at
this API are NHWC, as in the JAX package; the model runs NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiffusionConfig
from ..device import pin_fp32, resolve_device
from ..ops import upcast
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
                timesteps: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        if self.condition_encoder is None:
            x = torch.cat([latents, low_light.to(latents.dtype)], dim=1)
        else:
            x = latents + self.condition_encoder(low_light)
        return self.unet(x, timesteps, generator)


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


def sample_timesteps_and_noise(schedule: LCMSchedule, shape: Sequence[int],
                               generator: Optional[torch.Generator],
                               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U[0, T) [B] and ε ~ N(0, 1) of ``shape`` (NHWC), drawn from
    ``generator`` in that order: what :func:`train_forward` draws when it is
    given neither."""
    t = torch.randint(0, schedule.config.num_train_timesteps, (shape[0],),
                      generator=generator, device=device)
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    return t, noise


def train_forward(model: LowLightDiffusion, schedule: LCMSchedule,
                  low_light: torch.Tensor, normal_light: torch.Tensor, *,
                  timesteps: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  train: bool = True,
                  params: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Training forward pass (JAX ``train_forward``, ``diffusion.py:123``).

    ``low_light``, ``normal_light`` and ``noise`` are NHWC [B, H, W, 3] on
    the model's device; ``timesteps`` an int tensor [B]. What is not given
    is drawn from ``generator`` (:func:`sample_timesteps_and_noise`), which
    also draws the dropout masks. Puts the model in training mode when
    ``train``, else in eval mode; ``params`` (e.g. the EMA weights) replaces
    the module's own parameters for this call. Returns NHWC ``noise_pred``
    and ``target`` (ε, or v for v-prediction), and ``noise`` and
    ``timesteps``.
    """
    model.train(train)
    if timesteps is None or noise is None:
        t, n = sample_timesteps_and_noise(schedule, normal_light.shape,
                                          generator, normal_light.device)
        timesteps = t if timesteps is None else timesteps
        noise = n if noise is None else noise
    x0, eps = _to_nchw(normal_light), _to_nchw(noise)
    noisy = sched.add_noise(schedule, x0, eps, timesteps)
    args = (noisy, _to_nchw(low_light), timesteps)
    if params is None:
        pred = model(*args, generator=generator)
    else:
        pred = torch.func.functional_call(model, params, args,
                                          {"generator": generator})
    if schedule.config.prediction_type == "v_prediction":
        target = sched.get_velocity(schedule, x0, eps, timesteps)
    else:
        target = eps
    return {"noise_pred": pred.permute(0, 2, 3, 1),
            "target": target.permute(0, 2, 3, 1), "noise": noise,
            "timesteps": timesteps}


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """``F.huber_loss`` (mean), in at least float32."""
    return F.huber_loss(upcast(pred), upcast(target), delta=delta)


def diffusion_loss(noise_pred: torch.Tensor, target: torch.Tensor,
                   loss_type: str = "mse") -> torch.Tensor:
    """mse / huber / l1, in at least float32 (JAX ``diffusion_loss``)."""
    pred, tgt = upcast(noise_pred), upcast(target)
    if loss_type == "mse":
        return torch.mean((pred - tgt) ** 2)
    if loss_type == "huber":
        return huber(pred, tgt)
    if loss_type == "l1":
        return torch.mean(torch.abs(pred - tgt))
    raise ValueError(f"Unknown loss type: {loss_type}")


def compute_loss(model: LowLightDiffusion, schedule: LCMSchedule,
                 low_light: torch.Tensor, normal_light: torch.Tensor,
                 loss_type: str = "mse", *,
                 generator: Optional[torch.Generator] = None,
                 train: bool = True) -> torch.Tensor:
    """The training loss of one batch, t and ε drawn from ``generator``."""
    out = train_forward(model, schedule, low_light, normal_light,
                        generator=generator, train=train)
    return diffusion_loss(out["noise_pred"], out["target"], loss_type)


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

