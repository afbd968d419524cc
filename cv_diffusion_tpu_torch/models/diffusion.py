"""Conditional diffusion model, its training loss, and the LCM sampler.

Counterpart of ``cv_diffusion_tpu/models/diffusion.py``:
:class:`LowLightDiffusion` wraps the UNet with concat (or ``add``)
conditioning, :func:`train_forward` and :func:`compute_loss` are the
training forward pass and loss, and :func:`enhance` runs the LCM sampler
over a timestep grid with the scheduler arithmetic in float32. Images at
this API are NHWC, as in the JAX package; the model runs NCHW inside.

The UNet config's ``dtype`` is the compute dtype of the whole model: in
bfloat16 the sampler's carry, its noise and the condition are cast to it
(:func:`enhance`, JAX ``diffusion.py:227-286``), and the loss is taken in
float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiffusionConfig
from ..device import pin_fp32, resolve_device
from ..ops import upcast
from ..ops.qconv import QConv
from . import rows
from . import scheduler as sched
from .blocks import Conv2d, SiLU, set_compute_dtype
from .scheduler import LCMSchedule, make_schedule
from .unet import EfficientUNet


@dataclass
class EnhanceOutput:
    """:func:`enhance`'s output with ``return_intermediate`` (JAX
    ``EnhanceOutput``, ``diffusion.py:37-43``): the clipped result and the
    carry after each step, unclipped, stacked [steps, B, H, W, 3]."""

    enhanced: torch.Tensor
    intermediate: Optional[torch.Tensor] = None


class ConditionEncoder(nn.Sequential):
    """Small conv encoder for ``add`` conditioning (reference
    ``condition_encoder``: conv → SiLU → conv)."""

    def __init__(self):
        super().__init__(Conv2d(3, 32, 3, padding=1), SiLU(),
                         Conv2d(32, 3, 3, padding=1))


class LowLightDiffusion(nn.Module):
    """``forward(latents, low, timesteps)`` on NCHW tensors → the UNet's
    prediction."""

    def __init__(self, config: DiffusionConfig):
        super().__init__()
        if config.condition_mode not in ("concat", "add"):
            raise ValueError(f"Unknown condition mode: {config.condition_mode}")
        self.config = config
        self.unet = EfficientUNet(config.unet)
        self.condition_encoder = None
        if config.condition_mode == "add":
            self.condition_encoder = ConditionEncoder()
            set_compute_dtype(self.condition_encoder, self.unet.compute_dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the UNet computes in and the sampler carries."""
        return self.unet.compute_dtype or next(self.parameters()).dtype

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


def with_dtype(model: LowLightDiffusion, dtype: str) -> LowLightDiffusion:
    """``model``'s weights in a model built for the compute dtype ``dtype``
    (``"float32"`` or ``"bfloat16"``), on the same device and in eval mode:
    what a JAX user gets from the same params with ``unet.dtype`` set in
    the model config. The parameters are copied (float32 either way), and
    so are the activation scales of an ``act_quant`` model, which the state
    dict does not hold."""
    import dataclasses

    cfg = dataclasses.replace(model.config, unet=dataclasses.replace(
        model.config.unet, dtype=dtype))
    dev = next(model.parameters()).device
    with dev:
        other = LowLightDiffusion(cfg).eval()
    other.load_state_dict(model.state_dict(), strict=True)
    amax = {n: m.amax for n, m in model.named_modules() if isinstance(m, QConv)}
    for n, m in other.named_modules():
        if isinstance(m, QConv):
            m.set_amax(amax[n])
    return other


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def sample_timesteps_and_noise(schedule: LCMSchedule, shape: Sequence[int],
                               generator: Optional[torch.Generator],
                               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U[0, T) [B] and ε ~ N(0, 1) of ``shape`` (NHWC), drawn from
    ``generator`` in that order: what :func:`train_forward` draws when it is
    given neither. Inside ``rows.global_batch`` both are drawn for the
    global batch and narrowed to this process's rows (and ε to its strip of
    image rows)."""
    t = rows.draw(lambda s: torch.randint(
        0, schedule.config.num_train_timesteps, s, generator=generator,
        device=device), (shape[0],))
    noise = rows.draw(lambda s: torch.randn(s, generator=generator,
                                            device=device), shape, hdim=1)
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


def sampler_noise(generator: Optional[torch.Generator],
                  shape: Sequence[int], steps: int, device,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's noise, ε ~ N(0, 1) in float32 drawn from ``generator``
    in this order: ``init_noise`` of ``shape`` [B, H, W, 3], then
    ``step_noise`` [steps, B, H, W, 3], one slice a step (drawn for every
    grid, the 1-step one too, whose renoise is unused). :func:`enhance`
    draws its noise here, and the serving pipeline's CUDA graph fills its
    buffers here (``out``, filled in place), so a seed gives the same image
    either way. Inside ``rows.global_batch`` both are drawn for the global
    batch and narrowed to this process's rows (dim 0 of ``init_noise``,
    dim 1 of ``step_noise``) and strip of image rows (dims 1 and 2)."""
    if rows.active():
        def fill(s):
            return torch.empty(s, device=device).normal_(generator=generator)
        drawn = (rows.draw(fill, shape, hdim=1),
                 rows.draw(fill, (steps,) + tuple(shape), 1, hdim=2))
        if out is None:
            return drawn
        for t, d in zip(out, drawn):
            t.copy_(d)
        return out
    if out is None:
        out = (torch.empty(tuple(shape), device=device),
               torch.empty((steps,) + tuple(shape), device=device))
    for t in out:
        t.normal_(generator=generator)
    return out


@torch.inference_mode()
def enhance(model: LowLightDiffusion, schedule: LCMSchedule,
            low_light: torch.Tensor, *,
            timesteps: Optional[Sequence[int]] = None,
            num_inference_steps: Optional[int] = None,
            init_noise: Optional[torch.Tensor] = None,
            step_noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False,
            device="cuda",
            params: Optional[Dict[str, torch.Tensor]] = None,
            return_intermediate: bool = False
            ) -> Union[torch.Tensor, EnhanceOutput]:
    """LCM sampling. ``low_light`` [B, H, W, 3] in [-1, 1] → [B, H, W, 3] in
    [-1, 1], in the model's compute dtype (float32, or bfloat16 for a bf16
    model, as the JAX ``enhance`` returns it).

    ``timesteps`` is the descending grid (a distilled student's own, e.g.
    ``[739]``); without it the stock ``lcm_timesteps`` grid of
    ``num_inference_steps`` (default: the config's) is used.
    ``init_noise`` [B, H, W, 3] and ``step_noise`` [steps, B, H, W, 3] are
    explicit noise; when either is not given, both are drawn from
    ``generator`` (:func:`sampler_noise`) and the drawn one is used.
    ``deterministic`` takes renoise-free DDIM-style steps. ``params`` (e.g.
    the EMA weights) replaces the module's own parameters.
    ``return_intermediate`` returns an :class:`EnhanceOutput` with each
    step's carry as well.

    In bfloat16 the carry, both noises and the condition are cast to bf16
    before use (the noise is still drawn in float32, so a seed gives both
    dtypes the same noise); each step takes the UNet's bf16 prediction and
    the carry to float32 for the scheduler arithmetic and casts the new
    carry back (JAX ``diffusion.py:242-278``).
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

    batch, height, width = low_light.shape[:3]
    if init_noise is None or step_noise is None:
        drawn = sampler_noise(generator, (batch, height, width, 3), len(grid), dev)
        init_noise = drawn[0] if init_noise is None else init_noise
        step_noise = drawn[1] if step_noise is None else step_noise
    return run_sampler(model, schedule, low_light.to(dev), init_noise.to(dev),
                       step_noise.to(dev), grid, deterministic=deterministic,
                       params=params, return_intermediate=return_intermediate)


def run_sampler(model: LowLightDiffusion, schedule: LCMSchedule,
                low_light: torch.Tensor, init_noise: torch.Tensor,
                step_noise: torch.Tensor, grid: Sequence[int], *,
                deterministic: bool = False,
                params: Optional[Dict[str, torch.Tensor]] = None,
                return_intermediate: bool = False
                ) -> Union[torch.Tensor, EnhanceOutput]:
    """The LCM sampler over the descending ``grid`` with explicit noise
    (``init_noise`` [B, H, W, 3], ``step_noise`` [steps, B, H, W, 3]), on
    the tensors' device, differentiable: :func:`enhance` calls it under
    inference mode, and a distilled student's sampler
    (``distillation.sampler_regression_loss``) with grad enabled, so that
    the gradient reaches the weights through every step. The model is
    called in whatever mode it is in.

    The scheduler arithmetic runs in at least float32 (a float64 model's
    in float64), the carry and the condition in the compute dtype.
    """
    dtype = model.compute_dtype
    prev = sched.prev_timesteps(grid)
    batch = low_light.shape[0]
    dev = low_light.device
    latents = _to_nchw(upcast(init_noise)).to(dtype)
    step_noise = upcast(step_noise).permute(0, 1, 4, 2, 3).contiguous().to(dtype)
    low = _to_nchw(upcast(low_light)).to(dtype)

    carries = []
    for i, (t, prev_t) in enumerate(zip(grid, prev)):
        t_vec = torch.full((batch,), t, dtype=torch.int32, device=dev)
        args = (latents, low, t_vec)
        pred = upcast(model(*args) if params is None
                      else torch.func.functional_call(model, params, args))
        if deterministic:
            latents, _ = sched.ddim_step(schedule, pred, t, prev_t,
                                         upcast(latents))
        else:
            latents, _ = sched.step(schedule, pred, t, prev_t, upcast(latents),
                                    noise=upcast(step_noise[i]))
        latents = latents.to(dtype)
        if return_intermediate:
            carries.append(latents.permute(0, 2, 3, 1))
    enhanced = latents.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
    if return_intermediate:
        return EnhanceOutput(enhanced, torch.stack(carries))
    return enhanced


def denormalize_image(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → [0, 1] (JAX ``denormalize_image``)."""
    return (image + 1.0) / 2.0

