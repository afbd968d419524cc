"""LCM scheduler: noise-schedule tables and the denoising step.

Counterpart of ``cv_diffusion_tpu/models/scheduler.py``. The tables are built
on the host in float64 and cast to float32, exactly as the JAX package does,
and the step arithmetic is float32, so the two agree to rounding. The sampler's
timesteps are Python integers (its grid lives on the host), the training
forward process's an int tensor [B]; noise is an explicit tensor or comes
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig
from . import rows


@dataclass(frozen=True)
class LCMSchedule:
    """Noise-schedule tables (float32 tensors) and their config."""

    betas: torch.Tensor            # [T]
    alphas_cumprod: torch.Tensor   # [T]  (ᾱ_t)
    final_alpha_cumprod: torch.Tensor  # scalar: ᾱ_0
    config: SchedulerConfig

    def to(self, device) -> "LCMSchedule":
        return dataclasses.replace(
            self, betas=self.betas.to(device),
            alphas_cumprod=self.alphas_cumprod.to(device),
            final_alpha_cumprod=self.final_alpha_cumprod.to(device))


def _cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    """squaredcos_cap_v2, in float32 as the JAX package builds it."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float32)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale √ᾱ so that ᾱ[T-1] = 0 (sampling starts from pure
    noise)."""
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)
    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = alphas_bar_sqrt - aT
    alphas_bar_sqrt = alphas_bar_sqrt * (a0 / (a0 - aT))
    return alphas_bar_sqrt ** 2


def make_schedule(config: SchedulerConfig = SchedulerConfig()) -> LCMSchedule:
    """Build the tables on the host (float64 → float32); ``.to(device)``
    moves them."""
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T,
                            dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            T, dtype=np.float64) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        betas = _cosine_betas(T)
    else:
        raise ValueError(f"Unknown beta schedule: {config.beta_schedule}")

    alphas_cumprod = np.cumprod(1.0 - betas)
    if config.rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)

    return LCMSchedule(
        betas=torch.tensor(np.asarray(betas, dtype=np.float32)),
        alphas_cumprod=torch.tensor(np.asarray(alphas_cumprod, dtype=np.float32)),
        final_alpha_cumprod=torch.tensor(np.float32(alphas_cumprod[0])),
        config=config,
    )


def lcm_timesteps(num_inference_steps: int = 4,
                  num_train_timesteps: int = 1000,
                  original_inference_steps: int = 50) -> List[int]:
    """LCM inference timesteps, descending: ``[739, 499, 259, 19]`` for 4
    steps with the defaults."""
    if not 1 <= num_inference_steps <= original_inference_steps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in "
            f"[1, original_inference_steps={original_inference_steps}]: the "
            "LCM grid subsamples the teacher's DDIM grid")
    c = num_train_timesteps // original_inference_steps
    origin = [i * c - 1 for i in range(1, original_inference_steps + 1)]
    skip = len(origin) // num_inference_steps
    steps = origin[::skip][:num_inference_steps]
    return list(reversed(steps))


def prev_timesteps(timesteps: Sequence[int]) -> List[int]:
    """For each timestep, the next (smaller) one in the grid, 0 after the
    last."""
    ts = list(timesteps)
    return ts[1:] + [0]


def _sqrt_alphas(schedule: LCMSchedule, timesteps: torch.Tensor,
                 like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(√ᾱ_t, √(1-ᾱ_t)) for int timesteps [B], shaped to broadcast over
    ``like`` [B, ...], in its dtype."""
    acp = schedule.alphas_cumprod.to(device=like.device, dtype=like.dtype)
    a = acp[timesteps.to(device=like.device, dtype=torch.long)]
    shape = (-1,) + (1,) * (like.dim() - 1)
    return torch.sqrt(a).reshape(shape), torch.sqrt(1.0 - a).reshape(shape)


def add_noise(schedule: LCMSchedule, original_samples: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """Forward process x_t = √ᾱ_t·x₀ + √(1-ᾱ_t)·ε; ``timesteps`` an int
    tensor [B] (JAX ``add_noise``, ``models/scheduler.py:138``)."""
    sqrt_alpha, sqrt_one_minus = _sqrt_alphas(schedule, timesteps,
                                              original_samples)
    return sqrt_alpha * original_samples + sqrt_one_minus * noise


def get_velocity(schedule: LCMSchedule, sample: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """v = √ᾱ_t·ε − √(1-ᾱ_t)·x₀ (JAX ``get_velocity``, ``:154``)."""
    sqrt_alpha, sqrt_one_minus = _sqrt_alphas(schedule, timesteps, sample)
    return sqrt_alpha * noise - sqrt_one_minus * sample


def _alpha(schedule: LCMSchedule, t: int, like: torch.Tensor) -> torch.Tensor:
    return schedule.alphas_cumprod.to(device=like.device, dtype=like.dtype)[t]


def _alpha_prev(schedule: LCMSchedule, prev_t: int,
                like: torch.Tensor) -> torch.Tensor:
    if prev_t > 0:
        return _alpha(schedule, prev_t, like)
    return schedule.final_alpha_cumprod.to(device=like.device, dtype=like.dtype)


def pred_original_sample(schedule: LCMSchedule, model_output: torch.Tensor,
                         timestep: int, sample: torch.Tensor) -> torch.Tensor:
    """x̂₀ from the model output under the configured prediction type."""
    alpha_prod_t = _alpha(schedule, timestep, sample)
    beta_prod_t = 1.0 - alpha_prod_t
    if schedule.config.prediction_type == "epsilon":
        x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(alpha_prod_t)
    elif schedule.config.prediction_type == "v_prediction":
        x0 = torch.sqrt(alpha_prod_t) * sample - torch.sqrt(beta_prod_t) * model_output
    else:
        raise ValueError(
            f"Unknown prediction type: {schedule.config.prediction_type}")
    if schedule.config.clip_pred_x0:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def step(schedule: LCMSchedule, model_output: torch.Tensor, timestep: int,
         prev_timestep: int, sample: torch.Tensor,
         noise: Optional[torch.Tensor] = None,
         generator: Optional[torch.Generator] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LCM step: predict x̂₀, then, unless ``prev_timestep == 0``,
    renoise to the previous grid point with ``noise`` (or noise drawn from
    ``generator``). Returns ``(prev_sample, pred_original_sample)``."""
    x0 = pred_original_sample(schedule, model_output, timestep, sample)
    if prev_timestep == 0:
        return x0, x0
    if noise is None:
        if generator is None:
            raise ValueError("step() needs `noise` or `generator` to renoise")
        noise = torch.randn(sample.shape, generator=generator,
                            device=sample.device, dtype=sample.dtype)
    alpha_prod_prev = _alpha_prev(schedule, prev_timestep, sample)
    prev_sample = (torch.sqrt(alpha_prod_prev) * x0
                   + torch.sqrt(1.0 - alpha_prod_prev) * noise)
    return prev_sample, x0


def ddim_step(schedule: LCMSchedule, model_output: torch.Tensor,
              timestep: int, prev_timestep: int, sample: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One deterministic (η=0 DDIM-style) step along the model's own noise
    direction ε̂ = (x_t − √ᾱ_t·x̂₀)/√(1−ᾱ_t). Returns
    ``(prev_sample, pred_original_sample)``."""
    x0 = pred_original_sample(schedule, model_output, timestep, sample)
    if prev_timestep == 0:
        return x0, x0
    alpha_prod_t = _alpha(schedule, timestep, sample)
    eps = (sample - torch.sqrt(alpha_prod_t) * x0) / torch.sqrt(
        torch.clamp_min(1.0 - alpha_prod_t, 1e-8))
    alpha_prod_prev = _alpha_prev(schedule, prev_timestep, sample)
    prev_sample = (torch.sqrt(alpha_prod_prev) * x0
                   + torch.sqrt(1.0 - alpha_prod_prev) * eps)
    return prev_sample, x0


def consistency_timestep_pairs(batch_size: int, num_inference_steps: int,
                               num_train_timesteps: int = 1000,
                               num_ddim_timesteps: int = 50, *,
                               generator: Optional[torch.Generator] = None,
                               idx: Optional[torch.Tensor] = None,
                               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, t_next) = (idx·c+c−1, (idx+k)·c+c−1) on the DDIM grid, c = T/N
    and k = N/num_inference_steps, with idx ~ U[0, N−k−1) drawn from
    ``generator`` unless ``idx`` [B] is given (JAX
    ``consistency_timestep_pairs``, ``models/scheduler.py:276``). The upper
    bound leaves out the last grid point t_next = 999, where ᾱ = 0 under
    zero-terminal SNR and x̂₀ is a division by zero."""
    c = num_train_timesteps // num_ddim_timesteps
    k = num_ddim_timesteps // num_inference_steps
    if idx is None:
        idx = rows.draw(lambda s: torch.randint(
            0, num_ddim_timesteps - k - 1, s, generator=generator,
            device=device), (batch_size,))
    return idx * c + c - 1, (idx + k) * c + c - 1
