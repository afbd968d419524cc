"""Train state, the LR schedule and optimizer, and the train and eval steps.

Counterpart of ``cv_diffusion_tpu/training/train_state.py:47-131``. One
train step is forward, backward, global-norm clip, AdamW with the LR
schedule, and EMA, as the JAX step; with ``grad_accum_steps > 1`` it runs
the micro-batches one after another and makes one update from their mean.
The state is updated in place. Linear attention runs forward and backward
through the port's CUDA kernels (the CPU runs their plain versions).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.diffusion import (LowLightDiffusion, diffusion_loss,
                                train_forward)
from ..models.scheduler import LCMSchedule
from .ema import init_ema, update_ema

Schedule = Callable[[int], float]

# TrainConfig fields the port does not have yet: (name, refused when, what).
_UNPORTED = (
    ("use_amp", lambda v: v,
     "bf16 compute (ROADMAP queue 1 items 3 and 4); pass use_amp=False"),
    ("remat", lambda v: v, "rematerialisation (ROADMAP queue 1 item 4)"),
    ("qat", lambda v: v, "quantization-aware training (ROADMAP queue 1 item 6)"),
    ("qat_act", lambda v: v,
     "activation-aware QAT (ROADMAP queue 1 item 6)"),
    ("mesh_shape", lambda v: v is not None and math.prod(v) > 1,
     "training over more than one device (ROADMAP queue 1 item 8)"),
    ("use_wandb", lambda v: v, "W&B logging (ROADMAP queue 1 item 4)"),
    ("data_on_device", lambda v: v,
     "the device-side data cache (ROADMAP queue 1 item 4)"),
    ("native_loader", lambda v: v is True,
     "the native C++ loader (ROADMAP queue 1 item 4)"),
    ("init_params_from", lambda v: v is not None,
     "warm starts from a checkpoint (ROADMAP queue 1 item 4)"),
)


def check_trainable(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for a training feature the port does
    not have yet; it never runs another path in its place."""
    for name, refused, what in _UNPORTED:
        if refused(getattr(config, name)):
            raise NotImplementedError(
                f"TrainConfig.{name}={getattr(config, name)!r}: {what} is "
                "not ported")


def _cosine_decay(init_value: float, decay_steps: int,
                  alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def _cosine_onecycle(transition_steps: int, peak_value: float,
                     pct_start: float, div_factor: float = 25.0,
                     final_div_factor: float = 1e4) -> Schedule:
    """optax ``cosine_onecycle_schedule``: its piecewise cosine
    interpolation between the accumulated values at the boundaries."""
    boundaries = {int(pct_start * transition_steps): div_factor,
                  int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    bounds_, scales = zip(*sorted(boundaries.items()))
    bounds = np.asarray((0,) + bounds_, dtype=np.float64)
    values = np.cumprod((peak_value / div_factor,) + scales)
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count: int) -> float:
        inside = (bounds[:-1] <= count) & (count < bounds[1:])
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (count - bounds[:-1]) / sizes
        start, end = values[:-1], values[1:]
        interp = end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
        return float(inside.dot(interp) + (bounds[-1] <= count) * values[-1])
    return schedule


def make_lr_schedule(config: TrainConfig, steps_per_epoch: int) -> Schedule:
    """The LR as a function of the update count (0 for the first update),
    by optax's formulas (JAX ``make_lr_schedule``):

    * ``cosine``: cosine decay from lr to min_lr over total − warmup steps,
      after a linear warmup from 0 over ``warmup_steps`` (none with
      ``faithful_no_warmup``);
    * ``onecycle``: optax's cosine one-cycle (div_factor 25, final_div_factor
      1e4) with pct_start = warmup / total.

    ``warmup_steps = min(steps_per_epoch · warmup_epochs, total // 2)``, so a
    run shorter than the warmup still decays.
    """
    total = max(1, steps_per_epoch * config.epochs)
    warmup = min(steps_per_epoch * config.warmup_epochs, total // 2)
    lr = config.learning_rate
    if config.scheduler_type == "cosine":
        cosine = _cosine_decay(lr, max(1, total - warmup), config.min_lr / lr)
        if config.faithful_no_warmup or warmup == 0:
            return cosine

        def joined(count: int) -> float:
            if count < warmup:
                return lr * min(max(count, 0), warmup) / warmup
            return cosine(count - warmup)
        return joined
    if config.scheduler_type == "onecycle":
        return _cosine_onecycle(total, lr, max(1, warmup) / total)
    raise ValueError(f"Unknown scheduler type: {config.scheduler_type}")


def make_optimizer(config: TrainConfig, params: List[torch.nn.Parameter]
                   ) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw(lr, weight_decay=wd)``: b1 0.9, b2 0.999, eps
    1e-8, decoupled decay of every parameter. Its LR is set from the
    schedule before each update (:func:`apply_update`)."""
    return torch.optim.AdamW(params, lr=config.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=config.weight_decay)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """√(Σ‖t‖²) over all tensors, as ``optax.global_norm``."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """In place, as ``optax.clip_by_global_norm``: g·max_norm/‖g‖ when
    ‖g‖ ≥ max_norm, else g (not ``clip_grad_norm_``, which divides by
    ‖g‖ + 1e-6 and scales below the threshold too)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


@dataclass
class TrainState:
    """What evolves in training: the update count, the module (its
    parameters), the optimizer and its LR schedule, the EMA of the
    parameters, and the generator that draws t, ε and the dropout masks."""

    step: int
    model: LowLightDiffusion
    optimizer: torch.optim.AdamW
    lr_schedule: Schedule
    ema_params: Optional[Dict[str, torch.Tensor]]
    generator: torch.Generator

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(model: LowLightDiffusion, config: TrainConfig,
                       steps_per_epoch: int = 100) -> TrainState:
    """The state of a fresh run on the model's device and with its current
    weights; the generator is seeded with ``config.seed``."""
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    return TrainState(
        step=0, model=model,
        optimizer=make_optimizer(config, list(params.values())),
        lr_schedule=make_lr_schedule(config, steps_per_epoch),
        ema_params=init_ema(params) if config.use_ema else None,
        generator=torch.Generator(device=device).manual_seed(config.seed))


@torch.no_grad()
def apply_update(state: TrainState, config: TrainConfig
                 ) -> torch.Tensor:
    """Clip the gradients held in ``.grad``, take one AdamW step at
    lr(state.step), update the EMA with the pre-increment step, and count
    the update. Returns the global norm before the clip."""
    params = list(state.model.parameters())
    for p in params:        # optax decays every parameter, used or not
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    clip_by_global_norm(grads, config.gradient_clip, norm)
    lr = state.lr_schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    if state.ema_params is not None:
        update_ema(state.ema_params, state.params, config.ema_decay,
                   step=state.step if config.ema_warmup else None)
    state.step += 1
    return norm


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32,
                                 non_blocking=True)


def make_train_step(model: LowLightDiffusion, schedule: LCMSchedule,
                    config: TrainConfig) -> Callable:
    """``step(state, batch) → (state, {"loss", "grad_norm"})``, both device
    scalars (no host sync). ``batch`` holds NHWC ``low_light`` and
    ``normal_light`` in [-1, 1] (numpy arrays or tensors)."""
    check_trainable(config)
    accum = max(1, config.grad_accum_steps)
    device = next(model.parameters()).device

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        low = _as_tensor(batch["low_light"], device)
        normal = _as_tensor(batch["normal_light"], device)
        lead = low.shape[0]
        if lead % accum:
            raise ValueError(f"batch size {lead} not divisible by "
                             f"grad_accum_steps={accum}")
        state.optimizer.zero_grad(set_to_none=True)
        micro = lead // accum
        loss = torch.zeros((), device=device)
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            out = train_forward(model, schedule, low[rows], normal[rows],
                                generator=state.generator, train=True)
            micro_loss = diffusion_loss(out["noise_pred"], out["target"],
                                        config.loss_type)
            micro_loss.backward()
            loss = loss + micro_loss.detach()
        if accum > 1:
            loss = loss / accum
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in model.parameters()
                                     if p.grad is not None], accum)
        norm = apply_update(state, config)
        if config.debug_nans and not bool(torch.isfinite(loss)
                                          & torch.isfinite(norm)):
            raise FloatingPointError(
                f"step {state.step}: loss {float(loss)}, grad norm {float(norm)}")
        return state, {"loss": loss, "grad_norm": norm}

    return step


def make_eval_step(model: LowLightDiffusion, schedule: LCMSchedule,
                   config: TrainConfig) -> Callable:
    """``eval(params, generator, batch, n_valid=None) → mse``: the
    validation loss, mse whatever ``config.loss_type`` is (as the JAX
    package and its reference), per image and averaged over the first
    ``n_valid`` rows; t and ε drawn from ``generator``; ``params`` (e.g. the
    EMA) in place of the module's own, or None for those."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def evaluate(params, generator, batch, n_valid: Optional[int] = None
                 ) -> torch.Tensor:
        low = _as_tensor(batch["low_light"], device)
        normal = _as_tensor(batch["normal_light"], device)
        out = train_forward(model, schedule, low, normal, generator=generator,
                            train=False, params=params)
        err = out["noise_pred"].float() - out["target"].float()
        per_image = (err * err).mean(dim=(1, 2, 3))
        n = per_image.shape[0] if n_valid is None else n_valid
        return per_image[:n].sum() / max(n, 1)

    return evaluate
