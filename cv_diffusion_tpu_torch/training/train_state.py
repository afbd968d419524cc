"""Train state, the LR schedule and optimizer, and the train and eval steps.

Counterpart of ``cv_diffusion_tpu/training/train_state.py:47-131``. One
train step is forward, backward, global-norm clip, AdamW with the LR
schedule, and EMA, as the JAX step; with ``grad_accum_steps > 1`` it runs
the micro-batches one after another and makes one update from their mean.
The state is updated in place; ``params_transform`` (QAT's fake-quant)
maps the parameters the forward sees. Linear attention runs forward and backward
through the port's CUDA kernels (the CPU runs their plain versions). The
model computes in its config's dtype (bfloat16 under ``use_amp``, which
``trainer.train_model`` maps as the JAX trainer does) while the parameters,
their gradients, AdamW's moments and the EMA stay float32: the loss is
taken in float32 and the gradients reach the float32 parameters through
the casts, as in JAX.

Over a mesh (``parallel.make_mesh``: one process per GPU) the steps are
data parallel, and over a ``(data, spatial)`` mesh also spatially sharded
(each process a strip of image rows of its images, the UNet's layers
exchanging what crosses the strips: ``parallel.halo``); either way they
equal the one-process step at the global batch, as JAX's steps over a mesh
equal its single-device step: t, ε and the dropout masks are drawn for the
global batch from the state's generator, seeded alike everywhere, and each
process takes its block (``models.rows``); the gradients and the loss are
averaged over the whole mesh (one flattened ``all_reduce``) before the
clip, so the update, the EMA and the LR are the same in every process.
Each process's loss is the mean over its own pixels, and every process
holds as many, so that average is the global batch's mean.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import upcast
from ..models import rows
from ..models.diffusion import (LowLightDiffusion, diffusion_loss,
                                train_forward)
from ..models.scheduler import LCMSchedule
from ..parallel.halo import spatial_sum
from ..parallel.mesh import (DataShard, Mesh, all_reduce_mean_,
                             all_reduce_sum, broadcast_, data_shard,
                             refuse_spatial_model, shard_batch, spatial_scope)
from .ema import init_ema, update_ema

Schedule = Callable[[int], float]

# TrainConfig fields the port does not have yet: (name, refused when, what).
_UNPORTED = (
    ("use_wandb", lambda v: v,
     "W&B logging (not queued: no wandb and no network; ROADMAP queue 1 "
     "item 4)"),
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
def optimizer_update(model: torch.nn.Module, optimizer: torch.optim.AdamW,
                     lr_schedule: Schedule, step: int,
                     max_grad_norm: float) -> torch.Tensor:
    """The update ``optax.chain(clip_by_global_norm, adamw(schedule))``
    makes from the gradients held in ``.grad``: clip them to
    ``max_grad_norm``, then one AdamW step at lr(step). Returns the global
    norm before the clip. The trainer's and the distillation's updates
    both take it (each then updates its own EMA)."""
    params = list(model.parameters())
    for p in params:        # optax decays every parameter, used or not
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    clip_by_global_norm(grads, max_grad_norm, norm)
    lr = lr_schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


@torch.no_grad()
def apply_update(state: TrainState, config: TrainConfig
                 ) -> torch.Tensor:
    """Clip the gradients held in ``.grad``, take one AdamW step at
    lr(state.step) (:func:`optimizer_update`), update the EMA with the
    pre-increment step, and count the update. Returns the global norm
    before the clip."""
    norm = optimizer_update(state.model, state.optimizer, state.lr_schedule,
                            state.step, config.gradient_clip)
    if state.ema_params is not None:
        update_ema(state.ema_params, state.params, config.ema_decay,
                   step=state.step if config.ema_warmup else None)
    state.step += 1
    return norm


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype,
                                 non_blocking=True)


@contextlib.contextmanager
def shard_rows(shard: Optional[DataShard], local: int):
    """The draws' block of a global batch of which this process holds
    ``local`` rows (the whole batch without a mesh) and, with a spatial
    axis, its strip of image rows; the layers run under its spatial
    shard."""
    spatial = shard.spatial if shard is not None else None
    block = shard.rows(local) if shard is not None else (local, 0, local)
    strips = (spatial.size, spatial.index) if spatial is not None else None
    with rows.global_batch(*block, strips=strips), spatial_scope(spatial):
        yield


def sync_replicas(shard: Optional[DataShard], model: torch.nn.Module,
                  ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Copy the mesh's first process's parameters, buffers and EMA to the
    others (what ``DistributedDataParallel`` does when it is built): the
    replicas then start equal whatever each process initialised."""
    if shard is None or shard.replicas == 1:
        return
    tensors = [t.data for t in model.parameters()] + list(model.buffers())
    if ema is not None:
        tensors += list(ema.values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        broadcast_([t for t in tensors if t.dtype == dtype], shard.mesh_group,
                   shard.mesh_src)


def reduce_gradients(shard: Optional[DataShard], model: torch.nn.Module,
                     loss: torch.Tensor) -> torch.Tensor:
    """Average the gradients held in ``.grad`` over the whole mesh in place
    (every parameter: a missing gradient counts as zeros, as in JAX), and
    return the loss averaged likewise. Under a spatial axis each process's
    gradients hold its own pixels' share of the loss (``parallel.halo``
    says why none is counted twice), so this one average is the gradient
    of the global batch's mean."""
    if shard is None or shard.replicas == 1:
        return loss
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        all_reduce_mean_([g for g in grads if g.dtype == dtype], shard.mesh_group)
    return all_reduce_sum(loss, shard.mesh_group) / shard.replicas


def make_train_step(model: LowLightDiffusion, schedule: LCMSchedule,
                    config: TrainConfig,
                    params_transform: Optional[Callable] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, batch, draws=None) → (state, {"loss", "grad_norm"})``,
    both device scalars (no host sync). ``batch`` holds NHWC ``low_light``
    and ``normal_light`` in [-1, 1] (numpy arrays or tensors, taken in the
    parameters' dtype); ``draws`` explicit ``timesteps`` [B] and ``noise``
    [B, H, W, 3] for the batch's rows.

    ``params_transform`` (the QAT fake-quant, ``export.qat``) maps the
    parameters (``{name: Parameter}``) to those the forward uses, inside
    the loss (``torch.func.functional_call``): the gradients reach the raw
    parameters through it, and the optimizer and the EMA update those (JAX
    ``train_state.py:140-163``).

    With ``mesh`` the step is data parallel (module docstring): ``batch``
    is this process's block (``parallel.shard_batch`` of a global batch,
    or its own loader's batch on a data-only mesh), and the first step
    copies the first process's parameters and EMA to the others. On a
    ``(data, spatial)`` mesh the block is its rows of the batch and its
    strip of image rows of each. With ``grad_accum_steps`` k, micro-batch i
    is every process's local rows [i·b/k, (i+1)·b/k) (each micro-batch
    stays split over both axes) and the gradients are reduced once, after
    the last. Under a spatial axis an ``act_quant`` model and ``qat_act``
    raise ``NotImplementedError`` (ROADMAP item 8c)."""
    check_trainable(config)
    refuse_spatial_model(mesh, model, config)
    shard = data_shard(mesh)
    accum = max(1, config.grad_accum_steps)
    param = next(model.parameters())
    device = param.device
    synced = []

    def step(state: TrainState, batch, draws: Optional[Dict] = None
             ) -> Tuple[TrainState, Dict]:
        if not synced:
            sync_replicas(shard, model, state.ema_params)
            synced.append(True)
        low = _as_tensor(batch["low_light"], device, param.dtype)
        normal = _as_tensor(batch["normal_light"], device, param.dtype)
        lead = low.shape[0]
        if lead % accum:
            raise ValueError(f"batch size {lead} not divisible by "
                             f"grad_accum_steps={accum}")
        state.optimizer.zero_grad(set_to_none=True)
        micro = lead // accum
        loss = torch.zeros((), device=device)
        for i in range(accum):
            part = slice(i * micro, (i + 1) * micro)
            given = {k: torch.as_tensor(v)[part].to(device)
                     for k, v in (draws or {}).items()}
            params = (None if params_transform is None
                      else params_transform(dict(model.named_parameters())))
            with shard_rows(shard, micro):
                out = train_forward(model, schedule, low[part], normal[part],
                                    generator=state.generator, train=True,
                                    params=params, **given)
                micro_loss = diffusion_loss(out["noise_pred"], out["target"],
                                            config.loss_type)
                micro_loss.backward()
            loss = loss + micro_loss.detach()
        if accum > 1:
            loss = loss / accum
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in model.parameters()
                                     if p.grad is not None], accum)
        loss = reduce_gradients(shard, model, loss)
        norm = apply_update(state, config)
        if config.debug_nans and not bool(torch.isfinite(loss)
                                          & torch.isfinite(norm)):
            raise FloatingPointError(
                f"step {state.step}: loss {float(loss)}, grad norm {float(norm)}")
        return state, {"loss": loss, "grad_norm": norm}

    return step


def make_eval_step(model: LowLightDiffusion, schedule: LCMSchedule,
                   config: TrainConfig, mesh: Optional[Mesh] = None
                   ) -> Callable:
    """``eval(params, generator, batch, n_valid=None) → mse``: the
    validation loss, mse whatever ``config.loss_type`` is (as the JAX
    package and its reference), per image and averaged over the first
    ``n_valid`` rows (the rest, e.g. ``parallel.pad_batch``'s padding,
    masked out); t and ε drawn from ``generator``; ``params`` (e.g. the
    EMA) in place of the module's own, or None for those.

    With ``mesh``, ``batch`` is the global batch, whole in every process:
    each takes its block (``parallel.shard_batch``: its rows, and on a
    ``(data, spatial)`` mesh its strip of image rows; a batch that does not
    split over the data axis is computed whole everywhere), t and ε are
    drawn for the global batch, each image's squared error is summed over
    the spatial group, and the masked per-image means are added over the
    data axis and divided by ``n_valid`` (JAX ``train_state.py:234-276``):
    every process gets the same loss."""
    refuse_spatial_model(mesh, model)
    shard = data_shard(mesh)
    spatial = shard.spatial if shard is not None else None
    param = next(model.parameters())
    device = param.device
    levels = len(model.config.unet.channels)

    @torch.no_grad()
    def evaluate(params, generator, batch, n_valid: Optional[int] = None
                 ) -> torch.Tensor:
        total = len(batch["low_light"])
        n = total if n_valid is None else n_valid
        split = shard is not None and total % shard.size == 0
        if split:
            if spatial is not None:
                spatial.check_height(len(batch["low_light"][0]), levels)
            batch = shard_batch(mesh, {k: batch[k] for k in
                                       ("low_light", "normal_light")})
        low = _as_tensor(batch["low_light"], device, param.dtype)
        normal = _as_tensor(batch["normal_light"], device, param.dtype)
        with shard_rows(shard if split else None, low.shape[0]):
            out = train_forward(model, schedule, low, normal,
                                generator=generator, train=False,
                                params=params)
        err = upcast(out["noise_pred"]) - upcast(out["target"])
        if split and spatial is not None:
            per_image = (spatial_sum((err * err).sum(dim=(1, 2, 3)), spatial)
                         / (err[0].numel() * spatial.size))
        else:
            per_image = (err * err).mean(dim=(1, 2, 3))
        local = low.shape[0]
        block = shard.rows(local) if split else (local, 0, local)
        index = torch.arange(block[1], block[2], device=device)
        masked = torch.where(index < n, per_image,
                             torch.zeros_like(per_image)).sum()
        if split:
            masked = all_reduce_sum(masked, shard.group)
        return masked / max(n, 1)

    return evaluate
