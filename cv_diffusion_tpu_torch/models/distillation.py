"""Consistency and sampler-regression distillation: a student trained from a
frozen teacher.

Counterpart of ``cv_diffusion_tpu/models/distillation.py``, name for name:
the loss utilities, the consistency pairings (the reference's, canonical,
and sampler-matched), the sampler-regression loss that made the committed
1-step students, and the state and step factories with their own EMA (decay
0.95, no warm-up).

The student is the module ``model`` itself (its parameters are trained in
place, or ``student_params`` replace them for one call); the teacher and
the EMA student are dicts of tensors called through
``torch.func.functional_call``, on ``model`` or, for a teacher of another
architecture, on ``teacher_model``. Images are NHWC [B, H, W, 3] in
[-1, 1], as in the JAX package.

Random draws: each loss takes them as explicit tensors (the tests hand it
JAX's own), or draws what is not given from ``generator`` in the order its
docstring states. The teacher, and the EMA target, run under
``torch.no_grad`` (JAX's ``stop_gradient``), so only the student's graph is
kept. On the card every linear attention runs through the hand-written
kernels: the teacher's and the target's forwards, the student's forward and
its backward.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import TrainConfig
from ..ops import upcast
from . import rows
from . import scheduler as sched
from .diffusion import LowLightDiffusion, _to_nchw, huber, run_sampler, sampler_noise
from .scheduler import LCMSchedule

Params = Dict[str, torch.Tensor]


def consistency_loss(model_output: torch.Tensor,
                     target_output: torch.Tensor) -> torch.Tensor:
    """MSE, in at least float32 (JAX ``consistency_loss``)."""
    return torch.mean((upcast(model_output) - upcast(target_output)) ** 2)


def huber_loss(model_output: torch.Tensor, target_output: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Huber (mean), in at least float32 (JAX ``huber_loss``:
    ``diffusion.huber``)."""
    return huber(model_output, target_output, delta)


def sample_timestep_pairs(batch_size: int, num_train_timesteps: int,
                          num_ddim_timesteps: int, num_inference_steps: int, *,
                          generator: Optional[torch.Generator] = None,
                          idx: Optional[torch.Tensor] = None,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's pairing, t_next > t: ``scheduler.
    consistency_timestep_pairs`` (idx ~ U[0, N−k−1), the terminal grid
    point left out)."""
    return sched.consistency_timestep_pairs(
        batch_size, num_inference_steps, num_train_timesteps,
        num_ddim_timesteps, generator=generator, idx=idx, device=device)


def sample_canonical_pairs(batch_size: int, num_train_timesteps: int,
                           num_ddim_timesteps: int, num_inference_steps: int,
                           stride: Optional[int] = None, *,
                           generator: Optional[torch.Generator] = None,
                           idx: Optional[torch.Tensor] = None,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, t_prev) with t > t_prev on the DDIM grid, the canonical LCM
    pairing: t = idx·c+c−1, t_prev = (idx−k)·c+c−1, idx ~ U[k, N−1) (the
    terminal grid point left out), k = ``stride`` grid points (default
    N/num_inference_steps, the reference's skip; 1: adjacent points)."""
    c = num_train_timesteps // num_ddim_timesteps
    k = num_ddim_timesteps // num_inference_steps if stride is None else stride
    if idx is None:
        idx = rows.draw(lambda s: torch.randint(
            k, num_ddim_timesteps - 1, s, generator=generator, device=device),
            (batch_size,))
    return idx * c + c - 1, (idx - k) * c + c - 1


def sample_sampler_pairs(batch_size: int, grid: Sequence[int], *,
                         generator: Optional[torch.Generator] = None,
                         idx: Optional[torch.Tensor] = None,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjacent points of the deployed sampler's descending ``grid``:
    (grid[i], grid[i+1]), i ~ U[0, len(grid)−1) (the ``sampler_matched``
    pairing, JAX ``distillation.py:152-158``)."""
    g = torch.as_tensor(list(grid), device=device if idx is None else idx.device)
    if idx is None:
        idx = rows.draw(lambda s: torch.randint(
            0, len(grid) - 1, s, generator=generator, device=device),
            (batch_size,))
    return g[idx], g[idx + 1]


@contextlib.contextmanager
def _mode(model: torch.nn.Module, train: bool):
    """``model`` in training (or eval) mode inside the block, its own mode
    after."""
    was = model.training
    model.train(train)
    try:
        yield model
    finally:
        model.train(was)


def _call(model: LowLightDiffusion, params: Optional[Params], *args,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if params is None:
        return model(*args, generator=generator)
    return torch.func.functional_call(model, params, args,
                                      {"generator": generator})


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def consistency_distillation_loss(
        model: LowLightDiffusion, schedule: LCMSchedule,
        teacher_params: Params, student_params: Optional[Params],
        ema_student_params: Params,
        low_light: torch.Tensor, normal_light: torch.Tensor,
        num_ddim_timesteps: int = 50, num_inference_steps: int = 4,
        canonical: bool = False, clip_x0: Optional[float] = 1.5,
        pair_stride: Optional[int] = None,
        sampler_matched: bool = False, *,
        noise: Optional[torch.Tensor] = None,
        timesteps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        renoise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One consistency-distillation loss (JAX
    ``consistency_distillation_loss``, ``distillation.py:110``).

    The frozen teacher's ε at (x_t, t) takes one DDIM step to x_{t_next}
    (with ``sampler_matched``, x̂₀ renoised with fresh noise instead); the
    student's x̂₀ at (x_t, t) is held by a Huber loss to the EMA student's
    x̂₀ at (x_{t_next}, t_next). x̂₀ is clipped to ±``clip_x0``. Pairings:
    the reference's (t_next > t, :func:`sample_timestep_pairs`),
    ``canonical`` (:func:`sample_canonical_pairs` with ``pair_stride``), or
    ``sampler_matched`` (adjacent points of the stock ``num_inference_steps``
    grid, :func:`sample_sampler_pairs`). The teacher and the target run in
    eval mode under no grad, the student in training mode.

    Explicit draws: ``noise`` (the shape of ``normal_light``), ``timesteps``
    (t, t_next) [B], ``renoise`` (``sampler_matched``: the fresh noise).
    What is not given is drawn from ``generator`` in this order: the noise,
    the pair, the renoise; the student's dropout masks come after them.
    """
    batch = low_light.shape[0]
    device = normal_light.device
    if noise is None:
        noise = rows.draw(lambda s: torch.randn(
            s, generator=generator, device=device, dtype=normal_light.dtype),
            normal_light.shape)
    if timesteps is None:
        T = schedule.config.num_train_timesteps
        if sampler_matched:
            grid = sched.lcm_timesteps(num_inference_steps, T,
                                       num_ddim_timesteps)
            timesteps = sample_sampler_pairs(batch, grid, generator=generator,
                                             device=device)
        elif canonical:
            timesteps = sample_canonical_pairs(
                batch, T, num_ddim_timesteps, num_inference_steps,
                stride=pair_stride, generator=generator, device=device)
        else:
            timesteps = sample_timestep_pairs(
                batch, T, num_ddim_timesteps, num_inference_steps,
                generator=generator, device=device)
    t, t_next = (torch.as_tensor(v, device=device) for v in timesteps)
    if sampler_matched and renoise is None:
        renoise = rows.draw(lambda s: torch.randn(
            s, generator=generator, device=device,
            dtype=upcast(normal_light).dtype), normal_light.shape)

    x0 = _to_nchw(normal_light)
    low = _to_nchw(low_light)
    x_t = sched.add_noise(schedule, x0, _to_nchw(noise.to(normal_light.dtype)), t)
    x_tf = upcast(x_t)
    acp = schedule.alphas_cumprod.to(device=device, dtype=x_tf.dtype)
    alpha_t = _bcast(acp[t.long()], x_t.dim())
    alpha_t_next = _bcast(acp[t_next.long()], x_t.dim())

    def to_x0(x, eps_pred, alpha):
        x0_ = (x - torch.sqrt(1 - alpha) * eps_pred) / torch.sqrt(alpha)
        if clip_x0 is not None:
            x0_ = x0_.clamp(-clip_x0, clip_x0)
        return x0_

    with torch.no_grad(), _mode(model, False):
        teacher_eps = upcast(_call(model, teacher_params, x_t, low, t))
        x0_teacher = to_x0(x_tf, teacher_eps, alpha_t)
        if sampler_matched:
            fresh = _to_nchw(renoise).to(x_tf.dtype)
            x_t_next = (torch.sqrt(alpha_t_next) * x0_teacher
                        + torch.sqrt(1 - alpha_t_next) * fresh)
        else:
            x_t_next = (torch.sqrt(alpha_t_next) * x0_teacher
                        + torch.sqrt(1 - alpha_t_next) * teacher_eps)
        x_t_next = x_t_next.to(x_t.dtype)

    with _mode(model, True):
        student_eps = upcast(_call(model, student_params, x_t, low, t,
                                   generator=generator))
    student_x0 = to_x0(x_tf, student_eps, alpha_t)

    with torch.no_grad(), _mode(model, False):
        target_eps = upcast(_call(model, ema_student_params, x_t_next, low,
                                  t_next))
        target_x0 = to_x0(upcast(x_t_next), target_eps, alpha_t_next)

    return huber_loss(student_x0, target_x0)


def sampler_regression_loss(
        model: LowLightDiffusion, schedule: LCMSchedule,
        teacher_params: Params, student_params: Optional[Params],
        low_light: torch.Tensor, normal_light: torch.Tensor,
        teacher_steps: int = 4,
        student_timesteps: Sequence[int] = (739,),
        deterministic_teacher: bool = False,
        gt_weight: float = 0.0,
        full_grad: bool = False,
        teacher_model: Optional[LowLightDiffusion] = None, *,
        teacher_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        student_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sampler-to-sampler regression (JAX ``sampler_regression_loss``,
    ``distillation.py:212``): the student's whole m-step sampler on its own
    grid ``student_timesteps``, from pure noise, regresses by a Huber loss
    onto the frozen teacher's ``teacher_steps``-step sampler output
    (stochastic, or with ``deterministic_teacher`` the renoise-free one;
    ``teacher_model`` when the teacher's architecture differs), mixed with
    a ground-truth anchor: (1 − ``gt_weight``)·L_teacher + ``gt_weight``·
    huber(student, normal_light).

    The teacher's sampler runs in eval mode under no grad. The student runs
    in eval mode (its sampler) with grad enabled: for m = 1, or with
    ``full_grad``, the gradient passes through the whole sampler
    (``diffusion.run_sampler``); for m > 1 by default the first m − 1 steps
    run under no grad (JAX's stop-gradient prefix) and the last step's x̂₀,
    clipped to [−1, 1], is the output.

    Explicit draws, (init_noise [B, H, W, 3], step_noise [steps, B, H, W,
    3]) each: ``teacher_noise`` with ``teacher_steps`` step slices,
    ``student_noise`` with m slices (m − 1 for the prefix, one a prefix
    step). What is not given is drawn from ``generator`` with
    ``diffusion.sampler_noise``: the teacher's init and step noise, then
    the student's.
    """
    shape = tuple(low_light.shape[:3]) + (3,)
    device = low_light.device
    grid = [int(t) for t in student_timesteps]
    prefix = len(grid) > 1 and not full_grad
    if teacher_noise is None:
        teacher_noise = sampler_noise(generator, shape, teacher_steps, device)
    if student_noise is None:
        student_noise = sampler_noise(generator, shape,
                                      len(grid) - 1 if prefix else len(grid),
                                      device)

    teacher = teacher_model or model
    teacher_grid = sched.lcm_timesteps(
        teacher_steps, schedule.config.num_train_timesteps,
        schedule.config.original_inference_steps)
    with torch.no_grad(), _mode(teacher, False):
        teacher_out = upcast(run_sampler(
            teacher, schedule, low_light, *teacher_noise, teacher_grid,
            deterministic=deterministic_teacher, params=teacher_params))

    with _mode(model, False):
        if not prefix:
            student_out = upcast(run_sampler(model, schedule, low_light,
                                             *student_noise, grid,
                                             params=student_params))
        else:
            dtype = model.compute_dtype
            low = _to_nchw(upcast(low_light)).to(dtype)
            init, steps = student_noise
            x = _to_nchw(upcast(init)).to(dtype)
            batch = shape[0]
            with torch.no_grad():
                for i, t in enumerate(grid[:-1]):
                    t_vec = torch.full((batch,), t, dtype=torch.int32,
                                       device=device)
                    eps = _call(model, student_params, x, low, t_vec)
                    x, _ = sched.step(schedule, eps, t, grid[i + 1], x,
                                      noise=_to_nchw(steps[i]).to(x.dtype))
            t_vec = torch.full((batch,), grid[-1], dtype=torch.int32,
                               device=device)
            eps = _call(model, student_params, x, low, t_vec)
            x0 = sched.pred_original_sample(schedule, eps, grid[-1], x)
            student_out = upcast(x0.clamp(-1.0, 1.0).permute(0, 2, 3, 1))

    loss = huber_loss(student_out, teacher_out)
    if gt_weight:
        gt = huber_loss(student_out, normal_light)
        loss = (1.0 - gt_weight) * loss + gt_weight * gt
    return loss


@dataclass
class DistillationState:
    """What evolves in distillation (JAX ``DistillationState``): the update
    count, the student (the module's parameters), the frozen teacher's
    parameters (and its module when its architecture differs), the EMA
    student, the optimizer with its LR schedule and clip, and the generator
    of the draws."""

    step: int
    model: LowLightDiffusion
    teacher_params: Params
    ema_params: Params
    optimizer: torch.optim.AdamW
    lr_schedule: Callable[[int], float]
    max_grad_norm: float
    generator: torch.Generator
    teacher_model: Optional[LowLightDiffusion] = None

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def _like(params: Params, module: torch.nn.Module) -> Params:
    """Detached copies of ``params`` on ``module``'s device in its
    parameters' dtype (never aliases of tensors the optimizer updates in
    place)."""
    p = next(module.parameters())
    return {k: v.detach().to(p.device, p.dtype, copy=True)
            for k, v in params.items()}


def create_distillation_state(model: LowLightDiffusion, teacher_params: Params,
                              config: TrainConfig, steps_per_epoch: int = 100,
                              student_params: Optional[Params] = None,
                              teacher_model: Optional[LowLightDiffusion] = None
                              ) -> DistillationState:
    """A fresh state on the model's device (JAX
    ``create_distillation_state``): the teacher's weights copied in the
    teacher module's parameter dtype, the student ``student_params`` loaded
    into ``model`` (default: a copy of the teacher's, the standard LCM
    initialisation; with a ``teacher_model`` of another architecture, the
    module's own weights), the EMA a copy of the student, AdamW and the LR
    schedule from ``config`` (``train_state.make_optimizer``), the
    generator seeded ``config.seed``."""
    from ..training.ema import init_ema
    from ..training.train_state import make_lr_schedule, make_optimizer

    device = next(model.parameters()).device
    teacher = teacher_model or model
    names = set(dict(teacher.named_parameters()))
    if set(teacher_params) != names:
        raise ValueError("teacher_params do not name the teacher's parameters: "
                         f"{sorted(set(teacher_params) ^ names)[:4]} …")
    teacher_params = _like(teacher_params, teacher)
    if student_params is None and teacher_model is None:
        student_params = teacher_params
    if student_params is not None:
        model.load_state_dict(student_params, strict=True)
    params = dict(model.named_parameters())
    return DistillationState(
        step=0, model=model, teacher_params=teacher_params,
        ema_params=init_ema(params),
        optimizer=make_optimizer(config, list(params.values())),
        lr_schedule=make_lr_schedule(config, steps_per_epoch),
        max_grad_norm=config.gradient_clip,
        generator=torch.Generator(device=device).manual_seed(config.seed),
        teacher_model=teacher_model)


LossFn = Callable[[DistillationState, torch.Tensor, torch.Tensor, dict],
                  torch.Tensor]


def _distillation_step(loss_fn: LossFn, ema_decay: float,
                       mesh=None) -> Callable:
    """The update around a loss (JAX ``_jit_distillation_step``): the loss
    of the student, its gradients, the clip and AdamW step
    (``train_state.optimizer_update``; ``grad_norm`` before the clip), the
    EMA at ``ema_decay`` with no warm-up, and the count. ``step(state,
    batch, draws=None)``: ``batch`` holds NHWC ``low_light`` and
    ``normal_light`` (numpy arrays or tensors, taken in the student's
    parameter dtype), ``draws`` the loss's
    explicit draws by keyword.

    With ``mesh`` the step is data parallel as ``train_state.
    make_train_step``'s (JAX ``:343-407``): ``batch`` is this process's
    rows, the draws are made for the global batch and narrowed to them,
    the gradients and the loss are averaged over the data axis before the
    clip, and the first step copies the first process's student and EMA
    to the others. A spatial axis of more than one rank raises
    ``NotImplementedError`` (ROADMAP item 8c)."""
    from ..parallel.mesh import data_shard
    from ..training.ema import update_ema
    from ..training.train_state import (optimizer_update, reduce_gradients,
                                        shard_rows, sync_replicas)

    shard = data_shard(mesh, unported="distillation")
    synced = []

    def step(state: DistillationState, batch, draws: Optional[dict] = None):
        if not synced:
            sync_replicas(shard, state.model, state.ema_params)
            synced.append(True)
        p = next(state.model.parameters())
        low, normal = (torch.as_tensor(batch[k]).to(p.device, p.dtype, non_blocking=True)
                       for k in ("low_light", "normal_light"))
        state.optimizer.zero_grad(set_to_none=True)
        with shard_rows(shard, low.shape[0]):
            loss = loss_fn(state, low, normal, draws or {})
            loss.backward()
        loss = reduce_gradients(shard, state.model, loss.detach())
        norm = optimizer_update(state.model, state.optimizer, state.lr_schedule,
                                state.step, state.max_grad_norm)
        update_ema(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": norm}

    return step


def make_distillation_step(model: LowLightDiffusion, schedule: LCMSchedule,
                           ema_decay: float = 0.95,
                           num_ddim_timesteps: int = 50,
                           num_inference_steps: int = 4,
                           canonical: bool = False,
                           clip_x0: Optional[float] = 1.5,
                           pair_stride: Optional[int] = None,
                           sampler_matched: bool = False,
                           mesh=None) -> Callable:
    """The consistency-distillation step (JAX ``make_distillation_step``):
    :func:`consistency_distillation_loss` of the state's student against
    its teacher and EMA. EMA decay 0.95, the distillation components'
    default, not the trainer's 0.9999. ``mesh``: data parallel
    (:func:`_distillation_step`)."""
    def loss_fn(state, low, normal, draws):
        return consistency_distillation_loss(
            model, schedule, state.teacher_params, None, state.ema_params,
            low, normal, num_ddim_timesteps, num_inference_steps,
            canonical=canonical, clip_x0=clip_x0, pair_stride=pair_stride,
            sampler_matched=sampler_matched, generator=state.generator,
            **draws)

    return _distillation_step(loss_fn, ema_decay, mesh)


def make_regression_distillation_step(
        model: LowLightDiffusion, schedule: LCMSchedule,
        ema_decay: float = 0.95,
        teacher_steps: int = 4,
        student_timesteps: Sequence[int] = (739,),
        deterministic_teacher: bool = False,
        gt_weight: float = 0.0,
        full_grad: bool = False,
        teacher_model: Optional[LowLightDiffusion] = None,
        mesh=None) -> Callable:
    """The sampler-regression step (JAX
    ``make_regression_distillation_step``): :func:`sampler_regression_loss`,
    the 1-step student's training mode; for m > 1 the stop-grad prefix
    unless ``full_grad``. ``mesh``: data parallel
    (:func:`_distillation_step`)."""
    grid = tuple(int(t) for t in student_timesteps)

    def loss_fn(state, low, normal, draws):
        return sampler_regression_loss(
            model, schedule, state.teacher_params, None, low, normal,
            teacher_steps=teacher_steps, student_timesteps=grid,
            deterministic_teacher=deterministic_teacher, gt_weight=gt_weight,
            full_grad=full_grad, teacher_model=teacher_model,
            generator=state.generator, **draws)

    return _distillation_step(loss_fn, ema_decay, mesh)
