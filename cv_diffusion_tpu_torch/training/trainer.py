"""Training orchestration: the host loop around the train step.

Counterpart of ``cv_diffusion_tpu/training/trainer.py:52-366`` with the
same loop: epochs, per-epoch validation on the EMA weights, periodic, best
and final checkpoints (written on a worker thread unless
``async_checkpoints`` is off), sample grids every ``sample_interval``
epochs, resume at epoch + 1, and the fine-tuning warm start
(``init_params_from``: the parameters, or with ``init_params_ema`` the EMA,
of an existing checkpoint, with a fresh optimizer, LR schedule, epoch and
EMA). The loss is read back to the host at log intervals and once per
epoch, never after each step. :meth:`Trainer.evaluate_quality` is the
full-sampler PSNR/SSIM evaluation (``metrics.py``). :func:`train_model`
trains from image directories, as the JAX one. ``qat`` / ``qat_act`` take
the QAT step (``export.qat``); ``qat_act`` on a model not built with
``unet.act_quant="fake"`` raises, where the JAX trainer quietly trains
weight-only QAT. W&B is not ported.
:class:`DistillationTrainer` is the host loop of distillation (JAX
``trainer.py:369-598``): a student trained from a frozen teacher, with the
best-by-PSNR EMA student kept.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig, diffusion_config, to_json
from ..models.diffusion import (LowLightDiffusion, create_model,
                                denormalize_image, enhance)
from ..models.scheduler import LCMSchedule
from . import checkpoint as ckpt
from .metrics import psnr, ssim
from .train_state import (check_trainable, create_train_state, make_eval_step,
                          make_train_step)


def save_comparison_grid(low, enhanced, target, path: str) -> None:
    """[low | enhanced | target] rows, one image a column, as one PNG
    (``data/png.py``). Inputs NHWC in [-1, 1], numpy arrays or tensors,
    each mapped to uint8 in its own dtype as the JAX function does:
    denormalised, ×255, clipped, truncated."""
    from ..data.png import write_png

    rows = []
    for block in (low, enhanced, target):
        img = denormalize_image(torch.as_tensor(block).detach().cpu())
        u8 = (img * 255.0).clamp(0, 255).to(torch.uint8).numpy()
        rows.append(np.concatenate(list(u8), axis=1))
    write_png(path, np.concatenate(rows, axis=0))


class _HostLoop:
    """What both trainers share: the model on its device, the loaders, the
    checkpoint saver and output directories, and the epoch loop around
    ``self.train_step`` (set by the subclass)."""

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 train_loader, val_loader, config: Optional[TrainConfig]):
        self.config = config or TrainConfig()
        check_trainable(self.config)
        self.model = model
        self.schedule = schedule
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = next(model.parameters()).device
        self.epoch = 0
        self._saver = (ckpt.AsyncCheckpointSaver()
                       if self.config.async_checkpoints else None)
        # where the last epoch's time went: steps, seconds, and the seconds
        # spent waiting for the loader's next batch
        self.epoch_stats: Dict[str, float] = {}
        self.output_dir = Path(self.config.output_dir)
        self.checkpoint_dir = Path(self.config.checkpoint_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's images as float32 tensors on the model's device
        (host arrays are uploaded; a device cache's tensors stay)."""
        return {k: torch.as_tensor(batch[k]).to(self.device, torch.float32,
                                                non_blocking=True)
                for k in ("low_light", "normal_light")}

    def train_epoch(self) -> float:
        """One epoch of ``self.train_step``; the mean loss, read back to the
        host at log intervals and once at the end. ``epoch_stats`` gets its
        steps, seconds and the seconds waited on the loader."""
        total = torch.zeros((), device=self.device)
        count, waited = 0, 0.0
        start = time.perf_counter()
        batches = iter(self.train_loader)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            waited += time.perf_counter() - t
            if batch is None:
                break
            self.state, metrics = self.train_step(self.state,
                                                  self._device_batch(batch))
            total = total + metrics["loss"]
            if count % self.config.log_interval == 0:
                print(f"epoch {self.epoch} step {self.state.step}: "
                      f"loss={float(metrics['loss']):.4f} "
                      f"lr={self.state.lr_schedule(self.state.step):.3e}", flush=True)
            count += 1
        mean = float(total) / max(1, count)
        self.epoch_stats = {"steps": count, "loader_wait_s": waited,
                            "seconds": time.perf_counter() - start}
        return mean

    def wait_for_checkpoints(self) -> None:
        """Wait for the asynchronous saves in flight (none when synchronous)."""
        if self._saver is not None:
            self._saver.wait()


class Trainer(_HostLoop):
    """Host-side training loop of a model on its device."""

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 train_loader, val_loader=None,
                 config: Optional[TrainConfig] = None):
        super().__init__(model, schedule, train_loader, val_loader, config)
        if self.config.init_params_from:
            # fine-tuning warm start (unlike resume): the weights only; the
            # state below starts from them (step 0, fresh AdamW, EMA = them)
            model.load_state_dict(ckpt.load_inference_params(
                self.config.init_params_from,
                use_ema=self.config.init_params_ema), strict=True)
        self.state = create_train_state(model, self.config,
                                        steps_per_epoch=len(train_loader))
        if self.config.qat_act and model.config.unet.act_quant != "fake":
            # the JAX trainer trains weight-only QAT here without a word
            # (trainer.py:122; ROADMAP queue 3)
            raise ValueError(
                "TrainConfig.qat_act needs a model built with unet.act_quant="
                f"'fake' (this one has {model.config.unet.act_quant!r}); "
                "train_model builds it so")
        if self.config.qat or self.config.qat_act:
            from ..export.qat import make_qat_train_step
            self.train_step = make_qat_train_step(model, schedule, self.config)
        else:
            self.train_step = make_train_step(model, schedule, self.config)
        self.eval_step = make_eval_step(model, schedule, self.config)
        self.best_val_loss = float("inf")
        if self.config.resume_from:
            self.load_checkpoint(self.config.resume_from)

    def train(self) -> None:
        """All epochs from ``self.epoch`` on (the JAX ``Trainer.train``)."""
        print(f"Starting training on {self.device}")
        for epoch in range(self.epoch, self.config.epochs):
            self.epoch = epoch
            train_loss = self.train_epoch()
            val_loss = self.validate() if self.val_loader is not None else None
            msg = f"Epoch {epoch}: train_loss={train_loss:.4f}"
            if val_loss is not None:
                msg += f", val_loss={val_loss:.4f}"
            print(msg, flush=True)
            if (epoch + 1) % self.config.save_interval == 0:
                self.save_checkpoint(f"checkpoint_epoch_{epoch}")
            if val_loss is not None and val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_checkpoint("best_model")
            if (epoch + 1) % self.config.sample_interval == 0:
                self.generate_samples(epoch)
        self.save_checkpoint("final_model")
        self.wait_for_checkpoints()

    def _eval_params(self) -> Dict[str, torch.Tensor]:
        """The EMA weights when kept, else the model's own."""
        if self.state.ema_params is not None:
            return self.state.ema_params
        return self.state.params

    def validate(self) -> float:
        """Validation mse under the EMA weights, per image over the whole
        validation set (t and ε from a generator seeded 12345)."""
        params = self._eval_params()
        generator = torch.Generator(device=self.device).manual_seed(12345)
        total, count = 0.0, 0
        for batch in self.val_loader:
            n = len(batch["low_light"])
            total += float(self.eval_step(params, generator,
                                          self._device_batch(batch), n)) * n
            count += n
        return total / max(1, count)

    @torch.no_grad()
    def evaluate_quality(self, num_inference_steps: Optional[int] = None,
                         max_batches: Optional[int] = None,
                         noise: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None
                         ) -> Dict[str, float]:
        """Full-sampler PSNR and SSIM on the validation set under the EMA
        weights (the JAX ``Trainer.evaluate_quality``): each batch enhanced
        on the stock grid of ``num_inference_steps`` (default: the
        config's), the output in [0, 1] clipped, each metric's batch mean
        averaged over the batches. The noise comes from a generator seeded
        0, or from ``noise``, one (init_noise, step_noise) per batch."""
        params = self._eval_params()
        steps = (num_inference_steps if num_inference_steps is not None
                 else self.config.num_inference_steps)
        generator = torch.Generator(device=self.device).manual_seed(0)
        explicit = iter(noise) if noise is not None else None
        self.model.eval()
        psnrs, ssims = [], []
        for i, batch in enumerate(self.val_loader):
            if max_batches is not None and i >= max_batches:
                break
            init, step = next(explicit) if explicit is not None else (None, None)
            out = enhance(self.model, self.schedule,
                          torch.as_tensor(batch["low_light"]).to(self.device),
                          num_inference_steps=steps, init_noise=init,
                          step_noise=step, generator=generator,
                          device=self.device, params=params)
            pred = denormalize_image(out.float()).clamp(0.0, 1.0)
            target = denormalize_image(
                torch.as_tensor(batch["normal_light"]).to(self.device).float())
            psnrs.append(float(psnr(pred, target)))
            ssims.append(float(ssim(pred, target)))
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}

    @torch.no_grad()
    def generate_samples(self, epoch: int) -> str:
        """A [low | enhanced | target] grid of the first ``num_samples``
        images of the first val (else train) batch under the EMA weights,
        noise from a generator seeded ``epoch``, written to
        ``output_dir/samples_epoch_{epoch}.png``."""
        loader = self.val_loader or self.train_loader
        batch = self._device_batch(next(iter(loader)))
        n = self.config.num_samples
        low = batch["low_light"][:n]
        self.model.eval()
        out = enhance(self.model, self.schedule, low,
                      generator=torch.Generator(device=self.device).manual_seed(epoch),
                      device=self.device, params=self._eval_params())
        path = str(self.output_dir / f"samples_epoch_{epoch}.png")
        save_comparison_grid(low, out, batch["normal_light"][:n], path)
        return path

    def save_checkpoint(self, name: str) -> str:
        """Save the state as ``checkpoint_dir/{name}.pt``, on the worker
        thread when checkpoints are asynchronous; returns the path."""
        path = str(self.checkpoint_dir / f"{name}.pt")
        save = self._saver.save if self._saver is not None else ckpt.save_checkpoint
        save(path, self.state, epoch=self.epoch,
             best_val_loss=self.best_val_loss, config_json=to_json(self.config))
        return path

    def load_checkpoint(self, path: str) -> None:
        self.wait_for_checkpoints()
        restored = ckpt.restore_checkpoint(path, self.state)
        self.epoch = restored["epoch"] + 1
        self.best_val_loss = restored["best_val_loss"]


def train_model(train_data_dir: str, val_data_dir: Optional[str] = None,
                config: Optional[TrainConfig] = None,
                use_synthetic: bool = False, *, device="cuda") -> Trainer:
    """Train the model that ``config`` names, from random weights seeded
    ``config.seed`` (``weights.init_weights``), on ``device``, from image
    directories (JAX ``train_model``, ``trainer.py:339-366``): the loaders
    come from ``data.dataset.create_dataloaders`` (``native_loader``,
    ``prefetch_batches`` and ``data_on_device`` route them), ``use_amp``
    makes the model compute in bfloat16, ``remat`` rematerialises its
    blocks, and ``qat_act`` builds it with ``unet.act_quant="fake"`` (its
    convolutions fake-quantize their inputs; with ``qat`` or ``qat_act``
    the step fake-quantizes the weights, ``export.qat``). Returns the
    trainer after ``train()``."""
    from ..data.dataset import create_dataloaders
    from ..weights import init_weights

    config = config or TrainConfig()
    check_trainable(config)
    train_loader, val_loader = create_dataloaders(
        train_root=train_data_dir, val_root=val_data_dir,
        batch_size=config.batch_size, image_size=config.image_size,
        use_synthetic=use_synthetic, seed=config.seed,
        native=config.native_loader, prefetch=config.prefetch_batches,
        device_cache=config.data_on_device, device=device)
    model_cfg = diffusion_config(config.unet_variant, config.image_size,
                                 config.num_inference_steps,
                                 dtype="bfloat16" if config.use_amp else "float32",
                                 prediction_type=config.prediction_type,
                                 use_pallas=config.use_pallas,
                                 remat=config.remat,
                                 **({"act_quant": "fake"} if config.qat_act else {}))
    model, schedule = create_model(model_cfg, device=device)
    model.load_state_dict(init_weights(model_cfg, seed=config.seed,
                                       device=device), strict=True)
    trainer = Trainer(model, schedule, train_loader, val_loader, config)
    trainer.train()
    return trainer


class DistillationTrainer(_HostLoop):
    """Host loop of consistency or sampler-regression distillation (JAX
    ``DistillationTrainer``, ``trainer.py:369``): a frozen teacher, the
    student (``model``, trained in place) and its EMA (decay
    ``ema_decay``, no warm-up), the step of
    ``models.distillation.make_distillation_step`` or, with
    ``regression``, ``make_regression_distillation_step``; per epoch the
    EMA student's full-sampler PSNR on the validation set (the best kept
    as ``best_student``), periodic students and sample grids, and
    ``student_final`` at the end.

    The student starts as ``student_params`` (a warm start), else fresh
    from ``weights.init_weights`` (seeded ``config.seed``) when
    ``teacher_model`` (a teacher of another architecture, regression only)
    is given, else as a copy of ``teacher_params``. A regression student is
    validated, sampled and saved with its own grid ``student_timesteps``
    (default ``(739,)``), written beside its weights as
    ``student_timesteps.json``. There is one card: ``mesh`` other than None
    or False raises.
    """

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 teacher_params: Dict[str, torch.Tensor], train_loader,
                 val_loader=None, config: Optional[TrainConfig] = None,
                 num_ddim_timesteps: int = 50, ema_decay: float = 0.95,
                 mesh=None, canonical: bool = False,
                 pair_stride: Optional[int] = None,
                 sampler_matched: bool = False,
                 student_params: Optional[Dict[str, torch.Tensor]] = None,
                 regression: bool = False,
                 student_timesteps: Optional[Sequence[int]] = None,
                 teacher_steps: Optional[int] = None,
                 deterministic_teacher: bool = False,
                 gt_weight: float = 0.0,
                 full_grad: bool = False,
                 teacher_model: Optional[LowLightDiffusion] = None):
        from ..models.distillation import (create_distillation_state,
                                           make_distillation_step,
                                           make_regression_distillation_step)

        if teacher_model is not None and not regression:
            # adjacent-pair consistency starts the student from the
            # teacher's weights and targets them: one architecture only
            raise ValueError("teacher_model (capacity-asymmetric "
                             "distillation) requires regression mode")
        if mesh is not None and mesh is not False:
            raise NotImplementedError(
                "DistillationTrainer(mesh=...): training over more than one "
                "device is not ported (ROADMAP queue 1 item 8)")
        super().__init__(model, schedule, train_loader, val_loader, config)
        if student_params is None and teacher_model is not None:
            from ..weights import init_weights
            model.load_state_dict(init_weights(model.config, seed=self.config.seed,
                                               device=self.device), strict=True)
        self.state = create_distillation_state(
            model, teacher_params, self.config,
            steps_per_epoch=len(train_loader), student_params=student_params,
            teacher_model=teacher_model)
        self.student_timesteps = (tuple(int(t) for t in student_timesteps)
                                  if student_timesteps is not None else None)
        if regression:
            if self.student_timesteps is None:
                self.student_timesteps = (739,)
            self.train_step = make_regression_distillation_step(
                model, schedule, ema_decay=ema_decay,
                teacher_steps=teacher_steps or self.config.num_inference_steps,
                student_timesteps=self.student_timesteps,
                deterministic_teacher=deterministic_teacher,
                gt_weight=gt_weight, full_grad=full_grad,
                teacher_model=teacher_model)
        else:
            self.train_step = make_distillation_step(
                model, schedule, ema_decay=ema_decay,
                num_ddim_timesteps=num_ddim_timesteps,
                num_inference_steps=self.config.num_inference_steps,
                canonical=canonical, pair_stride=pair_stride,
                sampler_matched=sampler_matched)
        self.best_val_psnr = float("-inf")

    def train(self) -> None:
        """All epochs from ``self.epoch`` on, then ``student_final``; the
        asynchronous saves are drained before it returns, so a failed write
        raises here and a caller can read what was saved."""
        print(f"Distilling on {self.device} ({self.config.epochs} epochs)")
        for epoch in range(self.epoch, self.config.epochs):
            self.epoch = epoch
            loss = self.train_epoch()
            count = self.epoch_stats["steps"]
            print(f"Distill epoch {epoch}: loss={loss:.4f} "
                  f"lr={self.state.lr_schedule(count * (epoch + 1)):.2e}",
                  flush=True)
            if self.val_loader is not None:
                val_psnr = self.validate_psnr()
                print(f"Distill epoch {epoch}: val_psnr={val_psnr:.2f} dB",
                      flush=True)
                # students degrade with over-training: keep the best one
                if val_psnr > self.best_val_psnr:
                    self.best_val_psnr = val_psnr
                    self.save_student("best_student")
            if (epoch + 1) % self.config.save_interval == 0:
                self.save_student(f"student_epoch_{epoch}")
            if (epoch + 1) % self.config.sample_interval == 0:
                self.generate_samples(epoch)
        self.save_student("student_final")
        self.wait_for_checkpoints()

    def _enhance(self, low: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The EMA student's sampler on its own grid (a regression
        student's, else the stock grid of ``num_inference_steps``)."""
        return enhance(self.model, self.schedule, low,
                       timesteps=self.student_timesteps,
                       num_inference_steps=self.config.num_inference_steps,
                       generator=generator, device=self.device,
                       params=self.state.ema_params)

    @torch.no_grad()
    def validate_psnr(self) -> float:
        """Mean full-sampler PSNR of the EMA student over the validation
        set, per image, on [0, 1] outputs clipped (noise from a generator
        seeded ``config.seed``)."""
        generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        scores = []
        for batch in self.val_loader:
            batch = self._device_batch(batch)
            out = self._enhance(batch["low_light"], generator)
            pred = denormalize_image(out.float()).clamp(0.0, 1.0)
            target = denormalize_image(batch["normal_light"])
            scores.extend(float(psnr(pred[i:i + 1], target[i:i + 1]))
                          for i in range(pred.shape[0]))
        return float(np.mean(scores)) if scores else float("-inf")

    @torch.no_grad()
    def generate_samples(self, epoch: int) -> str:
        """A [low | enhanced | target] grid of the first ``num_samples``
        images of the first val (else train) batch under the EMA student,
        noise from a generator seeded ``epoch``, written to
        ``output_dir/distill_samples_epoch_{epoch}.png``."""
        loader = self.val_loader or self.train_loader
        batch = self._device_batch(next(iter(loader)))
        n = self.config.num_samples
        low = batch["low_light"][:n]
        out = self._enhance(low, torch.Generator(device=self.device).manual_seed(epoch))
        path = str(self.output_dir / f"distill_samples_epoch_{epoch}.png")
        save_comparison_grid(low, out, batch["normal_light"][:n], path)
        return path

    def save_student(self, name: str) -> str:
        """The EMA student's weights and model config into
        ``checkpoint_dir/name`` (``checkpoint.save_params``), with a
        regression student's grid as ``student_timesteps.json``; on the
        worker thread when checkpoints are asynchronous."""
        path = str(self.checkpoint_dir / name)
        sidecar = None
        if self.student_timesteps is not None:
            sidecar = {"student_timesteps.json": json.dumps(
                {"timesteps": list(self.student_timesteps)})}
        save = self._saver.save_params if self._saver is not None else ckpt.save_params
        save(path, self.state.ema_params, config_json=to_json(self.model.config),
             sidecar=sidecar)
        print(f"Saved distilled student: {name}", flush=True)
        return path
