"""Training orchestration: the host loop around the train step.

Counterpart of ``cv_diffusion_tpu/training/trainer.py:71-337`` with the same
loop: epochs, per-epoch validation on the EMA weights, periodic, best and
final checkpoints, resume at epoch + 1, and the fine-tuning warm start
(``init_params_from``: the parameters, or with ``init_params_ema`` the EMA,
of an existing checkpoint, with a fresh optimizer, LR schedule, epoch and
EMA). The loss is read back to the host at log intervals and once per
epoch, never after each step.
:meth:`Trainer.evaluate_quality` is the full-sampler PSNR/SSIM evaluation
(``metrics.py``). Sample grids and W&B are not ported (ROADMAP queue 1
item 4); checkpoints are written synchronously.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

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


class Trainer:
    """Host-side training loop of a model on its device."""

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 train_loader, val_loader=None,
                 config: Optional[TrainConfig] = None):
        self.config = config or TrainConfig()
        check_trainable(self.config)
        self.model = model
        self.schedule = schedule
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = next(model.parameters()).device
        if self.config.init_params_from:
            # fine-tuning warm start (unlike resume): the weights only; the
            # state below starts from them (step 0, fresh AdamW, EMA = them)
            model.load_state_dict(ckpt.load_inference_params(
                self.config.init_params_from,
                use_ema=self.config.init_params_ema), strict=True)
        self.state = create_train_state(model, self.config,
                                        steps_per_epoch=len(train_loader))
        self.train_step = make_train_step(model, schedule, self.config)
        self.eval_step = make_eval_step(model, schedule, self.config)
        self.epoch = 0
        self.best_val_loss = float("inf")
        self.checkpoint_dir = Path(self.config.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
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
        self.save_checkpoint("final_model")

    def train_epoch(self) -> float:
        """One epoch; the mean train loss."""
        total = torch.zeros((), device=self.device)
        count = 0
        for batch_idx, batch in enumerate(self.train_loader):
            self.state, metrics = self.train_step(self.state, batch)
            total = total + metrics["loss"]
            count += 1
            if batch_idx % self.config.log_interval == 0:
                print(f"epoch {self.epoch} step {self.state.step}: "
                      f"loss={float(metrics['loss']):.4f} "
                      f"lr={self.state.lr_schedule(self.state.step):.3e}", flush=True)
        return float(total) / max(1, count)

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
            total += float(self.eval_step(params, generator, batch, n)) * n
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

    def save_checkpoint(self, name: str) -> str:
        path = str(self.checkpoint_dir / f"{name}.pt")
        ckpt.save_checkpoint(path, self.state, epoch=self.epoch,
                             best_val_loss=self.best_val_loss,
                             config_json=to_json(self.config))
        return path

    def load_checkpoint(self, path: str) -> None:
        restored = ckpt.restore_checkpoint(path, self.state)
        self.epoch = restored["epoch"] + 1
        self.best_val_loss = restored["best_val_loss"]


def train_model(train_loader, val_loader=None,
                config: Optional[TrainConfig] = None, *,
                device="cuda") -> Trainer:
    """Build the model that ``config`` names on ``device`` with random
    weights from ``config.seed`` (``weights.init_weights``), train it on the
    loaders, and return the trainer. As the JAX ``train_model``
    (``trainer.py:353-362``): ``use_amp`` makes the model compute in
    bfloat16, and ``remat`` rematerialises its blocks."""
    from ..weights import init_weights

    config = config or TrainConfig()
    check_trainable(config)
    model_cfg = diffusion_config(config.unet_variant, config.image_size,
                                 config.num_inference_steps,
                                 dtype="bfloat16" if config.use_amp else "float32",
                                 prediction_type=config.prediction_type,
                                 use_pallas=config.use_pallas,
                                 remat=config.remat)
    model, schedule = create_model(model_cfg, device=device)
    model.load_state_dict(init_weights(model_cfg, seed=config.seed,
                                       device=device), strict=True)
    trainer = Trainer(model, schedule, train_loader, val_loader, config)
    trainer.train()
    return trainer
