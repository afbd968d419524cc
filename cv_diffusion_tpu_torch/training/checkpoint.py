"""Checkpoint save and restore with ``torch.save``.

Counterpart of ``cv_diffusion_tpu/training/checkpoint.py``: one file holds
the update count, the parameters, the optimizer state, the EMA, the
generator's state, the epoch, the best validation loss and the training
config as JSON. Files are written atomically and read with
``weights_only=True`` (tensors, numbers and strings only).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from .train_state import TrainState


def save_checkpoint(path: str, state: TrainState, *, epoch: int,
                    best_val_loss: float, config_json: str) -> None:
    """Write the train state and host metadata to the file ``path``."""
    item = {
        "step": state.step,
        "params": {k: v.detach() for k, v in state.model.state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "epoch": epoch,
        "best_val_loss": float(best_val_loss),
        "config": config_json,
    }
    if state.ema_params is not None:
        item["ema_params"] = state.ema_params
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(item, tmp)
    os.replace(tmp, path)


def load_raw(path: str) -> Dict[str, Any]:
    """The saved dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Restore ``state`` in place from ``path``; returns
    ``{"state", "epoch", "best_val_loss", "config"}`` (the trainer resumes at
    epoch + 1)."""
    raw = load_raw(path)
    state.model.load_state_dict(raw["params"], strict=True)
    state.optimizer.load_state_dict(raw["opt_state"])
    state.step = int(raw["step"])
    state.generator.set_state(raw["generator"])
    if state.ema_params is not None:
        if "ema_params" not in raw:
            raise ValueError(f"{path} holds no EMA, and this run keeps one")
        with torch.no_grad():
            for name, e in state.ema_params.items():
                e.copy_(raw["ema_params"][name])
    return {"state": state, "epoch": int(raw["epoch"]),
            "best_val_loss": float(raw["best_val_loss"]),
            "config": json.loads(raw["config"])}


def load_inference_params(path: str, use_ema: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """The weights to serve from a full checkpoint, as a state dict (CPU
    tensors): its EMA when ``use_ema`` and it has one, else its raw
    parameters. (The JAX loader returns the raw parameters of a full
    checkpoint even when asked for the EMA; this one does not.)"""
    raw = load_raw(path)
    if use_ema and "ema_params" in raw:
        return dict(raw["ema_params"])
    return dict(raw["params"])
