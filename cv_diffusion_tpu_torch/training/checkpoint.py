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


def load_inference_params(path: str, use_ema: bool = True,
                          verbose: bool = True) -> Dict[str, torch.Tensor]:
    """The weights to serve or to warm-start from (``TrainConfig.
    init_params_from``), as a state dict of CPU tensors, from any of the
    port's layouts (JAX ``load_inference_params``, ``checkpoint.py:234``):

    * a full checkpoint (a file of :func:`save_checkpoint`): its EMA when
      ``use_ema`` and it has one, else its raw parameters. (The JAX loader
      returns the raw parameters of a full checkpoint even when asked for
      the EMA; this one does not.)
    * a weights file in the port's format (``.npz``,
      ``weights.save_state_dict_npz``, e.g. ``artifacts_torch/<name>.npz``)
      or a serving package's directory: its parameters, float32 (a package's
      bf16 or int8 codec brought back as ``load_serving_package`` does);
      ``use_ema`` is ignored with a warning, as in the JAX package (these
      hold the already-selected weights).

    The JAX package's orbax directories cannot be read here (there is no
    orbax where the card is): convert them first with
    ``scripts/torch_port_export_weights.py``."""
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, "params.npz")):
            raise ValueError(
                f"{path}: a directory without params.npz, such as an orbax "
                "checkpoint of the JAX package, which the port cannot read; "
                "convert it to the port's weights format with "
                "scripts/torch_port_export_weights.py")
        from ..export.serving import load_serving_package
        state = load_serving_package(path, "cpu")[2]
    elif path.endswith(".npz"):
        from ..weights import load_state_dict_npz
        state = load_state_dict_npz(path, "cpu")
    else:
        raw = load_raw(path)
        key = "ema_params" if use_ema and "ema_params" in raw else "params"
        if use_ema and key == "params" and verbose:
            print("Warning: --use_ema requested but checkpoint has no "
                  "ema_params; using raw params")
        return dict(raw[key])
    if use_ema and verbose:
        print("Warning: --use_ema ignored (params-only artifact; packages "
              "store the already-selected weights)")
    return state
