"""Training CLI of the port: ``python -m cv_diffusion_tpu_torch.train``.

Counterpart of ``scripts/train.py``, with its flags and defaults mapped onto
:class:`~cv_diffusion_tpu_torch.config.TrainConfig`, and ``--device``
(default ``cuda``). It trains from LOL-style ``{low,high}/`` image
directories (or, with ``--use_synthetic``, a directory of normal-light
images) through ``training.trainer.train_model``. ``--config`` reads an
experiment YAML (``configs/default.yaml``'s layout, ``config.load_yaml``,
no PyYAML needed): its ``train`` section is the base, only the flags present
in the command line override it, and ``data.train_root``, ``data.val_root``
and ``data.use_synthetic`` give the directories (JAX ``scripts/train.py:54``).
A field the port refuses raises where it does without the YAML
(``training.train_state.check_trainable``: ``use_wandb``). ``--wandb``
raises ``NotImplementedError`` (not queued). ``--qat`` trains with the
weights fake-quantized in the forward, ``--qat_act`` also with every
convolution's input fake-quantized (``export.qat``). ``--distributed``
starts the process group (``parallel.distributed_init``: the
``CVDM_COORDINATOR`` / ``CVDM_NUM_PROCESSES`` / ``CVDM_PROCESS_ID``
variables, or ``CVDM_DISTRIBUTED=1`` under ``torch.distributed.run``; a
no-op without them, as in JAX): every process then trains on
``parallel.local_device`` on its shard of the files, data parallel (NCCL
on CUDA, gloo on the CPU).

    python -m cv_diffusion_tpu_torch.train --data_dir D --val_dir V \\
        --variant small --image_size 256 --epochs 100 --batch_size 8
    python -m cv_diffusion_tpu_torch.train --config configs/default.yaml --epochs 1
    CVDM_DISTRIBUTED=1 python -m torch.distributed.run --nproc_per_node 8 \\
        -m cv_diffusion_tpu_torch.train --distributed --data_dir D --val_dir V
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Sequence

from .config import TrainConfig, load_yaml
from .device import resolve_device

# CLI flag → TrainConfig field; the disable-switches are inverted in
# ``resolve_config``
_FLAG_TO_FIELD = {
    "variant": "unet_variant",
    "image_size": "image_size",
    "num_steps": "num_inference_steps",
    "epochs": "epochs",
    "batch_size": "batch_size",
    "lr": "learning_rate",
    "weight_decay": "weight_decay",
    "scheduler": "scheduler_type",
    "no_amp": "use_amp",
    "no_ema": "use_ema",
    "ema_decay": "ema_decay",
    "no_warmup": "faithful_no_warmup",
    "loss": "loss_type",
    "save_interval": "save_interval",
    "sample_interval": "sample_interval",
    "output_dir": "output_dir",
    "checkpoint_dir": "checkpoint_dir",
    "wandb": "use_wandb",
    "wandb_project": "wandb_project",
    "resume": "resume_from",
    "seed": "seed",
    "use_pallas": "use_pallas",
    "remat": "remat",
    "grad_accum": "grad_accum_steps",
    "data_on_device": "data_on_device",
    "qat": "qat",
    "qat_act": "qat_act",
    "prediction": "prediction_type",
    "init_params": "init_params_from",
    "init_ema": "init_params_ema",
    "sync_checkpoints": "async_checkpoints",
}
_INVERTED = ("no_amp", "no_ema", "sync_checkpoints")

# flag → why the port refuses it
_REFUSED = {
    "wandb": "--wandb: W&B logging is not ported (not queued: no wandb and "
             "no network; ROADMAP queue 1 item 4)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train low-light diffusion (PyTorch port)",
        allow_abbrev=False)
    # Data
    p.add_argument("--data_dir", type=str, default="data/our485",
                   help="Training data directory (root/{low,high}/)")
    p.add_argument("--val_dir", type=str, default="data/eval15",
                   help="Validation data directory ('' or 'none': none)")
    p.add_argument("--use_synthetic", action="store_true",
                   help="Synthesize low-light inputs from normal images")
    # Model
    p.add_argument("--variant", type=str, default="small",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=4,
                   help="LCM inference steps")
    # Training
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--loss", type=str, default="mse",
                   choices=["mse", "huber", "l1"])
    p.add_argument("--scheduler", type=str, default="cosine",
                   choices=["cosine", "onecycle"])
    p.add_argument("--no_amp", action="store_true",
                   help="Disable bf16 mixed precision")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--no_warmup", action="store_true",
                   help="Reference-faithful: cosine from step 0, no warmup")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_pallas", action="store_true",
                   help="Read and ignored: linear attention always runs "
                        "through the port's CUDA kernels")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize blocks in the backward pass")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Micro-batches per optimizer update; 1 = off")
    p.add_argument("--data_on_device", action="store_true",
                   help="Cache the decoded training set on the device "
                        "(uint8) and augment there")
    # Logging / checkpointing
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--save_interval", type=int, default=5)
    p.add_argument("--sync_checkpoints", action="store_true",
                   help="Save checkpoints on the main thread (default: a "
                        "device snapshot, then fetch and write on a worker "
                        "thread)")
    p.add_argument("--sample_interval", type=int, default=1)
    p.add_argument("--wandb", action="store_true", help="Refused")
    p.add_argument("--wandb_project", type=str,
                   default="low-light-diffusion-tpu")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--prediction", type=str, default="epsilon",
                   choices=("epsilon", "v_prediction"))
    p.add_argument("--qat", action="store_true",
                   help="Quantization-aware training: fake-quantize the "
                        "weights in the forward pass (int8, straight-through, "
                        "the int8 export's scale and skip rules)")
    p.add_argument("--qat_act", action="store_true",
                   help="Activation-aware QAT: also fake-quantize every "
                        "convolution's input (the int8 path's scale rules); "
                        "implies --qat")
    p.add_argument("--init_params", type=str, default=None,
                   help="Warm-start params (+EMA) from a checkpoint with a "
                        "fresh optimizer and epoch")
    p.add_argument("--init_ema", action="store_true",
                   help="With --init_params: start from the checkpoint's EMA")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-process: torch.distributed from "
                        "CVDM_COORDINATOR/CVDM_NUM_PROCESSES/CVDM_PROCESS_ID "
                        "(or torch.distributed.run's environment with "
                        "CVDM_DISTRIBUTED=1)")
    p.add_argument("--config", type=str, default=None,
                   help="Experiment YAML (configs/default.yaml's layout); "
                        "flags given on the command line override it")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on (default: cuda)")
    return p


def _val_dir(value):
    """``--val_dir``: '' or 'none' disables validation."""
    return value if value not in ("", "none", None) else None


def resolve_config(args, argv: Sequence[str] = ()):
    """(TrainConfig, data_dir, val_dir, use_synthetic) from parsed args
    (JAX ``scripts/train.py:54``); ``NotImplementedError`` for a refused
    flag. With ``--config`` the YAML is the base and only the flags present
    in ``argv`` (the command line the args were parsed from) override it;
    flags left at their defaults do not."""
    for flag, why in _REFUSED.items():
        if getattr(args, flag):
            raise NotImplementedError(why)

    def flag_value(flag):
        value = getattr(args, flag)
        return (not value) if flag in _INVERTED else value

    if not args.config:
        config = TrainConfig(**{field: flag_value(flag)
                                for flag, field in _FLAG_TO_FIELD.items()})
        return config, args.data_dir, _val_dir(args.val_dir), args.use_synthetic
    exp = load_yaml(args.config)
    passed = {a.lstrip("-").split("=")[0] for a in argv if a.startswith("--")}
    config = dataclasses.replace(exp.train, **{
        field: flag_value(flag) for flag, field in _FLAG_TO_FIELD.items()
        if flag in passed})
    data_dir = args.data_dir if "data_dir" in passed else exp.data.train_root
    val_dir = (_val_dir(args.val_dir) if "val_dir" in passed
               else exp.data.val_root)
    use_synth = (args.use_synthetic if "use_synthetic" in passed
                 else exp.data.use_synthetic)
    return config, data_dir, val_dir, use_synth


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    config, data_dir, val_dir, use_synth = resolve_config(args, argv)
    resolve_device(args.device)
    from .parallel import distributed_init, local_device
    from .training.trainer import train_model

    if args.distributed:
        distributed_init(device=args.device)
    train_model(data_dir, val_dir, config, use_synthetic=use_synth,
                device=local_device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
