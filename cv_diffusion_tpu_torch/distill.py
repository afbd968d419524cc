"""Distillation CLI of the port: ``python -m cv_diffusion_tpu_torch.distill``.

Counterpart of ``scripts/distill.py``, every flag with its default and its
meaning, and ``--device`` (default ``cuda``): a teacher's weights → a
distilled student (``best_student`` and ``student_final`` under
``--checkpoint_dir``: ``params.npz``, ``model_config.json`` and, for a
regression student, ``student_timesteps.json``), through
``training.trainer.DistillationTrainer``.

``--teacher`` and ``--init_student`` take the port's layouts (a
``save_params`` directory, a serving package, a full checkpoint, a weights
``.npz``, or a committed artifact's ``artifacts/<name>/`` whose weights are
``artifacts_torch/<name>.npz``: ``training.checkpoint.resolve_weights``);
an orbax directory of the JAX package without such a copy is refused by
``training.checkpoint.load_inference_params``. What they load
from a full checkpoint: the teacher its EMA with ``--teacher_ema`` and its
raw parameters without; ``--init_student`` always its raw parameters (the
JAX CLI's default). ``--dtype bfloat16`` trains in bf16 compute,
``--remat`` rematerialises the student's blocks, ``--data_on_device`` caches
the training set on the device; ``--use_pallas`` is accepted and ignored:
linear attention always runs through the port's kernels. With the
environment of ``parallel.distributed_init`` (``CVDM_COORDINATOR`` …, or
``CVDM_DISTRIBUTED=1`` under ``torch.distributed.run``) every process
distills data parallel on its shard of the files, on
``parallel.local_device``.

The sampler-regression recipe of the committed 1-step student::

    python -m cv_diffusion_tpu_torch.distill --teacher T --data_dir D \\
        --val_dir V --regression --student_timesteps 739 --teacher_steps 8 \\
        --gt_weight 0.3 --epochs 20 --batch_size 16 --lr 2e-5
"""

from __future__ import annotations

import argparse
import sys

REFERENCE_PAIRING_WARNING = (
    "WARNING: running with the reference-faithful timestep pairing "
    "(EMA target at the MORE-noised point, "
    "low_light_diffusion.py:344-351). Measured on-chip, this "
    "pairing collapses the student (19.3 -> 5.1 dB PSNR, "
    "BENCHMARKS.md quality gate) because the consistency recursion "
    "has no anchor at the data end. Pass --canonical or "
    "--sampler_matched for a properly anchored variant.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LCM consistency distillation (PyTorch port)",
        allow_abbrev=False)
    p.add_argument("--teacher", type=str, required=True,
                   help="Teacher weights in one of the port's layouts: a "
                        "save_params directory, a serving package, a full "
                        "checkpoint (.pt: its raw params, its EMA with "
                        "--teacher_ema), a weights .npz, or artifacts/<name>/ "
                        "beside artifacts_torch/<name>.npz")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--val_dir", type=str, default=None)
    p.add_argument("--use_synthetic", action="store_true")
    p.add_argument("--variant", type=str, default="small",
                   help="STUDENT architecture variant")
    p.add_argument("--teacher_variant", type=str, default=None,
                   help="teacher architecture when it differs from the "
                        "student (regression mode only); default: "
                        "auto-detect from the teacher artifact, falling "
                        "back to --variant")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=4,
                   help="Target LCM inference steps for the student")
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--ema_decay", type=float, default=0.95,
                   help="Distillation EMA (reference default 0.95)")
    p.add_argument("--init_student", type=str, default=None,
                   help="Warm-start the student (and its EMA copy) from an "
                        "existing student checkpoint / params dir instead of "
                        "the teacher — continue or stage a distillation run "
                        "(a full checkpoint gives its raw params, not its "
                        "EMA, as in the JAX CLI)")
    p.add_argument("--teacher_ema", action="store_true",
                   help="Use the teacher checkpoint's EMA weights (only "
                        "sensible when the teacher trained long enough for "
                        "EMA to converge: ~3/decay-complement steps); only a "
                        "full checkpoint holds an EMA, the other layouts "
                        "hold the selected weights and ignore it")
    p.add_argument("--canonical", action="store_true",
                   help="Canonical LCM timestep direction (EMA target one "
                        "teacher DDIM step closer to data) instead of the "
                        "reference's inverted pairing")
    p.add_argument("--pair_stride", type=int, default=None,
                   help="DDIM grid points per teacher step in --canonical "
                        "mode (default: the reference's N/num_steps skip; "
                        "1 = adjacent-point consistency distillation)")
    p.add_argument("--sampler_matched", action="store_true",
                   help="Distill over the deployed k-step LCM sampler's own "
                        "grid and stochastic renoise transitions instead of "
                        "DDIM trajectories")
    p.add_argument("--regression", action="store_true",
                   help="Sampler-to-sampler regression distillation: the "
                        "student's FULL m-step sampler output (its own "
                        "--student_timesteps grid) regresses onto the frozen "
                        "teacher's full --teacher_steps sampler output. The "
                        "1-step-student mode — the stock 1-step grid [19] is "
                        "degenerate by construction")
    p.add_argument("--student_timesteps", type=str, default="739",
                   help="Comma-separated descending student grid for "
                        "--regression (default '739': one high-t step)")
    p.add_argument("--teacher_steps", type=int, default=None,
                   help="Teacher sampler steps for --regression "
                        "(default: --num_steps)")
    p.add_argument("--deterministic_teacher", action="store_true",
                   help="Use the renoise-free DDIM-style teacher sampler as "
                        "the regression target")
    p.add_argument("--regression_full_grad", action="store_true",
                   help="With --regression and a multi-step grid: backprop "
                        "through ALL student steps instead of the default "
                        "final-step-only (stop-grad prefix); needs about m "
                        "times the activation memory")
    p.add_argument("--gt_weight", type=float, default=0.0,
                   help="Mix a ground-truth huber anchor into the "
                        "regression loss: (1-w)*teacher + w*gt")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="Compute dtype for the distillation forwards. "
                        "bfloat16 trains the student in the SERVING dtype "
                        "(a student validated in f32 can lose ~0.8 dB when "
                        "sampled in bf16)")
    p.add_argument("--use_pallas", action="store_true",
                   help="Read and ignored: linear attention always runs "
                        "through the port's CUDA kernels (forward and "
                        "backward)")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize blocks in the student's backward pass")
    p.add_argument("--data_on_device", action="store_true",
                   help="Cache the decoded training set on the device "
                        "(uint8) and augment there")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to distill on (default: cuda)")
    return p


def main(argv=None):
    """Parse ``argv``, distill, and return the trainer after ``train()``."""
    args = build_parser().parse_args(argv)
    if not (args.canonical or args.sampler_matched or args.regression):
        print(REFERENCE_PAIRING_WARNING, file=sys.stderr)

    from .config import TrainConfig, diffusion_config
    from .data.dataset import create_dataloaders
    from .models.diffusion import create_model
    from .parallel import distributed_init, local_device
    from .training import checkpoint as ckpt
    from .training.trainer import DistillationTrainer

    # a process group from the CVDM_* or torch.distributed.run environment
    # (none without it): the trainer is then data parallel over it
    distributed_init(device=args.device)
    args.device = local_device(args.device)

    # the student inherits the teacher's prediction target (its saved
    # model_config.json carries it on); a v-prediction teacher distilled
    # under an epsilon schedule gives garbage
    pred_type = ckpt.load_prediction_type(args.teacher) or "epsilon"
    if pred_type != "epsilon":
        print(f"Prediction type: {pred_type} (auto-detected from teacher)")

    def model_for(variant):
        return create_model(diffusion_config(
            variant, image_size=args.image_size,
            num_inference_steps=args.num_steps, dtype=args.dtype,
            prediction_type=pred_type, use_pallas=args.use_pallas,
            remat=args.remat), device=args.device)

    model, schedule = model_for(args.variant)
    teacher_variant = (args.teacher_variant or ckpt.detect_variant(args.teacher)
                       or args.variant)
    teacher_model = None
    if teacher_variant != args.variant:
        print(f"Teacher variant: {teacher_variant} (student: {args.variant})")
        teacher_model, _ = model_for(teacher_variant)
    teacher = ckpt.load_inference_params(ckpt.resolve_weights(args.teacher),
                                         use_ema=args.teacher_ema)
    student = None
    if args.init_student is not None:
        student = ckpt.load_inference_params(ckpt.resolve_weights(args.init_student),
                                             use_ema=False)

    train_loader, val_loader = create_dataloaders(
        args.data_dir, args.val_dir, batch_size=args.batch_size,
        image_size=args.image_size, use_synthetic=args.use_synthetic,
        seed=args.seed, device_cache=args.data_on_device, device=args.device)
    cfg = TrainConfig(unet_variant=args.variant, image_size=args.image_size,
                      num_inference_steps=args.num_steps, epochs=args.epochs,
                      batch_size=args.batch_size, learning_rate=args.lr,
                      checkpoint_dir=args.checkpoint_dir,
                      output_dir=args.output_dir, seed=args.seed)
    student_ts = None
    if args.regression:
        student_ts = tuple(
            int(t) for t in args.student_timesteps.split(",") if t.strip())
    trainer = DistillationTrainer(
        model, schedule, teacher, train_loader, val_loader, cfg,
        num_ddim_timesteps=args.num_ddim_timesteps, ema_decay=args.ema_decay,
        canonical=args.canonical, pair_stride=args.pair_stride,
        sampler_matched=args.sampler_matched, student_params=student,
        regression=args.regression, student_timesteps=student_ts,
        teacher_steps=args.teacher_steps,
        deterministic_teacher=args.deterministic_teacher,
        gt_weight=args.gt_weight, full_grad=args.regression_full_grad,
        teacher_model=teacher_model)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
