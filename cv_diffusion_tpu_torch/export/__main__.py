"""Export CLI of the port: ``python -m cv_diffusion_tpu_torch.export``.

Counterpart of ``scripts/export.py``, its flags and defaults, and
``--device`` (default ``cuda``): weights → a serving package
(``export.serving.create_serving_package``), optionally quantized
(``bf16``, ``int8`` weights, or ``int8_act``: int8 activation compute, whose
scales are calibrated first on ``--calib_batches`` batches of 8 pairs from
``--calib_dir``'s ``{low,high}/`` images, ``export.quantization.
calibrate_act_scales``, t and the noise drawn from a generator seeded 0),
then optionally benchmarked.

``--checkpoint`` takes the port's layouts (a full checkpoint, a weights
``.npz``, a ``save_params`` directory, a serving package, or a committed
artifact's ``artifacts/<name>/``, whose weights are
``artifacts_torch/<name>.npz``: ``training.checkpoint.resolve_weights``).
The grid comes from ``--timesteps``, else from the checkpoint's
``student_timesteps.json`` or a package's recorded grid, as in JAX.
``--graph`` raises: the JAX package's StableHLO sampler has no PyTorch
counterpart (the pipeline captures a CUDA graph when it serves).

    python -m cv_diffusion_tpu_torch.export --checkpoint artifacts/vreg1b_gt03_ema \\
        --output pkg --quantize int8_act --calib_dir data/our485
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..inference import parse_timesteps

CALIB_BATCH = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export model for serving (PyTorch port)",
                                allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Weights in one of the port's layouts: a full checkpoint "
                        "(.pt), a weights .npz, a save_params directory, a serving "
                        "package, or artifacts/<name>/ beside "
                        "artifacts_torch/<name>.npz")
    p.add_argument("--output", type=str, default="export_package")
    p.add_argument("--variant", type=str, default="small")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "bf16", "int8", "int8_act"])
    p.add_argument("--calib_dir", type=str, default=None,
                   help="With --quantize int8_act: paired dataset dir "
                        "(root/{low,high}/) for PTQ activation calibration")
    p.add_argument("--calib_batches", type=int, default=4,
                   help="Calibration batches (batch 8) drawn from --calib_dir")
    p.add_argument("--graph", action="store_true",
                   help="Refused: the StableHLO sampler graph has no PyTorch "
                        "counterpart")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--dynamic_batch", action="store_true",
                   help="Record a dynamic batch dimension in model_config.json")
    p.add_argument("--deterministic", action="store_true",
                   help="Package the renoise-free DDIM-style sampler (recorded "
                        "in model_config.json; pipelines built from the "
                        "package inherit it)")
    p.add_argument("--timesteps", type=str, default=None,
                   help="Comma-separated descending timestep grid overriding "
                        "the stock LCM grid (auto-detected from the "
                        "checkpoint's student_timesteps.json when present)")
    p.add_argument("--use_ema", action="store_true",
                   help="From a full checkpoint (.pt): export its EMA weights "
                        "(without: its raw parameters). Ignored, with a "
                        "warning, for a weights file, a save_params directory "
                        "or a serving package, which hold the already-selected "
                        "weights")
    p.add_argument("--benchmark", action="store_true",
                   help="Benchmark the exported package after writing it")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to calibrate and benchmark on (default: cuda)")
    return p


def calibration_batches(calib_dir: str, image_size: int, count: int):
    """The first ``count`` batches of 8 pairs of ``calib_dir``, centre
    crops without augmentation (JAX ``scripts/export.py:109-118``)."""
    from ..data.dataset import DataLoader, LowLightDataset

    loader = DataLoader(LowLightDataset(calib_dir, image_size=image_size,
                                        augment_data=False), CALIB_BATCH)
    batches = []
    for i, batch in enumerate(loader):
        if i >= count:
            break
        batches.append(batch)
    return batches


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    if args.quantize == "int8_act" and not args.calib_dir:
        p.error("--quantize int8_act requires --calib_dir")
    if args.graph:
        raise NotImplementedError(
            "--graph: the JAX package's StableHLO sampler has no PyTorch "
            "counterpart; on a CUDA device ServingPipeline captures the "
            "sampler as a CUDA graph when it serves")

    import torch

    from ..config import diffusion_config
    from ..models.diffusion import create_model
    from ..training import checkpoint as ckpt
    from .quantization import act_quant_model, calibrate_act_scales
    from .serving import ServingPipeline, create_serving_package

    model_cfg = diffusion_config(args.variant, image_size=args.image_size,
                                 num_inference_steps=args.num_steps,
                                 prediction_type=ckpt.load_prediction_type(
                                     args.checkpoint) or "epsilon")
    params = ckpt.load_inference_params(ckpt.resolve_weights(args.checkpoint),
                                        use_ema=args.use_ema)
    model, schedule = create_model(model_cfg, device=args.device)
    model.load_state_dict(params, strict=True)
    timesteps = parse_timesteps(args.checkpoint, args.timesteps)

    act_scales = None
    if args.quantize == "int8_act":
        batches = calibration_batches(args.calib_dir, args.image_size,
                                      args.calib_batches)
        qmodel, _ = act_quant_model(model_cfg, device=args.device)
        qmodel.load_state_dict(params, strict=True)
        act_scales = calibrate_act_scales(
            qmodel, schedule, batches,
            generator=torch.Generator(device=model.unet.init_conv.weight.device).manual_seed(0))
        print(f"Calibrated act_scales on {len(batches)} batches")

    files = create_serving_package(
        args.output, model, schedule, num_inference_steps=args.num_steps,
        quantize=args.quantize, batch_size=args.batch_size,
        act_scales=act_scales, dynamic_batch=args.dynamic_batch,
        deterministic=args.deterministic, timesteps=timesteps)
    print("Exported package:")
    for k, v in files.items():
        print(f"  {k}: {v}")

    if args.benchmark:
        pipe = ServingPipeline.from_package(args.output, device=args.device,
                                            image_size=args.image_size)
        stats = pipe.benchmark(num_runs=10)
        print("\nBenchmark:")
        for k, v in stats.items():
            print(f"  {k}: {v:.2f}")


if __name__ == "__main__":
    main(sys.argv[1:])
