"""Inference CLI of the port: ``python -m cv_diffusion_tpu_torch.inference``.

Counterpart of ``scripts/inference.py``, its flags and defaults, and
``--device`` (default ``cuda``): an image file or a directory of images in,
enhanced PNGs out, per-image milliseconds and the folder's FPS. ``--model``
is a serving package (``--format package``) or weights in one of the port's
layouts (``--format checkpoint``: a full checkpoint, a weights ``.npz``, a
``save_params`` directory, or a committed artifact's ``artifacts/<name>/``,
whose weights are ``artifacts_torch/<name>.npz``). The variant, the
prediction type and the student's grid are read from the path given
(``student_timesteps.json``, ``model_config.json``), the weights from the
resolved one (``training.checkpoint.resolve_weights``).

Images are read with ``data/png.py`` (PNG and BMP) and written as PNG; a
JPEG is refused by name (no libjpeg where the card is), and an output is
always a PNG (a directory's outputs keep their stem, with ``.png``).
``--no_pallas`` is read and ignored: attention always runs through the
port's hand-written kernels, which launch on a CUDA device.

    python -m cv_diffusion_tpu_torch.inference --input photos/ --output out/ \\
        --model artifacts/vreg1b_gt03_ema [--batch_size 8] [--dtype float32]

:func:`parse_timesteps` and :func:`load_pipeline` are shared with the
evaluate and benchmark CLIs, as the JAX scripts share them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import load_timesteps
from .device import resolve_device

IMAGE_EXTENSIONS = (".png", ".bmp")
JPEG_EXTENSIONS = (".jpg", ".jpeg")
NO_PALLAS_HELP = ("Read and ignored: attention always runs through the port's "
                  "hand-written kernels (the JAX package's XLA path has no "
                  "counterpart here)")
USE_EMA_HELP = ("From a full training checkpoint (.pt): serve its EMA weights "
                "(without: its raw parameters). Ignored, with a warning, for a "
                "weights .npz, a save_params directory or a serving package, "
                "which hold the already-selected weights")


def parse_timesteps(model_path: str, timesteps_arg: Optional[str]
                    ) -> Optional[Tuple[int, ...]]:
    """``--timesteps``, or the grid recorded beside the weights
    (``student_timesteps.json``, or a serving package's
    ``model_config.json``), or None (JAX ``scripts/inference.py:21``):
    serving a distilled student on the stock grid would be wrong."""
    if timesteps_arg:
        return tuple(int(t) for t in timesteps_arg.split(",") if t.strip())
    marker = os.path.join(model_path, "student_timesteps.json")
    if os.path.isfile(marker):
        ts = load_timesteps(marker)
        print(f"Using recorded student timestep grid: {list(ts)}")
        return ts
    pkg_cfg = os.path.join(model_path, "model_config.json")
    if os.path.isfile(pkg_cfg):
        with open(pkg_cfg) as f:
            ts = json.load(f).get("timesteps")
        if ts:
            print(f"Using package timestep grid: {list(ts)}")
            return tuple(ts)
    return None


def load_checkpoint_model(model_path: str, variant: str, image_size: int,
                          num_steps: int, dtype: str, use_ema: bool, device):
    """(model, schedule, variant) for weights in one of the port's layouts:
    the variant and prediction type the path records (JAX
    ``scripts/inference.py:72-90``; a v-prediction model sampled as epsilon
    gives garbage), the weights from ``resolve_weights(model_path)``, loaded
    with ``strict=True``."""
    from .config import diffusion_config
    from .models.diffusion import create_model
    from .training import checkpoint as ckpt

    detected = ckpt.detect_variant(model_path)
    if detected and detected != variant:
        print(f"Variant: {detected} (auto-detected from artifact)")
        variant = detected
    pred_type = ckpt.load_prediction_type(model_path) or "epsilon"
    if pred_type != "epsilon":
        print(f"Prediction type: {pred_type} (auto-detected)")
    cfg = diffusion_config(variant, image_size=image_size,
                           num_inference_steps=num_steps, dtype=dtype,
                           prediction_type=pred_type)
    model, schedule = create_model(cfg, device=device)
    model.load_state_dict(ckpt.load_inference_params(
        ckpt.resolve_weights(model_path), use_ema=use_ema), strict=True)
    return model, schedule, variant


def load_pipeline(args, device):
    """The :class:`~.export.serving.ServingPipeline` that ``args`` (the
    inference CLI's flags) describe (JAX ``scripts/inference.py:45``). A
    package records its image size, steps, grid and sampler; flags override
    them only when given. A package's recorded ``use_pallas_irb`` is kept."""
    from .export.serving import ServingConfig, ServingPipeline

    timesteps = parse_timesteps(args.model, args.timesteps)
    if args.format == "package":
        return ServingPipeline.from_package(
            args.model, device=device, use_pallas_irb=None,
            image_size=args.image_size, num_inference_steps=args.num_steps,
            keep_aspect=not args.no_pad, seed=args.seed,
            batch_size=args.batch_size,
            deterministic=True if args.deterministic else None,
            timesteps=timesteps)
    cfg = ServingConfig(image_size=args.image_size or 256,
                        num_inference_steps=args.num_steps or 4,
                        keep_aspect=not args.no_pad, seed=args.seed,
                        batch_size=args.batch_size,
                        deterministic=args.deterministic, timesteps=timesteps)
    model, schedule, args.variant = load_checkpoint_model(
        args.model, args.variant, cfg.image_size, cfg.num_inference_steps,
        args.dtype, args.use_ema, device)
    return ServingPipeline(model, schedule, cfg, device=device)


def refuse_jpeg(paths: Sequence[Path]) -> None:
    """Raise ``ValueError`` naming every JPEG in ``paths``."""
    jpegs = [str(p) for p in paths if p.suffix.lower() in JPEG_EXTENSIONS]
    if jpegs:
        raise ValueError(
            f"JPEG input is not read by the port (no libjpeg where the card "
            f"is; data/png.py reads PNG and BMP): {', '.join(jpegs)}; convert "
            "these to PNG first")


def png_name(path: Path) -> str:
    return path.stem + ".png"


def enhance_file(pipe, in_path: Path, out_path: Path) -> float:
    """Enhance one file into the PNG ``out_path``; the seconds the request
    took (the pipeline returns its output on the host)."""
    from .data.png import read_image, write_png

    img = read_image(in_path)
    t0 = time.perf_counter()
    out = pipe(img)
    dt = time.perf_counter() - t0
    write_png(out_path, out)
    return dt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Low-light enhancement inference (PyTorch port)",
        allow_abbrev=False)
    p.add_argument("--input", type=str, required=True,
                   help="Input image or directory (PNG or BMP; JPEG refused)")
    p.add_argument("--output", type=str, default="enhanced",
                   help="Output PNG file or directory")
    p.add_argument("--model", type=str, required=True,
                   help="Weights (a full checkpoint .pt, a weights .npz, a "
                        "save_params directory, or artifacts/<name>/ beside "
                        "artifacts_torch/<name>.npz) or a serving package")
    p.add_argument("--format", type=str, default="checkpoint",
                   choices=["checkpoint", "package"])
    p.add_argument("--variant", type=str, default="small")
    p.add_argument("--image_size", type=int, default=None,
                   help="default: the package's recorded size, else 256")
    p.add_argument("--num_steps", type=int, default=None,
                   help="default: the package's recorded steps, else 4")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="Compute dtype of a checkpoint's model (float32 "
                        "weights either way); a package computes in its own")
    p.add_argument("--no_pad", action="store_true",
                   help="Plain resize instead of aspect-preserving pad")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true", help=USE_EMA_HELP)
    p.add_argument("--batch_size", type=int, default=1,
                   help="Device batch for folder mode (pipe.batch); "
                        "1 = per-image")
    p.add_argument("--no_pallas", action="store_true", help=NO_PALLAS_HELP)
    p.add_argument("--timesteps", type=str, default=None,
                   help="Comma-separated descending timestep grid overriding "
                        "the stock LCM grid (auto-detected from "
                        "student_timesteps.json when present)")
    p.add_argument("--deterministic", action="store_true",
                   help="Renoise-free DDIM-style sampling")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to serve on (default: cuda)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the CLI; returns ``{"outputs": [paths], "seconds": [per request
    or the batch call], "batch_size"}``."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    in_path, out_path = Path(args.input), Path(args.output)
    if in_path.is_file():
        files = [in_path]
    elif in_path.is_dir():
        files = sorted(f for f in in_path.iterdir()
                       if f.suffix.lower() in IMAGE_EXTENSIONS + JPEG_EXTENSIONS)
        if not files:
            raise SystemExit(f"No images found in {in_path}")
    else:
        raise FileNotFoundError(f"{in_path}: no such file or directory")
    refuse_jpeg(files)
    if in_path.is_file():
        if out_path.suffix == "":
            out_path = out_path / png_name(in_path)
        elif out_path.suffix.lower() != ".png":
            raise ValueError(f"{out_path}: the port writes PNG only")

    pipe = load_pipeline(args, args.device)

    if in_path.is_file():
        dt = enhance_file(pipe, in_path, out_path)
        print(f"{in_path.name}: {dt * 1000:.1f} ms → {out_path}")
        return {"outputs": [str(out_path)], "seconds": [dt], "batch_size": 1}

    outputs = [out_path / png_name(f) for f in files]
    if args.batch_size > 1:
        from .data.png import read_images, write_png

        imgs = read_images(files)
        t0 = time.perf_counter()
        outs = pipe.batch(imgs)
        dt = time.perf_counter() - t0
        for path, out in zip(outputs, outs):
            write_png(path, out)
        print(f"{len(files)} images | batch {args.batch_size} | "
              f"{dt:.2f} s total | {len(files) / dt:.2f} FPS "
              f"(includes graph capture)")
        return {"outputs": [str(p) for p in outputs], "seconds": [dt],
                "batch_size": args.batch_size}
    times: List[float] = []
    for f, path in zip(files, outputs):
        times.append(enhance_file(pipe, f, path))
        print(f"{f.name}: {times[-1] * 1000:.1f} ms")
    # the first request of a size captures its graph: left out of the FPS
    steady = times[1:] or times
    print(f"\n{len(files)} images | mean {np.mean(steady) * 1000:.1f} ms "
          f"| {1.0 / np.mean(steady):.2f} FPS (steady-state)")
    return {"outputs": [str(p) for p in outputs], "seconds": times,
            "batch_size": 1}


if __name__ == "__main__":
    main(sys.argv[1:])
