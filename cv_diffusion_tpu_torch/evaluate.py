"""Quality of a model on a paired directory, or of a committed artifact on
the synthetic validation split.

    python -m cv_diffusion_tpu_torch.evaluate --data_dir D --model M \\
        [--seeds 5] [--batch_size 8] [--dtype float32] [--json out.json]
    python -m cv_diffusion_tpu_torch.evaluate --artifact vreg1b_gt03_ema \\
        --n 15 --size 256 --seed 0 --json out.json [--device cuda]
        [--use_pallas_irb] [--dtype bfloat16]

With ``--data_dir`` (:func:`evaluate_directory`), the port's counterpart of
``scripts/evaluate.py`` on any ``root/{low,high}/`` directory
(``data.dataset.LowLightDataset`` without augmentation: centre crops of
``--image_size``) and any model: a serving package (an int8_act one through
its int8-compute model, as JAX warns it must be) or weights in one of the
port's layouts (``inference.load_checkpoint_model``: the variant, the
prediction type and the grid from the path given, the weights from
``resolve_weights``). For each of ``--seeds`` seeds the noise of the whole
split is drawn by :data:`NOISE_RECIPE` and sliced per batch, so an image
gets the same noise at any ``--batch_size`` (a ragged last batch is run as
it is). ``--no_pallas`` is read and ignored: attention always runs through
the port's kernels.

With ``--artifact``, the port's counterpart of ``scripts/evaluate.py`` on
the split that ``scripts/make_synthetic_dataset.py`` writes as ``val`` (seed + 77,
procedural scenes only), made in memory (``data/synthetic.py``). The
sampler runs on explicit numpy noise (:data:`NOISE_RECIPE`), so another
implementation given the same recipe draws the same noise; the JAX
package's ``evaluate.py`` draws it with ``jax.random`` instead, so its
dumps pair with this one's by file name but not noise for noise.
Per image, as ``scripts/evaluate.py:136-150`` does: the prediction
denormalised and clipped to [0, 1] in float, the target denormalised from
the normalised uint8, then PSNR, SSIM, MAE, MS-SSIM (``null`` below 176²,
where its five scales do not fit) and GMSD. The JSON has the shape of
``benchmarks/evals_r5/*.json`` (``scripts/compare_eval.py`` pairs two).
``--dtype bfloat16`` computes in bf16 on the artifact's float32 weights
(``models.diffusion.with_dtype``); ``scripts/torch_port_eval_reference.py
--dtype bfloat16`` writes the JAX package's numbers for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import variant_of
from .data.augment import normalize
from .data.synthetic import make_split
from .device import pin_fp32, resolve_device
from .models.diffusion import denormalize_image, enhance, with_dtype
from .training import metrics

NOISE_RECIPE = ("init_noise = np.random.default_rng(seed).standard_normal("
                "(n, 3, size, size), dtype=np.float32), then for grids of more "
                "than one step step_noise = the same generator's "
                "standard_normal((steps, n, 3, size, size), dtype=np.float32), "
                "else zeros; channels-first, moved to NHWC for the sampler")
SPLIT_SEED_OFFSET = 77        # make_synthetic_dataset.py:140: val = seed + 77
MS_SSIM_MIN_SIZE = 176        # 11·2⁴: MS-SSIM's five scales
BATCH_SIZE = 8                # scripts/evaluate.py's default
METRICS = ("psnr", "ssim", "mae", "ms_ssim", "gmsd")


def eval_split(n: int, size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(low, high) uint8 [n, size, size, 3]: the validation split of
    ``make_synthetic_dataset.py --seed seed``."""
    return make_split(n, size, seed + SPLIT_SEED_OFFSET)


def eval_noise(n: int, size: int, seed: int, steps: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(init_noise [n, size, size, 3], step_noise [steps, n, size, size, 3]),
    float32, drawn as :data:`NOISE_RECIPE` says."""
    rng = np.random.default_rng(seed)
    init = rng.standard_normal((n, 3, size, size), dtype=np.float32)
    if steps > 1:
        step = rng.standard_normal((steps, n, 3, size, size), dtype=np.float32)
    else:
        step = np.zeros((steps, n, 3, size, size), np.float32)
    return (np.ascontiguousarray(init.transpose(0, 2, 3, 1)),
            np.ascontiguousarray(step.transpose(0, 1, 3, 4, 2)))


def sha256(a: np.ndarray) -> str:
    """SHA-256 of an array's bytes in C order."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def input_hashes(low: np.ndarray, high: np.ndarray, init: np.ndarray
                 ) -> List[Dict[str, str]]:
    """Per image, the SHA-256 of its low and high uint8 arrays [S, S, 3] and
    of its init noise in the recipe's channels-first layout [3, S, S]."""
    return [{"low": sha256(lo), "high": sha256(hi),
             "noise": sha256(nz.transpose(2, 0, 1))}
            for lo, hi, nz in zip(low, high, init)]


def per_image_metrics(pred: torch.Tensor, target: torch.Tensor
                      ) -> Dict[str, List[Optional[float]]]:
    """The five metrics of each image of ``pred``/``target`` [B, H, W, 3] in
    [0, 1], each image on its own (``ms_ssim`` None below 176²)."""
    with_ms = min(pred.shape[1:3]) >= MS_SSIM_MIN_SIZE
    out: Dict[str, List[Optional[float]]] = {k: [] for k in METRICS}
    for p, t in zip(pred, target):
        p, t = p[None], t[None]
        out["psnr"].append(float(metrics.psnr(p, t)))
        out["ssim"].append(float(metrics.ssim(p, t)))
        out["mae"].append(float(metrics.mae(p, t)))
        out["ms_ssim"].append(float(metrics.ms_ssim(p, t)) if with_ms else None)
        out["gmsd"].append(float(metrics.gmsd(p, t)))
    return out


@torch.inference_mode()
def enhance_unit(model, schedule, low: np.ndarray, init: np.ndarray,
                 step: np.ndarray, grid: Sequence[int], device="cuda",
                 deterministic: bool = False) -> torch.Tensor:
    """The sampler's output [B, S, S, 3] in [0, 1], clipped, on ``device``,
    for the normalised batch ``low`` and its explicit noise; contiguous, as
    the metrics' sums then run in one order whatever the batching."""
    out = enhance(model, schedule, torch.from_numpy(low), timesteps=grid,
                  init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(step),
                  deterministic=deterministic, device=resolve_device(device))
    return denormalize_image(out.float()).clamp(0.0, 1.0).contiguous()


@torch.inference_mode()
def enhance_split(model, schedule, low_u8: np.ndarray, init: np.ndarray,
                  step: np.ndarray, grid: Sequence[int], device="cuda") -> torch.Tensor:
    """The sampler's output [n, S, S, 3] in [0, 1], clipped, on ``device``:
    ``low_u8`` normalised as the dataset does, in batches of
    :data:`BATCH_SIZE`, each image with its own explicit noise."""
    return torch.cat([
        enhance_unit(model, schedule, normalize(low_u8[s:s + BATCH_SIZE]),
                     init[s:s + BATCH_SIZE], step[:, s:s + BATCH_SIZE], grid, device)
        for s in range(0, len(low_u8), BATCH_SIZE)])


def target_unit(high_u8: np.ndarray, device) -> torch.Tensor:
    """The targets [n, S, S, 3] in [0, 1] as the evaluation sees them:
    normalised, then denormalised."""
    return denormalize_image(torch.from_numpy(normalize(high_u8))).to(
        resolve_device(device))


def to_u8(pred: torch.Tensor) -> np.ndarray:
    """``clip(pred·255, 0, 255)`` cast to uint8 by truncation, on the host
    (``scripts/evaluate.py:150``)."""
    return (pred * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()


def summary(per_image: Dict[str, List[Optional[float]]]) -> Dict[str, Optional[float]]:
    def mean(k):
        vals = per_image[k]
        return None if any(v is None for v in vals) else float(np.mean(vals))
    return {"psnr_mean": mean("psnr"), "psnr_std_across_seeds": 0.0,
            "ssim_mean": mean("ssim"), "mae_mean": mean("mae"),
            "ms_ssim_mean": mean("ms_ssim"), "gmsd_mean": mean("gmsd")}


def evaluate_artifact(artifact: str, n: int = 15, size: int = 256, seed: int = 0,
                      use_pallas_irb: bool = False, device="cuda",
                      dtype: str = "float32") -> Dict:
    """The JSON payload of one evaluation run (see the module docstring),
    with ``inputs`` (the per-image SHA-256s) and ``seconds``."""
    from .export.serving import ServingPipeline

    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32()
    pipe = ServingPipeline.from_artifact(artifact, dev,
                                         use_pallas_irb=use_pallas_irb)
    model = pipe.model if dtype == "float32" else with_dtype(pipe.model, dtype)
    grid = list(pipe.config.timesteps)
    low, high = eval_split(n, size, seed)
    init, step = eval_noise(n, size, seed, len(grid))
    t0 = time.perf_counter()
    pred = enhance_split(model, pipe.schedule, low, init, step, grid, dev)
    per_image = per_image_metrics(pred, target_unit(high, dev))
    seconds = time.perf_counter() - t0
    per_image["files"] = [f"{i:05d}.png" for i in range(n)]
    return {"model": artifact + ("+use_pallas_irb" if use_pallas_irb else "")
            + ("" if dtype == "float32" else f"+{dtype}"), "dtype": dtype,
            "variant": variant_of(dataclasses.asdict(pipe.model.config.unet)),
            "image_size": size, "num_steps": len(grid),
            "deterministic": False, "timesteps": grid,
            "noise": NOISE_RECIPE, "split": f"make_split({n}, {size}, {seed} + 77)",
            "seeds": {str(seed): per_image}, "summary": summary(per_image),
            "inputs": input_hashes(low, high, init), "device": str(dev),
            "seconds": seconds}


def load_model(model_path: str, variant: str, image_size: int, num_steps: int,
               dtype: str, use_ema: bool, device):
    """(model, schedule, variant) of ``--model``: a serving package of the
    port (its own model config: an int8_act package's int8-compute model, a
    recorded ``use_pallas_irb`` kept) or weights in one of the port's
    layouts (``inference.load_checkpoint_model``)."""
    from .export.serving import FRAMEWORK, load_serving_package
    from .inference import load_checkpoint_model

    cfg_path = os.path.join(model_path, "model_config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            is_package = json.load(f).get("framework") == FRAMEWORK
        if is_package:
            model, schedule, _, pkg = load_serving_package(model_path, device,
                                                           use_pallas_irb=None)
            print(f"Package: quantization={pkg.get('quantization')}")
            return model, schedule, variant_of(dataclasses.asdict(model.config.unet))
    return load_checkpoint_model(model_path, variant, image_size, num_steps, dtype,
                                 use_ema, device)


def evaluate_directory(data_dir: str, model_path: str, *, variant: str = "small",
                       image_size: int = 256, num_steps: int = 4,
                       batch_size: int = BATCH_SIZE, dtype: str = "bfloat16",
                       seed: int = 0, seeds: int = 1, use_ema: bool = False,
                       save_outputs: Optional[str] = None,
                       deterministic: bool = False, timesteps: Optional[str] = None,
                       device="cuda") -> Dict:
    """The JSON payload of ``scripts/evaluate.py`` (``:237-262``, the shape
    of ``benchmarks/evals_r5/*.json``) for ``model_path`` on the paired
    directory ``data_dir``: per seed, per image PSNR, SSIM, MAE, MS-SSIM
    (None below 176²) and GMSD, and their summary."""
    from .data.dataset import DataLoader, LowLightDataset
    from .data.png import write_png
    from .inference import parse_timesteps, png_name
    from .models.scheduler import lcm_timesteps

    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32()
    model, schedule, variant = load_model(model_path, variant, image_size, num_steps,
                                          dtype, use_ema, dev)
    loader = DataLoader(LowLightDataset(data_dir, image_size=image_size,
                                        augment_data=False), batch_size)
    recorded = parse_timesteps(model_path, timesteps)
    grid = (list(recorded) if recorded else lcm_timesteps(
        num_steps, schedule.config.num_train_timesteps,
        schedule.config.original_inference_steps))
    print(f"Timestep grid: {grid}")
    n = len(loader.dataset)
    per_seed: Dict[str, Dict[str, list]] = {}
    for s in range(seed, seed + seeds):
        init, step = eval_noise(n, image_size, s, len(grid))
        per: Dict[str, list] = {k: [] for k in METRICS + ("files",)}
        start = 0
        for batch in loader:
            stop = start + len(batch["filenames"])
            pred = enhance_unit(model, schedule, batch["low_light"], init[start:stop],
                                step[:, start:stop], grid, dev, deterministic)
            target = denormalize_image(torch.from_numpy(batch["normal_light"])).to(dev)
            for k, v in per_image_metrics(pred, target).items():
                per[k] += v
            per["files"] += batch["filenames"]
            if save_outputs and s == seed:
                for name, img in zip(batch["filenames"], to_u8(pred)):
                    write_png(os.path.join(save_outputs, png_name(Path(name))), img)
            if seeds == 1:
                for i in range(start, stop):
                    print(f"{per['files'][i]}: psnr={per['psnr'][i]:.2f} dB  "
                          f"ssim={per['ssim'][i]:.4f}")
            start = stop
        per_seed[str(s)] = per
        print(f"seed {s}: {n} images | PSNR {np.mean(per['psnr']):.2f} ± "
              f"{np.std(per['psnr']):.2f} dB | SSIM {np.mean(per['ssim']):.4f} | "
              f"MAE {np.mean(per['mae']):.4f} | GMSD {np.mean(per['gmsd']):.4f}")
    means = {k: [float(np.mean(p[k])) for p in per_seed.values()]
             for k in ("psnr", "ssim", "gmsd")}
    with_ms = image_size >= MS_SSIM_MIN_SIZE
    summary = {"psnr_mean": float(np.mean(means["psnr"])),
               "psnr_std_across_seeds": float(np.std(means["psnr"])),
               "ssim_mean": float(np.mean(means["ssim"])),
               "ms_ssim_mean": float(np.mean([np.mean(p["ms_ssim"])
                                              for p in per_seed.values()]))
               if with_ms else None,
               "gmsd_mean": float(np.mean(means["gmsd"]))}
    print(f"\n{seeds} seed(s) | PSNR {summary['psnr_mean']:.2f} ± "
          f"{summary['psnr_std_across_seeds']:.2f} dB (across-seed std of means) | "
          f"SSIM {summary['ssim_mean']:.4f}")
    return {"model": model_path, "variant": variant, "image_size": image_size,
            "num_steps": num_steps, "deterministic": deterministic,
            "timesteps": None if recorded is None else [int(t) for t in recorded],
            "seeds": per_seed, "summary": summary}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                allow_abbrev=False)
    p.add_argument("--data_dir", default=None,
                   help="Paired eval set (root/{low,high}/); needs --model")
    p.add_argument("--model", default=None,
                   help="With --data_dir: weights (a full checkpoint .pt, a "
                        "weights .npz, a save_params directory, or "
                        "artifacts/<name>/ beside artifacts_torch/<name>.npz) "
                        "or a serving package of the port")
    p.add_argument("--variant", default="small")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    p.add_argument("--seeds", type=int, default=1,
                   help="With --data_dir: eval seeds seed..seed+N-1 (per-seed "
                        "means and the std across seeds)")
    p.add_argument("--use_ema", action="store_true",
                   help="From a full training checkpoint (.pt): evaluate its "
                        "EMA weights (without: its raw parameters); ignored, "
                        "with a warning, for a weights file, a save_params "
                        "directory or a package")
    p.add_argument("--save_outputs", default=None,
                   help="With --data_dir: write the first seed's outputs here "
                        "as PNG")
    p.add_argument("--deterministic", action="store_true",
                   help="Renoise-free DDIM-style sampling")
    p.add_argument("--timesteps", default=None,
                   help="Comma-separated descending grid (default: the "
                        "model's recorded student or package grid)")
    p.add_argument("--no_pallas", action="store_true",
                   help="Read and ignored: attention always runs through the "
                        "port's hand-written kernels")
    p.add_argument("--artifact", default="vreg1b_gt03_ema",
                   help="Without --data_dir: the committed artifact evaluated "
                        "on the in-memory synthetic split")
    p.add_argument("--n", type=int, default=15)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_pallas_irb", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="The compute dtype (float32 weights either way; a "
                        "package computes in its own); default bfloat16 with "
                        "--data_dir, as the JAX CLI, float32 with --artifact")
    p.add_argument("--json", default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = build_parser()
    args = p.parse_args(argv)
    resolve_device(args.device)
    if args.data_dir is not None:
        if args.model is None:
            p.error("--data_dir needs --model")
        payload = evaluate_directory(
            args.data_dir, args.model, variant=args.variant,
            image_size=args.image_size, num_steps=args.num_steps,
            batch_size=args.batch_size, dtype=args.dtype or "bfloat16",
            seed=args.seed, seeds=args.seeds, use_ema=args.use_ema,
            save_outputs=args.save_outputs, deterministic=args.deterministic,
            timesteps=args.timesteps, device=args.device)
    else:
        payload = evaluate_artifact(args.artifact, args.n, args.size, args.seed,
                                    args.use_pallas_irb, args.device,
                                    args.dtype or "float32")
        s = payload["summary"]
        print(f"{args.n} images | PSNR {s['psnr_mean']:.4f} dB | SSIM "
              f"{s['ssim_mean']:.4f} | MAE {s['mae_mean']:.4f} | MS-SSIM "
              f"{s['ms_ssim_mean']} | GMSD {s['gmsd_mean']:.4f} | "
              f"{payload['seconds']:.2f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    return payload


if __name__ == "__main__":
    main()
