"""Quality of a committed artifact on the synthetic validation split.

    python -m cv_diffusion_tpu_torch.evaluate --artifact vreg1b_gt03_ema \\
        --n 15 --size 256 --seed 0 --json out.json [--device cuda]
        [--use_pallas_irb] [--dtype bfloat16]

The port's counterpart of ``scripts/evaluate.py`` on the split that
``scripts/make_synthetic_dataset.py`` writes as ``val`` (seed + 77,
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
def enhance_split(model, schedule, low_u8: np.ndarray, init: np.ndarray,
                  step: np.ndarray, grid: Sequence[int], device="cuda") -> torch.Tensor:
    """The sampler's output [n, S, S, 3] in [0, 1], clipped, on ``device``:
    ``low_u8`` normalised as the dataset does, in batches of
    :data:`BATCH_SIZE`, each image with its own explicit noise."""
    dev = resolve_device(device)
    outs = []
    for s in range(0, len(low_u8), BATCH_SIZE):
        chunk = slice(s, s + BATCH_SIZE)
        out = enhance(model, schedule, torch.from_numpy(normalize(low_u8[chunk])),
                      timesteps=grid, init_noise=torch.from_numpy(init[chunk]),
                      step_noise=torch.from_numpy(step[:, chunk]), device=dev)
        outs.append(denormalize_image(out.float()).clamp(0.0, 1.0))
    return torch.cat(outs)


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


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    p.add_argument("--n", type=int, default=15)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_pallas_irb", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the compute dtype (float32 weights either way)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    payload = evaluate_artifact(args.artifact, args.n, args.size, args.seed,
                                args.use_pallas_irb, args.device, args.dtype)
    s = payload["summary"]
    print(f"{args.n} images | PSNR {s['psnr_mean']:.4f} dB | SSIM "
          f"{s['ssim_mean']:.4f} | MAE {s['mae_mean']:.4f} | MS-SSIM "
          f"{s['ms_ssim_mean']} | GMSD {s['gmsd_mean']:.4f} | "
          f"{payload['seconds']:.2f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
