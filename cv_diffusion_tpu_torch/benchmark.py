"""Benchmark CLI of the port: ``python -m cv_diffusion_tpu_torch.benchmark``.

Counterpart of ``scripts/benchmark.py``, its flags and defaults, and
``--device`` (default ``cuda``). Without ``--model``, the sampler of a
randomly initialised variant (``weights.init_weights``, seed 0) is timed at
each of ``--batch_sizes``: its input a uint8 canvas of values in [0, 64)
(the JAX script's uniform [-1, -0.5]), one warm-up call a batch size, which
on a CUDA device captures the sampler's CUDA graph (the counterpart of
JAX's ``jit``; its seconds are printed apart), then ``--num_runs`` calls
each between two synchronisations (JAX's ``block_until_ready``): rows with
the JAX script's keys. With ``--model`` (``--format checkpoint|package``,
as the inference CLI loads it) the pipeline's own ``benchmark()``, uint8 to
uint8 by stage. Both end with the 30-FPS verdict on batch-1 latency.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the timed
calls into DIR (``profiling.trace``). ``--no_pallas`` is read and ignored:
attention always runs through the port's hand-written kernels.

    python -m cv_diffusion_tpu_torch.benchmark --batch_sizes 1 8 32 --num_runs 10
    python -m cv_diffusion_tpu_torch.benchmark --model artifacts/vreg1b_gt03_ema
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .device import resolve_device
from .inference import NO_PALLAS_HELP, USE_EMA_HELP

REALTIME_FPS = 30.0
ROW_KEYS = ("batch", "mean_ms", "std_ms", "min_ms", "max_ms", "per_step_ms",
            "per_image_ms", "img_per_sec")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_sampler(args, device, profile: Optional[str] = None) -> Dict:
    """``{"rows": [one per batch size, the JAX script's keys], "warmup_s":
    {batch: seconds of the first call}, "trace": path or None}``."""
    import torch

    from .config import diffusion_config
    from .export.serving import ServingConfig, ServingPipeline
    from .models.diffusion import create_model
    from .profiling import trace
    from .weights import init_weights

    dev = resolve_device(device)
    cfg = diffusion_config(args.variant, image_size=args.image_size,
                           num_inference_steps=args.num_steps, dtype=args.dtype)
    model, schedule = create_model(cfg, device=dev)
    model.load_state_dict(init_weights(cfg, seed=0, device=dev), strict=True)
    pipe = ServingPipeline(model, schedule, ServingConfig(
        image_size=args.image_size, num_inference_steps=args.num_steps,
        seed=args.seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    size = args.image_size
    inputs = {b: torch.randint(0, 64, (b, size, size, 3), generator=gen,
                               dtype=torch.uint8, device=dev)
              for b in args.batch_sizes}
    warmup = {}
    for b, x in inputs.items():
        _sync(dev)
        t0 = time.perf_counter()
        pipe._run(x, pipe._generator(2))
        _sync(dev)
        warmup[b] = time.perf_counter() - t0
    rows: List[Dict[str, float]] = []
    with (trace(profile) if profile else contextlib.nullcontext()) as path:
        for b, x in inputs.items():
            times = []
            for i in range(args.num_runs):
                _sync(dev)
                t0 = time.perf_counter()
                pipe._run(x, pipe._generator(10 + i))
                _sync(dev)
                times.append(time.perf_counter() - t0)
            arr = np.asarray(times) * 1000
            rows.append({"batch": b, "mean_ms": float(arr.mean()),
                         "std_ms": float(arr.std()), "min_ms": float(arr.min()),
                         "max_ms": float(arr.max()),
                         "per_step_ms": float(arr.mean() / args.num_steps),
                         "per_image_ms": float(arr.mean() / b),
                         "img_per_sec": float(b / (arr.mean() / 1000))})
    return {"rows": rows, "warmup_s": warmup, "trace": path}


def verdict(mean_ms: float) -> str:
    budget_ms = 1000.0 / REALTIME_FPS
    word = "REAL-TIME ✓" if mean_ms <= budget_ms else "not real-time"
    return (f"Batch-1 end-to-end: {mean_ms:.1f} ms vs {budget_ms:.1f} ms budget "
            f"({REALTIME_FPS:.0f} FPS): {word}")


def benchmark_model(args, device) -> Dict:
    """The loaded pipeline's ``benchmark()`` (uint8 → uint8 by stage)."""
    from .inference import load_pipeline

    pipe = load_pipeline(args, device)
    stats = pipe.benchmark(num_runs=args.num_runs)
    print(f"\nEnd-to-end pipeline ({args.format}: {args.model}):")
    for k, v in stats.items():
        print(f"  {k:>16}: {v:.2f}")
    print("\n" + verdict(stats["mean_ms"]))
    return {"stats": stats}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Benchmark the sampler (PyTorch port)",
                                allow_abbrev=False)
    p.add_argument("--variant", type=str, default="small")
    p.add_argument("--image_size", type=int, default=None,
                   help="default: 256, or the package's recorded size")
    p.add_argument("--num_steps", type=int, default=None,
                   help="default: 4, or the package's recorded steps")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--num_runs", type=int, default=10)
    p.add_argument("--profile", type=str, default=None,
                   help="Write a torch.profiler Chrome trace of the timed "
                        "calls into this directory")
    p.add_argument("--model", type=str, default=None,
                   help="Benchmark a trained model (weights or a serving "
                        "package, as the inference CLI takes them) end to end "
                        "instead of a random-init variant")
    p.add_argument("--format", type=str, default="checkpoint",
                   choices=["checkpoint", "package"])
    p.add_argument("--use_ema", action="store_true", help=USE_EMA_HELP)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_pallas", action="store_true", help=NO_PALLAS_HELP)
    p.add_argument("--timesteps", type=str, default=None,
                   help="Explicit sampler grid (comma-separated); default: "
                        "the model's recorded student or package grid")
    p.add_argument("--deterministic", action="store_true",
                   help="Renoise-free DDIM-style sampler")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to benchmark on (default: cuda)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the inference CLI's flags that load_pipeline reads
    args.no_pad = False
    args.batch_size = 1
    if args.model:
        return benchmark_model(args, device)
    args.image_size = args.image_size or 256
    args.num_steps = args.num_steps or 4
    print(f"Benchmarking {args.variant} @ {args.image_size}px, "
          f"{args.num_steps} LCM steps, {args.dtype}")
    result = benchmark_sampler(args, device, args.profile)
    if result["trace"]:
        print(f"Trace written to {result['trace']} (chrome://tracing, Perfetto)")
    print("first call (graph capture on CUDA): " + ", ".join(
        f"batch {b} {s:.2f} s" for b, s in result["warmup_s"].items()))
    print(f"\n{'batch':>6} {'mean ms':>9} {'std':>7} {'min':>8} {'max':>8} "
          f"{'ms/step':>8} {'ms/img':>8} {'img/s':>9}")
    for r in result["rows"]:
        print(f"{r['batch']:>6} {r['mean_ms']:>9.2f} {r['std_ms']:>7.2f} "
              f"{r['min_ms']:>8.2f} {r['max_ms']:>8.2f} "
              f"{r['per_step_ms']:>8.2f} {r['per_image_ms']:>8.2f} "
              f"{r['img_per_sec']:>9.1f}")
    b1 = next((r for r in result["rows"] if r["batch"] == 1), None)
    if b1 is None:
        print("\n(no batch-1 row in --batch_sizes; skipping the real-time "
              "verdict: it is a single-image latency budget)")
    else:
        print("\n" + verdict(b1["mean_ms"]))
        if b1["mean_ms"] > 1000.0 / REALTIME_FPS:
            print("Suggestions: fewer LCM steps (--num_steps 2), smaller variant "
                  "(--variant tiny), int8 weights, or batch for throughput.")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
