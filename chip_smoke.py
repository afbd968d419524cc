#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cv_diffusion_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one JSON line each on stdout (warnings and build logs go to stderr):

1. device  -- the card's name and power limit (``nvidia-smi``).
2. build   -- the hand-written kernels, built with ``nvcc`` from ``csrc/``.
3. kernel  -- each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and the JAX tests' edge shapes, with CUDA-event
   times per call (``*_ms``, host launch cost included; ``*_graph_ms``, one
   call replayed from a CUDA graph, device time alone) and the least time
   the card could take (``bound``).
4. serve   -- the main path at full width: ``ServingPipeline`` for the small
   1-step student (``artifacts/vreg1b_gt03_ema``, grid [739]) and the 2-step
   one (``vreg2b_gt03_ema``, [739, 259]) at 256², random weights from a seed.
   Single requests of several sizes and a batch of 8; launch counts against
   UNet calls; latency, images/s and peak memory at steady state.
5. check   -- the kernel against its plain version on ``mid_attn``'s own
   q/k/v, and the card's sampler output against the CPU's on the same
   weights and noise.
6. profile -- only with ``--profile``: where the card's time goes when the
   1-step student serves, from ``torch.profiler`` over five single requests
   (480×720) and five batches of 8. Wall and device time per request, the
   device's busy share, kernels per request, device time by kind and the
   top kernels.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs one CUDA device and the
repository beside it; only ``model_config.json`` and
``student_timesteps.json`` are read from ``artifacts/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
STUDENTS = (("vreg1b_gt03_ema", (739,)), ("vreg2b_gt03_ema", (739, 259)))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_pallas_kernels.py:43,60
SAMPLER_TOL = 5e-3            # README "Testing": full sampler vs reference


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# kernel name fragments → kind, first match wins (profile phase)
KINDS = (
    ("linear_attention", ("reduce_kv", "apply_kv")),
    ("conv", ("conv", "cudnn", "implicit", "xmma", "winograd", "fft",
              "depthwise", "dgrad", "wgrad", "fprop")),
    ("gemm", ("gemm", "sgemm", "cutlass", "ampere", "sm90", "magma")),
    ("reduction", ("reduce", "mean", "sum")),
    ("interpolate", ("upsample", "interp")),
    ("copy/cat", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile(label: str, fn, requests_per_run: int, runs: int = 5) -> None:
    """Trace ``runs`` calls of ``fn`` with ``torch.profiler`` and emit where
    the card's time went, per request."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    require(bool(kernels), "the profiler traced no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:                     # union of kernel intervals (µs)
        if e > end:
            busy += e - max(s, end)
            end = e
    active = spans[-1][1] - spans[0][0]
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    n = runs * requests_per_run
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", run=label,
         wall_ms_per_request=wall * 1e3 / n,
         device_ms_per_request=sum(by_kind.values()) / 1e3 / n,
         device_busy_share_of_active_span=busy / active,
         device_busy_share_of_wall=busy / (wall * 1e6),
         kernels_per_request=len(kernels) / n,
         ms_per_request_by_kind={k: v / 1e3 / n for k, v in
                                 sorted(by_kind.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"name": name[:90], "ms_per_request": t / 1e3 / n,
                       "calls_per_request": c / n} for name, (t, c) in top])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace the 1-step student's serving with "
                             "torch.profiler")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from cv_diffusion_tpu_torch.config import load_model_config
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.ops.attention import linear_attention_plain
    from cv_diffusion_tpu_torch.weights import init_weights

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device -----------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0].strip()
    emit("device", nvidia_smi=smi_line, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, seconds=time.perf_counter() - t0)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = lak.build()
    print(built.log, file=sys.stderr)
    emit("build", kernel="linear_attention", library=os.path.relpath(built.path, ROOT),
         compiled=built.compiled, seconds=time.perf_counter() - t0)

    # 3. kernel vs plain --------------------------------------------------
    def cuda_ms(fn, iters=200, warmup=20) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn) -> float:
        """Device time of one call, without the host's launch cost: the
        call captured once in a CUDA graph and replayed."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay)

    def bound(shape, dtype):
        b, n, h, d = shape
        elems = b * n * h * d
        moved = 4 * elems * torch.tensor([], dtype=dtype).element_size()
        flops = elems * (4 * d + 6)   # kv, num: 2·D each; ksum, den, φ, divide
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations", moved, flops)

    def compare(q, k, v):
        out = lak.linear_attention_kernel(q, k, v)
        again = lak.linear_attention_kernel(q, k, v)
        ref = linear_attention_plain(q, k, v)
        torch.cuda.synchronize()
        require(out.dtype == q.dtype and out.shape == q.shape,
                f"kernel output {out.dtype} {tuple(out.shape)}")
        require(torch.equal(out, again), "kernel reruns differ")
        return float((out.float() - ref.float()).abs().max())

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = ([((b, 1024, 4, 32), dt, True) for b in (1, 8)
              for dt in (torch.float32, torch.bfloat16)]
             + [(s, torch.float32, False)
                for s in ((2, 256, 4, 32), (1, 1000, 4, 32), (2, 64, 2, 32),
                          (1, 128, 1, 128), (1, 128, 6, 32), (1, 192, 8, 32),
                          (2, 300, 3, 64))]
             + [((1, 128, 1, 128), torch.bfloat16, False)])
    timings = {}
    for shape, dtype, timed in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        name = str(dtype).replace("torch.", "")
        err = compare(q, k, v)
        require(err <= TOL[name], f"kernel vs plain {shape} {name}: {err}")
        row = dict(shape=list(shape), dtype=name, max_err=err, tol=TOL[name])
        if timed:
            bound_ms, bound_by, moved, flops = bound(shape, dtype)
            kernel = lambda: lak.linear_attention_kernel(q, k, v)  # noqa: E731
            plain = lambda: linear_attention_plain(q, k, v)  # noqa: E731
            row.update(
                kernel_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                kernel_graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                bytes=moved, flops=flops, library_ms=None,
                library="none: no single PyTorch call computes linear attention")
            timings[(shape, name)] = row
        emit("kernel", **row)
    emit("kernel_done", seconds=time.perf_counter() - t0)

    # 4. serve: the main path at full width --------------------------------
    t0 = time.perf_counter()
    art = [os.path.join(ROOT, "artifacts", name) for name, _ in STUDENTS]
    cfg = load_model_config(os.path.join(art[0], "model_config.json"))
    weights = init_weights(cfg, seed=0, device=dev)
    pipes = []
    for path, grid in zip(art, (g for _, g in STUDENTS)):
        pipe = ServingPipeline.from_config(
            os.path.join(path, "model_config.json"),
            os.path.join(path, "student_timesteps.json"), weights,
            device=dev, batch_size=8)
        require(pipe.config.timesteps == grid,
                f"{path}: grid {pipe.config.timesteps} != {grid}")
        pipes.append(pipe)

    unet_calls = [0]

    def count_call(module, args):
        unet_calls[0] += 1

    hooks = [p.model.unet.register_forward_pre_hook(count_call) for p in pipes]
    rng = np.random.default_rng(0)
    sizes = ((400, 600), (256, 256), (480, 720), (720, 480), (97, 301))
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    batch_images = [images[i % len(images)] for i in range(8)]

    def check_outputs(inputs, outputs):
        for img, out in zip(inputs, outputs):
            require(out.dtype == np.uint8 and out.shape == img.shape,
                    f"output {out.dtype} {out.shape} for input {img.shape}")
            require(int(out.max()) > int(out.min()), "constant output image")

    lak.linear_attention_kernel.launches = 0
    expected_calls = 0
    for pipe, (name, grid) in zip(pipes, STUDENTS):
        steps = len(grid)
        torch.cuda.reset_peak_memory_stats()
        outs = [pipe(img, seed=i) for i, img in enumerate(images)]
        check_outputs(images, outs)
        outs = pipe.batch(batch_images, seed=100)
        check_outputs(batch_images, outs)
        expected_calls += (len(images) + 1) * steps

        # steady state: single requests (host clock, the output is on the host)
        lat, stages = [], []
        for i in range(10):
            img = images[2]
            torch.cuda.synchronize()
            a = time.perf_counter()
            canvas, meta = pipe.pre(img)
            torch.cuda.synchronize()
            b = time.perf_counter()
            out = pipe._run(canvas, pipe._generator(i))
            torch.cuda.synchronize()
            c = time.perf_counter()
            res = pipe.post(out[0], meta)
            d = time.perf_counter()
            require(res.shape == img.shape, "steady-state output shape")
            lat.append((d - a) * 1e3)
            stages.append(((b - a) * 1e3, (c - b) * 1e3, (d - c) * 1e3))
        expected_calls += 10 * steps
        reps = 3
        torch.cuda.synchronize()
        a = time.perf_counter()
        for r in range(reps):
            outs = pipe.batch(batch_images, seed=200 + r)
        elapsed = time.perf_counter() - a
        check_outputs(batch_images, outs)
        expected_calls += reps * steps
        st = np.asarray(stages)
        with FlopCounterMode(display=False) as flop_counter:
            pipe(images[2], seed=0)
        expected_calls += steps
        row = dict(student=name, grid=list(grid), image=list(images[2].shape),
                   latency_ms_mean=float(np.mean(lat)),
                   latency_ms_p50=float(np.median(lat)),
                   latency_ms_min=float(np.min(lat)),
                   pre_ms=float(st[:, 0].mean()), sampler_ms=float(st[:, 1].mean()),
                   post_ms=float(st[:, 2].mean()),
                   batch=8, images_per_s=reps * 8 / elapsed,
                   conv_matmul_gflop_per_request=flop_counter.get_total_flops() / 1e9,
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        emit("serve", **row)
    launches = lak.linear_attention_kernel.launches
    for h in hooks:
        h.remove()
    require(unet_calls[0] == expected_calls,
            f"UNet calls {unet_calls[0]} != expected {expected_calls}")
    require(launches == unet_calls[0],
            f"kernel launches {launches} != UNet calls {unet_calls[0]} "
            "(one mid_attn per call)")
    emit("serve_done", unet_calls=unet_calls[0], kernel_launches=launches,
         seconds=time.perf_counter() - t0)

    # 5. checks on the main path's own tensors ------------------------------
    t0 = time.perf_counter()
    captured = {}

    def capture(module, args):
        captured["qkv"] = [a.detach().clone() for a in args]

    h = pipes[0].model.unet.mid_attn.attn.register_forward_pre_hook(capture)
    pipes[0](images[0], seed=0)
    h.remove()
    q, k, v = captured["qkv"]
    require(tuple(q.shape) == (1, 1024, 4, 32) and q.dtype == torch.float32,
            f"mid_attn q {q.dtype} {tuple(q.shape)}")
    mid_err = compare(q, k, v)
    require(mid_err <= TOL["float32"], f"mid_attn kernel vs plain: {mid_err}")

    # the card's sampler against the CPU's: same weights, same numpy noise
    small = 64
    cpu_model, cpu_sched = create_model(cfg, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in weights.items()})
    ref_rng = np.random.default_rng(1)
    low = ref_rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32)
    sampler_err = {}
    for pipe, (name, grid) in zip(pipes, STUDENTS):
        init = ref_rng.standard_normal((2, small, small, 3)).astype(np.float32)
        noise = ref_rng.standard_normal((len(grid), 2, small, small, 3)).astype(np.float32)
        got = enhance(pipe.model, pipe.schedule, torch.from_numpy(low),
                      timesteps=grid, init_noise=torch.from_numpy(init),
                      step_noise=torch.from_numpy(noise), device=dev).cpu()
        want = enhance(cpu_model, cpu_sched, torch.from_numpy(low),
                       timesteps=grid, init_noise=torch.from_numpy(init),
                       step_noise=torch.from_numpy(noise), device="cpu")
        require(bool(torch.isfinite(got).all()), "non-finite sampler output")
        err = float((got - want).abs().max())
        require(err <= SAMPLER_TOL, f"{name}: card vs CPU sampler {err}")
        sampler_err[name] = err
    emit("check", mid_attn_max_err=mid_err, mid_attn_shape=list(q.shape),
         sampler_vs_cpu_max_abs_err=sampler_err, sampler_tol=SAMPLER_TOL,
         seconds=time.perf_counter() - t0)

    # 6. profile (optional) -------------------------------------------------
    if args.profile:
        pipe = pipes[0]
        for _ in range(3):                  # warm-up: cuDNN plans, allocator
            pipe(images[2], seed=0)
            pipe.batch(batch_images, seed=0)
        profile("request_480x720_batch1", lambda: pipe(images[2], seed=1), 1)
        profile("batch8_mixed_sizes", lambda: pipe.batch(batch_images, seed=1), 8)

    # kernels line, nvidia-smi line, last line -----------------------------
    main_row = timings[((1, 1024, 4, 32), "float32")]
    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:82",
        "launches": launches,
        "max_abs_err": mid_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "graph_ms": main_row["kernel_graph_ms"],
        "plain_graph_ms": main_row["plain_graph_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
