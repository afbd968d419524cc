#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cv_diffusion_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one JSON line each on stdout (warnings and build logs go to stderr):

1. device  -- the card's name and power limit (``nvidia-smi``).
2. build   -- the hand-written kernels, each built with its own ``nvcc`` from
   ``csrc/``, all started together; for the fused IRB, every kernel's
   registers and spill bytes from the ptxas report (its output and pool
   passes must not spill).
3. kernel  -- each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and the JAX tests' edge shapes, with CUDA-event
   times per call (``*_ms``, host launch cost included; ``*_graph_ms``, one
   call replayed from a CUDA graph, device time alone) and the least time
   the card could take (``bound``; for the fused IRB also ``tc_bound_ms``,
   its products on the tensor cores: 3×TF32 or bf16). Linear attention,
   forward and backward, at ``mid_attn``'s shapes (batch 1 and 8), edge
   shapes (N = 1, 5, 100, 4096) and clusters of 16 at D = 64 and 128, each
   with its plan (cluster size C, shared memory) and its device kernels per
   call from ``torch.profiler`` (one each); the
   fused IRB, v2 and v1 (both GroupNorms' statistics in the kernel) side by
   side on the same inputs, at every distinct IRB shape of the small UNet at
   256², batch 1 and 8, and at the widest blocks of the base and large
   UNets (Cout 384 and 512); v1 also at the JAX tests' shapes (``tile_h=8``)
   and in bf16 at the widest block of each UNet level.
4. serve   -- the main path at full width, through the CUDA graphs: the
   committed 1-step student on its own weights
   (``ServingPipeline.from_artifact("vreg1b_gt03_ema")``:
   ``artifacts_torch/vreg1b_gt03_ema.npz``, grid [739]; the file's size and
   load time), the same student with ``use_pallas_irb=True`` (every IRB
   through the fused kernel), and ``vreg2b_gt03_ema``'s grid [739, 259] on
   the 1-step student's weights (the 2-step student's own are not in the
   tree; its line says ``"weights": "vreg1b_gt03_ema"``), at 256². Single
   requests of several sizes (the batch-1 graph is captured at the first),
   batches of 8 one chunk a call and ``REPS`` chunks pipelined in one call
   (the batch-8 graph), latency, images/s, peak memory and the memory the
   graphs hold, and the ``benchmark()`` dict (a ``benchmark`` line). Each
   configuration's kernel launches, with the counts set to 0 just before
   it: the wrappers' (each graph's warm-up and capture, one eager call) and
   those inside replays (replays times each graph's launches a replay).
5. graph   -- each configuration's graphs, batch 1 and 8, against its eager
   sampler on the same seed (uint8, equal or at most 1 LSB, the values off
   counted), capture seconds, eager and graph latency in paired runs, and
   from ``torch.profiler`` the host's CUDA launch calls and the device's
   kernels per sampler call and per request (a replay must run one
   attention kernel a UNet call, and the fused IRB's kernels when on).
6. package -- the student's serving packages, fp32, bf16 and int8, written
   into ``cv_diffusion_tpu_torch/_build/packages/``: bytes, the
   quantization report and error, write and load seconds; the loaded
   weights equal the codec's; the card's sampler on each package's weights
   against the CPU's on the same noise, unfused and fused (5e-3); each
   package served through ``from_package``, unfused and fused, at batch 1
   and 8 (latency, images/s, peak memory, launches).
7. check   -- each kernel against its plain version on the main path's own
   inputs (``mid_attn``'s q/k/v, ``decoder_blocks.3.0``'s x, taken from
   eager requests); on that x, the Gram fold's GN2⊕FiLM affine against the
   statistics of h1 itself (and the same fold in TF32, which that check
   must reject); ``fused_irb_v1`` on the x and FiLM of each of the 22 IRBs
   of one unfused request (its launch count set to 0 just before), against
   each block's own output and against v2, and its device-side GN affines
   at ``decoder_blocks.3.0`` against float64 statistics of x and h1; the
   card's sampler output against the CPU's on the same (trained) weights
   and noise, and the fused configuration's sampler against the unfused
   one's on the card.
8. eval    -- the student's quality on the card: the 15 pairs of the
   synthetic validation split at 256² and their noise, made anew
   (``cv_diffusion_tpu_torch.evaluate``) and held by SHA-256 to the JAX
   reference (``artifacts_torch/vreg1b_gt03_ema.eval_ref.json``); served
   unfused and fused (the counts set to 0 just before each), PSNR, SSIM,
   MAE, MS-SSIM and GMSD per image against the JAX package's values, images
   0 and 1 against JAX's uint8 outputs (``….eval_ref_u8.npz``), and the
   card's metrics against the CPU port's on the same outputs; then the bf16
   and int8 packages, unfused, per image against the JAX package's own
   packages of those codecs (``….eval_ref_bf16.json``, ``…_int8.json``).
9. profile -- only with ``--profile``: where the card's time goes when the
   1-step student serves through its graphs, unfused and fused, from
   ``torch.profiler`` over five single requests (480×720) and five batches
   of 8 (and, in the train phase, over three train steps). Wall and device
   time per request, the device's busy share, kernels per request, device
   time by kind and the top kernels; and, per configuration, the UNet
   blocks inside which an eager batch of 8 reaches its highest memory
   peaks.
10. train  -- the training path at full width: ``Trainer`` on the small
   UNet at 256² (v-prediction, float32, batch 8), random weights from seed
   0 and synthetic batches from a numpy seed. Two warm-up steps, then ten
   timed ones (``train_epoch``); ms per step, images/s, peak memory, and
   the attention kernels' forward and backward launches (one each a step),
   with the counts set to 0 just before; finite loss, gradient norm and
   gradients, and a non-zero gradient of ``mid_attn.to_qkv``. Then one
   step through the kernels against the same step with the attention on
   its plain autograd path, one step on the card against the CPU (small at
   64², batch 2), a validation pass, and a checkpoint save and restore.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs one CUDA device and the
repository beside it; only ``model_config.json`` and
``student_timesteps.json`` are read from ``artifacts/``, and the weights and
the JAX reference from ``artifacts_torch/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# (label, artifact, grid, use_pallas_irb); every row serves the weights of
# STUDENT, the one artifact whose weights are in the tree
STUDENT = "vreg1b_gt03_ema"
SERVED = (("vreg1b_gt03_ema", "vreg1b_gt03_ema", (739,), False),
          ("vreg2b_gt03_ema", "vreg2b_gt03_ema", (739, 259), False),
          ("vreg1b_gt03_ema+use_pallas_irb", "vreg1b_gt03_ema", (739,), True))
# the eval phase's bounds per image against the JAX package's values: PSNR
# 0.1 dB (scripts/parity_eval.py's gate), the others in their units; uint8
# outputs within 1 LSB (the sampler's 5e-3 is 0.64 LSB before the cast);
# the card's metrics against the CPU port's on the same outputs
EVAL_TOL = {"psnr": 0.1, "ssim": 2e-3, "mae": 1e-3, "ms_ssim": 2e-3, "gmsd": 2e-3}
EVAL_U8_TOL = 1
EVAL_CPU_REL_TOL = 1e-5
IRBS_PER_UNET_CALL = 22       # small UNet: 8 encoder, 2 middle, 12 decoder
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores ...
BF16_FLOPS_PER_S = 989e12     # ... and bf16
# the fused IRB's output and pool passes must not spill (ptxas report)
NO_SPILL_KERNELS = ("irb_out", "irb_pool")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_pallas_kernels.py:43,60
# linear attention's backward: 5e-4 in float32 (tests/test_pallas_kernels.py:
# 81); in bfloat16 the outputs are rounded to bf16 (8 bits) at |d| up to ~0.3,
# a few ulps of which is ~5e-3
BWD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
IRB_TOL = {"float32": 2e-4, "bfloat16": 5e-2}   # tests/test_pallas_kernels.py:172,252
SAMPLER_TOL = 5e-3            # README "Testing": full sampler vs reference
# a graph's uint8 output against eager's on the same seed: equal, unless
# cuDNN takes another algorithm under capture, then at most 1 LSB
GRAPH_LSB_TOL = 1
REPS = 10                     # chunks of 8 in the serve phase's batch timings
# the serving packages' codecs: (label, create_serving_package's quantize)
CODECS = (("fp32", "none"), ("bf16", "bf16"), ("int8", "int8"))
# one train step against another (kernels vs plain attention, card vs CPU):
# loss relative, the gradients' difference relative to their norm, each
# gradient's largest difference relative to its largest entry, and the share
# of parameter entries the update moved differently
# why: at the train phase
STEP_LOSS_TOL = 1e-5
STEP_GRAD_NORM_TOL = 1e-3      # ‖Δg‖ / ‖g‖ over all parameters
STEP_GRAD_TOL = 1e-2           # each tensor's max |Δg| / its max |g|
STEP_PARAM_TOL = 1e-6          # a parameter entry "differs" above this ...
STEP_PARAM_SHARE = 1e-2        # ... and at most this share of them may
# GN2⊕FiLM from the Gram fold against the same statistics taken two-pass from
# h1 itself, as max |Δ(h1·a2 + b2)| (values up to ~8): a float32 Gram is
# ~2e-6 off at the widest block's shape, one with TF32-rounded inputs ~4e-4
# (a CPU stand-in of that shape), so a TF32 fold fails this bound. fused_irb
# v1's own affines (GN1's on x, GN2⊕FiLM's on h1, from the kernel's one-pass
# float32 partials) are held to it against float64 statistics
FOLD_TOL = 5e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bf16_ulp(magnitude: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at ``magnitude``."""
    return 2.0 ** (math.floor(math.log2(magnitude)) - 7) if magnitude > 0 else 0.0


# kernel name fragments → kind, first match wins (profile phase)
KINDS = (
    ("linear_attention", ("linear_attention_fwd", "linear_attention_bwd")),
    ("fused_irb", ("irb_out", "irb_pool", "irb_se_fc", "irb_combine",
                   "irb_gn1_stats", "irb_gn_finalize")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fft",
              "depthwise", "dgrad", "wgrad", "fprop")),
    ("gemm", ("gemm", "sgemm", "cutlass", "ampere", "sm90", "magma")),
    ("reduction", ("reduce", "mean", "sum")),
    ("interpolate", ("upsample", "interp")),
    ("copy/cat", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas=-v``
    log, by a short name: ``irb_out<float,false,32>`` for the mangled
    ``..irb_outIfLb0ELi32EEE..``."""
    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            t = re.search(r"\d+((?:irb|linear)_\w+?)(?:I(.*?E)E|E)", mangled)
            args = re.findall(r"13__nv_bfloat16|f|L[bi]\d+E", (t and t.group(2)) or "")
            names = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}
            name = mangled if not t else t.group(1) + (
                "<" + ",".join(names.get(a, a[2:-1]) for a in args) + ">" if args else "")
            cur = kernels.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return kernels


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
    # device kernels only: not the GPU-side ranges of annotations such as
    # the optimizer's step
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
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
                        help="also trace the 1-step student's serving and "
                             "three train steps with torch.profiler")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from cv_diffusion_tpu_torch.config import (TrainConfig, diffusion_config,
                                               load_model_config)
    from cv_diffusion_tpu_torch.data.dataset import (DataLoader,
                                                     SyntheticLowLightDataset)
    from cv_diffusion_tpu_torch.models.diffusion import (diffusion_loss,
                                                        train_forward)
    from cv_diffusion_tpu_torch.models.unet import count_params
    from cv_diffusion_tpu_torch.training.train_state import (
        apply_update, create_train_state, make_train_step)
    from cv_diffusion_tpu_torch.training.trainer import Trainer
    from cv_diffusion_tpu_torch.device import pin_fp32
    from cv_diffusion_tpu_torch.export.quantization import (
        dequantize_int8, quantization_error, quantization_report, quantize_model)
    from cv_diffusion_tpu_torch.export.serving import (
        GRAPH_WARMUP, ServingPipeline, create_serving_package, kernel_launches,
        load_serving_package)
    from cv_diffusion_tpu_torch.models.blocks import (InvertedResidualBlock,
                                                      LinearAttention)
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance
    from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.ops.attention import (
        linear_attention_backward_plain, linear_attention_plain)
    from cv_diffusion_tpu_torch.ops import cuda_build
    from cv_diffusion_tpu_torch.ops.fused_irb import (folded_gn_scales,
                                                     fused_irb_v1_plain,
                                                     fused_irb_v2_plain, irb_args)
    from cv_diffusion_tpu_torch import evaluate as ev
    from cv_diffusion_tpu_torch.weights import init_weights, load_state_dict_npz

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    pin_fp32()   # the plain versions' convolutions in full f32, as served

    # 1. device -----------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0].strip()
    emit("device", nvidia_smi=smi_line, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, seconds=time.perf_counter() - t0)

    # 2. build: one nvcc per source, all started together -----------------
    def timed_build(module):
        start = time.perf_counter()
        return module.build(), time.perf_counter() - start

    t0 = time.perf_counter()
    wrappers = (("linear_attention", lak), ("fused_irb (v2, v1)", fik))
    with ThreadPoolExecutor(len(wrappers)) as pool:
        builds = list(pool.map(timed_build, (m for _, m in wrappers)))
    for (name, module), (built, seconds) in zip(wrappers, builds):
        print(built.log, file=sys.stderr)
        fields = {}
        if module is lak:      # registers and spills of each instance
            fields["kernels"] = ptxas_report(built.log)
        if module is fik:      # registers and spills of each fused-IRB kernel
            report = ptxas_report(built.log)
            require(any(k.startswith(NO_SPILL_KERNELS) for k in report),
                    f"no ptxas report of {NO_SPILL_KERNELS} in the build log")
            spilled = {k: v for k, v in report.items()
                       if k.startswith(NO_SPILL_KERNELS) and v["spill_bytes"]}
            require(not spilled, f"fused-IRB passes spill: {spilled}")
            fields["kernels"] = report
        emit("build", kernel=name, library=os.path.relpath(built.path, ROOT),
             compiled=built.compiled, seconds=seconds, **fields)
    emit("build_done", seconds=time.perf_counter() - t0)

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

    def graph_ms(fn, iters=200, warmup=20) -> float:
        """Device time of one call, without the host's launch cost: the
        call captured once in a CUDA graph and replayed."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay, iters, warmup)

    def bound(moved, flops):
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def attention_bound(shape, dtype):
        b, n, h, d = shape
        elems = b * n * h * d
        moved = 4 * elems * torch.tensor([], dtype=dtype).element_size()
        flops = elems * (4 * d + 6)   # kv, num: 2·D each; ksum, den, φ, divide
        return bound(moved, flops) + (moved, flops)

    def device_ops_per_call(fn, calls=10, traces=3) -> float:
        """Device kernels (and copies) per call of ``fn``, from
        torch.profiler over ``calls`` calls after one untraced. The profiler
        now and then drops an event (a trace of 10 one-kernel calls has read
        9 on the card), never adds one: a trace that reads a fraction of a
        kernel a call is taken again, up to ``traces`` times, and the
        largest reading counts."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        fn()
        torch.cuda.synchronize()
        readings = []
        for _ in range(traces):
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            readings.append(len(ops) / calls)
            if len(ops) % calls == 0:
                break
        return max(readings)

    la_lib = cuda_build.load(lak.SOURCE, lak._declare)

    def attention_plan(shape, dtype, backward):
        """The wrapper's plan, held to the library's own shared-memory
        size; with the profiler's count of device kernels a call."""
        p = lak.plan(*shape, dtype, backward=backward)
        lib_smem = la_lib.linear_attention_smem_bytes(shape[-1], int(backward), p.rows)
        require(lib_smem == p.smem_bytes,
                f"plan {p} vs the library's {lib_smem} bytes of shared memory")
        return dict(p._asdict())

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
                          (2, 300, 3, 64), (1, 1, 1, 32), (1, 5, 2, 32),
                          (1, 100, 2, 32), (1, 4096, 4, 32), (1, 1024, 1, 128),
                          (1, 1024, 2, 64))]
             + [((1, 128, 1, 128), torch.bfloat16, False)])
    timings = {}
    for shape, dtype, timed in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        name = str(dtype).replace("torch.", "")
        err = compare(q, k, v)
        require(err <= TOL[name], f"kernel vs plain {shape} {name}: {err}")
        row = dict(kernel="linear_attention", shape=list(shape), dtype=name,
                   max_err=err, tol=TOL[name],
                   plan=attention_plan(shape, dtype, False),
                   kernels_per_call=device_ops_per_call(
                       lambda: lak.linear_attention_kernel(q, k, v)))
        require(row["kernels_per_call"] == 1,
                f"forward {shape} {name}: {row['kernels_per_call']} device "
                "kernels a call, not 1")
        if timed:
            bound_ms, bound_by, moved, flops = attention_bound(shape, dtype)
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

    # linear attention's backward against its plain version: mid_attn's
    # shape in training (batch 8) and serving (1), and the JAX tests' shapes
    def attention_bwd_work(shape, dtype):
        """(bytes, FLOP): q, k, v, g read and dq, dk, dv written once; the
        two contractions each of kv, num, dφq, d_kv, dφk and dv (12·D² a
        token and head) and the per-token vector work (~16·D)."""
        b, n, h, d = shape
        elems = b * n * h * d
        moved = 7 * elems * torch.tensor([], dtype=dtype).element_size()
        return moved, b * n * h * (12 * d * d + 16 * d)

    def compare_bwd(q, k, v, g):
        got = lak.linear_attention_backward_kernel(q, k, v, g)
        again = lak.linear_attention_backward_kernel(q, k, v, g)
        ref = linear_attention_backward_plain(q, k, v, g)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            require(a.dtype == q.dtype and a.shape == q.shape,
                    f"backward output {a.dtype} {tuple(a.shape)}")
            require(bool(torch.isfinite(a).all()), "backward: non-finite output")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                "backward kernel reruns differ")
        return max(float((a.float() - r.float()).abs().max())
                   for a, r in zip(got, ref))

    bwd_cases = ([((b, 1024, 4, 32), dt, True) for b in (1, 8)
                  for dt in (torch.float32, torch.bfloat16)]
                 + [(s, torch.float32, False)
                    for s in ((2, 256, 4, 32), (1, 100, 2, 32), (1, 128, 6, 32),
                              (1, 128, 1, 128), (2, 300, 3, 64), (1, 1, 1, 32),
                              (1, 5, 2, 32), (1, 4096, 4, 32), (1, 1024, 1, 128),
                              (1, 1024, 2, 64))])
    bwd_rows = {}
    for shape, dtype, timed in bwd_cases:
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        name = str(dtype).replace("torch.", "")
        err = compare_bwd(q, k, v, g)
        require(err <= BWD_TOL[name], f"backward kernel vs plain {shape} {name}: {err}")
        row = dict(kernel="linear_attention_backward", shape=list(shape),
                   dtype=name, max_err=err, tol=BWD_TOL[name],
                   plan=attention_plan(shape, dtype, True),
                   kernels_per_call=device_ops_per_call(
                       lambda: lak.linear_attention_backward_kernel(q, k, v, g)))
        require(row["kernels_per_call"] == 1,
                f"backward {shape} {name}: {row['kernels_per_call']} device "
                "kernels a call, not 1")
        if timed:
            moved, flops = attention_bwd_work(shape, dtype)
            bound_ms, bound_by = bound(moved, flops)
            kernel = lambda: lak.linear_attention_backward_kernel(q, k, v, g)  # noqa: E731
            plain = lambda: linear_attention_backward_plain(q, k, v, g)  # noqa: E731
            row.update(
                kernel_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                kernel_graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by, bytes=moved, flops=flops,
                library_ms=None,
                library="none: no single PyTorch call computes this backward")
        bwd_rows[(shape, name)] = row
        emit("kernel", **row)

    # the fused IRB at the shapes one small-UNet call at 256² gives it
    art = {a: os.path.join(ROOT, "artifacts", a) for _, a, _, _ in SERVED}
    cfg = load_model_config(os.path.join(art["vreg1b_gt03_ema"], "model_config.json"))
    fused_cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas_irb=True))
    weights = init_weights(cfg, seed=0, device=dev)
    probe, _ = create_model(fused_cfg, device=dev)
    probe.load_state_dict(weights, strict=True)
    irb_calls = []   # (name, Cin, H, W) of each IRB call, in order
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, name=name: irb_calls.append((name,) + tuple(a[0].shape[1:]))
    ) for name, m in probe.unet.named_modules()
        if isinstance(m, InvertedResidualBlock)]
    size = cfg.unet.image_size
    with torch.inference_mode():
        probe.unet(torch.zeros(1, cfg.unet.in_channels, size, size, device=dev),
                   torch.tensor([739], dtype=torch.int32, device=dev))
    for h in hooks:
        h.remove()
    require(len(irb_calls) == IRBS_PER_UNET_CALL,
            f"{len(irb_calls)} IRBs in a UNet call, not {IRBS_PER_UNET_CALL}")
    blocks = dict(probe.unet.named_modules())
    per_call = {}   # (Cin, Chid, Cout, H) → [first block's name, IRBs of that shape a call]
    for name, cin, height, _ in irb_calls:
        blk = blocks[name]
        key = (cin, blk.expand.weight.shape[0], blk.project.weight.shape[0], height)
        per_call.setdefault(key, [name, 0])[1] += 1

    def irb_inputs(block, b, height, width, dtype, use_se=True, silu=False,
                   tdim=cfg.unet.time_embed_dim):
        cin = block.expand.weight.shape[1]
        x = torch.randn((b, cin, height, width), generator=gen, device=dev).to(dtype)
        temb = torch.randn((b, tdim), generator=gen, device=dev)
        with torch.inference_mode():
            fs, fb = block.time_mlp(temb).chunk(2, dim=-1)
        kw = irb_args(block)
        if not use_se:
            kw.update(use_se=False, se_w1=None, se_b1=None, se_w2=None, se_b2=None)
        kw["silu"] = silu
        return x, dict(film_scale=fs, film_shift=fb, **kw)

    def irb_compare(x, kw):
        with torch.inference_mode():
            out = fik.fused_irb_v2(x, **kw)
            again = fik.fused_irb_v2(x, **kw)
            ref = fused_irb_v2_plain(x, **kw)
        torch.cuda.synchronize()
        require(out.dtype == x.dtype and out.shape == ref.shape,
                f"fused kernel output {out.dtype} {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "fused kernel: non-finite output")
        require(torch.equal(out, again), "fused kernel reruns differ")
        return float((out.float() - ref.float()).abs().max())

    def irb_work(x, kw):
        """(bytes, FLOP) of one call, each counted once: x read, out written,
        weights read; expand, depthwise, project and skip. The Gram of the
        GN2 fold is not counted: the function needs GN2's statistics, not
        the Gram, and they can come from h1 itself, whose write and re-read
        take less time than these operations at every serving shape."""
        b, cin, height, width = x.shape
        chid, cout = kw["wexp"].shape[0], kw["wproj"].shape[0]
        n = b * height * width
        weights_n = sum(t.numel() for k, t in kw.items()
                        if isinstance(t, torch.Tensor) and k.startswith(("w", "se_", "gn")))
        moved = (cin + cout) * n * x.element_size() + 4 * weights_n
        flops = 2 * n * (cin * chid + 9 * chid + chid * cout
                         + (cin * cout if kw.get("wskip") is not None else 0))
        return moved, flops

    def irb_tc_bound(x, kw, bf16_products):
        """The least time of one call on the tensor cores (ms): the bytes of
        irb_work; the products' FLOP three times at the TF32 rate (3×TF32:
        float32 operands, v2's f32 entry and both of v1's) or once at the
        bf16 rate (v2's bf16 entry); the depthwise at the float32 rate."""
        b, cin, height, width = x.shape
        chid, cout = kw["wexp"].shape[0], kw["wproj"].shape[0]
        n = b * height * width
        moved, _ = irb_work(x, kw)
        products = 2 * n * (cin * chid + chid * cout
                            + (cin * cout if kw.get("wskip") is not None else 0))
        t_products = (products / BF16_FLOPS_PER_S if bf16_products
                      else 3 * products / TF32_FLOPS_PER_S)
        return max(moved / HBM_BYTES_PER_S, t_products,
                   2 * n * 9 * chid / F32_FLOPS_PER_S) * 1e3

    def irb_v1_compare(x, kw):
        """v1 against its plain version: (max abs error, its bound)."""
        fik.fused_irb_v1.launches = 0
        with torch.inference_mode():
            out = fik.fused_irb_v1(x, **kw)
            again = fik.fused_irb_v1(x, **kw)
            ref = fused_irb_v1_plain(x, **kw)
        torch.cuda.synchronize()
        require(fik.fused_irb_v1.launches == 2,
                f"fused_irb_v1: {fik.fused_irb_v1.launches} launches for 2 calls")
        require(out.dtype == x.dtype and out.shape == ref.shape,
                f"fused_irb_v1 output {out.dtype} {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "fused_irb_v1: non-finite output")
        require(torch.equal(out, again), "fused_irb_v1 reruns differ")
        err = float((out.float() - ref.float()).abs().max())
        # in bf16 both compute in float32 (2e-4 apart at most) and round only
        # the output, to the same bf16 value or to neighbours: one bf16 ulp
        # of the output's largest magnitude apart at most
        tol = (IRB_TOL["float32"] if x.dtype == torch.float32
               else bf16_ulp(float(ref.float().abs().max())))
        require(err <= tol, f"fused_irb_v1 vs plain {tuple(x.shape)} {x.dtype}: {err} > {tol}")
        return err, tol

    def irb_v1_row(x, kw, v2_row=None, **fields):
        """v1 against its plain version at one shape, timed, with v2's times
        on the same inputs beside it; emitted and returned."""
        err, tol = irb_v1_compare(x, kw)
        moved, flops = irb_work(x, kw)
        bound_ms, bound_by = bound(moved, flops)

        def kernel():
            with torch.inference_mode():
                fik.fused_irb_v1(x, **kw)

        def plain():
            with torch.inference_mode():
                fused_irb_v1_plain(x, **kw)

        row = dict(kernel="fused_irb_v1", **fields, shape=list(x.shape),
                   chid=kw["wexp"].shape[0], cout=kw["wproj"].shape[0],
                   dtype=str(x.dtype).replace("torch.", ""), max_err=err, tol=tol,
                   kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                   kernel_graph_ms=graph_ms(kernel, 20, 3),
                   plain_graph_ms=graph_ms(plain, 20, 3),
                   bound_ms=bound_ms, bound_by=bound_by,
                   tc_bound_ms=irb_tc_bound(x, kw, False), bytes=moved, flops=flops,
                   library_ms=None,
                   library="none: no single PyTorch call computes the fused IRB")
        if v2_row is not None:
            row.update(v2_kernel_ms=v2_row["kernel_ms"],
                       v2_kernel_graph_ms=v2_row["kernel_graph_ms"],
                       v1_over_v2_graph=row["kernel_graph_ms"] / v2_row["kernel_graph_ms"])
        emit("kernel", **row)
        return row

    # v1 in bf16 at the widest block of each UNet level
    widest_of_level = {}     # height → (Cin, Chid, Cout, H) of the most input channels
    for key in sorted(per_call):
        widest_of_level[key[3]] = key
    irb_rows, v1_rows = {}, {}
    for (cin, chid, cout, height), (name, count) in sorted(per_call.items()):
        for b in (1, 8):
            for dtype in (torch.float32, torch.bfloat16):
                bf16_v2 = (cin, height) == (96, size)    # v2: bf16 at the widest block only
                bf16_v1 = widest_of_level[height] == (cin, chid, cout, height)
                if dtype == torch.bfloat16 and not (bf16_v1 or bf16_v2):
                    continue
                x, kw = irb_inputs(blocks[name], b, height, height, dtype)
                dname = str(dtype).replace("torch.", "")
                if dtype == torch.bfloat16 and not bf16_v2:
                    v1_rows[(cin, chid, cout, height, b, dname)] = irb_v1_row(
                        x, kw, block=name, per_unet_call=count)
                    continue
                err = irb_compare(x, kw)
                require(err <= IRB_TOL[dname],
                        f"fused kernel vs plain {name} {tuple(x.shape)} {dname}: {err}")
                moved, flops = irb_work(x, kw)
                bound_ms, bound_by = bound(moved, flops)

                def kernel(x=x, kw=kw):
                    with torch.inference_mode():
                        fik.fused_irb_v2(x, **kw)

                def plain(x=x, kw=kw):
                    with torch.inference_mode():
                        fused_irb_v2_plain(x, **kw)

                row = dict(kernel="fused_irb_v2", block=name, shape=[b, cin, height, height],
                           chid=chid, cout=cout, dtype=dname, per_unet_call=count,
                           max_err=err, tol=IRB_TOL[dname],
                           kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                           kernel_graph_ms=graph_ms(kernel, 20, 3),
                           plain_graph_ms=graph_ms(plain, 20, 3),
                           bound_ms=bound_ms, bound_by=bound_by,
                           tc_bound_ms=irb_tc_bound(x, kw, dtype == torch.bfloat16),
                           bytes=moved, flops=flops,
                           plan=list(fik.plan(b, chid, cout, height, height)),
                           library_ms=None,
                           library="none: no single PyTorch call computes the fused IRB")
                irb_rows[(cin, chid, cout, height, b, dname)] = row
                emit("kernel", **row)
                if dtype == torch.float32 or bf16_v1:
                    v1_rows[(cin, chid, cout, height, b, dname)] = irb_v1_row(
                        x, kw, row, block=name, per_unet_call=count)
    # the widest blocks of the base (384 output channels) and large (512)
    # UNets at 256²: the middle blocks and the decoder's first concat blocks,
    # at 32²; more than 256 output channels take several output blocks
    wide_err = 0.0
    for variant, cin, cout, tdim in (("base", 384, 384, 192), ("base", 768, 384, 192),
                                     ("large", 512, 512, 256), ("large", 1024, 512, 256)):
        blk = InvertedResidualBlock(cin, cout, tdim, expansion_ratio=4).to(dev).eval()
        for b in (1, 8):
            x, kw = irb_inputs(blk, b, 32, 32, torch.float32, tdim=tdim)
            err = irb_compare(x, kw)
            require(err <= IRB_TOL["float32"],
                    f"fused kernel vs plain {variant} {cin}->{cout} b{b}: {err}")
            wide_err = max(wide_err, err)
            moved, flops = irb_work(x, kw)
            bound_ms, bound_by = bound(moved, flops)

            def kernel(x=x, kw=kw):
                with torch.inference_mode():
                    fik.fused_irb_v2(x, **kw)

            def plain(x=x, kw=kw):
                with torch.inference_mode():
                    fused_irb_v2_plain(x, **kw)

            row = dict(kernel="fused_irb_v2", variant=variant,
                       shape=[b, cin, 32, 32], chid=4 * cin, cout=cout, dtype="float32",
                       max_err=err, tol=IRB_TOL["float32"],
                       kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                       kernel_graph_ms=graph_ms(kernel, 20, 3),
                       plain_graph_ms=graph_ms(plain, 20, 3), bound_ms=bound_ms,
                       bound_by=bound_by, tc_bound_ms=irb_tc_bound(x, kw, False),
                       bytes=moved, flops=flops,
                       plan=list(fik.plan(b, 4 * cin, cout, 32, 32)), library_ms=None)
            emit("kernel", **row)
            v1_rows[(variant, cin, b)] = irb_v1_row(x, kw, row, variant=variant)
    # the JAX tests' edge cases: no SE with SiLU, 48 channels in 16 groups,
    # 24 rows (an uneven last tile)
    edge = probe.unet.encoder_blocks[0][0]
    for label, blk, b, height, kwargs in (
            ("no_se_silu", edge, 2, 32, dict(use_se=False, silu=True)),
            ("cin48_16_groups", InvertedResidualBlock(
                48, 48, cfg.unet.time_embed_dim, expansion_ratio=2).to(dev).eval(),
             2, 16, {}),
            ("size24_uneven_tile", edge, 2, 24, {})):
        for dtype in (torch.float32, torch.bfloat16):
            x, kw = irb_inputs(blk, b, height, height, dtype, **kwargs)
            dname = str(dtype).replace("torch.", "")
            err = irb_compare(x, kw)
            require(err <= IRB_TOL[dname], f"fused kernel vs plain {label} {dname}: {err}")
            emit("kernel", kernel="fused_irb_v2", case=label, shape=list(x.shape),
                 dtype=dname, max_err=err, tol=IRB_TOL[dname])
    # v1 at the four TestFusedIRB shapes (tests/test_pallas_kernels.py:167-201),
    # with their tile_h=8: batch 2; 32→128→32, 32→128→64 and no SE with SiLU
    # at 32², 48→96→48 at 16²
    tdim = cfg.unet.time_embed_dim
    for label, cin, cout, exp, height, use_se, silu in (
            ("identity", 32, 32, 4, 32, True, False),
            ("channel_change_skip", 32, 64, 4, 32, True, False),
            ("no_se_silu", 32, 32, 4, 32, False, True),
            ("uneven_group_counts", 48, 48, 2, 16, True, False)):
        blk = InvertedResidualBlock(cin, cout, tdim, expansion_ratio=exp, use_se=use_se,
                                    quantization_friendly=not silu).to(dev).eval()
        x, kw = irb_inputs(blk, 2, height, height, torch.float32, use_se=use_se, silu=silu)
        err, tol = irb_v1_compare(x, dict(kw, tile_h=8))
        v1_rows[label] = dict(kernel="fused_irb_v1", case=label, shape=list(x.shape),
                              chid=cin * exp, cout=cout, dtype="float32", tile_h=8,
                              max_err=err, tol=tol)
        emit("kernel", **v1_rows[label])
    del probe
    torch.cuda.empty_cache()
    emit("kernel_done", seconds=time.perf_counter() - t0)

    # 4. serve: the main path at full width --------------------------------
    t0 = time.perf_counter()
    npz = os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz")
    torch.cuda.synchronize()
    a = time.perf_counter()
    trained = load_state_dict_npz(npz, dev)     # bytes put together, SHA-256 checked
    torch.cuda.synchronize()
    emit("weights", artifact=STUDENT, file=os.path.relpath(npz, ROOT),
         bytes=os.path.getsize(npz), load_s=time.perf_counter() - a,
         tensors=len(trained), params=sum(t.numel() for t in trained.values()))
    pipes = []
    for label, name, grid, fused in SERVED:
        path = art[name]
        if name == STUDENT:
            a = time.perf_counter()
            pipe = ServingPipeline.from_artifact(name, dev, use_pallas_irb=fused,
                                                 batch_size=8)
            emit("from_artifact", student=label, seconds=time.perf_counter() - a)
        else:       # another grid, on the student's weights
            pipe = ServingPipeline.from_config(
                os.path.join(path, "model_config.json"),
                os.path.join(path, "student_timesteps.json"), trained,
                device=dev, batch_size=8)
        require(pipe.config.timesteps == grid,
                f"{label}: grid {pipe.config.timesteps} != {grid}")
        require(pipe.model.config.unet.use_pallas_irb == fused,
                f"{label}: use_pallas_irb is {pipe.model.config.unet.use_pallas_irb}")
        require(all(torch.equal(t, trained[k]) for k, t in pipe.model.state_dict().items()),
                f"{label}: the served weights are not {STUDENT}'s")
        pipes.append(pipe)

    rng = np.random.default_rng(0)
    sizes = ((400, 600), (256, 256), (480, 720), (720, 480), (97, 301))
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    batch_images = [images[i % len(images)] for i in range(8)]

    def check_outputs(inputs, outputs):
        require(len(outputs) == len(inputs), f"{len(outputs)} outputs for {len(inputs)} inputs")
        for img, out in zip(inputs, outputs):
            require(out.dtype == np.uint8 and out.shape == img.shape,
                    f"output {out.dtype} {out.shape} for input {img.shape}")
            require(int(out.max()) > int(out.min()), "constant output image")

    def eager_request(pipe, img, seed=0):
        """One request's sampler op by op (forward hooks see it; a graph's
        replay runs no Python)."""
        canvas, _ = pipe.pre(img)
        return pipe.run_eager(canvas, pipe._generator(seed))

    def peak_where(pipe):
        """Peak device memory of one eager batch of 8, and the three blocks
        of the UNet inside which the highest peaks are reached."""
        unet, blocks_, hooks_ = pipe.model.unet, [], []

        def walk(module, prefix):
            for n, child in module.named_children():
                if isinstance(child, torch.nn.ModuleList):
                    walk(child, f"{prefix}{n}.")
                else:
                    blocks_.append((f"{prefix}{n}", child))

        def enter(module, args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        def leave(module, args, out, name):
            torch.cuda.synchronize()
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())

        walk(unet, "")
        peaks = {}
        for name, m in blocks_:
            hooks_.append(m.register_forward_pre_hook(enter))
            hooks_.append(m.register_forward_hook(
                lambda mod, a, o, name=name: leave(mod, a, o, name)))
        canvas = torch.cat([pipe.pre(img)[0] for img in batch_images])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pipe.run_eager(canvas, pipe._generator(300))
        torch.cuda.synchronize()
        for h in hooks_:
            h.remove()
        top = sorted(peaks.items(), key=lambda kv: -kv[1])[:3]
        return base, [{"block": n, "peak_mem_bytes": v} for n, v in top]

    def per_replay(steps, fused):
        """The hand-written kernels' launches inside one replay of a graph
        of a sampler of ``steps`` UNet calls."""
        return {"linear_attention": steps,
                "fused_irb_v2": IRBS_PER_UNET_CALL * steps if fused else 0,
                "fused_irb_v1": 0}      # no model path runs v1, as in JAX

    def reset_launches():
        lak.linear_attention_kernel.launches = 0
        fik.fused_irb_v2.launches = 0
        fik.fused_irb_v1.launches = 0

    def graph_accounting(pipe, label, want, eager_calls):
        """Hold the launches of a configuration's run to its graphs: each
        graph's replay launches ``want``; the wrappers launched (GRAPH_WARMUP
        + 1)·``want`` for each graph (warm-up and capture) and ``want`` for
        each of ``eager_calls`` eager sampler calls. Returns (wrapper
        launches, launches inside replays, replays by batch size)."""
        counts = kernel_launches()
        for b, g in pipe.graphs.items():
            require(g.launches == want, f"{label}: the batch-{b} graph launches "
                                        f"{g.launches} a replay, not {want}")
        direct = {k: ((GRAPH_WARMUP + 1) * len(pipe.graphs) + eager_calls) * v
                  for k, v in want.items()}
        require(counts == direct, f"{label}: wrapper launches {counts} != {direct}")
        replays = {b: g.replays for b, g in sorted(pipe.graphs.items())}
        return counts, {k: sum(replays.values()) * v for k, v in want.items()}, replays

    launches = {"linear_attention": 0, "fused_irb_v2": 0, "fused_irb_v1": 0}
    replayed = dict(launches)
    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        steps = len(grid)
        require(not pipe.graphs, f"{label}: graphs before the run")
        # the counts go to 0 just before this configuration runs
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        outs = [pipe(img, seed=i) for i, img in enumerate(images)]   # captures batch 1
        check_outputs(images, outs)
        outs = pipe.batch(batch_images, seed=100)                     # captures batch 8
        check_outputs(batch_images, outs)

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
        # batches of 8: one chunk a call, then REPS chunks pipelined in one call
        torch.cuda.synchronize()
        a = time.perf_counter()
        for r in range(REPS):
            outs = pipe.batch(batch_images, seed=200 + r)
        one_chunk_s = time.perf_counter() - a
        check_outputs(batch_images, outs)
        a = time.perf_counter()
        outs = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        check_outputs(batch_images * REPS, outs)
        st = np.asarray(stages)
        with FlopCounterMode(display=False) as flop_counter:   # one eager call
            eager_request(pipe, images[2])
        bench = pipe.benchmark()
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        # what the graphs hold: their pool, and the pipeline's own tensors
        graph_mem = torch.cuda.memory_reserved() - reserved_before
        counts, in_replays, replays = graph_accounting(pipe, label, per_replay(steps, fused), 1)
        bench_runs = 20 + 3
        want_replays = {1: len(images) + 10 + bench_runs, 8: 1 + 2 * REPS}
        require(replays == want_replays, f"{label}: replays {replays} != {want_replays}")
        for k in launches:
            launches[k] += counts[k]
            replayed[k] += in_replays[k]
        row = dict(student=label, grid=list(grid), use_pallas_irb=fused,
                   weights=STUDENT, image=list(images[2].shape),
                   latency_ms_mean=float(np.mean(lat)),
                   latency_ms_p50=float(np.median(lat)),
                   latency_ms_min=float(np.min(lat)),
                   pre_ms=float(st[:, 0].mean()), sampler_ms=float(st[:, 1].mean()),
                   post_ms=float(st[:, 2].mean()),
                   batch=8, images_per_s=REPS * 8 / pipelined,
                   images_per_s_one_chunk_a_call=REPS * 8 / one_chunk_s,
                   conv_matmul_gflop_per_request=flop_counter.get_total_flops() / 1e9,
                   peak_mem_bytes=peak_mem, graph_mem_bytes=graph_mem,
                   capture_s={b: g.seconds for b, g in sorted(pipe.graphs.items())},
                   replays=replays, launches=counts, launches_in_replays=in_replays)
        emit("serve", **row)
        emit("benchmark", student=label, **bench)
    emit("serve_done", kernel_launches=launches, kernel_launches_in_replays=replayed,
         seconds=time.perf_counter() - t0)

    # 5. graph: each configuration's CUDA graphs against its eager sampler --
    t0 = time.perf_counter()
    launch_api = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                            r"GraphLaunch|Memcpy|Memset)")

    def launch_calls(fn, calls=3):
        """Per call of ``fn``, from torch.profiler over ``calls`` calls after
        one untraced: the host's CUDA launch and copy calls by API name,
        and the device's kernels (and copies) in all and by kind."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        fn()
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        api, kinds, device = defaultdict(int), defaultdict(int), 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device += 1
                    kinds[kernel_kind(e.name)] += 1
            elif launch_api.match(e.name):
                api[e.name] += 1
        return ({k: v / calls for k, v in sorted(api.items())}, device / calls,
                {k: v / calls for k, v in sorted(kinds.items())})

    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        for b in (1, 8):
            canvas = torch.cat([pipe.pre(img)[0] for img in (batch_images[:b])])
            graph_out = pipe._run(canvas, pipe._generator(7))
            eager_out = pipe.run_eager(canvas, pipe._generator(7))
            diff = (graph_out.int() - eager_out.int()).abs()
            lsb, off = int(diff.max()), int((diff > 0).sum())
            require(lsb <= GRAPH_LSB_TOL,
                    f"{label} batch {b}: graph vs eager {lsb} LSB ({off} values)")
            # paired runs, eager and graph in turn
            eager_ms, graph_ms = [], []
            for i in range(10 if b == 1 else 4):
                for fn, into in ((pipe.run_eager, eager_ms), (pipe._run, graph_ms)):
                    torch.cuda.synchronize()
                    a = time.perf_counter()
                    fn(canvas, pipe._generator(i))
                    torch.cuda.synchronize()
                    into.append((time.perf_counter() - a) * 1e3)
            eager_api, eager_dev, _ = launch_calls(
                lambda: pipe.run_eager(canvas, pipe._generator(1)))
            graph_api, graph_dev, graph_kinds = launch_calls(
                lambda: pipe._run(canvas, pipe._generator(1)))
            # the replay runs the hand-written kernels: one attention kernel
            # a UNet call, and the fused IRB's kernels when it is on
            require(graph_kinds.get("linear_attention") == len(grid),
                    f"{label} batch {b}: {graph_kinds} in a replay")
            require(bool(graph_kinds.get("fused_irb")) == fused,
                    f"{label} batch {b}: {graph_kinds} in a replay")
            row = dict(
                student=label, batch=b, grid=list(grid), use_pallas_irb=fused,
                graph_vs_eager_max_lsb=lsb, graph_vs_eager_values_off=off,
                lsb_tol=GRAPH_LSB_TOL, capture_s=pipe.graphs[b].seconds,
                eager_ms_mean=float(np.mean(eager_ms)),
                eager_ms_p50=float(np.median(eager_ms)),
                graph_ms_mean=float(np.mean(graph_ms)),
                graph_ms_p50=float(np.median(graph_ms)),
                host_launch_calls_eager=sum(eager_api.values()),
                host_launch_calls_graph=sum(graph_api.values()),
                host_calls_eager_by_api=eager_api, host_calls_graph_by_api=graph_api,
                device_ops_eager=eager_dev, device_ops_graph=graph_dev,
                device_ops_graph_by_kind=graph_kinds)
            emit("graph", **row)
        # a whole request of 480×720 through the pipeline: pre, graph, post
        api, dev_ops, _ = launch_calls(lambda: pipe(images[2], seed=1))
        emit("graph_request", student=label, image=list(images[2].shape),
             host_launch_calls=sum(api.values()), host_calls_by_api=api,
             device_ops=dev_ops)
    emit("graph_done", seconds=time.perf_counter() - t0)

    # 6. package: the student's serving packages, fp32 / bf16 / int8 -------
    t0 = time.perf_counter()
    pkg_root = os.path.join(cuda_build.BUILD_DIR, "packages")
    student = pipes[0].model
    original = {k: t.detach().cpu() for k, t in student.state_dict().items()}
    small = 64
    pkg_rng = np.random.default_rng(5)
    pkg_low = torch.from_numpy(pkg_rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32))
    pkg_init = torch.from_numpy(pkg_rng.standard_normal((2, small, small, 3)).astype(np.float32))
    pkg_noise = torch.from_numpy(pkg_rng.standard_normal((1, 2, small, small, 3)).astype(np.float32))
    packages = {}
    pkg_launches = {"linear_attention": 0, "fused_irb_v2": 0, "fused_irb_v1": 0}
    pkg_replayed = dict(pkg_launches)
    for codec, quantize in CODECS:
        path = packages[codec] = os.path.join(pkg_root, codec)
        shutil.rmtree(path, ignore_errors=True)
        a = time.perf_counter()
        files = create_serving_package(path, student, pipes[0].schedule,
                                       quantize=quantize, timesteps=SERVED[0][2])
        write_s = time.perf_counter() - a
        qparams, tag = quantize_model(original, student.config, quantize)
        require(tag == codec, f"codec {tag} for {quantize}")
        deq = (dequantize_int8(qparams) if tag == "int8"
               else {k: t.float() for k, t in qparams.items()})
        torch.cuda.synchronize()
        a = time.perf_counter()
        _, _, state, meta = load_serving_package(path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - a
        require(meta["quantization"] == codec and tuple(meta["timesteps"]) == SERVED[0][2],
                f"{codec}: package config {meta['quantization']} {meta['timesteps']}")
        require(all(torch.equal(state[k].cpu(), deq[k]) for k in original),
                f"{codec}: the loaded weights are not the codec's")
        del state
        # the card's sampler on the package's weights against the CPU's,
        # unfused and fused: same weights, same numpy noise
        cpu_model, cpu_sched, _, _ = load_serving_package(path, "cpu")
        want = enhance(cpu_model, cpu_sched, pkg_low, timesteps=SERVED[0][2],
                       init_noise=pkg_init, step_noise=pkg_noise, device="cpu")
        vs_cpu = {}
        for fused in (False, True):
            card_model, card_sched, _, _ = load_serving_package(path, dev,
                                                                use_pallas_irb=fused)
            got = enhance(card_model, card_sched, pkg_low, timesteps=SERVED[0][2],
                          init_noise=pkg_init, step_noise=pkg_noise, device=dev).cpu()
            require(bool(torch.isfinite(got).all()), f"{codec}: non-finite sampler output")
            vs_cpu["fused" if fused else "unfused"] = err = float((got - want).abs().max())
            require(err <= SAMPLER_TOL, f"{codec} fused={fused}: card vs CPU sampler {err}")
            del card_model
        del cpu_model
        serve_rows = {}
        for fused in (False, True):
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved_before = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            a = time.perf_counter()
            pipe = ServingPipeline.from_package(path, device=dev, use_pallas_irb=fused,
                                                batch_size=8)
            from_package_s = time.perf_counter() - a
            require(pipe.grid == list(SERVED[0][2]), f"{codec}: grid {pipe.grid}")
            outs = [pipe(img, seed=i) for i, img in enumerate(images)]
            check_outputs(images, outs)
            lat = []
            for i in range(5):
                torch.cuda.synchronize()
                a = time.perf_counter()
                pipe(images[2], seed=i)
                lat.append((time.perf_counter() - a) * 1e3)
            pkg_reps = 4
            pipe.batch(batch_images, seed=0)          # captures batch 8
            a = time.perf_counter()
            outs = pipe.batch(batch_images * pkg_reps, seed=500)
            pipelined = time.perf_counter() - a
            check_outputs(batch_images * pkg_reps, outs)
            torch.cuda.synchronize()
            peak_mem = torch.cuda.max_memory_allocated()
            counts, in_replays, replays = graph_accounting(
                pipe, f"{codec} package", per_replay(1, fused), 0)
            require(replays == {1: len(images) + 5, 8: 1 + pkg_reps},
                    f"{codec} package: replays {replays}")
            for k in pkg_launches:
                pkg_launches[k] += counts[k]
                pkg_replayed[k] += in_replays[k]
            capture_s = {b: g.seconds for b, g in sorted(pipe.graphs.items())}
            del pipe, outs
            torch.cuda.empty_cache()
            serve_rows["fused" if fused else "unfused"] = dict(
                from_package_s=from_package_s, latency_ms_mean=float(np.mean(lat)),
                latency_ms_p50=float(np.median(lat)), batch=8,
                images_per_s=pkg_reps * 8 / pipelined, peak_mem_bytes=peak_mem,
                capture_s=capture_s, replays=replays, launches=counts,
                launches_in_replays=in_replays)
        row = dict(
            codec=codec, quantize=quantize,
            file_bytes={role: os.path.getsize(f) for role, f in files.items()},
            bytes=sum(os.path.getsize(f) for f in files.values()),
            report=quantization_report(original, qparams),
            error=quantization_error(original, deq), write_s=write_s, load_s=load_s,
            sampler_vs_cpu_max_abs_err=vs_cpu, sampler_tol=SAMPLER_TOL,
            serve=serve_rows)
        emit("package", **row)
        del qparams, deq
    emit("package_done", kernel_launches=pkg_launches,
         kernel_launches_in_replays=pkg_replayed, seconds=time.perf_counter() - t0)

    # 7. checks on the main path's own tensors ------------------------------
    t0 = time.perf_counter()
    captured = {}

    def capture(module, args):
        captured["qkv"] = [a.detach().clone() for a in args]

    h = pipes[0].model.unet.mid_attn.attn.register_forward_pre_hook(capture)
    eager_request(pipes[0], images[0])
    h.remove()
    q, k, v = captured["qkv"]
    require(tuple(q.shape) == (1, 1024, 4, 32) and q.dtype == torch.float32,
            f"mid_attn q {q.dtype} {tuple(q.shape)}")
    mid_err = compare(q, k, v)
    require(mid_err <= TOL["float32"], f"mid_attn kernel vs plain: {mid_err}")

    # the widest IRB's own input, captured during a fused request
    widest = "decoder_blocks.3.0"
    fused_pipe = pipes[-1]
    blk = dict(fused_pipe.model.unet.named_modules())[widest]

    def capture_irb(module, args):
        captured["irb"] = [a.detach().clone() for a in args[:2]]   # x, time_emb

    h = blk.register_forward_pre_hook(capture_irb)
    eager_request(fused_pipe, images[0])
    h.remove()
    xb, temb = captured["irb"]
    require(tuple(xb.shape) == (1, 96, size, size), f"{widest} x {tuple(xb.shape)}")
    with torch.inference_mode():
        fs, fb = blk.time_mlp(temb).chunk(2, dim=-1)
    irb_kw = dict(film_scale=fs, film_shift=fb, **irb_args(blk))
    irb_err = irb_compare(xb, irb_kw)
    require(irb_err <= IRB_TOL["float32"], f"{widest} kernel vs plain: {irb_err}")

    # the Gram fold on that x: GN2⊕FiLM's (a2, b2) against GN2's statistics
    # taken two-pass from h1 = expand(x̂) itself, in float32 on the card
    def fold_err():
        with torch.inference_mode():
            _, (a2, b2), xhat = folded_gn_scales(
                xb, irb_kw["wexp"], irb_kw["gn1_scale"], irb_kw["gn1_bias"],
                irb_kw["gn2_scale"], irb_kw["gn2_bias"], fs, fb,
                irb_kw["eps"], irb_kw["silu"])
            h1 = torch.einsum("bkhw,ck->bchw", xhat, irb_kw["wexp"])
            groups = blk.norm2.num_groups
            hg = h1.reshape(1, groups, -1)
            mean = hg.mean(dim=-1)
            var = (hg - mean[..., None]).square().mean(dim=-1)
            per = h1.shape[1] // groups
            rstd = torch.rsqrt(var + irb_kw["eps"]).repeat_interleave(per, dim=1)
            mean = mean.repeat_interleave(per, dim=1)
            gamma = irb_kw["gn2_scale"][None] * (1 + fs)
            a_ref = rstd * gamma
            b_ref = (irb_kw["gn2_bias"][None] - mean * rstd * irb_kw["gn2_scale"][None]) \
                * (1 + fs) + fb
            per_c = lambda v: v[:, :, None, None]  # noqa: E731
            got = h1 * per_c(a2) + per_c(b2)
            want = h1 * per_c(a_ref) + per_c(b_ref)
        return float((got - want).abs().max()), float(want.abs().max())

    fold_f32, fold_scale = fold_err()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fold_tf32, _ = fold_err()
    finally:
        pin_fp32()
    require(fold_f32 <= FOLD_TOL, f"{widest} Gram fold vs two-pass GN2: {fold_f32}")
    require(fold_tf32 > FOLD_TOL,
            f"{widest}: a TF32 Gram fold ({fold_tf32}) passes the fold check")

    # fused_irb_v1 on the 22 IRBs of one unfused served request: each block's
    # own x and FiLM, captured by hooks, through v1 (its count set to 0 just
    # before), against the block's own output and against v2 on that input
    named = [(n, m) for n, m in pipes[0].model.unet.named_modules()
             if isinstance(m, InvertedResidualBlock) and m.stride == 1]
    require(len(named) == IRBS_PER_UNET_CALL, f"{len(named)} stride-1 IRBs")
    irb_io = {}

    def keep_in(module, args, name):
        irb_io.setdefault(name, [a.detach().clone() for a in args[:2]])

    def keep_out(module, args, out, name):
        if len(irb_io[name]) == 2:
            irb_io[name].append(out.detach().clone())

    hooks = [m.register_forward_pre_hook(lambda mod, a, n=n: keep_in(mod, a, n))
             for n, m in named]
    hooks += [m.register_forward_hook(lambda mod, a, o, n=n: keep_out(mod, a, o, n))
              for n, m in named]
    eager_request(pipes[0], images[0])
    for h in hooks:
        h.remove()
    require(all(len(irb_io.get(n, ())) == 3 for n, _ in named), "an IRB was not captured")
    v1_film = {}
    with torch.inference_mode():
        for n, m in named:
            v1_film[n] = m.time_mlp(irb_io[n][1]).chunk(2, dim=-1)
        fik.fused_irb_v1.launches = 0
        v1_out = {n: fik.fused_irb_v1(irb_io[n][0], film_scale=v1_film[n][0],
                                      film_shift=v1_film[n][1], **irb_args(m))
                  for n, m in named}
        torch.cuda.synchronize()
        v1_path_launches = fik.fused_irb_v1.launches
        require(v1_path_launches == IRBS_PER_UNET_CALL,
                f"fused_irb_v1: {v1_path_launches} launches for {IRBS_PER_UNET_CALL} IRBs")
        v1_vs_block, v1_vs_v2 = {}, {}
        for n, m in named:
            x_, _, out_ = irb_io[n]
            v2_ = fik.fused_irb_v2(x_, film_scale=v1_film[n][0], film_shift=v1_film[n][1],
                                   **irb_args(m))
            v1_vs_block[n] = float((v1_out[n] - out_).abs().max())
            v1_vs_v2[n] = float((v1_out[n] - v2_).abs().max())
    worst_block = max(v1_vs_block, key=v1_vs_block.get)
    require(v1_vs_block[worst_block] <= IRB_TOL["float32"],
            f"fused_irb_v1 vs the block's own output at {worst_block}: "
            f"{v1_vs_block[worst_block]}")
    require(max(v1_vs_v2.values()) <= IRB_TOL["float32"],
            f"fused_irb_v1 vs fused_irb_v2 on a request's IRB inputs: {v1_vs_v2}")
    del irb_io, v1_out

    # v1's device-side affines at decoder_blocks.3.0 (the kernel's one-pass
    # float32 partials) and the Gram fold's, against GN1 and GN2⊕FiLM with
    # float64 statistics taken two-pass from x and h1, as max |Δ(x·a1 + b1)|
    # and max |Δ(h1·a2 + b2)| over the float64 x and h1
    def gn_affine(v, scale, bias, groups, film=None):
        vg = v.reshape(v.shape[0], groups, -1)
        mean = vg.mean(dim=-1)
        var = (vg - mean[..., None]).square().mean(dim=-1)
        per = v.shape[1] // groups
        rstd = torch.rsqrt(var + irb_kw["eps"]).repeat_interleave(per, dim=1)
        mean = mean.repeat_interleave(per, dim=1)
        a = rstd * scale.double()[None]
        b = bias.double()[None] - mean * a
        if film is not None:
            m = 1 + film[0].double()
            a, b = a * m, b * m + film[1].double()
        return a, b

    def per_c(v):
        return v[:, :, None, None]

    with torch.inference_mode():
        x64 = xb.double()
        a1_ref, b1_ref = gn_affine(x64, irb_kw["gn1_scale"], irb_kw["gn1_bias"],
                                   blk.norm1.num_groups)
        pre = x64 * per_c(a1_ref) + per_c(b1_ref)
        xhat64 = torch.nn.functional.silu(pre) if irb_kw["silu"] else pre.clamp(0, 6)
        h1_64 = torch.einsum("bkhw,ck->bchw", xhat64, irb_kw["wexp"].double())
        a2_ref, b2_ref = gn_affine(h1_64, irb_kw["gn2_scale"], irb_kw["gn2_bias"],
                                   blk.norm2.num_groups, (fs, fb))

        def affine_errs(a1, b1, a2, b2):
            return (float((x64 * per_c(a1.double() - a1_ref)
                           + per_c(b1.double() - b1_ref)).abs().max()),
                    float((h1_64 * per_c(a2.double() - a2_ref)
                           + per_c(b2.double() - b2_ref)).abs().max()))

        v1_t = fik._launch_v1(cuda_build.load(fik.SOURCE, fik._declare),
                              torch.cuda.current_stream().cuda_stream, xb,
                              film_scale=fs, film_shift=fb, **irb_args(blk))
        v1_gn1_err, v1_gn2_err = affine_errs(*(v1_t[k] for k in ("a1", "b1", "a2", "b2")))
        (fa1, fb1), (fa2, fb2), _ = folded_gn_scales(
            xb, irb_kw["wexp"], irb_kw["gn1_scale"], irb_kw["gn1_bias"],
            irb_kw["gn2_scale"], irb_kw["gn2_bias"], fs, fb, irb_kw["eps"], irb_kw["silu"])
        fold_gn1_err, fold_gn2_err = affine_errs(fa1, fb1, fa2, fb2)
        del x64, pre, xhat64, h1_64, v1_t
    require(max(v1_gn1_err, v1_gn2_err) <= FOLD_TOL,
            f"{widest}: fused_irb_v1's GN affines vs float64 statistics: "
            f"{v1_gn1_err}, {v1_gn2_err}")

    # the card's samplers against the CPU's, and fused against unfused on
    # the card: same weights, same numpy noise
    small = 64
    cpu_sd = {k: t.cpu() for k, t in trained.items()}
    ref_rng = np.random.default_rng(1)
    low = ref_rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32)
    sampler_err, card_out = {}, {}
    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        cpu_model, cpu_sched = create_model(pipe.model.config, device="cpu")
        cpu_model.load_state_dict(cpu_sd)
        init = ref_rng.standard_normal((2, small, small, 3)).astype(np.float32)
        noise = ref_rng.standard_normal((len(grid), 2, small, small, 3)).astype(np.float32)
        if fused:     # the unfused 1-step student's noise, for the comparison
            init, noise = card_out["noise"]
        card_out.setdefault("noise", (init, noise))
        got = enhance(pipe.model, pipe.schedule, torch.from_numpy(low),
                      timesteps=grid, init_noise=torch.from_numpy(init),
                      step_noise=torch.from_numpy(noise), device=dev).cpu()
        want = enhance(cpu_model, cpu_sched, torch.from_numpy(low),
                       timesteps=grid, init_noise=torch.from_numpy(init),
                       step_noise=torch.from_numpy(noise), device="cpu")
        require(bool(torch.isfinite(got).all()), "non-finite sampler output")
        err = float((got - want).abs().max())
        require(err <= SAMPLER_TOL, f"{label}: card vs CPU sampler {err}")
        sampler_err[label] = err
        card_out[label] = got
    fused_vs_unfused = float((card_out[SERVED[2][0]] - card_out[SERVED[0][0]]).abs().max())
    require(fused_vs_unfused <= SAMPLER_TOL,
            f"fused vs unfused sampler on the card: {fused_vs_unfused}")
    emit("check", mid_attn_max_err=mid_err, mid_attn_shape=list(q.shape),
         irb_block=widest, irb_shape=list(xb.shape), irb_max_err=irb_err,
         irb_tol=IRB_TOL["float32"], fold_max_abs_err=fold_f32,
         fold_tf32_max_abs_err=fold_tf32, fold_tol=FOLD_TOL,
         fold_output_max_abs=fold_scale,
         v1_blocks=len(named), v1_launches=v1_path_launches,
         v1_vs_block_max_abs_err=v1_vs_block[worst_block], v1_worst_block=worst_block,
         v1_vs_v2_max_abs_err=max(v1_vs_v2.values()),
         v1_vs_block_max_abs_err_by_block=v1_vs_block,
         v1_gn1_affine_vs_float64=v1_gn1_err, v1_gn2_affine_vs_float64=v1_gn2_err,
         fold_gn1_affine_vs_float64=fold_gn1_err, fold_gn2_affine_vs_float64=fold_gn2_err,
         affine_tol=FOLD_TOL,
         sampler_vs_cpu_max_abs_err=sampler_err,
         fused_vs_unfused_sampler_max_abs_err=fused_vs_unfused,
         sampler_tol=SAMPLER_TOL, seconds=time.perf_counter() - t0)

    # 8. eval: the student's quality on the card against the JAX package ----
    t0 = time.perf_counter()
    ref_base = os.path.join(ROOT, "artifacts_torch", STUDENT)
    with open(ref_base + ".eval_ref.json") as f:
        ref = json.load(f)
    with np.load(ref_base + ".eval_ref_u8.npz", allow_pickle=False) as z:
        ref_u8 = z["pred_u8"]
    grid = list(pipes[0].config.timesteps)
    eval_n = ref["n"]
    require(ref["timesteps"] == grid and ref["size"] == size and eval_n == 15,
            f"eval reference is for {ref['timesteps']} n={eval_n} size={ref['size']}")
    eval_low, eval_high = ev.eval_split(eval_n, size, ref["seed"])
    eval_init, eval_step = ev.eval_noise(eval_n, size, ref["seed"], len(grid))
    hashes = ev.input_hashes(eval_low, eval_high, eval_init)
    for i, (h, im) in enumerate(zip(hashes, ref["images"])):
        for what in ("low", "high", "noise"):
            require(h[what] == im[f"{what}_sha256"],
                    f"eval image {i}: its {what} array's SHA-256 {h[what]} is not "
                    f"the reference's {im[f'{what}_sha256']}: the inputs differ")
    require(len(hashes) == len(ref["images"]) == eval_n, "eval: image count")
    eval_target = ev.target_unit(eval_high, dev)
    eval_rows = {}
    for pipe, (label, _, _, fused) in ((pipes[0], SERVED[0]), (pipes[-1], SERVED[-1])):
        pin_fp32()
        lak.linear_attention_kernel.launches = 0
        fik.fused_irb_v2.launches = 0
        fik.fused_irb_v1.launches = 0
        for _ in range(2):      # the first pass sets up cuDNN; the second is timed
            torch.cuda.synchronize()
            a = time.perf_counter()
            pred = ev.enhance_split(pipe.model, pipe.schedule, eval_low, eval_init,
                                    eval_step, grid, device=dev)
            per = ev.per_image_metrics(pred, eval_target)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - a
        batches = 2 * -(-eval_n // ev.BATCH_SIZE) * len(grid)
        counts = {"linear_attention": lak.linear_attention_kernel.launches,
                  "fused_irb_v2": fik.fused_irb_v2.launches,
                  "fused_irb_v1": fik.fused_irb_v1.launches}
        require(counts == {"linear_attention": batches,
                           "fused_irb_v2": IRBS_PER_UNET_CALL * batches if fused else 0,
                           "fused_irb_v1": 0},
                f"{label}: eval launches {counts} for {batches} UNet calls")
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], ref["images"])]
                  for k in EVAL_TOL}
        for k, tol in EVAL_TOL.items():
            worst = int(np.argmax(deltas[k]))
            require(deltas[k][worst] <= tol,
                    f"{label}: image {worst}: |Δ{k}| {deltas[k][worst]} against JAX > {tol}")
        u8 = ev.to_u8(pred[list(ref["u8_images"])])
        u8_err = int(np.abs(u8.astype(np.int16) - ref_u8.astype(np.int16)).max())
        u8_off = int((u8 != ref_u8).sum())
        require(u8_err <= EVAL_U8_TOL,
                f"{label}: images {ref['u8_images']} {u8_err} LSB from JAX's uint8")
        cpu_per = ev.per_image_metrics(pred.cpu(), eval_target.cpu())
        cpu_rel = max(abs(a_ - b_) / max(abs(b_), 1e-12)
                      for k in EVAL_TOL for a_, b_ in zip(per[k], cpu_per[k]))
        require(cpu_rel <= EVAL_CPU_REL_TOL,
                f"{label}: card metrics vs the CPU port's on the same outputs: {cpu_rel}")
        eval_rows[label] = row = dict(
            student=label, weights=STUDENT, grid=grid, images=eval_n, size=size,
            batch=ev.BATCH_SIZE, launches=counts,
            mean={k: float(np.mean(per[k])) for k in EVAL_TOL},
            jax_mean={k: ref["summary"][f"{k}_mean"] for k in EVAL_TOL},
            max_abs_delta={k: max(v) for k, v in deltas.items()},
            worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
            tol=EVAL_TOL, u8_max_lsb=u8_err, u8_pixels_off=u8_off,
            u8_tol=EVAL_U8_TOL, card_vs_cpu_metrics_max_rel=cpu_rel,
            cpu_rel_tol=EVAL_CPU_REL_TOL, seconds=seconds,
            images_per_s=eval_n / seconds, per_image=per)
        emit("eval", **row)
        del pred
    # the bf16 and int8 packages, unfused, against the JAX package's own
    # package of that codec (eval_ref_<codec>.json) on the same inputs
    for codec in ("bf16", "int8"):
        with open(f"{ref_base}.eval_ref_{codec}.json") as f:
            cref = json.load(f)
        require(cref["quantization"] == codec and cref["timesteps"] == grid
                and cref["n"] == eval_n and cref["size"] == size
                and [im[f"{w}_sha256"] for im in cref["images"] for w in ("low", "high", "noise")]
                == [im[f"{w}_sha256"] for im in ref["images"] for w in ("low", "high", "noise")],
                f"{codec} eval reference is not for the fp32 reference's inputs")
        model, schedule, _, _ = load_serving_package(packages[codec], dev)
        reset_launches()
        torch.cuda.synchronize()
        a = time.perf_counter()
        pred = ev.enhance_split(model, schedule, eval_low, eval_init, eval_step, grid,
                                device=dev)
        per = ev.per_image_metrics(pred, eval_target)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - a
        batches = -(-eval_n // ev.BATCH_SIZE) * len(grid)
        counts = kernel_launches()
        require(counts == {"linear_attention": batches, "fused_irb_v2": 0, "fused_irb_v1": 0},
                f"{codec}: eval launches {counts} for {batches} UNet calls")
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], cref["images"])]
                  for k in EVAL_TOL}
        for k, tol in EVAL_TOL.items():
            worst = int(np.argmax(deltas[k]))
            require(deltas[k][worst] <= tol,
                    f"{codec} package: image {worst}: |Δ{k}| {deltas[k][worst]} "
                    f"against JAX's {codec} package > {tol}")
        eval_rows[f"{STUDENT}:{codec}"] = row = dict(
            student=STUDENT, package=codec, weights=STUDENT, grid=grid, images=eval_n,
            size=size, batch=ev.BATCH_SIZE, launches=counts,
            mean={k: float(np.mean(per[k])) for k in EVAL_TOL},
            jax_mean={k: cref["summary"][f"{k}_mean"] for k in EVAL_TOL},
            max_abs_delta={k: max(v) for k, v in deltas.items()},
            worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
            tol=EVAL_TOL, seconds=seconds, images_per_s=eval_n / seconds, per_image=per)
        emit("eval", **row)
        del model, pred
    emit("eval_summary", inputs_sha256_match=eval_n,
         psnr_mean={k: r["mean"]["psnr"] for k, r in eval_rows.items()},
         jax_psnr_mean=ref["summary"]["psnr_mean"],
         jax_psnr_mean_by_run={k: r["jax_mean"]["psnr"] for k, r in eval_rows.items()},
         max_abs_delta={k: r["max_abs_delta"] for k, r in eval_rows.items()},
         images_per_s={k: r["images_per_s"] for k, r in eval_rows.items()},
         seconds=time.perf_counter() - t0)

    # 9. profile (optional) -------------------------------------------------
    if args.profile:
        for pipe, (label, *_) in ((pipes[0], SERVED[0]), (pipes[-1], SERVED[-1])):
            resident, peak_blocks = peak_where(pipe)
            emit("profile", run=label, resident_mem_bytes=resident,
                 peak_mem_blocks_batch8=peak_blocks)
        for pipe, label in ((pipes[0], ""), (pipes[-1], "fused_")):
            for _ in range(3):              # warm-up: cuDNN plans, allocator
                pipe(images[2], seed=0)
                pipe.batch(batch_images, seed=0)
            profile(f"{label}request_480x720_batch1",
                    lambda pipe=pipe: pipe(images[2], seed=1), 1)
            profile(f"{label}batch8_mixed_sizes",
                    lambda pipe=pipe: pipe.batch(batch_images, seed=1), 8)

    # 10. train: the training path at full width ---------------------------
    t0 = time.perf_counter()
    del pipes, fused_pipe, blk, pipe, student
    torch.cuda.empty_cache()
    train_cfg = TrainConfig(unet_variant="small", image_size=size, batch_size=8,
                            use_amp=False, epochs=1, warmup_epochs=0,
                            prediction_type="v_prediction", log_interval=1000,
                            seed=0, checkpoint_dir=os.path.join(
                                tempfile.mkdtemp(prefix="chip_smoke_"), "ckpt"))
    model_cfg = diffusion_config("small", size, prediction_type="v_prediction")
    train_weights = init_weights(model_cfg, seed=0, device=dev)

    def train_model_on_card(cfg=model_cfg, weights_=train_weights, device=dev):
        model, schedule = create_model(cfg, device=device)
        model.load_state_dict(weights_, strict=True)
        return model, schedule

    # synthetic batches made in bulk before the timed steps (set-up)
    data_rng = np.random.default_rng(0)
    normal_images = data_rng.integers(0, 256, (16, size + 32, size + 32, 3),
                                      dtype=np.uint8)
    loader = DataLoader(SyntheticLowLightDataset(normal_images, image_size=size, seed=0),
                        8, shuffle=True, drop_last=True, seed=0)
    batches = [b for _ in range(6) for b in loader]       # 12 batches of 8
    warm, timed, val = batches[:2], batches[2:], batches[:2]
    model, schedule = train_model_on_card()
    train_params = count_params(model.unet)
    require(train_params == 18_008_035 or size != 256,
            f"small UNet at 256²: {train_params} params, not 18,008,035")
    trainer = Trainer(model, schedule, timed, val, train_cfg)
    mid_qkv = model.unet.mid_attn.to_qkv.weight
    n_attn = sum(isinstance(m, LinearAttention) for m in model.modules())
    require(n_attn == (1 if size == 256 else n_attn),
            f"{n_attn} attention blocks in the small UNet at {size}², not 1")

    lak.linear_attention_kernel.launches = 0
    lak.linear_attention_backward_kernel.launches = 0
    fik.fused_irb_v2.launches = 0
    metrics_seen = []
    for batch in warm:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        metrics_seen.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):    # its log line
        train_loss = trainer.train_epoch()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - a
    peak_train = torch.cuda.max_memory_allocated()
    steps = len(warm) + len(timed)
    train_launches = {"linear_attention": lak.linear_attention_kernel.launches,
                      "linear_attention_backward":
                          lak.linear_attention_backward_kernel.launches,
                      "fused_irb_v2": fik.fused_irb_v2.launches}
    require(train_launches["linear_attention"] == steps * n_attn,
            f"train: forward attention launches {train_launches}, {steps} steps")
    require(train_launches["linear_attention_backward"] == steps * n_attn,
            f"train: backward attention launches {train_launches}, {steps} steps")
    require(trainer.state.step == steps, f"train: {trainer.state.step} steps taken")
    require(np.isfinite(train_loss), f"train loss {train_loss}")
    for m in metrics_seen:
        require(bool(torch.isfinite(m["loss"]) & torch.isfinite(m["grad_norm"])),
                f"train: loss {m['loss']} grad norm {m['grad_norm']}")
    grads = {n: p.grad for n, p in model.named_parameters()}
    require(all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values()),
            "train: a parameter without a finite gradient")
    qkv_grad = float(mid_qkv.grad.abs().max())
    require(qkv_grad > 0, "train: mid_attn.to_qkv has a zero gradient")

    if args.profile:        # where a train step's time goes, per image
        profile("train_step_small256_batch8",
                lambda: trainer.train_step(trainer.state, timed[0]), 8, runs=3)

    before_val = lak.linear_attention_kernel.launches
    val_loss = trainer.validate()
    val_launches = lak.linear_attention_kernel.launches - before_val
    require(np.isfinite(val_loss) and val_launches == len(val) * n_attn,
            f"validation: loss {val_loss}, {val_launches} attention launches")

    # checkpoint save and restore on the card
    ckpt_path = trainer.save_checkpoint("smoke")
    fresh, _ = train_model_on_card()
    resumed = Trainer(fresh, schedule, timed, val,
                      dataclasses.replace(train_cfg, resume_from=ckpt_path))
    require(resumed.state.step == trainer.state.step
            and resumed.epoch == trainer.epoch + 1,
            f"restore: step {resumed.state.step}, epoch {resumed.epoch}")
    require(all(torch.equal(p, q) for p, q in zip(fresh.parameters(), model.parameters())),
            "restore: parameters differ")
    require(all(torch.equal(resumed.state.ema_params[k], e)
                for k, e in trainer.state.ema_params.items()), "restore: EMA differs")
    sa, sb = (t.state.optimizer.state_dict()["state"] for t in (trainer, resumed))
    require(all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa),
            "restore: optimizer state differs")
    require(torch.equal(trainer.state.generator.get_state(),
                        resumed.state.generator.get_state()), "restore: generator differs")
    ckpt_bytes = os.path.getsize(ckpt_path)
    del resumed, fresh, trainer, model
    shutil.rmtree(os.path.dirname(train_cfg.checkpoint_dir), ignore_errors=True)
    torch.cuda.empty_cache()
    emit("train", config=f"small@{size} v-prediction float32", batch=8,
         params=train_params, warmup_steps=len(warm), timed_steps=len(timed),
         ms_per_step=elapsed * 1e3 / len(timed),
         images_per_s=len(timed) * 8 / elapsed, peak_mem_bytes=peak_train,
         train_loss=train_loss, val_loss=val_loss, launches=train_launches,
         launches_per_step={k: v / steps for k, v in train_launches.items()},
         mid_attn_to_qkv_grad_max_abs=qkv_grad, checkpoint_bytes=ckpt_bytes,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()

    # one step through the kernels against the same step with the attention
    # on its plain autograd path: same weights, batch, t and ε (the same
    # generator seed), f32. Bounds: the two attention passes differ by ~1e-7,
    # which GroupNorm's one-pass variance amplifies in the float32 gradients
    # (on the CPU tests' tiny UNet a float32 gradient is up to 2.5e-3 of its
    # tensor's largest entry from float64), so the gradients are held to
    # 1e-3 of their norm and each tensor to 1e-2 of its largest entry;
    # AdamW's first update is ±lr where a gradient is far above eps, so an
    # entry near 0 whose sign differs moves the parameter by up to 2·lr
    # (a bound any first step meets); such entries must stay rare: at most
    # 1% of the parameters may differ by more than 1e-6.
    # The backward kernel itself is held to its plain version on the step's
    # own q, k, v and upstream gradient.
    step_inputs = {}

    def one_step(plain_attention: bool, cfg=model_cfg, weights_=train_weights,
                 device=dev, batch=warm[0]):
        model, schedule = train_model_on_card(cfg, weights_, device)
        state = create_train_state(model, train_cfg)
        step = make_train_step(model, schedule, train_cfg)
        original = lak.linear_attention_trainable
        attn = model.unet.mid_attn.attn

        def keep_qkv(module, args):      # the backward's q, k, v ...
            step_inputs["qkv"] = [a.detach().clone() for a in args]

        def keep_g(module, args, out):   # ... and its upstream gradient
            out.register_hook(lambda g: step_inputs.__setitem__("g", g.detach().clone()))

        hooks_ = [attn.register_forward_pre_hook(keep_qkv),
                  attn.register_forward_hook(keep_g)]
        if plain_attention:
            lak.linear_attention_trainable = linear_attention_plain
        try:
            state, m = step(state, batch)
        finally:
            lak.linear_attention_trainable = original
            for h_ in hooks_:
                h_.remove()
        return (float(m["loss"]), {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    def step_diffs(a, b):
        """Loss, gradient-norm and worst-tensor differences of two steps,
        the parameters' largest difference, and the share of parameter
        entries that differ by more than STEP_PARAM_TOL."""
        loss_rel = abs(a[0] - b[0]) / abs(b[0])
        diff_sq = sum(float((a[1][k] - b[1][k]).double().square().sum()) for k in b[1])
        norm_sq = sum(float(b[1][k].double().square().sum()) for k in b[1])
        worst = max((float((a[1][k] - b[1][k]).abs().max())
                     / (float(b[1][k].abs().max()) + 1e-12), k) for k in b[1])
        moved = sum(int(((a[2][k] - b[2][k]).abs() > STEP_PARAM_TOL).sum()) for k in b[2])
        total = sum(t.numel() for t in b[2].values())
        return dict(loss_rel=loss_rel, grad_norm_rel=(diff_sq / norm_sq) ** 0.5,
                    grad_tensor_rel=worst[0], worst_tensor=worst[1],
                    param_max_abs=max(float((a[2][k] - b[2][k]).abs().max())
                                      for k in b[2]),
                    param_differ_share=moved / total)

    def within(d):
        return (d["loss_rel"] <= STEP_LOSS_TOL and d["grad_norm_rel"] <= STEP_GRAD_NORM_TOL
                and d["grad_tensor_rel"] <= STEP_GRAD_TOL
                and d["param_differ_share"] <= STEP_PARAM_SHARE)

    before = lak.linear_attention_backward_kernel.launches
    with_kernels = one_step(False)
    kernel_step_inputs = dict(step_inputs)
    require(lak.linear_attention_backward_kernel.launches == before + n_attn,
            "the kernel step did not launch the backward kernel")
    with_plain = one_step(True)
    require(lak.linear_attention_backward_kernel.launches == before + n_attn,
            "the plain-attention step launched the backward kernel")
    kernel_vs_plain = step_diffs(with_kernels, with_plain)
    q, k, v = kernel_step_inputs["qkv"]
    g = kernel_step_inputs["g"].contiguous()
    require(tuple(q.shape) == (8, 1024, 4, 32) or size != 256,
            f"train: mid_attn backward shape {tuple(q.shape)}")
    step_bwd_err = compare_bwd(q, k, v, g)
    require(step_bwd_err <= BWD_TOL["float32"],
            f"backward kernel vs plain on the step's own inputs: {step_bwd_err}")
    del with_kernels, with_plain, q, k, v, g
    torch.cuda.empty_cache()

    # one step on the card against the CPU: small at 64², batch 2, explicit
    # t and ε (the two devices' generators draw different numbers)
    small_cfg = diffusion_config("small", 64, prediction_type="v_prediction")
    small_w = init_weights(small_cfg, seed=1, device="cpu")
    small_batch = {k: v[:2, :64, :64] for k, v in warm[0].items()}
    t_fix = torch.tensor([37, 801])
    eps_fix = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))

    def explicit_step(device):
        model, schedule = train_model_on_card(small_cfg, small_w, device)
        state = create_train_state(model, train_cfg)
        out = train_forward(model, schedule,
                            torch.from_numpy(small_batch["low_light"]).to(device),
                            torch.from_numpy(small_batch["normal_light"]).to(device),
                            timesteps=t_fix.to(device), noise=eps_fix.to(device))
        loss = diffusion_loss(out["noise_pred"], out["target"])
        loss.backward()
        apply_update(state, train_cfg)
        return (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                {n: p.detach().cpu() for n, p in model.named_parameters()})

    on_card = explicit_step(dev)
    on_cpu = explicit_step(torch.device("cpu"))
    card_vs_cpu = step_diffs(on_card, on_cpu)
    emit("train_check", kernel_vs_plain_step=kernel_vs_plain,
         card_vs_cpu_step_small64=card_vs_cpu,
         backward_on_step_inputs_max_abs_err=step_bwd_err,
         step_tol=dict(loss_rel=STEP_LOSS_TOL, grad_norm_rel=STEP_GRAD_NORM_TOL,
                       grad_tensor_rel=STEP_GRAD_TOL,
                       param_differ_by=STEP_PARAM_TOL,
                       param_differ_share=STEP_PARAM_SHARE),
         seconds=time.perf_counter() - t0)
    require(within(kernel_vs_plain), f"kernel vs plain-attention step: {kernel_vs_plain}")
    require(within(card_vs_cpu), f"card vs CPU step: {card_vs_cpu}")

    # kernels line, nvidia-smi line, last line -----------------------------
    main_row = timings[((1, 1024, 4, 32), "float32")]
    bwd_main = bwd_rows[((8, 1024, 4, 32), "float32")]    # the train batch
    # the fused IRB per UNet call at batch 1: each shape's time times the
    # IRBs of that shape in a call
    call_rows = [irb_rows[key + (1, "float32")] for key in per_call]
    per_unet = {f: sum(r[f] * r["per_unet_call"] for r in call_rows)
                for f in ("kernel_ms", "plain_ms", "kernel_graph_ms",
                          "plain_graph_ms", "bound_ms", "tc_bound_ms", "flops")}
    irb_err_all = max([irb_err] + [r["max_err"] for r in irb_rows.values()
                                   if r["dtype"] == "float32"])
    v1_call_rows = [v1_rows[key + (1, "float32")] for key in per_call]
    v1_per_unet = {f: sum(r[f] * r["per_unet_call"] for r in v1_call_rows)
                   for f in ("kernel_ms", "plain_ms", "kernel_graph_ms",
                             "plain_graph_ms", "bound_ms", "tc_bound_ms",
                             "v2_kernel_graph_ms")}
    v1_err_all = max([max(v1_vs_block.values())]
                     + [r["max_err"] for r in v1_rows.values() if r["dtype"] == "float32"])
    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:82",
        "launches": launches["linear_attention"],
        "launches_in_replays": replayed["linear_attention"],
        "launches_package": pkg_launches["linear_attention"],
        "launches_package_in_replays": pkg_replayed["linear_attention"],
        "launches_train": train_launches["linear_attention"],
        "launches_eval": sum(r["launches"]["linear_attention"] for r in eval_rows.values()),
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
        "kernels_per_call": main_row["kernels_per_call"],
    }, {
        "name": "fused_irb_v2",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/fused_irb.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_irb.py:607",
        "launches": launches["fused_irb_v2"],
        "launches_in_replays": replayed["fused_irb_v2"],
        "launches_package": pkg_launches["fused_irb_v2"],
        "launches_package_in_replays": pkg_replayed["fused_irb_v2"],
        "launches_eval": sum(r["launches"]["fused_irb_v2"] for r in eval_rows.values()),
        "max_abs_err": irb_err_all,
        "ms": per_unet["kernel_ms"],
        "plain_ms": per_unet["plain_ms"],
        "graph_ms": per_unet["kernel_graph_ms"],
        "plain_graph_ms": per_unet["plain_graph_ms"],
        "bound_ms": per_unet["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in call_rows) else "bytes",
        "tc_bound_ms": per_unet["tc_bound_ms"],
        "library_ms": None,
        "shape": f"the {IRBS_PER_UNET_CALL} IRBs of one small-UNet call at "
                 f"{size}², batch 1 ({per_unet['flops'] / 1e9:.2f} GFLOP)",
        "dtype": "float32",
    }, {
        "name": "fused_irb_v1",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/fused_irb.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_irb.py:241",
        "launches": v1_path_launches,
        "max_abs_err": v1_err_all,
        "ms": v1_per_unet["kernel_ms"],
        "plain_ms": v1_per_unet["plain_ms"],
        "graph_ms": v1_per_unet["kernel_graph_ms"],
        "plain_graph_ms": v1_per_unet["plain_graph_ms"],
        "v2_graph_ms": v1_per_unet["v2_kernel_graph_ms"],
        "bound_ms": v1_per_unet["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in v1_call_rows) else "bytes",
        "tc_bound_ms": v1_per_unet["tc_bound_ms"],
        "library_ms": None,
        "shape": f"the {IRBS_PER_UNET_CALL} IRBs of one small-UNet call at "
                 f"{size}², batch 1; launched on the {IRBS_PER_UNET_CALL} IRB inputs "
                 "of a served request (no model path runs it)",
        "dtype": "float32",
    }, {
        "name": "linear_attention_backward",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:202",
        "launches": train_launches["linear_attention_backward"],
        "max_abs_err": max(r["max_err"] for r in bwd_rows.values()
                           if r["dtype"] == "float32"),
        "ms": bwd_main["kernel_ms"],
        "plain_ms": bwd_main["plain_ms"],
        "graph_ms": bwd_main["kernel_graph_ms"],
        "plain_graph_ms": bwd_main["plain_graph_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "shape": bwd_main["shape"],
        "dtype": bwd_main["dtype"],
        "kernels_per_call": bwd_main["kernels_per_call"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
