#!/usr/bin/env python
"""The flash-attention backward kernels against an earlier version of
``csrc/flash_attention.cu``, in one process on one card.

    git show <commit>:cv_diffusion_tpu_torch/csrc/flash_attention.cu > _archive/flash_old.cu
    python scripts/torch_port_flash_ab.py --old _archive/flash_old.cu [--sweep]
        [--shapes 1,1024,4,32 8,1024,4,32] [--iters 100]

The earlier source is built with its own ``nvcc`` call beside the current
one (``ops/cuda_build.py``). It is the CUDA-core backward (commit d79ada7),
whose dQ entry reads di, which ``row_dot`` forms before both kernels; the
current dQ entry takes the forward's output and forms di itself, for dK/dV
after it. At each
shape (``chip_smoke.FLASH_TIMED`` unless ``--shapes``) and in float32 and
bf16, both versions' dK, dV and dQ (and the current di) are held to the
plain version at the card's gate (``chip_smoke.flash_limit``), and the
current ones to themselves on a rerun, bit for bit. Then each is timed from
a CUDA graph replayed ``--iters`` times (CUDA events), in the order old,
new, new, old: dK/dV, dQ (the current one forming di), and the pair with
di (old: ``row_dot``, dK/dV, dQ; new: dQ, dK/dV: what a training step's
backward runs); ``row_dot`` alone and ``scaled_dot_product_attention``'s
backward (its forward and ``autograd.grad`` captured, less its forward)
beside them, with each kernel's bound (``chip_smoke.flash_bound``). One
JSON line a shape and dtype.

With ``--sweep`` the current source's dK/dV and dQ are also timed under
every plan it takes (rows a block 16 to 128, split 1, 2 or 4; each launch
checked against the plain version first): what its default plan is chosen
from. One JSON line a shape and dtype.

Needs a CUDA device; prints the card and its power limit first.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

# the repository's root in place of scripts/, whose profile.py would shadow
# the standard module that torch imports
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from cv_diffusion_tpu_torch.ops import cuda_build  # noqa: E402
from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk  # noqa: E402
from cv_diffusion_tpu_torch.ops.attention import (  # noqa: E402
    row_dot, softmax_attention_backward_rows, softmax_attention_plain)

ROWS, SPLITS = (16, 32, 64, 128), (1, 2, 4)


def declare_old(lib) -> None:
    """The earlier source's backward entries' C signatures (its dQ reads
    di)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"flash_bwd_dkv_{dt}")
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"flash_bwd_dq_{dt}")
        fn.argtypes = [ptr] * 7 + [i32] * 4 + [f32, ptr]
        fn.restype = i32


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: captured once in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(5):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def run_old(lib, kernel, q, k, v, do, lse, di, scale):
    """dK/dV or the earlier source's dQ (di read) through ``lib``."""
    if kernel == "dkv":
        return fk._launch_dkv(lib, stream(), q, k, v, do, lse, di, scale)
    dq = torch.empty_like(q)
    err = getattr(lib, f"flash_bwd_dq_{'f32' if q.dtype == torch.float32 else 'bf16'}")(
        *(t.data_ptr() for t in (q, k, v, do, lse, di, dq)), *q.shape, float(scale), stream())
    assert err == 0, err
    return (dq,)


def run_new(lib, kernel, q, k, v, do, lse, out, di, scale):
    """dK/dV (on di) or dQ (forming di from out; returns dq, di) through the
    current source's default entries, the wrapper's launches."""
    if kernel == "dkv":
        return fk._launch_dkv(lib, stream(), q, k, v, do, lse, di, scale)
    return fk._launch_dq(lib, stream(), q, k, v, do, lse, out, scale)


def run_planned(lib, kernel, rows, split, q, k, v, do, lse, out, di, scale):
    """dK/dV or dQ (with di, as :func:`run_new`) through the current source
    under one plan."""
    out0 = torch.empty_like(q)
    out1 = torch.empty_like(q) if kernel == "dkv" else None
    if kernel == "dq":
        di = torch.empty_like(di)
    err = lib.flash_bwd_planned(fk.KERNELS.index(kernel), int(q.dtype == torch.bfloat16),
                                rows, split, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), out.data_ptr() if kernel == "dq" else None,
                                lse.data_ptr(), di.data_ptr(), out0.data_ptr(),
                                None if out1 is None else out1.data_ptr(), *q.shape,
                                float(scale), stream())
    fk._raise_on(lib, err, kernel, q)
    return (out0, di) if out1 is None else (out0, out1)


def check(name, got, want, dtype_name) -> list:
    """Max |got - want| of each output, each held to the card's gate."""
    errs = []
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max())
        limit = chip_smoke.flash_limit(w, dtype_name, backward=True)
        if not e <= limit:
            raise AssertionError(f"{name}: {e} above the gate {limit}")
        errs.append(e)
    return errs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", required=True, help="the earlier csrc/flash_attention.cu")
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="B,N,H,D shapes (default chip_smoke.FLASH_TIMED)")
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--sweep", action="store_true", help="also time every plan")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi.splitlines()[0], "torch": torch.__version__}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        old_built, new_built = pool.map(cuda_build.build, (os.path.abspath(args.old), fk.SOURCE))
    old = cuda_build.load(os.path.abspath(args.old), declare_old)
    new = cuda_build.load(fk.SOURCE, fk._declare)
    print(json.dumps({"build_s": time.perf_counter() - t0, "old": old_built.path,
                      "new": new_built.path}), flush=True)

    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shapes] if args.shapes
              else chip_smoke.FLASH_TIMED)
    gen = torch.Generator(device=dev).manual_seed(19)
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = shape[-1] ** -0.5
            out, lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
            out, lse = out.contiguous(), lse.float().contiguous()
            di = row_dot(out, do)
            ref = softmax_attention_backward_rows(q, k, v, do, lse, di, scale)
            want = {"dkv": ref[1:], "dq": ref[:1]}
            errs = {}
            for kernel in ("dkv", "dq"):
                got = run_old(old, kernel, q, k, v, do, lse, di, scale)
                torch.cuda.synchronize()
                errs[f"old_{kernel}"] = check(f"old {kernel} {shape} {name}", got, want[kernel],
                                              name)
                got = run_new(new, kernel, q, k, v, do, lse, out, di, scale)
                again = run_new(new, kernel, q, k, v, do, lse, out, di, scale)
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, again)):
                    raise AssertionError(f"{shape} {name} {kernel}: reruns differ")
                errs[f"new_{kernel}"] = check(f"new {kernel} {shape} {name}", got,
                                              want[kernel], name)
                if kernel == "dq":
                    errs["new_di"] = float((got[1] - di).abs().max())
                    if not errs["new_di"] <= 10 * chip_smoke.FLASH_TOL[0]:
                        raise AssertionError(f"new di {shape} {name}: {errs['new_di']}")

            def pair_old():
                d = row_dot(out, do)
                return (run_old(old, "dkv", q, k, v, do, lse, d, scale),
                        run_old(old, "dq", q, k, v, do, lse, d, scale))

            def pair_new():
                dq, d = run_new(new, "dq", q, k, v, do, lse, out, None, scale)
                return dq, run_new(new, "dkv", q, k, v, do, lse, out, d, scale)

            fns = {kernel: {"old": (lambda kernel=kernel:
                                    run_old(old, kernel, q, k, v, do, lse, di, scale)),
                            "new": (lambda kernel=kernel:
                                    run_new(new, kernel, q, k, v, do, lse, out, di, scale))}
                   for kernel in ("dkv", "dq")}
            fns["pair_with_di"] = {"old": pair_old, "new": pair_new}
            times = {}
            for key, pairfns in fns.items():
                t = [graph_ms(pairfns[lab], args.iters) for lab in ("old", "new", "new", "old")]
                times[key] = dict(old_new_new_old_ms=t, old_ms=(t[0] + t[3]) / 2,
                                  new_ms=(t[1] + t[2]) / 2, speedup=(t[0] + t[3]) / (t[1] + t[2]))
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
                return torch.autograd.grad(o, (qg, kg, vg), dot)

            sdpa_fwd = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                                args.iters)
            sdpa_both = graph_ms(lib_fwd_bwd, args.iters)
            print(json.dumps({
                "shape": list(shape), "dtype": name, "max_err": errs, **times,
                "row_dot_ms": graph_ms(lambda: row_dot(out, do), args.iters),
                "sdpa_bwd_ms": sdpa_both - sdpa_fwd,
                "plans": {kk: dict(fk.plan(new, kk, shape, dtype)._asdict()) for kk in ("dkv", "dq")},
                "bound": {kk: chip_smoke.flash_bound(shape, name, kk) for kk in ("dkv", "dq")},
                "device": smi.splitlines()[0]}), flush=True)

            if args.sweep:
                sweep = {}
                for kernel in ("dkv", "dq"):
                    for rows in ROWS:
                        for split in SPLITS:
                            p = fk.plan(new, kernel, shape, dtype, rows, split)
                            if p is None:
                                continue
                            got = run_planned(new, kernel, rows, split, q, k, v, do, lse, out,
                                              di, scale)
                            torch.cuda.synchronize()
                            check(f"sweep {kernel} {rows}x{split}", got, want[kernel], name)
                            sweep[f"{kernel} rows={rows} split={split}"] = dict(
                                ms=graph_ms(lambda kernel=kernel, rows=rows, split=split:
                                            run_planned(new, kernel, rows, split, q, k, v, do,
                                                        lse, out, di, scale), args.iters),
                                blocks=p.grid[0] * p.grid[1] * p.grid[2], warps=p.warps,
                                smem_bytes=p.smem_bytes)
                defaults = {kk: "{} rows={} split={}".format(kk, *fk.plan(new, kk, shape, dtype)[:2])
                            for kk in ("dkv", "dq")}
                print(json.dumps({"sweep": True, "shape": list(shape), "dtype": name,
                                  "default": defaults, "plans": sweep}), flush=True)
            del q, k, v, do, out, lse, di, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
