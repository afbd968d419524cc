#!/usr/bin/env python
"""The flash-attention kernels against an earlier version of
``csrc/flash_attention.cu``, in one process on one card.

    git show <commit>:cv_diffusion_tpu_torch/csrc/flash_attention.cu > _archive/flash_old.cu
    python scripts/torch_port_flash_ab.py --old _archive/flash_old.cu [--sweep]
        [--shapes 1,1024,4,32 8,1024,4,32] [--iters 100]

The earlier source is built with its own ``nvcc`` call beside the current
one (``ops/cuda_build.py``); its six default entries must take the current
C signatures (commit c51b104 on: the CUDA-core forward and the tensor-core
backward, whose dQ forms di from the forward's output). At each shape
(``chip_smoke.FLASH_TIMED`` unless ``--shapes``) and in float32 and bf16,
both versions' forward (out and lse) and backward (dQ, then dK/dV on its
di) are held to the plain version at the card's gates
(``chip_smoke.flash_limit``; lse within 10x the float32 forward's limit),
each version's backward on its own forward's lse, and the current ones to
themselves on a rerun, bit for bit. Then each is timed from a CUDA graph
replayed ``--iters`` times (CUDA events), in the order old, new, new, old:
the forward without lse (what serving runs) and with it (what training
runs), and the backward pair; ``scaled_dot_product_attention``'s forward
and backward (its forward and ``autograd.grad`` captured, less its
forward) beside them, with each kernel's bound (``chip_smoke.flash_bound``).
One JSON line a shape and dtype.

With ``--sweep`` the current source's forward, dK/dV and dQ are also timed
under every plan it takes (rows a block 16 to 128, split 1, 2 or 4; each
launch checked against the plain version first): what its defaults are
chosen from. One JSON line a shape and dtype.

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
    """The earlier source's six default entries (the current signatures)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        for name, ptrs in (("flash_fwd", 5), ("flash_bwd_dkv", 8), ("flash_bwd_dq", 8)):
            fn = getattr(lib, f"{name}_{dt}")
            fn.argtypes = [ptr] * ptrs + [i32] * 4 + [f32, ptr]
            fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_plan.argtypes = [i32] * 8 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_plan.restype = i32


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


def forward(lib, q, k, v, scale, with_lse):
    """(out, lse) through ``lib``'s default forward entry."""
    return fk._launch_forward(lib, stream(), q, k, v, scale, with_lse)


def backward(lib, q, k, v, do, lse, out, scale):
    """(dq, dk, dv, di) through ``lib``'s default entries: dQ (forming di),
    then dK/dV on that di: what a training step's backward runs."""
    dq, di = fk._launch_dq(lib, stream(), q, k, v, do, lse, out, scale)
    return (dq, *fk._launch_dkv(lib, stream(), q, k, v, do, lse, di, scale), di)


def fwd_planned(lib, rows, split, q, k, v, scale):
    """(out, lse) through the current source's forward under one plan."""
    b, n, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_planned(int(q.dtype == torch.bfloat16), rows, split, q.data_ptr(),
                                k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                b, n, h, d, float(scale), stream())
    fk._raise_on(lib, err, "forward", q)
    return out, lse


def bwd_planned(lib, kernel, rows, split, q, k, v, do, lse, out, di, scale):
    """dK/dV (on di) or dQ (forming di from out; returns dq, di) through the
    current source under one plan."""
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


def check(name, got, want, dtype_name, backward_gate=False) -> list:
    """Max |got - want| of each output, each held to the card's gate."""
    errs = []
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max())
        limit = chip_smoke.flash_limit(w, dtype_name, backward=backward_gate)
        if not e <= limit:
            raise AssertionError(f"{name}: {e} above the gate {limit}")
        errs.append(e)
    return errs


def check_lse(name, got, want) -> float:
    e = float((got - want).abs().max())
    if not e <= 10 * chip_smoke.FLASH_TOL[0]:
        raise AssertionError(f"{name}: lse {e} above the gate")
    return e


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
    gen = torch.Generator(device=dev).manual_seed(20)
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = shape[-1] ** -0.5
            ref, ref_lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
            ref_lse = ref_lse.float()
            ref_grads = softmax_attention_backward_rows(q, k, v, do, ref_lse,
                                                        row_dot(ref, do), scale)
            errs, outs = {}, {}
            for label, lib in (("old", old), ("new", new)):
                out, lse = forward(lib, q, k, v, scale, True)
                grads = backward(lib, q, k, v, do, lse, out, scale)
                if label == "new":
                    again = forward(lib, q, k, v, scale, True)
                    grads2 = backward(lib, q, k, v, do, lse, out, scale)
                    torch.cuda.synchronize()
                    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                            and all(map(torch.equal, grads, grads2))):
                        raise AssertionError(f"{shape} {name}: reruns differ")
                torch.cuda.synchronize()
                errs[f"{label}_fwd"] = check(f"{label} forward {shape} {name}", (out,), (ref,),
                                             name)[0]
                errs[f"{label}_lse"] = check_lse(f"{label} {shape} {name}", lse, ref_lse)
                errs[f"{label}_bwd"] = check(f"{label} backward {shape} {name}", grads[:3],
                                             ref_grads, name, backward_gate=True)
                outs[label] = (out, lse)

            fns = {"fwd": {lab: (lambda lib=lib: forward(lib, q, k, v, scale, False))
                           for lab, lib in (("old", old), ("new", new))},
                   "fwd_lse": {lab: (lambda lib=lib: forward(lib, q, k, v, scale, True))
                               for lab, lib in (("old", old), ("new", new))},
                   "bwd_pair": {lab: (lambda lib=lib, ol=outs[lab]:
                                      backward(lib, q, k, v, do, ol[1], ol[0], scale))
                                for lab, lib in (("old", old), ("new", new))}}
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
                "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_both - sdpa_fwd,
                "fwd_over_sdpa": times["fwd"]["new_ms"] / sdpa_fwd,
                "plans": {kk: dict(fk.plan(new, kk, shape, dtype)._asdict()) for kk in fk.KERNELS},
                "old_fwd_plan": dict(fk.plan(old, "forward", shape, dtype)._asdict()),
                "bound": {kk: chip_smoke.flash_bound(shape, name, kk) for kk in fk.KERNELS},
                "device": smi.splitlines()[0]}), flush=True)

            if args.sweep:
                out, lse = outs["new"]
                di = row_dot(out, do)
                want = {"dkv": ref_grads[1:], "dq": ref_grads[:1]}
                sweep = {}
                for rows in ROWS:
                    for split in SPLITS:
                        p = fk.plan(new, "forward", shape, dtype, rows, split)
                        if p is None:
                            continue
                        got = fwd_planned(new, rows, split, q, k, v, scale)
                        torch.cuda.synchronize()
                        check(f"sweep forward {rows}x{split}", got[:1], (ref,), name)
                        check_lse(f"sweep forward {rows}x{split}", got[1], ref_lse)
                        sweep[f"forward rows={rows} split={split}"] = dict(
                            ms=graph_ms(lambda rows=rows, split=split:
                                        fwd_planned(new, rows, split, q, k, v, scale),
                                        args.iters),
                            blocks=p.grid[0] * p.grid[1] * p.grid[2], warps=p.warps,
                            smem_bytes=p.smem_bytes)
                for kernel in ("dkv", "dq"):
                    for rows in ROWS:
                        for split in SPLITS:
                            p = fk.plan(new, kernel, shape, dtype, rows, split)
                            if p is None:
                                continue
                            got = bwd_planned(new, kernel, rows, split, q, k, v, do, lse, out,
                                              di, scale)
                            torch.cuda.synchronize()
                            check(f"sweep {kernel} {rows}x{split}", got, want[kernel], name,
                                  backward_gate=True)
                            sweep[f"{kernel} rows={rows} split={split}"] = dict(
                                ms=graph_ms(lambda kernel=kernel, rows=rows, split=split:
                                            bwd_planned(new, kernel, rows, split, q, k, v, do,
                                                        lse, out, di, scale), args.iters),
                                blocks=p.grid[0] * p.grid[1] * p.grid[2], warps=p.warps,
                                smem_bytes=p.smem_bytes)
                defaults = {kk: "{} rows={} split={}".format(
                    kk, *fk.plan(new, kk, shape, dtype)[:2]) for kk in fk.KERNELS}
                print(json.dumps({"sweep": True, "shape": list(shape), "dtype": name,
                                  "default": defaults, "plans": sweep}), flush=True)
            del q, k, v, do, ref, ref_lse, ref_grads, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
