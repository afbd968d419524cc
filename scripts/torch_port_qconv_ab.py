#!/usr/bin/env python
"""The int8 kernels against an earlier version of ``csrc/qconv.cu``, in one
process on one card.

    git show <commit>:cv_diffusion_tpu_torch/csrc/qconv.cu > _archive/qconv_old.cu
    python scripts/torch_port_qconv_ab.py --old _archive/qconv_old.cu [--batches 1 8]
        [--entries quantize weight conv]

The earlier source is built with its own ``nvcc`` call beside the current
one (``ops/cuda_build.py``) and called with the C signatures read from its
text: those of the ``__dp4a`` kernels (no launch-plan arguments), or the
planned ones (a dense tile; a depthwise band's rows and columns), which
take the current plans, held first to the source's own shared-memory
sizes. A source with other signatures is refused. Each entry is timed
from a CUDA graph replayed ``--iters`` times (CUDA events), in the order
old, new, new, old, after both outputs are held to the plain version bit
for bit:

- ``quantize``: the activation quantize (the same C signature in every
  version) at each distinct input of one small-UNet call at 256²
  (``--artifact``'s ``model_config.json``, each weighted by its count in
  the call): N(0, 2²) values, through ReLU6 where the QConv's input is
  bound (about half of them zeros, as when served); float32 and bf16; one
  JSON line a batch size and dtype, with the bound;
- ``weight``: the weight pass of the call's 83 QConvs (``--artifact``'s
  own weights from ``artifacts_torch/`` where they are there): the plain
  chain (``qconv.quantize_weight`` and the layout, as the int8 path ran it
  before ``qconv_kernel.quantize_weight``) against the kernel's 83
  launches, each captured whole in one graph, in the order plain, kernel,
  kernel, plain; one JSON line;
- ``conv``: at every ``QConv`` shape class and batch size, in float32
  compute, one random input quantized and both versions' dense or
  depthwise outputs; one JSON line a batch size: each class's four times
  and plan, and the sums over a UNet call. With ``--sweep`` each class is
  also timed under every other launch the current source takes (dense:
  each tile; depthwise: bands of 1 to 16 rows), each launch's output
  checked bit for bit first: what ``plan_dense`` and ``plan_depthwise``
  choose from.

Needs a CUDA device; prints the card and its power limit first.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

# the repository's root in place of scripts/, whose profile.py would shadow
# the standard module that torch imports
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from cv_diffusion_tpu_torch.config import load_model_config  # noqa: E402
from cv_diffusion_tpu_torch.export.quantization import (  # noqa: E402
    act_quant_model, qconv_modules)
from cv_diffusion_tpu_torch.ops import cuda_build  # noqa: E402
from cv_diffusion_tpu_torch.ops import qconv as tq  # noqa: E402
from cv_diffusion_tpu_torch.ops import qconv_kernel as qk  # noqa: E402
from cv_diffusion_tpu_torch.weights import load_state_dict_npz  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory


# the parameters of the dense and depthwise entries without a launch plan
DENSE_ARGS = ("xq", "wq", "amax", "s_w", "bias", "out", "N", "H", "W", "Cp", "O", "K", "stride",
              "pad", "OH", "OW")
DEPTHWISE_ARGS = ("xq", "wq", "amax", "s_w", "bias", "out", "N", "H", "W", "C", "Cp", "stride",
                  "OH", "OW")


def declare_quantize(lib) -> None:
    """The activation quantize's C signature, the same in every version."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"qconv_quantize_{dt}")
        fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        fn.restype = i32


def declare_unplanned(lib) -> None:
    """The ``__dp4a`` kernels' C signatures (no launch-plan arguments)."""
    declare_quantize(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"qconv_dense_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * (len(DENSE_ARGS) - 6) + [ptr]
        fn.restype = i32
        fn = getattr(lib, f"qconv_depthwise_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * (len(DEPTHWISE_ARGS) - 6) + [ptr]
        fn.restype = i32


def declare_planned(lib) -> None:
    """The C signatures with a launch plan (a dense tile; a depthwise band),
    the current ones but the weight pass's entry, which earlier versions
    lack."""
    declare_quantize(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"qconv_dense_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * (len(DENSE_ARGS) - 6 + 1) + [ptr]
        fn.restype = i32
        fn = getattr(lib, f"qconv_depthwise_{dt}")
        fn.argtypes = [ptr] * 6 + [i32] * (len(DEPTHWISE_ARGS) - 6 + 2) + [ptr]
        fn.restype = i32
    lib.qconv_dense_smem_bytes.argtypes = [i32, i32]
    lib.qconv_dense_smem_bytes.restype = i32
    lib.qconv_depthwise_smem_bytes.argtypes = [i32] * 3
    lib.qconv_depthwise_smem_bytes.restype = i32
    lib.qconv_error_string.argtypes = [i32]
    lib.qconv_error_string.restype = ctypes.c_char_p


def parameters(source: str, entry: str) -> tuple:
    """The parameter names of ``int entry(...)`` in a source's text."""
    m = re.search(rf"\bint {entry}\(([^)]*)\)", source)
    if m is None:
        raise SystemExit(f"no entry {entry} in the earlier source")
    return tuple(p.split()[-1].lstrip("*") for p in m.group(1).split(","))


def load_old(path: str):
    """(the earlier library, whether its entries take the current plans)."""
    with open(path) as f:
        source = f.read()
    dense = parameters(source, "qconv_dense_f32")
    depthwise = parameters(source, "qconv_depthwise_f32")
    if (dense, depthwise) == (DENSE_ARGS + ("stream",), DEPTHWISE_ARGS + ("stream",)):
        return cuda_build.load(path, declare_unplanned), False
    if (dense, depthwise) == (DENSE_ARGS + ("tile", "stream"),
                              DEPTHWISE_ARGS + ("rows", "cols", "stream")):
        return cuda_build.load(path, declare_planned), True
    raise SystemExit(f"{path}: qconv_dense_f32{dense}, qconv_depthwise_f32{depthwise}: "
                     "signatures this runner does not know")


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


def shape_classes(cfg, dev, weights=None):
    """({(depthwise, Cin, Cout, kernel, stride, H, W, bias): count} of one
    UNet call at the config's size, in call order; (module, H, W) of each
    QConv call, in call order, with ``weights`` loaded where given)."""
    model, _ = act_quant_model(cfg, dev)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    classes, calls = {}, []

    def hook(mod, args):
        key = (mod.depthwise, mod.in_channels, mod.out_channels, mod.kernel_size[0],
               mod.stride[0], args[0].shape[2], args[0].shape[3], mod.bias is not None)
        classes[key] = classes.get(key, 0) + 1
        calls.append((mod, args[0].shape[2], args[0].shape[3]))

    for m in qconv_modules(model).values():
        m.act_quant = False          # the float path: only the shapes are wanted
        m.register_forward_pre_hook(hook)
    size = cfg.unet.image_size
    with torch.inference_mode():
        model.unet(torch.zeros(1, cfg.unet.in_channels, size, size, device=dev),
                   torch.tensor([739], dtype=torch.int32, device=dev))
    return classes, calls


def run_quantize(lib, x, amax):
    """One launch of ``lib``'s activation quantize on ``x``'s device."""
    n, c, h, w = x.shape
    out = torch.empty((n, h, w, tq.padded_channels(c)), dtype=torch.int8, device=x.device)
    err = getattr(lib, f"qconv_quantize_{'f32' if x.dtype == torch.float32 else 'bf16'}")(
        x.data_ptr(), amax.data_ptr(), out.data_ptr(), n, c, h * w, out.shape[-1],
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def quantize_ab(old, new, calls, batches, iters, gen, dev) -> None:
    """The activation quantize, old against new, at each distinct input of
    a UNet call's QConvs: N(0, 2²) values, through ReLU6 where the QConv's
    input is bound (``act_bound``: about half of them zeros, as served);
    one JSON line a batch size and dtype."""
    inputs = {}
    for mod, h, w in calls:
        key = (mod.in_channels, h, w, mod.act_bound is not None)
        inputs[key] = inputs.get(key, 0) + 1
    for b in batches:
        for dt in (torch.float32, torch.bfloat16):
            rows, sums = [], {"old_ms": 0.0, "new_ms": 0.0, "bound_ms": 0.0}
            for (cin, h, w, relu6), count in inputs.items():
                x = torch.randn((b, cin, h, w), generator=gen, device=dev) * 2
                x = (x.clamp(0, 6) if relu6 else x).to(dt)
                amax = x.float().abs().amax() * 0.75
                want = tq.quantize_plain(x, amax)
                got_old, got_new = run_quantize(old, x, amax), run_quantize(new, x, amax)
                torch.cuda.synchronize()
                if not (torch.equal(got_old, want) and torch.equal(got_new, want)):
                    raise AssertionError(f"quantize {(b, cin, h, w)} {dt}: new or old differs "
                                         "from the plain version")
                times = [graph_ms(fn, iters) for fn in (
                    lambda: run_quantize(old, x, amax), lambda: run_quantize(new, x, amax),
                    lambda: run_quantize(new, x, amax), lambda: run_quantize(old, x, amax))]
                old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
                # the float input read once, its int8 values (real channels) written once
                bound = x.numel() * (x.element_size() + 1) / HBM_BYTES_PER_S * 1e3
                sums["old_ms"] += count * old_ms
                sums["new_ms"] += count * new_ms
                sums["bound_ms"] += count * bound
                rows.append(dict(cin=cin, hw=[h, w], relu6=relu6, count=count,
                                 old_new_new_old_ms=times,
                                 old_ms=old_ms, new_ms=new_ms, bound_ms=bound,
                                 speedup=old_ms / new_ms))
            print(json.dumps({"entry": "quantize", "batch": b, "dtype": str(dt)[6:],
                              "per_unet_call": sums, "speedup": sums["old_ms"] / sums["new_ms"],
                              "share_of_bound_old": sums["bound_ms"] / sums["old_ms"],
                              "share_of_bound_new": sums["bound_ms"] / sums["new_ms"],
                              "classes": rows}), flush=True)


def weight_ab(calls, iters) -> None:
    """One UNet call's weight pass: the plain chain against the kernel, each
    the 83 QConvs' passes captured in one graph; one JSON line."""
    def plain():
        return [(tq.depthwise_weight_layout if m.depthwise else tq.dense_weight_layout)(wq)
                for m in mods for wq in (tq.quantize_weight(m.weight)[0],)]

    def kernel():
        return [qk.quantize_weight(m.weight, m.depthwise)[0] for m in mods]

    mods = [m for m, _, _ in calls]
    with torch.inference_mode():
        for m in mods:
            wq, want_s = tq.quantize_weight(m.weight)
            want_l = (tq.depthwise_weight_layout if m.depthwise else tq.dense_weight_layout)(wq)
            got_l, got_s = qk.quantize_weight(m.weight, m.depthwise)
            torch.cuda.synchronize()
            if not (torch.equal(got_l, want_l) and torch.equal(got_s, want_s)):
                raise AssertionError(f"weight pass {tuple(m.weight.shape)}: kernel != plain")
        times = [graph_ms(fn, iters) for fn in (plain, kernel, kernel, plain)]
    params = sum(m.weight.numel() for m in mods)
    real = sum(m.weight.numel() + m.out_channels * 4 for m in mods)
    print(json.dumps({"entry": "weight_pass", "qconvs": len(mods), "parameters": params,
                      "plain_kernel_kernel_plain_ms": times,
                      "plain_ms": (times[0] + times[3]) / 2, "kernel_ms": (times[1] + times[2]) / 2,
                      "bound_ms": (4 * params + real) / HBM_BYTES_PER_S * 1e3}), flush=True)


def sweep(lib, dw, xq, wl, cout, amax, s_w, bvec, s, k, dt, want, iters) -> dict:
    """{launch: graph ms} of one call under each launch the source takes."""
    n, h, w, cp = xq.shape

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if dw:
        ow = (w - 1) // s + 1
        launches = {f"rows={r}": qk.depthwise_launch(n, h, w, cp, s, r, min(ow, qk.DW_MAX_COLS))
                    for r in (1, 2, 3, 4, 6, 8, 12, 16)}
        launches = {key: p for key, p in launches.items() if p.smem_bytes <= qk.SMEM_MAX}
        run = {key: (lambda p=p: qk._depthwise(lib, xq, wl, cout, amax, s_w, bvec, s, dt,
                                               stream(), plan=p)) for key, p in launches.items()}
    else:
        launches = {f"tile={t}": qk.dense_launch(n, h, w, cp, cout, k, s, k // 2, dt, t)
                    for t in range(len(qk.DENSE_TILES))}
        run = {key: (lambda p=p: qk._dense(lib, xq, wl, amax, s_w, bvec, s, k // 2, dt, stream(),
                                           plan=p)) for key, p in launches.items()}
    out = {}
    for key, fn in run.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"sweep {key}: differs from the plain version")
        out[key] = graph_ms(fn, iters)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", required=True, help="the earlier csrc/qconv.cu")
    parser.add_argument("--artifact", default="vreg1b_gt03_ema")
    parser.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--entries", nargs="+", default=["quantize", "weight", "conv"],
                        choices=["quantize", "weight", "conv"])
    parser.add_argument("--sweep", action="store_true",
                        help="also time every tile (dense) and band (depthwise)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_qconv_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi.splitlines()[0], "torch": torch.__version__}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        old_built, new_built = pool.map(cuda_build.build, (os.path.abspath(args.old), qk.SOURCE))
    old, old_planned = load_old(os.path.abspath(args.old))
    new = cuda_build.load(qk.SOURCE, qk._declare)
    print(json.dumps({"build_s": time.perf_counter() - t0, "old": old_built.path,
                      "new": new_built.path}), flush=True)

    cfg = load_model_config(os.path.join(ROOT, "artifacts", args.artifact, "model_config.json"))
    npz = os.path.join(ROOT, "artifacts_torch", f"{args.artifact}.npz")
    weights = load_state_dict_npz(npz, dev) if os.path.exists(npz) else None
    classes, calls = shape_classes(cfg, dev, weights)
    gen = torch.Generator(device=dev).manual_seed(16)
    if "quantize" in args.entries:
        quantize_ab(old, new, calls, args.batches, args.iters, gen, dev)
    if "weight" in args.entries:
        weight_ab(calls, args.iters)
    dt = torch.float32
    for b in (args.batches if "conv" in args.entries else ()):
        rows, sums = [], {"old_ms": 0.0, "new_ms": 0.0, "dense_old_ms": 0.0, "dense_new_ms": 0.0,
                          "depthwise_old_ms": 0.0, "depthwise_new_ms": 0.0}
        for (dw, cin, cout, k, s, h, w, bias), count in classes.items():
            x = torch.randn((b, cin, h, w), generator=gen, device=dev) * 2
            amax = x.abs().amax() * 0.75
            xq = qk.quantize(x, amax)
            n, _, _, cp = xq.shape
            wt = torch.randn((cout, 1 if dw else cin, k, k), generator=gen, device=dev)
            wq, s_w = tq.quantize_weight(wt)
            bvec = torch.randn((cout,), generator=gen, device=dev) if bias else None
            bptr = None if bvec is None else bvec.data_ptr()
            if dw:
                wl = tq.depthwise_weight_layout(wq)
                oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
                plan = qk.plan_depthwise(n, h, w, cp, s)
                old_smem = (old.qconv_depthwise_smem_bytes(plan.rows, plan.cols, s)
                            if old_planned else plan.smem_bytes)

                def run_new():
                    return qk._depthwise(new, xq, wl, cout, amax, s_w, bvec, s, dt,
                                         torch.cuda.current_stream().cuda_stream)

                def run_old():
                    if old_planned:
                        return qk._depthwise(old, xq, wl, cout, amax, s_w, bvec, s, dt,
                                             torch.cuda.current_stream().cuda_stream)
                    out = torch.empty((n, cout, oh, ow), dtype=dt, device=dev)
                    err = old.qconv_depthwise_f32(xq.data_ptr(), wl.data_ptr(), amax.data_ptr(),
                                                  s_w.data_ptr(), bptr, out.data_ptr(), n, h, w,
                                                  cout, cp, s, oh, ow,
                                                  torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                    return out
                want = tq.int8_depthwise_plain(xq, wl, cout, amax, s_w, bvec, s, dt)
            else:
                wl = tq.dense_weight_layout(wq)
                p = k // 2
                oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
                plan = qk.plan_dense(n, h, w, cp, cout, k, s, p, dt)
                old_smem = (old.qconv_dense_smem_bytes(plan.tile, 0) if old_planned
                            else plan.smem_bytes)

                def run_new():
                    return qk._dense(new, xq, wl, amax, s_w, bvec, s, p, dt,
                                     torch.cuda.current_stream().cuda_stream)

                def run_old():
                    if old_planned:
                        return qk._dense(old, xq, wl, amax, s_w, bvec, s, p, dt,
                                         torch.cuda.current_stream().cuda_stream)
                    out = torch.empty((n, cout, oh, ow), dtype=dt, device=dev)
                    err = old.qconv_dense_f32(xq.data_ptr(), wl.data_ptr(), amax.data_ptr(),
                                              s_w.data_ptr(), bptr, out.data_ptr(), n, h, w, cp,
                                              cout, k, s, p, oh, ow,
                                              torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                    return out
                want = tq.int8_conv_plain(xq, wl, amax, s_w, bvec, s, p, dt)
            if old_smem != plan.smem_bytes:
                raise SystemExit(f"{(dw, cin, cout, k, s, h, w)}: the earlier source lays out "
                                 f"{old_smem} bytes of shared memory for the plan {plan}")
            got_new, got_old = run_new(), run_old()
            torch.cuda.synchronize()
            if not (torch.equal(got_new, want) and torch.equal(got_old, want)):
                raise AssertionError(f"{(dw, cin, cout, k, s, h, w)} batch {b}: new or old "
                                     "differs from the plain version")
            times = [graph_ms(fn, args.iters) for fn in (run_old, run_new, run_new, run_old)]
            old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            kind = "depthwise" if dw else "dense"
            sums["old_ms"] += count * old_ms
            sums["new_ms"] += count * new_ms
            sums[f"{kind}_old_ms"] += count * old_ms
            sums[f"{kind}_new_ms"] += count * new_ms
            row = dict(kind=kind, cin=cin, cout=cout, kernel=k, stride=s, hw=[h, w],
                       count=count, old_new_new_old_ms=times, old_ms=old_ms,
                       new_ms=new_ms, speedup=old_ms / new_ms, plan=plan._asdict())
            if args.sweep:
                row["sweep_ms"] = sweep(new, dw, xq, wl, cout, amax, s_w, bvec, s, k, dt,
                                        want, args.iters)
            rows.append(row)
        print(json.dumps({"batch": b, "dtype": "float32", "per_unet_call": sums,
                          "speedup": sums["old_ms"] / sums["new_ms"], "classes": rows}),
              flush=True)
    print(json.dumps({"device": smi.splitlines()[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
