#!/usr/bin/env python
"""How cuDNN runs the small UNet's widest 3×3 convolution, and what it holds.

    python scripts/torch_port_conv_workspace.py [--sweep]

``upsamplers.1.conv`` of the small UNet at 256² (128 → 128 channels, 3×3,
padding 1, on the 128² output of the bilinear ×2) is where a served batch of
8 reaches its memory peak. For float32 and bfloat16, batch 1 and 8, and each
way of running it below, one JSON line: the memory the call holds beyond its
input, weights and output (cuDNN's workspace), its time by CUDA events, the
device kernels it runs (from ``torch.profiler``) and its largest difference
from float64 over the float32/bf16 input values. The ways:

- ``default``: ``F.conv2d`` as the model calls it (cuDNN's heuristics);
- ``channels_last``: input and weight in channels-last memory, the output
  made contiguous again (cuDNN's NHWC kernels);
- ``cudnn_off``: PyTorch's own convolution (``torch.backends.cudnn.flags(
  enabled=False)``);
- ``wscap``: the default call in a child process started with
  ``CUDNN_CONV_WSCAP_DBG`` (cuDNN's workspace cap, MiB) set.

With ``--sweep``: each of the three upsample convolutions of the small UNet
at 256² (``upsamplers.0``-``.2``: their channels and output sizes from the
model), float32 and bf16, batches 1 to 8, ``default`` against
``cudnn_off``: which batches cuDNN runs as an FFT, and what that holds and
costs beside PyTorch's own convolution.

Needs a CUDA device; prints the card and its power limit first.
"""

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

SHAPE = (128, 128, 128)            # channels, height, width at upsamplers.1
WSCAP_MIB = os.environ.get("CUDNN_CONV_WSCAP_DBG")


def run(mode: str, dtype: torch.dtype, batch: int, shape=SHAPE, iters: int = 20) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c, h, w = shape
    x = torch.randn((batch, c, h, w), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((c, c, 3, 3), generator=gen, device=dev) / 34).to(dtype)
    bias = torch.randn((c,), generator=gen, device=dev).to(dtype)

    def call():
        if mode == "channels_last":
            y = F.conv2d(x.to(memory_format=torch.channels_last),
                         wt.to(memory_format=torch.channels_last), bias, padding=1)
            return y.contiguous()
        if mode == "cudnn_off":
            with torch.backends.cudnn.flags(enabled=False):
                return F.conv2d(x, wt, bias, padding=1)
        return F.conv2d(x, wt, bias, padding=1)

    y = call()
    torch.cuda.synchronize()
    ref = F.conv2d(x.double(), wt.double(), bias.double(), padding=1)
    err = float((y.double() - ref).abs().max())
    del y, ref
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = call()
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()
    for _ in range(3):
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sorted({e.name[:80] for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA})
    return dict(mode=mode if not WSCAP_MIB else f"wscap{WSCAP_MIB}",
                dtype=str(dtype).replace("torch.", ""), batch=batch, shape=list(shape),
                fft=any("fft" in k.lower() for k in kernels),
                held_bytes=held, ms=start.elapsed_time(end) / iters,
                max_abs_err_vs_float64=err, kernels=kernels)


def upsample_shapes():
    """(name, (channels, height, width) of the conv's input) of each
    ``Upsample`` of the small UNet at 256²."""
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.models.diffusion import LowLightDiffusion

    size = 256
    ups = LowLightDiffusion(diffusion_config("small", size)).unet.upsamplers
    return [(f"upsamplers.{i}", (up.conv.in_channels,) + (2 * size // 2 ** (len(ups) - i),) * 2)
            for i, up in enumerate(ups)]


def sweep() -> None:
    for name, shape in upsample_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            for batch in range(1, 9):
                for mode in ("default", "cudnn_off"):
                    print(json.dumps(dict(block=name, **run(mode, dtype, batch, shape, 10))),
                          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--sweep" in sys.argv[1:]:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            "torch": torch.__version__, "cudnn": torch.backends.cudnn.version()}), flush=True)
        sweep()
        return 0
    modes = ("default",) if WSCAP_MIB else ("default", "channels_last", "cudnn_off")
    if not WSCAP_MIB:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                          "torch": torch.__version__,
                          "cudnn": torch.backends.cudnn.version()}), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 8):
            for mode in modes:
                print(json.dumps(run(mode, dtype, batch)), flush=True)
    if not WSCAP_MIB:
        for cap in ("256", "1024"):
            subprocess.run([sys.executable, __file__],
                           env=dict(os.environ, CUDNN_CONV_WSCAP_DBG=cap), check=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), file=sys.stderr)
    sys.exit(rc)
