#!/usr/bin/env python
"""What the bf16 SiLU's four rounded steps cost the served UNet on the card.

    python scripts/torch_port_silu_cost.py [--artifact vreg1b_gt03_ema]

In bf16 compute ``models/blocks.py::silu`` runs x·(1/(1 + e^−x)) as four
operations, each rounded to bf16, as the JAX package's ``jax.nn.silu`` is
computed when every cast rounds; ``F.silu`` is one operation that rounds
once. The committed student (ReLU6 blocks) runs SiLU on the timestep
embedding, once in ``time_mlp`` and once in every block's FiLM MLP, and once
in the final head at full resolution. For batch 1 and 8 at 256², one JSON
line per way: the UNet call's time replayed from a CUDA graph (CUDA events,
the median of 5 rounds of 20 replays, in the order four steps, one step, one
step, four steps) and the device kernels one replay runs (``torch.profiler``).

Needs a CUDA device; prints the card and its power limit first.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# the repository's root in place of scripts/, whose profile.py would shadow
# the standard module that torch imports
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from cv_diffusion_tpu_torch.export.serving import ServingPipeline  # noqa: E402
from cv_diffusion_tpu_torch.models import blocks, unet  # noqa: E402
from cv_diffusion_tpu_torch.models.diffusion import with_dtype  # noqa: E402

FOUR_STEPS = blocks.silu


def one_step(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def use(silu) -> None:
    blocks.silu = unet.silu = silu


def graph_of(model, batch: int, size: int):
    """(graph, its output, its inputs) of one UNet call; the inputs are
    returned so that their memory lives as long as the graph."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, 6, size, size), generator=gen, device=dev).to(torch.bfloat16)
    t = torch.full((batch,), 739, device=dev, dtype=torch.long)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.inference_mode():
        for _ in range(3):
            model.unet(x, t)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g), torch.inference_mode():
        out = model.unet(x, t)
    return g, out, (x, t)


def replay_ms(g, iters: int = 20) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    g.replay()
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernels_per_replay(g) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "torch": torch.__version__}), flush=True)
    base = ServingPipeline.from_artifact(args.artifact, dev)
    model = with_dtype(base.model, "bfloat16")
    for batch in (1, 8):
        graphs = {}
        for name, fn in (("four_steps", FOUR_STEPS), ("one_step", one_step)):
            use(fn)
            graphs[name] = graph_of(model, batch, args.size)
        use(FOUR_STEPS)
        times = {name: [] for name in graphs}
        for _ in range(5):
            for name in ("four_steps", "one_step", "one_step", "four_steps"):
                times[name].append(replay_ms(graphs[name][0]))
        diff = float((graphs["four_steps"][1].float() - graphs["one_step"][1].float())
                     .abs().max())
        for name, (g, out, _) in graphs.items():
            print(json.dumps(dict(silu=name, batch=batch, size=args.size,
                                  unet_graph_ms=statistics.median(times[name]),
                                  unet_graph_ms_all=times[name],
                                  device_kernels_per_replay=kernels_per_replay(g),
                                  output_finite=bool(torch.isfinite(out).all()),
                                  max_abs_output_difference=diff)), flush=True)
        del graphs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), file=sys.stderr)
    sys.exit(rc)
