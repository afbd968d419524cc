#!/usr/bin/env python
"""Which operation makes two identical train steps' gradients differ on the card.

    python scripts/torch_port_grad_determinism.py [--runs 4] [--size 256]

Builds the small UNet (seed-0 weights, v-prediction) at ``--size``, float32
and bf16 compute, and computes the gradients of one batch of 8 ``--runs``
times from the same weights, batch, t, ε and dropout generator, with cuDNN
pinned (``deterministic=True``, ``benchmark=False``). Per dtype, one JSON
line: how many different gradient outcomes the runs gave, each run's
distance from the first (‖Δg‖ / ‖g‖ over every parameter), and, for the
first run that differs, the first tensors in backward order whose gradient
differs (hooks on every module's input and output record the gradient each
receives, in the order the backward reaches them; the operation that
differs lies between the last equal tensor and the first different one).
Then the same runs with ``torch.use_deterministic_algorithms(True,
warn_only=True)``: the operations PyTorch itself reports as having no
deterministic implementation. Then the same runs with every ``Upsample``'s
bilinear ×2 written as slices, concatenations and fixed weights, whose
backward adds without atomics: if the outcomes become one, that resize's
backward was the cause.

Needs a CUDA device; prints the card and its power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# the repository's root in place of scripts/, whose profile.py would shadow
# the standard module that torch imports
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from cv_diffusion_tpu_torch.config import diffusion_config  # noqa: E402
from cv_diffusion_tpu_torch.device import pin_fp32  # noqa: E402
from cv_diffusion_tpu_torch.models import blocks  # noqa: E402
from cv_diffusion_tpu_torch.models.diffusion import (create_model,  # noqa: E402
                                                     diffusion_loss,
                                                     train_forward)
from cv_diffusion_tpu_torch.ops import upcast  # noqa: E402
from cv_diffusion_tpu_torch.weights import init_weights  # noqa: E402


def resize2x_by_slices(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 with half-pixel centres (``align_corners=False``), edges
    clamped: output 2i is ¾·x[i] + ¼·x[i−1], output 2i+1 is ¾·x[i] +
    ¼·x[i+1], along H then W. Its backward is slices and adds, no atomics."""
    for dim in (2, 3):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        even, odd = 0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt
        x = torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)
    return x


def upsample_by_slices(self, x):
    up = resize2x_by_slices(upcast(x)).to(x.dtype)
    return self.conv(up)


def digest(g: torch.Tensor) -> int:
    """An integer digest of a tensor's bits, on its device (wrapping int64
    arithmetic, so it is exact and the same for the same bits)."""
    bits = g.detach().contiguous().view({4: torch.int32, 2: torch.int16}[g.element_size()])
    pos = torch.arange(bits.numel(), device=g.device) % 1000003 + 1
    return int((bits.flatten().long() * pos).sum())


def gradients(model, schedule, batch, record=None):
    """One forward and backward; {name: grad} of every parameter. With
    ``record`` (a list), each module's input and output gradient as
    (tensor, digest) in the order the backward produces them."""
    hooks = []
    if record is not None:
        def tap(name):
            def hook(g):
                record.append((name, digest(g)))
            return hook

        for name, mod in model.named_modules():
            if not name or isinstance(mod, (torch.nn.Sequential, torch.nn.ModuleList)):
                continue

            def pre(m, args, name=name):
                if torch.is_tensor(args[0]) and args[0].requires_grad:
                    args[0].register_hook(tap(f"{name} (input)"))

            def post(m, args, out, name=name):
                if torch.is_tensor(out) and out.requires_grad:
                    out.register_hook(tap(f"{name} (output)"))
            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    out = train_forward(model, schedule, batch[0], batch[1],
                        generator=torch.Generator(device=dev).manual_seed(0))
    diffusion_loss(out["noise_pred"], out["target"]).backward()
    for h in hooks:
        h.remove()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def distance(a, b) -> float:
    num = sum(float((a[n] - b[n]).double().square().sum()) for n in a)
    return (num / sum(float(t.double().square().sum()) for t in b.values())) ** 0.5


def probe(dtype: str, size: int, runs: int, variant: str, dev: torch.device,
          unet: str = "small") -> dict:
    cfg = diffusion_config(unet, size, prediction_type="v_prediction", dtype=dtype)
    model, schedule = create_model(cfg, device=dev)
    model.load_state_dict(init_weights(cfg, seed=0, device=dev), strict=True)
    model.train()
    rng = np.random.default_rng(0)
    batch = [torch.from_numpy(rng.uniform(-1, 1, (8, size, size, 3)).astype(np.float32)).to(dev)
             for _ in range(2)]
    records = [[] for _ in range(runs)]
    reported = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if variant == "warn_only":
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads = [gradients(model, schedule, batch, records[i]) for i in range(runs)]
        finally:
            torch.use_deterministic_algorithms(False)
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            reported.append(text.split(". ")[0][:160])
    outcomes = []
    for g in grads:
        if not any(all(torch.equal(g[n], o[n]) for n in g) for o in outcomes):
            outcomes.append(g)
    row = dict(dtype=dtype, variant=variant, size=size, batch=8, runs=runs,
               outcomes=len(outcomes), vs_first=[distance(g, grads[0]) for g in grads],
               tensors_differ=[sum(not torch.equal(g[n], grads[0][n]) for n in g)
                               for g in grads],
               nondeterministic_ops_reported=sorted(set(reported)))
    diff = next((i for i, g in enumerate(grads)
                 if any(not torch.equal(g[n], grads[0][n]) for n in g)), None)
    if diff is not None:
        a, b = records[0], records[diff]
        first = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if first is not None:
            row["last_equal"] = [n for n, _ in a[max(0, first - 3):first]]
            row["first_different"] = [n for (n, da), (_, db) in zip(a[first:first + 6],
                                                                     b[first:first + 6])
                                      if da != db][:3]
            row["hooked_tensors"] = len(a)
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--unet", default="small")
    p.add_argument("--device", default="cuda", help="cpu: a quick run of the logic")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if dev.type == "cuda":
        pin_fp32()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                          "torch": torch.__version__}), flush=True)
    for variant in ("as_is", "warn_only", "upsample_by_slices"):
        if variant == "upsample_by_slices":
            blocks.Upsample.forward = upsample_by_slices
        for dtype in ("float32", "bfloat16"):
            print(json.dumps(probe(dtype, args.size, args.runs, variant, dev, args.unet)),
                  flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), file=sys.stderr)
    sys.exit(rc)
