#!/usr/bin/env python
"""The JAX package's quality numbers on the port's evaluation inputs.

    python scripts/torch_port_eval_reference.py [--artifact vreg1b_gt03_ema]
        [--n 15] [--size 256] [--seed 0] [--quantize bf16|int8]
        [--dtype bfloat16 [--use_pallas_irb]]

Runs the JAX package's ``enhance`` (``cv_diffusion_tpu/models/diffusion.py``)
on the orbax weights of ``artifacts/<artifact>`` over the inputs and noise
that ``python -m cv_diffusion_tpu_torch.evaluate`` uses (the synthetic
validation split made in memory, ``NOISE_RECIPE``), computes the JAX
package's metrics per image as ``scripts/evaluate.py:136-150`` does, and
writes:

- ``artifacts_torch/<artifact>.eval_ref.json``: per image the five metrics
  and the SHA-256 of its low, high and noise arrays; the means; the grid;
- ``artifacts_torch/<artifact>.eval_ref_u8.npz``: the uint8 outputs
  (``clip(pred·255)``) of images 0 and 1 (``pred_u8`` [2, S, S, 3]).

The model runs as its ``model_config.json`` says (float32; linear attention
through XLA, which computes what the Pallas kernel does). With
``--quantize bf16`` or ``int8`` the weights go through the JAX package's own
serving package instead: ``create_serving_package(quantize=…)`` into a
temporary directory and ``load_serving_package`` back (bf16 params served
as they are, int8 dequantized; linear attention through the Pallas kernel,
in interpret mode on the CPU), and only
``artifacts_torch/<artifact>.eval_ref_<codec>.json`` is written (no uint8
outputs). Needs the JAX stack and orbax; ``chip_smoke.py`` holds the card's
numbers against these files.

With ``--dtype bfloat16`` the model computes in bf16 (its
``model_config.json`` with ``unet.dtype = "bfloat16"``: float32 weights cast
at each use, as ``train_model`` builds a ``use_amp`` model), on the float32
weights, and only ``artifacts_torch/<artifact>.eval_ref_bf16compute.json``
is written; with ``--use_pallas_irb`` as well, every stride-1 IRB runs
through the JAX package's ``fused_irb_v2`` (interpret mode on the CPU), into
``….eval_ref_bf16compute_fused.json``. The bf16 sampler is compiled with
XLA's ``xla_allow_excess_precision`` off: on by default, it lets XLA's CPU
compiler drop a cast to bf16 whose value feeds a float32 computation (a
convolution's input or output, a GroupNorm's output), so the reference
would skip roundings the model's code writes; off, every cast rounds, as
on an accelerator that takes bf16 operands. On the committed student the
flag alone moves JAX's own per-image PSNR by up to 0.145 dB.
"""

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

U8_IMAGES = (0, 1)


def reference(artifact: str, n: int, size: int, seed: int,
              quantize: Optional[str] = None, dtype: str = "float32",
              use_pallas_irb: bool = False):
    import dataclasses
    import tempfile

    import jax
    import jax.numpy as jnp

    from cv_diffusion_tpu.config import DiffusionConfig, from_dict
    from cv_diffusion_tpu.data.augment import normalize
    from cv_diffusion_tpu.export.serving import (create_serving_package,
                                                 load_serving_package)
    from cv_diffusion_tpu.models.diffusion import (create_model,
                                                   denormalize_image, enhance)
    from cv_diffusion_tpu.training.checkpoint import load_inference_params
    from cv_diffusion_tpu.training.metrics import gmsd, mae, ms_ssim, psnr, ssim
    from cv_diffusion_tpu_torch.evaluate import (BATCH_SIZE, MS_SSIM_MIN_SIZE,
                                                 NOISE_RECIPE, eval_noise,
                                                 eval_split, input_hashes)

    path = os.path.join(REPO, "artifacts", artifact)
    with open(os.path.join(path, "model_config.json")) as f:
        cfg = from_dict(DiffusionConfig, json.load(f))
    with open(os.path.join(path, "student_timesteps.json")) as f:
        grid = [int(t) for t in json.load(f)["timesteps"]]
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, dtype=dtype, use_pallas_irb=use_pallas_irb))
    model, schedule = create_model(cfg)
    variables = {"params": load_inference_params(path, verbose=False)}
    if quantize:
        with tempfile.TemporaryDirectory() as tmp:
            create_serving_package(tmp, model, schedule, variables["params"],
                                   quantize=quantize, timesteps=grid)
            model, schedule, params, meta = load_serving_package(tmp)
        if meta["quantization"] != quantize:
            raise ValueError(f"package codec {meta['quantization']!r}, "
                             f"not {quantize!r}")
        variables = {"params": params}
    low, high = eval_split(n, size, seed)
    init, step = eval_noise(n, size, seed, len(grid))
    with_perceptual = size >= MS_SSIM_MIN_SIZE

    enh = jax.jit(lambda v, x, i, s: enhance(
        model, schedule, v, jax.random.key(0), x, init_noise=i, step_noise=s,
        timesteps=grid))

    @jax.jit
    def metrics_fn(out, target):
        pred = jnp.clip(denormalize_image(out.astype(jnp.float32)), 0.0, 1.0)
        tgt = denormalize_image(target.astype(jnp.float32))

        def one_img(p, t):
            ms = (ms_ssim(p[None], t[None]) if with_perceptual
                  else jnp.zeros(()))
            return (psnr(p[None], t[None]), ssim(p[None], t[None]),
                    mae(p[None], t[None]), ms, gmsd(p[None], t[None]))

        m = jax.vmap(one_img)(pred, tgt)
        return m, jnp.clip(pred * 255.0, 0, 255).astype(jnp.uint8)

    options = ({} if dtype == "float32"
               else {"xla_allow_excess_precision": False})
    rows, u8 = [], []
    for s in range(0, n, BATCH_SIZE):
        sl = slice(s, s + BATCH_SIZE)
        args = (variables, jnp.asarray(normalize(low[sl])),
                jnp.asarray(init[sl]), jnp.asarray(step[:, sl]))
        out = enh.lower(*args).compile(options)(*args)
        m, pred_u8 = metrics_fn(out, jnp.asarray(normalize(high[sl])))
        m = [np.asarray(v) for v in m]
        for i in range(len(m[0])):
            rows.append({"psnr": float(m[0][i]), "ssim": float(m[1][i]),
                         "mae": float(m[2][i]),
                         "ms_ssim": float(m[3][i]) if with_perceptual else None,
                         "gmsd": float(m[4][i])})
        u8.append(np.asarray(pred_u8))
    u8 = np.concatenate(u8)
    hashes = input_hashes(low, high, init)
    images = [dict(file=f"{i:05d}.png", **row, low_sha256=h["low"],
                   high_sha256=h["high"], noise_sha256=h["noise"])
              for i, (row, h) in enumerate(zip(rows, hashes))]
    means = {f"{k}_mean": (None if rows[0][k] is None
                           else float(np.mean([r[k] for r in rows])))
             for k in ("psnr", "ssim", "mae", "ms_ssim", "gmsd")}
    payload = {"artifact": artifact, "timesteps": grid, "n": n, "size": size,
               "seed": seed, "split": f"make_split({n}, {size}, {seed} + 77)",
               "noise": NOISE_RECIPE, "batch_size": BATCH_SIZE,
               "reference": f"cv_diffusion_tpu enhance + training.metrics, "
                            f"jax {jax.__version__}, {jax.default_backend()}",
               "u8_images": [] if quantize or dtype != "float32" else list(U8_IMAGES),
               "summary": means, "images": images}
    if quantize:
        payload["quantization"] = quantize
        payload["package"] = ("cv_diffusion_tpu create_serving_package + "
                              "load_serving_package")
    if dtype != "float32":
        payload["dtype"] = dtype
        payload["xla_allow_excess_precision"] = False
    if use_pallas_irb:
        payload["use_pallas_irb"] = True
    return payload, u8[list(U8_IMAGES)]


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    p.add_argument("--n", type=int, default=15)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", choices=("bf16", "int8"), default=None,
                   help="serve the JAX package's own serving package of "
                        "this codec")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the UNet's compute dtype (float32 weights either way)")
    p.add_argument("--use_pallas_irb", action="store_true",
                   help="with --dtype bfloat16: every stride-1 IRB through "
                        "fused_irb_v2")
    args = p.parse_args()
    if args.quantize and args.dtype != "float32":
        p.error("--quantize and --dtype bfloat16 are separate references")
    if args.use_pallas_irb and args.dtype == "float32":
        p.error("--use_pallas_irb is a reference of bf16 compute")
    payload, u8 = reference(args.artifact, args.n, args.size, args.seed,
                            args.quantize, args.dtype, args.use_pallas_irb)
    out = os.path.join(REPO, "artifacts_torch", args.artifact)
    suffix = (f"_{args.quantize}" if args.quantize
              else "_bf16compute" if args.dtype == "bfloat16" else "")
    suffix += "_fused" if args.use_pallas_irb else ""
    with open(out + f".eval_ref{suffix}.json", "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    if not suffix:
        np.savez_compressed(out + ".eval_ref_u8.npz", pred_u8=u8)
    print(json.dumps(payload["summary"]))


if __name__ == "__main__":
    main()
