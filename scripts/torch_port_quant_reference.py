#!/usr/bin/env python
"""The JAX package's int8 activation path and QAT on fixed inputs and draws,
for the port to be held to on the card.

    python scripts/torch_port_quant_reference.py [--artifact vreg1b_gt03_ema]
        [--part int8_act|qat|both]

On the orbax weights of ``artifacts/<artifact>`` at its own config
(small@256, float32), with the JAX package's own functions; every random
draw is made with numpy (``chip_smoke.reference_draws``: setting or batch i
draws from ``np.random.default_rng([seed, i])``), so the card run makes them
again and checks their SHA-256. Writes, each a few kilobytes:

- ``artifacts_torch/<artifact>.int8act_ref.json``: the PTQ calibration of
  the ``act_quant=True`` model on ``CALIB_BATCHES`` batches of 8 pairs of
  the synthetic split ``data.synthetic.make_split(32, 256, CALIB_SEED)``,
  each batch noised at t ~ U[0, 1000) with ε ~ N(0, 1) (numpy, batch i
  from ``[CALIB_DRAW_SEED, i]``), the loop of ``export.quantization.
  calibrate_act_scales`` with these draws in place of ``jax.random``'s:
  every ``QConv``'s amax, by the port's module name and JAX path; then
  JAX's ``int8_act`` package of those scales (``create_serving_package`` +
  ``load_serving_package``: bf16 weights, int8 compute) on the 15 pairs and
  noise of the eval phase (``evaluate.eval_split``/``eval_noise``), the five
  metrics per image.
- ``artifacts_torch/<artifact>.qat_ref.json``: one QAT loss and gradient
  (``jax.value_and_grad`` of ``train_forward`` + ``diffusion_loss`` over
  ``export.qat.fake_quant_params`` of the weights, the loss of
  ``make_qat_train_step``) at batch 2 (the eval split's first two pairs,
  t and ε one numpy draw from ``[QAT_SEED, 0]``) in three settings: ``qat``
  (the float model), ``qat_act`` (``unet.act_quant="fake"``) and, for the
  record, ``float`` (no fake-quant, the plain step): the loss, the
  gradient's global norm and the norms of ``GRAD_NAMES``.

XLA's CPU backend runs the int8 depthwise convolution at ~0.04 G
operations/s (one of the student's at 256², batch 8: 31 s), which would
keep the int8_act part for hours: inside the script the depthwise int8
convolutions (``feature_group_count > 1``, int8 operands, int32 result) are
computed as the float32 convolution of the same int8 values, cast to int32.
That is exact: a 3×3 depthwise sum has 9 products of at most 127², every
partial sum an integer below 2²⁴ (``exact_int8_depthwise``). Nothing of
the JAX package is edited. Needs the JAX stack and orbax (~10 GB and ~15
minutes on a CPU).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SIZE = 256
CALIB_SEED, CALIB_DRAW_SEED = 151, 152
CALIB_BATCHES, CALIB_BATCH = 4, 8
QAT_SEED, QAT_BATCH = 153, 2
GRAD_NAMES = ("unet.init_conv.weight", "unet.time_mlp.1.weight",
              "unet.encoder_blocks.0.0.expand.weight",
              "unet.encoder_blocks.3.1.project.weight",
              "unet.mid_attn.to_qkv.weight", "unet.mid_attn.to_out.0.weight",
              "unet.decoder_blocks.3.0.depthwise.weight",
              "unet.final_conv.weight")
QAT_SETTINGS = (("qat", False), ("qat_act", "fake"), ("float", False))


def calib_spec(batch=CALIB_BATCH, size=SIZE):
    return [["randint", [batch], 0, 1000], ["normal", [batch, size, size, 3]]]


def qat_spec(batch=QAT_BATCH, size=SIZE):
    return [["randint", [batch], 0, 1000], ["normal", [batch, size, size, 3]]]


def _load(artifact):
    from cv_diffusion_tpu.config import DiffusionConfig, from_dict
    from cv_diffusion_tpu.training.checkpoint import load_inference_params
    from cv_diffusion_tpu_torch.config import load_model_config

    path = os.path.join(REPO, "artifacts", artifact)
    with open(os.path.join(path, "model_config.json")) as f:
        jcfg = from_dict(DiffusionConfig, json.load(f))
    with open(os.path.join(path, "student_timesteps.json")) as f:
        grid = [int(t) for t in json.load(f)["timesteps"]]
    tcfg = load_model_config(os.path.join(path, "model_config.json"))
    return jcfg, tcfg, grid, load_inference_params(path, verbose=False)


@contextlib.contextmanager
def exact_int8_depthwise():
    """``jax.lax.conv_general_dilated`` of int8 depthwise operands with an
    int32 result computed as the float32 convolution of the same values:
    exact while every partial sum stays below 2**24, which the check on
    the kernel's size guarantees (|sum| ≤ taps · 127²)."""
    import jax
    import jax.numpy as jnp

    real = jax.lax.conv_general_dilated

    def conv(lhs, rhs, *args, feature_group_count=1, preferred_element_type=None,
             **kwargs):
        if (feature_group_count > 1 and lhs.dtype == jnp.int8
                and preferred_element_type == jnp.int32):
            taps = int(np.prod(rhs.shape)) // rhs.shape[-1]
            assert taps * 127 ** 2 < 2 ** 24, rhs.shape
            out = real(lhs.astype(jnp.float32), rhs.astype(jnp.float32), *args,
                       feature_group_count=feature_group_count, **kwargs)
            return out.astype(jnp.int32)
        return real(lhs, rhs, *args, feature_group_count=feature_group_count,
                    preferred_element_type=preferred_element_type, **kwargs)

    jax.lax.conv_general_dilated = conv
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = real


def int8_act_reference(artifact):
    import jax
    import jax.numpy as jnp

    from chip_smoke import reference_draws
    from cv_diffusion_tpu.data.augment import normalize
    from cv_diffusion_tpu.export.serving import (create_serving_package,
                                                 load_serving_package)
    from cv_diffusion_tpu.models.diffusion import (LowLightDiffusion, create_model,
                                                   denormalize_image, enhance)
    from cv_diffusion_tpu.models.scheduler import add_noise
    from cv_diffusion_tpu.training.metrics import gmsd, mae, ms_ssim, psnr, ssim
    from cv_diffusion_tpu_torch.data.synthetic import make_split
    from cv_diffusion_tpu_torch.evaluate import (BATCH_SIZE, eval_noise, eval_split,
                                                 input_hashes, sha256)
    from cv_diffusion_tpu_torch.weights import jax_paths, model_entries

    jcfg, tcfg, grid, params = _load(artifact)
    model, schedule = create_model(jcfg)
    qcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, act_quant=True))
    qmodel = LowLightDiffusion(qcfg)

    low_u8, high_u8 = make_split(CALIB_BATCHES * CALIB_BATCH, SIZE, CALIB_SEED)

    @jax.jit
    def calib_step(variables, low, high, t, noise):
        noisy = add_noise(schedule, high, noise, t)
        _, mutated = qmodel.apply(variables, noisy, low, t, train=False,
                                  mutable=["act_scales"])
        return mutated["act_scales"]

    scales, draw_hashes = None, []
    for i in range(CALIB_BATCHES):
        t, noise = reference_draws(CALIB_DRAW_SEED, i, calib_spec())
        draw_hashes.append([sha256(t), sha256(noise)])
        sl = slice(i * CALIB_BATCH, (i + 1) * CALIB_BATCH)
        variables = {"params": params}
        if scales is not None:
            variables["act_scales"] = scales
        scales = calib_step(variables, jnp.asarray(normalize(low_u8[sl])),
                            jnp.asarray(normalize(high_u8[sl])), jnp.asarray(t),
                            jnp.asarray(noise))
    flat = jax.tree_util.tree_flatten_with_path(scales)[0]
    by_path = {tuple(str(getattr(k, "key", k)) for k in p): float(v) for p, v in flat}
    # the port's module names: each QConv's kernel path without "kernel"
    kernels = {path[:-1]: name[:-len(".weight")] for name, path in
               jax_paths(tcfg, [n for n, _, _, _ in model_entries(tcfg)]).items()
               if path[-1] == "kernel"}
    rows = [{"module": kernels[path[:-1]], "jax_path": "/".join(path), "amax": amax}
            for path, amax in sorted(by_path.items())]

    n = 15
    low, high = eval_split(n, SIZE, 0)
    init, step = eval_noise(n, SIZE, 0, len(grid))
    with tempfile.TemporaryDirectory() as tmp:
        create_serving_package(tmp, model, schedule, params, quantize="int8_act",
                               act_scales=scales, timesteps=grid)
        pkg_model, pkg_schedule, pkg_vars, meta = load_serving_package(tmp)
    assert meta["quantization"] == "int8_act" and pkg_model.config.unet.act_quant

    enh = jax.jit(lambda v, x, i, s: enhance(
        pkg_model, pkg_schedule, v, jax.random.key(0), x, init_noise=i,
        step_noise=s, timesteps=grid))

    @jax.jit
    def metrics_fn(out, target):
        pred = jnp.clip(denormalize_image(out.astype(jnp.float32)), 0.0, 1.0)
        tgt = denormalize_image(target.astype(jnp.float32))

        def one(p, t):
            return (psnr(p[None], t[None]), ssim(p[None], t[None]),
                    mae(p[None], t[None]), ms_ssim(p[None], t[None]),
                    gmsd(p[None], t[None]))
        return jax.vmap(one)(pred, tgt)

    images = []
    hashes = input_hashes(low, high, init)
    for s in range(0, n, BATCH_SIZE):
        sl = slice(s, s + BATCH_SIZE)
        out = enh(pkg_vars, jnp.asarray(normalize(low[sl])), jnp.asarray(init[sl]),
                  jnp.asarray(step[:, sl]))
        m = [np.asarray(v) for v in metrics_fn(out, jnp.asarray(normalize(high[sl])))]
        for i in range(len(m[0])):
            images.append(dict(zip(("psnr", "ssim", "mae", "ms_ssim", "gmsd"),
                                   (float(v[i]) for v in m))))
    for i, (row, h) in enumerate(zip(images, hashes)):
        row.update(low_sha256=h["low"], noise_sha256=h["noise"])
    return dict(
        artifact=artifact, size=SIZE, timesteps=grid,
        calibration=dict(split=f"data.synthetic.make_split({CALIB_BATCHES * CALIB_BATCH}, "
                               f"{SIZE}, {CALIB_SEED}), normalised, batches of "
                               f"{CALIB_BATCH} in order",
                         split_low_sha256=sha256(low_u8), split_high_sha256=sha256(high_u8),
                         draw_seed=CALIB_DRAW_SEED, draws=calib_spec(),
                         draws_sha256=draw_hashes, batches=CALIB_BATCHES),
        act_scales=rows,
        eval=dict(split="evaluate.eval_split(15, 256, 0)", noise="evaluate.eval_noise",
                  package="cv_diffusion_tpu create_serving_package(quantize='int8_act') "
                          "+ load_serving_package",
                  images=images,
                  psnr_mean=float(np.mean([r["psnr"] for r in images]))),
        reference=f"cv_diffusion_tpu act_quant model and int8_act package, jax "
                  f"{jax.__version__}, {jax.default_backend()}")


def qat_reference(artifact):
    import jax
    import jax.numpy as jnp

    from chip_smoke import reference_draws
    from cv_diffusion_tpu.data.augment import normalize
    from cv_diffusion_tpu.export.qat import fake_quant_params
    from cv_diffusion_tpu.models.diffusion import (create_model, diffusion_loss,
                                                   train_forward)
    from cv_diffusion_tpu_torch.evaluate import eval_split, sha256
    from cv_diffusion_tpu_torch.weights import state_dict_from_jax

    jcfg, tcfg, _, params = _load(artifact)
    low_u8, high_u8 = (a[:QAT_BATCH] for a in eval_split(15, SIZE, 0))
    low, high = (jnp.asarray(normalize(a)) for a in (low_u8, high_u8))
    out = []
    for i, (name, act_quant) in enumerate(QAT_SETTINGS):
        cfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet,
                                                                 act_quant=act_quant))
        model, schedule = create_model(cfg)
        t, noise = reference_draws(QAT_SEED, 0, qat_spec())

        def loss_fn(p):
            if name != "float":
                p = fake_quant_params(p)
            res = train_forward(model, schedule, {"params": p}, jax.random.key(0),
                                low, high, train=True, timesteps=jnp.asarray(t),
                                noise=jnp.asarray(noise))
            return diffusion_loss(res["noise_pred"], res["target"], "mse")

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        grads = {k: v.numpy().astype(np.float64) for k, v in
                 state_dict_from_jax(jax.tree.map(np.asarray, grads), tcfg).items()}
        row = dict(name=name, act_quant=act_quant, weights_fake_quant=name != "float",
                   draws=qat_spec(), draws_sha256=[sha256(t), sha256(noise)],
                   loss=float(loss),
                   grad_global_norm=float(np.sqrt(sum(np.square(g).sum()
                                                      for g in grads.values()))),
                   grad_norms={n: float(np.linalg.norm(grads[n])) for n in GRAD_NAMES})
        print(json.dumps({k: row[k] for k in ("name", "loss", "grad_global_norm")}),
              flush=True)
        out.append(row)
    return dict(artifact=artifact, seed=QAT_SEED, batch=QAT_BATCH, size=SIZE,
                inputs=dict(split="evaluate.eval_split(15, 256, 0)[:2], normalised",
                            low_sha256=[sha256(a) for a in low_u8],
                            high_sha256=[sha256(a) for a in high_u8]),
                draws_recipe="np.random.default_rng([seed, 0]) for every setting: "
                             "integers(0, 1000, [2]) as int32, then "
                             "standard_normal([2, 256, 256, 3], dtype=float32)",
                loss="train_forward(train=True, timesteps=t, noise=eps) + "
                     "diffusion_loss mse, over export.qat.fake_quant_params of the "
                     "weights (not for 'float')",
                reference=f"cv_diffusion_tpu, jax {jax.__version__}, cpu, float32",
                settings=out)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    p.add_argument("--part", choices=("int8_act", "qat", "both"), default="both")
    args = p.parse_args()
    parts = (("int8_act", int8_act_reference, "int8act_ref"),
             ("qat", qat_reference, "qat_ref"))
    for part, fn, suffix in parts:
        if args.part not in (part, "both"):
            continue
        with exact_int8_depthwise():
            ref = fn(args.artifact)
        dest = os.path.join(REPO, "artifacts_torch", f"{args.artifact}.{suffix}.json")
        with open(dest, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(dest, os.path.getsize(dest), "bytes", flush=True)


if __name__ == "__main__":
    main()
