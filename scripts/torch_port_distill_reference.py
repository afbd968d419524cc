#!/usr/bin/env python
"""The JAX package's distillation losses and gradients on fixed inputs and
draws, for the port to be held to on the card.

    python scripts/torch_port_distill_reference.py [--artifact vreg1b_gt03_ema]

Runs the JAX package's own ``sampler_regression_loss`` and
``consistency_distillation_loss`` (``cv_diffusion_tpu/models/
distillation.py``) with ``jax.value_and_grad`` over the student, the orbax
weights of ``artifacts/<artifact>`` as teacher, student and EMA student,
at its own config (small@256, float32), on batch 2: the first two pairs of
the synthetic validation split (``evaluate.eval_split(15, 256, 0)``, held
by the SHA-256 of the eval phase's reference), in four settings:

- ``regression_739``: the 1-step recipe, grid [739], an 8-step stochastic
  teacher, ``gt_weight`` 0.3;
- ``regression_739_259_prefix``: grid [739, 259] with the stop-grad
  prefix, the same teacher and ``gt_weight``;
- ``canonical_stride1``: consistency, canonical pairs, ``pair_stride=1``;
- ``sampler_matched``: consistency over the 4-step sampler's own grid.

Every random draw is made with numpy, not by ``jax.random``: within the loss
the script replaces ``jax.random.normal`` and ``jax.random.randint`` by
functions that hand out the setting's draws in order (each checked against
the shape, and for ``randint`` the bounds, that the JAX code asks for; the
count checked at the end), and ``jax.vmap`` over a key array by a loop, so
that ``enhance``'s per-step noise gets one draw a step. ``jax.lax.scan``
(``enhance``'s loop over the grid, fully unrolled there) is replaced by the
Python loop it stands for: XLA's CPU backend runs the gradient of the
scanned UNet ~25× slower than the same operations unrolled (measured on the
small UNet at 64², 108 s against 4.4 s), which made one setting take most
of an hour. A setting's draws
come from ``np.random.default_rng([SEED, i])`` (i its index) in the order
its ``draws`` list gives: ``standard_normal(shape, dtype=float32)`` or
``integers(lo, hi, shape)`` (``chip_smoke.reference_draws``, which the card
run calls to make them again and check their SHA-256). Nothing of the JAX package is edited.

Writes ``artifacts_torch/<artifact>.distill_ref.json``: per setting its
arguments, draws, the loss, the gradient's global norm and the norms of
``GRAD_NAMES`` (the port's parameter names). Needs the JAX stack and orbax.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 14
BATCH, SIZE = 2, 256
GRAD_NAMES = ("unet.init_conv.weight", "unet.time_mlp.1.weight",
              "unet.encoder_blocks.0.0.expand.weight",
              "unet.encoder_blocks.3.1.project.weight",
              "unet.mid_attn.to_qkv.weight", "unet.mid_attn.to_out.0.weight",
              "unet.decoder_blocks.3.0.depthwise.weight",
              "unet.final_conv.weight")
IMG = [BATCH, SIZE, SIZE, 3]
SETTINGS = (
    ("regression_739", "regression",
     dict(teacher_steps=8, student_timesteps=[739], gt_weight=0.3),
     [["normal", IMG]] * 9 + [["normal", IMG]] * 2),
    ("regression_739_259_prefix", "regression",
     dict(teacher_steps=8, student_timesteps=[739, 259], gt_weight=0.3),
     [["normal", IMG]] * 9 + [["normal", IMG]] * 2),
    ("canonical_stride1", "consistency",
     dict(canonical=True, pair_stride=1),
     [["normal", IMG], ["randint", [BATCH], 1, 49]]),
    ("sampler_matched", "consistency",
     dict(sampler_matched=True),
     [["normal", IMG], ["randint", [BATCH], 0, 3], ["normal", IMG]]),
)


@contextlib.contextmanager
def numpy_draws(spec, draws):
    """``jax.random.normal``/``randint`` hand out ``draws`` in order (each
    checked against ``spec``), ``jax.vmap`` over a key array and
    ``jax.lax.scan`` loop."""
    import jax
    import jax.numpy as jnp

    queue = list(zip(spec, draws))
    real_vmap = jax.vmap

    def take(kind, shape, bounds=None):
        assert queue, f"more draws than the {len(spec)} expected"
        (want, draw) = queue.pop(0)
        assert want[0] == kind and tuple(want[1]) == tuple(shape), (want, kind, shape)
        if bounds is not None:
            assert tuple(want[2:]) == tuple(int(b) for b in bounds), (want, bounds)
        return draw

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(take("normal", shape), dtype)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(take("randint", shape, (minval, maxval)), dtype)

    def scan(f, init, xs, length=None, reverse=False, unroll=1, **kwargs):
        assert not reverse and not kwargs, (reverse, kwargs)
        n = length or jax.tree_util.tree_leaves(xs)[0].shape[0]
        carry, ys = init, []
        for i in range(n):
            carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
            ys.append(y)
        if ys[0] is None:
            return carry, None
        return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)

    def vmap(fn, *args, **kwargs):
        def looped(xs, *rest):
            if rest or not jax.dtypes.issubdtype(xs.dtype, jax.dtypes.prng_key):
                return real_vmap(fn, *args, **kwargs)(xs, *rest)
            return jnp.stack([fn(xs[i]) for i in range(xs.shape[0])])
        return looped

    saved = (jax.random.normal, jax.random.randint, jax.vmap, jax.lax.scan)
    jax.random.normal, jax.random.randint, jax.vmap, jax.lax.scan = (
        normal, randint, vmap, scan)
    try:
        yield
        assert not queue, f"{len(queue)} draws left unused"
    finally:
        jax.random.normal, jax.random.randint, jax.vmap, jax.lax.scan = saved


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="vreg1b_gt03_ema")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from cv_diffusion_tpu.config import DiffusionConfig, from_dict
    from cv_diffusion_tpu.data.augment import normalize
    from cv_diffusion_tpu.models import distillation as jdist
    from cv_diffusion_tpu.models.diffusion import create_model
    from cv_diffusion_tpu.training.checkpoint import load_inference_params
    from cv_diffusion_tpu_torch.config import load_model_config
    from chip_smoke import reference_draws
    from cv_diffusion_tpu_torch.evaluate import eval_split, sha256
    from cv_diffusion_tpu_torch.weights import state_dict_from_jax

    path = os.path.join(REPO, "artifacts", args.artifact)
    with open(os.path.join(path, "model_config.json")) as f:
        jcfg = from_dict(DiffusionConfig, json.load(f))
    tcfg = load_model_config(os.path.join(path, "model_config.json"))
    model, schedule = create_model(jcfg)
    params = load_inference_params(path, verbose=False)
    low_u8, high_u8 = (a[:BATCH] for a in eval_split(15, SIZE, 0))
    low, high = (jnp.asarray(normalize(a)) for a in (low_u8, high_u8))
    inputs = {"split": "evaluate.eval_split(15, 256, 0)[:2], normalised",
              "low_sha256": [sha256(a) for a in low_u8],
              "high_sha256": [sha256(a) for a in high_u8]}

    out = []
    for i, (name, kind, kw, spec) in enumerate(SETTINGS):
        draws = reference_draws(SEED, i, spec)
        hashes = [sha256(d) for d in draws]

        def loss_fn(student, teacher):
            if kind == "regression":
                return jdist.sampler_regression_loss(
                    model, schedule, teacher, student, jax.random.key(0), low,
                    high, teacher_steps=kw["teacher_steps"],
                    student_timesteps=tuple(kw["student_timesteps"]),
                    gt_weight=kw["gt_weight"])
            return jdist.consistency_distillation_loss(
                model, schedule, teacher, student, teacher, jax.random.key(0),
                low, high, **kw)

        with numpy_draws(spec, draws):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, params)
        grads = {k: v.numpy().astype(np.float64) for k, v in
                 state_dict_from_jax(jax.tree.map(np.asarray, grads), tcfg).items()}
        row = dict(name=name, kind=kind, args=kw, draws=spec,
                   draws_sha256=hashes, loss=float(loss),
                   grad_global_norm=float(np.sqrt(sum(np.square(g).sum()
                                                      for g in grads.values()))),
                   grad_norms={n: float(np.linalg.norm(grads[n])) for n in GRAD_NAMES})
        print(json.dumps({k: row[k] for k in ("name", "loss", "grad_global_norm")}),
              flush=True)
        out.append(row)

    ref = dict(artifact=args.artifact, seed=SEED, batch=BATCH, size=SIZE,
               inputs=inputs,
               draws_recipe="np.random.default_rng([seed, i]) for setting i; in "
                            "order: standard_normal(shape, dtype=float32) for "
                            "'normal', integers(lo, hi, shape) as int32 for "
                            "'randint'",
               weights="teacher = student = EMA student = the artifact's",
               reference=f"cv_diffusion_tpu distillation losses, jax "
                         f"{jax.__version__}, cpu, float32",
               settings=out)
    dest = os.path.join(REPO, "artifacts_torch", f"{args.artifact}.distill_ref.json")
    with open(dest, "w") as f:
        json.dump(ref, f, indent=1)
    print(dest, os.path.getsize(dest), "bytes")


if __name__ == "__main__":
    main()
