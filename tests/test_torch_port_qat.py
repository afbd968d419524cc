"""The port's quantization-aware training against the JAX package's, on the
CPU.

The tiny UNet cut to two levels at 16² (its IRBs with SE and skips,
attention at both levels and ``mid_attn``, Down/Upsample: every kind of
``QConv``), v-prediction, random weights, batch 2; t and ε are the port's
first step's draws (its state's generator), handed to JAX. (Two levels keep
JAX's two float64 gradient compiles of the fake-quant model short.)

- ``qat`` (weights fake-quantized in the forward, ``export.qat``) and
  ``qat_act`` (also every convolution's input, ``unet.act_quant="fake"``):
  the loss and the gradient of the raw parameters, through the transform,
  with both sides in float64 (the JAX package's float32 casts patched),
  equal to 1e-9 of the largest gradient entry: the same function and the
  same straight-through gradients, the scale's path and ``jnp.clip``'s
  half gradient at ±127 included.
- One whole float32 QAT step of each (``make_qat_train_step``: clip, AdamW,
  EMA) held by the change it makes to the parameters against JAX's float64
  step's change. AdamW's first step is ±lr·sign(g) wherever |g| ≫ eps, so
  float32 flips the sign of near-zero gradients, and fake-quant flips some
  roundings, as in the distillation steps (``test_torch_port_distillation_
  steps.py``): the bound is on the norm of the difference relative to the
  norm of the change.
- ``qat_act`` on a model without ``act_quant="fake"`` raises (the JAX
  trainer silently trains weight-only QAT there), and the train CLI with
  ``--qat_act`` trains.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cv_diffusion_tpu.export import qat as jqat
from cv_diffusion_tpu.export import quantization as jquant
from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.training import train_state as jts
from cv_diffusion_tpu_torch.export import qat as tqat
from cv_diffusion_tpu_torch.models.diffusion import diffusion_loss, train_forward
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.training.trainer import Trainer

from cv_diffusion_tpu_torch.models.diffusion import sample_timesteps_and_noise
from test_torch_port_training import SPE, STEP_CFG, _cfgs, _flat_port
from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     port_model, random_jax_params)

SIZE = 16
LEVELS = (1, 2)
SETTINGS = {"qat": False, "qat_act": "fake"}
F64_TOL = 1e-9
# one float32 step against JAX's float64 step, per setting: (‖Δg‖ / ‖g‖ of
# the clipped gradients, ‖Δθ_port − Δθ_jax‖ / ‖Δθ_jax‖ of the parameters'
# change). Measured: qat 8.8e-6 and 9.9e-4; qat_act 2.6e-2 and 0.197, where
# float32 puts some convolution inputs on the other side of a rounding
# boundary of their fake-quant grid, and AdamW's first step, ±lr wherever
# |g| ≫ eps, then takes 0.97% of the parameters the other way (0.006% in
# qat); in float64 both settings equal JAX's (the test above).
STEP_TOL = {"qat": (1e-4, 1e-2), "qat_act": (5e-2, 0.3)}


def _with_act_quant(cfg, act_quant):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, act_quant=act_quant))


@pytest.fixture(scope="module")
def case():
    return random_jax_params("tiny", SIZE, seed=61, channel_multipliers=LEVELS)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("low_light", "normal_light")}


def _port_draws(tc, tcfg):
    """The t and ε of the port's first train step on a batch of 2 (a fresh
    state's generator is seeded with ``tc.seed``)."""
    gen = torch.Generator().manual_seed(tc.seed)
    t, eps = sample_timesteps_and_noise(make_schedule(tcfg.scheduler),
                                        (2, SIZE, SIZE, 3), gen, "cpu")
    return t.numpy().astype(np.int32), eps.numpy()


@pytest.fixture(scope="module")
def jax_qat(case):
    """Per setting, JAX's float64 QAT loss, gradients, gradient norm and the
    parameters after one step (clip + AdamW of ``make_optimizer``), on the
    port's first step's draws; in the port's names and layouts."""
    jcfg, tcfg, params = case
    jc, tc = _cfgs(**STEP_CFG)
    t, eps = _port_draws(tc, tcfg)
    batch = _batch(60)
    monkeypatch = pytest.MonkeyPatch()
    out = {}
    with jax_in_float64(monkeypatch, extra=(jdiffusion, jqat, jquant)):
        tx, _ = jts.make_optimizer(jc, SPE)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        for name, act_quant in SETTINGS.items():
            j64 = _with_act_quant(dataclasses.replace(jcfg, unet=dataclasses.replace(
                jcfg.unet, dtype="float64")), act_quant)
            jmodel, jschedule = jax_create_model(j64)

            def loss_fn(q):
                res = jdiffusion.train_forward(
                    jmodel, jschedule, {"params": jqat.fake_quant_params(q)},
                    jax.random.key(0), jnp.asarray(batch["low_light"], jnp.float64),
                    jnp.asarray(batch["normal_light"], jnp.float64),
                    timesteps=jnp.asarray(t), noise=jnp.asarray(eps, jnp.float64))
                return jdiffusion.diffusion_loss(res["noise_pred"], res["target"])

            @jax.jit
            def step(q):
                loss, grads = jax.value_and_grad(loss_fn)(q)
                updates, _ = tx.update(grads, tx.init(q), q)
                return loss, grads, optax.global_norm(grads), optax.apply_updates(q, updates)

            loss, grads, norm, new = step(p)
            assert loss.dtype == jnp.float64
            flat = lambda tree: _flat_port(jax.tree.map(np.asarray, tree),  # noqa: E731
                                           tcfg, monkeypatch)
            out[name] = dict(loss=float(loss), norm=float(norm), grads=flat(grads),
                             params=flat(new))
    monkeypatch.undo()
    return dict(t=t, eps=eps, batch=batch, steps=out)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_qat_loss_and_grads_match_jax_in_float64(case, jax_qat, name):
    _, tcfg, params = case
    model = port_model(_with_act_quant(tcfg, SETTINGS[name]), params).double()
    schedule = make_schedule(tcfg.scheduler)
    batch = jax_qat["batch"]
    q = tqat.fake_quant_params(dict(model.named_parameters()), model.config)
    out = train_forward(model, schedule, torch.from_numpy(batch["low_light"]).double(),
                        torch.from_numpy(batch["normal_light"]).double(),
                        timesteps=torch.from_numpy(jax_qat["t"]),
                        noise=torch.from_numpy(jax_qat["eps"]).double(), params=q)
    loss = diffusion_loss(out["noise_pred"], out["target"])
    loss.backward()
    ref = jax_qat["steps"][name]
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=F64_TOL, atol=0)
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][k], rtol=0,
                                   atol=F64_TOL * scale, err_msg=k)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_qat_step_matches_jax(case, jax_qat, name, tmp_path):
    """The float32 QAT step (``make_qat_train_step`` through the Trainer's
    choice of step) against JAX's float64 step: the loss (rtol 1e-3), the
    gradient norm before the clip (rtol 1e-2), the clipped gradients and the
    change of the parameters within STEP_TOL; the same step without the
    fake-quant (the plain step) moves the loss beyond the loss's bound."""
    _, tcfg, params = case
    _, tc = _cfgs(**STEP_CFG, qat=True, qat_act=name == "qat_act",
                  output_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    model = port_model(_with_act_quant(tcfg, SETTINGS[name]), params)
    schedule = make_schedule(tcfg.scheduler)
    trainer = Trainer(model, schedule, [None] * SPE, config=tc)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, metrics = trainer.train_step(trainer.state, jax_qat["batch"])
    ref = jax_qat["steps"][name]
    got = np.concatenate([(p.detach() - before[k]).numpy().ravel()
                          for k, p in model.named_parameters()])
    start = _flat_port(params, tcfg)
    want = np.concatenate([ref["params"][k].ravel() - start[k].ravel()
                           for k, _ in model.named_parameters()])
    clip = min(1.0, tc.gradient_clip / ref["norm"])
    g_got = np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])
    g_want = np.concatenate([ref["grads"][k].ravel() * clip for k, _ in model.named_parameters()])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-3)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["norm"], rtol=1e-2)
    grad_tol, step_tol = STEP_TOL[name]
    assert np.linalg.norm(g_got - g_want) <= grad_tol * np.linalg.norm(g_want)
    assert np.linalg.norm(got - want) <= step_tol * np.linalg.norm(want)
    plain = port_model(_with_act_quant(tcfg, False), params)
    pstate = tts.create_train_state(plain, tc, steps_per_epoch=SPE)
    _, pm = tts.make_train_step(plain, schedule, tc)(pstate, jax_qat["batch"])
    assert abs(float(pm["loss"]) / ref["loss"] - 1) > 1e-3


def test_qat_act_needs_a_fake_quant_model(case, tmp_path):
    """Where the JAX trainer quietly trains weight-only QAT on a model
    without ``act_quant="fake"`` (``trainer.py:122``), the port raises."""
    _, tcfg, params = case
    _, tc = _cfgs(**STEP_CFG, qat_act=True, output_dir=str(tmp_path),
                  checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="act_quant='fake'"):
        Trainer(port_model(tcfg, params), make_schedule(tcfg.scheduler), [None], config=tc)
    fake = port_model(_with_act_quant(tcfg, "fake"), params)
    trainer = Trainer(fake, make_schedule(tcfg.scheduler), [None], config=tc)
    assert trainer.state.step == 0


def test_identity_transform_is_the_plain_step(case):
    """``params_transform`` of the identity gives the plain step's loss and
    gradients bit for bit: the transform's path adds nothing but itself."""
    _, tcfg, params = case
    _, tc = _cfgs(**STEP_CFG)
    schedule = make_schedule(tcfg.scheduler)
    grads = []
    for transform in (None, lambda p: p):
        model = port_model(tcfg, params)
        state = tts.create_train_state(model, tc, steps_per_epoch=SPE)
        state, m = tts.make_train_step(model, schedule, tc, params_transform=transform)(
            state, _batch(62))
        grads.append((float(m["loss"]), [p.grad.clone() for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_train_cli_qat_act(tmp_path):
    """``python -m cv_diffusion_tpu_torch.train --qat_act`` on the CPU: one
    epoch of the tiny model with activation- and weight-fake-quant."""
    from cv_diffusion_tpu_torch import train as cli
    from cv_diffusion_tpu_torch.data import png

    rng = np.random.default_rng(63)
    for i in range(2):
        for sub in ("low", "high"):
            png.write_png(tmp_path / "lol" / sub / f"{i}.png",
                          rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
    cli.main(["--data_dir", str(tmp_path / "lol"), "--val_dir", "none",
              "--variant", "tiny", "--image_size", "32", "--epochs", "1",
              "--batch_size", "2", "--no_amp", "--qat_act", "--device", "cpu",
              "--output_dir", str(tmp_path / "out"),
              "--checkpoint_dir", str(tmp_path / "ck")])
    assert (tmp_path / "ck" / "final_model.pt").is_file()
