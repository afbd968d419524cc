"""The port's training against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the port's
own draws (t and ε from the train step's ``torch.Generator``) are replayed
from a copy of the generator and handed to JAX's ``train_forward``. The LR
schedules are held to optax's at every step (1e-7 relative to the peak LR,
float64 against optax's float32); clip + AdamW and the EMA, from equal
gradients, to optax and ``update_ema`` at 1e-6; one whole train step of the
tiny UNet at 32² to JAX's ``train_forward`` + ``make_optimizer`` +
``update_ema`` over two steps at 1e-3 in float32 (loss, gradients,
parameters and EMA: on random weights the float32 GroupNorm and attention
of both frameworks are only that close to exact, see
``test_torch_port_weights.py``), and its loss and gradients at 1e-9 with
both sides in float64.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cv_diffusion_tpu.config import TrainConfig as JaxTrainConfig
from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.training import ema as jema
from cv_diffusion_tpu.training import train_state as jts
from cv_diffusion_tpu_torch.config import TrainConfig, diffusion_config
from cv_diffusion_tpu_torch.data import augment as taugment
from cv_diffusion_tpu_torch.data.dataset import (DataLoader,
                                                 SyntheticLowLightDataset)
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models.diffusion import (
    create_model, diffusion_loss, sample_timesteps_and_noise, train_forward)
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
from cv_diffusion_tpu_torch.training import checkpoint as tckpt
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.training.ema import init_ema, update_ema
from cv_diffusion_tpu_torch.training.trainer import Trainer
from cv_diffusion_tpu_torch import weights as tweights
from cv_diffusion_tpu_torch.weights import init_weights, state_dict_from_jax

from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     port_model, random_jax_params)

SIZE = 32


def _cfgs(**kw):
    kw.setdefault("use_amp", False)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


# --- LR schedule, clip + AdamW, EMA ------------------------------------------

@pytest.mark.parametrize("kw,spe", [
    (dict(scheduler_type="cosine", epochs=6, warmup_epochs=2), 3),
    (dict(scheduler_type="cosine", epochs=6, warmup_epochs=2,
          faithful_no_warmup=True), 3),
    (dict(scheduler_type="cosine", epochs=5, warmup_epochs=0), 4),
    (dict(scheduler_type="onecycle", epochs=6, warmup_epochs=2), 3),
    (dict(scheduler_type="onecycle", epochs=10, warmup_epochs=0), 1),
    (dict(scheduler_type="cosine", epochs=2, warmup_epochs=5), 3),   # clamp
    (dict(scheduler_type="onecycle", epochs=2, warmup_epochs=5), 3),
])
def test_lr_schedule_matches_optax(kw, spe):
    jc, tc = _cfgs(learning_rate=3e-4, min_lr=1e-6, **kw)
    ref = jts.make_lr_schedule(jc, spe)
    got = tts.make_lr_schedule(tc, spe)
    total = spe * tc.epochs
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(ref(count)),
                                   rtol=0, atol=1e-7 * tc.learning_rate,
                                   err_msg=f"count {count}")


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in arrays.items()})


@pytest.mark.parametrize("ema_warmup", [True, False])
def test_clip_adamw_and_ema_match_optax(ema_warmup):
    """Three updates from the same gradients: the first with LR 0 (linear
    warmup starts at 0), gradients above and below the clip norm."""
    jc, tc = _cfgs(learning_rate=1e-2, weight_decay=0.05, gradient_clip=1.0,
                   epochs=4, warmup_epochs=1, ema_decay=0.9,
                   ema_warmup=ema_warmup)
    spe = 2
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    tx, _ = jts.make_optimizer(jc, spe)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state, jema_p = tx.init(jp), jema.init_ema(jp)

    module = _Params(params)
    state = tts.TrainState(
        step=0, model=module,
        optimizer=tts.make_optimizer(tc, list(module.parameters())),
        lr_schedule=tts.make_lr_schedule(tc, spe),
        ema_params=init_ema(dict(module.named_parameters())),
        generator=torch.Generator())
    for step, scale in enumerate((3.0, 0.1, 2.0)):
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        jnorm = float(optax.global_norm(jg))
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        jema_p = jema.update_ema(jema_p, jp, jc.ema_decay,
                                 step=jnp.asarray(step) if ema_warmup else None)
        for k, p in module.p.items():
            p.grad = torch.tensor(grads[k])      # a copy: the clip is in place
        norm = tts.apply_update(state, tc)
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-6)
        for k, p in module.p.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(state.ema_params[f"p.{k}"].numpy(),
                                       np.asarray(jema_p[k]), atol=1e-6)
    assert state.step == 3


def test_init_ema_is_a_copy():
    p = {"w": torch.ones(3)}
    e = init_ema(p)
    p["w"].add_(1.0)
    assert torch.equal(e["w"], torch.ones(3))
    update_ema(e, p, decay=0.9999, step=0)        # d = 1/10
    np.testing.assert_allclose(e["w"].numpy(), 1.9, rtol=1e-6)


# --- the whole train step against JAX -----------------------------------------

def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"low_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
            "normal_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)}


def _replay(state, schedule, shape):
    """The t and ε the port's next step draws, from a copy of its generator."""
    gen = torch.Generator().set_state(state.generator.get_state())
    t, eps = sample_timesteps_and_noise(schedule, shape, gen, "cpu")
    return t.numpy().astype(np.int32), eps.numpy()


class _Np64:
    """numpy with ``float32`` meaning float64, so the weight converter keeps
    float64 gradients float64."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


def _flat_port(tree, tcfg, monkeypatch=None):
    """A JAX params-shaped tree (params or grads) in the port's names and
    layouts; in float64 when a ``monkeypatch`` is given (the converter casts
    to float32 otherwise)."""
    if monkeypatch is None:
        return {k: v.numpy() for k, v in state_dict_from_jax(tree, tcfg).items()}
    with monkeypatch.context() as patch:
        patch.setattr(tweights, "np", _Np64())
        return {k: v.numpy() for k, v in state_dict_from_jax(tree, tcfg).items()}


def _assert_trees_close(got, want, atol, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def tiny_case():
    """JAX and port configs and random params of the tiny UNet at 32²
    (attention at 16² and 8²), v-prediction, every bias and GroupNorm
    scale perturbed."""
    return random_jax_params("tiny", SIZE, seed=11)


STEP_CFG = dict(epochs=2, warmup_epochs=0)      # default LR, clip and EMA
SPE = 4


def _port_draws(tc, n):
    """The t and ε of the port's first ``n`` train steps on batches of 2:
    a fresh state's generator is seeded with ``tc.seed``."""
    gen = torch.Generator().manual_seed(tc.seed)
    schedule = make_schedule(diffusion_config("tiny", SIZE).scheduler)
    out = []
    for _ in range(n):
        t, eps = sample_timesteps_and_noise(schedule, (2, SIZE, SIZE, 3), gen,
                                            "cpu")
        out.append((t.numpy().astype(np.int32), eps.numpy()))
    return out


@pytest.fixture(scope="module")
def jax_steps(tiny_case):
    """Two train steps of the JAX package in float64 (``train_forward`` +
    ``make_optimizer``'s clip and AdamW + ``update_ema``; its float32 casts
    patched to float64) on the batches, t and ε of the port's first two
    steps; each step's loss, gradient norm, gradients, parameters and EMA
    in the port's names and layouts, in float64."""
    jcfg_model, tcfg_model, params = tiny_case
    jcfg64 = dataclasses.replace(
        jcfg_model, unet=dataclasses.replace(jcfg_model.unet, dtype="float64"))
    jc, tc = _cfgs(**STEP_CFG)
    monkeypatch = pytest.MonkeyPatch()
    out = []
    with jax_in_float64(monkeypatch, extra=(jdiffusion,)):
        jmodel, jschedule = jax_create_model(jcfg64)
        tx, _ = jts.make_optimizer(jc, SPE)

        def jloss(p, batch, t, eps):
            res = jdiffusion.train_forward(
                jmodel, jschedule, {"params": p}, jax.random.key(0),
                batch["low_light"], batch["normal_light"], timesteps=t,
                noise=eps)
            return jdiffusion.diffusion_loss(res["noise_pred"], res["target"])

        @jax.jit
        def jstep(p, opt_state, ema, batch, t, eps, step):
            loss, grads = jax.value_and_grad(jloss)(p, batch, t, eps)
            updates, opt_state = tx.update(grads, opt_state, p)
            p = optax.apply_updates(p, updates)
            ema = jema.update_ema(ema, p, jc.ema_decay, step=step)
            return p, opt_state, ema, loss, optax.global_norm(grads), grads

        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        opt_state, ema = tx.init(p), jema.init_ema(p)
        for i, (t, eps) in enumerate(_port_draws(tc, 2)):
            batch = {k: jnp.asarray(v, jnp.float64)
                     for k, v in _batch(2, 20 + i).items()}
            p, opt_state, ema, loss, norm, grads = jstep(
                p, opt_state, ema, batch, jnp.asarray(t),
                jnp.asarray(eps, jnp.float64), jnp.asarray(i))
            assert loss.dtype == jnp.float64
            flat = lambda tree: _flat_port(jax.tree.map(np.asarray, tree),  # noqa: E731
                                           tcfg_model, monkeypatch)
            out.append(dict(loss=float(loss), norm=float(norm),
                            grads=flat(grads), params=flat(p), ema=flat(ema)))
    monkeypatch.undo()
    return out


def test_train_step_matches_jax(tiny_case, jax_steps):
    """Two whole float32 train steps of the port against the JAX package's
    train step math on the same weights, batches, t and ε: loss (rtol
    1e-4), clipped gradients, parameters and EMA (atol 1e-3), and the
    gradient norm before the clip (rtol 5e-3). The JAX side runs in
    float64, since float32 gradients of this UNet on random weights are far
    from exact in both frameworks: GroupNorm's one-pass variance puts the
    port's 2.7e-3 and their norm 2.2e-3 (relative) from float64 on the
    first batch (``test_float32_gradient_error_is_groupnorms_one_pass_
    variance``), and JAX's float32 gradients differ from float64 too; and
    Adam's first update is ±lr wherever a gradient is far above eps, so two
    float32 runs whose gradients differ in sign near 0 take parameters 2·lr
    apart, and their second steps' gradients further apart still."""
    _, tcfg_model, params = tiny_case
    _, tc = _cfgs(**STEP_CFG)
    model = port_model(tcfg_model, params)
    schedule = make_schedule(tcfg_model.scheduler)
    state = tts.create_train_state(model, tc, steps_per_epoch=SPE)
    step = tts.make_train_step(model, schedule, tc)
    for i, (ref, (t, eps)) in enumerate(zip(jax_steps, _port_draws(tc, 2))):
        got_t, got_eps = _replay(state, schedule, (2, SIZE, SIZE, 3))
        assert np.array_equal(got_t, t) and np.array_equal(got_eps, eps)
        state, metrics = step(state, _batch(2, 20 + i))
        np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(float(metrics["grad_norm"]), ref["norm"],
                                   rtol=5e-3)
        scale = min(1.0, tc.gradient_clip / ref["norm"])
        _assert_trees_close(
            {k: p.grad.numpy() for k, p in model.named_parameters()},
            {k: g * scale for k, g in ref["grads"].items()}, 1e-3,
            f"clipped grad, step {i}")
        _assert_trees_close(
            {k: p.detach().numpy() for k, p in model.named_parameters()},
            ref["params"], 1e-3, f"param, step {i}")
        _assert_trees_close(
            {k: e.numpy() for k, e in state.ema_params.items()},
            ref["ema"], 1e-3, f"EMA, step {i}")
    assert state.step == 2


def test_train_loss_and_grads_match_jax_in_float64(tiny_case, jax_steps):
    """The port's loss and gradients of the first step in float64 against
    the JAX package's in float64 (its float32 casts, ``diffusion_loss``'s
    included, patched to float64): equal to rounding, so the port computes
    the JAX package's loss and gradients."""
    _, tcfg_model, params = tiny_case
    _, tc = _cfgs(**STEP_CFG)
    (t, eps), = _port_draws(tc, 1)
    batch = _batch(2, 20)
    model = port_model(tcfg_model, params).double()
    schedule = make_schedule(tcfg_model.scheduler)
    out = train_forward(model, schedule,
                        torch.from_numpy(batch["low_light"]).double(),
                        torch.from_numpy(batch["normal_light"]).double(),
                        timesteps=torch.from_numpy(t),
                        noise=torch.from_numpy(eps).double())
    loss = diffusion_loss(out["noise_pred"], out["target"])
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), jax_steps[0]["loss"], atol=1e-9,
                               rtol=0)
    _assert_trees_close({k: p.grad.numpy() for k, p in model.named_parameters()},
                        jax_steps[0]["grads"], 1e-9, "grad")


def test_float32_gradient_error_is_groupnorms_one_pass_variance(
        tiny_case, jax_steps, monkeypatch):
    """Why the float32 step is held to JAX in float64 and the gradient norm
    at 5e-3: on the first step's batch the port's float32 gradients are
    2.7e-3 from float64 (norm 2.2e-3 relative), and nearly all of that is
    GroupNorm's one-pass variance E[x²] − E[x]², the JAX package's formula,
    which the port keeps: taken two-pass, the error falls below 1e-4."""
    from cv_diffusion_tpu_torch.ops import norms

    _, tcfg_model, params = tiny_case
    _, tc = _cfgs(**STEP_CFG)
    (t, eps), = _port_draws(tc, 1)
    batch = _batch(2, 20)
    exact = jax_steps[0]["grads"]

    def grads():
        model = port_model(tcfg_model, params)
        out = train_forward(model, make_schedule(tcfg_model.scheduler),
                            torch.from_numpy(batch["low_light"]),
                            torch.from_numpy(batch["normal_light"]),
                            timesteps=torch.from_numpy(t),
                            noise=torch.from_numpy(eps))
        diffusion_loss(out["noise_pred"], out["target"]).backward()
        g = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
        err = max(np.abs(g[k] - exact[k]).max() for k in g)
        norm = np.sqrt(sum((v ** 2).sum() for v in g.values()))
        return err, norm

    one_pass, norm = grads()
    exact_norm = np.sqrt(sum((v ** 2).sum() for v in exact.values()))
    assert 1e-3 < one_pass < 5e-3
    assert 1e-3 < abs(norm / exact_norm - 1) < 5e-3

    def two_pass(x, num_groups, eps):
        xg = x.reshape(x.shape[0], num_groups, -1)
        mean = xg.mean(dim=-1, keepdim=True)
        var = (xg - mean).square().mean(dim=-1, keepdim=True)
        return ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)

    monkeypatch.setattr(norms, "_normalized", two_pass)
    assert grads()[0] < 1e-4


def _tiny_model(seed=0, **unet):
    cfg = diffusion_config("tiny", SIZE, prediction_type="v_prediction", **unet)
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(init_weights(cfg, seed=seed, device="cpu"))
    return model, schedule


def test_grad_accum_matches_manual_average():
    """``grad_accum_steps=2`` is one update from the mean of the two
    micro-batches' loss and gradients, t and ε drawn micro-batch after
    micro-batch from the step's generator."""
    tc = TrainConfig(use_amp=False, grad_accum_steps=2, use_ema=False,
                     warmup_epochs=0, learning_rate=1e-3)
    batch = _batch(4, 40)
    model, schedule = _tiny_model()
    ref_model, _ = _tiny_model()
    state = tts.create_train_state(model, tc, steps_per_epoch=10)
    ref_state = tts.create_train_state(ref_model, tc, steps_per_epoch=10)
    losses = []
    for i in range(2):
        out = train_forward(ref_model, schedule,
                            torch.from_numpy(batch["low_light"][2 * i:2 * i + 2]),
                            torch.from_numpy(batch["normal_light"][2 * i:2 * i + 2]),
                            generator=ref_state.generator)
        loss = diffusion_loss(out["noise_pred"], out["target"])
        loss.backward()
        losses.append(float(loss))
    for p in ref_model.parameters():
        p.grad /= 2
    ref_norm = tts.apply_update(ref_state, tc)

    state, metrics = tts.make_train_step(model, schedule, tc)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_norm),
                               rtol=1e-6)
    for (name, p), q in zip(model.named_parameters(), ref_model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-7, err_msg=name)


def test_grad_accum_refuses_an_indivisible_batch():
    tc = TrainConfig(use_amp=False, grad_accum_steps=3)
    model, schedule = _tiny_model()
    state = tts.create_train_state(model, tc)
    with pytest.raises(ValueError, match="not divisible"):
        tts.make_train_step(model, schedule, tc)(state, _batch(4, 41))


def test_eval_step_is_masked_mse():
    """mse over the first ``n_valid`` images, whatever ``loss_type`` is;
    with the EMA (here: other weights) in place of the module's own."""
    tc = TrainConfig(use_amp=False, loss_type="l1")
    model, schedule = _tiny_model()
    other, _ = _tiny_model(seed=1)
    evaluate = tts.make_eval_step(model, schedule, tc)
    batch = _batch(3, 50)
    params = dict(other.named_parameters())

    def per_image(params, n):
        gen = torch.Generator().manual_seed(0)
        return float(evaluate(params, gen, batch, n))

    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = train_forward(other, schedule, torch.from_numpy(batch["low_light"]),
                            torch.from_numpy(batch["normal_light"]),
                            generator=gen, train=False)
    mse = ((out["noise_pred"] - out["target"]) ** 2).mean(dim=(1, 2, 3))
    np.testing.assert_allclose(per_image(params, 2), float(mse[:2].mean()),
                               rtol=1e-6)
    np.testing.assert_allclose(per_image(params, None), float(mse.mean()),
                               rtol=1e-6)
    assert per_image(None, 3) != per_image(params, 3)


@pytest.mark.parametrize("name,value", [("use_wandb", True)])
def test_unported_training_features_raise(name, value):
    tc = dataclasses.replace(TrainConfig(use_amp=False), **{name: value})
    model, schedule = _tiny_model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tts.make_train_step(model, schedule, tc)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(model, schedule, [None], config=tc)


@pytest.mark.parametrize("name,value", [
    ("use_amp", True), ("remat", True), ("init_params_from", "weights.npz"),
    ("data_on_device", True), ("native_loader", True), ("qat", True),
    ("qat_act", True), ("mesh_shape", (1, 1))])
def test_ported_training_features_are_accepted(name, value, tmp_path):
    """Refused before they were ported: a train step and a Trainer take
    them (``init_params_from`` names a weights file written here; ``qat_act``
    is given a model built with ``act_quant="fake"``; ``mesh_shape`` lays
    out this one process, as data × spatial; more processes are
    ``test_torch_port_parallel_train.py``'s)."""
    model, schedule = _tiny_model(**({"act_quant": "fake"} if name == "qat_act" else {}))
    if name == "init_params_from":
        value = str(tmp_path / value)
        tweights.save_state_dict_npz(model.state_dict(), value, source="test")
    tc = dataclasses.replace(TrainConfig(use_amp=False), checkpoint_dir=str(tmp_path),
                             **{name: value})
    tts.make_train_step(model, schedule, tc)
    assert Trainer(model, schedule, [None], config=tc).state.step == 0


def test_train_config_matches_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)])


# --- checkpoints, the trainer ------------------------------------------------

def _loaders(n=4, seed=0):
    images = np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3),
                                                  dtype=np.uint8)
    ds = SyntheticLowLightDataset(images, image_size=SIZE, seed=seed)
    return (DataLoader(ds, 2, shuffle=True, drop_last=True, seed=seed),
            DataLoader(ds, 2))


def test_trainer_epoch_validation_checkpoints_and_resume(tmp_path, capsys):
    """One epoch of two steps plus validation on tiny@32; the final
    checkpoint restores the whole state and resumes at epoch + 1, and
    ``load_inference_params`` gives its EMA."""
    ckpt_dir = tmp_path / "ckpt"
    tc = TrainConfig(unet_variant="tiny", image_size=SIZE, epochs=1,
                     batch_size=2, use_amp=False, warmup_epochs=0,
                     checkpoint_dir=str(ckpt_dir), log_interval=1,
                     save_interval=1, prediction_type="v_prediction",
                     output_dir=str(tmp_path / "samples"))
    train, val = _loaders()
    model, schedule = _tiny_model()
    trainer = Trainer(model, schedule, train, val, tc)
    before = (lak.linear_attention_kernel.launches,
              lak.linear_attention_backward_kernel.launches)
    trainer.train()
    assert trainer.state.step == 2
    assert (lak.linear_attention_kernel.launches,
            lak.linear_attention_backward_kernel.launches) == before
    assert sorted(os.listdir(ckpt_dir)) == ["best_model.pt",
                                            "checkpoint_epoch_0.pt",
                                            "final_model.pt"]
    assert os.listdir(tmp_path / "samples") == ["samples_epoch_0.png"]
    assert np.isfinite(trainer.best_val_loss)
    assert "Epoch 0: train_loss=" in capsys.readouterr().out

    final = str(ckpt_dir / "final_model.pt")
    fresh, _ = _tiny_model(seed=5)
    resumed = Trainer(fresh, schedule, train, val,
                      dataclasses.replace(tc, resume_from=final, epochs=2))
    assert resumed.epoch == 1 and resumed.state.step == 2
    assert resumed.best_val_loss == trainer.best_val_loss
    for (name, p), q in zip(fresh.named_parameters(), model.parameters()):
        assert torch.equal(p, q), name
    for name, e in trainer.state.ema_params.items():
        assert torch.equal(resumed.state.ema_params[name], e)
    assert torch.equal(resumed.state.generator.get_state(),
                       trainer.state.generator.get_state())
    a = trainer.state.optimizer.state_dict()["state"]
    b = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"]) for i in a)

    ema = tckpt.load_inference_params(final, use_ema=True)
    raw = tckpt.load_inference_params(final, use_ema=False)
    for name, e in trainer.state.ema_params.items():
        assert torch.equal(ema[name], e)
        assert torch.equal(raw[name], dict(model.named_parameters())[name])
    assert not all(torch.equal(ema[k], raw[k]) for k in ema)
    # the next epoch from the resumed state takes the same step as the
    # original run would have
    resumed.train()
    assert resumed.state.step == 4


# --- dropout ------------------------------------------------------------------

def _irb(dropout):
    torch.manual_seed(0)
    return tblocks.InvertedResidualBlock(16, 32, 64, expansion_ratio=2,
                                         dropout=dropout)


def test_dropout_off_in_eval_and_at_rate_zero():
    x, temb = torch.randn(2, 16, 8, 8), torch.randn(2, 64)
    ref = _irb(0.0).eval()(x, temb)
    blk = _irb(0.3)
    assert torch.equal(blk.eval()(x, temb), ref)
    assert torch.equal(_irb(0.0).train()(x, temb), ref)


def test_dropout_in_training_uses_the_given_generator():
    blk = _irb(0.25).train()
    x, temb = torch.randn(2, 16, 8, 8), torch.randn(2, 64)
    with pytest.raises(ValueError, match="Generator"):
        blk(x, temb)
    state = torch.random.get_rng_state()
    a = blk(x, temb, torch.Generator().manual_seed(1))
    b = blk(x, temb, torch.Generator().manual_seed(1))
    c = blk(x, temb, torch.Generator().manual_seed(2))
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the dropped-out projection: kept elements scaled by 1/(1 − p)
    full = blk.eval()(x, temb) - blk.skip(x)
    kept = (a - blk.skip(x)).detach()
    zero = kept == 0
    assert abs(float(zero.float().mean()) - 0.25) < 0.03
    torch.testing.assert_close(kept[~zero], (full / 0.75).detach()[~zero])


def test_train_step_draws_dropout_from_the_state_generator():
    tc = TrainConfig(use_amp=False, warmup_epochs=0)
    losses = []
    for _ in range(2):
        model, schedule = _tiny_model(dropout=0.1)
        state = tts.create_train_state(model, tc)
        _, metrics = tts.make_train_step(model, schedule, tc)(state, _batch(2, 60))
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1]


# --- data -------------------------------------------------------------------

def test_synthetic_dataset_and_loader_match_jax(tmp_path):
    """The same images as files for the JAX dataset and as an array for the
    port's: the same pairs, bit for bit, and the same shuffled batches."""
    from PIL import Image

    from cv_diffusion_tpu.data import augment as jaugment
    from cv_diffusion_tpu.data.dataset import DataLoader as JaxDataLoader
    from cv_diffusion_tpu.data.dataset import \
        SyntheticLowLightDataset as JaxSynthetic

    images = np.random.default_rng(70).integers(0, 256, (5, 40, 48, 3),
                                                dtype=np.uint8)
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / f"{i:02d}.png")
    ref = JaxDataLoader(JaxSynthetic(str(tmp_path), image_size=SIZE, seed=3),
                        2, shuffle=True, drop_last=True, seed=4)
    got = DataLoader(SyntheticLowLightDataset(images, image_size=SIZE, seed=3),
                     2, shuffle=True, drop_last=True, seed=4)
    assert len(got) == len(ref) == 2
    for _ in range(2):          # two epochs: the shuffle carries on
        for r, g in zip(ref, got):
            for key in ("low_light", "normal_light"):
                assert g[key].dtype == np.float32
                np.testing.assert_array_equal(g[key], r[key])
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(
        taugment.synthetic_low_light(rng_a, images[0]),
        jaugment.synthetic_low_light(rng_b, images[0]))



# --- the full-sampler quality evaluation --------------------------------------

def test_evaluate_quality_matches_the_jax_formula(tmp_path):
    """``Trainer.evaluate_quality`` on tiny@32 with explicit noise against
    the JAX ``Trainer.evaluate_quality``'s formula (``trainer.py:277-295``):
    the JAX sampler on the stock 2-step grid under the EMA weights, the
    output denormalised and clipped, PSNR and SSIM batch means averaged over
    the batches. The module's own weights are moved away from the EMA's
    first, so the EMA must be the weights used. PSNR within 1e-3 dB, SSIM
    within 1e-4."""
    from cv_diffusion_tpu.models.diffusion import denormalize_image
    from cv_diffusion_tpu.training import metrics as jm

    jcfg, tcfg, params = random_jax_params("tiny", SIZE, seed=3,
                                           perturb_norms=False)
    model, schedule = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    val = list(_loaders(n=4, seed=2)[1])   # the loader draws anew each epoch
    trainer = Trainer(model, schedule, [None], val, TrainConfig(
        use_amp=False, use_ema=True, checkpoint_dir=str(tmp_path)))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    rng = np.random.default_rng(9)
    noise = [(rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32),
              rng.standard_normal((2, 2, SIZE, SIZE, 3)).astype(np.float32))
             for _ in range(len(val))]
    got = trainer.evaluate_quality(
        num_inference_steps=2,
        noise=[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in noise])

    jmodel, jschedule = jax_create_model(jcfg)
    psnrs, ssims = [], []
    for batch, (init, step) in zip(val, noise):
        out = jdiffusion.enhance(jmodel, jschedule, {"params": params},
                                 jax.random.key(0), jnp.asarray(batch["low_light"]),
                                 num_inference_steps=2, init_noise=jnp.asarray(init),
                                 step_noise=jnp.asarray(step))
        pred = jnp.clip(denormalize_image(out.astype(jnp.float32)), 0.0, 1.0)
        target = denormalize_image(jnp.asarray(batch["normal_light"]))
        psnrs.append(float(jm.psnr(pred, target)))
        ssims.append(float(jm.ssim(pred, target)))
    assert abs(got["psnr"] - np.mean(psnrs)) <= 1e-3, (got, psnrs)
    assert abs(got["ssim"] - np.mean(ssims)) <= 1e-4, (got, ssims)
    # without explicit noise it draws from a generator seeded 0: repeatable
    a = trainer.evaluate_quality(num_inference_steps=2, max_batches=1)
    assert a == trainer.evaluate_quality(num_inference_steps=2, max_batches=1)
