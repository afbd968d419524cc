"""The port's distillation steps, trainer and CLI against the JAX package's,
on the CPU (the losses: ``test_torch_port_distillation.py``, whose weights,
batch and JAX draws these tests share).

Whole steps are held against JAX's own step factory in float64: the
port's step in float64 for two steps (loss, gradient norm, and the change
of the student and of its EMA, relative to JAX's change, at 1e-9), and in
float32 for one (the loss at 1e-3, the gradient norm at 5e-3, the changes
at 5e-2). The rest is the port's own: the generator's draw order, the
capacity-asymmetric teacher (JAX's test of it is marked slow), the trainer
and the CLI on a LOL-style directory, the layouts the CLI reads, the
``--use_ema`` difference from the JAX loader, and the card's reference's
draws.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.config import TrainConfig as JaxTrainConfig
from cv_diffusion_tpu.models import distillation as jdist
from cv_diffusion_tpu.training import train_state as jts
from cv_diffusion_tpu_torch import distill as tcli
from cv_diffusion_tpu_torch.config import (TrainConfig, diffusion_config,
                                           load_model_config, to_json)
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.data.dataset import create_dataloaders
from cv_diffusion_tpu_torch.models import distillation as tdist
from cv_diffusion_tpu_torch.models.diffusion import create_model
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.training import checkpoint as tckpt
from cv_diffusion_tpu_torch.training.trainer import DistillationTrainer
from cv_diffusion_tpu_torch.weights import init_weights, state_dict_from_jax

from test_torch_port_distillation import (F32_TOL, F64_TOL, SIZE, TEACHER_STEPS,  # noqa: F401
                                          _F64,
                                          _flat_port, _np, _t, case,
                                          jax_consistency_draws,
                                          jax_regression_draws)
from test_torch_port_weights import one_torch_thread, port_model  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- whole steps -----------------------------------------------------------------

STEP_KINDS = {
    "regression": dict(student_timesteps=(739,), teacher_steps=1, gt_weight=0.3),
    "consistency": dict(canonical=True, pair_stride=1),
}
# the relative error of the float32 step's change of the student and EMA
# (below): measured 2.5e-2 (regression) and 3.3e-2 (consistency) against
# JAX in float64
F32_DELTA_TOL = 5e-2


def _delta_err(got: dict, want: dict, before: dict) -> float:
    """‖(got − before) − (want − before)‖ / ‖want − before‖ over all
    tensors: how far a step's change of the parameters is from JAX's."""
    assert set(got) == set(want)
    num = sum(np.square(got[k] - want[k]).sum() for k in want)
    den = sum(np.square(want[k] - before[k]).sum() for k in want)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("kind", list(STEP_KINDS))
def test_distillation_step_matches_jax(case, kind):
    """Whole steps of each kind (regression m = 1 with ``gt_weight`` from a
    1-step teacher; canonical consistency, ``pair_stride=1``) against JAX's
    own step factory (``make_regression_distillation_step`` /
    ``make_distillation_step``, with ``create_distillation_state`` and
    ``make_optimizer``'s clip and AdamW) in float64, from the same teacher
    and student (the EMA starts as a copy of the student on both sides) and
    JAX's draws from the key each step splits off the state's. What is held
    is each step's loss and gradient norm before the clip, and the CHANGE of
    the student and of its EMA (0.95, no warm-up) relative to JAX's change
    (``_delta_err``); the teacher stays bit for bit.

    In float64 both steps are held at F64_TOL (measured 1.2e-10 and below).
    The clip binds (gradient norms 0.96 then 1.51, and 8.8 then 2.6, at
    ``gradient_clip`` 1.0), so the second step shows it. A step that leaves the
    state unchanged gives 1.0; twice the learning rate gives 1.2 to 1.3; no
    clip gives 0.067 and 0.17 on the student; the trainer's EMA decay
    0.9999 gives 0.998 on the EMA (all measured). The port's float32 step is
    held for one step: a first AdamW step moves each parameter by about
    ±lr·sign(g), and float32 flips the sign of gradients that are
    near zero, so its change is 2.5e-2 and 3.3e-2 from float64 and the
    second step's gradient norm 7% from JAX's in regression (measured): held at
    F32_DELTA_TOL, the loss at F32_TOL and the norm at 5e-3."""
    jcfg, tcfg, params, batch = case
    kw = STEP_KINDS[kind]
    jc = JaxTrainConfig(epochs=2, warmup_epochs=0)
    spe = 4
    with _F64(jcfg) as f64:
        p = {k: f64.tree(v) for k, v in params.items()}
        tx, _ = jts.make_optimizer(jc, spe)
        state = jdist.create_distillation_state(p["teacher"], p["student"], tx,
                                                jax.random.key(7))
        low, normal = (jnp.asarray(batch[k], jnp.float64)
                       for k in ("low_light", "normal_light"))
        if kind == "regression":
            step = jdist.make_regression_distillation_step(
                f64.model, f64.schedule, donate=False, **kw)
        else:
            step = jdist.make_distillation_step(f64.model, f64.schedule,
                                                donate=False, **kw)
        flat = lambda t: _flat_port(_np(t), tcfg, f64.monkeypatch)  # noqa: E731
        before = flat(p["student"])
        ref = []
        for _ in range(2):
            _, step_rng = jax.random.split(state.rng)
            draws = (jax_regression_draws(step_rng, low.shape, 1, (739,))
                     if kind == "regression" else
                     jax_consistency_draws(step_rng, low.shape, "canonical", stride=1))
            state, metrics = step(state, {"low_light": low, "normal_light": normal})
            ref.append(dict(loss=float(metrics["loss"]), norm=float(metrics["grad_norm"]),
                            student=flat(state.student_params),
                            ema=flat(state.ema_student_params), draws=_np(draws)))

    def port_steps(dtype, n):
        model = port_model(tcfg, params["teacher"]).to(dtype)  # the student replaces these
        st = tdist.create_distillation_state(
            model, state_dict_from_jax(params["teacher"], tcfg),
            TrainConfig(epochs=2, warmup_epochs=0), spe,
            student_params=state_dict_from_jax(params["student"], tcfg))
        teacher_before = {k: v.clone() for k, v in st.teacher_params.items()}
        schedule = make_schedule(tcfg.scheduler)
        if kind == "regression":
            step = tdist.make_regression_distillation_step(model, schedule, **kw)
        else:
            step = tdist.make_distillation_step(model, schedule, **kw)
        metrics = []
        for r in ref[:n]:
            if kind == "regression":
                (ti, ts), (si, ss) = r["draws"]
                explicit = dict(teacher_noise=(_t(ti, dtype), _t(ts, dtype)),
                                student_noise=(_t(si, dtype), _t(ss, dtype)))
            else:
                noise, pair, _ = r["draws"]
                explicit = dict(noise=_t(noise, dtype), timesteps=tuple(_t(a) for a in pair))
            st, m = step(st, batch, explicit)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        assert st.step == n
        assert all(torch.equal(st.teacher_params[k], v) for k, v in teacher_before.items())
        student = {k: v.detach().double().numpy() for k, v in model.named_parameters()}
        return metrics, student, {k: v.double().numpy() for k, v in st.ema_params.items()}

    metrics, student, ema = port_steps(torch.float64, 2)
    for (loss, norm), r in zip(metrics, ref):
        assert abs(loss - r["loss"]) <= F64_TOL * abs(r["loss"]), (loss, r["loss"])
        assert abs(norm - r["norm"]) <= F64_TOL * r["norm"], (norm, r["norm"])
    assert _delta_err(student, ref[1]["student"], before) <= F64_TOL
    assert _delta_err(ema, ref[1]["ema"], before) <= F64_TOL

    [(loss, norm)], student, ema = port_steps(torch.float32, 1)
    np.testing.assert_allclose(loss, ref[0]["loss"], rtol=F32_TOL)
    np.testing.assert_allclose(norm, ref[0]["norm"], rtol=5e-3)
    errs = (_delta_err(student, ref[0]["student"], before),
            _delta_err(ema, ref[0]["ema"], before))
    assert max(errs) <= F32_DELTA_TOL, errs


def test_step_draws_from_the_generator_in_its_documented_order(case):
    """Without explicit draws a regression step draws the teacher's and then
    the student's sampler noise from the state's generator
    (``diffusion.sampler_noise``): the same step on those draws made
    explicitly from a copy of the generator gives the same loss."""
    _, tcfg, params, batch = case
    schedule = make_schedule(tcfg.scheduler)
    teacher = state_dict_from_jax(params["teacher"], tcfg)
    losses = []
    for explicit in (False, True):
        model = port_model(tcfg, params["student"])
        st = tdist.create_distillation_state(model, teacher, TrainConfig(), 4)
        draws = None
        if explicit:
            from cv_diffusion_tpu_torch.models.diffusion import sampler_noise
            gen = torch.Generator().set_state(st.generator.get_state())
            shape = (2, SIZE, SIZE, 3)
            draws = dict(teacher_noise=sampler_noise(gen, shape, TEACHER_STEPS, "cpu"),
                         student_noise=sampler_noise(gen, shape, 1, "cpu"))
        step = tdist.make_regression_distillation_step(model, schedule,
                                                       teacher_steps=TEACHER_STEPS)
        losses.append(float(step(st, batch, draws)[1]["loss"]))
    assert losses[0] == losses[1]


# --- a teacher of another architecture ---------------------------------------------

def test_asymmetric_teacher_regression_step():
    """A small student under a tiny teacher (regression only; JAX's own
    test is marked slow): the student starts from ``init_weights`` with the
    config's seed, the teacher's sampler runs the teacher's module
    (``teacher_steps`` calls a step), the student moves and the teacher
    does not; consistency with a ``teacher_model`` raises."""
    small_cfg = diffusion_config("small", SIZE, prediction_type="v_prediction")
    tiny_cfg = diffusion_config("tiny", SIZE, prediction_type="v_prediction")
    student, schedule = create_model(small_cfg, device="cpu")
    teacher_model, _ = create_model(tiny_cfg, device="cpu")
    teacher = init_weights(tiny_cfg, seed=5, device="cpu")
    rng = np.random.default_rng(6)
    batch = [{k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
              for k in ("low_light", "normal_light")}]
    cfg = TrainConfig(epochs=1, warmup_epochs=0, seed=3, async_checkpoints=False)
    with pytest.raises(ValueError, match="requires regression"):
        DistillationTrainer(student, schedule, teacher, batch, config=cfg,
                            teacher_model=teacher_model)
    calls = []
    teacher_model.unet.register_forward_hook(lambda *a: calls.append(1))
    trainer = DistillationTrainer(student, schedule, teacher, batch, config=cfg,
                                  regression=True, teacher_steps=2,
                                  teacher_model=teacher_model)
    init = init_weights(small_cfg, seed=3, device="cpu")
    assert all(torch.equal(p, init[k]) for k, p in student.named_parameters())
    loss = trainer.train_epoch()
    assert np.isfinite(loss) and len(calls) == 2 and trainer.state.step == 1
    assert any(not torch.equal(p, init[k]) for k, p in student.named_parameters())
    assert all(torch.equal(trainer.state.teacher_params[k], v) for k, v in teacher.items())


# --- the trainer and the CLI on a LOL-style directory -------------------------------

def _lol(root, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        for side in ("low", "high"):
            png.write_png(root / side / f"{i:03d}.png",
                          rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
    return str(root)


def _tiny_teacher(tmp_path):
    """A tiny v-prediction model's random weights saved with
    ``save_params`` (params.npz + model_config.json)."""
    cfg = diffusion_config("tiny", SIZE, prediction_type="v_prediction")
    path = str(tmp_path / "teacher")
    tckpt.save_params(path, init_weights(cfg, seed=8, device="cpu"), to_json(cfg))
    return cfg, path


def _student_files(d):
    return sorted(os.listdir(d))


def test_trainer_one_epoch_on_a_directory(tmp_path):
    """``DistillationTrainer`` (regression, synchronous saves) for one epoch
    on a LOL-style directory: ``best_student`` and ``student_final`` with
    their weights, model config and grid, the sample grid, and the saved
    student served through the port's loaders."""
    cfg, teacher_dir = _tiny_teacher(tmp_path)
    data = _lol(tmp_path / "lol", 4, 0)
    train, val = create_dataloaders(data, data, batch_size=2, image_size=SIZE,
                                    native=False, prefetch=0, device="cpu")
    model, schedule = create_model(cfg, device="cpu")
    tc = TrainConfig(unet_variant="tiny", image_size=SIZE, epochs=1,
                     warmup_epochs=0, batch_size=2, async_checkpoints=False,
                     checkpoint_dir=str(tmp_path / "ck"), output_dir=str(tmp_path / "out"))
    trainer = DistillationTrainer(model, schedule,
                                  tckpt.load_inference_params(teacher_dir, use_ema=False),
                                  train, val, tc, regression=True,
                                  student_timesteps=(739,), teacher_steps=2,
                                  gt_weight=0.3)
    trainer.train()
    assert trainer.state.step == 2 and np.isfinite(trainer.best_val_psnr)
    for name in ("best_student", "student_final"):
        d = tmp_path / "ck" / name
        assert _student_files(d) == ["model_config.json", "params.npz",
                                     "student_timesteps.json"]
        assert json.loads((d / "student_timesteps.json").read_text()) == {"timesteps": [739]}
    assert (tmp_path / "out" / "distill_samples_epoch_0.png").is_file()
    final = tmp_path / "ck" / "student_final"
    saved = tckpt.load_inference_params(str(final), use_ema=False)
    assert all(torch.equal(saved[k], v) for k, v in trainer.state.ema_params.items())
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    pipe = ServingPipeline.from_config(str(final / "model_config.json"),
                                       str(final / "student_timesteps.json"), saved,
                                       device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    out = pipe(img, seed=0)
    assert out.shape == img.shape and out.dtype == np.uint8


def _jax_cli_parser():
    """``scripts/distill.py``'s parser, taken where its ``main`` parses."""
    import argparse
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import distill as jcli
    finally:
        sys.path.pop(0)
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jcli.main()
    return seen[0]


def test_cli_flags_and_defaults_match_scripts_distill():
    """Every flag of ``scripts/distill.py`` with its default, type,
    choices, and whether it is required or a switch; the port adds
    ``--device``."""
    def flags(parser):
        return {a.dest: (a.default, a.type, a.choices, a.required, a.nargs, a.const)
                for a in parser._actions if a.dest != "help"}

    ref, got = flags(_jax_cli_parser()), flags(tcli.build_parser())
    assert set(got) - set(ref) == {"device"} and got.pop("device")[0] == "cuda"
    assert got == ref


def test_cli_warns_and_defaults_to_cuda(capsys):
    """Without ``--canonical``, ``--sampler_matched`` or ``--regression``
    the CLI prints the JAX CLI's warning about the reference pairing; its
    device is ``cuda`` unless asked, and without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--teacher", "none", "--data_dir", "none"])
    assert tcli.REFERENCE_PAIRING_WARNING in capsys.readouterr().err


def test_cli_distills_from_a_directory(tmp_path):
    """``python -m cv_diffusion_tpu_torch.distill``'s ``main`` on the CPU:
    a regression run from a ``save_params`` teacher (its v-prediction and
    variant read from its model config) on a LOL-style directory, asynchronous
    saves drained; the students carry the teacher's prediction type."""
    _, teacher_dir = _tiny_teacher(tmp_path)
    data = _lol(tmp_path / "lol", 2, 1)
    trainer = tcli.main([
        "--teacher", teacher_dir, "--data_dir", data, "--val_dir", data,
        "--variant", "tiny", "--image_size", str(SIZE), "--epochs", "1",
        "--batch_size", "2", "--regression", "--student_timesteps", "739,259",
        "--teacher_steps", "2", "--gt_weight", "0.3", "--device", "cpu",
        "--checkpoint_dir", str(tmp_path / "ck"), "--output_dir", str(tmp_path / "out")])
    assert trainer.state.step == 1 and trainer.student_timesteps == (739, 259)
    for name in ("best_student", "student_final"):
        d = tmp_path / "ck" / name
        assert _student_files(d) == ["model_config.json", "params.npz",
                                     "student_timesteps.json"]
        assert load_model_config(str(d / "model_config.json")).scheduler.prediction_type \
            == "v_prediction"
        assert tckpt.detect_variant(str(d)) == "tiny"


# --- the layouts the CLI reads, and --use_ema ----------------------------------------

def test_layouts_prediction_type_and_variant(tmp_path):
    """``load_prediction_type`` and ``detect_variant`` on each of the port's
    layouts (a ``save_params`` directory, a serving package, a full
    checkpoint, a committed artifact's directory beside its ``.npz``), and
    ``resolve_weights`` on the last: the ``.npz``, whose weights the CLI
    then loads. An orbax directory without weights in the port's format
    stays as it is, and the loader refuses it."""
    from cv_diffusion_tpu_torch.export.serving import create_serving_package
    from cv_diffusion_tpu_torch.training.train_state import create_train_state
    from cv_diffusion_tpu_torch.weights import load_state_dict_npz

    cfg, teacher_dir = _tiny_teacher(tmp_path)
    model, schedule = create_model(cfg, device="cpu")
    create_serving_package(str(tmp_path / "pkg"), model, schedule)
    tc = TrainConfig(unet_variant="tiny", prediction_type="v_prediction")
    ckpt_path = str(tmp_path / "full.pt")
    tckpt.save_checkpoint(ckpt_path, create_train_state(model, tc), epoch=0,
                          best_val_loss=0.0, config_json=to_json(tc))
    art = os.path.join(REPO, "artifacts", "vreg1b_gt03_ema")
    for path, want in ((teacher_dir, "tiny"), (str(tmp_path / "pkg"), "tiny"),
                       (ckpt_path, "tiny"), (art, "small")):
        assert tckpt.load_prediction_type(path) == "v_prediction", path
        assert tckpt.detect_variant(path) == want, path
    npz = load_state_dict_npz(os.path.join(REPO, "artifacts_torch",
                                           "vreg1b_gt03_ema.npz"), "cpu")
    got = tckpt.load_inference_params(tckpt.resolve_weights(art), use_ema=False)
    assert set(got) == set(npz) and all(torch.equal(got[k], v) for k, v in npz.items())
    orbax = os.path.join(REPO, "artifacts", "vpred256_ema")
    assert tckpt.resolve_weights(orbax) == orbax
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_inference_params(tckpt.resolve_weights(orbax))


def test_use_ema_of_a_full_checkpoint_differs_from_the_jax_loader(tmp_path):
    """The ``--use_ema`` divergence, pinned: on a full checkpoint whose
    parameters and EMA differ, the JAX loader's ``use_ema=True`` returns
    the raw parameters when called without ``params_like`` (its params-only
    branch restores the checkpoint's ``params``), and the EMA with it (as
    the JAX CLIs call it: ``scripts/distill.py`` passes one); the port's
    returns the EMA, and its raw parameters with ``use_ema=False``, which
    the port's distill CLI passes for ``--init_student`` (the JAX CLI's
    default)."""
    from cv_diffusion_tpu.training import checkpoint as jckpt
    from cv_diffusion_tpu.training import train_state as jts_
    from cv_diffusion_tpu_torch.training.train_state import TrainState

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ema = {"w": params["w"] + 100.0}
    jstate = jts_.create_train_state(None, JaxTrainConfig(), jax.random.key(0),
                                     variables={"params": params})
    jstate = jstate.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    jpath = str(tmp_path / "jax_full")
    jckpt.save_checkpoint(jpath, jstate, epoch=0, best_val_loss=0.0,
                          config_json=json.dumps({}))
    like = jax.tree.map(np.zeros_like, params)
    np.testing.assert_array_equal(
        jckpt.load_inference_params(jpath, use_ema=True, verbose=False)["w"], params["w"])
    np.testing.assert_array_equal(
        jckpt.load_inference_params(jpath, like, use_ema=True, verbose=False)["w"],
        ema["w"])

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(params["w"]))
    state = TrainState(step=0, model=module, optimizer=torch.optim.AdamW(module.parameters()),
                       lr_schedule=lambda s: 0.0,
                       ema_params={"w": torch.from_numpy(ema["w"])},
                       generator=torch.Generator())
    path = str(tmp_path / "port_full.pt")
    tckpt.save_checkpoint(path, state, epoch=0, best_val_loss=0.0, config_json="{}")
    np.testing.assert_array_equal(
        tckpt.load_inference_params(path, use_ema=True)["w"].numpy(), ema["w"])
    np.testing.assert_array_equal(
        tckpt.load_inference_params(path, use_ema=False)["w"].numpy(), params["w"])


def test_distill_reference_draws_and_inputs_regenerate():
    """``chip_smoke.py``'s ``distill`` phase makes the JAX reference's numpy
    draws again from the recipe in ``….distill_ref.json`` and takes its two
    inputs from the synthetic split: both match the SHA-256 the reference
    recorded, and every setting's draws are the shapes and bounds JAX's
    losses asked for."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    from cv_diffusion_tpu_torch.evaluate import eval_split, sha256

    with open(os.path.join(REPO, "artifacts_torch", "vreg1b_gt03_ema.distill_ref.json")) as f:
        ref = json.load(f)
    assert [s["name"] for s in ref["settings"]] == [
        "regression_739", "regression_739_259_prefix", "canonical_stride1",
        "sampler_matched"]
    for i, s in enumerate(ref["settings"]):
        draws = chip_smoke.reference_draws(ref["seed"], i, s["draws"])
        assert [sha256(d) for d in draws] == s["draws_sha256"], s["name"]
        assert all(np.isfinite(v) and v > 0 for v in s["grad_norms"].values())
    low, high = (a[:ref["batch"]] for a in eval_split(15, ref["size"], 0))
    assert [sha256(a) for a in low] == ref["inputs"]["low_sha256"]
    assert [sha256(a) for a in high] == ref["inputs"]["high_sha256"]
