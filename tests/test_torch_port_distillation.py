"""The port's distillation against the JAX package's, on the CPU.

The tiny UNet at 32², batch 2, v-prediction, three sets of random weights
(teacher, student, EMA student). The port's losses take their random draws
as explicit tensors; the tests hand them JAX's own draws, made with the
keys and the split order of the JAX functions (``distillation.py:148``: the
noise, the pair, the renoise; ``:255``: the teacher's key, the student's;
``:283-285``: the stop-grad prefix's init noise and one key a step;
``diffusion.py:239-247``: the sampler's init noise, then one key a step).

Float32 UNet comparisons follow the repo's rule: the math is pinned with
both sides in float64 (the JAX package's float32 casts patched to float64,
as in ``test_torch_port_training.py``), equal to rounding (loss 1e-9
relative, gradients 1e-9 of their largest entry), and the port in float32
is held to that float64 value at 1e-3 (the loss relative, gradients
absolute, and the gradients' norm at 5e-3 relative), as the float32 train
step is: on random weights the float32 GroupNorm and attention of both
frameworks are only that close to exact (a step's change of the
parameters: ``test_torch_port_distillation_steps.py``). This file holds
the pairings and the losses (and a bf16 loss against JAX compiled with
XLA's excess precision off, as ``test_torch_port_bf16.py`` does, and the
refusal to pass a gradient through the fused IRB);
``test_torch_port_distillation_steps.py`` holds whole steps, the trainer
and the CLI. Each JAX-side case costs a trace and a compile of the UNet
(12-50 s), so they are few.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models import distillation as jdist
from cv_diffusion_tpu.models import scheduler as jsched
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu_torch.models import blocks as tblocks
from cv_diffusion_tpu_torch.models import distillation as tdist
from cv_diffusion_tpu_torch.models import scheduler as tsched
from cv_diffusion_tpu_torch.models.diffusion import enhance, run_sampler
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.weights import state_dict_from_jax

from test_torch_port_training import _flat_port
from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     port_model, random_jax_params)

SIZE = 32
NO_EXCESS = {"xla_allow_excess_precision": False}
TEACHER_STEPS = 2
F32_TOL = 1e-3
F64_TOL = 1e-9


# --- the three weight sets, the batch, JAX in float64 ----------------------------

@pytest.fixture(scope="module")
def case():
    """(jax config, port config, {teacher, student, ema} params, batch)."""
    jcfg, tcfg, teacher = random_jax_params("tiny", SIZE, seed=31)
    params = {"teacher": teacher,
              "student": random_jax_params("tiny", SIZE, seed=32)[2],
              "ema": random_jax_params("tiny", SIZE, seed=33)[2]}
    rng = np.random.default_rng(34)
    batch = {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("low_light", "normal_light")}
    return jcfg, tcfg, params, batch


class _F64:
    """The JAX package in float64 inside the block (its float32 casts, the
    distillation module's and the sampler's included, made float64), with
    the model built for it."""

    def __init__(self, jcfg):
        self.monkeypatch = pytest.MonkeyPatch()
        self.jcfg = dataclasses.replace(
            jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        self.stack.callback(self.monkeypatch.undo)
        self.stack.enter_context(jax_in_float64(self.monkeypatch,
                                                extra=(jdiffusion, jdist)))
        self.model, self.schedule = jax_create_model(self.jcfg)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)

    @staticmethod
    def tree(params):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# --- JAX's draws, in its split order ----------------------------------------------

def jax_sampler_draws(rng, shape, steps):
    """``enhance``'s draws (``diffusion.py:239-247``): (init, step noise)."""
    init_rng, steps_rng = jax.random.split(rng)
    init = jax.random.normal(init_rng, shape)
    keys = jax.random.split(steps_rng, steps)
    return init, jax.vmap(lambda k: jax.random.normal(k, shape))(keys)


def jax_regression_draws(rng, shape, teacher_steps, grid, full_grad=False):
    """``sampler_regression_loss``'s draws (``distillation.py:255, 283-285``):
    the teacher's (init, steps), the student's (init, steps)."""
    t_rng, s_rng = jax.random.split(rng)
    teacher = jax_sampler_draws(t_rng, shape, teacher_steps)
    if len(grid) == 1 or full_grad:
        return teacher, jax_sampler_draws(s_rng, shape, len(grid))
    s_init, s_steps = jax.random.split(s_rng)
    init = jax.random.normal(s_init, shape)
    keys = jax.random.split(s_steps, len(grid) - 1)
    return teacher, (init, jnp.stack([jax.random.normal(k, shape) for k in keys]))


def jax_consistency_draws(rng, shape, mode, steps=4, n_ddim=50, stride=None):
    """``consistency_distillation_loss``'s draws (``distillation.py:148-177``):
    the noise, the pair (t, t_next), the renoise."""
    noise_rng, t_rng, renoise_rng, _ = jax.random.split(rng, 4)
    noise = jax.random.normal(noise_rng, shape)
    batch = shape[0]
    if mode == "sampler_matched":
        grid = jnp.asarray(jsched.lcm_timesteps(steps, 1000, n_ddim), jnp.int32)
        i = jax.random.randint(t_rng, (batch,), 0, grid.shape[0] - 1)
        pair = (grid[i], grid[i + 1])
    elif mode == "canonical":
        pair = jdist.sample_canonical_pairs(t_rng, batch, 1000, n_ddim, steps,
                                            stride=stride)
    else:
        pair = jdist.sample_timestep_pairs(t_rng, batch, 1000, n_ddim, steps)
    return noise, pair, jax.random.normal(renoise_rng, shape)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- the pairings --------------------------------------------------------------------

PAIRINGS = [("reference", None), ("canonical", None), ("canonical", 1),
            ("canonical", 3), ("sampler_matched", None)]


@pytest.mark.parametrize("mode,stride", PAIRINGS,
                         ids=[f"{m}-{s}" for m, s in PAIRINGS])
def test_pairings_match_jax(mode, stride):
    """Each pairing's (t, t_next) from JAX's own draw (its index recovered
    from t) equals the port's from that index; and 4,096 of the port's own
    draws cover exactly JAX's support: the same set of pairs, none at the
    terminal grid point t = 999 (ᾱ = 0 under zero-terminal SNR)."""
    c, n = 20, 50
    steps = 4
    jt, jn = jax_consistency_draws(jax.random.key(5), (4096, 1, 1, 3), mode,
                                   steps, n, stride)[1]
    jt, jn = np.asarray(jt), np.asarray(jn)
    if mode == "sampler_matched":
        grid = tsched.lcm_timesteps(steps, 1000, n)
        idx = _t([grid.index(int(v)) for v in jt])
        got = tdist.sample_sampler_pairs(4096, grid, idx=idx)
        drawn = tdist.sample_sampler_pairs(4096, grid,
                                           generator=torch.Generator().manual_seed(0))
    else:
        idx = _t((jt - c + 1) // c)
        fn = (tdist.sample_timestep_pairs if mode == "reference" else
              lambda *a, **k: tdist.sample_canonical_pairs(*a, stride=stride, **k))
        got = fn(4096, 1000, n, steps, idx=idx)
        drawn = fn(4096, 1000, n, steps, generator=torch.Generator().manual_seed(0))
    assert np.array_equal(got[0].numpy(), jt) and np.array_equal(got[1].numpy(), jn)
    pairs = lambda a, b: set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))  # noqa: E731
    assert pairs(*drawn) == pairs(jt, jn)
    assert 999 not in set(drawn[0].tolist()) | set(drawn[1].tolist())


def test_scheduler_consistency_pairs_match_jax():
    key = jax.random.key(9)
    jt, jn = (np.asarray(a) for a in jsched.consistency_timestep_pairs(key, 64, 4))
    idx = jax.random.randint(key, (64,), 0, 50 - 12 - 1)
    t, tn = tsched.consistency_timestep_pairs(64, 4, idx=_t(np.asarray(idx)))
    assert np.array_equal(t.numpy(), jt) and np.array_equal(tn.numpy(), jn)


# --- the losses -------------------------------------------------------------------

def _grads_diff(got: dict, want: dict) -> float:
    """The largest |Δ| over all gradient entries."""
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _norm(grads: dict) -> float:
    return float(np.sqrt(sum(np.square(g).sum() for g in grads.values())))


def _models(tcfg, params, dtype):
    """The student module (its own weights) and the teacher's and EMA's
    weights as dicts, in ``dtype``."""
    model = port_model(tcfg, params["student"]).to(dtype)
    as_dict = lambda p: {k: v.to(dtype) for k, v in  # noqa: E731
                         state_dict_from_jax(p, tcfg).items()}
    return model, as_dict(params["teacher"]), as_dict(params["ema"])


def jax_f64(case, jax_loss, grad=False):
    """JAX's float64 loss (and with ``grad`` its gradients in the port's
    names, float64) and draws: ``jax_loss(f64, params, low, normal) →
    (loss function of the student's params, draws)``."""
    jcfg, tcfg, params, batch = case
    with _F64(jcfg) as f64:
        p = {k: f64.tree(v) for k, v in params.items()}
        low, normal = (jnp.asarray(batch[k], jnp.float64)
                       for k in ("low_light", "normal_light"))
        fn, draws = jax_loss(f64, p, low, normal)
        if grad:
            loss, grads = jax.jit(jax.value_and_grad(fn))(p["student"])
            grads = _flat_port(_np(grads), tcfg, f64.monkeypatch)
        else:
            loss, grads = jax.jit(fn)(p["student"]), None
        return jax.tree.map(float, loss), grads, _np(draws)


def port_loss(case, dtype, loss_fn, grad=False):
    """The port's loss (and gradients, float64 numpy) in ``dtype``:
    ``loss_fn(model, teacher, ema, low, normal)``."""
    _, tcfg, params, batch = case
    model, teacher, ema = _models(tcfg, params, dtype)
    low, normal = (_t(batch[k], dtype) for k in ("low_light", "normal_light"))
    with torch.set_grad_enabled(grad):
        loss = loss_fn(model, teacher, ema, low, normal)
    if not grad:
        return loss.item(), None
    loss.backward()
    return loss.item(), {k: p.grad.double().numpy() for k, p in model.named_parameters()
                         if p.grad is not None}


def hold_loss(case, ref_loss, loss_fn):
    """The port's loss in float64 within F64_TOL and in float32 within
    F32_TOL of JAX's float64 loss, relative."""
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        got, _ = port_loss(case, dtype, loss_fn)
        assert abs(got - ref_loss) <= tol * abs(ref_loss), (dtype, got, ref_loss)


CONSISTENCY = {"reference": {}, "sampler_matched": dict(sampler_matched=True)}


@pytest.fixture(scope="module")
def jax_consistency(case):
    """JAX's float64 loss and draws (noise, pair, renoise) of each mode in
    CONSISTENCY on one key, from one jitted function (one trace and compile
    for all of them)."""
    rng = jax.random.key(41)

    def jax_loss(f64, p, low, normal):
        draws = {m: jax_consistency_draws(rng, normal.shape, m) for m in CONSISTENCY}
        return (lambda s: {m: jdist.consistency_distillation_loss(
            f64.model, f64.schedule, p["teacher"], s, p["ema"], rng, low,
            normal, **kw) for m, kw in CONSISTENCY.items()}), draws

    losses, _, draws = jax_f64(case, jax_loss)
    return losses, draws


@pytest.mark.parametrize("mode", list(CONSISTENCY))
def test_consistency_loss_matches_jax(case, jax_consistency, mode):
    """``consistency_distillation_loss`` on JAX's noise, pair and renoise:
    the loss of the reference pairing (t_next > t, the DDIM step on the
    teacher's ε) and of the ``sampler_matched`` mode (its transition
    renoises x̂₀ with fresh noise). The canonical mode (the reference's
    transition on its own pairs) is held with its gradients through a whole
    step (``test_torch_port_distillation_steps.py``), and every mode's pairs
    by ``test_pairings_match_jax``."""
    kw = CONSISTENCY[mode]
    losses, draws = jax_consistency
    noise, pair, renoise = draws[mode]
    schedule = make_schedule(case[1].scheduler)
    hold_loss(case, losses[mode], lambda model, teacher, ema, low, normal:
              tdist.consistency_distillation_loss(
                  model, schedule, teacher, None, ema, low, normal,
                  noise=_t(noise, low.dtype), timesteps=tuple(_t(a) for a in pair),
                  renoise=_t(renoise, low.dtype), **kw))


def test_prefix_loss_matches_jax_and_trains_the_last_step(case):
    """``sampler_regression_loss`` on a 2-step grid with the stop-grad
    prefix, ``gt_weight`` and the deterministic teacher: the loss against
    JAX's (float64 F64_TOL, float32 F32_TOL), and, in float64, gradients
    equal to those of the last step alone (the first step's carry taken from
    ``run_sampler`` under no grad, then ``run_sampler`` on [259] from it: the
    clipped x̂₀ of the final step, JAX ``distillation.py:270-300``). The
    gradients with both sides in float64, through a whole step: the steps'
    tests; in float32 those of this grid are ill-conditioned on random
    weights (the second step's input at t = 259 and the attention blocks'
    output GroupNorm: 7.6e-2 and 9.8e-2 of their norm from float64 with the
    stochastic and the deterministic teacher, measured)."""
    kw = dict(student_timesteps=(739, 259), gt_weight=0.3,
              deterministic_teacher=True)
    rng = jax.random.key(42)

    def jax_loss(f64, p, low, normal):
        draws = jax_regression_draws(rng, low.shape, TEACHER_STEPS, (739, 259))
        return (lambda s: jdist.sampler_regression_loss(
            f64.model, f64.schedule, p["teacher"], s, rng, low, normal,
            teacher_steps=TEACHER_STEPS, **kw)), draws

    ref, _, draws = jax_f64(case, jax_loss)
    hold_loss(case, ref, _regression_loss(case, draws, **kw))
    (ti, ts), (si, ss) = draws
    schedule = make_schedule(case[1].scheduler)

    def last_step_only(model, teacher, ema, low, normal):
        d = low.dtype
        with torch.no_grad():
            target = run_sampler(model, schedule, low, _t(ti, d), _t(ts, d),
                                 tsched.lcm_timesteps(TEACHER_STEPS),
                                 deterministic=True, params=teacher)
            carry = run_sampler(model, schedule, low, _t(si, d),
                                torch.cat([_t(ss, d), _t(ss, d)]), [739, 259],
                                return_intermediate=True).intermediate[0]
        out = run_sampler(model, schedule, low, carry, torch.zeros((1,) + carry.shape,
                                                                   dtype=d), [259])
        return (0.7 * tdist.huber_loss(out, target)
                + 0.3 * tdist.huber_loss(out, normal))

    got, grads = port_loss(case, torch.float64, _regression_loss(case, draws, **kw),
                           grad=True)
    want, want_grads = port_loss(case, torch.float64, last_step_only, grad=True)
    assert abs(got - want) <= F64_TOL * abs(want)
    assert _grads_diff(grads, want_grads) <= F64_TOL * max(
        float(np.abs(g).max()) for g in want_grads.values())


def test_full_grad_is_the_gradient_through_the_whole_sampler(case):
    """``full_grad`` on the 2-step grid (JAX: ``enhance`` differentiated
    through both steps, ``distillation.py:264-268``): the loss and the
    gradients of the student's whole ``run_sampler`` against the teacher's
    (``run_sampler`` is ``enhance`` bit for bit, below, and ``enhance`` is
    held to JAX's in ``test_torch_port_sampler.py``), in float64; the same
    loss as the stop-grad prefix's on the same draws (held to JAX's above),
    and gradients that differ from the prefix's, since they also pass
    through the first step."""
    _, tcfg, params, batch = case
    rng = np.random.default_rng(45)
    shape = (2, SIZE, SIZE, 3)
    t_init, s_init = (rng.standard_normal(shape) for _ in range(2))
    t_steps, s_steps = (rng.standard_normal((2,) + shape) for _ in range(2))
    kw = dict(student_timesteps=(739, 259), gt_weight=0.3)
    draws = ((t_init, t_steps), (s_init, s_steps))
    full, g_full = port_loss(case, torch.float64,
                             _regression_loss(case, draws, full_grad=True, **kw),
                             grad=True)
    schedule = make_schedule(tcfg.scheduler)

    def composed(model, teacher, ema, low, normal):
        d = low.dtype
        with torch.no_grad():
            target = run_sampler(model, schedule, low, _t(t_init, d), _t(t_steps, d),
                                 tsched.lcm_timesteps(TEACHER_STEPS), params=teacher)
        out = run_sampler(model, schedule, low, _t(s_init, d), _t(s_steps, d), [739, 259])
        return (0.7 * tdist.huber_loss(out, target)
                + 0.3 * tdist.huber_loss(out, normal))

    ref, g_ref = port_loss(case, torch.float64, composed, grad=True)
    assert abs(full - ref) <= F64_TOL * abs(ref)
    assert _grads_diff(g_full, g_ref) <= F64_TOL * max(float(np.abs(g).max())
                                                       for g in g_ref.values())
    prefix, g_prefix = port_loss(case, torch.float64, _regression_loss(
        case, ((t_init, t_steps), (s_init, s_steps[:1])), **kw), grad=True)
    assert abs(full - prefix) <= F64_TOL * abs(full)
    assert _grads_diff(g_full, g_prefix) > 1e-3 * _norm(g_full)


def _regression_loss(case, draws, **kw):
    """The port's ``sampler_regression_loss`` on JAX's ``draws`` (teacher
    and student (init, steps)), as a ``port_loss`` function."""
    (ti, ts), (si, ss) = draws
    schedule = make_schedule(case[1].scheduler)

    def loss_fn(model, teacher, ema, low, normal):
        d = low.dtype
        return tdist.sampler_regression_loss(
            model, schedule, teacher, None, low, normal,
            teacher_steps=TEACHER_STEPS,
            teacher_noise=(_t(ti, d), _t(ts, d)),
            student_noise=(_t(si, d), _t(ss, d)), **kw)
    return loss_fn


def test_sampler_is_enhance_with_grad(case):
    """``run_sampler`` computes ``enhance``'s output bit for bit, and with
    grad enabled it carries the gradient to the weights."""
    _, tcfg, params, batch = case
    model = port_model(tcfg, params["student"])
    rng = np.random.default_rng(3)
    init = _t(rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32))
    steps = _t(rng.standard_normal((2, 2, SIZE, SIZE, 3)).astype(np.float32))
    low = _t(batch["low_light"])
    schedule = make_schedule(tcfg.scheduler)
    ref = enhance(model, schedule, low, timesteps=[739, 259], init_noise=init,
                  step_noise=steps, device="cpu")
    got = run_sampler(model, schedule, low, init, steps, [739, 259])
    assert torch.equal(got, ref) and got.requires_grad and not ref.requires_grad
    got.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


# --- bf16 -------------------------------------------------------------------------

def _conv_dense_grads_bf16_valued(model) -> bool:
    layers = [p for m in model.modules() if isinstance(m, (tblocks.Conv2d, tblocks.Linear))
              for p in m.parameters(recurse=False)]
    return all(torch.equal(p.grad, p.grad.to(torch.bfloat16).float()) for p in layers)


def test_bf16_regression_loss_matches_jax(case):
    """The regression loss (m = 1, ``gt_weight`` 0.3, a 1-step teacher)
    with teacher and student in bf16 compute against the JAX package's in
    bf16, compiled with XLA's excess precision off, on JAX's float32 draws:
    within 1e-3 relative (measured 5.3e-4 here, 3.1e-4 and 4.2e-4 on two
    other keys; JAX's own bf16 loss moves 1.1e-3 to 2.4e-3 with excess
    precision on). A loss averages bf16's roundings, so the value does not
    tell bf16 from float32 (a float32 computation is 6e-5 to 4.6e-3 away);
    what does: the student's convolution and dense weight gradients hold
    bf16 values only, as in a ``use_amp`` step (``test_torch_port_bf16.
    py``), and the float32 model's do not."""
    jcfg, tcfg, params, batch = case
    kw = dict(student_timesteps=(739,), gt_weight=0.3, teacher_steps=1)
    bf = lambda cfg: dataclasses.replace(  # noqa: E731
        cfg, unet=dataclasses.replace(cfg.unet, dtype="bfloat16"))
    jmodel, jschedule = jax_create_model(bf(jcfg))
    rng = jax.random.key(44)
    low, normal = (jnp.asarray(batch[k]) for k in ("low_light", "normal_light"))

    def jloss(student, teacher):
        return jdist.sampler_regression_loss(jmodel, jschedule, teacher, student,
                                             rng, low, normal, **kw)

    ref = float(jax.jit(jloss).lower(params["student"], params["teacher"])
                .compile(NO_EXCESS)(params["student"], params["teacher"]))
    (ti, ts), (si, ss) = _np(jax_regression_draws(rng, low.shape, 1, (739,)))
    teacher = state_dict_from_jax(params["teacher"], tcfg)
    for cfg, holds in ((bf(tcfg), True), (tcfg, False)):
        model = port_model(cfg, params["student"])
        loss = tdist.sampler_regression_loss(
            model, make_schedule(cfg.scheduler), teacher, None,
            _t(batch["low_light"]), _t(batch["normal_light"]),
            teacher_noise=(_t(ti), _t(ts)), student_noise=(_t(si), _t(ss)), **kw)
        loss.backward()
        if holds:
            assert abs(loss.item() - ref) <= 1e-3 * abs(ref)
        assert _conv_dense_grads_bf16_valued(model) == holds


# --- the fused IRB's refusal --------------------------------------------------------

def test_no_gradient_through_the_fused_irb(case):
    """With ``use_pallas_irb`` a regression student (eval mode, grad on)
    would route every stride-1 IRB through the fused kernel, which has no
    backward: the port raises; the teacher's sampler, under no grad, takes
    the fused route. JAX's regression student, its ``enhance``
    differentiated (``distillation.py:264-268``), cannot be differentiated
    on the same configuration either: its Pallas kernel's JVP fails an
    assertion (``jax/_src/pallas/pallas_call.py``)."""
    jcfg, tcfg, params, batch = case
    fused = lambda cfg: dataclasses.replace(  # noqa: E731
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas_irb=True))
    model = port_model(fused(tcfg), params["student"])
    teacher = state_dict_from_jax(params["teacher"], tcfg)
    low, normal = (_t(batch[k]) for k in ("low_light", "normal_light"))
    kw = dict(teacher_steps=1, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="fused IRB kernel has no backward"):
        tdist.sampler_regression_loss(model, make_schedule(tcfg.scheduler), teacher,
                                      None, low, normal, **kw)
    with torch.no_grad():
        loss = tdist.sampler_regression_loss(model, make_schedule(tcfg.scheduler),
                                             teacher, None, low, normal, **kw)
    assert torch.isfinite(loss)

    from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
    jmodel, jschedule = jax_create_model(fused(jcfg))
    with pytest.raises(AssertionError) as err:
        jax.grad(lambda s: jax_enhance(
            jmodel, jschedule, {"params": s}, jax.random.key(0),
            jnp.asarray(batch["low_light"]), timesteps=(739,)).sum())(params["student"])
    assert any(str(f.path).endswith("pallas/pallas_call.py") for f in err.traceback)
