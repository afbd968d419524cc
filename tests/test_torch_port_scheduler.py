"""The PyTorch port's LCM scheduler against the JAX package's, at 1e-6.

Inputs are made with numpy from a seed and handed to both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.config import SchedulerConfig as JaxSchedulerConfig
from cv_diffusion_tpu.models import scheduler as jsched
from cv_diffusion_tpu_torch.config import SchedulerConfig
from cv_diffusion_tpu_torch.models import scheduler as tsched

from test_torch_port_weights import one_torch_thread  # noqa: F401

TOL = 1e-6


def _configs(**kw):
    return JaxSchedulerConfig(**kw), SchedulerConfig(**kw)


def test_scheduler_config_fields_match():
    assert ([f.name for f in dataclasses.fields(SchedulerConfig)]
            == [f.name for f in dataclasses.fields(JaxSchedulerConfig)])


@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear",
                                           "squaredcos_cap_v2"])
@pytest.mark.parametrize("rescale", [False, True])
def test_tables_match(beta_schedule, rescale):
    jc, tc = _configs(beta_schedule=beta_schedule,
                      rescale_betas_zero_snr=rescale)
    js, ts = jsched.make_schedule(jc), tsched.make_schedule(tc)
    for name in ("betas", "alphas_cumprod", "final_alpha_cumprod"):
        got = getattr(ts, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, name)),
                                   atol=TOL, rtol=0)
    if rescale:
        assert float(ts.alphas_cumprod[-1]) == 0.0


@pytest.mark.parametrize("steps", [1, 2, 4, 8, 50])
def test_grids_match(steps):
    grid = tsched.lcm_timesteps(steps)
    assert grid == jsched.lcm_timesteps(steps)
    assert tsched.prev_timesteps(grid) == jsched.prev_timesteps(grid)
    if steps == 4:
        assert grid == [739, 499, 259, 19]
    with pytest.raises(ValueError):
        tsched.lcm_timesteps(0)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("t,prev_t", [(739, 259), (739, 0), (499, 259),
                                      (19, 0), (259, 19)])
def test_steps_match(prediction_type, clip, t, prev_t):
    jc, tc = _configs(prediction_type=prediction_type,
                      rescale_betas_zero_snr=True, clip_pred_x0=clip)
    js, ts = jsched.make_schedule(jc), tsched.make_schedule(tc)
    rng = np.random.default_rng(t + prev_t)
    shape = (2, 8, 8, 3)
    out, x, noise = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(3))

    x0_j = jsched.pred_original_sample(js, jnp.asarray(out), t, jnp.asarray(x))
    x0_t = tsched.pred_original_sample(ts, torch.from_numpy(out), t,
                                       torch.from_numpy(x))
    np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), atol=TOL)

    prev_j, _ = jsched.step(js, jnp.asarray(out), jnp.int32(t),
                            jnp.int32(prev_t), jnp.asarray(x),
                            noise=jnp.asarray(noise))
    prev_t_, _ = tsched.step(ts, torch.from_numpy(out), t, prev_t,
                             torch.from_numpy(x), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(prev_t_.numpy(), np.asarray(prev_j), atol=TOL)

    ddim_j, _ = jsched.ddim_step(js, jnp.asarray(out), jnp.int32(t),
                                 jnp.int32(prev_t), jnp.asarray(x))
    ddim_t, _ = tsched.ddim_step(ts, torch.from_numpy(out), t, prev_t,
                                 torch.from_numpy(x))
    np.testing.assert_allclose(ddim_t.numpy(), np.asarray(ddim_j), atol=TOL)


def test_step_draws_noise_from_generator():
    ts = tsched.make_schedule(SchedulerConfig(rescale_betas_zero_snr=True))
    x = torch.zeros(1, 3, 4, 4)
    a, _ = tsched.step(ts, x, 739, 259, x,
                       generator=torch.Generator().manual_seed(0))
    b, _ = tsched.step(ts, x, 739, 259, x,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.abs().max() > 0
    with pytest.raises(ValueError):
        tsched.step(ts, x, 739, 259, x)
    # the last step returns x̂₀ and needs no noise
    last, x0 = tsched.step(ts, x, 19, 0, x)
    assert torch.equal(last, x0)


@pytest.mark.parametrize("rescale", [False, True])
def test_add_noise_and_velocity_match(rescale):
    """The training forward process on int timesteps [B], at 1e-6; t = 999
    under zero-terminal SNR (ᾱ = 0) included."""
    jc, tc = _configs(rescale_betas_zero_snr=rescale)
    js, ts = jsched.make_schedule(jc), tsched.make_schedule(tc)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.asarray([0, 17, 500, 999], dtype=np.int32)
    for j_fn, t_fn in ((jsched.add_noise, tsched.add_noise),
                       (jsched.get_velocity, tsched.get_velocity)):
        ref = np.asarray(j_fn(js, jnp.asarray(x0), jnp.asarray(eps),
                              jnp.asarray(t)))
        got = t_fn(ts, torch.from_numpy(x0), torch.from_numpy(eps),
                   torch.from_numpy(t))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
