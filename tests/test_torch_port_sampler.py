"""The port's ``enhance`` against the JAX package's on identical noise, within
5e-3 (the README's sampler tolerance): random weights on several grids, and
the committed 1-step student ``artifacts/vreg1b_gt03_ema`` carried across.

The JAX side reads the orbax checkpoint here, in the test; the port itself
never does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from cv_diffusion_tpu.config import from_dict as jax_from_dict
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.training import checkpoint as ckpt
from cv_diffusion_tpu_torch.config import load_model_config, load_timesteps
from cv_diffusion_tpu_torch.export.serving import ServingPipeline
from cv_diffusion_tpu_torch.models.diffusion import LowLightDiffusion, enhance
from cv_diffusion_tpu_torch.models.scheduler import make_schedule
from cv_diffusion_tpu_torch.weights import state_dict_from_jax

from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(REPO, "artifacts", "vreg1b_gt03_ema")
TOL = 5e-3


def _both_enhance(jcfg, tcfg, params, size, grid, deterministic=False,
                  batch=2, seed=0):
    """(port, jax) outputs of one sampler run on the same numpy noise."""
    steps = len(grid) if grid else jcfg.num_inference_steps
    rng = np.random.default_rng(seed)
    low = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    init = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    noise = rng.standard_normal((steps, batch, size, size, 3)).astype(np.float32)

    jmodel, jschedule = jax_create_model(jcfg)
    ref = jax_enhance(jmodel, jschedule, {"params": params},
                      jax.random.key(0), jnp.asarray(low),
                      init_noise=jnp.asarray(init),
                      step_noise=jnp.asarray(noise),
                      deterministic=deterministic, timesteps=grid)

    model = LowLightDiffusion(tcfg).eval()
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    got = enhance(model, make_schedule(tcfg.scheduler), torch.from_numpy(low),
                  timesteps=grid, init_noise=torch.from_numpy(init),
                  step_noise=torch.from_numpy(noise),
                  deterministic=deterministic, device="cpu")
    assert got.shape == (batch, size, size, 3) and got.dtype == torch.float32
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("grid,deterministic,mode", [
    ([739], False, "concat"),
    ([739, 259], False, "concat"),
    (None, False, "concat"),            # the stock 4-step grid [739, 499, 259, 19]
    ([739, 259], True, "concat"),       # renoise-free DDIM-style steps
    ([739, 259], False, "add"),         # ConditionEncoder conditioning
])
def test_enhance_matches_jax(grid, deterministic, mode):
    jcfg, tcfg, params = random_jax_params("tiny", 32, seed=7,
                                           perturb_norms=False,
                                           condition_mode=mode)
    got, ref = _both_enhance(jcfg, tcfg, params, 32, grid, deterministic)
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.skipif(not os.path.isdir(STUDENT),
                    reason="committed student artifact missing")
def test_committed_student_matches_jax():
    """The committed 1-step student, carried across, through both samplers
    at 64² on its own grid [739] (the UNet is built for 256², where the only
    attention is mid_attn, and runs on the 64² input as in JAX); and the
    port's ServingPipeline on those weights answers a uint8 request."""
    params = ckpt.load_inference_params(STUDENT, verbose=False)
    tcfg = load_model_config(os.path.join(STUDENT, "model_config.json"))
    grid = list(load_timesteps(os.path.join(STUDENT, "student_timesteps.json")))
    assert grid == [739]
    with open(os.path.join(STUDENT, "model_config.json")) as f:
        jcfg = jax_from_dict(JaxDiffusionConfig, json.load(f))
    assert tcfg.scheduler.prediction_type == "v_prediction"
    got, ref = _both_enhance(jcfg, tcfg, params, 64, grid, batch=1, seed=3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert got.std() > 0.05          # trained weights: a real image, not noise

    pipe = ServingPipeline.from_config(
        os.path.join(STUDENT, "model_config.json"),
        os.path.join(STUDENT, "student_timesteps.json"),
        state_dict_from_jax(params, tcfg), device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    out = pipe(img, seed=0)
    assert out.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, pipe(img, seed=0))
