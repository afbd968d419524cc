"""The port's spatially sharded training on the CPU, against its
one-process steps and the JAX package's unsharded loss.

Four processes of the port (``tests/torch_dp_rank.py spatial_train``,
gloo, started once for the module) lay out a ``(2, 2)`` mesh (two rows of
the global batch of 8 and 16 of the 32 image rows a process) and run the
tiny UNet's forward through ``train_forward`` in float64 and float32,
train steps in float64 (dropout 0.1; ``grad_accum_steps=2``; ``remat``;
weight-only QAT), a step with explicit t and ε, a ragged eval and one
``Trainer`` step with ``mesh_shape=(2, 2)`` and its gathered sample grid.
The steps are compared in float64, as the data-parallel ones are
(``test_torch_port_parallel_train.py`` says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.export.qat import make_qat_train_step
from cv_diffusion_tpu_torch.parallel import pad_batch
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.training.trainer import Trainer
from cv_diffusion_tpu_torch.weights import state_dict_from_jax

import torch_dp_rank
from torch_dp_rank import SPATIAL_STEP_CASES, step_config, tiny
from test_torch_port_parallel_train import _micro_major
from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     random_jax_params)

WORLD = 4
SIZE = 32
STEP_TOL = 1e-9             # float64, sharded against one process
JAX_LOSS_REL = 1e-4         # tests/test_parallel.py:118
FORWARD_F32_TOL = 1e-3      # the port's float32 forward against JAX's


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"low_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
            "normal_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    """JAX config, port config and random weights (perturbed norms) of the
    tiny v-prediction UNet at 32²."""
    return random_jax_params("tiny", SIZE, seed=13)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """(inputs, each process's results) of the ``spatial_train`` task."""
    _, tcfg, params = case
    rng = np.random.default_rng(8)
    padded, n_valid = pad_batch(_batch(5, 40), 8)
    directory = str(tmp_path_factory.mktemp("spatial_train"))
    inputs = dict(
        weights=state_dict_from_jax(params, tcfg), dir=directory,
        batch=_batch(8, 41), t=rng.integers(0, 1000, 8).astype(np.int32),
        eps=rng.standard_normal((8, SIZE, SIZE, 3)),
        train_batches=[_batch(8, 42), _batch(8, 43)],
        eval_padded=padded, n_valid=n_valid)
    return inputs, torch_dp_rank.spawn("spatial_train", directory, inputs, WORLD)


def _block(a, rank):
    """Rank ``rank``'s block of an NHWC batch of 8 on the (2, 2) mesh."""
    d, s = divmod(rank, 2)
    return a[4 * d:4 * d + 4, 16 * s:16 * s + 16]


@pytest.fixture(scope="module")
def jax_loss(case, ranks):
    """JAX's ``train_forward`` and loss in float64 on the whole batch with
    the explicit t and ε: (noise_pred, loss)."""
    jcfg, _, params = case
    inputs, _ = ranks
    jcfg64 = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))
    monkeypatch = pytest.MonkeyPatch()
    with jax_in_float64(monkeypatch, extra=(jdiffusion,)):
        jmodel, jschedule = jax_create_model(jcfg64)

        def fwd(p, batch, t, eps):
            out = jdiffusion.train_forward(
                jmodel, jschedule, {"params": p}, jax.random.key(0),
                batch["low_light"], batch["normal_light"], timesteps=t, noise=eps)
            return out["noise_pred"], jdiffusion.diffusion_loss(out["noise_pred"],
                                                                out["target"])

        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        batch = {k: jnp.asarray(v, jnp.float64) for k, v in inputs["batch"].items()}
        pred, loss = jax.jit(fwd)(p, batch, jnp.asarray(inputs["t"]),
                                  jnp.asarray(inputs["eps"], jnp.float64))
        out = np.asarray(pred), float(loss)
    monkeypatch.undo()
    return out


def test_forward_matches_jax_unsharded(ranks, jax_loss):
    """The tiny UNet's forward (``train_forward`` with the explicit t and ε)
    on its block of the (2, 2) mesh against JAX's unsharded forward of the
    whole batch: float64 within 1e-9, float32 within the port's standing
    1e-3."""
    _, results = ranks
    pred, _ = jax_loss
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["float64"], _block(pred, rank), atol=1e-9, rtol=0)
        np.testing.assert_allclose(res["float32"], _block(pred, rank),
                                   atol=FORWARD_F32_TOL, rtol=0)


def test_explicit_step_loss_matches_jax(ranks, jax_loss):
    """A step with the explicit t and ε on the (2, 2) mesh: its loss (the
    mean over the whole mesh of each process's mean) against JAX's
    unsharded loss, rel 1e-4 (``tests/test_parallel.py:118``), the same on
    every process."""
    _, results = ranks
    _, loss = jax_loss
    for res in results:
        assert res["explicit"]["loss"] == results[0]["explicit"]["loss"]
        np.testing.assert_allclose(res["explicit"]["loss"], loss, rtol=JAX_LOSS_REL)


@pytest.mark.parametrize("label,model_kw,config_kw,_", SPATIAL_STEP_CASES)
def test_spatial_train_step_matches_one_process(ranks, label, model_kw, config_kw, _,
                                                one_torch_thread):  # noqa: F811
    """Two steps on the (2, 2) mesh against the port's one-process step on
    the global batch in float64 (dropout masks, t and ε drawn for the
    global batch; with ``grad_accum_steps=2`` the batch micro-major over
    the data axis; ``remat`` recomputing every block, collectives
    included, in the backward; weight-only QAT): loss and gradient norm of
    each step (rel 1e-9), parameters and EMA after (atol 1e-9), the same
    bits in every process."""
    inputs, results = ranks
    model, schedule = tiny(inputs, float64=True, **model_kw)
    tc = step_config(**config_kw)
    state = tts.create_train_state(model, tc, steps_per_epoch=4)
    make = make_qat_train_step if label == "qat" else tts.make_train_step
    step = make(model, schedule, tc)
    got = results[0]["steps"][label]
    accum = tc.grad_accum_steps
    for batch, (loss, norm) in zip(inputs["train_batches"], got["metrics"]):
        state, m = step(state, _micro_major(batch, accum, world=2))
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=STEP_TOL)
        np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=STEP_TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["params"][k], p.detach().numpy(),
                                   atol=STEP_TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["ema"][k], state.ema_params[k].numpy(),
                                   atol=STEP_TOL, rtol=0, err_msg=k)
    for res in results[1:]:
        other = res["steps"][label]
        assert other["metrics"] == got["metrics"]
        assert all(np.array_equal(other["params"][k], v) for k, v in got["params"].items())


def test_spatial_eval_matches_one_process(ranks, one_torch_thread):  # noqa: F811
    """A batch of 5 padded to 8 over the (2, 2) mesh: the eval step (each
    image's squared error summed over the spatial group) equals the
    one-process eval, float64 rel 1e-9, on every process."""
    inputs, results = ranks
    model, schedule = tiny(inputs, float64=True)
    evaluate = tts.make_eval_step(model, schedule, step_config())
    ref = float(evaluate(None, torch.Generator().manual_seed(7),
                         inputs["eval_padded"], inputs["n_valid"]))
    for res in results:
        assert res["eval"] == pytest.approx(ref, rel=STEP_TOL)


def test_trainer_step_on_a_spatial_mesh(ranks, tmp_path, one_torch_thread):  # noqa: F811
    """``Trainer`` with ``mesh_shape=(2, 2)``: each process takes its block
    of the loader's global batch; one step equals a one-process Trainer's
    on that batch (float64, atol 1e-9), and the sample grid, sampled over
    the mesh and gathered, is written by process 0 alone and is the
    one-process grid within 1 LSB."""
    inputs, results = ranks
    model, schedule = tiny(inputs, float64=True)
    tc = step_config(batch_size=8, num_samples=4, async_checkpoints=False,
                     output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ck"))
    trainer = Trainer(model, schedule, [inputs["train_batches"][0]],
                      [inputs["train_batches"][1]], tc)
    loss = trainer.train_epoch()
    want = png.read_image(trainer.generate_samples(0)).astype(int)
    for rank, res in enumerate(results):
        got = res["trainer"]
        assert got["spatial"] is True
        np.testing.assert_allclose(got["loss"], loss, rtol=STEP_TOL)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(got["params"][k], p.detach().numpy(),
                                       atol=STEP_TOL, rtol=0, err_msg=k)
        assert (got["grid"] is None) == (rank != 0)
    grid = png.read_image(results[0]["trainer"]["grid"]).astype(int)
    assert grid.shape == want.shape
    assert np.abs(grid - want).max() <= 1
