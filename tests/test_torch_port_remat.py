"""Rematerialisation (``UNetConfig.remat``) and warm starts
(``TrainConfig.init_params_from`` / ``init_params_ema``) of the port, on the
CPU.

remat recomputes the same operations on the same inputs in the backward, so
its gradients are held to the plain backward's bit for bit, for both
policies and both scopes, in float32 and bf16, with dropout on (its masks
come from the train step's generator, which the recompute must replay and
hand back where it was). ``remat_policy="conv"`` is held to what JAX's
``save_only_these_names("conv_out")`` keeps: the convolutions' outputs are
saved (no convolution runs again in the backward) while the rest is
recomputed. Unknown policies and scopes raise the JAX package's own
messages.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cv_diffusion_tpu_torch.config import TrainConfig, diffusion_config
from cv_diffusion_tpu_torch.models import unet as tunet
from cv_diffusion_tpu_torch.models.diffusion import (create_model, diffusion_loss,
                                                     train_forward)
from cv_diffusion_tpu_torch.training import checkpoint as tckpt
from cv_diffusion_tpu_torch.training.trainer import Trainer
from cv_diffusion_tpu_torch.weights import (init_weights, load_state_dict_npz,
                                            save_state_dict_npz)

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


def _model(dtype="float32", dropout=0.1, **remat):
    cfg = diffusion_config("tiny", SIZE, prediction_type="v_prediction",
                           dtype=dtype, dropout=dropout, **remat)
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(init_weights(cfg, seed=0, device="cpu"), strict=True)
    return model.train(), schedule


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
            for k in ("low_light", "normal_light")}


def _loss_and_grads(model, schedule, batch, generator):
    out = train_forward(model, schedule, batch["low_light"], batch["normal_light"],
                        timesteps=torch.tensor([100, 800]),
                        noise=torch.from_numpy(np.random.default_rng(4).standard_normal(
                            (2, SIZE, SIZE, 3)).astype(np.float32)),
                        generator=generator)
    loss = diffusion_loss(out["noise_pred"], out["target"])
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy,scope", [("full", "all"), ("full", "decoder"),
                                          ("conv", "all"), ("conv", "decoder")])
def test_remat_gradients_equal_the_plain_backward(policy, scope, dtype):
    """Loss, every gradient and the generator's state after the step equal
    those without remat, bit for bit (bound 0: the recompute runs the same
    operations on the same inputs, dropout masks included)."""
    batch = _batch()
    runs = []
    for remat in (False, True):
        model, schedule = _model(dtype, remat=remat, remat_policy=policy,
                                 remat_scope=scope)
        gen = torch.Generator().manual_seed(9)
        loss, grads = _loss_and_grads(model, schedule, batch, gen)
        runs.append((loss, grads, gen.get_state()))
    (loss0, grads0, gen0), (loss1, grads1, gen1) = runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)
    assert torch.equal(gen0, gen1)


class _CountOps(TorchDispatchMode):
    """Counts the operations that run under it, by overload."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(policy, scope="all"):
    """The operations the backward of one remat step runs, by overload."""
    model, schedule = _model(dropout=0.0, remat=True, remat_policy=policy,
                             remat_scope=scope)
    batch = _batch()
    out = train_forward(model, schedule, batch["low_light"], batch["normal_light"],
                        timesteps=torch.tensor([100, 800]),
                        noise=torch.zeros(2, SIZE, SIZE, 3))
    loss = diffusion_loss(out["noise_pred"], out["target"])
    with _CountOps() as ops:
        loss.backward()
    return ops.counts


@pytest.mark.parametrize("scope", ["all", "decoder"])
def test_conv_policy_saves_only_the_convolutions(scope):
    """In the backward, ``full`` runs convolutions of the rematerialised
    blocks again (those whose outputs the backward needs: the recompute
    stops once it has them), ``conv`` runs none, their outputs having been
    saved. Both recompute the rest: the GroupNorms' statistics among it. The
    gradients' own convolutions are the same in both."""
    conv = torch.ops.aten.convolution.default
    gn_mean = torch.ops.aten.mean.dim
    bwd = torch.ops.aten.convolution_backward.default
    full = _backward_ops("full", scope)
    saved = _backward_ops("conv", scope)
    assert full.get(conv, 0) > 0 and saved.get(conv, 0) == 0
    assert saved.get(gn_mean, 0) > 0 and full.get(gn_mean, 0) >= saved[gn_mean]
    assert full[bwd] == saved[bwd] > 0


def test_forward_without_a_gradient_runs_no_checkpoint(monkeypatch):
    """remat acts only where a gradient is recorded: inference and
    validation run the blocks as they are."""
    calls = []
    monkeypatch.setattr(tunet, "checkpoint",
                        lambda *a, **k: calls.append(1) or pytest.fail("checkpointed"))
    model, _ = _model(remat=True)
    with torch.no_grad():
        model.eval().unet(torch.zeros(1, 6, SIZE, SIZE), torch.tensor([5]))
    assert not calls


@pytest.mark.parametrize("field,value", [("remat_scope", "encoder"),
                                         ("remat_policy", "dots")])
def test_unknown_remat_scope_and_policy_raise_jax_messages(field, value):
    """The port raises what the JAX package raises for the same config
    (``cv_diffusion_tpu/models/unet.py:60, 70``), when the model is built."""
    import jax
    import jax.numpy as jnp
    from cv_diffusion_tpu.config import diffusion_config as jax_diffusion_config
    from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model

    jmodel, _ = jax_create_model(jax_diffusion_config("tiny", SIZE, remat=True,
                                                      **{field: value}))
    z = jnp.zeros((1, SIZE, SIZE, 3))
    with pytest.raises(ValueError) as jax_err:
        jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, z, z,
                                           jnp.zeros((1,), jnp.int32)))
    with pytest.raises(ValueError) as port_err:
        create_model(diffusion_config("tiny", SIZE, remat=True, **{field: value}),
                     device="cpu")
    assert str(port_err.value) == str(jax_err.value).splitlines()[0]
    # without remat the JAX package never reads them, nor does the port
    create_model(diffusion_config("tiny", SIZE, **{field: value}), device="cpu")


# --- warm starts -------------------------------------------------------------------

def _loaders():
    from cv_diffusion_tpu_torch.data.dataset import (DataLoader,
                                                     SyntheticLowLightDataset)
    images = np.random.default_rng(0).integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)
    ds = SyntheticLowLightDataset(images, image_size=SIZE, seed=0)
    return DataLoader(ds, 2, shuffle=True, drop_last=True, seed=0)


def _trainer(tmp_path, **cfg):
    model, schedule = _model(dropout=0.0)
    tc = TrainConfig(use_amp=False, epochs=1, warmup_epochs=0,
                     checkpoint_dir=str(tmp_path / "ckpt"), **cfg)
    return Trainer(model, schedule, _loaders(), config=tc)


def _assert_fresh_start(trainer, weights):
    """The model holds ``weights`` bit for bit, the EMA equals them, AdamW has
    no state, and the step and epoch are 0."""
    got = dict(trainer.model.state_dict())
    assert all(torch.equal(got[k], w) for k, w in weights.items())
    assert all(torch.equal(trainer.state.ema_params[k], got[k])
               for k in trainer.state.ema_params)
    assert not trainer.state.optimizer.state_dict()["state"]
    assert trainer.state.step == 0 and trainer.epoch == 0


def test_warm_start_from_a_weights_file(tmp_path, capsys):
    """``init_params_from`` a weights file in the port's format (the
    committed student's ``.npz`` is one): its parameters, a fresh optimizer,
    LR schedule, epoch and an EMA of the loaded weights; ``init_params_ema``
    is ignored there with the JAX package's warning."""
    weights = {k: v + 0.25 for k, v in init_weights(
        diffusion_config("tiny", SIZE, prediction_type="v_prediction"), seed=5,
        device="cpu").items()}
    path = str(tmp_path / "weights.npz")
    save_state_dict_npz(weights, path, source="test")
    trainer = _trainer(tmp_path, init_params_from=path)
    _assert_fresh_start(trainer, weights)
    assert "ignored" not in capsys.readouterr().out
    trainer = _trainer(tmp_path, init_params_from=path, init_params_ema=True)
    _assert_fresh_start(trainer, weights)
    assert "--use_ema ignored" in capsys.readouterr().out
    trainer.train_step(trainer.state, next(iter(_loaders())))
    assert trainer.state.step == 1


def test_warm_start_from_a_checkpoint_takes_its_params_or_its_ema(tmp_path):
    """From a full checkpoint written by the trainer after a step:
    ``init_params_ema`` takes its EMA, otherwise its parameters; either way
    the run starts fresh, not where the checkpoint was (that is
    ``resume_from``)."""
    source = _trainer(tmp_path)
    for batch in _loaders():
        source.state, _ = source.train_step(source.state, batch)
    path = source.save_checkpoint("warm")
    source.wait_for_checkpoints()
    raw = tckpt.load_raw(path)
    assert raw["step"] == 2
    assert not all(torch.equal(raw["params"][k], raw["ema_params"][k])
                   for k in raw["params"])
    for use_ema, key in ((False, "params"), (True, "ema_params")):
        trainer = _trainer(tmp_path, init_params_from=path, init_params_ema=use_ema)
        _assert_fresh_start(trainer, raw[key])


def test_warm_start_refuses_an_orbax_directory(tmp_path):
    """The JAX package's orbax checkpoints (directories without the port's
    ``params.npz``) cannot be read where the card is; the error says how to
    convert one."""
    with pytest.raises(ValueError, match="orbax.*torch_port_export_weights"):
        _trainer(tmp_path, init_params_from=os.path.join(REPO, "artifacts",
                                                         "vreg1b_gt03_ema"))


def test_warm_start_from_the_committed_student(tmp_path):
    """The committed student's ``.npz`` through the loader: the weights
    file's tensors bit for bit, float32."""
    path = os.path.join(REPO, "artifacts_torch", "vreg1b_gt03_ema.npz")
    got = tckpt.load_inference_params(path, use_ema=False)
    want = load_state_dict_npz(path, "cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) and got[k].dtype == torch.float32
               for k in want)


def test_train_model_maps_use_amp_and_remat(monkeypatch):
    """``train_model`` builds the bf16-compute model for ``use_amp`` and
    passes ``remat`` on, as the JAX ``train_model`` (``trainer.py:353-362``)."""
    from cv_diffusion_tpu_torch.training import trainer as ttrainer

    built = []

    class Stop(Exception):
        pass

    def fake_trainer(model, *args, **kwargs):
        built.append(model.config.unet)
        raise Stop

    from cv_diffusion_tpu_torch.data import dataset as tdataset

    monkeypatch.setattr(ttrainer, "Trainer", fake_trainer)
    monkeypatch.setattr(tdataset, "create_dataloaders",
                        lambda **kwargs: (None, None))
    for amp, remat in ((True, True), (False, False)):
        with pytest.raises(Stop):
            ttrainer.train_model("unused", config=dataclasses.replace(
                TrainConfig(unet_variant="tiny", image_size=SIZE), use_amp=amp,
                remat=remat), device="cpu")
    assert [(u.dtype, u.remat) for u in built] == [("bfloat16", True),
                                                   ("float32", False)]
