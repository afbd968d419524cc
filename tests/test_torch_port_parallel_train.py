"""The port's data-parallel training on the CPU, against its one-process
steps and the JAX package's step on its 8-device virtual mesh.

Four processes of the port (``tests/torch_dp_rank.py``, gloo, started once
for the module) take data-parallel train steps of the tiny UNet at 32²
(global batch 8, two rows a process; dropout 0 and 0.1, and
``grad_accum_steps=2``), one in float64 with explicit t and ε, a ragged
eval and, over the first two processes, a distillation step. The train
and distillation steps are compared in float64: in float32 a one-process
step at 8 rows and four at 2 round the gradients of this UNet on random
weights ~1e-3 apart (``test_torch_port_training.py`` says why), and
AdamW's first update, ±lr·sign(g), turns that into 2·lr where a gradient
near 0 changes sign. ``python -m cv_diffusion_tpu_torch.train
--distributed`` runs under ``torch.distributed.run`` at two processes.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cv_diffusion_tpu.models import diffusion as jdiffusion
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.parallel import mesh as jmesh
from cv_diffusion_tpu_torch import parallel as tpar
from cv_diffusion_tpu_torch.config import diffusion_config
from cv_diffusion_tpu_torch.data import dataset as tdataset
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.models.distillation import (
    create_distillation_state, make_distillation_step)
from cv_diffusion_tpu_torch.parallel import pad_batch
from cv_diffusion_tpu_torch.training import checkpoint as tckpt
from cv_diffusion_tpu_torch.training import train_state as tts
from cv_diffusion_tpu_torch.training.trainer import DistillationTrainer, Trainer
from cv_diffusion_tpu_torch.weights import init_weights, state_dict_from_jax

import torch_dp_rank
from torch_dp_rank import DP_CASES, step_config, tiny
from test_torch_port_training import _flat_port
from test_torch_port_weights import (jax_in_float64, one_torch_thread,  # noqa: F401
                                     random_jax_params)

WORLD = 4
SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"low_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
            "normal_light": rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    """JAX config, port config and random weights (perturbed norms) of the
    tiny v-prediction UNet at 32²."""
    return random_jax_params("tiny", SIZE, seed=11)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """(inputs, each process's results) of the ``train`` task."""
    _, tcfg, params = case
    rng = np.random.default_rng(5)
    padded, n_valid = pad_batch(_batch(5, 30), 8)
    garbage = {k: v.copy() for k, v in padded.items()}
    for v in garbage.values():
        v[n_valid:] = 97.0
    inputs = dict(
        weights=state_dict_from_jax(params, tcfg),
        train_batches=[_batch(8, 20), _batch(8, 21)],
        f64_batch=_batch(8, 22),
        f64_t=rng.integers(0, 1000, 8).astype(np.int32),
        f64_eps=rng.standard_normal((8, SIZE, SIZE, 3)),
        eval_padded=padded, eval_garbage=garbage, n_valid=n_valid,
        distill_batch=_batch(4, 23))
    directory = str(tmp_path_factory.mktemp("dp_train"))
    return inputs, torch_dp_rank.spawn("train", directory, inputs, WORLD)


def _micro_major(batch, accum, world=WORLD):
    """The global batch in the order the DP step accumulates it: micro-batch
    i is every process's local rows [i·b/k, (i+1)·b/k), process by process
    (each process holds rows [r·b, (r+1)·b) of ``batch``)."""
    n = len(batch["low_light"])
    local, micro = n // world, n // world // accum
    order = [r * local + i * micro + j for i in range(accum)
             for r in range(world) for j in range(micro)]
    return {k: v[order] for k, v in batch.items()}


@pytest.mark.parametrize("dropout,accum", DP_CASES)
def test_dp_train_step_matches_one_process(ranks, dropout, accum,
                                           one_torch_thread):  # noqa: F811
    """Two DP steps at four processes against the port's one-process step
    at the global batch of 8, in float64: the loss and gradient norm of
    each step (rel 1e-5), the parameters and EMA after (atol 2e-6, the
    bounds of ``test_parallel.py:97-100``), and every process's parameters
    the same bits. With ``grad_accum_steps=2`` the one-process step takes
    the batch micro-major (:func:`_micro_major`)."""
    inputs, results = ranks
    model, schedule = tiny(inputs, float64=True, dropout=dropout)
    tc = step_config(grad_accum_steps=accum)
    state = tts.create_train_state(model, tc, steps_per_epoch=4)
    step = tts.make_train_step(model, schedule, tc)
    got = results[0]["dp"][(dropout, accum)]
    for batch, (loss, norm) in zip(inputs["train_batches"], got["metrics"]):
        state, m = step(state, _micro_major(batch, accum))
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=1e-5)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["params"][k], p.detach().numpy(),
                                   atol=2e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["ema"][k], state.ema_params[k].numpy(),
                                   atol=2e-6, rtol=0, err_msg=k)
    for res in results[1:]:
        other = res["dp"][(dropout, accum)]
        assert other["metrics"] == got["metrics"]
        assert all(np.array_equal(other["params"][k], v)
                   for k, v in got["params"].items())


@pytest.fixture(scope="module")
def jax_mesh_step(case, ranks):
    """Loss, gradient norm and gradients (the port's names and layouts) of
    the JAX package's train loss in float64 on ``make_mesh((8, 1))``: the
    params replicated, the batch, t and ε sharded over data."""
    jcfg, tcfg, params = case
    inputs, _ = ranks
    jcfg64 = dataclasses.replace(
        jcfg, unet=dataclasses.replace(jcfg.unet, dtype="float64"))
    monkeypatch = pytest.MonkeyPatch()
    with jax_in_float64(monkeypatch, extra=(jdiffusion,)):
        jmodel, jschedule = jax_create_model(jcfg64)
        mesh = jmesh.make_mesh((8, 1))
        repl, data = jmesh.replicated_sharding(mesh), jmesh.batch_sharding(mesh)

        def jloss(p, batch, t, eps):
            out = jdiffusion.train_forward(
                jmodel, jschedule, {"params": p}, jax.random.key(0),
                batch["low_light"], batch["normal_light"], timesteps=t,
                noise=eps)
            return jdiffusion.diffusion_loss(out["noise_pred"], out["target"])

        grad = jax.jit(jax.value_and_grad(jloss),
                       in_shardings=(repl, {"low_light": data,
                                            "normal_light": data},
                                     jmesh.NamedSharding(mesh, jmesh.P("data")),
                                     data))
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        batch = {k: jnp.asarray(v, jnp.float64)
                 for k, v in inputs["f64_batch"].items()}
        loss, grads = grad(p, batch, jnp.asarray(inputs["f64_t"]),
                           jnp.asarray(inputs["f64_eps"], jnp.float64))
        out = dict(loss=float(loss), norm=float(optax.global_norm(grads)),
                   grads=_flat_port(jax.tree.map(np.asarray, grads), tcfg,
                                    monkeypatch))
    monkeypatch.undo()
    return out


def test_dp_train_step_matches_jax_mesh_in_float64(ranks, jax_mesh_step):
    """The port's DP step at four processes with explicit t and ε against
    JAX's loss and gradients on its 8-device mesh, both in float64: loss
    and clipped gradients at 1e-9 (``test_torch_port_training.py``'s
    float64 bound), the gradient norm before the clip at rel 1e-9."""
    _, results = ranks
    ref = jax_mesh_step
    scale = min(1.0, step_config().gradient_clip / ref["norm"])
    for res in results:
        got = res["f64"]
        np.testing.assert_allclose(got["loss"], ref["loss"], atol=1e-9, rtol=0)
        np.testing.assert_allclose(got["norm"], ref["norm"], rtol=1e-9)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g * scale, atol=1e-9,
                                       rtol=0, err_msg=k)


def test_ragged_eval_over_the_mesh(ranks, one_torch_thread):  # noqa: F811
    """A batch of 5 padded to 8: the eval step over four processes equals
    the one-process eval (rel 1e-5, ``test_parallel.py:207-235``), every
    process gets the same loss, and garbage in the padded rows changes
    nothing."""
    inputs, results = ranks
    model, schedule = tiny(inputs)
    evaluate = tts.make_eval_step(model, schedule, step_config())
    ref = float(evaluate(None, torch.Generator().manual_seed(7),
                         inputs["eval_padded"], inputs["n_valid"]))
    for res in results:
        assert res["eval"]["padded"] == results[0]["eval"]["padded"]
        assert res["eval"]["padded"] == pytest.approx(ref, rel=1e-5)
        assert res["eval"]["garbage"] == pytest.approx(ref, rel=1e-5)


def test_distillation_step_at_two_processes_matches_one(ranks,
                                                        one_torch_thread):  # noqa: F811
    """One consistency-distillation step (canonical pairs, dropout 0.1) over
    the first two processes, two rows each, against one process at the
    batch of 4, in float64: loss and gradient norm (rel 1e-9), the student
    after it (atol 1e-9)."""
    inputs, results = ranks
    model, schedule = tiny(inputs, float64=True, dropout=0.1)
    state = create_distillation_state(model, inputs["weights"], step_config(),
                                      steps_per_epoch=4)
    step = make_distillation_step(model, schedule, canonical=True)
    state, m = step(state, inputs["distill_batch"])
    assert "distill" not in results[2] and "distill" not in results[3]
    for res in results[:2]:
        got = res["distill"]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-9)
        np.testing.assert_allclose(got["norm"], float(m["grad_norm"]), rtol=1e-9)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(got["params"][k], p.detach().numpy(),
                                       atol=1e-9, rtol=0, err_msg=k)


def test_spatial_axis_train_step_runs(ranks):
    """The float64 step with explicit t and ε on a (2, 2) mesh (a spatial
    axis of two processes, which the port once refused): its loss, gradient
    norm and gradients equal the data-parallel step's on (4, 1) within
    1e-9 (``test_torch_port_spatial_train.py`` holds the spatial paths to
    JAX and to one process)."""
    _, results = ranks
    for res in results:
        got, want = res["spatial_f64"], res["f64"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-9, rtol=0)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-9)
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, atol=1e-9, rtol=0, err_msg=k)


def test_spatial_axis_refuses_by_name(ranks):
    """What a spatial axis of more than one process does not run names
    ROADMAP item 8c: activation-aware QAT (the train step, the QAT step and
    the trainer with ``qat_act``), the distillation steps and
    ``DistillationTrainer``; a data-only mesh that leaves this process out
    raises ``ValueError``."""
    from cv_diffusion_tpu_torch.export.qat import make_qat_train_step

    inputs, _ = ranks
    model, schedule = tiny(inputs)
    mesh = tpar.make_mesh((1, 2), devices=[0, 1])
    tc = step_config(qat_act=True)
    for make in (lambda: tts.make_train_step(model, schedule, tc, mesh=mesh),
                 lambda: make_qat_train_step(model, schedule, tc, mesh=mesh),
                 lambda: Trainer(model, schedule, [None], config=tc, mesh=mesh),
                 lambda: make_distillation_step(model, schedule, mesh=mesh),
                 lambda: DistillationTrainer(model, schedule, inputs["weights"],
                                             [None], config=step_config(), mesh=mesh)):
        with pytest.raises(NotImplementedError, match="item 8c"):
            make()
    with pytest.raises(ValueError, match="not in"):
        tts.make_train_step(model, schedule, step_config(),
                            mesh=tpar.make_mesh((2,), devices=[1, 2]))


def _lol(root, n=8):
    rng = np.random.default_rng(9)
    for sub in ("low", "high"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        high = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
        png.write_png(root / "high" / f"{i:02d}.png", high)
        png.write_png(root / "low" / f"{i:02d}.png", (high // 4).astype(np.uint8))
    return root


def _rank_loaders(monkeypatch, root, config, world):
    """Each process's train loader as ``train_model`` makes it in a process
    group of ``world``."""
    import torch.distributed as dist

    loaders = []
    for rank in range(world):
        with monkeypatch.context() as patch:
            patch.setattr(dist, "is_initialized", lambda: True)
            patch.setattr(dist, "get_world_size", lambda: world)
            patch.setattr(dist, "get_rank", lambda: rank)
            loaders.append(tdataset.create_dataloaders(
                str(root), None, batch_size=config.batch_size,
                image_size=config.image_size, seed=config.seed,
                native=config.native_loader, prefetch=0, device="cpu")[0])
    return loaders


def test_train_cli_distributed_two_processes(tmp_path, monkeypatch,
                                             one_torch_thread):  # noqa: F811
    """``CVDM_DISTRIBUTED=1 python -m torch.distributed.run
    --nproc_per_node 2 -m cv_diffusion_tpu_torch.train --distributed`` on
    a LOL-style directory of 8 pairs, one epoch at batch 2 a process: each
    process trains on its shard of the files; process 0 alone writes the
    sample grid and the one checkpoint (``final_model.pt``). Its weights
    and EMA equal a one-process ``Trainer``'s on the global batches (each
    process's batch, process 0's rows first) up to AdamW's sign rule: its
    first update is ±lr·sign(g) and float32 gradients summed in another
    order may change the sign of one near 0, which moves that parameter by
    at most 2·lr over the two steps, and only a few do; the rest agree to
    1e-6."""
    root = _lol(tmp_path / "lol")
    args = ["--data_dir", str(root), "--val_dir", "none", "--variant", "tiny",
            "--image_size", str(SIZE), "--epochs", "1", "--batch_size", "2",
            "--device", "cpu", "--no_amp", "--save_interval", "100",
            "--output_dir", str(tmp_path / "out"),
            "--checkpoint_dir", str(tmp_path / "ck")]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CVDM_DISTRIBUTED="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(port),
         "-m", "cv_diffusion_tpu_torch.train", "--distributed"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ck")) == ["final_model.pt"]
    assert os.listdir(tmp_path / "out") == ["samples_epoch_0.png"]
    assert proc.stdout.count("Starting training") == 1

    from cv_diffusion_tpu_torch import train as tcli
    from cv_diffusion_tpu_torch.models.diffusion import create_model

    config = tcli.resolve_config(tcli.build_parser().parse_args(args), args)[0]
    config = dataclasses.replace(config, async_checkpoints=False,
                                 output_dir=str(tmp_path / "out1"),
                                 checkpoint_dir=str(tmp_path / "ck1"))
    loaders = _rank_loaders(monkeypatch, root, config, 2)
    model_cfg = diffusion_config("tiny", SIZE, dtype="float32")
    init = init_weights(model_cfg, seed=config.seed, device="cpu")
    saved = tckpt.load_raw(str(tmp_path / "ck" / "final_model.pt"))
    assert saved["step"] == 2
    bound = 2 * config.learning_rate * 2 + 1e-6

    def share_apart(order):
        """The share of parameter and EMA elements more than 1e-6 from a
        one-process Trainer's on the global batches with the processes'
        rows in ``order``; each within ``bound``."""
        batches = [{k: np.concatenate([pair[r][k] for r in order])
                    for k in ("low_light", "normal_light")}
                   for pair in zip(*loaders)]
        assert len(batches) == 2 and len(batches[0]["low_light"]) == 4
        model, schedule = create_model(model_cfg, device="cpu")
        model.load_state_dict(init, strict=True)
        trainer = Trainer(model, schedule, batches, None, config)
        trainer.train_epoch()
        far = total = 0
        for name, want in (("params", dict(model.named_parameters())),
                           ("ema_params", trainer.state.ema_params)):
            for k, w in want.items():
                diff = np.abs(saved[name][k].numpy() - w.detach().numpy())
                assert diff.max() <= bound, (name, k, diff.max())
                far += int((diff > 1e-6).sum())
                total += diff.size
        return far / total

    assert share_apart((0, 1)) < 0.01
    assert share_apart((1, 0)) > 0.1        # the other global row order
    moved = sum(int((saved["params"][k] != init[k]).sum()) for k in init)
    assert moved > 0.9 * sum(v.numel() for v in init.values())
