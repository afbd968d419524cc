"""One process of the port's data-parallel CPU tests (gloo).

    CVDM_COORDINATOR=localhost:PORT CVDM_NUM_PROCESSES=N CVDM_PROCESS_ID=R \\
        python tests/torch_dp_rank.py TASK DIR

joins the process group through ``parallel.distributed_init`` on the CPU,
reads ``DIR/inputs.pt`` (weights and inputs that the test made from numpy
seeds), runs TASK (``parallel``, ``train``, ``spatial`` or
``spatial_train``) and writes what it computed to ``DIR/TASK_rank{R}.pt``.
``tests/test_torch_port_parallel.py``, ``tests/test_torch_port_parallel_
train.py``, ``tests/test_torch_port_spatial.py`` and ``tests/test_torch_
port_spatial_train.py`` start the processes and hold the results against
the JAX package and the port's one-process paths. It imports nothing of
JAX.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from cv_diffusion_tpu_torch.config import TrainConfig, diffusion_config
from cv_diffusion_tpu_torch.data.dataset import shard_files_by_process
from cv_diffusion_tpu_torch.models.diffusion import create_model
from cv_diffusion_tpu_torch.ops.attention import linear_attention_sharded
from cv_diffusion_tpu_torch.parallel import (auto_mesh, distributed_init, gather,
                                             make_hybrid_mesh, make_mesh,
                                             make_sharded_sample_fn, shard_batch)
from cv_diffusion_tpu_torch.parallel.mesh import data_shard, spatial_scope
from cv_diffusion_tpu_torch.training import train_state as tts

SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(task: str, directory: str, inputs: dict, world: int = 4,
          timeout: float = 300) -> list:
    """Write ``inputs``, run ``world`` processes of TASK over a localhost
    coordinator, and return each process's results in rank order; a
    process that fails fails the caller with its output."""
    torch.save(inputs, f"{directory}/inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CVDM_COORDINATOR=f"localhost:{port}",
               CVDM_NUM_PROCESSES=str(world))
    env.pop("CVDM_DISTRIBUTED", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, directory],
        env=dict(env, CVDM_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{task} process {r} exited {p.returncode}:\n"
                               f"{logs[r][-4000:]}")
    return [torch.load(f"{directory}/{task}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def tiny(inputs, float64=False, **overrides):
    """The tiny v-prediction model at 32² on the inputs' weights (in
    float64 with ``float64``)."""
    model, schedule = create_model(diffusion_config(
        "tiny", SIZE, prediction_type="v_prediction", **overrides), device="cpu")
    model.load_state_dict(inputs["weights"], strict=True)
    return (model.double() if float64 else model), schedule


def error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def parallel_task(inputs, rank):
    out = {"meshes": {}, "errors": {}, "auto": {}, "shard": {}, "attention": {}}
    for shape in (None, (4,), (4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(shape)
        out["meshes"][shape] = (dict(mesh.shape), mesh.axis_names,
                                mesh.devices, mesh.coords())
    for name, shape in (("hybrid_ici", ((2, 2), (1, 1))),
                        ("hybrid_dcn", ((1, 2), (2, 1)))):
        mesh = make_hybrid_mesh(*shape)
        out["meshes"][name] = (dict(mesh.shape), mesh.axis_names,
                               mesh.devices, mesh.coords())
    out["errors"] = {
        "uncovered": error(lambda: make_mesh((3, 2))),
        "3d": error(lambda: make_mesh((2, 2, 1))),
        "names": error(lambda: make_mesh((4,), ("data", "spatial"))),
        "hybrid_covers": error(lambda: make_hybrid_mesh((2, 1), (1, 1))),
        "hybrid_rank": error(lambda: make_hybrid_mesh((2, 2, 2), (1, 1))),
        "init_again": distributed_init(),
    }
    for batch in (12, 6, 3, 64, 1):
        mesh = auto_mesh(batch)
        out["auto"][batch] = None if mesh is None else (dict(mesh.shape),
                                                        mesh.devices)
    for shape in ((4, 1), (2, 2)):
        out["shard"][shape] = shard_batch(make_mesh(shape), inputs["batch"])

    q, k, v = (torch.from_numpy(inputs[n]) for n in "qkv")
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape)
        n = q.shape[1] // mesh.shape["spatial"]
        j = mesh.coords()["spatial"]
        rows = slice(j * n, (j + 1) * n)
        out["attention"][shape] = linear_attention_sharded(
            q[:, rows], k[:, rows], v[:, rows], mesh).numpy()

    model, schedule = tiny(inputs)
    mesh = make_mesh()
    sampler = make_sharded_sample_fn(model, schedule, num_inference_steps=2,
                                     mesh=mesh)
    low = torch.from_numpy(inputs["low"])
    local = sampler(inputs["weights"], torch.Generator().manual_seed(5), low)
    again = sampler({"params": inputs["weights"]},
                    torch.Generator().manual_seed(5), low)
    out["serve"] = {"local": local.numpy(), "again": again.numpy(),
                    "whole": gather(mesh, local).numpy()}
    square = make_mesh((2, 2))
    sampler = make_sharded_sample_fn(model, schedule, num_inference_steps=2,
                                     mesh=square)
    local = sampler(inputs["weights"], torch.Generator().manual_seed(5), low)
    out["spatial_serve"] = {"local": local.numpy(), "graphs": dict(sampler.graphs),
                            "whole": gather(square, local).numpy()}
    out["files"] = shard_files_by_process(list(range(10)), rank, 4)
    return out


DP_CASES = ((0.0, 1), (0.1, 1), (0.1, 2))


def step_config(**kw):
    return TrainConfig(use_amp=False, epochs=2, warmup_epochs=0, **kw)


def train_task(inputs, rank):
    out = {"dp": {}}
    mesh = make_mesh()
    for dropout, accum in DP_CASES:
        model, schedule = tiny(inputs, float64=True, dropout=dropout)
        tc = step_config(grad_accum_steps=accum)
        state = tts.create_train_state(model, tc, steps_per_epoch=4)
        step = tts.make_train_step(model, schedule, tc, mesh=mesh)
        metrics = []
        for batch in inputs["train_batches"]:
            state, m = step(state, shard_batch(mesh, batch))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["dp"][(dropout, accum)] = dict(
            metrics=metrics,
            params={k: p.detach().numpy().copy()
                    for k, p in model.named_parameters()},
            ema={k: e.numpy().copy() for k, e in state.ema_params.items()})

    model, schedule = tiny(inputs, float64=True)
    tc = step_config()
    state = tts.create_train_state(model, tc, steps_per_epoch=4)
    step = tts.make_train_step(model, schedule, tc, mesh=mesh)
    batch = inputs["f64_batch"]
    draws = {"timesteps": inputs["f64_t"], "noise": inputs["f64_eps"]}
    state, m = step(state, shard_batch(mesh, batch), shard_batch(mesh, draws))
    out["f64"] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                      grads={k: p.grad.numpy().copy()
                             for k, p in model.named_parameters()})
    square = make_mesh((2, 2))
    model, schedule = tiny(inputs, float64=True)
    state = tts.create_train_state(model, tc, steps_per_epoch=4)
    step = tts.make_train_step(model, schedule, tc, mesh=square)
    state, m = step(state, shard_batch(square, batch), shard_batch(square, draws))
    out["spatial_f64"] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                              grads={k: p.grad.numpy().copy()
                                     for k, p in model.named_parameters()})

    model, schedule = tiny(inputs)
    evaluate = tts.make_eval_step(model, schedule, step_config(), mesh=mesh)
    out["eval"] = {
        name: float(evaluate(None, torch.Generator().manual_seed(7), batch,
                             inputs["n_valid"]))
        for name, batch in (("padded", inputs["eval_padded"]),
                            ("garbage", inputs["eval_garbage"]))}

    # distillation over the first two processes (all four build the mesh)
    pair = make_mesh((2,), devices=[0, 1])
    if rank in pair:
        from cv_diffusion_tpu_torch.models.distillation import (
            create_distillation_state, make_distillation_step)
        model, schedule = tiny(inputs, float64=True, dropout=0.1)
        state = create_distillation_state(model, inputs["weights"],
                                          step_config(), steps_per_epoch=4)
        step = make_distillation_step(model, schedule, canonical=True,
                                      mesh=pair)
        state, m = step(state, shard_batch(pair, inputs["distill_batch"]))
        out["distill"] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                              params={k: p.detach().numpy().copy()
                                      for k, p in model.named_parameters()})
    return out


# --- spatial sharding ----------------------------------------------------------

SPATIAL_MESHES = ((2, 2), (1, 4))
LAYER_INPUT = (2, 8, 16, 8)          # [B, C, H, W]: strips of 8 and 4 rows
TOKENS = (2, 128, 2, 32)             # [B, N, heads, D]: 64 and 32 tokens a rank
LAYERS = ("conv", "depthwise", "downsample", "upsample", "group_norm",
          "group_norm_film", "split_parts", "fold_gn", "se", "softmax",
          "linear", "fused_irb")


def spatial_layers():
    """The layers the spatial tests hold sharded against whole, float64,
    from a fixed seed: ``name → (fn, params, kind)``, ``fn`` on an NCHW
    input (``kind`` "image": an output strip of the input's strip;
    "replicated": an output every rank holds whole; "tokens": q, k, v
    [B, N, heads, D] stacked on a leading dim)."""
    from cv_diffusion_tpu_torch.models import blocks
    from cv_diffusion_tpu_torch.ops import norms
    from cv_diffusion_tpu_torch.ops.qconv import Conv2d

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * scale
                ).requires_grad_()

    def module(m):
        m = m.double()
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float64) * 0.3
                        + (1.0 if p.dim() == 1 and name.endswith("weight") else 0.0))
        return m

    b, c = LAYER_INPUT[:2]
    conv, dw = module(Conv2d(c, 6, 3, padding=1)), module(Conv2d(c, c, 3, padding=1, groups=c,
                                                                bias=False))
    down, up = module(blocks.Downsample(c)), module(blocks.Upsample(c))
    gn, se = module(blocks.GroupNorm(c)), module(blocks.SqueezeExcitation(c, 0.5, False))
    w, bias, fs, fh = rand(c), rand(c), rand(b, c, scale=0.3), rand(b, c, scale=0.3)
    wexp, s16, b16 = rand(16, c, scale=0.3), rand(16), rand(16)
    fs16, fh16 = rand(b, 16, scale=0.3), rand(b, 16, scale=0.3)
    soft = blocks.SoftmaxAttention(TOKENS[-1] ** -0.5)
    lin = blocks.LinearAttention()
    irb = module(blocks.InvertedResidualBlock(c, c, 16, expansion_ratio=2,
                                              quantization_friendly=False,
                                              use_pallas_irb=True)).eval()
    temb = rand(b, 16)
    return {
        "conv": (conv, list(conv.parameters()), "image"),
        "depthwise": (dw, list(dw.parameters()), "image"),
        "downsample": (down, list(down.parameters()), "image"),
        "upsample": (up, list(up.parameters()), "image"),
        "group_norm": (gn, list(gn.parameters()), "image"),
        "group_norm_film": (lambda x: norms.group_norm_film(x, w, bias, fs, fh, 4),
                            [w, bias, fs, fh], "image"),
        "split_parts": (lambda x: torch.cat(norms.concat_group_norm_parts(
            x[:, :3], x[:, 3:], w, bias, 4), dim=1), [w, bias], "image"),
        "fold_gn": (lambda x: torch.cat(norms.gn2_film_affine_gram(
            x, wexp, s16, b16, fs16, fh16, 4), dim=1), [wexp, s16, b16, fs16, fh16],
                    "replicated"),
        "se": (se, list(se.parameters()), "image"),
        "softmax": (lambda qkv: soft(*qkv), [], "tokens"),
        "linear": (lambda qkv: lin(*qkv), [], "tokens"),
        "fused_irb": (lambda x: irb(x, temb), [], "image"),
    }


def layer_inputs():
    """(x [B, C, H, W], qkv [3, B, N, heads, D]), float64, seeded."""
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(LAYER_INPUT, generator=gen, dtype=torch.float64),
            torch.randn((3,) + TOKENS, generator=gen, dtype=torch.float64))


def run_layer(name, x, shard=None, seed_out=2):
    """(output, d(output·w)/d input, d(output·w)/d params) of one layer of
    :func:`spatial_layers` on ``x`` (this rank's strip of it under
    ``shard``; the fused IRB, which has no backward, forward only). ``w``
    is a seeded tensor of the whole output's shape, narrowed like it; an
    output every rank holds whole is weighted by w / n on each, so that the
    ranks' losses add up to the one-process loss."""
    fn, params, kind = spatial_layers()[name]
    dim = 1 if kind == "tokens" else 2
    x = x.contiguous().requires_grad_(name != "fused_irb")
    with spatial_scope(shard):
        if name == "fused_irb":
            with torch.no_grad():
                return fn(x), None, []
        out = fn(x)
    n = 1 if shard is None else shard.size
    whole = list(out.shape)
    if kind != "replicated":
        whole[dim] *= n
    w = torch.randn(whole, generator=torch.Generator().manual_seed(seed_out),
                    dtype=torch.float64)
    if shard is not None:
        w = w / n if kind == "replicated" else strip(w, shard, dim)
    with spatial_scope(shard):
        grads = torch.autograd.grad((out * w).sum(), [x] + params, allow_unused=True)
    return out.detach(), grads[0], list(grads[1:])


def strip(t, shard, dim):
    rows = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * rows, rows)


def spatial_task(inputs, rank):
    from cv_diffusion_tpu_torch.models.diffusion import create_model

    out = {"layers": {}, "forward": {}}
    x, qkv = layer_inputs()
    for shape in SPATIAL_MESHES:
        shard = data_shard(make_mesh(shape)).spatial
        for name in LAYERS:
            kind = spatial_layers()[name][2]
            local = (strip(qkv, shard, 2) if kind == "tokens" else strip(x, shard, 2))
            y, dx, dp = run_layer(name, local, shard)
            out["layers"][(shape, name)] = dict(
                out=y.numpy(), dx=None if dx is None else dx.numpy(),
                dparams=[None if g is None else g.numpy() for g in dp])

    # the tiny UNet at 32², float32, on (1, 4): sharded, and every rank's
    # strip alone (the control)
    model, _ = tiny(inputs)
    mesh = make_mesh((1, 4))
    shard = data_shard(mesh).spatial
    noisy, low = (torch.from_numpy(inputs[k]) for k in ("noisy", "low_nchw"))
    t = torch.from_numpy(inputs["t"])
    rows = slice(shard.index * 8, (shard.index + 1) * 8)
    with torch.no_grad():
        with spatial_scope(shard):
            got = model(noisy[:, :, rows], low[:, :, rows], t)
        alone = model(noisy[:, :, rows], low[:, :, rows], t)
    out["forward"] = {"sharded": got.numpy(), "alone": alone.numpy()}
    from cv_diffusion_tpu_torch.models.diffusion import with_dtype

    with torch.no_grad(), spatial_scope(shard):
        out["forward"]["bf16"] = with_dtype(model, "bfloat16")(
            noisy[:, :, rows], low[:, :, rows], t).float().numpy()

    # the sampler on (2, 2), eager, gathered
    square = make_mesh((2, 2))
    sampler = make_sharded_sample_fn(model, _, num_inference_steps=2, mesh=square)
    local = sampler(inputs["weights"], torch.Generator().manual_seed(5),
                    torch.from_numpy(inputs["low"]))
    out["serve"] = {"local": local.numpy(), "whole": gather(square, local).numpy(),
                    "graphs": dict(sampler.graphs)}

    # dropout masks drawn for the global batch, narrowed on both axes
    from cv_diffusion_tpu_torch.models import blocks, rows as draws

    c = data_shard(square)
    ones = torch.ones(2, 3, 16, 32)
    with draws.global_batch(*c.rows(2), strips=(c.spatial.size, c.spatial.index)):
        out["dropout"] = blocks.dropout(ones, 0.5, torch.Generator().manual_seed(9)).numpy()
    return out


SPATIAL_STEP_CASES = (("dropout", dict(dropout=0.1), {}, 1),
                      ("accum", dict(dropout=0.1), dict(grad_accum_steps=2), 1),
                      ("remat", dict(dropout=0.1, remat=True), {}, 1),
                      ("qat", {}, dict(qat=True), 1))


def spatial_train_task(inputs, rank):
    from cv_diffusion_tpu_torch.export.qat import make_qat_train_step
    from cv_diffusion_tpu_torch.models.diffusion import train_forward
    from cv_diffusion_tpu_torch.training.trainer import Trainer

    out = {"steps": {}}
    mesh = make_mesh((2, 2))
    shard = data_shard(mesh)
    batch = shard_batch(mesh, inputs["batch"])
    draws = shard_batch(mesh, {"timesteps": inputs["t"], "noise": inputs["eps"]})

    # the forward through train_forward with explicit draws, both dtypes
    for name, f64 in (("float64", True), ("float32", False)):
        model, schedule = tiny(inputs, float64=f64)
        dt = torch.float64 if f64 else torch.float32
        low, normal = (torch.from_numpy(batch[k]).to(dt) for k in ("low_light", "normal_light"))
        with torch.no_grad(), tts.shard_rows(shard, low.shape[0]):
            res = train_forward(model, schedule, low, normal,
                                timesteps=torch.from_numpy(draws["timesteps"]),
                                noise=torch.from_numpy(draws["noise"]).to(dt), train=False)
        out[name] = res["noise_pred"].numpy()

    # train steps, float64, two each
    for label, model_kw, config_kw, _ in SPATIAL_STEP_CASES:
        model, schedule = tiny(inputs, float64=True, **model_kw)
        tc = step_config(**config_kw)
        state = tts.create_train_state(model, tc, steps_per_epoch=4)
        make = make_qat_train_step if label == "qat" else tts.make_train_step
        step = make(model, schedule, tc, mesh=mesh)
        metrics = []
        for b in inputs["train_batches"]:
            state, m = step(state, shard_batch(mesh, b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["steps"][label] = dict(
            metrics=metrics,
            params={k: p.detach().numpy().copy() for k, p in model.named_parameters()},
            ema={k: e.numpy().copy() for k, e in state.ema_params.items()})

    # one step with explicit draws, its loss against JAX's
    model, schedule = tiny(inputs, float64=True)
    tc = step_config()
    state = tts.create_train_state(model, tc, steps_per_epoch=4)
    state, m = tts.make_train_step(model, schedule, tc, mesh=mesh)(state, batch, draws)
    out["explicit"] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]))

    # the eval step on a padded ragged batch
    model, schedule = tiny(inputs, float64=True)
    evaluate = tts.make_eval_step(model, schedule, step_config(), mesh=mesh)
    out["eval"] = float(evaluate(None, torch.Generator().manual_seed(7),
                                 inputs["eval_padded"], inputs["n_valid"]))

    # one Trainer step on mesh_shape (2, 2) and its gathered sample grid
    model, schedule = tiny(inputs, float64=True)
    tc = step_config(mesh_shape=(2, 2), batch_size=8, num_samples=4,
                     async_checkpoints=False,
                     output_dir=f"{inputs['dir']}/out{rank}",
                     checkpoint_dir=f"{inputs['dir']}/ck{rank}")
    trainer = Trainer(model, schedule, [inputs["train_batches"][0]],
                      [inputs["train_batches"][1]], tc)
    loss = trainer.train_epoch()
    grid = trainer.generate_samples(0)
    out["trainer"] = dict(loss=loss, spatial=trainer.spatial, grid=grid,
                          params={k: p.detach().numpy().copy()
                                  for k, p in model.named_parameters()})
    return out


def main(task: str, directory: str) -> None:
    torch.set_num_threads(1)
    assert distributed_init(device="cpu")
    rank = torch.distributed.get_rank()
    inputs = torch.load(f"{directory}/inputs.pt", weights_only=False)
    out = {"parallel": parallel_task, "train": train_task, "spatial": spatial_task,
           "spatial_train": spatial_train_task}[task](inputs, rank)
    torch.save(out, f"{directory}/{task}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
