"""One process of the port's data-parallel CPU tests (gloo).

    CVDM_COORDINATOR=localhost:PORT CVDM_NUM_PROCESSES=N CVDM_PROCESS_ID=R \\
        python tests/torch_dp_rank.py TASK DIR

joins the process group through ``parallel.distributed_init`` on the CPU,
reads ``DIR/inputs.pt`` (weights and inputs that the test made from numpy
seeds), runs TASK (``parallel`` or ``train``) and writes what it computed
to ``DIR/TASK_rank{R}.pt``. ``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_parallel_train.py`` start the processes and hold
the results against the JAX package and the port's one-process paths. It
imports nothing of JAX.
"""

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


def main(task: str, directory: str) -> None:
    torch.set_num_threads(1)
    assert distributed_init(device="cpu")
    rank = torch.distributed.get_rank()
    inputs = torch.load(f"{directory}/inputs.pt", weights_only=False)
    out = {"parallel": parallel_task, "train": train_task}[task](inputs, rank)
    torch.save(out, f"{directory}/{task}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
