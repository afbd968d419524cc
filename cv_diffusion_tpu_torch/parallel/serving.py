"""Data-parallel serving: every process samples its block of a global batch.

Counterpart of ``cv_diffusion_tpu/parallel/serving.py``. The JAX package
jits the sampler once over the mesh, parameters replicated and the batch
sharded over ``(data, spatial)``, and XLA keeps every data row's sampler
independent. Here every process runs the same sampler body on its rows of
the batch (and, with a spatial axis, its strip of image rows of each),
through the hand-written kernels. The noise is drawn for the global batch
from the caller's generator and each process takes its block, so the
output does not depend on the number of processes. On a data-only mesh the
sampler issues no collective and runs on a CUDA device as one CUDA graph a
batch size (``export.serving.SamplerGraph``, as ``ServingPipeline``
serves); with a spatial axis its layers exchange rows over the spatial
group (``parallel.halo``) and it runs eagerly. :func:`gather` assembles the
whole output afterwards, outside any captured graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..export.quantization import load_act_scales
from ..export.serving import SamplerGraph
from ..models import rows
from ..models.diffusion import LowLightDiffusion, run_sampler, sampler_noise
from ..models.scheduler import LCMSchedule, lcm_timesteps
from .mesh import (DATA_AXIS, SPATIAL_AXIS, DataShard, Mesh, all_gather_rows,
                   data_shard, make_mesh, refuse_spatial_model, spatial_scope)


def sample_block(model: LowLightDiffusion, schedule: LCMSchedule,
                 grid: Sequence[int], shard: DataShard,
                 generator: torch.Generator, low_light: torch.Tensor, *,
                 deterministic: bool = False, params=None) -> torch.Tensor:
    """This process's block (rows of the batch, and its strip of image rows
    under a spatial shard) of the sampler's output on the global batch
    ``low_light`` [B, H, W, 3], whole on every process, run eagerly on the
    model's device; the noise drawn for the global batch from
    ``generator``. ``params`` replaces the module's parameters."""
    device = next(model.parameters()).device
    total, height, width = low_light.shape[:3]
    if total % shard.size:
        raise ValueError(f"a batch of {total} does not split over a data "
                         f"axis of {shard.size}")
    local, spatial = total // shard.size, shard.spatial
    _, start, stop = shard.rows(local)
    strips, h0, h1 = None, 0, height
    if spatial is not None:
        spatial.check_height(height, len(model.config.unet.channels))
        strips = (spatial.size, spatial.index)
        _, h0, h1 = spatial.rows(height // spatial.size)
    low = torch.as_tensor(low_light)[start:stop, h0:h1].to(device, torch.float32)
    with rows.global_batch(total, start, stop, strips=strips):
        noise = sampler_noise(generator, (local, h1 - h0, width, 3), len(grid), device)
    with spatial_scope(spatial):
        return run_sampler(model, schedule, low, *noise, grid,
                           deterministic=deterministic, params=params).float()


class ShardedSampler:
    """``sampler(params_or_variables, generator, low_light) → this process's
    block of the enhanced batch`` (float32 [B/n, H/s, W, 3]: its rows of
    the batch, and under a spatial axis of s ranks its strip of image
    rows).

    ``low_light`` is the global batch [B, H, W, 3] in [-1, 1], whole on
    every process, B divisible by the data axis's size n (and H, with a
    spatial axis, by s·2^(levels−1): ``ValueError`` otherwise). The
    parameters (a bare state dict, or ``{"params": ..., "act_scales":
    ...}`` as an ``int8_act`` package holds them) are copied into ``model``
    when a call brings another dict than the last one did, so a captured
    graph keeps reading the module's own tensors. ``graphs`` holds one
    :class:`~..export.serving.SamplerGraph` per local batch size (CUDA, a
    data-only mesh). With a spatial axis of more than one rank the sampler
    runs eagerly and ``graphs`` stays empty: its layers' gloo collectives
    cannot be captured in a CUDA graph (capture under NCCL is ROADMAP item
    8c); it still runs on the card, through the kernels. An ``act_quant``
    model raises ``NotImplementedError`` there (8c)."""

    def __init__(self, model: LowLightDiffusion, schedule: LCMSchedule,
                 grid: Sequence[int], mesh: Mesh, deterministic: bool = False):
        # eval mode once, as ServingPipeline sets it: Module.eval() walks
        # every submodule on the host
        self.model = model.eval()
        self.schedule = schedule
        self.grid = [int(t) for t in grid]
        self.mesh = mesh
        refuse_spatial_model(mesh, model)
        self.shard = data_shard(mesh)
        self.deterministic = deterministic
        self.device = next(model.parameters()).device
        self.graphs: Dict[int, SamplerGraph] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._loaded = None

    def _load(self, params) -> None:
        if params is self._loaded:
            return
        variables = params if "params" in params else {"params": params}
        self.model.load_state_dict(variables["params"], strict=True)
        if "act_scales" in variables:
            load_act_scales(self.model, variables["act_scales"])
        self._loaded = params

    def _body(self, low: torch.Tensor, init_noise: torch.Tensor,
              step_noise: torch.Tensor) -> torch.Tensor:
        return run_sampler(self.model, self.schedule, low, init_noise,
                           step_noise, self.grid,
                           deterministic=self.deterministic).float()

    @torch.inference_mode()
    def __call__(self, params, generator: torch.Generator,
                 low_light: torch.Tensor) -> torch.Tensor:
        self._load(params)
        if self.device.type != "cuda" or self.shard.spatial is not None:
            return sample_block(self.model, self.schedule, self.grid, self.shard,
                                generator, low_light, deterministic=self.deterministic)
        total, height, width = low_light.shape[:3]
        if total % self.shard.size:
            raise ValueError(f"a batch of {total} does not split over a data "
                             f"axis of {self.shard.size}")
        local = total // self.shard.size
        _, start, stop = self.shard.rows(local)
        low = torch.as_tensor(low_light)[start:stop].to(self.device,
                                                        torch.float32)
        with rows.global_batch(total, start, stop):
            noise = sampler_noise(generator, (local, height, width, 3),
                                  len(self.grid), self.device)
        if height != width:
            raise ValueError(f"the CUDA graph samples square batches, not "
                             f"{height}x{width}")
        if local not in self.graphs:
            self.graphs[local] = SamplerGraph(
                self._body, local, height, len(self.grid), self.device,
                self._pool, in_dtype=torch.float32)
        return self.graphs[local].replay(low, *noise).clone()


def make_sharded_sample_fn(model: LowLightDiffusion, schedule: LCMSchedule,
                           num_inference_steps: int = 4,
                           mesh: Optional[Mesh] = None, *,
                           deterministic: bool = False,
                           timesteps: Optional[Sequence[int]] = None
                           ) -> ShardedSampler:
    """The data-parallel sampler of ``model`` over ``mesh`` (default: every
    process on the data axis), on the stock grid of
    ``num_inference_steps`` or on ``timesteps`` (JAX
    ``make_sharded_sample_fn``); :class:`ShardedSampler` says what it
    takes and returns."""
    if mesh is None:
        mesh = make_mesh()
    grid = (list(timesteps) if timesteps is not None else lcm_timesteps(
        num_inference_steps, schedule.config.num_train_timesteps,
        schedule.config.original_inference_steps))
    return ShardedSampler(model, schedule, grid, mesh, deterministic)


def gather(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every process's block, in rank order: the strips of image rows
    (dim 1) over the spatial axis, then the rows (dim 0) over the data
    axis: the whole batch (a collective: every process of the mesh calls
    it)."""
    group = mesh.group(SPATIAL_AXIS)
    if group is not None:
        local = all_gather_rows(local.movedim(1, 0).contiguous(), group).movedim(0, 1)
    return all_gather_rows(local.contiguous(), mesh.group(DATA_AXIS))
