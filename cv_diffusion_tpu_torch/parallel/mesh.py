"""Process groups, meshes of named axes over the ranks, and batch sharding.

Counterpart of ``cv_diffusion_tpu/parallel/mesh.py``. The JAX package runs
one program over a mesh of devices and lets XLA insert the collectives; the
port runs one process per GPU (``torch.distributed``), and a :class:`Mesh`
lays the ranks of the process group out on named axes with a process
subgroup per axis, through which the port's data-parallel paths reduce.

Axes:
  * ``data``    — the batch axis (pure data parallelism);
  * ``spatial`` — the image-height axis: rank i of it holds image rows
    [i·H/n, (i+1)·H/n) of every image of its data block. The UNet's layers
    read this process's place on it (:class:`SpatialShard`, opened by
    :func:`spatial_scope`) and exchange what crosses the strips through
    ``parallel.halo``, where XLA's partitioner inserts the exchanges in the
    JAX package.

A rank takes ``cuda:LOCAL_RANK`` (:func:`local_device`). Ranks are laid
out host-major, as ``torch.distributed.run`` numbers them, so the blocks of
:func:`make_hybrid_mesh` are hosts when its ICI grid is a host's GPUs.
"""

from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MESH_GROUP = "mesh"         # the key of the subgroup of every rank of a mesh

_NEEDS_IDS = ("distributed_init: a coordinator address requires "
              "num_processes and process_id (as args or "
              "CVDM_NUM_PROCESSES / CVDM_PROCESS_ID env vars)")


def initialized() -> bool:
    """Whether this process is in a ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(processes, this process's rank): (1, 0) outside a process group."""
    if initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_device(device="cuda") -> torch.device:
    """The device this process computes on: ``cuda:LOCAL_RANK`` for a CUDA
    ``device`` given without an index (``LOCAL_RANK`` as
    ``torch.distributed.run`` sets it, else the rank modulo the GPUs
    present), else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else world()[1] % torch.cuda.device_count())
    return torch.device("cuda", index)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda", backend: Optional[str] = None) -> bool:
    """Start this process's ``torch.distributed`` process group (JAX
    ``distributed_init``, ``mesh.py:33-80``):

    * explicit args, or the ``CVDM_COORDINATOR`` (``host:port``) /
      ``CVDM_NUM_PROCESSES`` / ``CVDM_PROCESS_ID`` env vars, start it with
      ``tcp://`` init at the coordinator;
    * ``CVDM_DISTRIBUTED=1`` with no coordinator reads what
      ``torch.distributed.run`` sets: ``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR`` and ``MASTER_PORT`` (JAX's TPU-pod auto-detection);
    * otherwise it is a no-op that returns False.

    Idempotent: True once a group exists. The backend is ``backend``, else
    ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU; on CUDA the
    process's current device becomes :func:`local_device`. A failed init
    raises; no other backend is tried.
    """
    if initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("CVDM_COORDINATOR"))
    auto = os.environ.get("CVDM_DISTRIBUTED", "0") == "1"
    if coordinator_address is None and not auto:
        return False
    if coordinator_address is not None:
        if num_processes is None:
            if os.environ.get("CVDM_NUM_PROCESSES") is None:
                raise ValueError(_NEEDS_IDS)
            num_processes = int(os.environ["CVDM_NUM_PROCESSES"])
        if process_id is None:
            if os.environ.get("CVDM_PROCESS_ID") is None:
                raise ValueError(_NEEDS_IDS)
            process_id = int(os.environ["CVDM_PROCESS_ID"])
        address = coordinator_address
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError("distributed_init: CVDM_DISTRIBUTED=1 reads "
                             "torch.distributed.run's environment, which "
                             f"lacks {missing}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: a CUDA device asked for, but "
                               "CUDA is not available")
        if dev.index is None:
            # the rank is not known yet: local_device falls back to it
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None else
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    return True


class Mesh:
    """Named axes over ranks (JAX ``jax.sharding.Mesh`` over devices).

    ``devices`` is the array of ranks, its shape the mesh's; ``shape`` maps
    each axis name to its size. In a process group the mesh holds one
    process subgroup per line of ranks along each axis of more than one
    rank (the whole group's when a line is all of it): :meth:`group` is
    this process's. Every process of the group must build the same meshes
    in the same order, as ``torch.distributed.new_group`` requires. Outside
    a group a mesh is a layout only (no subgroups)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self._groups: Dict[str, object] = {}
        if initialized():
            n = dist.get_world_size()
            if self.devices.max() >= n:
                raise ValueError(f"mesh of ranks {self.devices.ravel().tolist()} "
                                 f"in a process group of {n}")
            me = dist.get_rank()
            for i, axis in enumerate(self.axis_names):
                if self.shape[axis] == 1:
                    continue
                lines = np.moveaxis(self.devices, i, -1).reshape(
                    -1, self.shape[axis])
                for line in lines:
                    ranks = [int(r) for r in line]
                    group = (dist.group.WORLD if sorted(ranks) == list(range(n))
                             else dist.new_group(ranks=ranks))
                    if me in ranks:
                        self._groups[axis] = group
            # every rank of the mesh: the one axis's line, or a group of its own
            split = [a for a in self.axis_names if self.shape[a] > 1]
            if len(split) == 1:
                if split[0] in self._groups:
                    self._groups[MESH_GROUP] = self._groups[split[0]]
            elif split:
                ranks = sorted(int(r) for r in self.devices.ravel())
                group = (dist.group.WORLD if ranks == list(range(n))
                         else dist.new_group(ranks=ranks))
                if me in ranks:
                    self._groups[MESH_GROUP] = group

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, ranks={self.devices.tolist()})"

    @property
    def rank(self) -> int:
        """This process's rank (0 outside a process group)."""
        return world()[1]

    def __contains__(self, rank: int) -> bool:
        return bool((self.devices == rank).any())

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(rank).get(axis, 0)

    def axis_ranks(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The ranks of ``rank``'s line along ``axis``, in axis order."""
        c = self.coords(rank)
        index = tuple(slice(None) if a == axis else c[a] for a in self.axis_names)
        return [int(r) for r in np.ravel(self.devices[index])]

    def group(self, axis: str):
        """This process's subgroup along ``axis`` (``MESH_GROUP``: every
        rank of the mesh); None when it has one rank (nothing to reduce) or
        outside a process group."""
        return self._groups.get(axis)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Optional[Tuple[str, ...]] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``devices`` (ranks; default: every rank of the group, or
    rank 0 alone outside one), all on the data axis by default. Names come
    from the shape's rank when not given: ``('data',)`` for 1-D,
    ``('data', 'spatial')`` for 2-D (JAX ``make_mesh``, errors included)."""
    if devices is None:
        devices = list(range(world()[0]))
    n = len(devices)
    if axis_names is None:
        axis_names = (DATA_AXIS, SPATIAL_AXIS)
        if shape is not None:
            if len(shape) > 2:
                raise ValueError(
                    f"pass axis_names explicitly for {len(shape)}-D meshes")
            axis_names = axis_names[:len(shape)]
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but "
                         f"axis_names {axis_names} has {len(axis_names)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def make_hybrid_mesh(ici_shape: Tuple[int, ...], dcn_shape: Tuple[int, ...],
                     axis_names: Tuple[str, ...] = (DATA_AXIS, SPATIAL_AXIS)
                     ) -> Mesh:
    """A mesh whose ``dcn_shape`` grid is of blocks of ``prod(ici_shape)``
    consecutive ranks, each block laid out as ``ici_shape`` (JAX
    ``make_hybrid_mesh``): with host-major ranks and the ICI grid a host's
    GPUs, the blocks are hosts, whose traffic crosses the network, and
    each axis has ``ici_shape[i] * dcn_shape[i]`` ranks, the block index
    outermost. Keep the data axis on the network and a spatial axis inside
    a host. An all-ones ``dcn_shape`` is a plain mesh of ``ici_shape``."""
    n = world()[0]
    if not (len(ici_shape) == len(dcn_shape) == len(axis_names)):
        raise ValueError(
            f"ici_shape {ici_shape}, dcn_shape {dcn_shape} and axis_names "
            f"{axis_names} must have equal rank")
    total = int(np.prod([i * d for i, d in zip(ici_shape, dcn_shape)]))
    if total != n:
        raise ValueError(
            f"hybrid mesh {ici_shape} x {dcn_shape} covers {total} devices "
            f"but {n} are available")
    k = len(ici_shape)
    ranks = np.arange(n).reshape(tuple(dcn_shape) + tuple(ici_shape))
    # (d0, ..., dk, i0, ..., ik) -> (d0, i0, d1, i1, ...)
    order = [j for pair in zip(range(k), range(k, 2 * k)) for j in pair]
    ranks = ranks.transpose(order).reshape(
        [i * d for i, d in zip(ici_shape, dcn_shape)])
    return Mesh(ranks, axis_names)


def auto_mesh(batch_size: int) -> Optional[Mesh]:
    """The largest data-parallel mesh whose size divides ``batch_size``:
    max d ≤ processes with ``batch_size % d == 0``, not gcd (JAX
    ``auto_mesh``), over ranks 0 … d−1; None when that is one rank."""
    n = world()[0]
    d = max((k for k in range(1, min(n, batch_size) + 1)
             if batch_size % k == 0), default=1)
    if d <= 1:
        return None
    return make_mesh((d, 1), devices=list(range(d)))


@dataclass(frozen=True)
class NamedSharding:
    """How a leaf is split over a mesh: ``spec[i]`` names the axis that dim
    i is split over (JAX ``NamedSharding`` with a ``PartitionSpec``)."""

    mesh: Mesh
    spec: Tuple[str, ...]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, C] batches split over (data, spatial)."""
    if mesh.axis_size(SPATIAL_AXIS) > 1:
        return NamedSharding(mesh, (DATA_AXIS, SPATIAL_AXIS))
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Whole on every rank (parameters, scalars)."""
    return NamedSharding(mesh, ())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):   # sorted keys, as jax.tree_util
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


def shard_block(mesh: Mesh, x, rank: Optional[int] = None):
    """``rank``'s block of one leaf (default: this process's), by the rule
    of :func:`shard_batch`; the leaf itself when it is replicated."""
    names = list(batch_sharding(mesh).spec)[:getattr(x, "ndim", 0)]
    while names:
        if all(x.shape[d] % mesh.axis_size(a) == 0 for d, a in enumerate(names)):
            c = mesh.coords(rank)
            index = []
            for d, a in enumerate(names):
                size = x.shape[d] // mesh.axis_size(a)
                index.append(slice(c[a] * size, (c[a] + 1) * size))
            return x[tuple(index)]
        names.pop()
    return x


def shard_batch(mesh: Mesh, batch, rank: Optional[int] = None):
    """This process's block of a host batch pytree that every process holds
    whole (numpy arrays or tensors; ``rank`` picks another rank's block).
    A leaf is split over the data axis (dim 0) and, on a mesh with a
    spatial axis, the spatial axis (dim 1); axes that the leaf does not
    have, or whose size does not divide its dim, are dropped innermost
    first, and a leaf that fits none is whole on every rank (JAX
    ``shard_batch``'s rule: a [B] vector splits over data only, a short
    final eval batch is replicated). Rank r of a data axis of size n holds
    rows [r·B/n, (r+1)·B/n), so the global row order is rank 0's rows,
    then rank 1's, and so on."""
    return _tree_map(lambda x: shard_block(mesh, x, rank), batch)


def pad_batch(batch, multiple: int):
    """Pad a host batch pytree along axis 0 to a multiple of ``multiple``
    by repeating its last row; returns ``(padded_batch, n_valid)`` (JAX
    ``pad_batch``, numpy, errors included). The caller masks the padded
    rows with ``n_valid``."""
    leaves = _tree_leaves(batch)
    if not leaves:
        return batch, 0
    n = np.asarray(leaves[0]).shape[0]
    for leaf in leaves:
        arr = np.asarray(leaf)
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(
                "pad_batch expects every leaf batched along axis 0 with "
                f"equal length {n}; got a leaf of shape {arr.shape}")
    target = -(-n // max(1, multiple)) * max(1, multiple)
    if target == n:
        return batch, n

    def pad(x):
        x = np.asarray(x)
        reps = np.repeat(x[-1:], target - n, axis=0)
        return np.concatenate([x, reps], axis=0)

    return _tree_map(pad, batch), n


# --- collectives ---------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(group, tensor: torch.Tensor) -> bool:
    """gloo runs all_gather on host tensors only: a CUDA tensor's gather
    is staged through the host."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_mean_(tensors: List[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over ``group``: one ``all_reduce`` of
    them flattened into one buffer, then a division by the group's size.
    Every member gets the same bits. Nothing happens for a group of one."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over ``group`` (a new tensor)."""
    out = tensor.clone()
    if group_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def broadcast_(tensors: List[torch.Tensor], group, src: int) -> None:
    """Copy global rank ``src``'s ``tensors`` to every member of ``group``,
    in place, in one flattened ``broadcast``."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    with torch.no_grad():
        torch._foreach_copy_(tensors, [c.view_as(t) for c, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])


def all_gather_rows(tensor: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``tensor`` (equal shapes) concatenated along dim 0 in
    group order."""
    n = group_size(group)
    if n == 1:
        return tensor
    staged = _staged(group, tensor)
    local = tensor.contiguous().cpu() if staged else tensor.contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    out = torch.cat(parts)
    return out.to(tensor.device) if staged else out


def barrier() -> None:
    """Wait for every process of the group (nothing outside one)."""
    if initialized() and dist.get_world_size() > 1:
        dist.barrier()


# --- data and spatial parallelism on a mesh ----------------------------------

SPATIAL_UNPORTED = ("{what} under a spatial axis of {n} ranks is not ported "
                    "(ROADMAP queue 1 item 8c)")


@dataclass(frozen=True)
class SpatialShard:
    """This process's place on a mesh's spatial axis: its subgroup, the
    axis's size n and this process's index on it. Rank i of the axis holds
    image rows [i·H/n, (i+1)·H/n) (dim 1 of an NHWC batch, dim 2 of the
    model's NCHW tensors) and tokens [i·N/n, (i+1)·N/n) of an h-major
    flattening."""

    group: object
    size: int
    index: int

    def rows(self, local: int) -> Tuple[int, int, int]:
        """(global rows, first here, one past the last) of an image of
        which this process holds ``local`` rows."""
        return local * self.size, self.index * local, (self.index + 1) * local

    def check_height(self, height: int, levels: int) -> None:
        """Raise ``ValueError`` unless ``height`` splits into n strips
        that every one of ``levels`` resolutions halves into an even number
        of rows: H a multiple of n·2^(levels−1). (JAX's partitioner pads an
        uneven split; the port refuses it: ROADMAP queue 3.)"""
        multiple = self.size * 2 ** (levels - 1)
        if height % multiple:
            raise ValueError(
                f"an image of {height} rows does not split over a spatial "
                f"axis of {self.size} ranks through {levels} resolutions: the "
                f"height must be a multiple of {multiple}")


# The spatial shard the layers run under: a module global, as
# ``models.rows`` keeps its block, because a rematerialised block runs its
# forward again on the autograd engine's device thread in the backward and
# must see what the forward saw.
_SPATIAL: Optional[SpatialShard] = None


@contextlib.contextmanager
def spatial_scope(shard: Optional[SpatialShard]) -> Iterator[None]:
    """The UNet's layers inside see ``shard`` (:func:`current_spatial`);
    a None ``shard`` leaves the current one as it is."""
    global _SPATIAL
    if shard is None:
        yield
        return
    previous, _SPATIAL = _SPATIAL, shard
    try:
        yield
    finally:
        _SPATIAL = previous


def current_spatial() -> Optional[SpatialShard]:
    """The spatial shard the layers run under, or None (whole images)."""
    return _SPATIAL


@dataclass(frozen=True)
class DataShard:
    """This process's place on a mesh: its data axis's subgroup (None for
    one rank), the axis's size, this process's index on it and the axis's
    first member; the subgroup of every rank of the mesh, its size and
    first member, over which gradients are averaged and replicas synced;
    and its :class:`SpatialShard` (None without a spatial axis of more
    than one rank)."""

    group: object
    size: int
    index: int
    src: int             # global rank of the data axis's first member
    mesh_group: object = None
    replicas: int = 1    # ranks of the mesh
    mesh_src: int = 0    # global rank of the mesh's first member
    spatial: Optional[SpatialShard] = None

    def rows(self, local: int) -> Tuple[int, int, int]:
        """(global rows, first here, one past the last) of a global batch
        of which this process holds ``local`` rows."""
        return local * self.size, self.index * local, (self.index + 1) * local


def spatial_shard(mesh: Optional[Mesh]) -> Optional[SpatialShard]:
    """This process's :class:`SpatialShard` of ``mesh``; None without a
    mesh or a spatial axis of more than one rank."""
    if mesh is None or mesh.axis_size(SPATIAL_AXIS) == 1:
        return None
    return SpatialShard(mesh.group(SPATIAL_AXIS), mesh.axis_size(SPATIAL_AXIS),
                        mesh.axis_index(SPATIAL_AXIS))


def refuse_spatial(mesh: Optional[Mesh], what: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP item 8c when ``mesh``
    has a spatial axis of more than one rank: ``what`` is not ported
    under it."""
    if mesh is not None and mesh.axis_size(SPATIAL_AXIS) > 1:
        raise NotImplementedError(SPATIAL_UNPORTED.format(
            what=what, n=mesh.axis_size(SPATIAL_AXIS)))


def refuse_spatial_model(mesh: Optional[Mesh], model, config=None) -> None:
    """:func:`refuse_spatial` for what a spatial axis does not run of a
    model (a ``LowLightDiffusion``) and its training config: ``act_quant``
    (its dynamic amax would need a max over the group) and ``qat_act``."""
    if model.config.unet.act_quant:
        refuse_spatial(mesh, f"UNetConfig.act_quant={model.config.unet.act_quant!r}")
    if config is not None and config.qat_act:
        refuse_spatial(mesh, "TrainConfig.qat_act (activation-aware QAT)")


def data_shard(mesh: Optional[Mesh],
               unported: Optional[str] = None) -> Optional[DataShard]:
    """This process's :class:`DataShard` of ``mesh`` for a UNet path (None
    without a mesh). ``unported`` names a path that a spatial axis of more
    than one rank does not run: it then raises ``NotImplementedError``
    (ROADMAP item 8c). Raises ``ValueError`` when this process is not in
    the mesh."""
    if mesh is None:
        return None
    if unported is not None:
        refuse_spatial(mesh, unported)
    if mesh.rank not in mesh:
        raise ValueError(f"rank {mesh.rank} is not in {mesh!r}")
    return DataShard(mesh.group(DATA_AXIS), mesh.axis_size(DATA_AXIS),
                     mesh.axis_index(DATA_AXIS), mesh.axis_ranks(DATA_AXIS)[0],
                     mesh.group(MESH_GROUP), mesh.size,
                     int(mesh.devices.ravel()[0]), spatial_shard(mesh))
