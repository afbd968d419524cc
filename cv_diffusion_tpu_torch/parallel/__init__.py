"""Data and spatial parallelism over ``torch.distributed`` process groups:
one process per GPU (counterpart of ``cv_diffusion_tpu/parallel``).

``gather`` and ``make_sharded_sample_fn`` load ``.serving`` at first use:
the model's layers import this package (the spatial shard and the halo
exchanges), and ``.serving`` imports the model."""

from .mesh import (DATA_AXIS, SPATIAL_AXIS, Mesh, auto_mesh, batch_sharding,
                   distributed_init, local_device, make_hybrid_mesh,
                   make_mesh, pad_batch, replicated_sharding, shard_batch)


def __getattr__(name):
    if name in ("gather", "make_sharded_sample_fn"):
        from . import serving
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
