"""Data parallelism over ``torch.distributed`` process groups: one process
per GPU (counterpart of ``cv_diffusion_tpu/parallel``)."""

from .mesh import (DATA_AXIS, SPATIAL_AXIS, Mesh, auto_mesh, batch_sharding,
                   distributed_init, local_device, make_hybrid_mesh,
                   make_mesh, pad_batch, replicated_sharding, shard_batch)
from .serving import gather, make_sharded_sample_fn
