"""The parallel layer on torch.distributed: meshes, the multi-rank runtime
and the sharded training step (the JAX package's `ppq_tpu/parallel`)."""

from .mesh import (Mesh, Sharding, batch_sharding, make_mesh, replicate,
                   shard_qparams, tp_param_shardings)
from .multihost import (broadcast_from_host0, host_local_array,
                        initialize_multihost, local_batch_size,
                        make_hybrid_mesh, slice_topology, spawn,
                        sync_global_devices)
from .train import make_sharded_train_step, shard_batch

__all__ = [
    'make_mesh', 'tp_param_shardings', 'batch_sharding', 'replicate',
    'shard_qparams', 'make_sharded_train_step',
    'initialize_multihost', 'make_hybrid_mesh', 'slice_topology',
    'local_batch_size', 'host_local_array', 'sync_global_devices',
    'broadcast_from_host0',
]
