"""Data parallel over torch.distributed (``mesh.py``), JAX's names where
they mean something in torch."""
from hdenseformer_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    local_device,
    local_mesh_devices,
    make_mesh,
    maybe_distributed_init,
    shard_batch,
)

__all__ = ["Mesh", "active_mesh", "local_device", "local_mesh_devices", "make_mesh",
           "maybe_distributed_init", "shard_batch"]
