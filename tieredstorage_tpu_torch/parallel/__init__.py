"""Multi-device scale-out: a device mesh and split window transforms.

Counterpart of tieredstorage_tpu/parallel/. The JAX package shards the
chunk batch of a window across a 1-D "data" mesh with GSPMD; here a mesh is
an ordered list of `torch.device` members and each member runs the same
window program on its own rows, on its own CUDA stream. Every kernel in
ops/ is row-local, so the forward path needs no collective; only the
per-chunk sizes are gathered back to build the chunk index
(`multichip._index_collective`).
"""

from tieredstorage_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DeviceMesh,
    MeshPlan,
    data_mesh,
    local_devices,
    pad_batch,
    run_on_members,
    shard_rows,
)

__all__ = [
    "DATA_AXIS", "DeviceMesh", "MeshPlan", "data_mesh", "local_devices", "pad_batch",
    "run_on_members", "shard_rows",
]
