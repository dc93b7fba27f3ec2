"""Multi-GPU layer: the process mesh, batch layout and collectives."""

from monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    warm_collectives,
)

__all__ = ["Mesh", "init_distributed", "make_mesh", "replicate", "shard_batch",
           "warm_collectives"]
