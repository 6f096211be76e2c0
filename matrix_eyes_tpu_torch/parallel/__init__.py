"""Multi-device execution: a (data, model) mesh of ranks, one process per
device over ``torch.distributed`` (port of ``matrix_eyes_tpu/parallel/``).

The reference is strictly single-device; its one latent parallel axis is
the 35-patch pyramid batch. The JAX package shards that axis over a
device mesh and runs Megatron tensor parallelism over the ViT blocks on
the mesh's 'model' axis, with XLA inserting the collectives. The port
runs the same layouts as one program per rank: ``sharding`` cuts the
parameters and the patch batch, ``collectives`` moves the partial results
(NCCL between cards, gloo on the CPU), ``launch`` starts the ranks.
"""

from matrix_eyes_tpu_torch.parallel.launch import launch
from matrix_eyes_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    patch_sharded,
    shard_batch,
    shard_params,
    shard_patches,
)

__all__ = ["Mesh", "launch", "make_mesh", "patch_sharded", "shard_batch", "shard_params",
           "shard_patches"]
