"""Parallelism: data-parallel training over torch.distributed (port of
clstm_tpu/parallel).

The reference is single-process; the JAX package shards width-bucketed line
batches over a 1-D device mesh and psums the gradients. The port runs one
process per rank (parallel/mesh.py: the group, the backend rule, the
launch) and sums the loss and gradients with one all_reduce a step
(parallel/dp.py). TP/PP do not apply at CLSTM's model sizes.
"""

from clstm_tpu_torch.parallel.dp import (
    make_parallel_multi_train_step, make_parallel_train_step, pmean_tree,
    psum_tree)
from clstm_tpu_torch.parallel.mesh import (
    Mesh, launch, make_mesh, replicate, shard_rows)

__all__ = ["Mesh", "make_mesh", "shard_rows", "replicate", "launch",
           "make_parallel_train_step", "make_parallel_multi_train_step",
           "pmean_tree", "psum_tree"]
