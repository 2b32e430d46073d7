"""Sharded execution: one process drives a mesh of devices, each shard on
its own stream, with explicit halo exchange between neighbours."""

from fib_tf_tpu_torch.parallel.sharding import (
    Mesh,
    gather_state,
    make_mesh,
    shard_state,
)

__all__ = ["Mesh", "gather_state", "make_mesh", "shard_state"]
