"""Spatial domain decomposition over several shards (SURVEY.md §5: the
reference is strictly single-GPU and skips grids over 40 GB,
main.cpp:337-341; the JAX package shards the grid over a device mesh, and
this package over a list of torch devices, one per shard)."""

from .sharded import (  # noqa: F401
    Mesh,
    ShardedSimulator,
    global_from_shards,
    make_mesh,
    shards_from_global,
    simulate_sharded,
)
