"""Distributed execution: a ``(data, shard)`` mesh of torch.distributed
ranks, index sharding, multi-process start-up."""

from .mesh import (COLLECTIVES, ShardedIndex, init_multihost,  # noqa: F401
                   make_mesh)
