"""Scale-out over ``torch.distributed``: process meshes, ring and zigzag
context parallelism, sharded attention and paged decode (PyTorch port of
``flash_attention_dlrs_tpu/parallel``).  Every rank runs the same program on
its local shards; :func:`.launch.launch` starts a group for tests and
examples, ``torchrun`` for real jobs."""

from .mesh import initialize_distributed, local_mesh_1d, make_mesh
from .ring import context_parallel_attention, merge_partials, ring_attention
from .sharded_attention import (
    combine_context_attention,
    head_parallel_attention,
    ring_context_attention,
    sharded_attention,
)

__all__ = [
    "make_mesh",
    "local_mesh_1d",
    "initialize_distributed",
    "ring_attention",
    "context_parallel_attention",
    "merge_partials",
    "sharded_attention",
    "head_parallel_attention",
    "ring_context_attention",
    "combine_context_attention",
]
