"""Attention laid out over a process mesh, PyTorch port of
``flash_attention_dlrs_tpu/parallel/sharded_attention.py``.

Strategies:

- ``head``    — Q/K/V heads sharded over a model axis; no communication
                during attention (GQA keeps each KV head with its Q group).
- ``data``    — batch sharded; embarrassingly parallel.
- ``ring``    — sequence sharded over a context axis; ring attention.
- ``zigzag``  — the load-balanced causal ring (shards in the zigzag layout).
- ``combine`` — KV sequence sharded, q replicated; partial attention and
                one logaddexp all-reduce (decode-shaped).

Each factory returns a callable that every rank of the mesh calls with its
LOCAL shards and that returns its local output shard (the JAX callables take
global arrays and ``shard_map`` over them; SPMD code in PyTorch holds only
its shard).  ``"zigzag"`` takes shards already in the zigzag layout
(:func:`.mesh.shard_tensor` with ``zigzag=True`` makes them from a global
tensor).  Axes missing from the mesh count as size 1.  With
``dropout_rate > 0`` the callable takes a 4th argument, the int dropout
seed, into which each rank folds its data / model coordinates.
"""

from __future__ import annotations

import functools
from typing import Optional

from ..ops.flash_attention import flash_attention
from ..ops.fwd_kernel import int32_seed
from .mesh import Mesh
from .ring import context_parallel_attention, ring_attention, zigzag_ring_attention

# Distinct from ring.shard_seed's prime: ring_context_attention composes both
# folds additively, and distinct primes keep the offsets from colliding.
_DM_SEED_PRIME = 32452843


def _fold_axes(seed, axis_a: Optional[str], axis_b: Optional[str], mesh: Mesh) -> int:
    """Fold up to two mesh-axis coordinates into a dropout seed as ONE
    flattened shard id a·n_b + b (int32); absent axes contribute 0."""
    flat = mesh.index(axis_a) * mesh.size(axis_b) + mesh.index(axis_b)
    return int32_seed(int(seed) + _DM_SEED_PRIME * flat)


def head_parallel_attention(mesh: Mesh, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            data_axis: Optional[str] = "data", model_axis: Optional[str] = "model",
                            dropout_rate: float = 0.0):
    """Heads on ``model_axis``, batch on ``data_axis``; no collectives.
    The callable takes the local [B/dp, H/tp, N, d] shards."""
    rate = float(dropout_rate)

    def call(q, k, v, seed=None):
        if rate:
            seed = _fold_axes(seed, data_axis, model_axis, mesh)
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               dropout_rate=rate, dropout_seed=seed)

    return call


def ring_context_attention(mesh: Mesh, *, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           data_axis: Optional[str] = "data", context_axis: str = "context",
                           model_axis: Optional[str] = None, dropout_rate: float = 0.0):
    """Sequence sharded over ``context_axis`` (with optional head / data
    sharding): ring attention rotates the K/V shards."""
    rate = float(dropout_rate)

    def call(q, k, v, seed=None):
        if rate:
            seed = _fold_axes(seed, data_axis, model_axis, mesh)
        return ring_attention(q, k, v, mesh=mesh, axis_name=context_axis, causal=causal,
                              sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)

    return call


def zigzag_context_attention(mesh: Mesh, *, sm_scale: Optional[float] = None,
                             data_axis: Optional[str] = "data", context_axis: str = "context",
                             model_axis: Optional[str] = None, dropout_rate: float = 0.0):
    """Load-balanced CAUSAL context parallelism on shards in the zigzag
    layout (the JAX callable permutes a contiguous global sequence at its
    boundary; here :func:`.mesh.shard_tensor` / :func:`.mesh.gather_tensor`
    with ``zigzag=True`` do that for a caller that holds one)."""
    rate = float(dropout_rate)

    def call(q, k, v, seed=None):
        if rate:
            seed = _fold_axes(seed, data_axis, model_axis, mesh)
        return zigzag_ring_attention(q, k, v, mesh=mesh, axis_name=context_axis,
                                     sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)

    return call


def combine_context_attention(mesh: Mesh, *, sm_scale: Optional[float] = None,
                              data_axis: Optional[str] = "data", context_axis: str = "context",
                              dropout_rate: float = 0.0):
    """Q replicated over context, KV sharded; one combine of the partials."""
    rate = float(dropout_rate)

    def call(q, k, v, seed=None):
        if rate:
            seed = _fold_axes(seed, data_axis, None, mesh)
        return context_parallel_attention(q, k, v, mesh=mesh, axis_name=context_axis,
                                          sm_scale=sm_scale, dropout_rate=rate,
                                          dropout_seed=seed)

    return call


def sharded_attention(mesh: Mesh, strategy: str = "head", **kw):
    """Factory over the strategies above."""
    builders = {
        "head": head_parallel_attention,
        "data": functools.partial(head_parallel_attention, model_axis=None),
        "ring": ring_context_attention,
        "zigzag": zigzag_context_attention,
        "combine": combine_context_attention,
    }
    if strategy not in builders:
        raise ValueError(f"unknown strategy {strategy!r}; have {sorted(builders)}")
    return builders[strategy](mesh, **kw)
