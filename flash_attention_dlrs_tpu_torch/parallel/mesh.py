"""Process meshes over ``torch.distributed``, PyTorch port of
``flash_attention_dlrs_tpu/parallel/mesh.py``.

The JAX package runs scale-out single-controller: one program, a
``jax.sharding.Mesh`` of devices, ``shard_map`` bodies.  Here every rank is a
process of its own (SPMD, as ``torchrun`` starts them) and a :class:`Mesh` is
a grid of RANKS with named axes: each rank knows its coordinate on every axis
(:meth:`Mesh.index`, JAX's ``lax.axis_index``) and holds one process group
per axis, the ranks that differ from it on that axis only
(:meth:`Mesh.group`), over which the collectives of
:mod:`.launch` run.  The backend (NCCL for CUDA by default; gloo on the CPU,
or for several ranks that share one card) is the caller's choice, made once
in :func:`initialize_distributed`.

Sharded entry points take and return each rank's LOCAL shard, as SPMD code
in PyTorch does; :func:`shard_tensor` and :func:`gather_tensor` convert for
callers that hold a global tensor.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._cuda import resolve_device


def initialize_distributed(backend: Optional[str] = None, *, device="cuda") -> None:
    """Join the process group ``torchrun`` describes (idempotent).

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card, ``LOCAL_RANK %
    device_count()``).  A single process (no ``WORLD_SIZE``, or 1) is a
    no-op.  ``backend`` defaults to "nccl" for ``device="cuda"`` and "gloo"
    for the CPU; several ranks on ONE card need "gloo" (NCCL refuses two
    ranks on one device), which the caller asks for."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count()}`` for
    "cuda", the CPU when asked for it."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """A grid of ranks with named axes.

    ``devices`` is the integer array of global ranks (the name JAX's Mesh
    gives its device array), ``axis_names`` its axes.  Built by
    :func:`make_mesh` inside a process group, it also holds this rank's
    coordinate and one subgroup per axis; built from a plain rank grid, with
    no process group, it answers :attr:`shape` only (what the divisibility
    checks read)."""

    def __init__(self, devices, axis_names: Sequence[str], *, rank: Optional[int] = None,
                 groups: Optional[Dict] = None, backend: Optional[str] = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank grid for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = rank
        self.groups = groups or {}
        self.backend = backend
        self._coords = None
        if rank is not None:
            where = np.argwhere(self.devices == rank)
            if len(where) != 1:
                raise ValueError(f"rank {rank} is not in the mesh {self.devices.tolist()}")
            self._coords = dict(zip(self.axis_names, (int(c) for c in where[0])))

    def size(self, axis: Optional[str]) -> int:
        """``lax.psum(1, axis)``: the axis's size, 1 for None or an axis the
        mesh lacks."""
        return self.shape.get(axis, 1) if axis is not None else 1

    def index(self, axis: Optional[str]) -> int:
        """``lax.axis_index(axis)``: this rank's coordinate on the axis, 0
        for None or an axis the mesh lacks."""
        if axis is None or axis not in self.shape:
            return 0
        if self._coords is None:
            raise ValueError("this Mesh has no process group: it answers shape only")
        return self._coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None when
        the axis has size 1 or there is no process group)."""
        return self.groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, backend={self.backend})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "model"), *,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A named mesh over the ranks of the process group (or ``ranks``).

    With no ``axis_sizes`` every rank lands on the FIRST axis (the rest get
    size 1).  The last axis varies fastest, as in the JAX package.  Every
    rank must call this with the same arguments: each axis's subgroups are
    created here, eagerly, in one fixed order on every rank
    (``new_group`` is collective; lazy creation in a rank-dependent order
    deadlocks).  A rank outside ``ranks`` gets a Mesh with no coordinate."""
    ranks = list(range(_world()) if ranks is None else ranks)
    n = len(ranks)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    axis_sizes = list(axis_sizes)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(
            f"mesh {axis_sizes} needs {int(np.prod(axis_sizes))} devices, have {n}"
        )
    grid = np.array(ranks, dtype=np.int64).reshape(axis_sizes)
    if not dist.is_initialized():
        return Mesh(grid, axis_names, rank=0 if n == 1 else None)
    me = dist.get_rank()
    groups = {}
    for ax, name in enumerate(axis_names):
        if axis_sizes[ax] == 1:
            continue
        lines = np.moveaxis(grid, ax, -1).reshape(-1, axis_sizes[ax])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = group
    rank = me if me in ranks else None
    return Mesh(grid, axis_names, rank=rank, groups=groups, backend=dist.get_backend())


def local_mesh_1d(axis_name: str = "x", max_devices: Optional[int] = None) -> Mesh:
    """Every rank (or the first ``max_devices``) on one axis."""
    ranks = list(range(_world()))
    if max_devices:
        ranks = ranks[:max_devices]
    return make_mesh([len(ranks)], (axis_name,), ranks=ranks)


def _spec_axes(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return spec


def zigzag_indices(n_devices: int, n_tokens: int) -> np.ndarray:
    """Permutation taking a CONTIGUOUS global sequence to the zigzag layout:
    rank i's contiguous shard of the permuted sequence holds global chunks
    (i, 2n−1−i); apply with ``index_select`` on the sequence dim, invert with
    :func:`zigzag_inverse`.  (The JAX package's ``ring.zigzag_indices``.)"""
    two_n = 2 * n_devices
    assert n_tokens % two_n == 0, (n_tokens, two_n)
    c = n_tokens // two_n
    order = []
    for i in range(n_devices):
        order += [i, two_n - 1 - i]
    return np.concatenate([np.arange(ch * c, (ch + 1) * c) for ch in order])


def zigzag_inverse(n_devices: int, n_tokens: int) -> np.ndarray:
    idx = zigzag_indices(n_devices, n_tokens)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(n_tokens)
    return inv


def shard_tensor(x: torch.Tensor, mesh: Mesh, spec, *, zigzag: bool = False) -> torch.Tensor:
    """This rank's shard of the global tensor ``x`` under ``spec`` (one mesh
    axis name or None per dim, as a ``PartitionSpec``): each named dim is cut
    into ``mesh.shape[axis]`` equal slices and the rank keeps slice
    ``mesh.index(axis)``.  With ``zigzag`` the sequence dim of a [B, H, N,
    d] tensor (dim 2) is first permuted into the zigzag layout of its axis
    (:func:`zigzag_indices`)."""
    for dim, axis in enumerate(_spec_axes(spec, x.ndim)):
        if axis is None or axis not in mesh.shape:
            continue
        n = mesh.shape[axis]
        if zigzag and dim == 2:
            idx = torch.as_tensor(zigzag_indices(n, x.shape[dim]), device=x.device)
            x = x.index_select(dim, idx)
        size = x.shape[dim] // n
        if size * n != x.shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                             f"{axis} ({n})")
        x = x.narrow(dim, mesh.index(axis) * size, size)
    return x.contiguous()


def gather_tensor(x: torch.Tensor, mesh: Mesh, spec, *, zigzag: bool = False) -> torch.Tensor:
    """The global tensor from every rank's shard ``x`` (the inverse of
    :func:`shard_tensor`): an all-gather over each named axis."""
    from .launch import all_gather

    for dim, axis in reversed(list(enumerate(_spec_axes(spec, x.ndim)))):
        if axis is None or axis not in mesh.shape or mesh.shape[axis] == 1:
            continue
        x = torch.cat(all_gather(x, mesh, axis), dim=dim)
        if zigzag and dim == 2:
            inv = zigzag_inverse(mesh.shape[axis], x.shape[dim])
            x = x.index_select(dim, torch.as_tensor(inv, device=x.device))
    return x
