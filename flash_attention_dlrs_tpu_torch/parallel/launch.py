"""Starting a group of ranks, and the exchanges the sharded paths use.

:func:`launch` runs ``fn(*args)`` on ``world_size`` fresh processes (the
``spawn`` method: CUDA cannot be forked) that meet over a ``FileStore`` in a
temporary directory, so that groups started side by side never compete for
a TCP port.  Each rank's return value comes back through a file; a rank that
raises, dies or outlives ``timeout`` fails the whole group: every rank is
killed and the parent raises with that rank's traceback.  ``torchrun`` is
the launcher for real jobs (:func:`.mesh.initialize_distributed`); this one
serves tests, examples and the smoke run.  Kernels are built by the parent
before it launches (``_cuda.build``): a rank only loads the built libraries.

The exchanges run over one axis of a :class:`.mesh.Mesh`:

- :func:`send_recv` is ``lax.ppermute`` by one step around the axis's ring:
  ``dist.batch_isend_irecv`` on NCCL.  Gloo sends CPU tensors only, so on a
  gloo group a CUDA tensor travels through pinned host memory.
- :func:`all_reduce` (sum or max, JAX's ``psum`` / ``pmax``) and
  :func:`all_gather`, on the tensor's own device: gloo runs both on CUDA
  tensors itself (checked with PyTorch 2.11 on an H100, fp32 / bf16 /
  fp16; it stages them through the host inside), where its send and
  receive abort on a CUDA tensor.

The backend, and so the path, is fixed when the mesh is made.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._cuda import resolve_device
from .mesh import Mesh

def _rank_main(fn, rank, world_size, tmp, backend, device, timeout, threads, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    result = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        out = (True, fn(*args))
    except Exception:  # reported to the parent, which raises
        out = (False, traceback.format_exc())
    with open(result + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(result + ".tmp", result)
    if out[0] and dist.is_initialized():
        dist.destroy_process_group()
    os._exit(0 if out[0] else 1)


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo", device="cpu",
           timeout: float = 300.0, threads: Optional[int] = None) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world_size)]``, each rank a
    spawned process in one process group of ``backend``.  ``fn`` must be a
    module-level function (it is pickled by name) and return something
    picklable without CUDA (CPU tensors, numpy, plain values).  ``device``
    "cuda" sets each rank's card to ``rank % device_count()`` (all ranks
    share ``cuda:0`` on a one-card machine, which needs gloo).  ``threads``
    sets ``torch.set_num_threads`` in the ranks.  Raises ``RuntimeError``
    with the failing rank's traceback, or ``TimeoutError`` after
    ``timeout`` seconds, having killed every rank."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="fa_torch_group_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, tmp, backend, str(device), timeout, threads, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results = [None] * world_size
        try:
            while True:
                for r, p in enumerate(procs):
                    path = os.path.join(tmp, f"rank{r}.pkl")
                    if results[r] is None and os.path.exists(path):
                        with open(path, "rb") as f:
                            results[r] = pickle.load(f)
                        if not results[r][0]:
                            raise RuntimeError(f"rank {r} of {world_size} failed:\n"
                                               f"{results[r][1]}")
                    if results[r] is None and p.exitcode is not None:
                        raise RuntimeError(f"rank {r} of {world_size} died with exit "
                                           f"code {p.exitcode} before reporting")
                if all(res is not None for res in results):
                    for p in procs:
                        p.join(timeout=max(1.0, deadline - time.monotonic()))
                    return [res[1] for res in results]
                if time.monotonic() > deadline:
                    raise TimeoutError(f"group of {world_size} ranks ran past {timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()


# ---------------------------------------------------------------------------
# Exchanges over one mesh axis
# ---------------------------------------------------------------------------


def _line(mesh: Mesh, axis: str):
    """The global ranks along ``axis`` through this rank, in axis order."""
    coords = [mesh.index(a) for a in mesh.axis_names]
    ax = mesh.axis_names.index(axis)
    coords[ax] = slice(None)
    return [int(r) for r in mesh.devices[tuple(coords)]]


class _Pending:
    """An exchange in flight: :meth:`wait` returns the received tensor.
    ``sent`` keeps the send buffer alive until then."""

    def __init__(self, works, buf, device, sent=None):
        self.works, self.buf, self.device, self.sent = works, buf, device, sent

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.buf.device != self.device:
            return self.buf.to(self.device, non_blocking=True)
        return self.buf


class _Done:
    def __init__(self, x):
        self.x = x

    def wait(self):
        return self.x


def send_recv(x: torch.Tensor, mesh: Mesh, axis: str):
    """Post ``lax.ppermute(x, axis, [(i, i+1 mod n)])``: send ``x`` to the
    next rank along ``axis`` and receive the previous rank's.  Returns a
    handle whose ``wait()`` gives the received tensor, so that a caller can
    compute while the exchange runs.  A gloo group stages CUDA tensors
    through pinned host memory."""
    n = mesh.size(axis)
    if n == 1:
        return _Done(x)
    line = _line(mesh, axis)
    i = mesh.index(axis)
    nxt, prv = line[(i + 1) % n], line[(i - 1) % n]
    group = mesh.group(axis)
    x = x.contiguous()
    if mesh.backend == "gloo":
        pin = x.is_cuda
        send = x.to("cpu") if pin else x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
        works = [dist.isend(send, nxt, group=group), dist.irecv(buf, prv, group=group)]
        return _Pending(works, buf, x.device, sent=send)
    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt, group),
                                    dist.P2POp(dist.irecv, buf, prv, group)])
    return _Pending(works, buf, x.device)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``lax.psum`` ("sum") or ``lax.pmax`` ("max") of ``x`` over ``axis``;
    returns a new tensor (``x`` is left alone)."""
    if mesh.size(axis) == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    y = x.clone().contiguous()
    dist.all_reduce(y, red, group=mesh.group(axis))
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``lax.all_gather`` over ``axis``: every rank's ``x``, in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=mesh.group(axis))
    # the group's ranks are in sorted order; put them in axis order
    line = _line(mesh, axis)
    by_rank = dict(zip(sorted(line), out))
    return [by_rank[r] for r in line]
