"""One step body, captured once into a CUDA graph and replayed.

PyTorch runs eagerly, and a decode step is a few hundred small launches
whose host cost dwarfs the device's work at small batch.  The JAX package
moves the token loop onto the device (``lax.while_loop``); here the loop
stays on the host and its body, a function of no arguments over static
device buffers, is captured once into a ``torch.cuda.CUDAGraph`` and
replayed: one launch of the whole graph per step.

:class:`StepGraph` runs such a body.  On the CPU every call runs it.  On
the card the first call runs it eagerly on a side stream: that warm-up is
also the body's first run, and it builds the kernels, fills the wrappers'
caches (``_slopes_on``) and sizes the split scratch and decode's
self-resetting counters of that stream (``ops/decode.py``).  The body is
then captured on the same stream, into the memory pool the caller gives
(one per engine), and every later call replays the graph.  A capture or a
replay that fails raises; nothing falls back to the eager body.

Launch counts.  The kernel wrappers count a launch when they call their C
entry, which under capture records the kernel and runs nothing.  So the
counts a capture adds (``_cuda.launch_counts``: every ``CudaKernel`` and
every registered count by route or split) are taken back after it and
added at each replay: the counters keep meaning launches on the card.

``pool=EAGER`` runs the body eagerly on every call, on the card too: the
steps of an engine under a mesh, whose collectives a graph cannot hold
across a gloo process group.

The split scratch is keyed by stream and replaced by a larger one when a
later call on that stream needs more; the graph holds the buffers it
captured (``ops.decode.split_scratch_on``), so a replacement cannot free
memory its kernels address.
"""

from __future__ import annotations

import time

import torch

from .._cuda import add_launches, launch_counts, launches_since
from ..ops.decode import split_scratch_on

EAGER = "eager"


class StepGraph:
    """``body`` (no arguments, static buffers) run once per call: eagerly
    on the CPU; on the card warmed up, captured into a CUDA graph in
    ``pool`` (a ``torch.cuda.graph_pool_handle()``, or None for a pool of
    its own) and replayed.  ``runs`` counts the body's runs (warm-up and
    replays), ``capture_seconds`` is the capture's host time (None until
    captured)."""

    def __init__(self, body, device: torch.device, pool=None):
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.capture_seconds = None
        self.runs = 0
        self._launches = ()
        self._scratch = None

    def __call__(self) -> None:
        if self.device.type != "cuda" or self.pool is EAGER:
            self.body()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            add_launches(self._launches)
        self.runs += 1

    def _warm_up_and_capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()  # the warm-up, and the body's first run
        main.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                self.body()
        finally:
            self._launches = launches_since(before)
        self.capture_seconds = time.perf_counter() - t0
        self._scratch = split_scratch_on(self.device, side.cuda_stream)
        self.graph = graph
