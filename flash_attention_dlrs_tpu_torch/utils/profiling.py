"""Profiling helpers, the PyTorch port of ``flash_attention_dlrs_tpu/utils/profiling.py``.

The reference's only observability is do_bench timing and an analytic FLOPs
model (reference: src/bench.py:99, src/flash_attention_openai_tutorial.py:630-636;
SURVEY.md §5).  Here: the card's peak numbers for a percentage of the speed
of light, ``torch.profiler`` traces (Chrome trace JSON, viewable in
Perfetto or chrome://tracing), named ranges that show on the profiler's and
Nsight's timelines, and a step timer that synchronises the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch

# Dense peaks of each card this port has run on, by a substring of
# torch.cuda.get_device_name: (bf16 / fp16 tensor-core TFLOP/s, HBM GB/s)
# from the public spec sheets.
_PEAKS = {
    "H100 80GB HBM3": (989.0, 3350.0),  # H100 SXM5
    "H100 SXM": (989.0, 3350.0),
}


def _device_name(device) -> Optional[str]:
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device  # a device name
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def device_peaks(device=None):
    """(bf16 TFLOP/s, HBM GB/s) of ``device`` (a CUDA device, default the
    current one, or a device name), or None for an unknown card and off the
    card."""
    name = _device_name(device)
    if name is None:
        return None
    for sub, peaks in _PEAKS.items():
        if sub in name:
            return peaks
    return None


def percent_of_sol(tflops: float, device=None) -> Optional[float]:
    """``tflops`` as a percentage of the card's bf16 peak, or None where the
    peak is unknown."""
    peaks = device_peaks(device)
    if peaks is None:
        return None
    return 100.0 * tflops / peaks[0]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU, and the card's kernels where
    one is present), written as a Chrome trace to ``log_dir/trace.json``
    (default: ``fa_torch_trace`` under the temporary directory); yields the
    profiler."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fa_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``record_function`` (the profiler's timeline) and,
    where a card is present, an NVTX range (Nsight's)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling wall-clock timer of steady-state steps (skips ``skip`` warm-up
    steps); it synchronises the card at each step's start and end, so a
    step's time includes the kernels it queued."""

    def __init__(self, skip: int = 2, device=None):
        self.skip = skip
        self.times = []
        self._t0 = None
        self._n = 0
        self._cuda = torch.cuda.is_available() and torch.device(
            "cuda" if device is None else device).type == "cuda"

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
