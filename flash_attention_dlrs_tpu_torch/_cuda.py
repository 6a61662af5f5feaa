"""Building the port's CUDA kernels and binding them to Python.

Each source under ``csrc/`` compiles into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``), loaded with ``ctypes``.  Libraries live in ``_build/``
beside this file, named by a hash of their source, the shared headers and
the flags: an edited source rebuilds on its next use, an unchanged one loads
at once.  Nothing is built
or loaded when a module is imported: the CPU tests import every module and
have no ``nvcc``.

Entry points of the port run on the card unless the caller asks for the CPU;
:func:`resolve_device` is where that rule lives.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

# dtype codes of the C interfaces (csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) requires a card and never falls back to the CPU; the CPU is
    used only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return device


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the port's kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a hash
    of the source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = CSRC_DIR / source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def all_sources() -> list:
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile each source (default: every ``csrc/*.cu``) whose library is
    missing for its current hash: one ``nvcc`` per source, all started
    together.  Returns ``{source: {"seconds": s, "log": nvcc output}}`` for
    the sources it built; raises with nvcc's output if one fails."""
    sources = list(all_sources() if sources is None else sources)
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        running[source] = (proc, tmp, out, time.perf_counter())
    built = {}
    failed = []
    for source, (proc, tmp, out, t0) in running.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, out)
        built[source] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


class CudaKernel:
    """One C entry point of the library built from ``csrc/<source>``.

    :meth:`launch` builds and loads the library on first use, calls the
    entry point (which returns ``cudaGetLastError()`` after its launch),
    raises on a non-zero code, and adds one to :attr:`launches`."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err_str = getattr(lib, f"{self.symbol}_error_string")
                err_str.argtypes = [ctypes.c_int]
                err_str.restype = ctypes.c_char_p
                self._lib, self._err_str, self._fn = lib, err_str, fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        err = fn(*args)
        if err:
            msg = self._err_str(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
