"""ctypes bindings of the native (C++) prefetching token loader, the port's
copy of ``flash_attention_dlrs_tpu/runtime/native_data.py``.

``native_batches`` is a drop-in for ``runtime.data.batches`` over a token
*file*, and so for :func:`..models.trainer.fit`'s ``batches``: the same
yield contract — ``(tokens [B, seq_len+1] int32, LoaderState)`` with a
deterministic, per-process-disjoint shard of each epoch's permutation and
(epoch, index) resume — but the window gather, dtype widening and batch
assembly run on a C++ background thread with a bounded ready queue
(``native/src/dataloader.cc``), so step N+1's batch is made while step N
computes, without holding the GIL.

Two deliberate contract differences from the Python loader:
- the shuffle is the native loader's own deterministic permutation
  (splitmix64 Fisher-Yates), not numpy PCG64 — resume cursors round-trip
  within each loader, not across them;
- ``drop_remainder`` is always true (the train step wants static shapes).

Batches are batch for batch those of the JAX package's native loader on the
same file, seed and cursor (one C++ source).  The library is built on
demand by :mod:`._native`; the loader raises ``RuntimeError`` when it
cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from . import _native
from .data import LoaderState

_DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.uint16): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.uint32): 3,
    np.dtype(np.int64): 4,
}

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _native.load_lib()
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.dl_num_windows.restype = ctypes.c_int64
        lib.dl_num_windows.argtypes = [ctypes.c_void_p]
        lib.dl_next.restype = ctypes.c_int32
        lib.dl_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_loader_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load_lib()
    except RuntimeError:
        return False
    return True


class NativeTokenLoader:
    """Prefetching iterator over shuffled [seq_len+1] windows of a token
    file.  Iterate, or call ``next_batch()``; ``close()`` (or ``with``)
    releases the mmap and joins the worker thread."""

    def __init__(
        self,
        path: str,
        *,
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        state: Optional[LoaderState] = None,
        process_index: int = 0,
        process_count: int = 1,
        prefetch_depth: int = 4,
        dtype=np.uint16,
    ):
        lib = _load_lib()
        code = _DTYPE_CODES.get(np.dtype(dtype))
        if code is None:
            raise ValueError(
                f"unsupported token dtype {dtype!r}; one of "
                f"{sorted(str(d) for d in _DTYPE_CODES)}"
            )
        state = state or LoaderState()
        self._lib = lib
        self._h = lib.dl_create(
            str(path).encode(), code, seq_len, batch_size, seed,
            process_index, process_count, prefetch_depth,
            state.epoch, state.index,
        )
        if not self._h:
            raise ValueError(
                f"native loader rejected {path!r}: missing file, or fewer "
                f"than one full batch of {seq_len}-token windows per host"
            )
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.num_windows = int(lib.dl_num_windows(self._h))
        self._buf = np.empty((batch_size, seq_len + 1), np.int32)

    def next_batch(self) -> Tuple[np.ndarray, LoaderState]:
        if not self._h:
            raise RuntimeError("loader closed")
        ep = ctypes.c_int64()
        ix = ctypes.c_int64()
        self._lib.dl_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(ep), ctypes.byref(ix),
        )
        return self._buf.copy(), LoaderState(epoch=ep.value, index=ix.value)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, LoaderState]]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if self._h:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_batches(
    path: str,
    *,
    seq_len: int,
    batch_size: int,
    seed: int = 0,
    state: Optional[LoaderState] = None,
    process_index: int = 0,
    process_count: int = 1,
    prefetch_depth: int = 4,
    dtype=np.uint16,
) -> Iterator[Tuple[np.ndarray, LoaderState]]:
    """Generator form of NativeTokenLoader (mirrors data.batches); the
    loader is closed when the generator is."""
    loader = NativeTokenLoader(
        path, seq_len=seq_len, batch_size=batch_size, seed=seed, state=state,
        process_index=process_index, process_count=process_count,
        prefetch_depth=prefetch_depth, dtype=dtype,
    )
    try:
        while True:
            yield loader.next_batch()
    finally:
        loader.close()
