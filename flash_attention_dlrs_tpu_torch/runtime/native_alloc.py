"""ctypes bindings of the native (C++) page allocator, the port's copy of
``flash_attention_dlrs_tpu/runtime/native_alloc.py``.

The per-decode-step page-table and length assembly for the whole batch is
the serving control plane's hot path on the host; ``native/src/
page_allocator.cc`` does it in one C call.  The library is built on demand
by :mod:`._native` (plain C ABI + ctypes).

``NativePageAllocator`` has the contract of :class:`.kv_cache.PageAllocator`:
the same methods and the dict-style views (``page_tables``,
``seq_lengths``, ``free_pages``) the engine uses.  :func:`make_page_allocator`
picks one: ``native=None`` takes the C++ allocator where the library builds
and the Python one otherwise (as the JAX package does), ``True`` raises when
the library cannot be built or loaded, ``False`` takes the Python one.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import _native
from .kv_cache import PageAllocator

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """dlopen the shared native library (built on demand by
    :mod:`._native`) and declare the pa_* signatures once; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _native.load_lib()
        lib.pa_create.restype = ctypes.c_void_p
        lib.pa_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.pa_destroy.argtypes = [ctypes.c_void_p]
        lib.pa_num_free.restype = ctypes.c_int32
        lib.pa_num_free.argtypes = [ctypes.c_void_p]
        lib.pa_can_allocate.restype = ctypes.c_int32
        lib.pa_can_allocate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pa_allocate.restype = ctypes.c_int32
        lib.pa_allocate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.pa_ensure_capacity.restype = ctypes.c_int32
        lib.pa_ensure_capacity.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.pa_free.restype = ctypes.c_int32
        lib.pa_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pa_get_length.restype = ctypes.c_int64
        lib.pa_get_length.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pa_set_length.restype = ctypes.c_int32
        lib.pa_set_length.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.pa_table_len.restype = ctypes.c_int32
        lib.pa_table_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pa_get_table.restype = ctypes.c_int32
        lib.pa_get_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.pa_page_indices.restype = ctypes.c_int32
        lib.pa_page_indices.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.pa_lengths.restype = ctypes.c_int32
        lib.pa_lengths.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.pa_decode_step.restype = ctypes.c_int32
        lib.pa_decode_step.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32] + [
            ctypes.POINTER(ctypes.c_int32)] * 5
        lib.pa_allocate_mixed.restype = ctypes.c_int32
        lib.pa_allocate_mixed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64]
        lib.pa_add_ref.restype = None
        lib.pa_add_ref.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.pa_release.restype = None
        lib.pa_release.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.pa_ref_counts.restype = None
        lib.pa_ref_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


_unavailable = False


def native_available() -> bool:
    """Whether the library builds and loads here; a failure is remembered,
    so auto-detection builds at most once a process."""
    global _unavailable
    if _lib is None and not _unavailable:
        try:
            _load_lib()
        except RuntimeError:
            _unavailable = True
    return _lib is not None


class _Table:
    """List-like view of one sequence's page table (fetched from native)."""

    __slots__ = ("_alloc", "_key")

    def __init__(self, alloc: "NativePageAllocator", key: int):
        self._alloc = alloc
        self._key = key

    def _fetch(self) -> np.ndarray:
        n = self._alloc._lib.pa_table_len(self._alloc._h, self._key)
        if n < 0:
            raise KeyError("sequence freed")
        out = np.empty(n, np.int32)
        self._alloc._lib.pa_get_table(
            self._alloc._h, self._key,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return out

    def __len__(self):
        n = self._alloc._lib.pa_table_len(self._alloc._h, self._key)
        if n < 0:
            raise KeyError("sequence freed")
        return n

    def __getitem__(self, i):
        return self._fetch()[i]

    def __iter__(self):
        return iter(self._fetch().tolist())

    def __array__(self, dtype=None, copy=None):
        arr = self._fetch()
        return arr.astype(dtype) if dtype is not None else arr


class _Tables:
    def __init__(self, alloc: "NativePageAllocator"):
        self._alloc = alloc

    def __getitem__(self, sid) -> _Table:
        key = self._alloc._key_of(sid, create=False)
        if key is None or self._alloc._lib.pa_table_len(self._alloc._h, key) < 0:
            raise KeyError(sid)
        return _Table(self._alloc, key)

    def __contains__(self, sid) -> bool:
        key = self._alloc._keys.get(sid)
        return (
            key is not None
            and self._alloc._lib.pa_table_len(self._alloc._h, key) >= 0
        )


class _Lengths:
    def __init__(self, alloc: "NativePageAllocator"):
        self._alloc = alloc

    def __getitem__(self, sid) -> int:
        key = self._alloc._keys.get(sid)
        if key is None:
            raise KeyError(sid)
        n = self._alloc._lib.pa_get_length(self._alloc._h, key)
        if n < 0:
            raise KeyError(sid)
        return int(n)

    def __setitem__(self, sid, value: int) -> None:
        key = self._alloc._keys.get(sid)
        if key is None or self._alloc._lib.pa_set_length(
                self._alloc._h, key, int(value)) != 0:
            raise KeyError(sid)

    def get(self, sid, default=0):
        try:
            return self[sid]
        except KeyError:
            return default


class _FreeList:
    """len()-only view of the native free list (tests check page counts)."""

    def __init__(self, alloc: "NativePageAllocator"):
        self._alloc = alloc

    def __len__(self):
        return self._alloc._lib.pa_num_free(self._alloc._h)


class NativePageAllocator:
    """C++-backed drop-in for :class:`.kv_cache.PageAllocator`; raises
    ``RuntimeError`` when the library cannot be built or loaded."""

    def __init__(self, num_pages: int, page_size: int):
        self._lib = lib = _load_lib()
        self._h = lib.pa_create(num_pages, page_size)
        self.page_size = page_size
        self._keys: dict = {}
        self._next_key = 0
        self._step_cache: dict = {}
        self.page_tables = _Tables(self)
        self.seq_lengths = _Lengths(self)
        self.free_pages = _FreeList(self)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and self._lib is not None:
            self._lib.pa_destroy(h)
            self._h = None

    def _key_of(self, sid, create: bool) -> Optional[int]:
        key = self._keys.get(sid)
        if key is None and create:
            key = self._next_key
            self._next_key += 1
            self._keys[sid] = key
        return key

    # -- PageAllocator API ----------------------------------------------------

    def can_allocate(self, num_tokens: int) -> bool:
        return bool(self._lib.pa_can_allocate(self._h, int(num_tokens)))

    def allocate(self, seq_id, num_tokens: int) -> None:
        key = self._key_of(seq_id, create=True)
        rc = self._lib.pa_allocate(self._h, key, int(num_tokens))
        if rc == -1:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if rc == -2:
            raise MemoryError("KV cache out of pages")

    def allocate_mixed(self, seq_id, shared_pages, num_tokens: int) -> None:
        key = self._key_of(seq_id, create=True)
        shared = np.asarray(list(shared_pages), np.int32)
        rc = self._lib.pa_allocate_mixed(
            self._h, key,
            shared.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(shared), int(num_tokens))
        if rc == -1:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if rc == -2:
            raise MemoryError("KV cache out of pages")

    def add_ref(self, pages) -> None:
        arr = np.asarray(list(pages), np.int32)
        self._lib.pa_add_ref(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(arr))

    def release(self, pages) -> None:
        arr = np.asarray(list(pages), np.int32)
        self._lib.pa_release(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(arr))

    def ref_counts(self, pages) -> np.ndarray:
        arr = np.asarray(list(pages), np.int32)
        out = np.empty(len(arr), np.int32)
        self._lib.pa_ref_counts(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(arr), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def ensure_capacity(self, seq_id, new_len: int) -> None:
        key = self._keys.get(seq_id)
        rc = -1 if key is None else self._lib.pa_ensure_capacity(
            self._h, key, int(new_len))
        if rc == -1:
            raise KeyError(seq_id)
        if rc == -2:
            raise MemoryError("KV cache out of pages")

    def free(self, seq_id) -> None:
        key = self._keys.pop(seq_id, None)
        if key is None or self._lib.pa_free(self._h, key) != 0:
            raise KeyError(seq_id)
        # A re-submitted sequence id interns a NEW key; cached step buffers
        # hold the old one and would hit a freed sequence.
        self._step_cache = {
            k: v for k, v in self._step_cache.items() if seq_id not in k[0]
        }

    def page_indices_for(self, seq_ids, pages_per_seq: int) -> np.ndarray:
        keys = np.asarray(
            [self._keys.get(s, -1) for s in seq_ids], np.int64
        )
        out = np.zeros((len(seq_ids), pages_per_seq), np.int32)
        self._lib.pa_page_indices(
            self._h, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seq_ids), pages_per_seq,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def lengths_for(self, seq_ids) -> np.ndarray:
        keys = np.asarray(
            [self._keys.get(s, -1) for s in seq_ids], np.int64
        )
        out = np.zeros(len(seq_ids), np.int32)
        self._lib.pa_lengths(
            self._h, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seq_ids),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def decode_step_bookkeeping(self, seq_ids, pages_per_seq: int,
                                wrap_tokens: int = 0, sink_tokens: int = 0):
        """The per-decode-step hot path in one native call: grow tables,
        emit (rows, offs, tables, positions, lens) and advance lengths.
        ``wrap_tokens`` > 0 = rolling sliding-window ring (see the Python
        twin in kv_cache.py).

        Buffers and ctypes pointers are cached per (sid tuple, pages_per_seq)
        — the decode loop calls with the same batch between admissions, and
        the numpy-allocation + pointer-wrapping overhead (~24 µs) would
        otherwise dwarf the 4 µs native call.
        """
        cache_key = (tuple(seq_ids), pages_per_seq, wrap_tokens,
                     sink_tokens)
        entry = self._step_cache.get(cache_key)
        if entry is None:
            n = len(seq_ids)
            keys = np.asarray([self._keys[s] for s in seq_ids], np.int64)
            outs = (
                np.zeros(n, np.int32), np.zeros(n, np.int32),
                np.zeros((n, pages_per_seq), np.int32),
                np.zeros(n, np.int32), np.zeros(n, np.int32),
            )
            p32 = ctypes.POINTER(ctypes.c_int32)
            ptrs = (
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                *(x.ctypes.data_as(p32) for x in outs),
            )
            entry = (keys, outs, ptrs, n)
            if len(self._step_cache) > 64:
                self._step_cache.clear()
            self._step_cache[cache_key] = entry
        _, outs, ptrs, n = entry
        rc = self._lib.pa_decode_step(
            self._h, ptrs[0], n, pages_per_seq, wrap_tokens, sink_tokens,
            ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5])
        if rc == -2:
            raise MemoryError("KV cache out of pages")
        if rc != 0:
            raise KeyError("unknown sequence in decode step")
        return outs


def make_page_allocator(num_pages: int, page_size: int, native: Optional[bool] = None):
    """The C++ allocator or the Python one: ``native=None`` takes the C++
    one where the library builds, ``True`` always (raising when it cannot be
    built or loaded), ``False`` never."""
    if native or (native is None and native_available()):
        return NativePageAllocator(num_pages, page_size)
    return PageAllocator(num_pages, page_size)
