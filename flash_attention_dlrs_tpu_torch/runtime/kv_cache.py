"""Host-side page accounting for the paged KV cache, PyTorch port of
``flash_attention_dlrs_tpu/runtime/kv_cache.py`` (``PageAllocator`` only).

Plain Python on the host: a free list and per-sequence page tables, touched
at admission and retirement and once per decode step for the batch's
bookkeeping.  Every layer's pool is indexed with the same page ids.
"""

from __future__ import annotations

import numpy as np


class PageAllocator:
    """Host-side page accounting: free list + per-sequence page tables.

    The decode engine reuses ONE allocation across all layers — every
    layer's pool is indexed with the same page ids."""

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.free_pages = list(range(num_pages - 1, -1, -1))
        self.page_tables: dict = {}
        self.seq_lengths: dict = {}
        # Reference counts for prefix sharing: a page allocated to a
        # sequence starts at 1; add_ref/release manage extra holders (the
        # prefix-cache registry and sequences reusing cached pages).  A page
        # returns to the free list only when its count reaches 0.
        self._refs = np.zeros(num_pages, np.int32)

    def can_allocate(self, num_tokens: int) -> bool:
        return -(-max(num_tokens, 1) // self.page_size) <= len(self.free_pages)

    def allocate(self, seq_id, num_tokens: int) -> None:
        self.allocate_mixed(seq_id, (), num_tokens)

    def allocate_mixed(self, seq_id, shared_pages, num_tokens: int) -> None:
        """Allocate a sequence whose first pages are SHARED (refcounted,
        already filled by a previous sequence) plus fresh pages to cover
        ``num_tokens`` total."""
        if seq_id in self.page_tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        shared = list(shared_pages)
        need = -(-max(num_tokens, 1) // self.page_size) - len(shared)
        if need > len(self.free_pages):
            raise MemoryError(
                f"KV cache out of pages: need {need}, free {len(self.free_pages)}"
            )
        fresh = [self.free_pages.pop() for _ in range(max(need, 0))]
        for p in shared:
            self._refs[p] += 1
        for p in fresh:
            self._refs[p] = 1
        self.page_tables[seq_id] = shared + fresh
        self.seq_lengths[seq_id] = 0

    def add_ref(self, pages) -> None:
        for p in pages:
            self._refs[p] += 1

    def ref_counts(self, pages) -> np.ndarray:
        return self._refs[np.asarray(list(pages), np.int32)].copy()

    def release(self, pages) -> None:
        """Drop one reference per page; count-0 pages return to the free list."""
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] <= 0:
                self._refs[p] = 0
                self.free_pages.append(int(p))

    def ensure_capacity(self, seq_id, new_len: int) -> None:
        table = self.page_tables[seq_id]
        need = -(-new_len // self.page_size)
        while len(table) < need:
            if not self.free_pages:
                raise MemoryError("KV cache out of pages")
            p = self.free_pages.pop()
            self._refs[p] = 1
            table.append(p)

    def free(self, seq_id) -> None:
        pages = self.page_tables.pop(seq_id)
        self.seq_lengths.pop(seq_id)
        self.release(reversed(pages))

    def page_indices_for(self, seq_ids, pages_per_seq: int) -> np.ndarray:
        out = np.zeros((len(seq_ids), pages_per_seq), np.int32)
        for row, sid in enumerate(seq_ids):
            table = self.page_tables[sid]
            out[row, : len(table)] = table
        return out

    def lengths_for(self, seq_ids) -> np.ndarray:
        return np.array(
            [self.seq_lengths.get(s, 0) for s in seq_ids], np.int32
        )

    def decode_step_bookkeeping(self, seq_ids, pages_per_seq: int,
                                wrap_tokens: int = 0, sink_tokens: int = 0):
        """Per-decode-step bookkeeping for a batch: grow each sequence's
        table by one token, emit (rows, offs, tables, positions, lens) and
        advance the stored lengths.  Same contract as the native allocator's
        single-call fused version (native_alloc.py).

        ``wrap_tokens`` > 0 = rolling ring of that many tokens (sliding-
        window serving): the write slot is pos % wrap (overwriting the
        oldest token), capacity never grows past the ring, and positions/
        lens stay TRUE (callers clamp the attention length).
        ``sink_tokens`` (with wrap) pins the FIRST sink_tokens slots
        (StreamingLLM attention sinks): positions below it write in place,
        later positions ring over the wrap_tokens slots after it."""
        n = len(seq_ids)
        rows = np.zeros(n, np.int32)
        offs = np.zeros(n, np.int32)
        tbl = np.zeros((n, pages_per_seq), np.int32)
        positions = np.zeros(n, np.int32)
        lens = np.zeros(n, np.int32)
        for i, sid in enumerate(seq_ids):
            pos = self.seq_lengths[sid]
            if not wrap_tokens:
                idx = pos
            elif pos < sink_tokens:
                idx = pos
            else:
                idx = sink_tokens + (pos - sink_tokens) % wrap_tokens
            self.ensure_capacity(
                sid, min(pos + 1, sink_tokens + wrap_tokens)
                if wrap_tokens else pos + 1)
            table = self.page_tables[sid]
            rows[i] = table[idx // self.page_size]
            offs[i] = idx % self.page_size
            m = min(len(table), pages_per_seq)
            tbl[i, :m] = table[:m]
            positions[i] = pos
            lens[i] = pos + 1
            self.seq_lengths[sid] = pos + 1
        return rows, offs, tbl, positions, lens
