"""The paged KV cache, PyTorch port of ``flash_attention_dlrs_tpu/runtime/kv_cache.py``.

``PageAllocator`` is plain Python on the host: a free list and per-sequence
page tables, touched at admission and retirement and once per decode step
for the batch's bookkeeping.  Every layer's pool is indexed with the same
page ids.  ``PagedKVCache`` holds one layer's device pools (value or int8 /
fp8 quantized) with an allocator, and writes prompts and decode tokens into
them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._cuda import resolve_device
from ..models.decoding import KVPools, _write_tokens, write_prompt_kv
from ..ops.fwd_kernel import kernel_width


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


@dataclasses.dataclass
class PagedKVCache:
    """Device page pools + host page accounting for one attention layer.
    Pools are allocated at the kernels' head dim (``kernel_width(head_dim)``:
    64, 128 or 256, as the JAX package pads to 128 lanes); ``head_dim`` is
    the model's.  Writes update them in place, zero-padded."""

    k_pages: torch.Tensor  # [Hkv, num_pages, page_size, d] (payload dtype)
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]  # [Hkv, num_pages, page_size, 1] fp32
    v_scales: Optional[torch.Tensor]
    page_size: int
    allocator: PageAllocator
    head_dim: int = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def create(
        cls,
        *,
        num_kv_heads: int,
        head_dim: int,
        num_pages: int,
        page_size: int = 256,
        dtype=torch.bfloat16,
        quantized: bool = False,
        device="cuda",
    ) -> "PagedKVCache":
        device = resolve_device(device)
        shape = (num_kv_heads, num_pages, page_size, kernel_width(head_dim))
        sshape = (num_kv_heads, num_pages, page_size, 1)

        def scales():
            return (torch.ones(sshape, dtype=torch.float32, device=device)
                    if quantized else None)

        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            k_scales=scales(),
            v_scales=scales(),
            page_size=page_size,
            allocator=PageAllocator(num_pages, page_size),
            head_dim=head_dim,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    def _pools(self) -> KVPools:
        """The pools as one layer of :class:`..models.decoding.KVPools`, so
        that the pool format is written and read by that module alone."""
        if self.quantized:
            return KVPools((self.k_pages,), (self.v_pages,),
                           (self.k_scales,), (self.v_scales,))
        return KVPools((self.k_pages,), (self.v_pages,))

    def kv_for_attention(self):
        """Views consumable by ops.decode.paged_decode_attention."""
        return self._pools().layer(0)

    # -- host-side control plane (delegated to the allocator) ----------------

    @property
    def free_pages(self):
        return self.allocator.free_pages

    @property
    def page_tables(self):
        return self.allocator.page_tables

    @property
    def seq_lengths(self):
        return self.allocator.seq_lengths

    def allocate(self, seq_id, num_tokens: int) -> None:
        self.allocator.allocate(seq_id, num_tokens)

    def ensure_capacity(self, seq_id, new_len: int) -> None:
        self.allocator.ensure_capacity(seq_id, new_len)

    def free(self, seq_id) -> None:
        self.allocator.free(seq_id)

    def page_indices_for(self, seq_ids, pages_per_seq: int) -> np.ndarray:
        return self.allocator.page_indices_for(seq_ids, pages_per_seq)

    def lengths_for(self, seq_ids) -> np.ndarray:
        return self.allocator.lengths_for(seq_ids)

    # -- device-side data plane ---------------------------------------------

    @torch.inference_mode()
    def write_prompt(self, seq_id, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write a full prompt's K/V ([Hkv, T, d]) into the sequence's pages."""
        t = k.shape[1]
        self.ensure_capacity(seq_id, t)
        n_pages = -(-t // self.page_size)
        pages = torch.tensor(self.page_tables[seq_id][:n_pages],
                             device=self.k_pages.device)
        write_prompt_kv(self._pools(), 0, (k, v), pages, self.page_size)
        self.seq_lengths[seq_id] = t

    @torch.inference_mode()
    def append_tokens(self, seq_ids, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Append one token per sequence: k_new/v_new [B, Hkv, d]."""
        rows, slots = [], []
        for sid in seq_ids:
            pos = self.seq_lengths[sid]
            self.ensure_capacity(sid, pos + 1)
            rows.append(self.page_tables[sid][pos // self.page_size])
            slots.append(pos % self.page_size)
            self.seq_lengths[sid] = pos + 1
        dev = self.k_pages.device
        _write_tokens(self._pools(), 0, torch.tensor(rows, device=dev)[:, None],
                      torch.tensor(slots, device=dev)[:, None],
                      k_new.transpose(0, 1)[:, :, None], v_new.transpose(0, 1)[:, :, None])
