"""Prefix caching, PyTorch port of ``flash_attention_dlrs_tpu/runtime/prefix_cache.py``.

Sequences whose prompts share a prefix (system prompts, few-shot headers)
reuse the SAME KV pages instead of recomputing and re-storing them:

- a page's identity is the rolling hash of all tokens up to and including
  that page (so equal page ids imply equal full *prefixes*, not just equal
  windows);
- only FULL pages are shared — the partial tail page and everything after is
  always private, so decode writes never touch shared pages;
- the allocator refcounts pages: the registry holds one reference per cached
  page, each using sequence holds another; pages return to the free list at
  refcount 0 (entry evicted AND no users);
- eviction is LRU over cache entries, triggered on allocation pressure, and
  must evict suffix-before-prefix (an entry's page can only be reused if its
  whole chain is intact, so dropping a later page first is always safe).

K/V values are pure per-token functions (projection + RoPE at an absolute
position, and per-token quantization) — independent of chunking or
attention — so a cached page's content equals what the new sequence would
have written.  Host-side only: numpy and hashlib, on the port's
``PageAllocator``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np


class PrefixCache:
    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # chain-hash -> page id, in LRU order (move_to_end on hit)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    # -- hashing ----------------------------------------------------------

    def _chain_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        """One hash per FULL page, chained over the whole prefix."""
        ps = self.page_size
        toks = np.asarray(tokens, np.int64)
        out = []
        h = b"root"
        for pg in range(len(toks) // ps):
            h = hashlib.sha1(h + toks[pg * ps:(pg + 1) * ps].tobytes()).digest()
            out.append(h)
        return out

    # -- lookup / registration ---------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix: ([page ids], n_cached_tokens).

        Never returns the whole prompt: at least the final token is left for
        recomputation so admission has logits to sample from (and the page
        holding it stays private).
        """
        hashes = self._chain_hashes(tokens)
        # leave the page containing token t-1 uncached
        max_pages = (len(tokens) - 1) // self.page_size
        pages: List[int] = []
        for h in hashes[:max_pages]:
            page = self._entries.get(h)
            if page is None:
                break
            self._entries.move_to_end(h)
            pages.append(page)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def register(self, tokens: Sequence[int], table) -> None:
        """Publish a just-prefilled sequence's full prompt pages."""
        for h, page in zip(self._chain_hashes(tokens), table):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self._entries[h] = int(page)
            self.allocator.add_ref([int(page)])

    # -- capacity ----------------------------------------------------------

    def evictable(self) -> int:
        """Number of cache entries whose eviction would actually FREE a page.

        Only pages at refcount 1 (registry-only — no live sequence holds
        them) return to the free list when the registry drops its ref;
        counting every entry would let the scheduler admit work that
        eviction cannot make room for (allocate_mixed would then raise)."""
        if not self._entries:
            return 0
        refs = self.allocator.ref_counts(list(self._entries.values()))
        return int(sum(1 for r in refs if r == 1))

    def evict(self, n_pages: int, exclude=()) -> int:
        """Release LRU entries until n_pages pages have actually returned to
        the free list (a hit bumps the whole used chain, so LRU order is
        naturally suffix-before-prefix for live chains).  Entries whose pages
        are still referenced by a live sequence are kept — dropping the
        registry ref would free nothing now and forfeit a future hit.
        ``exclude``: pages that must survive — e.g. the prefix just matched
        for the sequence being admitted, whose refs are not yet taken.
        Returns the number of pages freed."""
        exclude = set(int(p) for p in exclude)
        released = 0
        kept = []
        scanned = 0
        n_entries = len(self._entries)
        while released < n_pages and scanned < n_entries and self._entries:
            h, page = self._entries.popitem(last=False)
            scanned += 1
            if page in exclude or self.allocator.ref_counts([page])[0] != 1:
                kept.append((h, page))
                continue
            self.allocator.release([page])
            released += 1
        for h, page in reversed(kept):  # reinsert protected entries, LRU head
            self._entries[h] = page
            self._entries.move_to_end(h, last=False)
        return released

    def can_allocate(self, num_tokens: int) -> bool:
        need = -(-max(num_tokens, 1) // self.page_size)
        return need <= len(self.allocator.free_pages) + self.evictable()

    def allocate_mixed_with_eviction(self, sid, shared_pages, num_tokens):
        """allocate_mixed, evicting LRU cache entries on page pressure."""
        need = -(-max(num_tokens, 1) // self.page_size) - len(shared_pages)
        short = need - len(self.allocator.free_pages)
        if short > 0:
            self.evict(short, exclude=shared_pages)
        self.allocator.allocate_mixed(sid, shared_pages, num_tokens)
