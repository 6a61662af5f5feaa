"""Mesh-sharded paged decode, PyTorch port of
``flash_attention_dlrs_tpu/parallel/sharded_decode.py``.

- :func:`head_sharded_paged_decode`: KV-head pools sharded over the model
  axis (each rank owns the pages of its Hkv/tp heads, and GQA keeps the
  matching q heads with them), batch optionally over data.  No collective
  inside the attention.
- :func:`context_sharded_paged_decode`: each rank holds a slice of every
  sequence's pages; every rank computes a partial attention with its
  logsumexp, the partials are all-gathered and merged in rank order (the
  flash-decoding split, laid over ranks).

Both take each rank's LOCAL q, pools, lengths and page tables and run the
port's paged decode kernel on them.  A quantized pool (``QuantizedTensor`` /
``Int4QuantizedTensor``) shards its scales with its payload
(:func:`shard_pools`), so no dummy scales are needed.
"""

from __future__ import annotations

from typing import Optional

from ..ops.decode import paged_decode_attention
from ..ops.quantization import Int4QuantizedTensor, QuantizedTensor
from .launch import all_gather
from .mesh import Mesh, shard_tensor
from .ring import merge_partials


def shard_pools(pool, mesh: Mesh, axis: str, dim: int):
    """This rank's shard of a K or V pool [Hkv, P, page_size, d] along
    ``dim`` (0: kv heads, 1: pages) over ``axis``; a quantized pool's scales
    go with its payload."""
    spec = [None] * 4
    spec[dim] = axis
    if isinstance(pool, (QuantizedTensor, Int4QuantizedTensor)):
        return type(pool)(shard_tensor(pool.values, mesh, spec),
                          shard_tensor(pool.scales, mesh, spec))
    return shard_tensor(pool, mesh, spec)


def head_sharded_paged_decode(mesh: Mesh, *, sm_scale: Optional[float] = None,
                              pages_per_block: Optional[int] = None,
                              data_axis: Optional[str] = "data", model_axis: str = "model"):
    """``(q, k_pages, v_pages, lengths, page_indices) -> o`` on local shards:
    q [B/dp, Hq/tp, d], pools [Hkv/tp, P, page_size, d] (every rank holds
    the full page pool of ITS heads, so page ids need no translation),
    lengths [B/dp], page_indices [B/dp, pages_per_seq].  A quantized pool
    is a ``QuantizedTensor`` / ``Int4QuantizedTensor`` (JAX's ``quantized``
    flag: the pools' own type says it here)."""

    def call(q, k_pages, v_pages, lengths, page_indices):
        return paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                                      sm_scale=sm_scale, pages_per_block=pages_per_block)

    return call


def context_sharded_paged_decode(mesh: Mesh, *, sm_scale: Optional[float] = None,
                                 pages_per_block: Optional[int] = None,
                                 context_axis: str = "context"):
    """Context-sharded decode for sequences whose KV exceeds one rank.

    Local shapes: q [B, Hq, d] (replicated); pools [Hkv, P_local, page_size,
    d]; lengths [B] this rank's token count of each sequence; page_indices
    [B, pages_per_seq_local] into the local pool.  A rank holding no tokens
    of a sequence contributes the identity partial (O = 0, lse
    DEFAULT_MASK_VALUE, what the kernel returns for length 0).  Returns the
    full O [B, Hq, d] on every rank."""

    def call(q, k_pages, v_pages, lengths, page_indices):
        o, lse = paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                                        sm_scale=sm_scale, pages_per_block=pages_per_block,
                                        return_lse=True)
        os_ = all_gather(o.float(), mesh, context_axis)
        ls_ = all_gather(lse, mesh, context_axis)
        oc, lc = os_[0], ls_[0]
        for o_i, l_i in zip(os_[1:], ls_[1:]):
            oc, lc = merge_partials(oc, lc, o_i, l_i)
        return oc.to(q.dtype)

    return call
