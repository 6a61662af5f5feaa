"""Paged attention over a KV cache, PyTorch port of ``flash_attention_dlrs_tpu/ops/decode.py``.

Pools are ``[Hkv, P, page_size, d]`` tensors (fp32 / bf16 / fp16), or
quantized: a :class:`~.quantization.QuantizedTensor` (int8, fp8 e4m3fn or
e5m2 payload) or an :class:`~.quantization.Int4QuantizedTensor` (two tokens
per byte, ``[Hkv, P, page_size/2, d]``), each with per-token fp32 scales
``[Hkv, P, page_size, 1]``.  A page table ``[B, pages_per_seq]`` maps each
sequence's tokens to pool pages, and ``lengths`` ``[B]`` masks each
sequence.  Two kernels replace the TPU kernel
``ops/decode.py::_decode_kernel``: ``csrc/paged_decode.cuh`` its single-token
mode (:func:`paged_decode_attention`) and ``csrc/paged_verify.cuh`` its
multi-token verify mode (:func:`paged_verify_attention`, on the route of
:func:`verify_route`), each built once for each pool head dim
(:func:`paged_kernels`: ``paged_decode.cu`` and ``paged_verify.cu`` at 128,
``*_d64.cu`` and ``*_d256.cu``, verify from fp16 q at 256 in
``paged_verify_d256_f16.cu``; every pool head dim above 256 that is a
multiple of 128 in ``paged_verify_wide.cu`` and, up to 1024,
``paged_decode_wide.cu``, above it ``paged_decode_chunk.cu``: the kernels of
``csrc/wide.cuh``).  Both may cut
each page table into key splits of whole pages (:func:`decode_splits`, from
static shapes only, unless the caller sets ``pages_per_block``, the pages of
one split: :func:`key_splits`; :func:`tuned_pages_per_block` times the
choices) whose normalized partials are merged by lse weight
(:func:`combine_partials`).
CPU tensors take the plain versions, :func:`paged_decode_plain` and
:func:`paged_verify_plain`: :func:`paged_reference_attention` for
single-token value pools, and for every other mode the TPU kernel's own
arithmetic (integer scores for int8/int4 decode, scales folded into S and
P).  :func:`paged_reference_attention` is also the oracle: quantized pools
are dequantized first.  ``alibi_slopes`` adds the true ALiBi bias
−m_h·(q_pos − col) after the scales and the softcap, q_pos = length − 1 in
decode and length − T + t for verify row t; the lse that decode returns
keeps the JAX package's convention, shifted by +m_h·(length − 1).

Pools may be wider than q's head_dim (``models/decoding.py`` allocates them
at the kernels' width, :func:`.fwd_kernel.kernel_width`, as the JAX package
pads them to 128 lanes): q is zero-padded to the pool's head dim on every
device, ``sm_scale`` defaults to q's own head_dim**-0.5, and O is sliced
back.  The kernels take pool head dims 64, 128 and 256 and the wide ones
(every multiple of 128 above 256), each with every mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, register_launch_counts
from .flash_attention import _normalize_alibi
from ..geometry import WIDE_ROWS, chunked, is_wide, wide_cut
from .fwd_kernel import (
    DEFAULT_MASK_VALUE, KERNEL_WIDTHS, _slopes_on, check_kernel_head_dim, pad_head_dim,
)
from .quantization import (
    Int4QuantizedTensor,
    QuantizedTensor,
    quantize,
    quantize_int4,
    unpack_int4_rows,
)

# Pool kinds of the C interfaces (csrc/paged.cuh PoolKind).
POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3, "int4": 4, torch.float8_e4m3fn: 5,
              torch.float8_e5m2: 6}
_PAYLOADS = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)
_INV_127 = 1.0 / 127.0

_POOL_ARGS = [
    ctypes.c_void_p, ctypes.c_int,  # q, q dtype
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # k/v pools, pool kind
    ctypes.c_void_p, ctypes.c_void_p,  # k/v scales
    ctypes.c_void_p, ctypes.c_void_p,  # lengths, page table
]

_DECODE_ARGS = (
    _POOL_ARGS + [ctypes.c_void_p] * 5  # o, lse, split partials O and lse, counters
    + [ctypes.c_int] * 8  # B, Hq, Hkv, P, page_size, pages_per_seq, D, splits
    + [ctypes.c_float, ctypes.c_float]  # scale, cap
    + [ctypes.c_void_p, ctypes.c_void_p]  # ALiBi slopes, stream
)

_VERIFY_ARGS = (
    _POOL_ARGS + [ctypes.c_void_p] * 3  # o, split partials O and lse
    + [ctypes.c_int] * 9  # B, Hq, Hkv, T, P, page_size, pages_per_seq, D, splits
    + [ctypes.c_float, ctypes.c_float]  # scale_q, cap
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # ALiBi slopes, route, stream
)
# Each paged kernel's builds, one for each pool head dim.
DECODE_KERNEL = CudaKernel("paged_decode.cu", "paged_decode", _DECODE_ARGS)
DECODE_D64_KERNEL = CudaKernel("paged_decode_d64.cu", "paged_decode_d64", _DECODE_ARGS)
DECODE_D256_KERNEL = CudaKernel("paged_decode_d256.cu", "paged_decode_d256", _DECODE_ARGS)
VERIFY_KERNEL = CudaKernel("paged_verify.cu", "paged_verify", _VERIFY_ARGS)
VERIFY_D64_KERNEL = CudaKernel("paged_verify_d64.cu", "paged_verify_d64", _VERIFY_ARGS)
VERIFY_D256_KERNEL = CudaKernel("paged_verify_d256.cu", "paged_verify_d256", _VERIFY_ARGS)
VERIFY_D256_F16_KERNEL = CudaKernel("paged_verify_d256_f16.cu", "paged_verify_d256_f16",
                                    _VERIFY_ARGS)
# Every pool head dim above 256 (csrc/wide.cuh): decode on asynchronous page
# copies to 1024 (its splits merged inside the launch, as at d <= 256), and
# above it column-chunked on the CUDA cores (DECODE_CHUNK_KERNEL, the split
# scratch its accumulator, splits merged by a second kernel); verify on
# warpgroup products (bf16 / fp16 q to 1024), column-chunked on mma.sync
# (bf16 / fp16 q above 1024) or column-chunked in fp32 (fp32 q).
DECODE_WIDE_KERNEL = CudaKernel("paged_decode_wide.cu", "paged_decode_wide", _DECODE_ARGS)
DECODE_CHUNK_KERNEL = CudaKernel("paged_decode_chunk.cu", "paged_decode_chunk", _DECODE_ARGS)
VERIFY_WIDE_KERNEL = CudaKernel("paged_verify_wide.cu", "paged_verify_wide", _VERIFY_ARGS)


def paged_kernels(head_dim: int, q_dtype=None):
    """(decode build, verify build) of a pool head dim: the module attributes
    ``DECODE[_D<d>]_KERNEL`` / ``VERIFY[_D<d>]_KERNEL`` (no suffix at d
    128; verify from fp16 ``q_dtype`` at d 256: ``VERIFY_D256_F16_KERNEL``;
    ``DECODE_WIDE_KERNEL`` / ``VERIFY_WIDE_KERNEL`` at a wide head dim,
    ``DECODE_CHUNK_KERNEL`` for decode above 1024), looked up at call time
    so that a check may swap a build."""
    if is_wide(head_dim):
        decode = "DECODE_CHUNK_KERNEL" if chunked(head_dim) else "DECODE_WIDE_KERNEL"
        return globals()[decode], globals()["VERIFY_WIDE_KERNEL"]
    dim = "" if head_dim == 128 else f"_D{head_dim}"
    f16 = "_F16" if head_dim == 256 and q_dtype == torch.float16 else ""
    return globals()[f"DECODE{dim}_KERNEL"], globals()[f"VERIFY{dim}{f16}_KERNEL"]


# Calls of each kernel by key-split count ({splits: calls}), beside its
# launch count (one a call: the last CTA of each group merges the splits);
# cleared by whoever reads them.
DECODE_SPLITS: dict = register_launch_counts({})
VERIFY_SPLITS: dict = register_launch_counts({})

# The verify C entries' route codes (csrc/paged_verify.cuh kRouteF32 /
# kRouteWgmma, csrc/wide.cuh kRouteWideF32 / kRouteWideWgmma /
# kRouteWideChunk) and the launches of each route.
VERIFY_ROUTE_CODES = {"fp32": 0, "wgmma": 1, "wide_fp32": 2, "wide_wgmma": 4, "wide_chunk": 5}
VERIFY_ROUTE_LAUNCHES = register_launch_counts(dict.fromkeys(VERIFY_ROUTE_CODES, 0))

# Tokens of one stored-row tile of csrc/paged_decode.cuh: the least a split
# covers.
SPLIT_MIN_TOKENS = 64
# The pool head dims both paged kernels are built for, besides the wide ones.
PAGED_HEAD_DIMS = KERNEL_WIDTHS

# Rows of one CTA of the verify kernel's wgmma route, and the most key
# splits it takes (its combine kernel keeps two splits' weights a lane).
VERIFY_ROW_TILE = 128
VERIFY_MAX_SPLITS = 64


def _positive_int(name, value) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(f"{name} must be a Python int, not {type(value).__name__}")
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")
    return value


def decode_splits(batch: int, num_kv_heads: int, pages_per_seq: int,
                  page_size: int, num_sms: int) -> int:
    """The number of key splits of a paged call, from static shapes only.

    It never reads ``lengths`` (a device tensor: reading it would
    synchronise every step and could not be captured in a CUDA graph).  It
    aims at two CTAs per SM: ceil(2 · num_sms / (batch · num_kv_heads))
    splits, each a whole number of pages and at least
    :data:`SPLIT_MIN_TOKENS` tokens (one tile), at most one per page; the
    count returned is the one that ``ceil(pages_per_seq / splits)`` pages
    a split gives (:func:`split_pages`).  1 means no split."""
    batch = _positive_int("batch", batch)
    num_kv_heads = _positive_int("num_kv_heads", num_kv_heads)
    pages_per_seq = _positive_int("pages_per_seq", pages_per_seq)
    page_size = _positive_int("page_size", page_size)
    num_sms = _positive_int("num_sms", num_sms)
    want = -(-2 * num_sms // (batch * num_kv_heads))
    per = max(-(-pages_per_seq // want), -(-SPLIT_MIN_TOKENS // page_size))
    return -(-pages_per_seq // min(per, pages_per_seq))


def decode_groups(batch: int, num_q_heads: int, num_kv_heads: int) -> int:
    """The counters a split decode call needs, at every pool head dim: one
    for each (sequence, kv head, pair of that kv head's q heads), the group
    of CTAs whose splits cover the same rows, whose last CTA merges them
    inside the launch (``csrc/paged.cuh`` ``last_of_group``)."""
    return batch * num_kv_heads * -(-(num_q_heads // num_kv_heads) // 2)


def key_splits(pages_per_seq: int, pages_per_block: int, max_splits: int = 0) -> int:
    """The key splits of a call whose caller asks for ``pages_per_block``
    pages a split: ceil(pages_per_seq / pages_per_block), at most
    ``max_splits`` (0: no cap), as :func:`split_pages` cuts the table."""
    pages_per_block = _positive_int("pages_per_block", pages_per_block)
    splits = -(-_positive_int("pages_per_seq", pages_per_seq) // pages_per_block)
    return split_pages(pages_per_seq, min(splits, max_splits) if max_splits else splits)[1]


def split_pages(pages_per_seq: int, splits: int):
    """(pages a split, splits) when a table of ``pages_per_seq`` pages is cut
    into at most ``splits`` runs of whole pages: ceil(pages_per_seq /
    splits) pages each, the last run shorter; the count is what those runs
    need (at most ``splits``, at most one per page)."""
    per = -(-pages_per_seq // min(_positive_int("splits", splits), pages_per_seq))
    return per, -(-pages_per_seq // per)


def combine_partials(o_parts, lse_parts):
    """The merge of a split call (decode: csrc/paged_decode.cuh merge_rows,
    by the last CTA of each group; verify: csrc/paged_verify.cuh
    paged_verify_combine_kernel): ``o_parts`` [S, ..., d] fp32 partial
    attentions, each normalized over its own keys, and ``lse_parts``
    [S, ...] their natural-base lse (-inf where a split saw no key) merged
    by lse weight, O = Σ w_s O_s / Σ w_s with w_s = exp(lse_s − max lse), as
    a fold of the JAX package's ``parallel/ring.py`` ``merge_partials``
    would.  A partial of lse −inf weighs exactly 0 (its O is never read); a
    row no split saw gets O = 0 and lse DEFAULT_MASK_VALUE.  Returns (O
    fp32, lse)."""
    m = lse_parts.amax(dim=0)
    live = ~torch.isneginf(lse_parts)
    w = torch.where(live, torch.exp(lse_parts - torch.where(torch.isneginf(m), 0.0, m)), 0.0)
    w_sum = w.sum(dim=0)
    acc = (w[..., None] * torch.where(live[..., None], o_parts, 0.0)).sum(dim=0)
    seen = w_sum > 0
    o = torch.where(seen[..., None], acc / torch.where(seen, w_sum, 1.0)[..., None], 0.0)
    lse = torch.where(seen, m + torch.log(torch.where(seen, w_sum, 1.0)), DEFAULT_MASK_VALUE)
    return o, lse


def verify_route(q_dtype, pool_kind, page_size: int, head_dim: int,
                 alibi: bool = False) -> str:
    """The kernel route of a verify call, from its types alone:

    =========  =========================================================
    route      calls
    =========  =========================================================
    fp32       q in float32, any pool kind (CUDA cores, true fp32)
    wgmma      bf16 / fp16 q with a pool of q's own dtype or a quantized
               pool (int8, int4, e4m3, e5m2): the tensor cores
    wide_fp32  as fp32, at a wide pool head dim (``csrc/wide.cuh``)
    wide_wgmma as wgmma, at a wide pool head dim up to 1024
               (``csrc/wide.cuh``)
    wide_chunk as wgmma, at a wide pool head dim above 1024
               (``csrc/wide.cuh``, column-chunked on mma.sync; above
               1024 only verify takes this route: the forward and the
               sweeps take ``"wide_scores"``)
    =========  =========================================================

    ``pool_kind`` is a key of :data:`POOL_KINDS` (a dtype, or ``"int4"``).
    Every route takes every page size (int4: even) at d 64, 128 or 256, or
    (the wide routes) any multiple of 128 above 256, with or without
    ``alibi`` (kept so that a caller can name what it runs).  What no route
    takes raises."""
    del alibi
    check_kernel_head_dim(head_dim, "paged verify kernel", PAGED_HEAD_DIMS)
    if pool_kind not in POOL_KINDS:
        raise ValueError(f"paged verify kernel takes pools of {list(POOL_KINDS)}, "
                         f"not {pool_kind}")
    if page_size <= 0 or (pool_kind == "int4" and page_size % 2):
        raise ValueError(f"page_size {page_size} is not a page size of a {pool_kind} pool")
    wide = is_wide(head_dim)
    if q_dtype == torch.float32:
        return "wide_fp32" if wide else "fp32"
    if q_dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"paged verify kernel takes fp32/bf16/fp16 q, not {q_dtype}")
    if pool_kind in DTYPE_CODES and pool_kind != q_dtype:
        raise ValueError(
            f"paged verify kernel takes {q_dtype} q with quantized pools or "
            f"{q_dtype} pools, not {pool_kind}")
    if chunked(head_dim):
        return "wide_chunk"
    return "wide_wgmma" if wide else "wgmma"


def verify_ctas_per_split(route: str, rows: int, head_dim: int) -> int:
    """CTAs of one key split of a verify call, per (sequence, kv head), over
    its ``rows`` = T · G rows: blocks of :data:`VERIFY_ROW_TILE` rows on the
    ``"wgmma"`` route; on ``"wide_wgmma"`` blocks of 64 rows, each a
    cluster of the CTAs that split the head dim (:func:`..geometry.wide_cut`);
    on ``"wide_fp32"`` and ``"wide_chunk"`` blocks of 64 rows times the
    128-column chunks of the head dim; on ``"fp32"`` (which does not split)
    blocks of 64 rows."""
    if route == "wgmma":
        return -(-rows // VERIFY_ROW_TILE)
    if route == "wide_wgmma":
        return -(-rows // WIDE_ROWS) * wide_cut(head_dim)[0]
    if route in ("wide_fp32", "wide_chunk"):
        return -(-rows // WIDE_ROWS) * (head_dim // 128)
    return -(-rows // WIDE_ROWS)


def verify_splits(route: str, batch: int, num_q_heads: int, num_kv_heads: int,
                  num_tokens: int, head_dim: int, pages_per_seq: int, page_size: int,
                  num_sms: int) -> int:
    """The key splits of a verify call on ``route`` that names none, from
    static shapes: one CTA fills an SM, so :func:`decode_splits` asked for
    its two an SM of half the SMs, counting each (sequence, kv head)'s CTAs
    of a split (:func:`verify_ctas_per_split`) as its batch; at most
    :data:`VERIFY_MAX_SPLITS`, cut to whole pages (:func:`split_pages`).
    The fp32 route takes 1."""
    if route == "fp32":
        return 1
    ctas = verify_ctas_per_split(route, num_tokens * (num_q_heads // num_kv_heads), head_dim)
    splits = decode_splits(batch * ctas, num_kv_heads, pages_per_seq, page_size,
                           max(1, num_sms // 2))
    return split_pages(pages_per_seq, min(splits, VERIFY_MAX_SPLITS))[1]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The scratch of the split calls, per device and stream (calls on one
# stream run one after another; calls that may run at once never share
# it): fp32 partials, and decode's uint32 counters, which each kernel
# leaves zero (csrc/paged_decode.cuh last_of_group).  Grown, never shrunk.
_SCRATCH: dict = {}


def _split_scratch(splits: int, rows: int, head_dim: int, groups: int, device, stream: int,
                   always: bool = False):
    """Addresses of the partial O [splits, rows, d] and lse [splits, rows]
    and of ``groups`` counters of a split call on ``stream``; 0s without
    a split (and for the counters, without groups), unless ``always`` (the
    chunked decode accumulates O in the partials at every split count)."""
    if splits == 1 and not always:
        return 0, 0, 0
    need = splits * rows * (head_dim + 1)
    key = (device.index, stream)
    buf, counters = _SCRATCH.get(key, (None, None))
    if buf is None or buf.numel() < need:
        buf = torch.empty(need, dtype=torch.float32, device=device)
    if groups and (counters is None or counters.numel() < groups):
        counters = torch.zeros(groups, dtype=torch.int32, device=device)
    _SCRATCH[key] = buf, counters
    base = buf.data_ptr()
    return (base, base + 4 * splits * rows * head_dim,
            counters.data_ptr() if groups else 0)


def split_scratch_on(device, stream: int):
    """The (partials, counters) tensors the split calls on ``stream`` use
    now, or None: a CUDA graph captured on that stream holds them, so that
    a later call there that needs more (and gets a new buffer) cannot free
    memory the graph's kernels address."""
    return _SCRATCH.get((device.index, stream))


class _Pools:
    """The two pools of one call, split into payloads, scales and kind."""

    def __init__(self, k_pages, v_pages):
        if type(k_pages) is not type(v_pages):
            raise ValueError(
                "k_pages and v_pages must be the same kind "
                f"({type(k_pages).__name__} vs {type(v_pages).__name__})")
        self.int4 = isinstance(k_pages, Int4QuantizedTensor)
        self.quantized = self.int4 or isinstance(k_pages, QuantizedTensor)
        if self.quantized:
            self.k, self.v = k_pages.values, v_pages.values
            self.k_sc, self.v_sc = k_pages.scales, v_pages.scales
        else:
            self.k, self.v = k_pages, v_pages
            self.k_sc = self.v_sc = None
        if self.k.dtype != self.v.dtype:
            raise ValueError(
                f"KV pools must share one dtype, got {self.k.dtype} and {self.v.dtype}")
        allowed = (torch.int8,) if self.int4 else (
            _PAYLOADS if self.quantized else tuple(DTYPE_CODES))
        if self.k.dtype not in allowed:
            raise ValueError(
                f"{type(k_pages).__name__} pools hold {allowed}, not {self.k.dtype}")
        if self.k.ndim != 4 or self.k.shape != self.v.shape:
            raise ValueError(
                "k_pages and v_pages must both be [Hkv, P, page_size, d]; got "
                f"{tuple(self.k.shape)} and {tuple(self.v.shape)}")
        hkv, num_pages, stored, _ = self.k.shape
        self.page_size = 2 * stored if self.int4 else stored
        if self.quantized:
            want = (hkv, num_pages, self.page_size, 1)
            for sc in (self.k_sc, self.v_sc):
                if tuple(sc.shape) != want or sc.dtype != torch.float32:
                    raise ValueError(
                        f"scales must be {want} float32, got "
                        f"{tuple(sc.shape)} {sc.dtype}")
        self.key = "int4" if self.int4 else self.k.dtype
        self.kind = POOL_KINDS[self.key]

    def tensors(self):
        return [t for t in (self.k, self.v, self.k_sc, self.v_sc) if t is not None]


def _check_call(q, pools, lengths, page_indices, num_q_heads, head_dim,
                logit_softcap):
    num_kv_heads, d_pool = pools.k.shape[0], pools.k.shape[3]
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must divide by num_kv_heads "
            f"({num_kv_heads})")
    if head_dim > d_pool:
        raise ValueError(f"q head_dim {head_dim} > pool head_dim {d_pool}")
    batch = q.shape[0]
    if lengths.shape != (batch,) or page_indices.ndim != 2 or (
            page_indices.shape[0] != batch):
        raise ValueError(
            f"lengths must be [B] and page_indices [B, pages_per_seq]; got "
            f"{tuple(lengths.shape)} and {tuple(page_indices.shape)}")
    if logit_softcap < 0:
        raise ValueError(f"logit_softcap must be >= 0, got {logit_softcap}")


def _check_cuda(q, pools, lengths, page_indices, head_dim, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {q.device}")
    for name, t in [("q", q), ("lengths", lengths),
                    ("page_indices", page_indices)] + [
                        ("pools", t) for t in pools.tensors()]:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t in (q, pools.k, pools.v):
        if t.data_ptr() % 16:  # the kernels stage rows with 16-byte loads
            raise ValueError("q and the pools must start on a 16-byte boundary")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("lengths and page_indices must be int32")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{what} kernel takes fp32/bf16/fp16 q, not {q.dtype}")
    check_kernel_head_dim(head_dim, f"{what} kernel", PAGED_HEAD_DIMS)


def _scale_in(sm_scale: float, dtype) -> float:
    """sm_scale rounded to ``dtype``: the JAX wrapper pre-scales q by
    ``jnp.asarray(sm_scale, q.dtype)``."""
    return float(torch.tensor(sm_scale, dtype=dtype))


def _clamped(lengths, max_len: int):
    return lengths.long().clamp(0, max_len)


def publish_lse(lse, slopes, lengths, max_len: int):
    """The decode lse in the JAX convention: the true logsumexp shifted by
    +m_h·(length − 1) under ALiBi (DEFAULT_MASK_VALUE stays for an empty
    sequence); unchanged without ALiBi."""
    if slopes is None:
        return lse
    n = _clamped(lengths.to(lse.device), max_len)[:, None]
    m = torch.tensor(slopes, dtype=torch.float32, device=lse.device)[None, :]
    return torch.where(n > 0, lse + m * (n - 1).float(), lse)


def paged_decode_attention(
    q,  # [B, Hq, d]
    k_pages,  # [Hkv, P, page_size, d], or a (Int4)QuantizedTensor
    v_pages,
    lengths,  # [B] int32
    page_indices,  # [B, pages_per_seq] int32
    *,
    sm_scale=None,
    pages_per_block=None,
    return_lse: bool = False,
    alibi_slopes=None,
    logit_softcap: float = 0.0,
):
    """O = softmax(scale·q·K_pagesᵀ (softcapped), masked to ``lengths``) ·
    V_pages, [B, Hq, d] in q's dtype; with ``return_lse`` also the
    natural-base logsumexp [B, Hq] fp32 (DEFAULT_MASK_VALUE for length 0).

    GQA: q head h reads kv head h // (Hq / Hkv).  Quantized pools (both of
    one kind) fold their scales into the scores and probabilities;
    int8/int4 K scores through per-row int8 q, as the TPU kernel does.
    ``pages_per_block`` is the pages of one key split (:func:`key_splits`);
    None leaves the splits to :func:`decode_splits`.
    ``alibi_slopes``: see the module docstring; the returned lse is then
    shifted by +m_h·(length − 1).  The caller guarantees that every page id
    a sequence's length reaches is a valid pool page.  CPU tensors take the
    plain versions (split and merged as the kernel would when
    ``pages_per_block`` is given); CUDA tensors launch
    ``csrc/paged_decode.cuh``, at a wide pool head dim ``csrc/wide.cuh``'s
    decode (either with its key splits merged inside the launch; above
    1024 the column-chunked decode, its splits merged by a second kernel),
    or raise."""
    pools = _Pools(k_pages, v_pages)
    batch, num_q_heads, d_true = q.shape
    _check_call(q, pools, lengths, page_indices, num_q_heads, d_true,
                logit_softcap)
    slopes = _normalize_alibi(alibi_slopes, num_q_heads, causal=True)
    if sm_scale is None:
        sm_scale = float(d_true) ** -0.5
    pages_per_seq = page_indices.shape[1]
    chosen = None if pages_per_block is None else key_splits(pages_per_seq, pages_per_block)
    if q.device.type == "cpu":
        o, lse = paged_decode_plain(
            q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
            logit_softcap=logit_softcap, return_lse=True, alibi_slopes=slopes,
            splits=chosen or 1)
        return (o, lse) if return_lse else o
    head_dim = pools.k.shape[3]
    q = pad_head_dim(q, head_dim)
    _check_cuda(q, pools, lengths, page_indices, head_dim, "paged decode")
    o = torch.empty_like(q)
    lse = (torch.empty((batch, num_q_heads), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    scale = _scale_in(sm_scale, q.dtype) if pools.quantized else float(sm_scale)
    if batch:
        num_kv_heads = pools.k.shape[0]
        splits = chosen or decode_splits(batch, num_kv_heads, pages_per_seq, pools.page_size,
                                         _num_sms(q.device.index or 0))
        wide_chunk = chunked(head_dim)
        groups = 0 if wide_chunk else decode_groups(batch, num_q_heads, num_kv_heads)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_o, part_lse, counters = _split_scratch(
            splits, batch * num_q_heads, head_dim, groups, q.device, stream,
            always=wide_chunk)
        paged_kernels(head_dim)[0].launch(
            ptr(q), DTYPE_CODES[q.dtype], ptr(pools.k), ptr(pools.v),
            pools.kind, ptr(pools.k_sc), ptr(pools.v_sc), ptr(lengths),
            ptr(page_indices), ptr(o), ptr(lse), ctypes.c_void_p(part_o),
            ctypes.c_void_p(part_lse), ctypes.c_void_p(counters), batch,
            num_q_heads, num_kv_heads, pools.k.shape[1], pools.page_size,
            pages_per_seq, head_dim, splits, scale, float(logit_softcap),
            ptr(None if slopes is None else _slopes_on(slopes, q.device)),
            ctypes.c_void_p(stream),
        )
        DECODE_SPLITS[splits] = DECODE_SPLITS.get(splits, 0) + 1
    o = o[..., :d_true]
    if not return_lse:
        return o
    return o, publish_lse(lse, slopes, lengths, page_indices.shape[1] * pools.page_size)


def tuned_pages_per_block(
    q,
    k_pages,
    v_pages,
    lengths,
    page_indices,
    *,
    sm_scale=None,
    alibi_slopes=None,
    logit_softcap: float = 0.0,
) -> int:
    """Timed search over ``pages_per_block`` (pages per key split) for this
    decode workload, cached on the JAX package's key (q shape, pool shape,
    pages_per_seq, payload dtype, pool kind, ALiBi, softcap); pass the
    serving configuration's ALiBi and softcap so that the search times the
    kernel instance that will run.  Candidates: powers of two up to
    pages_per_seq whose split covers at least :data:`SPLIT_MIN_TOKENS`
    tokens (a tile; pages_per_seq alone if none does).  Each is timed by
    device time, as replays of one call captured as a CUDA graph on the card
    (:func:`..tuning._time_call`)."""
    from .. import tuning

    pools = _Pools(k_pages, v_pages)
    pages_per_seq = page_indices.shape[1]
    cands, ppb = [], 1
    while ppb <= pages_per_seq:
        if ppb * pools.page_size >= SPLIT_MIN_TOKENS:
            cands.append(ppb)
        ppb *= 2
    cands = cands or [pages_per_seq]

    def build(ppb_):
        return lambda q_, k_, v_, lengths_, idx_: paged_decode_attention(
            q_, k_, v_, lengths_, idx_, sm_scale=sm_scale, pages_per_block=ppb_,
            alibi_slopes=alibi_slopes, logit_softcap=logit_softcap)

    return int(tuning.tune_decode_pages_per_block(
        build, cands,
        [list(q.shape), list(pools.k.shape), pages_per_seq, str(pools.k.dtype),
         type(k_pages).__name__, alibi_slopes is not None, float(logit_softcap)],
        (q, k_pages, v_pages, lengths, page_indices),
    ))


def paged_verify_attention(
    q,  # [B, Hq, T, d]: T new tokens per sequence
    k_pages,
    v_pages,
    lengths,  # [B] int32: FINAL lengths (after the T tokens are appended)
    page_indices,
    *,
    sm_scale=None,
    pages_per_block=None,
    alibi_slopes=None,
    logit_softcap: float = 0.0,
):
    """Multi-token paged attention: token t of the T new tokens attends to
    positions < lengths − (T−1−t).  The K/V of all T tokens must already be
    in the pages.  This is the kernel of chunked prefill and of speculative
    verification.  Returns [B, Hq, T, d] in q's dtype; a token that sees no
    position (front padding of a partial chunk) gets zeros.

    As on the TPU, verify always takes the dequantized score route (no int8
    q), scales folded into S and P.  CPU tensors take
    :func:`paged_verify_plain`; CUDA tensors launch ``csrc/paged_verify.cuh``
    (the build of the pool's head dim) on the route of :func:`verify_route`
    (bf16/fp16 q needs quantized pools
    or value pools of q's dtype; the ``"wgmma"`` route splits the keys as
    :func:`decode_splits` does, for its blocks of :data:`VERIFY_ROW_TILE`
    rows, or into ``pages_per_block`` pages a split, at most
    :data:`VERIFY_MAX_SPLITS`; the wide routes likewise for their CTAs,
    :func:`verify_splits`; the fp32 route does not split) or raise.
    ``alibi_slopes``: see the module docstring."""
    pools = _Pools(k_pages, v_pages)
    batch, num_q_heads, num_tokens, d_true = q.shape
    _check_call(q, pools, lengths, page_indices, num_q_heads, d_true,
                logit_softcap)
    slopes = _normalize_alibi(alibi_slopes, num_q_heads, causal=True)
    if sm_scale is None:
        sm_scale = float(d_true) ** -0.5
    chosen = None if pages_per_block is None else key_splits(
        page_indices.shape[1], pages_per_block, VERIFY_MAX_SPLITS)
    if q.device.type == "cpu":
        return paged_verify_plain(
            q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
            logit_softcap=logit_softcap, alibi_slopes=slopes)
    head_dim = pools.k.shape[3]
    q = pad_head_dim(q, head_dim)
    _check_cuda(q, pools, lengths, page_indices, head_dim, "paged verify")
    route = verify_route(q.dtype, pools.key, pools.page_size, head_dim, slopes is not None)
    o = torch.empty_like(q)
    if batch and num_tokens:
        num_kv_heads, pages_per_seq = pools.k.shape[0], page_indices.shape[1]
        splits = 1
        if route != "fp32" and chosen:
            splits = chosen
        elif route != "fp32":
            splits = verify_splits(route, batch, num_q_heads, num_kv_heads, num_tokens,
                                   head_dim, pages_per_seq, pools.page_size,
                                   _num_sms(q.device.index or 0))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_o, part_lse, _ = _split_scratch(
            splits, batch * num_q_heads * num_tokens, head_dim, 0, q.device, stream)
        paged_kernels(head_dim, q.dtype)[1].launch(
            ptr(q), DTYPE_CODES[q.dtype], ptr(pools.k), ptr(pools.v),
            pools.kind, ptr(pools.k_sc), ptr(pools.v_sc), ptr(lengths),
            ptr(page_indices), ptr(o), ctypes.c_void_p(part_o),
            ctypes.c_void_p(part_lse), batch, num_q_heads, num_kv_heads, num_tokens,
            pools.k.shape[1],
            pools.page_size, pages_per_seq, head_dim, splits,
            _scale_in(sm_scale, q.dtype), float(logit_softcap),
            ptr(None if slopes is None else _slopes_on(slopes, q.device)),
            VERIFY_ROUTE_CODES[route], ctypes.c_void_p(stream),
        )
        VERIFY_ROUTE_LAUNCHES[route] += 1
        VERIFY_SPLITS[splits] = VERIFY_SPLITS.get(splits, 0) + 1
    return o[..., :d_true]


# ---------------------------------------------------------------------------
# Plain versions and the oracle
# ---------------------------------------------------------------------------


def _dense(pool, idx, int4: bool):
    """[Hkv, P, rows, d] pool gathered through ``idx`` [B, pps] into
    [B, Hkv, pps * page_size, d]; int4 bytes are unpacked per page."""
    g = pool[:, idx]  # [Hkv, B, pps, rows, d]
    if int4:
        g = unpack_int4_rows(g)
    hkv, b = g.shape[:2]
    return g.movedim(1, 0).reshape(b, hkv, -1, g.shape[-1])


def _paged_plain(
    q, k_pages, v_pages, lengths, page_indices, *, sm_scale=None,
    logit_softcap: float = 0.0, s8_scores: bool = True,
    return_lse: bool = False, alibi_slopes=None, key_range=None,
):
    """Plain version of the kernels' modes, q [B, Hq, T, d], with the TPU
    kernel's arithmetic: q pre-scaled in its own dtype; payloads cast to
    q's dtype unscaled; with ``s8_scores`` and int8/int4 pools each q row
    quantized to int8 as round(q · (127 / max|q|)) and the score an exact
    integer dot times max|q| · (1/127); the K scale times S; softcap; the
    ALiBi bias −m·(q_pos − pos) with q_pos = length − T + t (length clamped
    to the table); row t masked to positions < lengths − (T−1−t); P ·
    v_scale rounded to q's dtype before P V.  A row that sees nothing gets
    O = 0 and lse DEFAULT_MASK_VALUE (the true lse).  Returns O [B, Hq, T,
    d] (and lse [B, Hq, T]).  With ``key_range`` (lo, hi) only positions
    in [lo, hi) are seen, and O is the split's fp32 partial with lse −inf
    where the split sees nothing (:func:`_split_decode`)."""
    pools = _Pools(k_pages, v_pages)
    b, hq, t, d_true = q.shape
    if sm_scale is None:
        sm_scale = float(d_true) ** -0.5
    d = pools.k.shape[3]
    q = pad_head_dim(q, d)  # pools wider than q (see the module docstring)
    hkv = pools.k.shape[0]
    g = hq // hkv
    idx = page_indices.long()
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    rows = qs.reshape(b, hkv, g, t, d).transpose(2, 3).reshape(b, hkv, t * g, d)
    k = _dense(pools.k, idx, pools.int4)
    v = _dense(pools.v, idx, pools.int4)
    if s8_scores and pools.kind in (POOL_KINDS[torch.int8], POOL_KINDS["int4"]):
        qf = rows.float()
        qa = qf.abs().amax(dim=-1, keepdim=True)
        inv = torch.where(qa > 0, torch.full_like(qa, 127.0) / qa, 0.0)
        # integers below 2^24 at every partial sum: the fp32 dot is exact
        s = torch.matmul(torch.round(qf * inv), k.float().transpose(-1, -2))
        s = s * (qa * _INV_127)
    else:
        s = torch.matmul(rows.float(), k.to(q.dtype).float().transpose(-1, -2))
    if pools.quantized:
        s = s * _dense(pools.k_sc, idx, False)[..., 0][:, :, None, :]
    if logit_softcap:
        s = logit_softcap * torch.tanh(s * (1.0 / logit_softcap))
    pos = torch.arange(s.shape[-1], device=q.device)
    row_t = torch.arange(t * g, device=q.device) // g
    horizon = lengths.to(q.device).long()[:, None] - (t - 1) + row_t  # [B, TG]
    if alibi_slopes is not None:
        qpos = _clamped(lengths.to(q.device), s.shape[-1])[:, None] - t + row_t
        m = torch.tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        m = m.reshape(hkv, 1, g).expand(hkv, t, g).reshape(hkv, t * g)
        s = s - m[None, :, :, None] * (qpos[:, None, :, None] - pos).float()
    hidden = pos >= horizon[:, None, :, None]
    if key_range is not None:
        hidden = hidden | (pos < key_range[0]) | (pos >= key_range[1])
    s = s.masked_fill(hidden, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    p = torch.exp(s - torch.where(empty, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    if pools.quantized:
        p = p * _dense(pools.v_sc, idx, False)[..., 0][:, :, None, :]
    acc = torch.matmul(p.to(q.dtype).float(), v.to(q.dtype).float())
    o = acc * torch.where(empty, 0.0, torch.full_like(l, 1.0) / l)
    o = o.reshape(b, hkv, t, g, d).transpose(2, 3).reshape(b, hq, t, d)[..., :d_true]
    if key_range is None:
        o = o.to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(empty, DEFAULT_MASK_VALUE if key_range is None else float("-inf"),
                      m + torch.log(l))
    return o, lse.reshape(b, hkv, t, g).transpose(2, 3).reshape(b, hq, t)


def _split_decode(q, k_pages, v_pages, lengths, page_indices, pools, key_range,
                  **kw):
    """Single-token attention over positions ``key_range`` (or all):
    value pools :func:`paged_reference_attention`'s arithmetic, quantized
    pools :func:`_paged_plain`'s (integer scores for int8/int4)."""
    if not pools.quantized:
        return _reference(q, k_pages, v_pages, lengths, page_indices,
                          key_range=key_range, **kw)
    o, lse = _paged_plain(q[:, :, None], k_pages, v_pages, lengths, page_indices,
                          s8_scores=True, return_lse=True, key_range=key_range, **kw)
    return o[:, :, 0], lse[:, :, 0]


def paged_decode_plain(q, k_pages, v_pages, lengths, page_indices, *,
                       sm_scale=None, logit_softcap: float = 0.0,
                       return_lse: bool = False, alibi_slopes=None, splits: int = 1):
    """Plain version of :func:`paged_decode_attention` (q [B, Hq, d]):
    value pools take :func:`paged_reference_attention`, quantized pools the
    TPU kernel's single-token arithmetic (:func:`_paged_plain`, integer
    scores for int8/int4); the lse is published as the wrapper does.

    ``splits`` repeats the kernel's key splits: the table is cut as
    :func:`split_pages` cuts it, each split's fp32 partial (O normalized
    over its keys, its lse) is computed alone and :func:`combine_partials`
    merges them."""
    pools = _Pools(k_pages, v_pages)
    slopes = _normalize_alibi(alibi_slopes, q.shape[1], causal=True)
    kw = dict(sm_scale=sm_scale, logit_softcap=logit_softcap, alibi_slopes=slopes)
    pages_per_seq = page_indices.shape[1]
    per, splits = split_pages(pages_per_seq, splits)
    if splits == 1:
        o, lse = _split_decode(q, k_pages, v_pages, lengths, page_indices, pools, None, **kw)
    else:
        span = per * pools.page_size
        parts = [_split_decode(q, k_pages, v_pages, lengths, page_indices, pools,
                               (i * span, (i + 1) * span), **kw) for i in range(splits)]
        o, lse = combine_partials(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]))
    o = o.to(q.dtype)
    if not return_lse:
        return o
    return o, publish_lse(lse, slopes, lengths, pages_per_seq * pools.page_size)


def paged_verify_plain(q, k_pages, v_pages, lengths, page_indices, *,
                       sm_scale=None, logit_softcap: float = 0.0,
                       alibi_slopes=None):
    """Plain version of ``csrc/paged_verify.cuh`` (q [B, Hq, T, d]): the
    TPU kernel's dequantized route."""
    return _paged_plain(
        q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
        logit_softcap=logit_softcap, s8_scores=False,
        alibi_slopes=_normalize_alibi(alibi_slopes, q.shape[1], causal=True))


def paged_reference_attention(
    q, k_pages, v_pages, lengths, page_indices, *, sm_scale=None,
    alibi_slopes=None, logit_softcap: float = 0.0, return_lse: bool = False,
):
    """Oracle, and the plain version of the single-token kernel on value
    pools: gather pages into dense K/V (quantized pools dequantized first),
    masked fp32 softmax attention, with the true ALiBi bias −m·(q_pos − pos)
    at q_pos = length − 1 when ``alibi_slopes`` are given.  Lengths beyond
    the page table are clamped to it.  With ``return_lse`` also the
    natural-base logsumexp, the true one (DEFAULT_MASK_VALUE for an empty
    sequence)."""
    o, lse = _reference(q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
                        alibi_slopes=alibi_slopes, logit_softcap=logit_softcap)
    o = o.to(q.dtype)
    return (o, lse) if return_lse else o


def _reference(q, k_pages, v_pages, lengths, page_indices, *, sm_scale=None,
               alibi_slopes=None, logit_softcap: float = 0.0, key_range=None):
    """:func:`paged_reference_attention`'s (O fp32, lse); with
    ``key_range`` (lo, hi) over positions [lo, hi) only, lse −inf where
    that range holds no visible position."""
    pools = _Pools(k_pages, v_pages)
    if pools.quantized:
        k_pages, v_pages = k_pages.dequantize(), v_pages.dequantize()
    batch, num_q_heads, d_true = q.shape
    num_kv_heads, _, page_size, head_dim = k_pages.shape
    if sm_scale is None:
        sm_scale = float(d_true) ** -0.5
    q = pad_head_dim(q, head_dim)  # pools wider than q (see the module docstring)
    idx = page_indices.long()
    max_len = idx.shape[1] * page_size
    k_dense = _dense(k_pages, idx, False).float()  # [B, Hkv, max_len, d]
    v_dense = _dense(v_pages, idx, False).float()
    group = num_q_heads // num_kv_heads
    qg = q.float().reshape(batch, num_kv_heads, group, head_dim)
    s = torch.matmul(qg, k_dense.transpose(-1, -2)) * sm_scale  # [B,Hkv,G,L]
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(max_len, device=q.device)
    slopes = _normalize_alibi(alibi_slopes, num_q_heads, causal=True)
    if slopes is not None:
        qpos = _clamped(lengths.to(q.device), max_len) - 1  # [B]
        m = torch.tensor(slopes, dtype=torch.float32, device=q.device)
        m = m.reshape(1, num_kv_heads, group, 1)
        s = s - m * (qpos[:, None, None, None] - pos).float()
    mask = pos[None, :] < lengths.to(q.device).long()[:, None]  # [B, L]
    if key_range is not None:
        mask = mask & (pos >= key_range[0]) & (pos < key_range[1])
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    e = torch.exp(s - torch.where(empty, 0.0, m))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e, v_dense) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, DEFAULT_MASK_VALUE if key_range is None else float("-inf"),
                      m + torch.log(l))
    return o.reshape(batch, num_q_heads, head_dim)[..., :d_true], lse.reshape(batch, num_q_heads)


def quantize_kv_pages(pages: torch.Tensor, dtype=torch.int8):
    """Per-token symmetric quantization of [Hkv, P, page_size, d] KV pages:
    a :class:`QuantizedTensor` (int8 / fp8 payload), or with
    ``dtype="int4"`` an :class:`Int4QuantizedTensor` (two tokens per byte
    along the page axis).  The H100 converts fp8 natively, so fp8 needs no
    warning here (the JAX package warns on TPUs without an fp8 datapath)."""
    if isinstance(dtype, str) and dtype == "int4":
        return quantize_int4(pages, axis=-1)
    return quantize(pages, dtype=dtype, axis=-1)
