"""Paged decode attention, PyTorch port of ``flash_attention_dlrs_tpu/ops/decode.py``.

Single-token attention over a paged KV cache: pools are
``[Hkv, P, page_size, d]``, a page table ``[B, pages_per_seq]`` maps each
sequence's tokens to pool pages, and ``lengths`` ``[B]`` masks each
sequence.  The kernel is ``csrc/paged_decode.cu`` (replaces the unquantized
single-token path of the TPU kernel ``ops/decode.py::_decode_kernel``);
:func:`paged_reference_attention` is its plain PyTorch version, which CPU
tensors take.  Quantized pools, ALiBi and the multi-token verify mode raise
``NotImplementedError`` until their slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, stream_handle
from .fwd_kernel import DEFAULT_MASK_VALUE, KERNEL_HEAD_DIMS

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 2 of the PyTorch port)"

DECODE_KERNEL = CudaKernel(
    "paged_decode.cu",
    "paged_decode",
    [ctypes.c_void_p, ctypes.c_int,  # q, q dtype
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # k/v pools, kv dtype
     ctypes.c_void_p, ctypes.c_void_p,  # lengths, page table
     ctypes.c_void_p, ctypes.c_void_p]  # o, lse
    + [ctypes.c_int] * 7  # B, Hq, Hkv, P, page_size, pages_per_seq, D
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],  # scale, cap, stream
)


def _check_pools(k_pages, v_pages):
    if not (torch.is_tensor(k_pages) and torch.is_tensor(v_pages)):
        raise NotImplementedError(_NOT_YET.format("quantized KV pages"))
    if k_pages.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        if k_pages.dtype in (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
            raise NotImplementedError(_NOT_YET.format("quantized KV pages"))
        raise ValueError(
            f"KV pools must share one of fp32/bf16/fp16, got "
            f"{k_pages.dtype} and {v_pages.dtype}"
        )
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "k_pages and v_pages must both be [Hkv, P, page_size, d]; got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )


def paged_decode_attention(
    q,  # [B, Hq, d]
    k_pages,  # [Hkv, P, page_size, d]
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

    GQA: q head h reads kv head h // (Hq / Hkv).  ``pages_per_block`` (a TPU
    DMA tuning knob) is accepted and ignored.  The caller guarantees that
    every page id a sequence's length reaches is a valid pool page.  CPU
    tensors take :func:`paged_reference_attention`; CUDA tensors launch the
    kernel or raise."""
    del pages_per_block
    if alibi_slopes is not None:
        raise NotImplementedError(_NOT_YET.format("alibi_slopes in decode"))
    _check_pools(k_pages, v_pages)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads, num_pages, page_size, d_pool = k_pages.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must divide by num_kv_heads "
            f"({num_kv_heads})"
        )
    if d_pool != head_dim:
        raise ValueError(f"q head_dim {head_dim} != pool head_dim {d_pool}")
    if lengths.shape != (batch,) or page_indices.ndim != 2 or (
            page_indices.shape[0] != batch):
        raise ValueError(
            f"lengths must be [B] and page_indices [B, pages_per_seq]; got "
            f"{tuple(lengths.shape)} and {tuple(page_indices.shape)}"
        )
    if logit_softcap < 0:
        raise ValueError(f"logit_softcap must be >= 0, got {logit_softcap}")
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    if q.device.type == "cpu":
        o, lse = paged_reference_attention(
            q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
            logit_softcap=logit_softcap, return_lse=True,
        )
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cpu or cuda, not {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths), ("page_indices", page_indices)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:  # the kernel stages rows with 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("lengths and page_indices must be int32")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"paged decode kernel takes fp32/bf16/fp16 q, not {q.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged decode kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    o = torch.empty_like(q)
    lse = (torch.empty((batch, num_q_heads), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    if batch:
        DECODE_KERNEL.launch(
            ptr(q), DTYPE_CODES[q.dtype], ptr(k_pages), ptr(v_pages),
            DTYPE_CODES[k_pages.dtype], ptr(lengths), ptr(page_indices),
            ptr(o), ptr(lse), batch, num_q_heads, num_kv_heads, num_pages,
            page_size, page_indices.shape[1], head_dim, float(sm_scale),
            float(logit_softcap), stream_handle(q.device),
        )
    return (o, lse) if return_lse else o


def paged_verify_attention(*args, **kwargs):
    """Multi-token paged attention (speculative verify / chunked prefill)."""
    raise NotImplementedError(_NOT_YET.format("paged_verify_attention"))


def paged_reference_attention(
    q, k_pages, v_pages, lengths, page_indices, *, sm_scale=None,
    alibi_slopes=None, logit_softcap: float = 0.0, return_lse: bool = False,
):
    """Plain version: gather pages into dense K/V, masked fp32 softmax
    attention.  Lengths beyond the page table are clamped to it.  With
    ``return_lse`` also the natural-base logsumexp (DEFAULT_MASK_VALUE for
    an empty sequence)."""
    if alibi_slopes is not None:
        raise NotImplementedError(_NOT_YET.format("alibi_slopes in decode"))
    _check_pools(k_pages, v_pages)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads, _, page_size, d_pool = k_pages.shape
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    idx = page_indices.long()
    max_len = idx.shape[1] * page_size
    # [Hkv, B, pps, ps, d] -> [B, Hkv, max_len, d]
    k_dense = k_pages[:, idx].movedim(1, 0).reshape(
        batch, num_kv_heads, max_len, d_pool).float()
    v_dense = v_pages[:, idx].movedim(1, 0).reshape(
        batch, num_kv_heads, max_len, d_pool).float()
    group = num_q_heads // num_kv_heads
    qg = q.float().reshape(batch, num_kv_heads, group, head_dim)
    s = torch.matmul(qg, k_dense.transpose(-1, -2)) * sm_scale  # [B,Hkv,G,L]
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(max_len, device=q.device)
    mask = pos[None, :] < lengths.to(q.device).long()[:, None]  # [B, L]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    e = torch.exp(s - torch.where(empty, 0.0, m))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e, v_dense) / torch.where(empty, 1.0, l)
    o = o.reshape(batch, num_q_heads, head_dim).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(empty, DEFAULT_MASK_VALUE, m + torch.log(l))
    return o, lse.reshape(batch, num_q_heads)
