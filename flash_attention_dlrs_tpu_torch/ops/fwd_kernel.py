"""Attention forward kernel: wrapper, plain version and launch count.

The kernel is ``csrc/attn_fwd.cu``; it replaces the forward of the TPU
kernels ``ops/fwd_kernel.py::_fwd_kernel``, ``ops/fwd_mid.py::_mid_kernel``,
``ops/fwd_mid.py::_mid_strip_kernel`` and ``ops/fwd_small.py::_small_kernel``
of the JAX package for the serving feature set (causal or not, GQA, ragged
lengths, window, softcap).  :func:`attn_fwd` sends CPU tensors to the plain
PyTorch version :func:`attn_fwd_plain` and CUDA tensors to the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, stream_handle

# Finite sentinel for masked scores and the lse of a row that sees no key.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

KERNEL_HEAD_DIMS = (64, 128)

FWD_KERNEL = CudaKernel(
    "attn_fwd.cu",
    "attn_fwd",
    [ctypes.c_void_p] * 5  # q, k, v, o, lse
    + [ctypes.c_int] * 7  # dtype, B, Hq, Hkv, Nq, Nkv, D
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_void_p],  # stream
)

# Rows of scores the plain version materializes at once (bounds its memory).
_PLAIN_CHUNK_ELEMS = 1 << 26


def attn_fwd(q, k, v, *, causal: bool, sm_scale: float, window: int = 0,
             softcap: float = 0.0):
    """(O [B, Hq, Nq, d] in q's dtype, L [B, Hq, Nq] fp32 natural-base lse).

    Arguments are validated by the caller (ops/flash_attention.py).  CPU
    tensors take :func:`attn_fwd_plain`; CUDA tensors launch the kernel,
    which takes contiguous fp32/bf16/fp16 inputs with d in {64, 128}, or
    raise."""
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                              window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attn_fwd runs on cpu or cuda, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16:  # the kernel stages tiles with 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"attn_fwd kernel takes fp32/bf16/fp16, not {q.dtype}")
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attn_fwd kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, n_q), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        lse.fill_(DEFAULT_MASK_VALUE)
        return o, lse
    FWD_KERNEL.launch(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
        DTYPE_CODES[q.dtype], b, hq, hkv, n_q, n_kv, d,
        float(sm_scale), int(bool(causal)), int(window), float(softcap),
        stream_handle(q.device),
    )
    return o, lse


def attn_fwd_plain(q, k, v, *, causal: bool, sm_scale: float, window: int = 0,
                   softcap: float = 0.0):
    """Plain PyTorch version of the kernel: the same function in fp32 on the
    inputs' device, in chunks of q rows so the score matrix stays bounded.
    Empty rows give O = 0 and L = DEFAULT_MASK_VALUE."""
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hq != hkv:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    kt = kf.transpose(-1, -2)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, n_q), dtype=torch.float32, device=q.device)
    col = torch.arange(n_kv, device=q.device)[None, :]
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * hq * n_kv))
    for r0 in range(0, n_q, rows):
        r1 = min(n_q, r0 + rows)
        s = torch.matmul(q[:, :, r0:r1].float(), kt) * sm_scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            pos = torch.arange(r0, r1, device=q.device)[:, None] + (n_kv - n_q)
            visible = col <= pos
            if window:
                visible = visible & ((pos - col) < window)
            s = s.masked_fill(~visible, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        empty = torch.isneginf(m)
        p = torch.exp(s - torch.where(empty, 0.0, m))
        l = p.sum(dim=-1, keepdim=True)
        o[:, :, r0:r1] = (
            torch.matmul(p, vf) / torch.where(empty, 1.0, l)
        ).to(q.dtype)
        lse[:, :, r0:r1] = torch.where(
            empty, DEFAULT_MASK_VALUE, m + torch.log(l))[..., 0]
    return o, lse
