"""Attention backward kernels: wrappers, plain version and launch counts.

The kernels are ``csrc/attn_bwd.cu``: ``attn_bwd_preprocess``
(D = rowsum(O ∘ dO)), ``attn_bwd_dkv`` and ``attn_bwd_dq``.  Together they
replace the six backward TPU kernels of the JAX package —
``ops/fwd_small.py::_small_bwd_kernel``, ``ops/bwd_kernel.py::_bwd_d_kernel``,
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``,
``ops/bwd_fused.py::_bwd_fused_kernel`` and ``ops/bwd_mid.py::_bwd_mid_kernel``
— for the forward's feature set (causal or not, GQA, ragged lengths, window,
softcap).  The result is deterministic: every sum runs in a fixed order and
no kernel uses atomics.  :func:`attn_bwd` sends CPU tensors to the plain
PyTorch version :func:`attn_bwd_plain` and CUDA tensors to the kernels;
each kernel's wrapper likewise has a plain version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, stream_handle
from .fwd_kernel import _PLAIN_CHUNK_ELEMS, KERNEL_HEAD_DIMS

PREPROCESS_KERNEL = CudaKernel(
    "attn_bwd.cu",
    "attn_bwd_preprocess",
    [ctypes.c_void_p] * 3  # o, dout, delta
    + [ctypes.c_int] * 3  # dtype, rows, D
    + [ctypes.c_void_p],  # stream
)
_SWEEP_ARGS = (
    [ctypes.c_int] * 6  # dtype, B, Hq, Hkv, Nq, Nkv
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_void_p]  # stream
)
DKV_KERNEL = CudaKernel(
    "attn_bwd.cu",
    "attn_bwd_dkv",
    [ctypes.c_void_p] * 8  # q, k, v, dout, lse, delta, dk, dv
    + _SWEEP_ARGS,
)
DQ_KERNEL = CudaKernel(
    "attn_bwd.cu",
    "attn_bwd_dq",
    [ctypes.c_void_p] * 7  # q, k, v, dout, lse, delta, dq
    + _SWEEP_ARGS,
)


def _check_cuda(q, k, v, o, lse, do) -> None:
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16:  # the kernels stage tiles with 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"attn_bwd kernels take fp32/bf16/fp16, not {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attn_bwd kernels take head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse {tuple(lse.shape)} "
            f"do not match q {tuple(q.shape)}")


def attn_bwd_preprocess(o, do):
    """D = rowsum(O ∘ dO), [B, Hq, Nq] fp32: the preprocess kernel on a CUDA
    device, :func:`attn_bwd_preprocess_plain` on the CPU."""
    if o.device.type == "cpu":
        return attn_bwd_preprocess_plain(o, do)
    delta = torch.empty(o.shape[:3], dtype=torch.float32, device=o.device)
    PREPROCESS_KERNEL.launch(
        ptr(o), ptr(do), ptr(delta), DTYPE_CODES[o.dtype],
        o.numel() // o.shape[-1], o.shape[-1], stream_handle(o.device))
    return delta


def _sweep_args(q, k, causal, sm_scale, window, softcap):
    b, hq, n_q, d = q.shape
    return (DTYPE_CODES[q.dtype], b, hq, k.shape[1], n_q, k.shape[2], d,
            float(sm_scale), int(bool(causal)), int(window), float(softcap),
            stream_handle(q.device))


def attn_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                 softcap=0.0):
    """(dK, dV) [B, Hkv, Nkv, d] in k's dtype: the dK/dV sweep kernel on a
    CUDA device, :func:`attn_bwd_dkv_plain` on the CPU."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return attn_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    DKV_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                      ptr(dk), ptr(dv), *_sweep_args(q, k, **kw))
    return dk, dv


def attn_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                softcap=0.0):
    """dQ [B, Hq, Nq, d] in q's dtype: the dQ sweep kernel on a CUDA device,
    :func:`attn_bwd_dq_plain` on the CPU."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return attn_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dq = torch.empty_like(q)
    DQ_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                     ptr(dq), *_sweep_args(q, k, **kw))
    return dq


def attn_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
             window: int = 0, softcap: float = 0.0):
    """(dQ, dK, dV) of O = softmax(scale·QKᵀ (softcapped) + mask)V, given the
    forward's O and natural-base lse [B, Hq, Nq] and the output gradient dO.

    Arguments are validated by the caller (ops/flash_attention.py).  CPU
    tensors take :func:`attn_bwd_plain`; CUDA tensors launch the three
    kernels (preprocess, dK/dV sweep, dQ sweep), which take contiguous
    fp32/bf16/fp16 inputs with d in {64, 128}, or raise."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return attn_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attn_bwd runs on cpu or cuda, not {q.device}")
    _check_cuda(q, k, v, o, lse, do)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = attn_bwd_preprocess(o, do)
    dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return attn_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


# ---------------------------------------------------------------------------
# Plain versions: the same functions in fp32 on the inputs' device
# ---------------------------------------------------------------------------


def attn_bwd_preprocess_plain(o, do):
    """Plain version of the preprocess kernel."""
    return (o.float() * do.float()).sum(dim=-1)


def _plain_sweep(q, k, v, do, lse, delta, *, causal, sm_scale, window,
                 softcap):
    """Per chunk of q rows (bounding the score matrix's memory): the row
    slice, q and dO in fp32, P and dS, and K expanded to the q heads.  P is
    rebuilt from the passed lse as exp(S − lse), exactly 0 where masked (so
    a row that saw no key, whose lse is DEFAULT_MASK_VALUE, gives 0)."""
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hq != hkv:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    col = torch.arange(n_kv, device=q.device)[None, :]
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * hq * n_kv))
    for r0 in range(0, n_q, rows):
        r1 = min(n_q, r0 + rows)
        qc, doc = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        x = torch.matmul(qc, kf.transpose(-1, -2)) * sm_scale
        if softcap:
            x = softcap * torch.tanh(x / softcap)
        p = torch.exp(x - lse[:, :, r0:r1, None])
        if causal:
            pos = torch.arange(r0, r1, device=q.device)[:, None] + (n_kv - n_q)
            seen = col <= pos
            if window:
                seen = seen & ((pos - col) < window)
            p = torch.where(seen, p, 0.0)
        ds = p * (torch.matmul(doc, vf.transpose(-1, -2))
                  - delta[:, :, r0:r1, None])
        if softcap:
            ds = ds * (1.0 - (x / softcap) ** 2)
        yield slice(r0, r1), qc, doc, p, ds, kf


def attn_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal, sm_scale,
                       window=0, softcap=0.0):
    """Plain version of the dK/dV sweep kernel."""
    b, hq, _, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    dk = torch.zeros((b, hq, n_kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, qc, doc, p, ds, _ in _plain_sweep(
            q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
            window=window, softcap=softcap):
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dv += torch.matmul(p.transpose(-1, -2), doc)
    dk *= sm_scale
    if hq != hkv:
        dk = dk.view(b, hkv, hq // hkv, n_kv, d).sum(dim=2)
        dv = dv.view(b, hkv, hq // hkv, n_kv, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def attn_bwd_dq_plain(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                      softcap=0.0):
    """Plain version of the dQ sweep kernel."""
    dq = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    for rows, _, _, _, ds, kf in _plain_sweep(
            q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
            window=window, softcap=softcap):
        dq[:, :, rows] = (torch.matmul(ds, kf) * sm_scale).to(q.dtype)
    return dq


def attn_bwd_plain(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
                   window: int = 0, softcap: float = 0.0):
    """Plain PyTorch version of :func:`attn_bwd`: the three kernels' plain
    versions in turn, in fp32 on the inputs' device."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap)
    delta = attn_bwd_preprocess_plain(o, do)
    dk, dv = attn_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return attn_bwd_dq_plain(q, k, v, do, lse, delta, **kw), dk, dv
