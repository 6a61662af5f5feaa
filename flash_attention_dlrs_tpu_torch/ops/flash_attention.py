"""Public attention API, PyTorch port of ``flash_attention_dlrs_tpu/ops/flash_attention.py``.

- :func:`flash_attention_forward` returns ``(O, L)`` with L the natural-base
  logsumexp, ``[B, Hq, Nq]`` fp32;
- :func:`flash_attention_backward` returns ``(dQ, dK, dV)`` from the
  forward's O and L;
- :func:`flash_attention` is the differentiable op, a
  ``torch.autograd.Function`` in place of the JAX ``custom_vjp``: its
  forward saves (q, k, v, O, L) and its backward runs the backward kernels.

The JAX package splits the forward over four TPU routes and the backward
over six, chosen by length; here one forward kernel (``csrc/attn_fwd.cu``)
and one deterministic two-sweep backward family (``csrc/attn_bwd.cu``) take
every length, so there is no dispatch.  Segments, ALiBi, dropout and fp8 V
raise ``NotImplementedError`` until their slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from .bwd_kernel import attn_bwd
from .fwd_kernel import attn_fwd

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 2 of the PyTorch port)"
_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _validate(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4 [B,H,N,d]; got {tuple(q.shape)} "
            f"{tuple(k.shape)} {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q/k batch or head_dim mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"num_q_heads ({q.shape[1]}) must be a multiple of num_kv_heads "
            f"({k.shape[1]})"
        )
    if q.dtype != k.dtype:
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if v.dtype != q.dtype:
        if v.dtype in _FP8_DTYPES:
            raise NotImplementedError(_NOT_YET.format("fp8 V"))
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.float64:
        # Same refusal as the JAX package: a silent downcast would betray
        # the one reason to ask for fp64.
        raise NotImplementedError(
            "float64 attention is not supported; cast to float32 — the "
            "kernels' fp32 accumulators already give their best precision"
        )
    if q.dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; use fp32, bf16 or fp16")


def _normalize_window(window: int, causal: bool, n_kv: int) -> int:
    """Sliding-window size (tokens visible, including self).  0 disables;
    a window covering the whole sequence is normalized to 0 (plain causal)."""
    window = int(window)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is defined on the causal mask)")
    return 0 if window >= n_kv else window


def _prepare(q, k, v, causal, sm_scale, segment_ids, window, logit_softcap,
             alibi_slopes, dropout_rate):
    """Validate a call; returns (window, sm_scale) normalized."""
    _validate(q, k, v)
    if segment_ids is not None:
        raise NotImplementedError(_NOT_YET.format("segment_ids"))
    if alibi_slopes is not None:
        raise NotImplementedError(_NOT_YET.format("alibi_slopes"))
    if dropout_rate:
        raise NotImplementedError(_NOT_YET.format("attention dropout"))
    if logit_softcap < 0:
        raise ValueError(f"logit_softcap must be >= 0, got {logit_softcap}")
    window = _normalize_window(window, causal, k.shape[2])
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    return window, float(sm_scale)


def flash_attention_forward(
    q,
    k,
    v,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids=None,
    window: int = 0,
    logit_softcap: float = 0.0,
    alibi_slopes=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
):
    """Forward pass returning (O, L).  q: [B, Hq, Nq, d]; k, v:
    [B, Hkv, Nkv, d] with Hq % Hkv == 0.  ``sm_scale`` defaults to d**-0.5.
    Causal masking is bottom-right aligned (q row i sits at kv position
    i + Nkv − Nq).  L is the natural-base logsumexp of the scaled (and
    softcapped) scores, [B, Hq, Nq] fp32; a row that sees no key gets O = 0
    and L = DEFAULT_MASK_VALUE.  Runs where the inputs lie: the kernel on a
    CUDA device, the plain PyTorch version on the CPU."""
    window, sm_scale = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                                logit_softcap, alibi_slopes, dropout_rate)
    return attn_fwd(q, k, v, causal=bool(causal), sm_scale=sm_scale,
                    window=window, softcap=float(logit_softcap))


def flash_attention_backward(
    q,
    k,
    v,
    o,
    do,
    lse,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids=None,
    window: int = 0,
    logit_softcap: float = 0.0,
    alibi_slopes=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    rederive_stats: Optional[bool] = None,
):
    """Backward pass returning (dQ, dK, dV) in the dtypes of q, k and v.
    ``o`` and ``lse`` [B, Hq, Nq] come from the forward with the same
    arguments; ``do`` is the gradient of O.  The PASSED lse is honoured, as
    the JAX default does (a ring caller may pass a globally merged lse): P is
    rebuilt as exp(S − lse).  ``rederive_stats=True``, which replays the
    forward for its raw softmax statistics, is not ported.  Runs where the
    inputs lie: the kernels on a CUDA device, the plain PyTorch version on
    the CPU."""
    if rederive_stats:
        raise NotImplementedError(_NOT_YET.format("rederive_stats"))
    window, sm_scale = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                                logit_softcap, alibi_slopes, dropout_rate)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must match q "
            f"{tuple(q.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse {tuple(lse.shape)} must be [B, Hq, Nq] = "
                         f"{tuple(q.shape[:3])}")
    return attn_bwd(q, k, v, o.contiguous(), lse.contiguous(), do.contiguous(),
                    causal=bool(causal), sm_scale=sm_scale, window=window,
                    softcap=float(logit_softcap))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, softcap):
        o, lse = attn_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                          window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, window=window,
                      softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attn_bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids=None,
    window: int = 0,
    logit_softcap: float = 0.0,
    alibi_slopes=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
):
    """Differentiable fused attention O = softmax(scale·QKᵀ + mask)V, with
    the conventions of :func:`flash_attention_forward`; gradients flow to q,
    k and v through :func:`flash_attention_backward`'s kernels."""
    window, sm_scale = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                                logit_softcap, alibi_slopes, dropout_rate)
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale, window,
                                 float(logit_softcap))
