"""Naive attention oracle, PyTorch port of ``flash_attention_dlrs_tpu/ops/reference.py``.

A straightforward materialize-the-scores softmax attention in fp32: the
numerical oracle every test of the port holds its results against.  It
computes on whatever device its inputs lie on.
"""

from __future__ import annotations

import math

import torch

from .fwd_kernel import FP8_DTYPES, dropout_rows


def alibi_slopes_for(n_heads: int) -> tuple:
    """The standard ALiBi geometric slope schedule (Press et al. 2022):
    head i of H gets slope 2^(-8(i+1)/H), extended to non-power-of-2 head
    counts by interleaving the odd steps of the next power's schedule."""

    def pow2_slopes(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    n_floor = 2 ** int(math.floor(math.log2(n_heads)))
    if n_floor == n_heads:
        return tuple(pow2_slopes(n_heads))
    extra = pow2_slopes(2 * n_floor)[0::2][: n_heads - n_floor]
    return tuple(pow2_slopes(n_floor) + extra)


def reference_attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    sm_scale: float = 1.0,
    segment_ids=None,
    window: int = 0,
    logit_softcap: float = 0.0,
    alibi_slopes=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    with_lse: bool = False,
):
    """O = softmax(scale * Q K^T + mask) V with fp32 scores and softmax.

    q: [B, Hq, Nq, d]; k, v: [B, Hkv, Nkv, d] (GQA: Hq % Hkv == 0).  The
    causal mask is bottom-right aligned (q row i sits at kv position
    i + Nkv - Nq) and ``window`` (with ``causal``) keeps the last ``window``
    positions including the row's own.  ``alibi_slopes`` (one per q head)
    adds the true bias −m_h·(q_pos − col) after the softcap, q_pos aligned
    like the causal mask; ``dropout_rate`` multiplies the normalized P by
    the kernels' :func:`..fwd_kernel.dropout_keep_mask` of ``dropout_seed``
    (lse undropped).  ``segment_ids`` (``.q`` [B, Nq] / ``.kv`` [B, Nkv],
    as :class:`..flash_attention.SegmentIds`, or one [B, N] tensor for both)
    masks scores between unequal ids, after the causal mask.  As in the JAX
    oracle, P is cast to v's dtype before the P.V product, and a row that
    sees no key comes out NaN; fp8 V is first upcast (exactly) to q's dtype,
    where the JAX oracle would round P to fp8.  A slope count other than 1
    or Hq, a dropout rate outside [0, 1) or without a seed, and segment ids
    of another shape raise ``ValueError``.
    """
    hq, n_q = q.shape[1], q.shape[2]
    if alibi_slopes is not None and len(alibi_slopes) not in (1, hq):
        raise ValueError(f"alibi_slopes must have one slope per q head ({hq}), "
                         f"got {len(alibi_slopes)}")
    if dropout_rate and not (0.0 < dropout_rate < 1.0 and dropout_seed is not None):
        raise ValueError("dropout_rate must be in [0, 1) and needs a dropout_seed")
    hkv, n_kv = k.shape[1], k.shape[2]
    if segment_ids is not None:
        qs = torch.as_tensor(getattr(segment_ids, "q", segment_ids), device=q.device)
        ks = torch.as_tensor(getattr(segment_ids, "kv", segment_ids), device=q.device)
        if tuple(qs.shape) != (q.shape[0], n_q) or tuple(ks.shape) != (k.shape[0], n_kv):
            raise ValueError(f"segment_ids shapes {tuple(qs.shape)}/{tuple(ks.shape)} "
                             f"must be [B, Nq] / [B, Nkv]")
    if v.dtype in FP8_DTYPES:
        v = v.to(q.dtype)
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if alibi_slopes is not None:
        slopes = torch.tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        qpos = torch.arange(n_q, dtype=torch.float32, device=q.device) + float(n_kv - n_q)
        dist = qpos[:, None] - torch.arange(n_kv, dtype=torch.float32, device=q.device)
        s = s - slopes[None, :, None, None] * dist
    if causal:
        row = torch.arange(n_q, device=q.device)[:, None] + (n_kv - n_q)
        col = torch.arange(n_kv, device=q.device)[None, :]
        mask = col <= row
        if window:
            mask = mask & ((row - col) < window)
        s = s.masked_fill(~mask, float("-inf"))
    if segment_ids is not None:
        s = s.masked_fill(qs[:, None, :, None] != ks[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    p = e / l
    if dropout_rate:
        p = p * dropout_rows(q, 0, n_q, n_kv, float(dropout_rate), dropout_seed)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if with_lse:
        return o, lse
    return o


def reference_attention_grads(
    q, k, v, do, *, causal=False, sm_scale=1.0, segment_ids=None, window=0,
    logit_softcap=0.0, alibi_slopes=None, dropout_rate=0.0,
    dropout_seed=None,
):
    """Oracle gradients (dQ, dK, dV): torch autograd through
    :func:`reference_attention` with output gradient ``do``."""
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = reference_attention(
            q_, k_, v_, causal=causal, sm_scale=sm_scale,
            segment_ids=segment_ids, window=window,
            logit_softcap=logit_softcap, alibi_slopes=alibi_slopes,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
        return torch.autograd.grad(o, (q_, k_, v_), do)
