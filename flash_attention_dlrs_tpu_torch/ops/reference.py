"""Naive attention oracle, PyTorch port of ``flash_attention_dlrs_tpu/ops/reference.py``.

A straightforward materialize-the-scores softmax attention in fp32: the
numerical oracle every test of the port holds its results against.  It
computes on whatever device its inputs lie on.
"""

from __future__ import annotations

import math

import torch

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 2 of the PyTorch port)"


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
    positions including the row's own.  As in the JAX oracle, P is cast to
    v's dtype before the P.V product, and a row that sees no key comes out
    NaN.  Segments, ALiBi and dropout raise ``NotImplementedError``.
    """
    if segment_ids is not None:
        raise NotImplementedError(_NOT_YET.format("segment_ids"))
    if alibi_slopes is not None:
        raise NotImplementedError(_NOT_YET.format("alibi_slopes"))
    if dropout_rate:
        raise NotImplementedError(_NOT_YET.format("attention dropout"))
    hq, n_q = q.shape[1], q.shape[2]
    hkv, n_kv = k.shape[1], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if causal:
        row = torch.arange(n_q, device=q.device)[:, None] + (n_kv - n_q)
        col = torch.arange(n_kv, device=q.device)[None, :]
        mask = col <= row
        if window:
            mask = mask & ((row - col) < window)
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    p = e / l
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
