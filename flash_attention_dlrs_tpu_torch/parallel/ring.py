"""Ring attention over a context axis, PyTorch port of
``flash_attention_dlrs_tpu/parallel/ring.py``.

Each rank holds one shard of the sequence.  At every step it attends its
local Q to the K/V block it holds, through the port's forward kernel, and
passes the block to the next rank of the axis (:func:`.launch.send_recv`,
posted before the block's kernel so that NCCL can overlap the two).  The
partial (O, lse) pairs merge by their logsumexps (:func:`merge_partials`),
the same rescale the kernel does inside.  Under ``causal`` a block from
source rank s is, relative to this rank's queries, all past (full
attention), the diagonal (causal mask) or all future: a Python ``if`` on
the step's integers, and a skipped block launches nothing.

The backward (a ``torch.autograd.Function``) runs a second lap: each block's
gradients come from the port's backward kernels with the GLOBAL O and merged
lse (``rederive_stats=False``), so P = exp(S − lse) is the true softmax and
the per-block contributions simply sum; the fp32 dK/dV accumulators travel
with their block for n rotations, back to the rank that owns it.

:func:`zigzag_ring_attention` is the load-balanced causal layout (rank i
holds global chunks i and 2n−1−i: every rank launches n + 2 forward kernels
against the contiguous ring's r + 1), :func:`context_parallel_attention` the
ring-free combine for a replicated (decode-shaped) q.

Dropout masks fold the (q shard, kv shard) pair into the seed as the JAX
package does, wrapped to int32, so that the in-kernel masks are JAX's bit
for bit.  Every function runs inside a process group, on each rank's LOCAL
shards, where JAX's run inside ``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention_backward, flash_attention_forward
from ..ops.fwd_kernel import DEFAULT_MASK_VALUE, int32_seed
from .launch import all_reduce, send_recv
from .mesh import Mesh, zigzag_indices, zigzag_inverse

__all__ = [
    "context_parallel_attention",
    "merge_partials",
    "ring_attention",
    "shard_seed",
    "zigzag_indices",
    "zigzag_inverse",
    "zigzag_ring_attention",
]


def merge_partials(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions via their logsumexps.

    o_i: [..., N, d]; lse_i: [..., N].  Returns (o, lse) of the union,
    o in o1's dtype: the cross-rank form of the in-kernel rescale."""
    lse_c = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse_c)[..., None]
    w2 = torch.exp(lse2 - lse_c)[..., None]
    return (o1.float() * w1 + o2.float() * w2).to(o1.dtype), lse_c


_SHARD_SEED_PRIME = 15485863  # ≠ the transformer's per-layer 1299709


def shard_seed(seed: int, q_owner: int, kv_src: int, n: int) -> int:
    """Per-(q shard, kv shard) dropout sub-seed, int32: the in-kernel mask is
    a function of (seed, b, h, LOCAL row, LOCAL col), so folding both shard
    coordinates keeps ranks from dropping the same columns; the backward lap
    visits the same pairs and replays the masks."""
    return int32_seed(int(seed) + _SHARD_SEED_PRIME * (q_owner * n + kv_src))


def _empty(shape, dtype, device):
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.full(shape[:-1], DEFAULT_MASK_VALUE, dtype=torch.float32, device=device))


def _ring_forward(q, k, v, seed, mesh, axis, causal, sm_scale, rate):
    n, idx = mesh.size(axis), mesh.index(axis)
    o, lse = _empty(q.shape, q.dtype, q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        if step != n - 1:  # post the rotation first: it overlaps the kernel
            nxt = send_recv(k_blk, mesh, axis), send_recv(v_blk, mesh, axis)
        src = (idx - step) % n  # the rank this K/V block came from
        if not (causal and src > idx):
            o_b, lse_b = flash_attention_forward(
                q, k_blk, v_blk, causal=causal and src == idx, sm_scale=sm_scale,
                dropout_rate=rate, dropout_seed=shard_seed(seed, idx, src, n) if rate else None)
            o, lse = merge_partials(o, lse, o_b, lse_b)
        if step != n - 1:
            k_blk, v_blk = nxt[0].wait(), nxt[1].wait()
    return o, lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale, rate, seed):
        o, lse = _ring_forward(q, k, v, seed, mesh, axis, causal, sm_scale, rate)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (mesh, axis, causal, sm_scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale, rate, seed = ctx.cfg
        n, idx = mesh.size(axis), mesh.index(axis)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_blk, v_blk = k, v
        for step in range(n):
            nxt = send_recv(k_blk, mesh, axis), send_recv(v_blk, mesh, axis)
            src = (idx - step) % n
            if not (causal and src > idx):
                dq_p, dk_p, dv_p = flash_attention_backward(
                    q, k_blk, v_blk, o, do, lse, causal=causal and src == idx,
                    sm_scale=sm_scale, dropout_rate=rate,
                    dropout_seed=shard_seed(seed, idx, src, n) if rate else None,
                    rederive_stats=False)
                dq = dq + dq_p.float()
                dk_blk = dk_blk + dk_p.float()
                dv_blk = dv_blk + dv_p.float()
            # every step rotates (n in all): the accumulators come home
            grads = send_recv(dk_blk, mesh, axis), send_recv(dv_blk, mesh, axis)
            k_blk, v_blk = nxt[0].wait(), nxt[1].wait()
            dk_blk, dv_blk = grads[0].wait(), grads[1].wait()
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None, None, None, None)


def _check_dropout(rate, dropout_seed):
    rate = float(rate)
    if rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return rate, int32_seed(dropout_seed if dropout_seed is not None else 0)


def ring_attention(q, k, v, *, mesh: Mesh, axis_name: str, causal: bool = False,
                   sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                   dropout_seed=None):
    """Differentiable context-parallel attention over ``axis_name`` of
    ``mesh`` (every rank of the axis calls it).

    q: [B, H, Nq_shard, d], k/v: [B, Hkv, Nkv_shard, d], this rank's shards;
    the global sequence is their concatenation in axis order.  For causal,
    Nq_shard must equal Nkv_shard.  Returns the local O shard.  Dropout
    uses a per-(q shard, kv shard) sub-seed (:func:`shard_seed`), which the
    backward lap replays."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"causal ring attention requires equal q/kv shard lengths "
            f"(token-aligned context sharding); got Nq_shard={q.shape[2]} "
            f"vs Nkv_shard={k.shape[2]} — the full/diagonal/skip block "
            "classification assumes aligned shards"
        )
    rate, seed = _check_dropout(dropout_rate, dropout_seed)
    return _RingAttention.apply(q, k, v, mesh, axis_name, bool(causal), float(sm_scale),
                                rate, seed)


# ---------------------------------------------------------------------------
# Zigzag (load-balanced causal) ring
# ---------------------------------------------------------------------------
#
# Rank i holds global chunks (i, 2n−1−i).  For the K/V block of source s:
#   s < i:  only kv chunk s is visible: one kernel, both local q chunks
#   s > i:  only the late q chunk sees anything: one kernel over the block
#   s == i: both diagonal chunks and late q × early kv: three kernels
# so every rank launches n + 2 forward kernels in all.


def _zz_seed(seed: int, ga: int, gb: int, two_n: int) -> int:
    """Per-(global q chunk, global kv chunk) dropout sub-seed (the zigzag
    analogue of :func:`shard_seed`)."""
    return int32_seed(int(seed) + _SHARD_SEED_PRIME * (ga * two_n + gb))


def _halves(x):
    """(early, late) chunks of a zigzag shard, each contiguous: the kernels
    take contiguous inputs only."""
    h = x.shape[2] // 2
    return x[:, :, :h].contiguous(), x[:, :, h:].contiguous()


def _zz_forward(q, k, v, seed, mesh, axis, sm_scale, rate):
    n, idx = mesh.size(axis), mesh.index(axis)
    two_n = 2 * n
    ga_lo, ga_hi = idx, two_n - 1 - idx
    q_lo, q_hi = _halves(q)

    def fwd(q_, k_, v_, sd, causal):
        return flash_attention_forward(q_, k_, v_, causal=causal, sm_scale=sm_scale,
                                       dropout_rate=rate, dropout_seed=sd if rate else None)

    o, lse = _empty(q.shape, q.dtype, q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        if step != n - 1:
            nxt = send_recv(k_blk, mesh, axis), send_recv(v_blk, mesh, axis)
        src = (idx - step) % n
        k_lo, k_hi = _halves(k_blk)
        v_lo, v_hi = _halves(v_blk)
        if src < idx:  # past: kv chunk src seen by both q chunks
            o_b, lse_b = fwd(q, k_lo, v_lo, _zz_seed(seed, ga_lo, src, two_n), False)
        elif src > idx:  # future: the late q chunk sees the whole block
            o_hi, lse_hi = fwd(q_hi, k_blk, v_blk, _zz_seed(seed, ga_hi, src, two_n), False)
            o_z, lse_z = _empty(q_lo.shape, q.dtype, q.device)
            o_b, lse_b = torch.cat([o_z, o_hi], 2), torch.cat([lse_z, lse_hi], 2)
        else:  # diagonal
            o_lo, lse_lo = fwd(q_lo, k_lo, v_lo, _zz_seed(seed, ga_lo, ga_lo, two_n), True)
            o_d, lse_d = fwd(q_hi, k_hi, v_hi, _zz_seed(seed, ga_hi, ga_hi, two_n), True)
            o_f, lse_f = fwd(q_hi, k_lo, v_lo, _zz_seed(seed, ga_hi, ga_lo, two_n), False)
            o_hi, lse_hi = merge_partials(o_d, lse_d, o_f, lse_f)
            o_b, lse_b = torch.cat([o_lo, o_hi], 2), torch.cat([lse_lo, lse_hi], 2)
        o, lse = merge_partials(o, lse, o_b, lse_b)
        if step != n - 1:
            k_blk, v_blk = nxt[0].wait(), nxt[1].wait()
    return o, lse


class _ZigzagAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, sm_scale, rate, seed):
        o, lse = _zz_forward(q, k, v, seed, mesh, axis, sm_scale, rate)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (mesh, axis, sm_scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, sm_scale, rate, seed = ctx.cfg
        n, idx = mesh.size(axis), mesh.index(axis)
        two_n = 2 * n
        ga_lo, ga_hi = idx, two_n - 1 - idx
        do = do.contiguous()
        q_lo, q_hi = _halves(q)
        o_lo, o_hi = _halves(o)
        do_lo, do_hi = _halves(do)
        h = q.shape[2] // 2
        lse_lo, lse_hi = lse[:, :, :h].contiguous(), lse[:, :, h:].contiguous()

        def bwd(q_, k_, v_, o_, do_, lse_, sd, causal):
            return flash_attention_backward(
                q_, k_, v_, o_, do_, lse_, causal=causal, sm_scale=sm_scale,
                dropout_rate=rate, dropout_seed=sd if rate else None, rederive_stats=False)

        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_blk, v_blk = k, v
        for step in range(n):
            nxt = send_recv(k_blk, mesh, axis), send_recv(v_blk, mesh, axis)
            src = (idx - step) % n
            k_lo, k_hi = _halves(k_blk)
            v_lo, v_hi = _halves(v_blk)
            if src < idx:
                dq_p, dk_lo, dv_lo = bwd(q, k_lo, v_lo, o, do, lse,
                                         _zz_seed(seed, ga_lo, src, two_n), False)
                dk_p = torch.cat([dk_lo, torch.zeros_like(k_hi)], 2)
                dv_p = torch.cat([dv_lo, torch.zeros_like(v_hi)], 2)
            elif src > idx:
                dq_hi, dk_p, dv_p = bwd(q_hi, k_blk, v_blk, o_hi, do_hi, lse_hi,
                                        _zz_seed(seed, ga_hi, src, two_n), False)
                dq_p = torch.cat([torch.zeros_like(q_lo), dq_hi], 2)
            else:
                dq_lo, dk1, dv1 = bwd(q_lo, k_lo, v_lo, o_lo, do_lo, lse_lo,
                                      _zz_seed(seed, ga_lo, ga_lo, two_n), True)
                dq_d, dk_hi, dv_hi = bwd(q_hi, k_hi, v_hi, o_hi, do_hi, lse_hi,
                                         _zz_seed(seed, ga_hi, ga_hi, two_n), True)
                dq_f, dk2, dv2 = bwd(q_hi, k_lo, v_lo, o_hi, do_hi, lse_hi,
                                     _zz_seed(seed, ga_hi, ga_lo, two_n), False)
                dq_p = torch.cat([dq_lo, dq_d + dq_f], 2)
                # the two early-kv contributions summed in fp32
                dk_p = torch.cat([(dk1.float() + dk2.float()).to(k.dtype), dk_hi], 2)
                dv_p = torch.cat([(dv1.float() + dv2.float()).to(v.dtype), dv_hi], 2)
            dq = dq + dq_p.float()
            dk_blk = dk_blk + dk_p.float()
            dv_blk = dv_blk + dv_p.float()
            grads = send_recv(dk_blk, mesh, axis), send_recv(dv_blk, mesh, axis)
            k_blk, v_blk = nxt[0].wait(), nxt[1].wait()
            dk_blk, dv_blk = grads[0].wait(), grads[1].wait()
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None, None, None)


def zigzag_ring_attention(q, k, v, *, mesh: Mesh, axis_name: str,
                          sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                          dropout_seed=None):
    """Load-balanced CAUSAL context-parallel attention.  The local shards
    must be in the zigzag layout: rank i holds global chunks (i, 2n−1−i)
    concatenated, each half the local length (:func:`zigzag_indices`).
    Always causal (a non-causal ring has no balance problem: use
    :func:`ring_attention`)."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if q.shape[2] != k.shape[2]:
        raise ValueError(
            "zigzag ring attention requires equal q/kv shard lengths; got "
            f"Nq_shard={q.shape[2]} vs Nkv_shard={k.shape[2]}"
        )
    if q.shape[2] % 2:
        raise ValueError("zigzag shards hold two chunks: local length "
                         f"must be even, got {q.shape[2]}")
    rate, seed = _check_dropout(dropout_rate, dropout_seed)
    return _ZigzagAttention.apply(q, k, v, mesh, axis_name, float(sm_scale), rate, seed)


def context_parallel_attention(q, k, v, *, mesh: Mesh, axis_name: str, causal: bool = False,
                               sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                               dropout_seed=None):
    """Context parallelism WITHOUT the ring: each rank attends its local KV
    shard and the partials combine with one max and two sum all-reduces.
    Q is replicated over the axis (decode / short-q shape), so the causal
    mask is vacuous and ``causal=True`` is refused.  Forward only."""
    if causal:
        raise NotImplementedError(
            "combine-based CP is decode-shaped: q tokens are globally later "
            "than all resident KV, so causal masking is vacuous — pass "
            "causal=False; for sharded-q causal training use ring_attention"
        )
    rate, seed = _check_dropout(dropout_rate, dropout_seed)
    seed_l = None
    if rate:
        # Q is replicated (rows global), KV columns shard-local: fold only
        # the kv-owner coordinate so that shards drop independent columns
        seed_l = shard_seed(seed, 0, mesh.index(axis_name), mesh.size(axis_name))
    o_l, lse_l = flash_attention_forward(q, k, v, causal=False, sm_scale=sm_scale,
                                         dropout_rate=rate, dropout_seed=seed_l)
    lse_max = all_reduce(lse_l, mesh, axis_name, "max")
    w = torch.exp(lse_l - lse_max)
    num = all_reduce(o_l.float() * w[..., None], mesh, axis_name)
    den = all_reduce(w, mesh, axis_name)
    return (num / den[..., None]).to(q.dtype)
