"""Public attention API, PyTorch port of ``flash_attention_dlrs_tpu/ops/flash_attention.py``.

- :func:`flash_attention_forward` returns ``(O, L)`` with L the natural-base
  logsumexp, ``[B, Hq, Nq]`` fp32;
- :func:`flash_attention_backward` returns ``(dQ, dK, dV)`` from the
  forward's O and L (under ALiBi by default from the forward kernel's own
  replayed L: ``rederive_stats``);
- :func:`flash_attention` is the differentiable op, a custom operator
  (``torch.library``) with a registered backward in place of the JAX
  ``custom_vjp``: its forward saves (q, k, v, O, L) and the segment ids, and
  its backward runs the backward kernels.  As one dispatcher op it is what a
  selective checkpoint policy can keep (JAX's "flash_o" / "flash_lse").

The JAX package splits the forward over four TPU routes and the backward
over six, chosen by length; here one forward kernel (``csrc/attn_fwd.cuh``)
and one deterministic two-sweep backward family (``csrc/attn_bwd.cuh``) take
every length, so there is no dispatch.  ALiBi is the true bias
−m_h·(q_pos − col) in every kernel, so the public L is the kernels' own (the
TPU kernels' separable form needed a shift).  Dropout is the counter-based
mask of :func:`..fwd_kernel.dropout_keep_mask`.  :class:`SegmentIds` packs
sequences: a row sees only keys of its own id.  V may be fp8 (e4m3fn /
e5m2) beside fp32/bf16/fp16 q and k, for the forward only: the backward
through fp8 V raises ``NotImplementedError``, as in the JAX package.

``block_sizes`` (a :class:`..tuning.BlockSizes`) pins the kernels' tiles:
the forward's key tile and the rows the backward sweeps stream a stage,
each among those some build carries for the call (:mod:`..tuning`: a call
with ALiBi, dropout, segment ids or fp8 V has its build's own tile only,
and another raises ``ValueError`` naming the built tiles; the JAX package
takes any multiple of 128).  ``tune=True`` times the candidates on the
call's own inputs the first time a shape is seen
(:func:`tuned_block_sizes`, cached in process and on disk).  The plain
versions check the tiles alike and ignore them.

The kernels are built for head dims 64, 128 and 256; every entry point
zero-pads q, k and v to the next of them (:func:`..fwd_kernel.kernel_width`,
on every device, as the JAX package pads to 128 lanes), takes ``sm_scale``
from the true head_dim and slices O (and dQ, dK, dV) back.  The padding is
exact: zero columns add nothing to a score, and zero V columns are sliced
off.  A head_dim above 256 is padded to a multiple of 128, as the JAX
package pads it, and runs on the card on the wide builds (``csrc/wide.cuh``,
every mode, every width; above 1024 on the column-chunked kernels).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tuning
from .bwd_kernel import attn_bwd
from .fwd_kernel import FP8_DTYPES, attn_fwd, int32_seed, kernel_width, pad_head_dim

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_FP8_BACKWARD = ("backward through fp8 V is not supported — use bf16 V for "
                 "training, fp8 V for inference-only calls")


class SegmentIds(NamedTuple):
    """Packed-sequence segment ids: positions attend only within equal ids.

    q: [B, Nq] integer; kv: [B, Nkv] integer (tensors, or anything
    ``torch.as_tensor`` takes).  A single [B, N] tensor in their place
    serves both sides."""

    q: torch.Tensor
    kv: torch.Tensor


def _normalize_segments(segment_ids, q, k):
    """(q ids, kv ids) as contiguous int32 tensors on q's device, cast once
    per call, or (None, None); the JAX package's shape refusal.  No sentinel
    padding is needed: the kernels mask tails by bounds."""
    if segment_ids is None:
        return None, None
    if not isinstance(segment_ids, SegmentIds):
        segment_ids = SegmentIds(q=segment_ids, kv=segment_ids)
    qs, ks = torch.as_tensor(segment_ids.q), torch.as_tensor(segment_ids.kv)
    if (tuple(qs.shape) != (q.shape[0], q.shape[2])
            or tuple(ks.shape) != (k.shape[0], k.shape[2])):
        raise ValueError(
            f"segment_ids shapes {tuple(qs.shape)}/{tuple(ks.shape)} must be "
            f"[B, Nq]={q.shape[0], q.shape[2]} / [B, Nkv]={k.shape[0], k.shape[2]}")
    return tuple(t.to(device=q.device, dtype=torch.int32).contiguous() for t in (qs, ks))


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
    if v.dtype != q.dtype and v.dtype not in FP8_DTYPES:
        # fp8 V with higher-precision q/k is the one legal mixed case: the
        # forward kernel dequantizes V exactly as it stages it.  Contract:
        # fp8 V payloads are finite, as in the JAX package.
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


def _normalize_alibi(alibi_slopes, num_q_heads: int, causal: bool):
    """Per-head ALiBi slopes as a tuple of floats, one per q head (a single
    slope broadcasts), or None.  Causal only, as in the JAX package: ALiBi
    is defined on the causal distance q_pos − kv_pos."""
    if alibi_slopes is None:
        return None
    if not causal:
        raise ValueError("alibi_slopes requires causal=True (ALiBi is "
                         "defined on the causal distance q_pos - kv_pos)")
    slopes = tuple(float(x) for x in np.asarray(alibi_slopes).reshape(-1))
    if len(slopes) == 1 and num_q_heads > 1:
        slopes = slopes * num_q_heads
    if len(slopes) != num_q_heads:
        raise ValueError(
            f"alibi_slopes must have one slope per q head ({num_q_heads}), "
            f"got {len(slopes)}")
    return slopes


def _normalize_dropout(dropout_rate, dropout_seed):
    """(rate, seed): rate in [0, 1), the seed an int32 (wrapping past 2^31)
    required when rate > 0; (0.0, 0) without dropout."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0.0, 0
    if dropout_seed is None:
        raise ValueError(
            "dropout_rate > 0 requires dropout_seed (an int32; pass a fresh "
            "value per training step, e.g. the step counter)")
    return rate, int32_seed(dropout_seed)


def _prepare(q, k, v, causal, sm_scale, segment_ids, window, logit_softcap,
             alibi_slopes, dropout_rate, dropout_seed, block_sizes=None):
    """Validate a call; returns the kernels' keyword arguments normalized
    (``block_sizes`` checked against the tiles built for the call)."""
    _validate(q, k, v)
    q_seg, kv_seg = _normalize_segments(segment_ids, q, k)
    if logit_softcap < 0:
        raise ValueError(f"logit_softcap must be >= 0, got {logit_softcap}")
    slopes = _normalize_alibi(alibi_slopes, q.shape[1], causal)
    rate, seed = _normalize_dropout(dropout_rate, dropout_seed)
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5  # the true head_dim, not the padded one
    if block_sizes is not None:
        if not isinstance(block_sizes, tuning.BlockSizes):
            raise TypeError(f"block_sizes must be a BlockSizes, not "
                            f"{type(block_sizes).__name__}")
        block_sizes.check(kernel_width(q.shape[-1]), alibi=slopes is not None,
                          dropout=rate > 0, segments=q_seg is not None,
                          fp8_v=v.dtype in FP8_DTYPES)
    return dict(causal=bool(causal), sm_scale=float(sm_scale),
                window=_normalize_window(window, causal, k.shape[2]),
                softcap=float(logit_softcap), alibi_slopes=slopes,
                dropout_rate=rate, dropout_seed=seed, q_seg=q_seg, kv_seg=kv_seg,
                block_sizes=block_sizes)


def _has_modes(kw, v) -> bool:
    """Whether a prepared call has a mode the other tiles are not built
    with (ALiBi, dropout, segment ids, fp8 V)."""
    return (kw["alibi_slopes"] is not None or kw["dropout_rate"] > 0
            or kw["q_seg"] is not None or v.dtype in FP8_DTYPES)


def _resolve_blocks(q, k, v, kw, block_sizes, tune: bool, causal):
    """The call's tiles: ``block_sizes`` as given, or with ``tune`` (and
    none given) the timed search's, or None (each head dim's own).  A call
    with a mode has one candidate, its build's own tile, and is not timed;
    ``tune`` during a CUDA graph's capture raises ``ValueError``, as the
    JAX package raises under ``jit``."""
    if not tune or block_sizes is not None:
        return block_sizes
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        raise ValueError(
            "tune=True requires running outside a CUDA graph's capture (call "
            "once outside, or pass the tuned block_sizes in explicitly)")
    if _has_modes(kw, v):
        return tuning.default_block_sizes(kernel_width(q.shape[-1]))
    return tuned_block_sizes(q, k, v, causal=causal, sm_scale=kw["sm_scale"])


def _padded(*tensors):
    """The tensors with their head dim zero-padded to the kernels' width."""
    width = kernel_width(tensors[0].shape[-1])
    return [pad_head_dim(t, width) for t in tensors]


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
    block_sizes: Optional[tuning.BlockSizes] = None,
    tune: bool = False,
):
    """Forward pass returning (O, L).  q: [B, Hq, Nq, d]; k, v:
    [B, Hkv, Nkv, d] with Hq % Hkv == 0.  ``sm_scale`` defaults to d**-0.5.
    Causal masking is bottom-right aligned (q row i sits at kv position
    i + Nkv − Nq).  ``alibi_slopes`` (causal only; one per q head, or one
    for all) adds −m_h·(q_pos − col); ``dropout_rate`` with an int
    ``dropout_seed`` drops attention probabilities (flash-attn semantics);
    ``segment_ids`` (a :class:`SegmentIds` or one [B, N] integer tensor)
    keeps each row to the keys of its own id.  V may be fp8.  L is the
    natural-base logsumexp of the scaled, softcapped and biased scores
    (dropout-independent), [B, Hq, Nq] fp32; a row that sees no key gets
    O = 0 and L = DEFAULT_MASK_VALUE.  ``block_sizes`` / ``tune``: see the
    module docstring.  Runs where the inputs lie: the kernel on a CUDA
    device, the plain PyTorch version on the CPU."""
    kw = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                  logit_softcap, alibi_slopes, dropout_rate, dropout_seed, block_sizes)
    kw["block_sizes"] = _resolve_blocks(q, k, v, kw, block_sizes, tune, causal)
    d = q.shape[-1]
    q, k, v = _padded(q, k, v)
    o, lse = attn_fwd(q, k, v, **kw)
    return o[..., :d], lse


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
    block_sizes: Optional[tuning.BlockSizes] = None,
    tune: bool = False,
):
    """Backward pass returning (dQ, dK, dV) in the dtypes of q, k and v.
    ``o`` and ``lse`` [B, Hq, Nq] come from the forward with the same
    arguments (dropout's rate and seed included: the kernels regenerate its
    mask); ``do`` is the gradient of O.  P is rebuilt as exp(S − lse).
    ``rederive_stats=True`` replays the forward kernel for its own lse and
    ignores the passed one (a shape witness only); False honours the PASSED
    lse, as a ring caller with a globally merged lse needs; None, the
    default, rederives under ALiBi and honours the lse otherwise, as the JAX
    package does.  fp8 V raises ``NotImplementedError`` (no backward, as in
    the JAX package).  ``block_sizes`` / ``tune``: see the module docstring.
    Runs where the inputs lie: the kernels on a CUDA device, the plain
    PyTorch version on the CPU."""
    kw = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                  logit_softcap, alibi_slopes, dropout_rate, dropout_seed, block_sizes)
    if v.dtype in FP8_DTYPES:
        raise NotImplementedError(_FP8_BACKWARD)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must match q "
            f"{tuple(q.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse {tuple(lse.shape)} must be [B, Hq, Nq] = "
                         f"{tuple(q.shape[:3])}")
    if rederive_stats is None:
        rederive_stats = kw["alibi_slopes"] is not None
    kw["block_sizes"] = _resolve_blocks(q, k, v, kw, block_sizes, tune, causal)
    d = q.shape[-1]
    q, k, v, o, do = _padded(q, k, v, o, do)
    if rederive_stats:
        lse = attn_fwd(q, k, v, **kw)[1]
    grads = attn_bwd(q, k, v, o.contiguous(), lse.contiguous(), do.contiguous(), **kw)
    return tuple(g[..., :d] for g in grads)


# The differentiable forward is a custom operator (torch.library), so that a
# selective checkpoint policy sees it as one op and can keep its (O, L)
# instead of replaying it (models/transformer.py, remat_policy="save_flash"
# and the others, JAX's checkpoint names "flash_o" / "flash_lse"); its
# backward runs the backward kernels on the saved (q, k, v, O, L).
@torch.library.custom_op("flash_attention_dlrs_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
               causal: bool, sm_scale: float, window: int, softcap: float,
               alibi_slopes: Optional[List[float]], dropout_rate: float,
               dropout_seed: int, block_kv: int,
               block_kv_bwd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, L) of the forward kernel (:func:`..fwd_kernel.attn_fwd`);
    ``block_kv`` / ``block_kv_bwd`` 0: each head dim's own tiles."""
    return attn_fwd(q, k, v, **_op_kw(q_seg, kv_seg, causal, sm_scale, window, softcap,
                                      alibi_slopes, dropout_rate, dropout_seed, block_kv,
                                      block_kv_bwd))


def _op_kw(q_seg, kv_seg, causal, sm_scale, window, softcap, alibi_slopes,
           dropout_rate, dropout_seed, block_kv, block_kv_bwd):
    blocks = (tuning.BlockSizes(block_kv=block_kv, block_kv_bwd=block_kv_bwd)
              if block_kv else None)
    return dict(q_seg=q_seg, kv_seg=kv_seg, causal=causal, sm_scale=sm_scale,
                window=window, softcap=softcap,
                alibi_slopes=None if alibi_slopes is None else tuple(alibi_slopes),
                dropout_rate=dropout_rate, dropout_seed=dropout_seed, block_sizes=blocks)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, q_seg, kv_seg, *args = inputs
    ctx.save_for_backward(q, k, v, *output, q_seg, kv_seg)
    ctx.args = args


def _flash_fwd_backward(ctx, do, _dlse):
    """The backward kernels on the saved (q, k, v, O, L); the segment ids
    and the other arguments get no gradient, fp8 V has no backward."""
    q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
    if v.dtype in FP8_DTYPES:
        raise NotImplementedError(_FP8_BACKWARD)
    dq, dk, dv = attn_bwd(q, k, v, o, lse, do.contiguous(),
                          **_op_kw(q_seg, kv_seg, *ctx.args))
    return (dq, dk, dv) + (None,) * (2 + len(ctx.args))


_flash_fwd.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)
# the operator as a selective checkpoint policy meets it
FLASH_FWD = torch.ops.flash_attention_dlrs_tpu_torch.flash_fwd.default


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
    block_sizes: Optional[tuning.BlockSizes] = None,
    tune: bool = False,
):
    """Differentiable fused attention O = softmax(scale·QKᵀ + bias + mask)V
    (dropped out when asked), with the conventions of
    :func:`flash_attention_forward`; gradients flow to q, k and v through
    :func:`flash_attention_backward`'s kernels (none through fp8 V, whose
    backward raises ``NotImplementedError``).  ``block_sizes`` pins the
    forward's and the backward's tiles; ``tune=True`` (with none pinned)
    times both directions' candidates on these inputs first
    (:func:`tuned_block_sizes`), as ``triton.autotune`` did for the
    reference."""
    kw = _prepare(q, k, v, causal, sm_scale, segment_ids, window,
                  logit_softcap, alibi_slopes, dropout_rate, dropout_seed, block_sizes)
    blocks = _resolve_blocks(q, k, v, kw, block_sizes, tune, causal)
    slopes = kw["alibi_slopes"]
    d = q.shape[-1]
    q, k, v = _padded(q, k, v)  # the pad's backward slices the gradients
    o, _ = _flash_fwd(q, k, v, kw["q_seg"], kw["kv_seg"], kw["causal"], kw["sm_scale"],
                      kw["window"], kw["softcap"], None if slopes is None else list(slopes),
                      kw["dropout_rate"], kw["dropout_seed"],
                      0 if blocks is None else blocks.block_kv,
                      0 if blocks is None else blocks.block_kv_bwd)
    return o[..., :d]


def tuned_block_sizes(q, k, v, *, causal: bool = False,
                      sm_scale: Optional[float] = None) -> tuning.BlockSizes:
    """Timed tile search for this workload (the JAX package's
    ``tuned_block_sizes``): the forward's key tiles first, timed through
    :func:`flash_attention_forward`, then with the winner the backward's
    streamed tiles, timed through :func:`flash_attention_backward` (which
    returns all three gradients) on the winner's (O, L) and a seeded dO.
    Candidates are :func:`..tuning.candidate_fwd_configs` /
    ``candidate_bwd_configs`` of q's kernel width; each search is cached on
    its ("fwd" / "bwd", shapes, dtype, causal) key."""
    width = kernel_width(q.shape[-1])
    own = tuning.default_block_sizes(width)

    def blocks(bkv, bkv_bwd):
        return tuning.BlockSizes(block_kv=bkv, block_kv_bwd=bkv_bwd)

    def build_fwd(_, bkv):
        bs = blocks(bkv, own.block_kv_bwd)
        return lambda q_, k_, v_: flash_attention_forward(
            q_, k_, v_, causal=causal, sm_scale=sm_scale, block_sizes=bs)

    with torch.no_grad():
        _, bkv = tuning.tune_fwd_blocks(build_fwd, q, k, v, key_extra=causal,
                                        candidates=tuning.candidate_fwd_configs(width))
        o, lse = flash_attention_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                                         block_sizes=blocks(bkv, own.block_kv_bwd))
        gen = torch.Generator(device=q.device).manual_seed(0)
        do = torch.randn(q.shape, generator=gen, device=q.device,
                         dtype=torch.float32).to(q.dtype)

        def build_bwd(_, bkv_bwd):
            bs = blocks(bkv, bkv_bwd)
            return lambda q_, k_, v_, do_: flash_attention_backward(
                q_, k_, v_, o, do_, lse, causal=causal, sm_scale=sm_scale, block_sizes=bs)

        _, bkv_bwd = tuning.tune_bwd_blocks(build_bwd, q, k, v, do, key_extra=causal,
                                            candidates=tuning.candidate_bwd_configs(width))
    return blocks(bkv, bkv_bwd)
