"""``jax.nn.dot_product_attention``-compatible adapter over the flash kernels,
PyTorch port of ``flash_attention_dlrs_tpu/nn.py``.

Code written against ``jax.nn.dot_product_attention`` (query/key/value in
BTNH layout, ``is_causal``, ``local_window_size``, per-batch
``*_seq_lengths``, GQA by head count) runs on the port's kernels through
:func:`dot_product_attention`, with torch tensors in place of arrays.

Dispatch contract: the adapter routes to the flash kernels ONLY where the
semantics match ``jax.nn.dot_product_attention`` exactly, and otherwise
computes ``jax.nn``'s semantics itself in plain PyTorch (:func:`_plain`, the
role XLA's implementation plays for the JAX adapter; no library attention
kernel), so every argument combination keeps working.  The choice depends
on the arguments alone:

- general ``bias`` / ``mask`` tensors: fallback (the kernels mask
  structurally, causal/window/segment, and take no dense score-space
  tensors).
- ``is_causal`` with T != S: fallback.  ``jax.nn``'s causal mask is top-left
  aligned (``tril(ones(T, S))``); the kernels' cross-length causal is
  bottom-right aligned, so the two disagree whenever T != S.
- ``local_window_size`` without ``is_causal``: fallback (the kernels'
  sliding window is a causal band).  With ``is_causal``, the ``(left,
  right)`` window composes with the causal mask into "attend the last
  ``left + 1`` tokens", exactly the kernels' ``window = left + 1``; a
  negative ``left`` (rows masked empty) falls back.
- float64: fallback (the kernels refuse it; ``jax.nn`` semantics include it).
- ``return_residual=True``: fallback (the kernels' lse feeds the backward
  contract and is not a differentiable user-facing value).

Per-batch ``query_seq_lengths`` / ``key_value_seq_lengths`` lower onto the
kernels' segment ids: valid positions get id 1, padding id 0, so valid <->
valid survives and valid <-> pad is masked, identical to ``jax.nn``'s
padding mask for every valid row.  Rows beyond ``query_seq_lengths`` are
zeroed here (``jax.nn`` zeroes them too).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .ops.flash_attention import SegmentIds, flash_attention

__all__ = ["dot_product_attention"]


def _window_left(local_window_size):
    if local_window_size is None:
        return None
    if isinstance(local_window_size, int):
        return local_window_size
    return int(local_window_size[0])


def _needs_fallback(bias, mask, is_causal, t, s, local_window_size,
                    return_residual, implementation, dtype) -> bool:
    if implementation == "xla":
        return True
    if bias is not None or mask is not None:
        return True
    if return_residual:
        return True
    if dtype == torch.float64:
        return True
    if is_causal and t != s:
        return True  # top-left (jax.nn) vs bottom-right (kernels) alignment
    if local_window_size is not None and not is_causal:
        return True
    left = _window_left(local_window_size)
    if left is not None and left < 0:
        # jax.nn defines negative left windows (they mask rows empty); the
        # kernels' window=0 means "disabled": semantics diverge, defer.
        return True
    return False


def _lengths(lengths, b, device):
    """Per-batch sequence lengths as an int32 [B] tensor on ``device``."""
    if lengths is None:
        return None
    lengths = torch.as_tensor(lengths, device=device)
    if tuple(lengths.shape) != (b,) or lengths.dtype.is_floating_point:
        raise ValueError(f"sequence lengths must be integers of shape [B]={(b,)}, "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    return lengths.to(torch.int32)


def _as_4d(x):
    return None if x is None else x.reshape((1,) * (4 - x.ndim) + tuple(x.shape))


def _plain(query, key, value, bias, mask, *, scale, is_causal, q_len, kv_len,
           local_window_size, return_residual):
    """``jax.nn.dot_product_attention``'s own semantics (its XLA path) in
    plain PyTorch, BTNH in and out: logits in fp32 (fp64 stays fp64), scale,
    bias, then every mask at once to −0.7 × the logits' finite max (so a
    fully masked row is a uniform average, as in ``jax.nn``), softmax in
    fp32, P cast to V's dtype, rows past ``q_len`` zeroed; with
    ``return_residual`` also the logsumexp [B, T, N] in V's dtype, detached."""
    b, t, n, _ = query.shape
    s, kh = key.shape[1], key.shape[2]
    acc = torch.float64 if query.dtype == torch.float64 else torch.float32
    k = key.repeat_interleave(n // kh, dim=2) if n != kh else key
    v = value.repeat_interleave(n // kh, dim=2) if n != kh else value
    logits = torch.einsum("btnh,bsnh->bnts", query.to(acc), k.to(acc)) * scale
    if bias is not None:
        logits = logits + _as_4d(bias).to(acc)
    dev = query.device
    keep = torch.ones((1, 1, t, s), dtype=torch.bool, device=dev)
    if mask is not None:
        keep = keep & _as_4d(mask)
    row = torch.arange(t, device=dev)[:, None]
    col = torch.arange(s, device=dev)[None, :]
    if is_causal:
        keep = keep & (col <= row)
    if local_window_size is not None:
        left, right = ((local_window_size, local_window_size)
                       if isinstance(local_window_size, int) else local_window_size)
        keep = keep & (row <= col + left) & (row >= col - right)
    if q_len is not None:
        keep = keep & (torch.arange(t, device=dev)[None, None, :, None]
                       < q_len[:, None, None, None])
    if kv_len is not None:
        keep = keep & (torch.arange(s, device=dev)[None, None, None, :]
                       < kv_len[:, None, None, None])
    logits = torch.where(keep, logits, -0.7 * torch.finfo(acc).max).float()
    probs = torch.softmax(logits, dim=-1).to(key.dtype)
    out = torch.einsum("bnts,bsnh->btnh", probs, v)
    if q_len is not None:
        out = out * (torch.arange(t, device=dev)[None, :]
                     < q_len[:, None]).to(out.dtype)[:, :, None, None]
    if not return_residual:
        return out
    lse = torch.logsumexp(logits, dim=-1).to(key.dtype).transpose(1, 2)
    return out, lse.detach()


def dot_product_attention(
    query,
    key,
    value,
    bias=None,
    mask=None,
    *,
    scale: Optional[float] = None,
    is_causal: bool = False,
    query_seq_lengths=None,
    key_value_seq_lengths=None,
    local_window_size: Union[int, tuple, None] = None,
    implementation: Optional[str] = None,
    return_residual: bool = False,
):
    """Drop-in ``jax.nn.dot_product_attention`` on the flash kernels.

    Layouts, defaults and masking semantics follow ``jax.nn``: ``query`` is
    BTNH (or TNH unbatched), ``key`` / ``value`` are BSKH with N % K == 0 for
    GQA/MQA, ``scale`` defaults to 1/sqrt(H), ``mask`` is boolean (True
    keeps).  See the module docstring for the dispatch contract;
    ``implementation`` accepts "flash" (require the kernel path: raises if
    the arguments force the fallback), "xla" (force the plain ``jax.nn``
    semantics) or None (auto).  Differentiable on both paths."""
    if implementation not in (None, "flash", "xla"):
        raise ValueError(
            f"implementation must be None, 'flash', or 'xla'; got "
            f"{implementation!r} (cudnn's fused attention is a library kernel, "
            "which this port does not call)")

    unbatched = query.ndim == 3
    if unbatched:
        query, key, value = (x[None] for x in (query, key, value))

    b, t, n_heads, h = query.shape
    s, n_kv = key.shape[1], key.shape[2]
    if value.shape != key.shape or value.dtype != key.dtype or query.dtype != key.dtype:
        raise ValueError(f"query {tuple(query.shape)} {query.dtype}, key "
                         f"{tuple(key.shape)} {key.dtype} and value "
                         f"{tuple(value.shape)} {value.dtype} do not match")
    if key.shape[0] != b or key.shape[3] != h or n_heads % n_kv:
        raise ValueError(f"query {tuple(query.shape)} does not fit key "
                         f"{tuple(key.shape)} (batch, head_dim, N % K)")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError(f"mask must be boolean, got {mask.dtype}")
    q_len = _lengths(query_seq_lengths, b, query.device)
    kv_len = _lengths(key_value_seq_lengths, b, query.device)
    if scale is None:
        scale = 1.0 / h ** 0.5

    if _needs_fallback(bias, mask, is_causal, t, s, local_window_size,
                       return_residual, implementation, query.dtype):
        if implementation == "flash":
            raise ValueError(
                "implementation='flash' but the arguments require the plain "
                "fallback (general bias/mask, return_residual, fp64, "
                "cross-length causal, or non-causal or negative window): see "
                "the flash_attention_dlrs_tpu_torch.nn docstring")
        out = _plain(query, key, value, bias, mask, scale=scale, is_causal=is_causal,
                     q_len=q_len, kv_len=kv_len, local_window_size=local_window_size,
                     return_residual=return_residual)
        if unbatched:
            out = tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]
        return out

    window = 0
    if local_window_size is not None:
        # jax.nn: attend [i - left, i + right]; causal removes the right side.
        # kernels: `window` = tokens visible, including self.
        window = _window_left(local_window_size) + 1

    segment_ids, valid = None, None
    if q_len is not None or kv_len is not None:
        i32 = dict(dtype=torch.int32, device=query.device)
        q_len = torch.full((b,), t, **i32) if q_len is None else q_len
        kv_len = torch.full((b,), s, **i32) if kv_len is None else kv_len
        valid = torch.arange(t, **i32)[None, :] < q_len[:, None]
        seg_kv = torch.arange(s, **i32)[None, :] < kv_len[:, None]
        segment_ids = SegmentIds(q=valid.to(torch.int32), kv=seg_kv.to(torch.int32))

    # BTNH -> BHTD (the kernels' layout, contiguous), run, transpose back.
    o = flash_attention(
        *(x.transpose(1, 2).contiguous() for x in (query, key, value)),
        causal=is_causal, sm_scale=scale, segment_ids=segment_ids, window=window,
    ).transpose(1, 2)

    if query_seq_lengths is not None:
        # the same mask that drove the kernel; a new tensor, so autograd's
        # saved O is untouched and the pad rows' dO is 0
        o = torch.where(valid[:, :, None, None], o, torch.zeros((), dtype=o.dtype,
                                                                device=o.device))
    return o[0] if unbatched else o
