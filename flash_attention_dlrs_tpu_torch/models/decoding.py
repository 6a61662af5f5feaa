"""Prefill, decode and verify steps, PyTorch port of ``flash_attention_dlrs_tpu/models/decoding.py``.

Prefill runs the causal attention kernel over the prompt and returns each
layer's K/V for the paged cache; the decode step embeds the batch's current
tokens and, per layer, projects QKV, applies RoPE at the absolute position
(an ALiBi model rotates nothing: every attention call takes its slopes),
writes the new K/V into the page pools in place (quantizing on write for
int8 / int4 / fp8 pools) and attends over the pages with
:func:`..ops.decode.paged_decode_attention`; the verify step does the same
for T tokens per sequence with :func:`..ops.decode.paged_verify_attention`
(chunked prefill, speculative verification).  PyTorch runs eagerly, so
there is no jit here; shapes stay static (slots × pages_per_seq) all the
same.  Every step carries the model variants of ``models/transformer.py``:
scaled RoPE, QKV biases, sandwich norms, embeddings scaled by √d_model, the
attention softcap and ``sm_scale`` in all three, each layer's window in the
prefill (the engine keeps paged contexts within the window), the final
softcap on the logits, int8 weights.  Pools are allocated at the kernels'
head dim (:func:`..ops.fwd_kernel.kernel_width`: 64, 128 or 256, and above
256 the next multiple of 128, the wide builds' widths), as the JAX package
pads them to 128 lanes: K/V are zero-padded on write and the
paged ops pad q and slice O (a row's amax, and so its scale, is the same
either way).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._cuda import resolve_device
from ..ops.decode import paged_decode_attention, paged_verify_attention
from ..ops.flash_attention import flash_attention
from ..ops.fwd_kernel import kernel_width, pad_head_dim
from ..ops.quantization import (
    Int4QuantizedTensor,
    QuantizedTensor,
    quantize,
    quantize_int4_values,
)
from .transformer import (
    ModelConfig, Transformer, _cfg_slopes, apply_rope, attn_residual, embed_tokens,
    layer_window, logits_from_hidden, mlp_block, model_rope_tables, qkv, rms_norm,
)

_VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_PAYLOAD_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


class KVPools(NamedTuple):
    """Per-layer page pools (tuples of [Hkv, P, page_size, d] tensors) and,
    for quantized pools, per-token fp32 scales [Hkv, P, page_size, 1]."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    k_scales: Optional[Tuple[torch.Tensor, ...]] = None
    v_scales: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def int4(self) -> bool:
        """INT4-packed pools: payload rows are HALF the scale rows (two
        tokens per byte; ops.quantization split-half packing)."""
        return (self.k_scales is not None
                and self.k[0].shape[-2] * 2 == self.k_scales[0].shape[-2])

    def layer(self, li: int):
        """Layer ``li``'s (K, V) as the paged attention ops take them."""
        if not self.quantized:
            return self.k[li], self.v[li]
        kind = Int4QuantizedTensor if self.int4 else QuantizedTensor
        return (kind(self.k[li], self.k_scales[li]),
                kind(self.v[li], self.v_scales[li]))


def init_kv_pools(
    cfg: ModelConfig,
    *,
    num_pages: int,
    page_size: int = 128,
    dtype=torch.bfloat16,
    quantized: bool = False,
    device="cuda",
    num_kv_heads: Optional[int] = None,
) -> KVPools:
    """Zeroed pools, one K and one V per layer: value pools of ``dtype``,
    or with ``quantized`` int8 / fp8 payloads (``dtype``) or, for
    ``dtype="int4"``, packed int4 bytes [Hkv, P, page_size/2, d], with
    scales of 1.  d is the kernels' head dim, ``kernel_width(head_dim)``.
    Hkv is ``num_kv_heads`` (a tensor-parallel rank's share), by default
    ``cfg.n_kv_heads``."""
    hkv = cfg.n_kv_heads if num_kv_heads is None else num_kv_heads
    int4 = isinstance(dtype, str) and dtype == "int4"
    if int4:
        if page_size % 2:
            raise ValueError(f"int4 pools need an even page_size, got {page_size}")
        quantized, dtype = True, torch.int8  # packed payload bytes
    elif isinstance(dtype, str):
        raise ValueError(f"unknown KV dtype {dtype!r}")
    if quantized and dtype not in _PAYLOAD_DTYPES:
        raise ValueError(f"quantized pools hold int8, int4 or fp8, not {dtype}")
    if not quantized and dtype not in _VALUE_DTYPES:
        raise ValueError(f"{dtype} pools need quantized=True")
    device = resolve_device(device)
    store_ps = page_size // 2 if int4 else page_size
    shape = (hkv, num_pages, store_ps, kernel_width(cfg.head_dim))

    def pools(make):
        return tuple(make() for _ in range(cfg.n_layers))

    k = pools(lambda: torch.zeros(shape, dtype=dtype, device=device))
    v = pools(lambda: torch.zeros(shape, dtype=dtype, device=device))
    if not quantized:
        return KVPools(k, v)
    sshape = (hkv, num_pages, page_size, 1)
    ks = pools(lambda: torch.ones(sshape, dtype=torch.float32, device=device))
    vs = pools(lambda: torch.ones(sshape, dtype=torch.float32, device=device))
    return KVPools(k, v, ks, vs)


def _shift(x: torch.Tensor, k: int, dim: int, fill) -> torch.Tensor:
    """y[..., j, ...] = x[..., j + k, ...] along ``dim``, ``fill`` outside."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(k) < n:
        src = x.narrow(dim, max(k, 0), n - abs(k))
        out.narrow(dim, max(-k, 0), n - abs(k)).copy_(src)
    return out


def _int4_insert(pool, rows, offs, vals_q) -> None:
    """Write int4 values into a packed pool in place.

    pool: [Hkv, P, page_size/2, d] int8 (split-half packed); rows/offs
    [N, T]: page and in-page offset of each token, the T tokens of a row at
    consecutive positions (a row's front padding may all go to one scratch
    page); vals_q: [Hkv, N, T, d] int32 in [-8, 7].  Offset o lives in byte
    row o (low nibble) when o < page_size/2, else in byte row
    o - page_size/2 (high nibble).  Two tokens of one row share a byte when
    their offsets differ by page_size/2, i.e. half a page apart in the row:
    both then write the byte with both new nibbles, so no nibble is lost
    whatever T is.  (The JAX package reads the old byte once per token and
    loses one nibble of such a pair when T > page_size/2.)"""
    half = pool.shape[-2]
    is_low = offs < half
    brow = torch.where(is_low, offs, offs - half)
    raw = pool.view(torch.uint8)
    old = raw[:, rows, brow].to(torch.int32)  # [Hkv, N, T, d]
    nib = vals_q & 0xF
    low_side = is_low[None, :, :, None]
    step = torch.where(is_low, half, -half)
    p_rows = torch.where(is_low, _shift(rows, half, -1, -1), _shift(rows, -half, -1, -1))
    p_offs = torch.where(is_low, _shift(offs, half, -1, -1), _shift(offs, -half, -1, -1))
    paired = ((p_rows == rows) & (p_offs == offs + step))[None, :, :, None]
    p_nib = torch.where(low_side, _shift(nib, half, -2, 0), _shift(nib, -half, -2, 0))
    low = torch.where(low_side, nib, torch.where(paired, p_nib, old & 0xF))
    high = torch.where(low_side, torch.where(paired, p_nib, (old >> 4) & 0xF), nib)
    raw[:, rows, brow] = (low | (high << 4)).to(torch.uint8)


def _write_tokens(pools: KVPools, li: int, rows, offs, k, v) -> None:
    """Layer ``li``'s K/V of new tokens into the pools in place, quantized
    per token on write for quantized pools (the same payloads and scales as
    :func:`..ops.quantization.quantize` / ``quantize_int4``): rows/offs
    [N, T] (see :func:`_int4_insert`), k/v [Hkv, N, T, d], zero-padded to
    the pools' head dim."""
    scales = ((pools.k_scales[li], pools.v_scales[li]) if pools.quantized
              else (None, None))
    width = pools.k[li].shape[-1]
    for pool, sc, x in zip((pools.k[li], pools.v[li]), scales, (k, v)):
        x = pad_head_dim(x, width)
        if pools.int4:
            xq, xs = quantize_int4_values(x)
            _int4_insert(pool, rows, offs, xq)
        elif pools.quantized:
            xq = quantize(x, pool.dtype)
            pool[:, rows, offs], xs = xq.values, xq.scales
        else:
            pool[:, rows, offs] = x.to(pool.dtype)
            continue
        sc[:, rows, offs] = xs


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig):
    """(model, tokens [B, T], lengths [B]) -> (last-token logits [B, V] fp32,
    per-layer K/V [L] of ([B, Hkv, T, d], [B, Hkv, T, d])).  T may be
    padded: attention is causal, so padding rows only look back and are
    discarded, and the ALiBi bias of a real row depends only on its own
    position; ``lengths`` picks each row's last real token.  Each layer
    attends within its own window (:func:`..transformer.layer_window`)."""
    @torch.inference_mode()
    def prefill(model: Transformer, tokens, lengths):
        b, t = tokens.shape
        slopes = _cfg_slopes(cfg, model.tp)  # this rank's heads' slopes
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = embed_tokens(model, tokens, cfg)
        rope_cs = model_rope_tables(positions, cfg)
        kvs = []
        for li, layer in enumerate(model.layers):
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q, k, v = qkv(layer, h, cfg)
            if rope_cs is not None:
                q = apply_rope(q, *rope_cs)
                k = apply_rope(k, *rope_cs)
            kvs.append((k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous()))
            o = flash_attention(
                q.transpose(1, 2).contiguous(), kvs[-1][0], kvs[-1][1],
                causal=True, sm_scale=cfg.sm_scale, window=layer_window(cfg, li),
                logit_softcap=cfg.attn_softcap, alibi_slopes=slopes,
            )
            x = attn_residual(layer, x, o.transpose(1, 2).reshape(b, t, -1), cfg)
            x = mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        rows = torch.arange(b, device=x.device)
        last = x[rows, lengths.to(x.device).long() - 1]
        return logits_from_hidden(last, model, cfg.final_softcap), kvs

    return prefill


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ModelConfig, *, pages_per_block: Optional[int] = None):
    """Decode step that writes the new K/V into the pools IN PLACE (the JAX
    version donates its pools to the same effect) and returns them.
    ``pages_per_block``: the pages of one key split of every layer's paged
    decode (None: the kernel's planner, ops/decode.py decode_splits).

    (model, pools, tokens [B], positions [B], page_rows [B], page_offs [B],
     page_tbl [B, pages_per_seq] int32, lengths [B] int32)
     -> (logits [B, V] fp32, pools)

    ``positions`` is the absolute index of the incoming token; ``lengths``
    already counts it (an ALiBi model's query sits at lengths − 1)."""
    @torch.inference_mode()
    def decode_step(model: Transformer, pools: KVPools, tokens, positions,
                    page_rows, page_offs, page_tbl, lengths):
        b = tokens.shape[0]
        slopes = _cfg_slopes(cfg, model.tp)  # this rank's heads' slopes
        rows, offs = page_rows.long()[:, None], page_offs.long()[:, None]
        x = embed_tokens(model, tokens, cfg)  # [B, dm]
        rope_cs = model_rope_tables(positions, cfg)  # [B, 1, d/2]
        for li, layer in enumerate(model.layers):
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q, k, v = qkv(layer, h, cfg)
            if rope_cs is not None:
                q = apply_rope(q, *rope_cs)  # RoPE at each token's absolute position
                k = apply_rope(k, *rope_cs)
            # this token's K/V into its (page, offset): [Hkv, B, 1, d]
            _write_tokens(pools, li, rows, offs, k.transpose(0, 1)[:, :, None],
                          v.transpose(0, 1)[:, :, None])
            o = paged_decode_attention(
                q.contiguous(), *pools.layer(li), lengths, page_tbl,
                sm_scale=cfg.sm_scale, alibi_slopes=slopes,
                logit_softcap=cfg.attn_softcap, pages_per_block=pages_per_block,
            )  # [B, Hq, d]
            x = attn_residual(layer, x, o.reshape(b, -1), cfg)
            x = mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        return logits_from_hidden(x, model, cfg.final_softcap), pools

    return decode_step


# ---------------------------------------------------------------------------
# Verify step: T tokens per sequence in one pass (chunked prefill)
# ---------------------------------------------------------------------------


def make_verify_step(cfg: ModelConfig, num_tokens: int, *,
                     pages_per_block: Optional[int] = None):
    """Multi-token step for chunked prefill and speculative verification,
    pools written IN PLACE; ``pages_per_block`` as in
    :func:`make_decode_step`, for every layer's paged verify.

    (model, pools, tokens [B, T], positions [B, T], page_rows [B, T],
     page_offs [B, T], page_tbl [B, pages_per_seq], lengths [B])
     -> (logits [B, T, V] fp32, pools)

    Writes all T tokens' K/V into the pools, then scores every position
    with :func:`..ops.decode.paged_verify_attention`: token t attends to
    positions < lengths − (T−1−t).  ``lengths`` is the FINAL length (all T
    counted).  The T tokens of a sequence sit at consecutive positions
    (an ALiBi model's token t at lengths − T + t); padding tokens may all
    write to one scratch page."""
    t_new = num_tokens
    @torch.inference_mode()
    def verify_step(model: Transformer, pools: KVPools, tokens, positions,
                    page_rows, page_offs, page_tbl, lengths):
        b = tokens.shape[0]
        slopes = _cfg_slopes(cfg, model.tp)  # this rank's heads' slopes
        rows, offs = page_rows.long(), page_offs.long()
        x = embed_tokens(model, tokens, cfg)  # [B, T, dm]
        rope_cs = model_rope_tables(positions, cfg)  # [B, T, 1, d/2]
        for li, layer in enumerate(model.layers):
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q, k, v = qkv(layer, h, cfg)
            if rope_cs is not None:
                q = apply_rope(q, *rope_cs)
                k = apply_rope(k, *rope_cs)
            # all B·T tokens' K/V: [Hkv, B, T, d]
            _write_tokens(pools, li, rows, offs, k.permute(2, 0, 1, 3),
                          v.permute(2, 0, 1, 3))
            o = paged_verify_attention(
                q.transpose(1, 2).contiguous(), *pools.layer(li), lengths,
                page_tbl, sm_scale=cfg.sm_scale, alibi_slopes=slopes,
                logit_softcap=cfg.attn_softcap, pages_per_block=pages_per_block,
            )  # [B, Hq, T, d]
            x = attn_residual(layer, x, o.transpose(1, 2).reshape(b, t_new, -1), cfg)
            x = mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        return logits_from_hidden(x, model, cfg.final_softcap), pools

    return verify_step


# ---------------------------------------------------------------------------
# Admission writes
# ---------------------------------------------------------------------------


def write_prompt_kv(pools: KVPools, layer: int, kv, pages, page_size: int) -> KVPools:
    """Write one sequence's prompt K/V ([Hkv, T, d] each) into its pages
    (``pages`` [n_pages]), in place, quantized on write for quantized pools
    (padding tokens get scale 1): each page is one row of
    :func:`_write_tokens`."""
    k, v = kv
    hkv, t, d = k.shape
    n_pages = pages.shape[0]
    pad = n_pages * page_size - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    device = pools.k[layer].device
    rows = pages.to(device).long()[:, None].expand(n_pages, page_size)
    offs = torch.arange(page_size, device=device).expand(n_pages, page_size)
    _write_tokens(pools, layer, rows, offs, k.reshape(hkv, n_pages, page_size, d),
                  v.reshape(hkv, n_pages, page_size, d))
    return pools


def write_prompt_kv_all(pools: KVPools, kvs, pages, page_size: int) -> KVPools:
    """All layers' admission write for one sequence, in place.  ``kvs`` is
    the prefill's per-layer (k, v), each [1, Hkv, T_pad, d]; ``pages``
    [n_pages] covers the prompt."""
    n = pages.shape[0]
    with torch.inference_mode():
        for li, (k, v) in enumerate(kvs):
            write_prompt_kv(pools, li, (k[0, :, : n * page_size],
                                        v[0, :, : n * page_size]),
                            pages, page_size)
    return pools


def write_prompt_kv_batch(pools: KVPools, kvs, pages_b, page_size: int) -> KVPools:
    """Batched admission write, in place: every sequence's every layer.
    ``kvs`` is the prefill's per-layer (k, v), each [n, Hkv, T_pad, d];
    ``pages_b`` [n, max_pages] holds each sequence's prompt pages, rows
    padded to a common width with the null page (padding writes land there
    and are never read, the scratch contract of frozen burst slots).  Each
    page is one row of :func:`_write_tokens`, so the writes (quantized on
    write for quantized pools) are those of :func:`write_prompt_kv` per
    sequence."""
    n, max_pages = pages_b.shape
    span = max_pages * page_size
    device = pools.k[0].device
    rows = pages_b.to(device).long().reshape(-1, 1).expand(n * max_pages, page_size)
    offs = torch.arange(page_size, device=device).expand(n * max_pages, page_size)

    def paged(x):  # [n, Hkv, T_pad, d] -> [Hkv, n * max_pages, page_size, d]
        x = x[:, :, :span]
        if x.shape[2] < span:
            x = torch.nn.functional.pad(x, (0, 0, 0, span - x.shape[2]))
        hkv, d = x.shape[1], x.shape[3]
        return x.transpose(0, 1).reshape(hkv, n * max_pages, page_size, d)

    with torch.inference_mode():
        for li, (k, v) in enumerate(kvs):
            _write_tokens(pools, li, rows, offs, paged(k), paged(v))
    return pools
