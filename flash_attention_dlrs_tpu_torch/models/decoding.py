"""Prefill and decode step, PyTorch port of ``flash_attention_dlrs_tpu/models/decoding.py``.

Prefill runs the causal attention kernel over the prompt and returns each
layer's K/V for the paged cache; the decode step embeds the batch's current
tokens and, per layer, projects QKV, applies RoPE at the absolute position,
writes the new K/V into the page pools in place and attends over the pages
with :func:`..ops.decode.paged_decode_attention`.  PyTorch runs eagerly, so
there is no jit here; shapes stay static (slots × pages_per_seq) all the
same.  Pools keep the model's head_dim: the JAX package pads it to 128 lanes
for the TPU's DMA tiling, which this card does not need.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .._cuda import resolve_device
from ..ops.decode import paged_decode_attention
from ..ops.flash_attention import flash_attention
from .transformer import (
    ModelConfig, Transformer, _proj, apply_rope, logits_from_hidden,
    mlp_block, rms_norm, rope_tables,
)

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 2 of the PyTorch port)"


class KVPools(NamedTuple):
    """Per-layer page pools (tuples of [Hkv, P, page_size, d] tensors);
    unquantized only."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


def init_kv_pools(
    cfg: ModelConfig,
    *,
    num_pages: int,
    page_size: int = 128,
    dtype=torch.bfloat16,
    quantized: bool = False,
    device="cuda",
) -> KVPools:
    """Zeroed unquantized pools, one K and one V per layer."""
    if quantized or isinstance(dtype, str):
        raise NotImplementedError(_NOT_YET.format("quantized KV pools"))
    device = resolve_device(device)
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    k = tuple(torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers))
    v = tuple(torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers))
    return KVPools(k, v)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig):
    """(model, tokens [B, T], lengths [B]) -> (last-token logits [B, V] fp32,
    per-layer K/V [L] of ([B, Hkv, T, d], [B, Hkv, T, d])).  T may be
    padded: attention is causal, so padding rows only look back and are
    discarded; ``lengths`` picks each row's last real token."""

    @torch.inference_mode()
    def prefill(model: Transformer, tokens, lengths):
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = model.embed[tokens]
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        kvs = []
        for layer in model.layers:
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q = _proj(h, layer.wq).reshape(b, t, cfg.n_q_heads, cfg.head_dim)
            k = _proj(h, layer.wk).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
            v = _proj(h, layer.wv).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
            q = apply_rope(q, *rope_cs)
            k = apply_rope(k, *rope_cs)
            kvs.append((k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous()))
            o = flash_attention(
                q.transpose(1, 2).contiguous(), kvs[-1][0], kvs[-1][1],
                causal=True, sm_scale=cfg.sm_scale,
            )
            x = x + _proj(o.transpose(1, 2).reshape(b, t, -1), layer.wo)
            x = mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        rows = torch.arange(b, device=x.device)
        last = x[rows, lengths.to(x.device).long() - 1]
        return logits_from_hidden(last, model), kvs

    return prefill


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ModelConfig):
    """Decode step that writes the new K/V into the pools IN PLACE (the JAX
    version donates its pools to the same effect) and returns them.

    (model, pools, tokens [B], positions [B], page_rows [B], page_offs [B],
     page_tbl [B, pages_per_seq] int32, lengths [B] int32)
     -> (logits [B, V] fp32, pools)

    ``positions`` is the absolute index of the incoming token; ``lengths``
    already counts it."""

    @torch.inference_mode()
    def decode_step(model: Transformer, pools: KVPools, tokens, positions,
                    page_rows, page_offs, page_tbl, lengths):
        b = tokens.shape[0]
        rows, offs = page_rows.long(), page_offs.long()
        x = model.embed[tokens]  # [B, dm]
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)  # [B, 1, d/2]
        for li, layer in enumerate(model.layers):
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q = _proj(h, layer.wq).reshape(b, cfg.n_q_heads, cfg.head_dim)
            k = _proj(h, layer.wk).reshape(b, cfg.n_kv_heads, cfg.head_dim)
            v = _proj(h, layer.wv).reshape(b, cfg.n_kv_heads, cfg.head_dim)
            q = apply_rope(q, *rope_cs)  # RoPE at each token's absolute position
            k = apply_rope(k, *rope_cs)
            # this token's K/V into its (page, offset): [Hkv, B, d]
            pools.k[li][:, rows, offs] = k.transpose(0, 1).to(pools.k[li].dtype)
            pools.v[li][:, rows, offs] = v.transpose(0, 1).to(pools.v[li].dtype)
            o = paged_decode_attention(
                q.contiguous(), pools.k[li], pools.v[li], lengths, page_tbl,
                sm_scale=cfg.sm_scale,
            )  # [B, Hq, d]
            x = x + _proj(o.reshape(b, -1), layer.wo)
            x = mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        return logits_from_hidden(x, model), pools

    return decode_step


# ---------------------------------------------------------------------------
# Admission writes
# ---------------------------------------------------------------------------


def write_prompt_kv(pools: KVPools, layer: int, kv, pages, page_size: int) -> KVPools:
    """Write one sequence's prompt K/V ([Hkv, T, d] each) into its pages
    (``pages`` [n_pages]), in place."""
    k, v = kv
    hkv, t, d = k.shape
    n_pages = pages.shape[0]
    pad = n_pages * page_size - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    idx = pages.to(pools.k[layer].device).long()
    pools.k[layer][:, idx] = k.reshape(hkv, n_pages, page_size, d).to(
        pools.k[layer].dtype)
    pools.v[layer][:, idx] = v.reshape(hkv, n_pages, page_size, d).to(
        pools.v[layer].dtype)
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
