"""Bidirectional transformer encoder (BERT-style), PyTorch port of
``flash_attention_dlrs_tpu/models/encoder.py``.

The second model family: the decoder's blocks (RMSNorm, RoPE, SwiGLU) with
non-causal flash attention and a masked-LM head on the tied embedding.  It
runs the attention kernels' bidirectional path inside a whole model, and
its gradient through the backward sweeps.  Parameters have the decoder's
structure: a :class:`~.transformer.Transformer` (``init_encoder_params`` is
:func:`~.weights.init_params_numpy`, turned into a model by
``params_from_jax``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from .transformer import (
    ModelConfig, Block, Transformer, _proj, lm_logits, mlp_block, rms_norm, rope,
)
from .weights import init_params_numpy


def _block(layer: Block, x, positions, cfg: ModelConfig):
    b, n, _ = x.shape
    h = rms_norm(x, layer.attn_norm)
    q = _proj(h, layer.wq).reshape(b, n, cfg.n_q_heads, cfg.head_dim)
    k = _proj(h, layer.wk).reshape(b, n, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(h, layer.wv).reshape(b, n, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=False,  # the bidirectional difference
    )
    x = x + _proj(o.transpose(1, 2).reshape(b, n, -1), layer.wo)
    return mlp_block(layer, x)


def encode(model: Transformer, tokens, cfg: ModelConfig):
    """Token ids [B, N] → contextual embeddings [B, N, d_model]
    (bidirectional).  With ``cfg.remat`` and gradients on, each block runs
    under ``torch.utils.checkpoint`` (the backward recomputes it, attention
    kernel included), as the JAX encoder wraps each in ``jax.checkpoint``."""
    b, n = tokens.shape
    positions = torch.arange(n, device=tokens.device).expand(b, n)
    x = model.embed[tokens]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        if remat:
            x = checkpoint(_block, layer, x, positions, cfg, use_reentrant=False)
        else:
            x = _block(layer, x, positions, cfg)
    return rms_norm(x, model.final_norm)


def mlm_logits(model: Transformer, tokens, cfg: ModelConfig):
    """Masked-LM logits [B, N, vocab] fp32 through the tied embedding."""
    return lm_logits(encode(model, tokens, cfg), model.embed)


def mlm_loss(model: Transformer, tokens, masked_tokens, mask_positions, cfg: ModelConfig):
    """Mean NLL of the original ``tokens`` [B, N] at ``mask_positions``
    (bool [B, N]) from the logits of ``masked_tokens`` (the mask token
    substituted there)."""
    logits = mlm_logits(model, masked_tokens, cfg)
    nll = torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), tokens.flatten().long(), reduction="none")
    mask = mask_positions.flatten()
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom


init_encoder_params = init_params_numpy  # same parameter structure
