"""Decoder-only GQA transformer, PyTorch port of ``flash_attention_dlrs_tpu/models/transformer.py``.

RMSNorm → (RoPE, GQA attention) → RMSNorm → SwiGLU, residual around both,
tied embeddings by default.  Parameters live in :class:`Transformer`, an
``nn.Module`` with the JAX package's names and layouts (weights stored
``[in, out]`` so projections are ``x @ W``); the functions below take it in
place of the JAX params dict.  Plain projections are ``torch.matmul``, as
the JAX package leaves them to XLA; attention goes through the port's
kernels, forward and backward.  Parameters are trainable; the serving paths
run under ``torch.inference_mode``.  Variants the port does not run yet
raise when a :class:`ModelConfig` is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._cuda import resolve_device
from ..ops.flash_attention import flash_attention

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 1 of the PyTorch port)"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Same fields as the JAX package's ModelConfig.  ``dtype`` is a torch
    dtype.  ``remat`` with ``remat_policy="block"`` recomputes each layer in
    the backward (``torch.utils.checkpoint``), except the last
    ``remat_skip`` layers; the policies that pin named outputs
    (``save_flash``, ``save_dots``, ``save_matmuls``) raise
    ``NotImplementedError``.  ``loss_chunk`` chunks the cross entropy of
    :func:`loss_fn`."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_q_heads: int = 8
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1408
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None
    window: int = 0
    window_pattern: str = "all"
    norm_eps: float = 1e-6
    mlp_act: str = "silu"
    embed_scale: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sm_scale: Optional[float] = None
    tie_embeddings: bool = True
    position_encoding: str = "rope"
    attn_dropout: float = 0.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "block"
    remat_skip: int = 0
    loss_chunk: int = 0

    def __post_init__(self):
        if self.position_encoding not in ("rope", "alibi"):
            raise ValueError(
                f"unknown position_encoding {self.position_encoding!r} "
                "(expected 'rope' or 'alibi')")
        if self.mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"unknown mlp_act {self.mlp_act!r}")
        unported = {
            "rope_scaling": self.rope_scaling is not None,
            "position_encoding='alibi'": self.position_encoding == "alibi",
            "window": bool(self.window),
            "attn_dropout": bool(self.attn_dropout),
            "mlp_act='gelu_tanh'": self.mlp_act == "gelu_tanh",
            "embed_scale": self.embed_scale,
            "attn_softcap": bool(self.attn_softcap),
            "final_softcap": bool(self.final_softcap),
        }
        for name, used in unported.items():
            if used:
                raise NotImplementedError(_NOT_YET.format(f"ModelConfig {name}"))
        if self.n_q_heads % self.n_kv_heads:
            raise ValueError(
                f"n_q_heads ({self.n_q_heads}) must be a multiple of "
                f"n_kv_heads ({self.n_kv_heads})")

    @classmethod
    def tiny(cls, **kw):
        return cls(
            vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, **kw,
        )

    @classmethod
    def b7(cls, **kw):
        """7B-class head config (north-star eval shape)."""
        return cls(
            vocab_size=32000, d_model=4096, n_layers=32, n_q_heads=32,
            n_kv_heads=8, head_dim=128, d_ff=11008, **kw,
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One decoder layer's parameters (names as in the JAX params dict)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dm, dh, dff = cfg.d_model, cfg.head_dim, cfg.d_ff
        nq, nkv, dt = cfg.n_q_heads, cfg.n_kv_heads, cfg.dtype
        self.attn_norm = _param((dm,), torch.float32, device)
        self.wq = _param((dm, nq * dh), dt, device)
        self.wk = _param((dm, nkv * dh), dt, device)
        self.wv = _param((dm, nkv * dh), dt, device)
        self.wo = _param((nq * dh, dm), dt, device)
        self.mlp_norm = _param((dm,), torch.float32, device)
        self.w_gate = _param((dm, dff), dt, device)
        self.w_up = _param((dm, dff), dt, device)
        self.w_down = _param((dff, dm), dt, device)


class Transformer(nn.Module):
    """Parameters of the model, uninitialized: fill them with
    :func:`..models.weights.params_from_jax`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), cfg.dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.vocab_size, cfg.d_model), cfg.dtype, device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-6):
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * weight).to(x.dtype)


def _proj(x, w):
    return torch.matmul(x, w)


def rope_tables(positions, d: int, theta: float, scaling=None):
    """RoPE cos/sin for positions [..., N]: [..., N, 1, d/2] each, to
    broadcast over heads.  Built once per call and shared by q, k and every
    layer."""
    if scaling is not None:
        raise NotImplementedError(_NOT_YET.format("rope_scaling"))
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d)
    angles = positions[..., :, None].float() * freqs  # [..., N, d/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, cos, sin):
    """Rotate [..., N, H, d] by tables from :func:`rope_tables`."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x, positions, theta: float, scaling=None):
    """Rotary embedding on [..., N, H, d]; positions [..., N]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, scaling))


def attention_block(layer: Block, x, rope_cs, cfg: ModelConfig):
    """``rope_cs``: the (cos, sin) tables of the positions of x."""
    b, n, _ = x.shape
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    q = _proj(h, layer.wq).reshape(b, n, cfg.n_q_heads, cfg.head_dim)
    k = _proj(h, layer.wk).reshape(b, n, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(h, layer.wv).reshape(b, n, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    o = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=True,
        sm_scale=cfg.sm_scale,
    )
    o = o.transpose(1, 2).reshape(b, n, cfg.n_q_heads * cfg.head_dim)
    return x + _proj(o, layer.wo)


def mlp_block(layer: Block, x, eps: float = 1e-6, act: str = "silu"):
    if act != "silu":
        raise NotImplementedError(_NOT_YET.format(f"mlp_act={act!r}"))
    h = rms_norm(x, layer.mlp_norm, eps)
    gate = _proj(h, layer.w_gate)
    up = _proj(h, layer.w_up)
    gated = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + _proj(gated, layer.w_down)


# remat policies of the JAX package that pin named outputs
_UNPORTED_REMAT = ("save_flash", "save_dots", "save_matmuls")


def _block(layer: Block, x, rope_cs, cfg: ModelConfig):
    x = attention_block(layer, x, rope_cs, cfg)
    return mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)


def forward_hidden(model: Transformer, tokens, cfg: ModelConfig, *,
                   positions=None):
    """Token ids [B, N] → final-norm hidden states [B, N, d_model].  With
    ``cfg.remat`` and gradients on, each of the first ``n_layers −
    remat_skip`` layers runs under ``torch.utils.checkpoint`` (the JAX
    "block" policy): the backward recomputes it, attention kernel
    included."""
    if cfg.remat and cfg.remat_policy in _UNPORTED_REMAT:
        raise NotImplementedError(
            _NOT_YET.format(f"remat_policy={cfg.remat_policy!r}"))
    b, n = tokens.shape
    if positions is None:
        positions = torch.arange(n, device=tokens.device).expand(b, n)
    x = model.embed[tokens]
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    n_ckpt = 0
    if cfg.remat and torch.is_grad_enabled():
        n_ckpt = cfg.n_layers - max(0, cfg.remat_skip)
    for i, layer in enumerate(model.layers):
        if i < n_ckpt:
            x = checkpoint(_block, layer, x, rope_cs, cfg, use_reentrant=False)
        else:
            x = _block(layer, x, rope_cs, cfg)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def logits_from_hidden(x, model: Transformer):
    """Hidden states → fp32 logits: the unembedding in fp32, as the JAX
    package's f32-accumulated dot returns them."""
    return torch.matmul(x.float(), unembed_matrix(model).float().t())


def forward(model: Transformer, tokens, cfg: ModelConfig, *, positions=None):
    """Token ids [B, N] → logits [B, N, vocab] fp32: the dense causal
    forward, which the tests use as the greedy oracle."""
    return logits_from_hidden(
        forward_hidden(model, tokens, cfg, positions=positions), model)


def unembed_matrix(model: Transformer):
    """[V, d_model] output embedding: the separate ``unembed`` when the
    model unties it, the input embedding otherwise."""
    return getattr(model, "unembed", model.embed)


def chunked_cross_entropy(x, embed, targets, chunk: int):
    """Mean next-token NLL of hidden states x [B, N, d] against ``targets``
    [B, N] without keeping the [B, N, vocab] fp32 logits: each chunk of
    ``chunk`` positions computes its logits under ``torch.utils.checkpoint``,
    so the backward recomputes them chunk by chunk.  N must divide by
    ``chunk``."""
    b, n, _ = x.shape
    if n % chunk:
        raise ValueError(f"seq len {n} not divisible by loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n, chunk):
        total = total + checkpoint(_chunk_nll, x[:, c0:c0 + chunk], embed,
                                   targets[:, c0:c0 + chunk], use_reentrant=False)
    return total / (b * n)


def _chunk_nll(x_c, embed, t_c):
    logits = torch.matmul(x_c.float(), embed.float().t())
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), t_c.flatten(), reduction="sum")


def loss_fn(model: Transformer, tokens, cfg: ModelConfig):
    """Next-token cross entropy over tokens[:, :-1] → tokens[:, 1:]: the
    mean NLL from fp32 logits.  ``tokens`` [B, N+1] integer ids on the
    model's device."""
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.loss_chunk:
        x = forward_hidden(model, inputs, cfg)
        return chunked_cross_entropy(x, unembed_matrix(model), targets,
                                     cfg.loss_chunk)
    logits = forward(model, inputs, cfg)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), targets.flatten())
