"""Decoder-only GQA transformer, PyTorch port of ``flash_attention_dlrs_tpu/models/transformer.py``.

RMSNorm → (RoPE or ALiBi, GQA attention) → RMSNorm → SwiGLU, residual
around both, tied embeddings by default.  Parameters live in :class:`Transformer`, an
``nn.Module`` with the JAX package's names and layouts (weights stored
``[in, out]`` so projections are ``x @ W``); the functions below take it in
place of the JAX params dict.  Plain projections are ``torch.matmul``, as
the JAX package leaves them to XLA; attention goes through the port's
kernels, forward and backward.  Parameters are trainable; the serving paths
run under ``torch.inference_mode``.

The open checkpoint families' variants ride the same blocks (see
``models/convert.py``): scaled RoPE (linear, YaRN, Llama-3), sliding
windows per layer (:func:`layer_window`), the attention-logit and
final-logit softcaps, GeGLU, embeddings scaled by √d_model, an explicit
softmax scale, QKV biases and Gemma-2's sandwich norms (optional layer
parameters, present only when the weights have them), and weight-only int8
projections (:func:`quantize_params`).

Tensor parallelism (a :class:`Transformer` made with a ``mesh``): each rank
holds its slice of the heads and of the MLP's hidden width (the JAX
package's ``param_shardings``); the column-parallel inputs pass through
:class:`ToModel` (identity forward, gradient all-reduced over the model
axis) and the row-parallel outputs ``x @ wo`` and ``x @ w_down`` through
:class:`FromModel` (summed over the model axis), before any sandwich norm.
A rank takes its slice of the GLOBAL ALiBi slopes and folds its (data,
model) coordinates into the dropout seed as the JAX package's partitioned
attention does (``ops/partitioning.py``: prime 49979687, flat = data index ·
tp + model index).  An ALiBi model with dropout attends the whole batch and
every head on every rank, with the seed unfolded, and keeps its own block:
JAX's partitioned attention replicates an ALiBi call, so its masks are the
single-device masks.

Attention dropout runs only when a ``dropout_seed`` is passed (training):
layer i draws its mask from the seed base + i·1299709, wrapped to int32 as
the JAX package's int32 arithmetic wraps it, so a remat recompute and the
backward see the forward's mask and training stays bitwise reproducible.

Remat follows the JAX package's policies: "block" recomputes each layer in
the backward (``torch.utils.checkpoint``); "save_flash", "save_dots" and
"save_matmuls" keep the outputs JAX's ``checkpoint_name`` pins
(:data:`REMAT_SAVED`) through a selective checkpoint policy, which sees the
attention forward as one custom operator and the named projections as the
matrix products run inside :func:`checkpoint_name`; everything else is
recomputed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._cuda import resolve_device
from ..ops.flash_attention import FLASH_FWD, flash_attention
from ..parallel.launch import all_gather, all_reduce
from ..ops.fwd_kernel import int32_seed
from ..ops.quantization import QuantizedTensor, int8_matmul, quantize_weight
from ..ops.reference import alibi_slopes_for

# Projection weights (weight-only int8 under quantize_params), the optional
# QKV biases and the optional sandwich norms of a layer.
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BIASES = ("bq", "bk", "bv")
SANDWICH_NORMS = ("post_attn_norm", "post_mlp_norm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Same fields as the JAX package's ModelConfig.  ``dtype`` is a torch
    dtype.  ``remat`` with ``remat_policy="block"`` recomputes each layer in
    the backward (``torch.utils.checkpoint``), except the last
    ``remat_skip`` layers; ``save_flash``, ``save_dots`` and
    ``save_matmuls`` keep the named outputs of :data:`REMAT_SAVED` and
    recompute the rest (any other policy name is block remat, as in the JAX
    package).  ``loss_chunk`` chunks the cross entropy of
    :func:`loss_fn`.  ``position_encoding="alibi"`` replaces RoPE with the
    per-head linear bias of :func:`alibi_slopes_for` (MPT/BLOOM);
    ``attn_dropout`` is the attention-probability dropout rate of training
    steps that pass a ``dropout_seed``.  ``rope_scaling`` is a tuple
    ``("linear", factor)``, ``("llama3", factor, low_freq_factor,
    high_freq_factor, orig_max_pos)`` or ``("yarn", factor, beta_fast,
    beta_slow, orig_max_pos, attn_factor)``; ``window`` slides on the layers
    ``window_pattern`` names ("all", "even", or "from:K"); ``mlp_act`` is
    "silu" or "gelu_tanh"; ``embed_scale``, ``attn_softcap``,
    ``final_softcap`` and ``sm_scale`` are Gemma's (see the JAX
    ModelConfig)."""

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


class QuantizedWeight(nn.Module):
    """A weight-only int8 projection [in, out]: int8 ``values`` and one
    fp32 scale per output channel, ``scales`` [1, out] (buffers: not
    trained), the JAX package's ``QuantizedTensor`` leaf."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        self.register_buffer("values", values)
        self.register_buffer("scales", scales)

    def tensor(self) -> QuantizedTensor:
        return QuantizedTensor(self.values, self.scales)


class TensorParallel:
    """Where a rank sits in a tensor-parallel model: the mesh, its model
    axis (heads and MLP width) and its data axis (batch)."""

    def __init__(self, mesh, model_axis: str = "model", data_axis: str = "data"):
        self.mesh, self.model_axis, self.data_axis = mesh, model_axis, data_axis
        self.size = mesh.size(model_axis)
        self.index = mesh.index(model_axis)

    def dropout_seed(self, seed: int) -> int:
        """The JAX partitioned attention's seed fold: seed + 49979687 ·
        (data index · tp + model index), int32."""
        flat = self.mesh.index(self.data_axis) * self.size + self.index
        return int32_seed(int(seed) + 49979687 * flat)


class ToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis (the
    input of a column-parallel projection)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.tp.mesh, ctx.tp.model_axis), None


class FromModel(torch.autograd.Function):
    """Sum over the model axis forward (the output of a row-parallel
    projection); identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x, tp.mesh, tp.model_axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Whole(torch.autograd.Function):
    """This rank's [B/dp, H/tp, N, d] → the whole [B, H, N, d], gathered over
    the data axis (dim 0) and the model axis (dim 1); the backward keeps
    this rank's block (attention is independent per batch row and head, so
    no other rank's loss reaches it)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.b, ctx.h = tp, x.shape[0], x.shape[1]
        x = torch.cat(all_gather(x, tp.mesh, tp.data_axis), dim=0)
        return torch.cat(all_gather(x, tp.mesh, tp.model_axis), dim=1)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.tp, ctx.b, ctx.h).contiguous(), None


def _own_block(x, tp, b: int, h: int):
    """Rows and heads of the whole [B, H, ...] ``x`` that this rank holds."""
    d = tp.mesh.index(tp.data_axis)
    return x[d * b:(d + 1) * b, tp.index * h:(tp.index + 1) * h]


def _to_model(x, tp):
    return x if tp is None or tp.size == 1 else ToModel.apply(x, tp)


def _from_model(x, tp):
    return x if tp is None or tp.size == 1 else FromModel.apply(x, tp)


class Block(nn.Module):
    """One decoder layer's parameters (names as in the JAX params dict).
    ``extras`` names the optional ones this layer has (:data:`BIASES`,
    :data:`SANDWICH_NORMS`), kept as ``self.extras`` so that a step tests
    a set and never probes the module for a name it lacks; with
    ``quantized`` the projections are :class:`QuantizedWeight` buffers.
    With ``tp`` (a :class:`TensorParallel`) the layer holds its rank's slice
    of the heads and of the MLP's hidden width."""

    def __init__(self, cfg: ModelConfig, device, extras=(), quantized: bool = False,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.extras = frozenset(extras)
        self.tp = tp
        n = 1 if tp is None else tp.size
        dm, dh, dff = cfg.d_model, cfg.head_dim, cfg.d_ff // n
        nq, nkv, dt = cfg.n_q_heads // n, cfg.n_kv_heads // n, cfg.dtype
        shapes = {"attn_norm": (dm,), "wq": (dm, nq * dh), "wk": (dm, nkv * dh),
                  "wv": (dm, nkv * dh), "wo": (nq * dh, dm), "mlp_norm": (dm,),
                  "w_gate": (dm, dff), "w_up": (dm, dff), "w_down": (dff, dm)}
        for name, shape in shapes.items():
            if name not in PROJECTIONS:  # the norms' gains stay fp32
                setattr(self, name, _param(shape, torch.float32, device))
            elif quantized:
                setattr(self, name, QuantizedWeight(
                    torch.empty(shape, dtype=torch.int8, device=device),
                    torch.empty((1, shape[1]), dtype=torch.float32, device=device)))
            else:
                setattr(self, name, _param(shape, dt, device))
        for name in extras:
            if name in BIASES:  # bq is the width of wq's output, and so on
                setattr(self, name, _param((shapes["w" + name[1]][1],), dt, device))
            elif name in SANDWICH_NORMS:
                setattr(self, name, _param((dm,), torch.float32, device))
            else:
                raise ValueError(f"unknown optional layer parameter {name!r}")


class Transformer(nn.Module):
    """Parameters of the model, uninitialized: fill them with
    :func:`..models.weights.params_from_jax`.  ``extras`` and ``quantized``
    are every :class:`Block`'s.  With a ``mesh`` (a
    :class:`..parallel.mesh.Mesh`) this rank's layers hold their slice of
    the model axis (``tp``, a :class:`TensorParallel`); the embeddings and
    norms are whole on every rank."""

    def __init__(self, cfg: ModelConfig, device="cuda", extras=(), quantized: bool = False,
                 mesh=None, model_axis: str = "model", data_axis: str = "data"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tp = None if mesh is None else TensorParallel(mesh, model_axis, data_axis)
        self.embed = _param((cfg.vocab_size, cfg.d_model), cfg.dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device, extras, quantized, self.tp)
                                    for _ in range(cfg.n_layers))
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


# The outputs each selective remat policy keeps (the JAX package's
# save_only_these_names, transformer.py:380-409): the attention forward's O
# and lse, then the MLP's gate and up products, then its down product and
# the attention output projection.
REMAT_SAVED = {
    "save_flash": ("flash_o", "flash_lse"),
    "save_dots": ("flash_o", "flash_lse", "mlp_gate", "mlp_up"),
    "save_matmuls": ("flash_o", "flash_lse", "mlp_gate", "mlp_up", "mlp_down", "attn_wo"),
}
_NAMING = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: Optional[str]):
    """A scope whose matrix products make the output JAX names ``name``
    (``jax.ad_checkpoint.checkpoint_name``): a selective remat policy keeps
    the products run inside it when it pins the name.  Use as ``with
    checkpoint_name("mlp_gate"): ...``."""
    outer = getattr(_NAMING, "name", None)
    _NAMING.name = name
    try:
        yield
    finally:
        _NAMING.name = outer


def remat_policy_fn(saved):
    """The selective checkpoint policy that keeps the outputs named in
    ``saved``: the attention forward (its O and lse together, "flash_o" /
    "flash_lse") and each ``aten.mm`` run inside a :func:`checkpoint_name`
    of a saved name; every other op is recomputed."""
    mm = torch.ops.aten.mm.default

    def policy(ctx, op, *args, **kwargs):
        if op is FLASH_FWD:
            keep = "flash_o" in saved
        else:
            keep = op is mm and getattr(_NAMING, "name", None) in saved
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _proj(x, w, b=None, name=None):
    """x @ W (+ b): ``torch.matmul``, or :func:`..ops.quantization.int8_matmul`
    for a :class:`QuantizedWeight`, as the output JAX names ``name``
    (:func:`checkpoint_name`); the optional bias (Qwen2's QKV biases) is
    added in x's dtype."""
    with checkpoint_name(name):
        y = (int8_matmul(x, w.tensor()) if isinstance(w, QuantizedWeight)
             else torch.matmul(x, w))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def quantize_params(model: "Transformer") -> "Transformer":
    """Weight-only int8, in place: every projection of every layer becomes a
    :class:`QuantizedWeight` (per output channel, from the weight in fp32),
    as the JAX package's ``quantize_params``; returns ``model``."""
    with torch.no_grad():
        for layer in model.layers:
            for name in PROJECTIONS:
                wq = quantize_weight(getattr(layer, name).float())
                delattr(layer, name)
                setattr(layer, name, QuantizedWeight(wq.values, wq.scales))
    return model


def _scaled_rope_freqs(theta: float, d: int, scaling, device=None):
    """Inverse frequencies [d/2] fp32 with optional RoPE scaling (see
    :class:`ModelConfig`): the JAX package's ``_scaled_rope_freqs``, op for
    op (HF's linear, YaRN and Llama-3 rules)."""
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    if scaling is None:
        return freqs
    kind = scaling[0]
    if kind == "linear":
        return freqs / float(scaling[1])
    if kind == "yarn":
        _, factor, beta_fast, beta_slow, orig_max, _att = scaling

        def corr_dim(n_rot):
            return (d * math.log(orig_max / (n_rot * 2 * math.pi))) / (2 * math.log(float(theta)))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), d - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp(
            (torch.arange(d // 2, dtype=torch.float32, device=device) - low) / (high - low),
            0, 1)
        extrap_f = 1.0 - ramp  # 1 where extrapolation (unscaled) wins
        return (freqs / float(factor)) * (1.0 - extrap_f) + freqs * extrap_f
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_max = scaling
        factor, low_ff, high_ff = float(factor), float(low_ff), float(high_ff)
        orig_max = float(orig_max)
        wavelen = 2.0 * math.pi / freqs
        low_wl, high_wl = orig_max / low_ff, orig_max / high_ff
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        interp = (1.0 - smooth) * freqs / factor + smooth * freqs
        out = torch.where(wavelen > low_wl, freqs / factor, freqs)
        is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        return torch.where(is_mid, interp, out)
    raise ValueError(f"unsupported rope_scaling kind {kind!r}")


def rope_tables(positions, d: int, theta: float, scaling=None):
    """RoPE cos/sin for positions [..., N]: [..., N, 1, d/2] each, to
    broadcast over heads.  Built once per call and shared by q, k and every
    layer.  YaRN's attention factor rides both tables, as in HF (it scales
    the scores by its square)."""
    freqs = _scaled_rope_freqs(theta, d, scaling, positions.device)
    angles = positions[..., :, None].float() * freqs  # [..., N, d/2]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    if scaling is not None and scaling[0] == "yarn":
        att = torch.tensor(scaling[5], dtype=torch.float32)
        cos, sin = cos * att, sin * att
    return cos, sin


def model_rope_tables(positions, cfg: ModelConfig):
    """:func:`rope_tables` of the model's RoPE (theta and scaling), or None
    under ALiBi (no rotation; the bias rides in the kernels)."""
    if cfg.position_encoding == "alibi":
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)


def apply_rope(x, cos, sin):
    """Rotate [..., N, H, d] by tables from :func:`rope_tables`."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _cfg_slopes(cfg: ModelConfig, tp: Optional[TensorParallel] = None):
    """Per-head ALiBi slopes of an ALiBi config, else None (RoPE rotates
    instead).  Every attention call of the model takes them; under ``tp``
    a rank takes its slice of the global heads' slopes."""
    if cfg.position_encoding != "alibi":
        return None
    slopes = alibi_slopes_for(cfg.n_q_heads)
    if tp is None or tp.size == 1:
        return slopes
    h = cfg.n_q_heads // tp.size
    return list(slopes)[tp.index * h:(tp.index + 1) * h]


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """This layer's sliding window: ``cfg.window`` gated by
    ``window_pattern`` ("even": Gemma-2's layers 0, 2, ... slide; "from:K":
    Qwen2's max_window_layers, full attention below layer K); 0 = full
    causal."""
    if not cfg.window:
        return 0
    if cfg.window_pattern == "even" and layer_idx % 2 != 0:
        return 0
    if cfg.window_pattern.startswith("from:") and layer_idx < int(cfg.window_pattern[5:]):
        return 0
    return cfg.window


def embed_tokens(model: "Transformer", tokens, cfg: ModelConfig):
    """Token embeddings, times √d_model rounded to their dtype first (as
    the JAX package rounds it) under ``cfg.embed_scale``."""
    x = model.embed[tokens]
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def qkv(layer: "Block", h, cfg: ModelConfig):
    """q [..., Hq, d], k and v [..., Hkv, d] of normed states h [..., dm],
    with the layer's biases where it has them."""
    lead = h.shape[:-1]
    extras = layer.extras
    h = _to_model(h, layer.tp)
    q = _proj(h, layer.wq, layer.bq if "bq" in extras else None, "attn_q")
    k = _proj(h, layer.wk, layer.bk if "bk" in extras else None, "attn_k")
    v = _proj(h, layer.wv, layer.bv if "bv" in extras else None, "attn_v")
    return (q.reshape(*lead, -1, cfg.head_dim),
            k.reshape(*lead, -1, cfg.head_dim),
            v.reshape(*lead, -1, cfg.head_dim))


def attn_residual(layer: "Block", x, o, cfg: ModelConfig):
    """x + o W_o, the output normed first where the layer has Gemma-2's
    sandwich norm; o [..., Hq·d]."""
    out = _from_model(_proj(o, layer.wo, name="attn_wo"), layer.tp)
    if "post_attn_norm" in layer.extras:
        out = rms_norm(out, layer.post_attn_norm, cfg.norm_eps)
    return x + out


def layer_seed(dropout_seed, layer: int) -> int:
    """Layer ``layer``'s dropout seed: base + layer·1299709 in int32
    wrap-around (the JAX package's forward_hidden)."""
    return int32_seed(int(dropout_seed) + layer * 1299709)


def rope(x, positions, theta: float, scaling=None):
    """Rotary embedding on [..., N, H, d]; positions [..., N]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, scaling))


def attention_block(layer: Block, x, rope_cs, cfg: ModelConfig,
                    dropout_seed: Optional[int] = None, layer_idx: int = 0):
    """``rope_cs``: the (cos, sin) tables of the positions of x, or None
    under ALiBi (no rotation; the bias rides in the kernel).  With a
    ``dropout_seed`` (this layer's) and ``cfg.attn_dropout``, attention
    probabilities are dropped.  The layer's window is
    ``layer_window(cfg, layer_idx)``."""
    b, n, _ = x.shape
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    q, k, v = qkv(layer, h, cfg)
    if rope_cs is not None:
        q = apply_rope(q, *rope_cs)
        k = apply_rope(k, *rope_cs)
    rate = cfg.attn_dropout if dropout_seed is not None else 0.0
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    tp = layer.tp
    slopes = _cfg_slopes(cfg, tp)
    whole = bool(rate) and tp is not None and slopes is not None
    if whole:  # ALiBi with dropout on a mesh: JAX's single-device masks
        bl, hl = q.shape[:2]
        q, k, v = (_Whole.apply(t, tp) for t in (q, k, v))
        slopes = _cfg_slopes(cfg)
    elif rate and tp is not None:
        dropout_seed = tp.dropout_seed(dropout_seed)
    o = flash_attention(
        q, k, v,
        causal=True,
        sm_scale=cfg.sm_scale,
        window=layer_window(cfg, layer_idx),
        logit_softcap=cfg.attn_softcap,
        alibi_slopes=slopes,
        dropout_rate=rate,
        dropout_seed=dropout_seed if rate else None,
    )
    if whole:
        o = _own_block(o, tp, bl, hl)
    o = o.transpose(1, 2).reshape(b, n, -1)
    return attn_residual(layer, x, o, cfg)


def mlp_block(layer: Block, x, eps: float = 1e-6, act: str = "silu"):
    """x + the gated MLP: SwiGLU, or GeGLU (tanh GELU) for ``"gelu_tanh"``,
    the gate's activation in fp32; the output normed first where the layer
    has Gemma-2's sandwich norm."""
    h = _to_model(rms_norm(x, layer.mlp_norm, eps), layer.tp)
    gate = _proj(h, layer.w_gate, name="mlp_gate")
    up = _proj(h, layer.w_up, name="mlp_up")
    if act == "gelu_tanh":
        g32 = torch.nn.functional.gelu(gate.float(), approximate="tanh")
    else:
        g32 = torch.nn.functional.silu(gate.float())
    out = _from_model(_proj(g32.to(x.dtype) * up, layer.w_down, name="mlp_down"), layer.tp)
    if "post_mlp_norm" in layer.extras:
        out = rms_norm(out, layer.post_mlp_norm, eps)
    return x + out


def _block(layer: Block, x, rope_cs, cfg: ModelConfig, dropout_seed=None, layer_idx=0):
    x = attention_block(layer, x, rope_cs, cfg, dropout_seed, layer_idx)
    return mlp_block(layer, x, cfg.norm_eps, cfg.mlp_act)


def forward_hidden(model: Transformer, tokens, cfg: ModelConfig, *,
                   positions=None, dropout_seed=None):
    """Token ids [B, N] → final-norm hidden states [B, N, d_model].  With
    ``cfg.remat`` and gradients on, each of the first ``n_layers −
    remat_skip`` layers runs under ``torch.utils.checkpoint``: the backward
    recomputes it with the layer's own dropout seed, the attention kernel
    included under "block" and, under the selective policies of
    :data:`REMAT_SAVED`, all but the outputs they keep.  ALiBi assumes
    contiguous positions: ``positions`` only feed RoPE.  ``dropout_seed``
    (an int) turns on ``cfg.attn_dropout``."""
    b, n = tokens.shape
    if positions is None:
        positions = torch.arange(n, device=tokens.device).expand(b, n)
    x = embed_tokens(model, tokens, cfg)
    rope_cs = model_rope_tables(positions, cfg)
    dropping = dropout_seed is not None and bool(cfg.attn_dropout)
    n_ckpt = 0
    if cfg.remat and torch.is_grad_enabled():
        n_ckpt = cfg.n_layers - max(0, cfg.remat_skip)
    selective = {}
    if cfg.remat_policy in REMAT_SAVED:
        selective["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, remat_policy_fn(REMAT_SAVED[cfg.remat_policy]))
    for i, layer in enumerate(model.layers):
        seed = layer_seed(dropout_seed, i) if dropping else None
        if i < n_ckpt:
            x = checkpoint(_block, layer, x, rope_cs, cfg, seed, i, use_reentrant=False,
                           **selective)
        else:
            x = _block(layer, x, rope_cs, cfg, seed, i)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def softcapped(logits, cap: float):
    """cap·tanh(logits / cap) (Gemma-2's final-logit softcap), or the
    logits as they are for cap 0."""
    return cap * torch.tanh(logits / cap) if cap else logits


class _HalfLogits(torch.autograd.Function):
    """x [M, d] @ Eᵀ → fp32 [M, V] from half-precision x and E on the card:
    one GEMM of the half operands with fp32 accumulation and output
    (``torch.mm``'s ``out_dtype``), whose products are exact in fp32, as the
    JAX package's ``preferred_element_type=f32`` dot makes them; no fp32
    copy of E.  The backward runs in fp32 against E upcast, as JAX's
    transpose of that dot does, and rounds each gradient to its input's
    dtype."""

    @staticmethod
    def forward(ctx, x, e):
        ctx.save_for_backward(x, e)
        return torch.mm(x, e.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        dx = torch.mm(g, e.float()).to(x.dtype) if ctx.needs_input_grad[0] else None
        de = torch.mm(g.t(), x.float()).to(e.dtype) if ctx.needs_input_grad[1] else None
        return dx, de


def lm_logits(x, embed):
    """Hidden states x [..., d] → fp32 logits [..., V] against the output
    embedding [V, d]: :class:`_HalfLogits` for bf16 / fp16 operands on the
    card, else ``torch.matmul`` in true fp32 (the CPU plain path and fp32
    models)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and embed.dtype == x.dtype:
        return _HalfLogits.apply(x.reshape(-1, x.shape[-1]), embed).reshape(*x.shape[:-1], -1)
    return torch.matmul(x.float(), embed.float().t())


def logits_from_hidden(x, model: Transformer, softcap: float = 0.0):
    """Hidden states → fp32 logits (:func:`lm_logits`, as the JAX package's
    f32-accumulated dot returns them), then the final softcap."""
    return softcapped(lm_logits(x, unembed_matrix(model)), softcap)


def forward(model: Transformer, tokens, cfg: ModelConfig, *, positions=None,
            dropout_seed=None):
    """Token ids [B, N] → logits [B, N, vocab] fp32: the dense causal
    forward, which the tests use as the greedy oracle."""
    return logits_from_hidden(
        forward_hidden(model, tokens, cfg, positions=positions,
                       dropout_seed=dropout_seed), model, cfg.final_softcap)


def unembed_matrix(model: Transformer):
    """[V, d_model] output embedding: the separate ``unembed`` when the
    model unties it, the input embedding otherwise."""
    return getattr(model, "unembed", model.embed)


def chunked_cross_entropy(x, embed, targets, chunk: int, softcap: float = 0.0):
    """Mean next-token NLL of hidden states x [B, N, d] against ``targets``
    [B, N] without keeping the [B, N, vocab] fp32 logits: each chunk of
    ``chunk`` positions computes its logits (final-softcapped with
    ``softcap``) under ``torch.utils.checkpoint``, so the backward
    recomputes them chunk by chunk.  N must divide by ``chunk``."""
    b, n, _ = x.shape
    if n % chunk:
        raise ValueError(f"seq len {n} not divisible by loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n, chunk):
        total = total + checkpoint(_chunk_nll, x[:, c0:c0 + chunk], embed,
                                   targets[:, c0:c0 + chunk], softcap,
                                   use_reentrant=False)
    return total / (b * n)


def _chunk_nll(x_c, embed, t_c, softcap=0.0):
    logits = softcapped(lm_logits(x_c, embed), softcap)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), t_c.flatten(), reduction="sum")


def loss_fn(model: Transformer, tokens, cfg: ModelConfig, *, dropout_seed=None):
    """Next-token cross entropy over tokens[:, :-1] → tokens[:, 1:]: the
    mean NLL from fp32 logits (final-softcapped).  ``tokens`` [B, N+1]
    integer ids on the model's device; ``dropout_seed`` as in
    :func:`forward_hidden`."""
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.loss_chunk:
        x = forward_hidden(model, inputs, cfg, dropout_seed=dropout_seed)
        return chunked_cross_entropy(x, unembed_matrix(model), targets,
                                     cfg.loss_chunk, cfg.final_softcap)
    logits = forward(model, inputs, cfg, dropout_seed=dropout_seed)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), targets.flatten())
