"""Checkpoint import, PyTorch port of ``flash_attention_dlrs_tpu/models/convert.py``.

HuggingFace Llama-family weights (Llama / Llama-2/3/3.1, Mistral, Qwen2,
TinyLlama ...), Gemma-1/2 and Phi-3 become the port's
:class:`~.transformer.Transformer` and :class:`~.transformer.ModelConfig`,
with the JAX converter's mapping, refusals and messages:

- RoPE conventions match (split-half rotate_half); ``rope_scaling`` of type
  linear, llama3 or yarn maps to ``ModelConfig.rope_scaling``, any other
  type raises;
- projections transpose from torch's [out, in] to the port's [in, out];
- Qwen2's QKV biases map to the optional ``bq`` / ``bk`` / ``bv``;
- Mistral's ``sliding_window`` maps to ``window`` (Qwen2's
  ``use_sliding_window`` gate and ``max_window_layers`` respected);
- an untied ``lm_head`` maps to ``unembed``; ``rms_norm_eps`` to
  ``norm_eps``;
- Gemma's (1 + w) norm gains are folded in at import, its sandwich norms
  map to ``post_attn_norm`` / ``post_mlp_norm``, and its GeGLU, embedding
  scale, softcaps, query scale and alternating window to the config;
- Phi-3's fused ``qkv_proj`` and ``gate_up_proj`` are split.

Inputs are a torch module (``.state_dict()`` and ``.config``) or a state
dict of tensors (or numpy arrays) with an explicit ``cfg``.  HF configs are
read by attribute only, so any object with the fields serves (a
``types.SimpleNamespace`` holding a published ``config.json``):
``transformers`` is never imported.  Tensors are converted in torch, on
whatever device they lie: each weight goes through float32 and is cast once
to the model's dtype, as the JAX converter casts its float32 numpy arrays.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .._cuda import resolve_device
from .transformer import ModelConfig, Transformer
from .weights import params_from_jax

_REQUIRED_KEYS = (
    "model.embed_tokens.weight",
    "model.norm.weight",
    "model.layers.0.self_attn.q_proj.weight",
)


def _f32(t) -> torch.Tensor:
    """A state-dict entry (torch tensor or numpy array) as float32."""
    return torch.as_tensor(t).detach().float()


def _rope_scaling_from_hf(c):
    """HF rope_scaling dict → ModelConfig.rope_scaling tuple (or None).
    Unsupported kinds raise — silently ignoring them would corrupt every
    position (Llama-3.1+ checkpoints ship rope_type='llama3')."""
    rs = getattr(c, "rope_scaling", None)
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in ("default", None):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return (
            "llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    if kind == "yarn":
        factor = float(rs["factor"])
        att = rs.get("attention_factor")
        mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")
        if att is None:
            def get_mscale(scale, m=1.0):
                return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

            if mscale and mscale_all:
                att = get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
            else:
                att = get_mscale(factor)
        orig = (rs.get("original_max_position_embeddings")
                or getattr(c, "max_position_embeddings"))
        return (
            "yarn", factor, float(rs.get("beta_fast") or 32),
            float(rs.get("beta_slow") or 1), float(orig), float(att),
        )
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not supported (have: linear, "
        "llama3, yarn) — importing while ignoring it would corrupt positions"
    )


def config_from_hf(hf_config, *, dtype=torch.bfloat16, **overrides) -> ModelConfig:
    """ModelConfig from a Llama / Mistral / Qwen2 / Phi-3 config (by
    attribute)."""
    c = hf_config
    head_dim = getattr(c, "head_dim", None) or (
        c.hidden_size // c.num_attention_heads
    )
    kw = dict(
        vocab_size=c.vocab_size,
        d_model=c.hidden_size,
        n_layers=c.num_hidden_layers,
        n_q_heads=c.num_attention_heads,
        n_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        head_dim=head_dim,
        d_ff=c.intermediate_size,
        rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        rope_scaling=_rope_scaling_from_hf(c),
        # Mistral's window keeps key j for query i iff i - j < window, the
        # port's convention; Qwen2 gates its window by use_sliding_window
        # and keeps the FIRST max_window_layers layers on full attention.
        window=int(
            (getattr(c, "sliding_window", None) or 0)
            if getattr(c, "use_sliding_window", True) else 0
        ),
        window_pattern=(
            f"from:{c.max_window_layers}"
            if (getattr(c, "use_sliding_window", False)
                and getattr(c, "sliding_window", None)
                and getattr(c, "max_window_layers", 0))
            else "all"
        ),
        norm_eps=float(getattr(c, "rms_norm_eps", 1e-6)),
        tie_embeddings=bool(getattr(c, "tie_word_embeddings", False)),
        position_encoding="rope",
        dtype=dtype,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def _state_and_cfg(model_or_state, cfg, dtype, make_cfg):
    """(state dict, cfg): a module gives both (its config through
    ``make_cfg`` unless ``cfg`` is passed); a bare state dict needs ``cfg``."""
    if hasattr(model_or_state, "state_dict"):
        state = dict(model_or_state.state_dict())
        if cfg is None:
            cfg = make_cfg(model_or_state.config, dtype=dtype)
    else:
        state = dict(model_or_state)
        if cfg is None:
            raise ValueError("cfg is required when importing a raw state_dict")
    return state, cfg


def import_hf_llama(
    model_or_state: Any,
    *,
    dtype=torch.bfloat16,
    cfg: Optional[ModelConfig] = None,
    device="cuda",
) -> Tuple[Transformer, ModelConfig]:
    """(model on ``device``, cfg) from a LlamaForCausalLM-style module or
    its ``state_dict()``.

    Pass ``cfg`` to skip config inference (required when handing a bare
    state_dict, whose hyperparameters are only partially recoverable)."""
    device = resolve_device(device)
    state, cfg = _state_and_cfg(model_or_state, cfg, dtype, config_from_hf)
    missing = [k for k in _REQUIRED_KEYS if k not in state]
    if missing:
        raise ValueError(
            f"not a Llama-family state dict (missing {missing}); expected "
            "model.embed_tokens / model.layers.N.self_attn.* / model.norm"
        )

    def w(name):  # [out, in] torch linear → [in, out] x @ W
        return _f32(state[name]).t()

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        if p + "self_attn.q_proj.weight" not in state:
            raise ValueError(
                f"cfg.n_layers={cfg.n_layers} but layer {i} is missing "
                "from the state dict"
            )
        layer = {
            "attn_norm": _f32(state[p + "input_layernorm.weight"]),
            "wq": w(p + "self_attn.q_proj.weight"),
            "wk": w(p + "self_attn.k_proj.weight"),
            "wv": w(p + "self_attn.v_proj.weight"),
            "wo": w(p + "self_attn.o_proj.weight"),
            "mlp_norm": _f32(state[p + "post_attention_layernorm.weight"]),
            "w_gate": w(p + "mlp.gate_proj.weight"),
            "w_up": w(p + "mlp.up_proj.weight"),
            "w_down": w(p + "mlp.down_proj.weight"),
        }
        if p + "self_attn.q_proj.bias" in state:  # Qwen2-style QKV biases
            for b, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
                layer[b] = _f32(state[p + f"self_attn.{proj}_proj.bias"])
        layers.append(layer)

    params = {
        "embed": _f32(state["model.embed_tokens.weight"]),
        "layers": layers,
        "final_norm": _f32(state["model.norm.weight"]),
    }
    if not cfg.tie_embeddings:
        head = state.get("lm_head.weight")
        if head is None:  # some exports drop the tied head tensor
            raise ValueError(
                "cfg.tie_embeddings=False but the state dict has no "
                "lm_head.weight"
            )
        params["unembed"] = _f32(head)  # [V, dm]
    return params_from_jax(params, cfg, device=device), cfg


# ---------------------------------------------------------------------------
# Gemma family
# ---------------------------------------------------------------------------

_GEMMA_REQUIRED = (
    "model.embed_tokens.weight",
    "model.layers.0.input_layernorm.weight",
)


def config_from_hf_gemma(hf_config, *, dtype=torch.bfloat16, **overrides) -> ModelConfig:
    """ModelConfig from a GemmaConfig / Gemma2Config (by attribute)."""
    c = hf_config
    is_g2 = bool(getattr(c, "attn_logit_softcapping", None))
    kw = dict(
        vocab_size=c.vocab_size,
        d_model=c.hidden_size,
        n_layers=c.num_hidden_layers,
        n_q_heads=c.num_attention_heads,
        n_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        head_dim=c.head_dim,
        d_ff=c.intermediate_size,
        rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        norm_eps=float(getattr(c, "rms_norm_eps", 1e-6)),
        tie_embeddings=True,  # every Gemma ties
        position_encoding="rope",
        mlp_act="gelu_tanh",
        embed_scale=True,
        # queries scale by query_pre_attn_scalar**-0.5, not head_dim**-0.5
        # (they differ on Gemma-2 9B / 27B)
        sm_scale=float(getattr(c, "query_pre_attn_scalar", c.head_dim)) ** -0.5,
        attn_softcap=float(getattr(c, "attn_logit_softcapping", 0) or 0),
        final_softcap=float(getattr(c, "final_logit_softcapping", 0) or 0),
        # Gemma-2 slides on EVEN layers (HF: is_sliding = not layer_idx % 2)
        window=int(getattr(c, "sliding_window", None) or 0) if is_g2 else 0,
        window_pattern="even" if is_g2 else "all",
        dtype=dtype,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def import_hf_gemma(
    model_or_state: Any,
    *,
    dtype=torch.bfloat16,
    cfg: Optional[ModelConfig] = None,
    device="cuda",
) -> Tuple[Transformer, ModelConfig]:
    """(model on ``device``, cfg) from a GemmaForCausalLM /
    Gemma2ForCausalLM (or its state_dict, with an explicit cfg).

    Beyond the Llama-family mapping: Gemma's RMSNorm multiplies by (1 + w),
    folded into the stored gains here so the runtime norm stays
    ``x·rsqrt(mean x²)·w``; Gemma-2's sandwich norms map to the optional
    ``post_attn_norm`` / ``post_mlp_norm`` (its post_attention_layernorm is
    a TRUE post-norm, unlike Llama's, whose same-named tensor is the MLP
    pre-norm)."""
    device = resolve_device(device)
    state, cfg = _state_and_cfg(model_or_state, cfg, dtype, config_from_hf_gemma)
    missing = [k for k in _GEMMA_REQUIRED if k not in state]
    if missing:
        raise ValueError(f"not a Gemma-family state dict (missing {missing})")

    def w(name):
        return _f32(state[name]).t()

    def gain(name):  # Gemma's (1 + w) folded in, fp32
        return 1.0 + _f32(state[name])

    sandwich = "model.layers.0.pre_feedforward_layernorm.weight" in state
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        if p + "self_attn.q_proj.weight" not in state:
            raise ValueError(f"cfg.n_layers={cfg.n_layers} but layer {i} is missing")
        layer = {
            "attn_norm": gain(p + "input_layernorm.weight"),
            "wq": w(p + "self_attn.q_proj.weight"),
            "wk": w(p + "self_attn.k_proj.weight"),
            "wv": w(p + "self_attn.v_proj.weight"),
            "wo": w(p + "self_attn.o_proj.weight"),
            "w_gate": w(p + "mlp.gate_proj.weight"),
            "w_up": w(p + "mlp.up_proj.weight"),
            "w_down": w(p + "mlp.down_proj.weight"),
        }
        if sandwich:  # Gemma-2
            layer["post_attn_norm"] = gain(p + "post_attention_layernorm.weight")
            layer["mlp_norm"] = gain(p + "pre_feedforward_layernorm.weight")
            layer["post_mlp_norm"] = gain(p + "post_feedforward_layernorm.weight")
        else:  # Gemma-1: Llama-shaped norm placement
            layer["mlp_norm"] = gain(p + "post_attention_layernorm.weight")
        layers.append(layer)

    params = {
        "embed": _f32(state["model.embed_tokens.weight"]),
        "layers": layers,
        "final_norm": gain("model.norm.weight"),
    }
    return params_from_jax(params, cfg, device=device), cfg


# ---------------------------------------------------------------------------
# Phi-3 family (fused projections; otherwise Llama-shaped)
# ---------------------------------------------------------------------------


def import_hf_phi3(
    model_or_state: Any,
    *,
    dtype=torch.bfloat16,
    cfg: Optional[ModelConfig] = None,
    device="cuda",
) -> Tuple[Transformer, ModelConfig]:
    """(model on ``device``, cfg) from a Phi3ForCausalLM (or state_dict +
    explicit cfg).

    Phi-3 is Llama-shaped except for FUSED projections — one ``qkv_proj``
    of [(Hq+2·Hkv)·dh, dm] rows ordered q|k|v, and one ``gate_up_proj`` of
    [2·d_ff, dm] rows ordered gate|up.  They are split into Llama-named
    tensors and :func:`import_hf_llama` does the rest."""
    device = resolve_device(device)
    state, cfg = _state_and_cfg(model_or_state, cfg, dtype, config_from_hf)
    if "model.layers.0.self_attn.qkv_proj.weight" not in state:
        raise ValueError(
            "not a Phi-3 state dict (no fused self_attn.qkv_proj); for "
            "split-projection checkpoints use import_hf_llama"
        )
    nq, nkv, dh = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        qkv = _f32(state.pop(p + "self_attn.qkv_proj.weight"))  # [rows, dm]
        if qkv.shape[0] != (nq + 2 * nkv) * dh:
            raise ValueError(
                f"layer {i} qkv_proj rows {qkv.shape[0]} != "
                f"(Hq + 2·Hkv)·dh = {(nq + 2 * nkv) * dh}"
            )
        state[p + "self_attn.q_proj.weight"] = qkv[: nq * dh]
        state[p + "self_attn.k_proj.weight"] = qkv[nq * dh: (nq + nkv) * dh]
        state[p + "self_attn.v_proj.weight"] = qkv[(nq + nkv) * dh:]
        gu = _f32(state.pop(p + "mlp.gate_up_proj.weight"))  # [2·dff, dm]
        state[p + "mlp.gate_proj.weight"] = gu[: cfg.d_ff]
        state[p + "mlp.up_proj.weight"] = gu[cfg.d_ff:]
    return import_hf_llama(state, dtype=dtype, cfg=cfg, device=device)


def load_trained(ckpt_dir: str, *, dtype=None, device="cuda") -> Tuple[Transformer, ModelConfig]:
    """(model, cfg) from a training run directory: ``model_config.json``
    (the architecture record, its ``dtype`` a torch dtype name such as
    ``"bfloat16"``) and the params-only checkpoint under
    ``<ckpt_dir>/params_only`` (``utils/checkpoint.py`` format, the state
    ``{"params": model.state_dict()}``).  ``dtype`` overrides the stored
    activation dtype (e.g. load a bf16-trained model for fp32 CPU eval)."""
    from ..utils import checkpoint as ckpt_lib

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, "model_config.json")) as f:
        rec = json.load(f)
    stored = rec.pop("dtype")
    rec["dtype"] = dtype if dtype is not None else getattr(torch, stored)
    cfg = ModelConfig(**rec)
    state, _ = ckpt_lib.restore_checkpoint(os.path.join(ckpt_dir, "params_only"))
    params: Dict[str, torch.Tensor] = state["params"]
    model = Transformer(cfg, device=device)
    model.load_state_dict(params)  # copies, casting to the model's dtypes
    return model, cfg
