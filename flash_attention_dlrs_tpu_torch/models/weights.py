"""Weights for the port's model, from the JAX package's params or from a seed.

:func:`params_from_jax` takes the JAX package's params dict
(``models/transformer.py::init_params`` layout) with numpy arrays as leaves —
convert with ``jax.tree.map(numpy.asarray, params)`` on the JAX side — and
returns the port's :class:`~.transformer.Transformer` on a named device;
:func:`params_to_numpy` is its inverse, for weights and for gradients.
:func:`init_params_numpy` builds a dict of that layout with numpy alone, so
weights can be made from a seed where JAX is absent.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .transformer import ModelConfig, Transformer

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def init_params_numpy(cfg: ModelConfig, seed: int) -> Dict:
    """Random fp32 weights in the JAX params layout, made with numpy from
    ``seed``: the JAX package's init scheme (normal·din^-0.5 projections,
    normal·0.02 embedding, unit norms), not its random bits."""
    rng = np.random.default_rng(seed)
    dm, dh = cfg.d_model, cfg.head_dim
    nq, nkv, dff = cfg.n_q_heads, cfg.n_kv_heads, cfg.d_ff

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(scale)
        return x

    def dense(din, dout):
        return normal((din, dout), din ** -0.5)

    def layer():
        return {
            "attn_norm": np.ones((dm,), np.float32),
            "wq": dense(dm, nq * dh),
            "wk": dense(dm, nkv * dh),
            "wv": dense(dm, nkv * dh),
            "wo": dense(nq * dh, dm),
            "mlp_norm": np.ones((dm,), np.float32),
            "w_gate": dense(dm, dff),
            "w_up": dense(dm, dff),
            "w_down": dense(dff, dm),
        }

    params = {
        "embed": normal((cfg.vocab_size, dm), 0.02),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": np.ones((dm,), np.float32),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab_size, dm), dm ** -0.5)
    return params


def _to_tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # arrays read out of JAX are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from JAX: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _load(param: torch.nn.Parameter, array, name: str) -> None:
    t = _to_tensor(array)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} does not match the config's "
            f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The port's model on ``device`` with the weights of ``tree`` (the JAX
    params layout, numpy leaves), cast to ``cfg.dtype`` (norms stay fp32)."""
    expected = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    extra = set(tree) - expected
    for layer in tree.get("layers", []):
        extra |= set(layer) - set(_LAYER_KEYS)
    if extra:
        raise NotImplementedError(
            f"params {sorted(extra)} are not ported yet (ROADMAP.md, queue 1 "
            "of the PyTorch port)")
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(
            f"params have {len(tree['layers'])} layers, config {cfg.n_layers}")
    model = Transformer(cfg, device=device)
    _load(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _load(model.unembed, tree["unembed"], "unembed")
    for i, (block, layer) in enumerate(zip(model.layers, tree["layers"])):
        for key in _LAYER_KEYS:
            _load(getattr(block, key), layer[key], f"layers[{i}].{key}")
    return model


def params_to_numpy(
    source: Union[Transformer, Mapping[str, torch.Tensor]],
) -> Dict:
    """The JAX params layout with numpy leaves, from the port's model or
    from a mapping of its parameter names (``model.named_parameters()``
    names, e.g. ``"layers.0.wq"``) to tensors — such as the gradients
    ``{name: p.grad}``.  The inverse of :func:`params_from_jax`; bf16 leaves
    come out as float32 (numpy has no bfloat16), which holds their values
    exactly."""
    if isinstance(source, torch.nn.Module):
        source = dict(source.named_parameters())

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    tree = {"layers": []}
    for name, t in source.items():
        parts = name.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = leaf(t)
        else:
            tree[name] = leaf(t)
    return tree
