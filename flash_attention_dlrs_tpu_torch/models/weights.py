"""Weights for the port's model, from the JAX package's params or from a seed.

:func:`params_from_jax` takes the JAX package's params dict
(``models/transformer.py::init_params`` layout) with numpy arrays as leaves —
convert with ``jax.tree.map(numpy.asarray, params)`` on the JAX side — and
returns the port's :class:`~.transformer.Transformer` on a named device;
:func:`params_to_numpy` is its inverse, for weights and for gradients.
:func:`init_params_numpy` builds a dict of that layout with numpy alone, so
weights can be made from a seed where JAX is absent.  The optional layer
keys (QKV biases ``bq`` / ``bk`` / ``bv``, the sandwich norms
``post_attn_norm`` / ``post_mlp_norm``) and weight-only int8 projections
(leaves with ``values`` and ``scales``, as the JAX package's
``QuantizedTensor``) go across both ways.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ..ops.quantization import QuantizedTensor
from .transformer import (
    BIASES, PROJECTIONS, SANDWICH_NORMS, ModelConfig, QuantizedWeight, Transformer,
)

_LAYER_KEYS = ("attn_norm", "mlp_norm") + PROJECTIONS
_OPTIONAL_KEYS = BIASES + SANDWICH_NORMS


def init_params_numpy(cfg: ModelConfig, seed: int, extras=()) -> Dict:
    """Random fp32 weights in the JAX params layout, made with numpy from
    ``seed``: the JAX package's init scheme (normal·din^-0.5 projections,
    normal·0.02 embedding, unit norms), not its random bits.  ``extras``
    adds optional layer keys: biases normal·0.02, sandwich norms 1 +
    normal·0.1 (drawn after the layer's other weights)."""
    rng = np.random.default_rng(seed)
    dm, dh = cfg.d_model, cfg.head_dim
    nq, nkv, dff = cfg.n_q_heads, cfg.n_kv_heads, cfg.d_ff

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(scale)
        return x

    def dense(din, dout):
        return normal((din, dout), din ** -0.5)

    widths = {"bq": nq * dh, "bk": nkv * dh, "bv": nkv * dh}

    def layer():
        out = {
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
        for key in extras:
            if key in widths:
                out[key] = normal((widths[key],), 0.02)
            elif key in SANDWICH_NORMS:
                out[key] = 1.0 + normal((dm,), 0.1)
            else:
                raise ValueError(f"unknown optional layer key {key!r}")
        return out

    params = {
        "embed": normal((cfg.vocab_size, dm), 0.02),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": np.ones((dm,), np.float32),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab_size, dm), dm ** -0.5)
    return params


def _to_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):  # the HF converter's leaves (models/convert.py)
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # arrays read out of JAX are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from JAX: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _quantized(leaf) -> bool:
    """A weight-only int8 leaf: the JAX package's ``QuantizedTensor`` (with
    numpy leaves) or the port's."""
    return hasattr(leaf, "values") and hasattr(leaf, "scales")


def _load(param, array, name: str) -> None:
    if isinstance(param, QuantizedWeight):
        if not _quantized(array):
            raise ValueError(f"{name}: expected a quantized (values, scales) leaf")
        _load(param.values, array.values, name + ".values")
        _load(param.scales, array.scales, name + ".scales")
        return
    t = _to_tensor(array)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} does not match the config's "
            f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device="cuda", mesh=None,
                    model_axis: str = "model") -> Transformer:
    """The port's model on ``device`` with the weights of ``tree`` (the JAX
    params layout, numpy leaves), cast to ``cfg.dtype`` (norms stay fp32).
    Every layer must carry the same optional keys; int8 projections (every
    one of a layer, as ``quantize_params`` makes them) stay int8.  With a
    ``mesh``, ``tree`` is this rank's slice (``train.shard_params``) and the
    model is tensor-parallel over ``model_axis``."""
    expected = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    unknown = set(tree) - expected
    layers = tree.get("layers", [])
    for layer in layers:
        unknown |= set(layer) - set(_LAYER_KEYS) - set(_OPTIONAL_KEYS)
    if unknown:
        raise ValueError(f"params {sorted(unknown)} are not parameters of the model")
    if len(layers) != cfg.n_layers:
        raise ValueError(
            f"params have {len(layers)} layers, config {cfg.n_layers}")
    extras = tuple(k for k in _OPTIONAL_KEYS if layers and k in layers[0])
    quantized = bool(layers) and _quantized(layers[0]["wq"])
    for i, layer in enumerate(layers):
        if tuple(k for k in _OPTIONAL_KEYS if k in layer) != extras:
            raise ValueError(f"layers[{i}] has other optional keys than layers[0] {extras}")
        if any(_quantized(layer[k]) != quantized for k in PROJECTIONS):
            raise ValueError(f"layers[{i}]: projections must be all int8 or none")
    model = Transformer(cfg, device=device, extras=extras, quantized=quantized, mesh=mesh,
                        model_axis=model_axis)
    _load(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _load(model.unembed, tree["unembed"], "unembed")
    for i, (block, layer) in enumerate(zip(model.layers, layers)):
        for key in _LAYER_KEYS + extras:
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
    exactly.  An int8 projection of the model comes out as a
    :class:`~..ops.quantization.QuantizedTensor` of numpy arrays."""
    if isinstance(source, torch.nn.Module):
        source = {**dict(source.named_parameters()), **dict(source.named_buffers())}

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
            if len(parts) == 4:  # an int8 projection's values or scales
                q = tree["layers"][i].setdefault(parts[2], QuantizedTensor(None, None))
                setattr(q, parts[3], leaf(t))
            else:
                tree["layers"][i][parts[2]] = leaf(t)
        else:
            tree[name] = leaf(t)
    return tree
