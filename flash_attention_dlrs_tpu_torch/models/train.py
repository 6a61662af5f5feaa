"""Training step, PyTorch port of ``flash_attention_dlrs_tpu/models/train.py``.

The JAX step is a pure function that donates its inputs and returns the new
(params, opt_state); here the model's parameters and the optimizer state are
updated IN PLACE and the step returns the loss.  The optimizer reproduces
``optax.adamw``: moments in the parameter dtype, weight decay on every
parameter (norms included), bias-corrected Adam with eps outside the square
root, and optax's ``clip_by_global_norm`` rule when asked; or the JAX
package's blockwise-int8 AdamW (:mod:`.optim`).

On a mesh (dp × tp, :class:`..parallel.mesh.Mesh`) every rank runs the same
step on its shard: its slice of the parameters (:func:`param_shardings`:
heads and MLP width on the model axis, as the JAX package shards them) and
its rows of the global batch (the data axis).  The loss is the global mean
and the gradients are averaged over the data axis before the update; the
tensor-parallel collectives run inside the model
(:mod:`.transformer`).  The blockwise-int8 moments quantize each rank's
shard in blocks of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from ..parallel.launch import all_reduce
from .optim import Adam8State, AdamW8bit
from .transformer import BIASES, PROJECTIONS, ModelConfig, Transformer, loss_fn
from .weights import init_params_numpy, params_from_jax


def param_shardings(params: Dict, mesh, model_axis: str = "model",
                    n_kv_heads: Optional[int] = None) -> Dict:
    """Per-parameter placements of the JAX params layout ``params`` (the
    JAX package's ``param_shardings``): a tree of the same shape whose
    leaves are tuples with one mesh axis name or None per dim (a
    ``PartitionSpec``'s entries): head and MLP-width dims on the model axis,
    everything else replicated.  When the model axis does not divide
    ``n_kv_heads``, wk / wv / bk / bv are replicated."""
    m_size = mesh.shape.get(model_axis, 1)
    kv_ok = n_kv_heads is None or n_kv_heads % m_size == 0
    m = model_axis
    kv = m if kv_ok else None

    def spec_for_layer(layer):
        spec = {"attn_norm": (None,), "wq": (None, m), "wk": (None, kv), "wv": (None, kv),
                "wo": (m, None), "mlp_norm": (None,), "w_gate": (None, m),
                "w_up": (None, m), "w_down": (m, None)}
        if "bq" in layer:  # Qwen2-style QKV biases follow their projections
            spec.update(bq=(m,), bk=(kv,), bv=(kv,))
        for nm in ("post_attn_norm", "post_mlp_norm"):  # Gemma-2 sandwich
            if nm in layer:
                spec[nm] = (None,)
        return spec

    specs = {"embed": (None, None), "layers": [spec_for_layer(l) for l in params["layers"]],
             "final_norm": (None,)}
    if "unembed" in params:  # untied output embedding
        specs["unembed"] = (None, None)
    return specs


# The parameters param_shardings splits over the model axis (the kv ones
# only where the axis divides n_kv_heads, which every mesh entry point
# checks first).
SPLIT_PARAMS = frozenset(PROJECTIONS + BIASES)


def _take(a, spec, mesh):
    for dim, axis in enumerate(spec):
        n = mesh.size(axis)
        if n > 1:
            size = a.shape[dim] // n
            a = a.take(range(mesh.index(axis) * size, (mesh.index(axis) + 1) * size), axis=dim)
    return a


def shard_params(params: Dict, mesh, model_axis: str = "model",
                 n_kv_heads: Optional[int] = None) -> Dict:
    """This rank's slice of the JAX params layout ``params`` (numpy
    leaves) under :func:`param_shardings`.  A weight-only int8 leaf's
    per-column scales follow their columns."""
    specs = param_shardings(params, mesh, model_axis, n_kv_heads)

    def leaf(a, spec):
        if hasattr(a, "values") and hasattr(a, "scales"):
            return type(a)(_take(a.values, spec, mesh), _take(a.scales, (None, spec[1]), mesh))
        return _take(a, spec, mesh)

    out = {k: leaf(params[k], specs[k]) for k in params if k != "layers"}
    out["layers"] = [{k: leaf(layer[k], spec[k]) for k in layer}
                     for layer, spec in zip(params["layers"], specs["layers"])]
    return out


def _check_tp_divisibility(cfg: ModelConfig, mesh, model_axis: str = "model") -> None:
    """Tensor parallelism requires the model-axis size to divide BOTH head
    counts (the JAX package's rule and message)."""
    m = mesh.shape.get(model_axis, 1)
    if cfg.n_q_heads % m or cfg.n_kv_heads % m:
        raise ValueError(
            f"model axis size {m} must divide n_q_heads={cfg.n_q_heads} AND "
            f"n_kv_heads={cfg.n_kv_heads} for tensor-parallel training — "
            "pick a mesh whose model axis divides both (put the remaining "
            "devices on the data axis)"
        )


def _split(model: Transformer):
    """Whether each parameter of ``model`` is split over its model axis
    (its squares then sum over the axis in a global norm); None when the
    model is not tensor-parallel."""
    tp = getattr(model, "tp", None)  # any module the optimizers take
    if tp is None or tp.size == 1:
        return None
    return [name.split(".")[-1] in SPLIT_PARAMS for name, _ in model.named_parameters()]


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float, model=None):
    """optax.clip_by_global_norm, in place: when the global L2 norm of the
    gradients is at least ``max_norm`` each becomes (g / norm) · max_norm;
    below it they are left alone (torch's ``clip_grad_norm_`` would divide
    by norm + 1e-6 instead).  Returns the norm; no host synchronisation.
    With a tensor-parallel ``model`` (``grads`` its parameters' in order),
    the squares of the split parameters are summed over the model axis, so
    that the norm is the whole model's."""
    grads = list(grads)
    split = _split(model) if model is not None else None
    if split is None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    else:
        part = sum((g.float() ** 2).sum() for g, s in zip(grads, split) if s)
        whole = sum((g.float() ** 2).sum() for g, s in zip(grads, split) if not s)
        norm = torch.sqrt(all_reduce(part, model.tp.mesh, model.tp.model_axis) + whole)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


@dataclasses.dataclass
class OptState:
    """The optimizer's state: the moments, held by the torch AdamW
    (:class:`AdamW`) or as blockwise int8 (:class:`.optim.AdamW8bit`), and
    the update count that optax's schedules read."""

    adamw: Optional[torch.optim.AdamW] = None
    count: int = 0
    adam8: Optional[Adam8State] = None

    def state_dict(self) -> Dict:
        state = {"count": self.count}
        if self.adamw is not None:
            state["adamw"] = self.adamw.state_dict()
        if self.adam8 is not None:
            state["adam8"] = self.adam8.state_dict()
        return state

    def load_state_dict(self, state: Dict) -> None:
        if self.adamw is not None:
            self.adamw.load_state_dict(state["adamw"])
        if self.adam8 is not None:
            self.adam8.load_state_dict(state["adam8"])
        self.count = int(state["count"])


class AdamW:
    """``optax.adamw(learning_rate, weight_decay)`` (b1 0.9, b2 0.999,
    eps 1e-8), optionally chained after ``optax.clip_by_global_norm``.
    ``learning_rate`` is a float or a schedule ``count -> lr``, evaluated at
    the number of updates made so far, as optax does.  :meth:`update` reads
    each parameter's ``.grad`` and updates the parameters in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]], *,
                 weight_decay: float = 0.01, grad_clip_norm: float = 0.0):
        if callable(learning_rate):
            self.schedule = learning_rate
        else:
            self.schedule = lambda count: learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm

    def init(self, model: Transformer) -> OptState:
        return OptState(torch.optim.AdamW(
            model.parameters(), lr=float(self.schedule(0)), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.weight_decay))

    def update(self, model: Transformer, state: OptState) -> None:
        if self.grad_clip_norm:
            clip_by_global_norm([p.grad for p in model.parameters()],
                                self.grad_clip_norm, model)
        lr = float(self.schedule(state.count))
        for group in state.adamw.param_groups:
            group["lr"] = lr
        state.adamw.step()
        state.count += 1


def make_train_state(
    cfg: ModelConfig,
    mesh=None,
    *,
    seed: int = 0,
    params: Optional[Dict] = None,
    device="cuda",
    learning_rate: float = 3e-4,
    optimizer_name: str = "adamw",
) -> Tuple[Transformer, OptState, Union[AdamW, AdamW8bit]]:
    """(model, opt_state, optimizer) on ``device``.  The weights are
    ``params`` (the JAX params layout with numpy leaves, e.g. carried across
    from the JAX package) or else :func:`init_params_numpy` of ``seed``: the
    port cannot reproduce ``jax.random``'s bits.  ``optimizer_name``:
    "adamw" (``optax.adamw(learning_rate, weight_decay=0.01)``, moments in
    the parameter dtype) or "adamw8bit" (blockwise-int8 moments,
    :class:`.optim.AdamW8bit`, weight decay 0.01).  With a ``mesh`` (every
    rank calls this with the same arguments) the model is this rank's slice
    (:func:`shard_params`)."""
    if mesh is not None:
        _check_tp_divisibility(cfg, mesh)
    if optimizer_name == "adamw":
        optimizer = AdamW(learning_rate, weight_decay=0.01)
    elif optimizer_name == "adamw8bit":
        optimizer = AdamW8bit(learning_rate, weight_decay=0.01)
    else:
        raise ValueError(f"unknown optimizer {optimizer_name!r}")
    tree = init_params_numpy(cfg, seed) if params is None else params
    if mesh is not None:
        tree = shard_params(tree, mesh, n_kv_heads=cfg.n_kv_heads)
    model = params_from_jax(tree, cfg, device=device, mesh=mesh)
    return model, optimizer.init(model), optimizer


def dropout_seed_of(cfg: ModelConfig, dropout_seed):
    """The step's dropout seed: required (an int, e.g. the step index) when
    ``cfg.attn_dropout``, ignored otherwise."""
    if not cfg.attn_dropout:
        return None
    if dropout_seed is None:
        raise ValueError(
            "cfg.attn_dropout > 0: the train step takes a 4th argument, the "
            "int dropout_seed (pass the step index)")
    return int(dropout_seed)


def data_shard(tokens, mesh, data_axis: str = "data"):
    """This rank's rows of the global batch ``tokens`` [B, ...] (all of
    them without a mesh)."""
    n = 1 if mesh is None else mesh.size(data_axis)
    if n == 1:
        return tokens
    if tokens.shape[0] % n:
        raise ValueError(f"batch {tokens.shape[0]} does not split over {data_axis} ({n})")
    rows = tokens.shape[0] // n
    return tokens[mesh.index(data_axis) * rows:(mesh.index(data_axis) + 1) * rows]


def data_mean(grads, loss, mesh, data_axis: str = "data"):
    """The global-batch mean from each data rank's mean: ``loss`` and the
    tensors ``grads`` (in place, one all-reduce per dtype) averaged over the
    data axis; returns the mean loss."""
    n = 1 if mesh is None else mesh.size(data_axis)
    if n == 1:
        return loss
    grads = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in same]), mesh, data_axis) * (1.0 / n)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))
    return all_reduce(loss.float(), mesh, data_axis) * (1.0 / n)


def grads_of(model: Transformer):
    """Every parameter's gradient (zeros where one got none)."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in model.parameters()]


def make_train_step(cfg: ModelConfig, optimizer: Union[AdamW, AdamW8bit], mesh=None, *,
                    data_axis: str = "data"):
    """``step(model, opt_state, tokens [B, N+1], dropout_seed=None) ->
    loss``: the loss and its gradients (:func:`~.transformer.loss_fn`), then
    one optimizer update.  With ``cfg.attn_dropout`` the step needs the
    ``dropout_seed`` (pass the step index): the masks are a pure function of
    it, so training stays bitwise reproducible.  Unlike the JAX step, which
    is functional and donates its inputs, this one updates ``model`` and
    ``opt_state`` IN PLACE.  ``tokens`` lie on the model's device; the
    returned loss is a 0-d tensor there.  With a ``mesh`` every rank calls
    the step with the same GLOBAL ``tokens`` and its own slice of the model
    (:func:`make_train_state`); it trains on its rows of the batch
    (:func:`data_shard`) and returns the global mean loss."""
    if mesh is not None:
        _check_tp_divisibility(cfg, mesh)

    def step(model: Transformer, opt_state: OptState, tokens, dropout_seed=None):
        seed = dropout_seed_of(cfg, dropout_seed)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, data_shard(tokens, mesh, data_axis), cfg, dropout_seed=seed)
        loss.backward()
        loss = data_mean(grads_of(model), loss.detach(), mesh, data_axis)
        optimizer.update(model, opt_state)
        return loss

    return step
