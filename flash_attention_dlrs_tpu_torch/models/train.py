"""Training step, PyTorch port of ``flash_attention_dlrs_tpu/models/train.py``.

The JAX step is a pure function that donates its inputs and returns the new
(params, opt_state); here the model's parameters and the optimizer state are
updated IN PLACE and the step returns the loss.  The optimizer reproduces
``optax.adamw``: moments in the parameter dtype, weight decay on every
parameter (norms included), bias-corrected Adam with eps outside the square
root, and optax's ``clip_by_global_norm`` rule when asked.  Mesh sharding
and the blockwise-int8 AdamW (``optim.py``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from .transformer import ModelConfig, Transformer, loss_fn
from .weights import init_params_numpy, params_from_jax

_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 1 of the PyTorch port)"


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm, in place: when the global L2 norm of the
    gradients is at least ``max_norm`` each becomes (g / norm) · max_norm;
    below it they are left alone (torch's ``clip_grad_norm_`` would divide
    by norm + 1e-6 instead).  Returns the norm; no host synchronisation."""
    grads = list(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


@dataclasses.dataclass
class OptState:
    """The optimizer's state: the torch AdamW that holds the moments, and
    the update count that optax's schedules read."""

    adamw: torch.optim.AdamW
    count: int = 0

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
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
            clip_by_global_norm((p.grad for p in model.parameters()),
                                self.grad_clip_norm)
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
) -> Tuple[Transformer, OptState, AdamW]:
    """(model, opt_state, optimizer) on ``device``.  The weights are
    ``params`` (the JAX params layout with numpy leaves, e.g. carried across
    from the JAX package) or else :func:`init_params_numpy` of ``seed``: the
    port cannot reproduce ``jax.random``'s bits.  The optimizer is
    ``optax.adamw(learning_rate, weight_decay=0.01)``."""
    if mesh is not None:
        raise NotImplementedError(_NOT_YET.format("mesh-sharded training"))
    if optimizer_name == "adamw8bit":
        raise NotImplementedError(_NOT_YET.format("the adamw8bit optimizer"))
    if optimizer_name != "adamw":
        raise ValueError(f"unknown optimizer {optimizer_name!r}")
    tree = init_params_numpy(cfg, seed) if params is None else params
    model = params_from_jax(tree, cfg, device=device)
    optimizer = AdamW(learning_rate, weight_decay=0.01)
    return model, optimizer.init(model), optimizer


def make_train_step(cfg: ModelConfig, optimizer: AdamW, mesh=None):
    """``step(model, opt_state, tokens [B, N+1]) -> loss``: the loss and its
    gradients (:func:`~.transformer.loss_fn`), then one optimizer update.
    Unlike the JAX step, which is functional and donates its inputs, this
    one updates ``model`` and ``opt_state`` IN PLACE.  ``tokens`` lie on the
    model's device; the returned loss is a 0-d tensor there."""
    if mesh is not None:
        raise NotImplementedError(_NOT_YET.format("mesh-sharded training"))

    def step(model: Transformer, opt_state: OptState, tokens):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, cfg)
        loss.backward()
        optimizer.update(model, opt_state)
        return loss.detach()

    return step
