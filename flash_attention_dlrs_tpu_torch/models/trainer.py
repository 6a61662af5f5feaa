"""High-level training loop, PyTorch port of ``flash_attention_dlrs_tpu/models/trainer.py``.

Schedules, clipping, gradient accumulation and resume behind one
:func:`fit`, with the invariants of the JAX loop:

- **Determinism across restarts**: the checkpoint carries the model, the
  optimizer state, the loader cursor and the step; a resumed run consumes
  exactly the batches the uninterrupted run would have, and lands on the
  same weights bit for bit (the attention backward is deterministic).
- **Gradient accumulation**: microbatches run one after another into an
  fp32 running-mean gradient; one optimizer update per outer step.
- **Warmup + cosine schedule** and **global-norm clipping** with optax's
  formulas and rule.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .._cuda import resolve_device
from ..runtime.data import LoaderState
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics import MetricsLogger, ThroughputMeter
from ..ops.fwd_kernel import int32_seed
from .optim import AdamW8bit
from .train import (
    AdamW,
    OptState,
    _check_tp_divisibility,
    data_mean,
    data_shard,
    dropout_seed_of,
    make_train_step,
    shard_params,
)
from .transformer import ModelConfig, Transformer, loss_fn
from .weights import init_params_numpy, params_from_jax


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Optimization hyperparameters for :func:`fit` / :func:`make_optimizer`."""

    learning_rate: float = 3e-4
    warmup_steps: int = 0
    # Cosine decay horizon (optimizer steps).  None = constant after warmup.
    total_steps: Optional[int] = None
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.01
    grad_clip_norm: float = 0.0  # global-norm clip; 0 = off
    accum_steps: int = 1  # microbatches averaged per optimizer step
    optimizer: str = "adamw"  # or "adamw8bit" (blockwise-int8 moments)

    def __post_init__(self):
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")
        if self.optimizer not in ("adamw", "adamw8bit"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule."""
    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i + 1 runs from boundary i on, fed the
    count past its boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out
    return schedule


def lr_schedule(spec: TrainSpec) -> Callable[[int], float]:
    """Linear warmup → cosine decay to min_lr_ratio (constant when
    total_steps is None), as the JAX package composes optax's schedules:
    with warmup the cosine's horizon is total_steps − warmup_steps."""
    peak = spec.learning_rate
    if spec.total_steps is None:
        if not spec.warmup_steps:
            return lambda count: peak
        return _join([_linear(0.0, peak, spec.warmup_steps), lambda count: peak],
                     [spec.warmup_steps])
    if spec.warmup_steps:
        end = peak * spec.min_lr_ratio
        alpha = 0.0 if peak == 0.0 else end / peak
        return _join([_linear(0.0, peak, spec.warmup_steps),
                      _cosine(peak, spec.total_steps - spec.warmup_steps, alpha)],
                     [spec.warmup_steps])
    return _cosine(peak, max(1, spec.total_steps - spec.warmup_steps),
                   spec.min_lr_ratio)


def make_optimizer(spec: TrainSpec) -> Union[AdamW, AdamW8bit]:
    """AdamW, or the blockwise-int8 AdamW for ``spec.optimizer ==
    "adamw8bit"``, on :func:`lr_schedule`, after global-norm clipping when
    ``spec.grad_clip_norm`` is set."""
    optimizer = AdamW8bit if spec.optimizer == "adamw8bit" else AdamW
    return optimizer(lr_schedule(spec), weight_decay=spec.weight_decay,
                     grad_clip_norm=spec.grad_clip_norm)


def make_accum_train_step(cfg: ModelConfig, optimizer: Union[AdamW, AdamW8bit], mesh=None, *,
                          accum_steps: int, data_axis: str = "data"):
    """``step(model, opt_state, tokens [A·b, N+1], dropout_seed=None) ->
    loss``: the batch is split into ``accum_steps`` microbatches of
    consecutive rows, their gradients are averaged into an fp32 running mean
    (each g / A added in turn, as the JAX scan does), then ONE optimizer
    update, in place.  Microbatch i draws its dropout from the sub-seed
    seed + 7368787·i in int32 wrap-around, as the JAX step does.  Peak
    memory is one microbatch's activations plus the fp32 mean.  With a
    ``mesh`` every rank takes the same GLOBAL ``tokens`` and trains on its
    rows of each microbatch; the fp32 mean is averaged over the data axis
    before the update."""
    if mesh is not None:
        _check_tp_divisibility(cfg, mesh)

    def step(model: Transformer, opt_state: OptState, tokens, dropout_seed=None):
        seed = dropout_seed_of(cfg, dropout_seed)
        b_total, n = tokens.shape
        if b_total % accum_steps:
            raise ValueError(
                f"batch {b_total} must divide by accum_steps {accum_steps}")
        params = list(model.parameters())
        mean = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss_mean = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i, micro in enumerate(tokens.reshape(accum_steps, b_total // accum_steps, n)):
            model.zero_grad(set_to_none=True)
            sub = None if seed is None else int32_seed(seed + 7368787 * i)
            loss = loss_fn(model, data_shard(micro, mesh, data_axis), cfg, dropout_seed=sub)
            loss.backward()
            for m, p in zip(mean, params):
                m.add_(p.grad / accum_steps)
            loss_mean += loss.detach() / accum_steps
        loss_mean = data_mean(mean, loss_mean, mesh, data_axis)
        for m, p in zip(mean, params):
            p.grad = m.to(p.dtype)
        optimizer.update(model, opt_state)
        return loss_mean

    return step


def _checkpoint_state(model, opt_state, loader_state, step) -> Dict:
    cursor = [0, 0] if loader_state is None else [loader_state.epoch,
                                                  loader_state.index]
    return {"params": model.state_dict(), "opt_state": opt_state.state_dict(),
            "loader_cursor": cursor, "step": step}


def fit(
    cfg: ModelConfig,
    batches,  # iterator of (tokens [B, N+1], state), or callable(state)->iterator
    *,
    spec: TrainSpec = TrainSpec(),
    steps: int,
    mesh=None,
    seed: int = 0,
    params: Optional[Dict] = None,
    device="cuda",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,  # 0 = only at the end (if dir given)
    metrics_path: Optional[str] = None,
    log_every: int = 10,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Dict:
    """Train for ``steps`` optimizer steps; returns the final state dict
    ``{"model", "opt_state", "step", "loader_state"}``.

    The initial weights are ``params`` (the JAX params layout, numpy
    leaves) or :func:`init_params_numpy` of ``seed``.  The JAX ``fit`` draws
    them from ``jax.random.PRNGKey(seed)``, whose bits the port cannot
    reproduce, so the two loops agree step for step only from weights
    carried across with ``params``.

    ``batches`` is any iterator yielding (tokens, resumable_state) — the
    contract of ``runtime.data.batches`` — or a CALLABLE
    ``lambda state: iterator`` so a resumed run can rebuild the stream from
    the checkpointed cursor.  With ``checkpoint_dir`` set, an existing
    checkpoint resumes the step, the weights, the optimizer moments and
    (for a callable ``batches``) the data cursor.  With ``cfg.attn_dropout``
    step i draws its dropout masks from seed i, so a resumed run stays
    bitwise equal to the uninterrupted one.

    With a ``mesh`` every rank of it calls ``fit`` with the same arguments
    and the same batches: each trains its slice of the model
    (``train.shard_params``) on its rows of every batch, and checkpoints its
    own shard under ``checkpoint_dir/rank<r>``."""
    device = resolve_device(device)
    optimizer = make_optimizer(spec)
    tree = init_params_numpy(cfg, seed) if params is None else params
    if mesh is not None:
        _check_tp_divisibility(cfg, mesh)
        tree = shard_params(tree, mesh, n_kv_heads=cfg.n_kv_heads)
        if checkpoint_dir is not None and mesh.devices.size > 1:
            checkpoint_dir = os.path.join(checkpoint_dir, f"rank{mesh.rank}")
    model = params_from_jax(tree, cfg, device=device, mesh=mesh)
    opt_state = optimizer.init(model)
    start_step = 0
    loader_state = None

    if checkpoint_dir is not None and ckpt_lib.latest_step(checkpoint_dir) is not None:
        restored, _ = ckpt_lib.restore_checkpoint(checkpoint_dir)
        model.load_state_dict(restored["params"])
        opt_state.load_state_dict(restored["opt_state"])
        epoch, index = restored["loader_cursor"]
        loader_state = LoaderState(epoch=int(epoch), index=int(index))
        start_step = int(restored["step"])

    if callable(batches) and not hasattr(batches, "__next__"):
        batches = batches(loader_state)

    if spec.accum_steps > 1:
        step_fn = make_accum_train_step(cfg, optimizer, mesh, accum_steps=spec.accum_steps)
    else:
        step_fn = make_train_step(cfg, optimizer, mesh)

    logger = MetricsLogger(metrics_path) if metrics_path else None
    meter = ThroughputMeter()
    for step in range(start_step, steps):
        tokens, loader_state = next(batches)
        tokens = torch.from_numpy(np.asarray(tokens)).to(device)
        loss = step_fn(model, opt_state, tokens, step if cfg.attn_dropout else None)
        meter.update(int(tokens.numel()))
        if logger and (step % log_every == 0 or step == steps - 1):
            logger.log(step, loss=float(loss), tokens_per_s=meter.rate)
        if on_step is not None:
            on_step(step, loss)
        if checkpoint_dir and checkpoint_every and (step + 1) % checkpoint_every == 0:
            ckpt_lib.save_checkpoint(
                checkpoint_dir,
                _checkpoint_state(model, opt_state, loader_state, step + 1),
                step=step + 1)
    if checkpoint_dir:
        ckpt_lib.save_checkpoint(
            checkpoint_dir, _checkpoint_state(model, opt_state, loader_state, steps),
            step=steps)
    if logger:
        logger.close()
    return {"model": model, "opt_state": opt_state, "step": steps,
            "loader_state": loader_state}
