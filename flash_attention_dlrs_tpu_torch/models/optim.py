"""Blockwise 8-bit AdamW, PyTorch port of ``flash_attention_dlrs_tpu/models/optim.py``.

Both Adam moments are stored int8, one fp32 absmax scale per block of
:data:`BLOCK` elements of the flattened (zero-padded) parameter; the second
moment is stored as √ν, not ν.  The update rule is the JAX package's op for
op: fp32 math in [n_blocks, BLOCK] layout, round half to even into int8 by
absmax/127 scales (a block whose scale is 0 keeps 0), then decayed weights
and the learning rate in the order ``optax.chain`` applies them.  The JAX
package computes it with ``jnp`` outside any Pallas kernel; here it is plain
PyTorch ops on the parameters' device.  Unlike optax's functional state,
the moments are updated in place.

At 2 bytes a parameter and 8 bytes a block (:func:`moment_bytes`) the
moments take about half of AdamW's 4 bytes a parameter (bf16 moments).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Sequence, Tuple, Union

import torch

BLOCK = 256
# blocks of one leaf updated at a time (2^18 blocks: 256 MB a fp32 temporary)
CHUNK_BLOCKS = 1 << 18


def _n_blocks(p: torch.Tensor) -> int:
    return -(-p.numel() // BLOCK)


@dataclasses.dataclass
class Adam8State:
    """The moments of :func:`scale_by_adam8`, one entry per parameter:
    ``mu_q`` / ``su_q`` [n_blocks, BLOCK] int8 payloads of the first moment
    and of √ν, ``mu_scale`` / ``su_scale`` [n_blocks, 1] fp32 absmax scales,
    and the update count."""

    count: int
    mu_q: List[torch.Tensor]
    mu_scale: List[torch.Tensor]
    su_q: List[torch.Tensor]
    su_scale: List[torch.Tensor]

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu_q": list(self.mu_q),
                "mu_scale": list(self.mu_scale), "su_q": list(self.su_q),
                "su_scale": list(self.su_scale)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for name in ("mu_q", "mu_scale", "su_q", "su_scale"):
            for dst, src in zip(getattr(self, name), state[name], strict=True):
                dst.copy_(src)


class ScaleByAdam8:
    """``optax.scale_by_adam`` with int8 blockwise moment storage, over a
    list of parameters: :meth:`init` makes the zero state,
    :meth:`update` turns gradients into Adam steps and updates the state in
    place."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Iterable[torch.Tensor]) -> Adam8State:
        params = list(params)

        def zeros(dtype, width):
            return [torch.zeros((_n_blocks(p), width), dtype=dtype, device=p.device)
                    for p in params]

        return Adam8State(0, zeros(torch.int8, BLOCK), zeros(torch.float32, 1),
                          zeros(torch.int8, BLOCK), zeros(torch.float32, 1))

    def update(self, grads: Sequence[torch.Tensor], state: Adam8State) -> List[torch.Tensor]:
        """The steps (mu / c1) / (√(ν / c2) + eps), each in its gradient's
        shape and dtype; the state's payloads, scales and count move on.
        Blocks are independent, so each leaf is taken :data:`CHUNK_BLOCKS`
        blocks at a time: the fp32 temporaries stay a few hundred MB whatever
        the leaf's size (a 256000 x 2304 embedding would need 2.4 GB each)."""
        b1, b2 = self.b1, self.b2
        state.count += 1
        count = torch.tensor(float(state.count), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
        inv = 1.0 / 127.0
        steps = []
        for i, g in enumerate(grads):
            flat = g.reshape(-1)
            step = torch.empty_like(flat)
            for r0 in range(0, state.mu_q[i].shape[0], CHUNK_BLOCKS):
                rows = slice(r0, r0 + CHUNK_BLOCKS)
                e0, e1 = r0 * BLOCK, min(flat.numel(), (r0 + CHUNK_BLOCKS) * BLOCK)
                gc = flat[e0:e1].float()
                pad = (-gc.numel()) % BLOCK
                if pad:
                    gc = torch.nn.functional.pad(gc, (0, pad))
                gb = gc.reshape(-1, BLOCK)
                mq, ms = state.mu_q[i][rows], state.mu_scale[i][rows]
                sq, ss = state.su_q[i][rows], state.su_scale[i][rows]
                mu = b1 * (mq.float() * (ms * inv)) + (1.0 - b1) * gb
                su = sq.float() * (ss * inv)
                nu = b2 * su * su + (1.0 - b2) * gb * gb
                out = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                _quantize_into(mu, mq, ms)
                _quantize_into(torch.sqrt(nu), sq, ss)
                step[e0:e1] = out.reshape(-1)[:e1 - e0].to(g.dtype)
            steps.append(step.reshape(g.shape))
        return steps


def _quantize_into(x: torch.Tensor, payload: torch.Tensor, scale: torch.Tensor) -> None:
    """Blockwise absmax int8 of x [n_blocks, BLOCK] into ``payload`` and
    ``scale``: round(x / absmax · 127), half to even; a block whose absmax is
    0 keeps payload 0."""
    amax = x.abs().amax(dim=1, keepdim=True)
    safe = torch.where(amax == 0.0, torch.ones_like(amax), amax)
    payload.copy_(torch.round(x / safe * 127.0).to(torch.int8))
    scale.copy_(amax)


def scale_by_adam8(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> ScaleByAdam8:
    """optax.scale_by_adam with int8 blockwise moment storage."""
    return ScaleByAdam8(b1, b2, eps)


class AdamW8bit:
    """``adamw8bit(learning_rate, weight_decay)`` of the JAX package
    (``optax.chain(scale_by_adam8, add_decayed_weights,
    scale_by_learning_rate)``), optionally after ``optax.clip_by_global_norm``:
    the optimizer object of :class:`..train.AdamW`'s shape.
    ``learning_rate`` is a float or a schedule ``count -> lr`` read at the
    number of updates made so far.  :meth:`update` reads each parameter's
    ``.grad`` and updates the parameters and the moments in place.  The
    decay and the learning rate are applied in the parameter's dtype, each
    rounded to it first, as JAX rounds a Python scalar beside a bf16 array."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip_norm: float = 0.0, mask=None):
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.adam8 = ScaleByAdam8(b1, b2, eps)
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.mask = mask

    def init(self, model: torch.nn.Module):
        from .train import OptState

        return OptState(adam8=self.adam8.init(model.parameters()))

    @torch.no_grad()
    def update(self, model: torch.nn.Module, state) -> None:
        from .train import clip_by_global_norm

        params = list(model.parameters())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if self.grad_clip_norm:
            clip_by_global_norm(grads, self.grad_clip_norm, model)
        steps = self.adam8.update(grads, state.adam8)
        lr = -float(self.schedule(state.count))
        for p, u, decay in zip(params, steps, decay_mask(model, self.mask)):
            if decay:
                u = u + torch.tensor(self.weight_decay, dtype=u.dtype, device=u.device) * p
            u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
            p.copy_((p + u).to(p.dtype))
        state.count += 1


def _layout(model: torch.nn.Module):
    """The JAX params layout of ``model``'s parameters (``layers.3.wq`` →
    ``tree["layers"][3]["wq"]``), leaves the parameters themselves."""
    tree = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            layers = tree.setdefault("layers", [])
            while len(layers) <= int(parts[1]):
                layers.append({})
            layers[int(parts[1])][parts[2]] = p
        else:
            tree[name] = p
    return tree


def decay_mask(model: torch.nn.Module, mask) -> List[bool]:
    """Whether weight decay applies to each parameter of ``model`` (in
    ``parameters()`` order) under ``mask``: optax's ``add_decayed_weights``
    mask over the JAX params layout, a tree of bools (``{"embed": False,
    "layers": [{"wq": True, ...}], ...}``) or a callable from the layout
    (leaves: the parameters) to one; None decays every parameter."""
    if mask is None:
        return [True] * len(list(model.parameters()))
    if callable(mask):
        mask = mask(_layout(model))
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        leaf = mask["layers"][int(parts[1])][parts[2]] if parts[0] == "layers" else mask[name]
        out.append(bool(leaf))
    return out


def adamw8bit(learning_rate: Union[float, Callable[[int], float]], *, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
              mask=None) -> AdamW8bit:
    """AdamW with blockwise-int8 moment storage (the JAX package's drop-in
    for optax.adamw).  ``mask`` limits the weight decay to the parameters
    it marks True (:func:`decay_mask`), as optax's ``add_decayed_weights``
    mask does in the JAX package."""
    return AdamW8bit(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     mask=mask)


def moment_bytes(params) -> Tuple[int, int]:
    """(adamw_bf16_bytes, adamw8bit_bytes) for parameters (a module or an
    iterable of tensors): the device memory the moments cost under each
    optimizer."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    params = list(params)
    n = sum(p.numel() for p in params)
    nb = sum(_n_blocks(p) for p in params)
    return 4 * n, 2 * n + 8 * nb
