"""Batched token sampling, PyTorch port of ``flash_attention_dlrs_tpu/runtime/sampling.py``.

One sampler handles a whole decode batch with PER-SLOT parameters:

- temperature == 0  → greedy argmax for that slot (the first maximum on a
  tie, as ``jnp.argmax``: greedy tokens match the JAX sampler exactly);
- top_k > 0         → keep the k highest logits (k clamped to MAX_TOP_K);
- top_p < 1         → nucleus sampling: smallest probability mass ≥ p.

Randomness is deterministic per (seed, position): each sampled slot draws
from a ``torch.Generator`` seeded from its request's seed and the token
position, so a request reproduces its stream whatever slot or batch it lands
in.  The bits differ from ``jax.random``'s: a seeded stream of the port
cannot match the JAX sampler's, only reproduce itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._cuda import resolve_device

_NEG = -1e30

# Upper bound for per-slot top-k (larger requests are clamped to it).
MAX_TOP_K = 64


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature=0 is greedy decoding (top_k / top_p ignored).
    """

    temperature: float = 0.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1 = disabled
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


_U64 = (1 << 64) - 1


def _stream_seed(seed: int, position: int) -> int:
    """One generator seed per (request seed, token position), mixed with the
    splitmix64 finalizer: the CPU generator keeps only the low 32 bits of
    its seed, so every input bit has to reach them."""
    x = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def sample_tokens(
    logits,  # [slots, vocab] any float dtype
    temperature,  # [slots] f32; 0 → greedy
    top_k,  # [slots] int32; 0 → disabled
    top_p,  # [slots] f32; 1 → disabled
    seeds,  # [slots] int32 per-request seeds
    positions,  # [slots] int32 — with the seed, picks the random stream
):
    """Per-slot filtered sampling; returns [slots] int64 token ids on the
    logits' device."""
    logits = logits.float()
    tokens = torch.argmax(logits, dim=-1)
    sampled = (temperature > 0).nonzero().flatten().tolist()
    if not sampled:
        return tokens
    scaled = filtered_logits(logits, temperature, top_k, top_p)
    seeds_h = seeds.tolist()
    pos_h = positions.tolist()
    for i in sampled:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_stream_seed(seeds_h[i], pos_h[i]))
        probs = torch.softmax(scaled[i], dim=-1)
        tokens[i] = torch.multinomial(probs, 1, generator=gen)[0]
    return tokens


def filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled logits with top-k / top-p filtering applied
    (_NEG where filtered).  softmax of the result is the exact distribution
    sampling draws from.

    ``logits`` is [slots, vocab] or [slots, steps, vocab]; the parameter
    tensors are per-slot and broadcast over intermediate axes.
    """
    param_shape = logits.shape[:1] + (1,) * (logits.ndim - 1)
    t = temperature.reshape(param_shape).float()
    k = top_k.reshape(param_shape).long()
    p = top_p.reshape(param_shape).float()

    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    scaled = logits.float() / safe_t

    # top-k: cutoff at each slot's k-th highest logit (k clamped)
    kk = min(MAX_TOP_K, logits.shape[-1])
    kth_vals = torch.topk(scaled, kk, dim=-1).values  # [..., kk] descending
    k_eff = (k.clamp(1, kk) - 1).expand(scaled.shape[:-1] + (1,))
    cutoff = torch.gather(kth_vals, -1, k_eff)
    scaled = torch.where((k > 0) & (scaled < cutoff),
                         torch.full_like(scaled, _NEG), scaled)

    # top-p (nucleus): smallest prefix of sorted probs with mass >= p
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # keep entries where the mass BEFORE them is < p (always keeps the top-1)
    keep_sorted = (cum - sorted_probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(scaled < thresh, torch.full_like(scaled, _NEG), scaled)


def batch_params(params_list, default: Optional[SamplingParams] = None,
                 device="cuda"):
    """Stack per-slot SamplingParams (None → default/greedy) into tensors
    (temperature, top_k, top_p, seeds) on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    default = default or GREEDY
    ps = [p or default for p in params_list]
    t = torch.tensor([p.temperature for p in ps], dtype=torch.float32, device=device)
    k = torch.tensor([p.top_k for p in ps], dtype=torch.int32, device=device)
    p_ = torch.tensor([p.top_p for p in ps], dtype=torch.float32, device=device)
    seeds = torch.tensor([p.seed for p in ps], dtype=torch.int32, device=device)
    return t, k, p_, seeds
