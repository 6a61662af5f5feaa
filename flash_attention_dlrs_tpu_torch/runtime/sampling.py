"""Batched token sampling, PyTorch port of ``flash_attention_dlrs_tpu/runtime/sampling.py``.

One sampler handles a whole decode batch with PER-SLOT parameters:

- temperature == 0  → greedy argmax for that slot (the first maximum on a
  tie, as ``jnp.argmax``: greedy tokens match the JAX sampler exactly);
- top_k > 0         → keep the k highest logits (k clamped to MAX_TOP_K);
- top_p < 1         → nucleus sampling: smallest probability mass ≥ p.

Randomness is a pure function of (seed, position, vocab index): a
counter-based 32-bit hash (``lowbias32``, the mixer of the attention
kernels' dropout) turned into a uniform, then Gumbel-max over the filtered
logits.  A (seed, position) stream therefore reproduces itself whatever
slot or batch it lands in, and drawing reads nothing back from the device,
so a decode step with its sampling can be captured into a CUDA graph.  The
bits differ from ``jax.random``'s: a seeded stream of the port cannot match
the JAX sampler's, only reproduce itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._cuda import resolve_device
from ..ops.fwd_kernel import lowbias32

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


# Stream tags folded into the key beside (seed, position): 0 draws sampled
# tokens; 2 and 3 are the acceptance and replacement draws of
# speculative_verify (the tags the JAX package folds in).
_TAG_SAMPLE, _TAG_ACCEPT, _TAG_REPLACE = 0, 2, 3
_M32 = 0xFFFFFFFF


def _u32(x):
    return x.long() & _M32


def _uniforms(seeds, positions, tag: int, index):
    """Uniforms in (0, 1), fp32, [slots, *index.shape]: a pure function of
    (seed, position, tag, index), hashed with ``lowbias32`` on uint32
    values held in int64.  ``seeds`` and ``positions`` are [slots]."""
    key = lowbias32(_u32(seeds) ^ ((tag * 0x9E3779B9) & _M32))
    key = lowbias32(key ^ _u32(positions))  # one key per (seed, position, tag)
    key = key.reshape(key.shape + (1,) * index.ndim)
    bits = lowbias32(lowbias32((_u32(index) + key) & _M32) ^ key)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel_argmax(scores, seeds, positions, tag: int):
    """argmax over the last axis of ``scores`` [slots, V] plus Gumbel noise
    from :func:`_uniforms`: a draw from softmax(scores)."""
    vocab = torch.arange(scores.shape[-1], device=scores.device)
    u = _uniforms(seeds, positions, tag, vocab)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(
    logits,  # [slots, vocab] any float dtype
    temperature,  # [slots] f32; 0 → greedy
    top_k,  # [slots] int32; 0 → disabled
    top_p,  # [slots] f32; 1 → disabled
    seeds,  # [slots] int32 per-request seeds
    positions,  # [slots] — with the seed, picks the random stream
    *,
    sample: bool = True,
):
    """Per-slot filtered sampling; returns [slots] int64 token ids on the
    logits' device, with tensor operations only (no value is read back to
    the host).  ``sample=False`` is the greedy-only form for a batch whose
    every temperature is 0: it skips the top-k / top-p sort."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if not sample:
        return greedy
    scaled = filtered_logits(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(scaled, seeds, positions, _TAG_SAMPLE)
    return torch.where(temperature > 0, sampled, greedy)


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


def speculative_verify(
    target_logits,  # [slots, gamma, vocab]: logits after consuming proposals[:, :j+1]
    draft_logits,  # [slots, gamma-1, vocab]: the distributions that drew d_1..d_{γ-1}
    proposals,  # [slots, gamma]: x0, d_1..d_{γ-1}
    temperature,  # [slots] f32; 0 → greedy verify (argmax match)
    top_k,  # [slots] int32
    top_p,  # [slots] f32
    seeds,  # [slots] int32
    base_positions,  # [slots]: committed length before this round
    *,
    sample: bool = True,
):
    """Speculative-decoding verification (Leviathan et al.), the JAX
    package's ``speculative_verify``: accept d_{j+1} with probability
    min(1, p_j(d_{j+1}) / q_j(d_{j+1})); at the first rejection resample
    from the residual norm(max(p_j − q_j, 0)); if all γ−1 proposals are
    accepted, draw the bonus token from p_{γ−1}.  The committed stream is
    distributed exactly as plain sampling from the filtered target
    distribution, whatever the draft.  temperature 0 is the greedy
    argmax-match rule.

    The acceptance uniforms are stream tag 2 at ``base_positions`` (index
    j), the replacement draw tag 3 at ``base_positions + m``.  Tensor
    operations only; ``sample=False`` (every temperature 0) skips the
    filtering and the draws.

    Returns (tokens [slots, gamma] int64, n_committed [slots] int64): the
    first n_committed[i] entries of tokens[i] are this round's output."""
    slots, gamma = proposals.shape
    greedy = torch.argmax(target_logits.float(), dim=-1)  # [slots, gamma]
    d_next = proposals[:, 1:].long()  # [slots, gamma-1]
    accept = d_next == greedy[:, : gamma - 1]
    if sample:
        p_probs = torch.softmax(
            filtered_logits(target_logits, temperature, top_k, top_p), dim=-1)
        q_probs = torch.softmax(
            filtered_logits(draft_logits, temperature, top_k, top_p), dim=-1)
        p_at = torch.gather(p_probs[:, : gamma - 1], -1, d_next[..., None])[..., 0]
        q_at = torch.gather(q_probs, -1, d_next[..., None])[..., 0]
        u = _uniforms(seeds, base_positions, _TAG_ACCEPT,
                      torch.arange(gamma - 1, device=proposals.device))
        accept = torch.where((temperature > 0)[:, None], u * q_at <= p_at, accept)
    m = torch.cumprod(accept.long(), dim=-1).sum(dim=-1)  # [slots]

    replacement = torch.gather(greedy, 1, m[:, None])[:, 0]
    if sample:
        # the residual at index m when a proposal was rejected (m < γ−1),
        # the target's bonus distribution when all were accepted
        at_m = m[:, None, None].expand(slots, 1, p_probs.shape[-1])
        p_m = torch.gather(p_probs, 1, at_m)[:, 0]
        q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
        q_m = torch.gather(q_pad, 1, at_m)[:, 0]
        residual = torch.clamp(p_m - q_m, min=0.0)
        use_residual = (m < gamma - 1) & (residual.sum(dim=-1) > 0)
        dist = torch.where(use_residual[:, None], residual, p_m)
        drawn = _gumbel_argmax(torch.log(torch.clamp(dist, min=1e-38)), seeds,
                               base_positions.long() + m, _TAG_REPLACE)
        replacement = torch.where(temperature > 0, drawn, replacement)

    # tokens[:, :m] = accepted proposals d_1..d_m; tokens[:, m] = replacement
    cols = torch.arange(gamma, device=proposals.device)[None, :]
    toks = torch.cat([d_next, torch.zeros_like(d_next[:, :1])], dim=1)
    tokens = torch.where(cols == m[:, None], replacement[:, None], toks)
    return tokens, m + 1


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
