"""Decode bursts and speculative rounds, PyTorch port of ``flash_attention_dlrs_tpu/runtime/speculative.py``.

The JAX package runs the token loop on the device: ``lax.scan`` over the
draft's γ−1 proposals and ``lax.while_loop`` over a burst's steps or over
every speculative round, inside one jitted program.  PyTorch has no such
loop.  Here each whole-generation program is ONE BODY over static device
buffers, run by a host loop through :class:`.step_graph.StepGraph`: on the
CPU the body is called in a Python loop, on the card it is captured once per
shape key into a CUDA graph and replayed.

- :func:`make_plain_generate`: the body is one decode step with its
  sampling and bookkeeping.  It replays exactly min(max_new, max(budget))
  times and reads nothing back: a slot past its budget re-writes its last
  (cur, pos) pair (bit-identical, so idempotent), a slot stopped by EOS
  keeps writing past its own live prefix, inside its allocation.
- :func:`make_spec_generate`: the body is one whole round: γ−1 draft
  steps, the final draft K/V write, the target's verify step,
  :func:`.sampling.speculative_verify` and the commit.  After each round the
  host reads one device flag ("every slot done"), so the round count
  depends on acceptance, as the JAX loop's ``cond`` does.

:func:`make_draft_propose` and :func:`make_verify_accept` are the two
halves of a round for the host-loop form
(``DecodeEngine.generate_speculative``), run eagerly.  Page capacity is
ensured by the host before any of these run: nothing inside allocates
pages.  No reference counterpart (the reference has no serving); the
algorithm is Leviathan et al. 2023 via ``runtime.sampling.speculative_verify``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.decoding import make_decode_step, make_verify_step
from ..models.transformer import ModelConfig
from .sampling import sample_tokens, speculative_verify
from .step_graph import StepGraph


def _rows_offs(page_tbl, pos, page_size: int):
    """Pool page and in-page offset of each position: pos [B] or [B, T]."""
    idx = (pos // page_size).long()
    rows = torch.gather(page_tbl, 1, idx if pos.ndim == 2 else idx[:, None])
    return (rows if pos.ndim == 2 else rows[:, 0]), pos % page_size


def _propose(step, params, pools, x0, base_pos, page_tbl, page_size, gamma,
             sampling, sample):
    """γ−1 draft decode steps with sampling between them (step j inserts
    the current token's K/V at base_pos + j and draws proposal j+1 from the
    filtered draft distribution), then the last proposal's K/V write, so a
    fully accepted round leaves the draft cache complete.  Returns
    (proposals [B, γ], draft logits [B, γ−1, V])."""
    cur, props, logits_seq = x0, [x0], []
    for j in range(gamma):
        pos = base_pos + j
        rows, offs = _rows_offs(page_tbl, pos, page_size)
        logits, _ = step(params, pools, cur, pos, rows, offs, page_tbl,
                         (pos + 1).int())
        if j == gamma - 1:
            break  # the final proposal's K/V write; its logits are unused
        cur = sample_tokens(logits, *sampling, pos + 1, sample=sample)
        props.append(cur)
        logits_seq.append(logits)
    return torch.stack(props, dim=1), torch.stack(logits_seq, dim=1)


def make_draft_propose(cfg: ModelConfig, gamma: int, page_size: int, *,
                       pages_per_block: Optional[int] = None):
    """The draft's proposal loop of one round.

    (params, pools, x0 [B], base_pos [B], page_tbl [B, pps] int32, temp,
    top_k, top_p, seeds, *, sample=True) -> (proposals [B, γ], draft_logits
    [B, γ-1, V], pools)

    Semantics of γ−1 single decode steps with sampling between them
    (``DecodeEngine._single_decode_logits`` in a loop) plus the final
    proposal's K/V write; pools are written in place.  Page capacity for
    base_pos + γ tokens must be ensured by the host.  ``sample=False`` when
    every temperature is 0.  ``pages_per_block``: the draft's key splits
    (``models.decoding.make_decode_step``)."""
    step = make_decode_step(cfg, pages_per_block=pages_per_block)

    def propose(params, pools, x0, base_pos, page_tbl, temp, top_k, top_p,
                seeds, *, sample=True):
        with torch.inference_mode():
            proposals, logits = _propose(
                step, params, pools, x0.long(), base_pos.long(), page_tbl,
                page_size, gamma, (temp, top_k, top_p, seeds), sample)
        return proposals, logits, pools

    return propose


def _verify_accept(verify, params, pools, proposals, positions, rows, offs,
                   tbl, lens, draft_logits, sampling, base_pos, sample):
    logits, _ = verify(params, pools, proposals, positions, rows, offs, tbl,
                       lens)
    return speculative_verify(logits, draft_logits, proposals, *sampling,
                              base_pos, sample=sample)


def make_verify_accept(cfg: ModelConfig, gamma: int, *,
                       pages_per_block: Optional[int] = None):
    """The target's verification of one round and the accept / resample
    rule.

    (params, pools, proposals [B, γ], positions, rows, offs, tbl, lens,
    draft_logits [B, γ-1, V], temp, top_k, top_p, seeds, base_pos, *,
    sample=True) -> (round_tokens [B, γ], n_committed [B], pools)

    ``pages_per_block``: the target's key splits
    (``models.decoding.make_verify_step``)."""
    verify = make_verify_step(cfg, gamma, pages_per_block=pages_per_block)

    def verify_accept(params, pools, proposals, positions, rows, offs, tbl,
                      lens, draft_logits, temp, top_k, top_p, seeds, base_pos,
                      *, sample=True):
        with torch.inference_mode():
            tokens, n_committed = _verify_accept(
                verify, params, pools, proposals, positions, rows, offs, tbl,
                lens, draft_logits, (temp, top_k, top_p, seeds), base_pos,
                sample)
        return tokens, n_committed, pools

    return verify_accept


# ---------------------------------------------------------------------------
# Whole-generation programs: one body over static buffers, replayed
# ---------------------------------------------------------------------------


class _Buffers:
    """The static device buffers of one program: allocated once, refilled
    from the caller's arguments before each generation, read and written in
    place by the body, so a captured graph's addresses stay valid."""

    def __init__(self, device, b: int, max_new: int, tables):
        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cur, self.base, self.budget, self.cnt = (zeros(b) for _ in range(4))
        self.done = zeros(b, dtype=torch.bool)
        # one column past max_new takes the writes a commit drops
        self.out = zeros(b, max_new + 1)
        self.step_i, self.eos = zeros(), zeros()
        self.tables = [zeros(*shape, dtype=torch.int32) for shape in tables]
        self.sampling = (zeros(b, dtype=torch.float32), zeros(b, dtype=torch.int32),
                         zeros(b, dtype=torch.float32), zeros(b, dtype=torch.int32))
        self.rounds, self.proposed, self.accepted = zeros(), zeros(), zeros()
        self.all_done = zeros(dtype=torch.bool)

    def load(self, x0, base_pos, tables, active, eos, sampling, budget):
        """Refill from one call's arguments: host arrays (numpy) or tensors
        of any device for the per-slot values, the sampling tensors
        (temp, top_k, top_p, seeds) on the program's device."""
        def put(dst, src):
            dst.copy_(src if torch.is_tensor(src) else torch.from_numpy(np.asarray(src)))

        put(self.cur, x0)
        put(self.base, base_pos)
        put(self.budget, budget)
        put(self.done, ~np.asarray(active, bool))
        for dst, src in zip(self.tables, tables):
            put(dst, src)
        for dst, src in zip(self.sampling, sampling):
            put(dst, src)
        self.eos.fill_(int(eos))
        for t in (self.cnt, self.out, self.step_i, self.rounds, self.proposed,
                  self.accepted):
            t.zero_()
        self.all_done.fill_(not np.any(active))


def _key(*tensors_or_objects):
    return tuple(id(t) for t in tensors_or_objects)


def make_plain_generate(cfg: ModelConfig, page_size: int, max_new: int, *,
                        graph_pool=None, pages_per_block: Optional[int] = None):
    """Plain autoregressive generation of up to ``max_new`` tokens a slot,
    one decode step per run of the body.

    (params, pools, x0 [B], base_pos [B], page_tbl [B, pps], active [B]
    bool, eos, temp, top_k, top_p, seeds, budget [B], *, sample=True)
    -> (out [B, max_new], n_out [B], pools)

    ``active`` marks real slots; padding slots start done (they still ride
    the lockstep batch, writing to their null page).  ``budget`` is each
    slot's step cap ≤ max_new: a slot whose budget runs out freezes while
    the batch keeps lockstep.  ``eos`` is an int (−1: none).  x0, base_pos,
    page_tbl, active and budget are host arrays (the host knows them, and
    the step count min(max_new, max(budget)) comes from them);
    temp/top_k/top_p/seeds are tensors on the pools' device (``sample=False``
    when every temperature is 0).  out and n_out are the program's buffers,
    valid until its next call.  Page capacity for base_pos + max_new tokens
    must be ensured by the host.  Each (params, pools, batch, table width,
    ``sample``) gets a program of its own: on the card one CUDA graph,
    captured in ``graph_pool`` on first use, its key splits fixed
    (``pages_per_block``, as ``models.decoding.make_decode_step``)."""
    step = make_decode_step(cfg, pages_per_block=pages_per_block)
    programs = {}

    def program(params, pools, b, pps, sample):
        device = pools.k[0].device
        bufs = _Buffers(device, b, max_new, [(b, pps)])
        tbl = bufs.tables[0]
        temp, top_k, top_p, seeds = bufs.sampling

        @torch.inference_mode()
        def body():
            i = bufs.step_i
            # a slot past its budget re-writes its last real (cur, pos)
            # pair: bit-identical, so idempotent, and never past its pages
            pos = bufs.base + torch.minimum(i, torch.clamp(bufs.budget, min=1) - 1)
            rows, offs = _rows_offs(tbl, pos, page_size)
            logits, _ = step(params, pools, bufs.cur, pos, rows, offs, tbl,
                             (pos + 1).int())
            nxt = sample_tokens(logits, temp, top_k, top_p, seeds, pos + 1,
                                sample=sample)
            nxt = torch.where(bufs.done, 0, nxt)
            bufs.out.index_copy_(1, i.reshape(1), nxt[:, None])
            bufs.cnt.add_((~bufs.done).long())
            bufs.done.logical_or_(nxt == bufs.eos)
            bufs.done.logical_or_(i + 1 >= bufs.budget)
            bufs.cur.copy_(torch.where(bufs.done, bufs.cur, nxt))
            i.add_(1)

        return bufs, StepGraph(body, device, graph_pool)

    def generate(params, pools, x0, base_pos, page_tbl, active, eos, temp,
                 top_k, top_p, seeds, budget, *, sample=True):
        page_tbl = np.asarray(page_tbl)
        b, pps = page_tbl.shape
        key = _key(params, pools) + (b, pps, sample)
        if key not in programs:
            programs[key] = program(params, pools, b, pps, sample)
        bufs, run = programs[key]
        bufs.load(x0, base_pos, [page_tbl], active, eos,
                  (temp, top_k, top_p, seeds), budget)
        live = np.asarray(budget)[np.asarray(active, bool)]
        for _ in range(min(max_new, int(live.max(initial=0)))):
            run()
        return bufs.out[:, :max_new], bufs.cnt, pools

    generate.programs = programs
    return generate


def make_spec_generate(t_cfg: ModelConfig, d_cfg: ModelConfig, gamma: int,
                       page_size: int, max_new: int, *, graph_pool=None,
                       t_pages_per_block: Optional[int] = None,
                       d_pages_per_block: Optional[int] = None):
    """Speculative generation, one whole round per run of the body.

    (t_params, t_pools, d_params, d_pools, x0 [B], base_pos [B],
    t_tbl [B, pps_t], d_tbl [B, pps_d], active [B] bool, eos, temp, top_k,
    top_p, seeds, budget [B], *, sample=True)
    -> (out [B, max_new], n_out [B], rounds, proposed, accepted,
        t_pools, d_pools)

    ``budget`` is each slot's commit cap ≤ max_new (the serving burst
    passes each request's remaining budget; offline callers max_new
    everywhere); a slot freezes once its count reaches it, or at EOS,
    while the batch keeps lockstep.  Each round is the JAX program's: the
    draft proposes (:func:`make_draft_propose`), the target verifies and
    accepts (:func:`make_verify_accept`), and the commit runs on the
    device: per-slot committed counts advance both caches' logical lengths
    (base_pos + n_out is the valid prefix), tokens scatter into ``out``,
    EOS and budget freeze a slot.  Rounds run until every slot is done or
    ``max_new`` rounds ran; the host reads the "every slot done" flag after
    each.  Arguments and outputs as :func:`make_plain_generate`'s; the
    counters are 0-d tensors.  Page capacity for base_pos + max_new + γ
    must be ensured on BOTH engines (frozen slots keep overwriting the same
    γ positions past their prefix).  ``t_pages_per_block`` /
    ``d_pages_per_block``: the target's verify and the draft's decode key
    splits."""
    d_step = make_decode_step(d_cfg, pages_per_block=d_pages_per_block)
    verify = make_verify_step(t_cfg, gamma, pages_per_block=t_pages_per_block)
    programs = {}

    def program(t_params, t_pools, d_params, d_pools, b, pps_t, pps_d, sample):
        device = t_pools.k[0].device
        bufs = _Buffers(device, b, max_new, [(b, pps_t), (b, pps_d)])
        t_tbl, d_tbl = bufs.tables
        gam = torch.arange(gamma, device=device)

        @torch.inference_mode()
        def body():
            base = bufs.base + bufs.cnt  # committed length of each slot
            cap = torch.clamp(bufs.budget, max=max_new)
            proposals, d_logits = _propose(
                d_step, d_params, d_pools, bufs.cur, base, d_tbl, page_size,
                gamma, bufs.sampling, sample)
            positions = base[:, None] + gam[None, :]
            rows, offs = _rows_offs(t_tbl, positions, page_size)
            round_tokens, n_comm = _verify_accept(
                verify, t_params, t_pools, proposals, positions, rows, offs,
                t_tbl, (base + gamma).int(), d_logits, bufs.sampling, base,
                sample)

            # the commit, on the device
            live = ~bufs.done
            bufs.proposed.add_(live.long().sum() * (gamma - 1))
            bufs.accepted.add_(torch.where(live, n_comm - 1, 0).sum())
            m = torch.where(live, n_comm, 0)
            m = torch.clamp(torch.minimum(m, cap - bufs.cnt), min=0)  # budget
            hit = (round_tokens == bufs.eos) & (gam[None, :] < m[:, None])
            any_hit = hit.any(dim=1)
            first = torch.argmax(hit.long(), dim=1)
            m = torch.where(any_hit, torch.minimum(m, first + 1), m)  # EOS
            bufs.done.logical_or_(any_hit)
            valid = gam[None, :] < m[:, None]
            cols = torch.where(valid, bufs.cnt[:, None] + gam[None, :], max_new)
            bufs.out.scatter_(1, cols, torch.where(valid, round_tokens, 0))
            bufs.out[:, max_new].zero_()  # the dropped writes' column
            new_cur = torch.gather(round_tokens, 1,
                                   torch.clamp(m - 1, min=0)[:, None])[:, 0]
            bufs.cur.copy_(torch.where(m > 0, new_cur, bufs.cur))
            bufs.cnt.add_(m)
            bufs.done.logical_or_(bufs.cnt >= cap)
            bufs.rounds.add_(1)
            torch.all(bufs.done, out=bufs.all_done)

        return bufs, StepGraph(body, device, graph_pool)

    def generate(t_params, t_pools, d_params, d_pools, x0, base_pos, t_tbl,
                 d_tbl, active, eos, temp, top_k, top_p, seeds, budget, *,
                 sample=True):
        t_tbl, d_tbl = np.asarray(t_tbl), np.asarray(d_tbl)
        b = t_tbl.shape[0]
        key = _key(t_params, t_pools, d_params, d_pools) + (
            b, t_tbl.shape[1], d_tbl.shape[1], sample)
        if key not in programs:
            programs[key] = program(t_params, t_pools, d_params, d_pools, b,
                                    t_tbl.shape[1], d_tbl.shape[1], sample)
        bufs, run = programs[key]
        bufs.load(x0, base_pos, [t_tbl, d_tbl], active, eos,
                  (temp, top_k, top_p, seeds), budget)
        if np.any(active):
            for _ in range(max_new):
                run()
                if bufs.all_done.item():  # the one read of each round
                    break
        return (bufs.out[:, :max_new], bufs.cnt, bufs.rounds, bufs.proposed,
                bufs.accepted, t_pools, d_pools)

    generate.programs = programs
    return generate
