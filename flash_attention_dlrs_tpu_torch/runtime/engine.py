"""DecodeEngine, PyTorch port of ``flash_attention_dlrs_tpu/runtime/engine.py``.

Continuous-batching generation over the paged KV cache:
ContinuousBatchingScheduler (admission control) + PageAllocator (page
accounting, shared across layers) + models.decoding (dense prefill per
admitted prompt and one batched decode step per token) — greedy or seeded
sampling, EOS/budget termination, slot backfill at step boundaries.

Inactive slots decode against a reserved null page with length 0 (their
output is ignored), so the decode batch never changes shape.  KV pools may
be quantized (int8, int4, fp8), prompts may be prefilled in fixed chunks
through the multi-token verify step, and full-page prompt prefixes may be
shared through the prefix cache.  The engine runs on the card by default
(``device="cuda"``) and on the CPU only when asked.  Ring modes, the mesh,
speculative serving and device-side bursts raise ``NotImplementedError``
until their slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._cuda import resolve_device
from ..models.decoding import (
    init_kv_pools,
    make_decode_step,
    make_prefill,
    make_verify_step,
    write_prompt_kv_all,
)
from ..models.transformer import ModelConfig, Transformer
from .kv_cache import PageAllocator
from .prefix_cache import PrefixCache
from .sampling import GREEDY, SamplingParams, batch_params, sample_tokens
from .scheduler import ContinuousBatchingScheduler, Request

_NULL_SEQ = "__null__"
_NOT_YET = "{} is not ported yet (ROADMAP.md, queue 1 of the PyTorch port)"


def _next_pow2(n: int, floor: int = 128) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class StreamEvent(NamedTuple):
    """One `DecodeEngine.generate_stream` event: a generated token
    (`done=False`), or end-of-request (`token=None, done=True`).
    ``logprob`` is the model's log P(token | prefix) (None on done events)."""

    request_id: str
    token: Optional[int]
    done: bool
    logprob: Optional[float] = None


def _token_logprobs(logits, tokens):
    """log-softmax of each row at the chosen token: [B, V], [B] → [B] f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, 1, tokens.long()[:, None])[:, 0]


class DecodeEngine:
    def __init__(
        self,
        params: Transformer,
        cfg: ModelConfig,
        *,
        num_pages: int = 128,
        page_size: int = 256,
        num_slots: int = 4,
        pages_per_seq: int = 8,
        kv_dtype=torch.bfloat16,
        quantized_kv: bool = False,
        eos_token: Optional[int] = None,
        prefill_chunk: int = 0,
        streaming_window: int = 0,
        attention_sinks: int = 0,
        enable_prefix_cache: bool = False,
        mesh=None,
        device="cuda",
    ):
        """``params`` is the port's model (models.weights.params_from_jax);
        it is moved to ``device`` if it lies elsewhere.  Pages are accounted
        by the Python PageAllocator.

        ``quantized_kv`` stores K/V as ``kv_dtype`` payloads with per-token
        scales: ``torch.int8``, ``"int4"`` (two tokens per byte),
        ``torch.float8_e4m3fn`` or ``torch.float8_e5m2``.  fp8 is taken as
        asked: the H100 has an fp8 datapath, where the JAX package falls
        back to int8 on TPUs without one.  ``prefill_chunk`` > 0 prefills
        every prompt in chunks of that many tokens through the verify step;
        ``enable_prefix_cache`` (which needs it) reuses the full-page
        prompt prefixes of earlier requests."""
        unported = {
            "streaming_window / attention_sinks": streaming_window or attention_sinks,
            "mesh (tensor-parallel serving)": mesh is not None,
        }
        for name, used in unported.items():
            if used:
                raise NotImplementedError(_NOT_YET.format(name))
        if kv_dtype == "int4" and not quantized_kv:
            raise ValueError("kv_dtype='int4' requires quantized_kv=True")
        if enable_prefix_cache and not prefill_chunk:
            raise ValueError(
                "enable_prefix_cache requires prefill_chunk > 0 (the suffix "
                "prefill runs through the chunked path)")
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.num_slots = num_slots
        self.eos_token = eos_token
        self.kv_dtype = kv_dtype

        self.pools = init_kv_pools(cfg, num_pages=num_pages,
                                   page_size=page_size, dtype=kv_dtype,
                                   quantized=quantized_kv, device=self.device)
        self.allocator = PageAllocator(num_pages, page_size)
        self.allocator.allocate(_NULL_SEQ, 1)  # scratch page for idle slots
        self._null_page = self.allocator.page_tables[_NULL_SEQ][0]
        # decode_step_bookkeeping zero-pads page-table rows, and step copies
        # rows wholesale — padding points at page 0, which is only safe
        # because _NULL_SEQ is allocated FIRST and gets page 0.
        if self._null_page != 0:
            raise RuntimeError(
                f"null sequence must own page 0; got page {self._null_page}")

        self.scheduler = ContinuousBatchingScheduler(
            num_slots=num_slots,
            can_allocate=self._can_admit,
            on_admit=self._admit,
            on_retire=self._retire,
        )
        self.slot_request: List[Optional[Request]] = [None] * num_slots
        self._slot_next_token = np.zeros(num_slots, np.int64)
        self._prefill = make_prefill(cfg)
        self._decode_step = make_decode_step(cfg)
        self._sample_cache_key = None
        self._sample_cache = None
        self.prefill_chunk = prefill_chunk
        if prefill_chunk:
            self._chunk_prefill = make_verify_step(cfg, prefill_chunk)
        self.prefix_cache = None
        if enable_prefix_cache:
            self.prefix_cache = PrefixCache(self.allocator, page_size)
            # the admission gate may free pages by evicting cache entries
            self.scheduler._can_allocate = self.prefix_cache.can_allocate

    # -- admission / retirement ------------------------------------------------

    def _can_admit(self, num_tokens: int) -> bool:
        return self.allocator.can_allocate(num_tokens)

    def attach_draft(self, draft: "DecodeEngine", gamma: int = 4) -> None:
        raise NotImplementedError(_NOT_YET.format("speculative serving"))

    def _admit(self, req: Request, slot: int) -> None:
        self._check_fits(req)
        if self.prefill_chunk:
            self._admit_chunked(req, slot)
        else:
            self._admit_dense(req, slot)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _check_fits(self, req: Request) -> None:
        need = -(-(len(req.prompt_tokens) + req.max_new_tokens) // self.page_size)
        if need > self.pages_per_seq:
            raise ValueError(
                f"request {req.request_id!r} needs {need} pages "
                f"({len(req.prompt_tokens)} prompt + {req.max_new_tokens} new "
                f"tokens) but page tables hold pages_per_seq="
                f"{self.pages_per_seq} — raise pages_per_seq (or page_size)"
            )

    def _first_token(self, req: Request, slot: int, logits, t: int) -> None:
        """Sample the request's first token from its prefill logits [1, V]."""
        temp, top_k, top_p, seeds = batch_params(
            [req.sampling or GREEDY], device=self.device)
        lengths = torch.tensor([t], dtype=torch.int32, device=self.device)
        first = sample_tokens(logits, temp, top_k, top_p, seeds, lengths)
        first_token = int(first[0])
        req.output_tokens.append(first_token)
        if req.want_logprobs:
            req.output_logprobs.append(float(_token_logprobs(logits, first)[0]))
        self.slot_request[slot] = req
        self._slot_next_token[slot] = first_token

    def _admit_dense(self, req: Request, slot: int) -> None:
        prompt = np.asarray(req.prompt_tokens, np.int64)
        t = len(prompt)
        self.allocator.allocate(req.request_id, t + req.max_new_tokens)
        pages = np.asarray(self.allocator.page_tables[req.request_id], np.int64)

        toks = np.zeros((1, _next_pow2(t)), np.int64)
        toks[0, :t] = prompt
        lengths = np.asarray([t], np.int32)
        logits, kvs = self._prefill(self.params, self._to_device(toks),
                                    self._to_device(lengths))
        n_pages_prompt = -(-t // self.page_size)
        write_prompt_kv_all(self.pools, kvs,
                            self._to_device(pages[:n_pages_prompt]),
                            self.page_size)
        self.allocator.seq_lengths[req.request_id] = t
        self._first_token(req, slot, logits[:1], t)

    def _admit_chunked(self, req: Request, slot: int) -> None:
        """Prefill through the multi-token verify step in fixed chunks: one
        step shape serves every prompt length, with bounded activation
        memory.  Real tokens sit at the END of each chunk so the kernel's
        per-row horizon (lengths − (C−1−t)) is exact for a partial chunk;
        front-pad rows write their K/V to the null page and their outputs
        are ignored.  With the prefix cache, the cached full pages of the
        prompt's prefix are shared, not recomputed."""
        c = self.prefill_chunk
        prompt = np.asarray(req.prompt_tokens, np.int64)
        t = len(prompt)
        sid = req.request_id
        cached_tokens = 0
        if self.prefix_cache is not None:
            shared_pages, cached_tokens = self.prefix_cache.match(req.prompt_tokens)
            self.prefix_cache.allocate_mixed_with_eviction(
                sid, shared_pages, t + req.max_new_tokens)
        else:
            self.allocator.allocate(sid, t + req.max_new_tokens)
        table = self.allocator.page_tables[sid]
        tbl = np.full((1, self.pages_per_seq), self._null_page, np.int32)
        tbl[0, : len(table)] = table
        tbl_d = self._to_device(tbl)

        logits = None
        done = cached_tokens  # cached prefix pages are already filled
        while done < t:
            r = min(c, t - done)  # real tokens in this chunk
            tokens = np.zeros((1, c), np.int64)
            positions = np.zeros((1, c), np.int64)
            rows = np.full((1, c), self._null_page, np.int64)
            offs = np.zeros((1, c), np.int64)
            pos = np.arange(done, done + r)
            tokens[0, c - r:] = prompt[done:done + r]
            positions[0, c - r:] = pos
            rows[0, c - r:] = np.asarray(table, np.int64)[pos // self.page_size]
            offs[0, c - r:] = pos % self.page_size
            lengths = np.asarray([done + r], np.int32)
            logits, self.pools = self._chunk_prefill(
                self.params, self.pools, self._to_device(tokens),
                self._to_device(positions), self._to_device(rows),
                self._to_device(offs), tbl_d, self._to_device(lengths),
            )
            done += r

        self.allocator.seq_lengths[sid] = t
        if self.prefix_cache is not None:
            self.prefix_cache.register(req.prompt_tokens, table)
        self._first_token(req, slot, logits[:1, -1], t)

    def _retire(self, req: Request, slot: int) -> None:
        self.allocator.free(req.request_id)
        self.slot_request[slot] = None

    # -- decode ----------------------------------------------------------------

    def step(self) -> int:
        """One batched decode step across all active slots; returns the number
        of tokens generated."""
        active = [
            (i, r) for i, r in enumerate(self.slot_request)
            if r is not None and not r.finished
        ]
        if not active:
            return 0
        b = self.num_slots
        tokens = np.zeros(b, np.int64)
        positions = np.zeros(b, np.int64)
        rows = np.full(b, self._null_page, np.int64)
        offs = np.zeros(b, np.int64)
        tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
        lens = np.zeros(b, np.int32)

        sids = [req.request_id for _, req in active]
        rows_a, offs_a, tbl_a, pos_a, lens_a = (
            self.allocator.decode_step_bookkeeping(sids, self.pages_per_seq))
        for i, (slot, _) in enumerate(active):
            tokens[slot] = self._slot_next_token[slot]
            positions[slot] = pos_a[i]
            rows[slot] = rows_a[i]
            offs[slot] = offs_a[i]
            tbl[slot] = tbl_a[i]
            lens[slot] = lens_a[i]

        lens_d = self._to_device(lens)
        logits, self.pools = self._decode_step(
            self.params, self.pools,
            self._to_device(tokens), self._to_device(positions),
            self._to_device(rows), self._to_device(offs),
            self._to_device(tbl), lens_d,
        )
        # Sampling parameters only change at admission boundaries.
        cache_key = tuple(
            id(self.slot_request[i]) if self.slot_request[i] else None
            for i in range(b)
        )
        if self._sample_cache_key != cache_key:
            slot_params = [
                (self.slot_request[i].sampling if self.slot_request[i] else None)
                for i in range(b)
            ]
            self._sample_cache = batch_params(slot_params, device=self.device)
            self._sample_cache_key = cache_key
        temp, top_k, top_p, seeds = self._sample_cache
        next_dev = sample_tokens(logits, temp, top_k, top_p, seeds, lens_d)
        next_tokens = next_dev.cpu().numpy()
        lps = None
        if any(req.want_logprobs for _, req in active):
            lps = _token_logprobs(logits, next_dev).cpu().numpy()
        for slot, req in active:
            tok = int(next_tokens[slot])
            req.output_tokens.append(tok)
            if req.want_logprobs:
                req.output_logprobs.append(float(lps[slot]))
            self._slot_next_token[slot] = tok
        self.scheduler.record_step(len(active))
        return len(active)

    def step_burst(self, max_steps: int = 8) -> int:
        raise NotImplementedError(_NOT_YET.format("step_burst (device-side bursts)"))

    def stats(self) -> Dict:
        """Operational snapshot: scheduler counters, slot/queue occupancy,
        and KV page utilization."""
        free = len(self.allocator.free_pages)
        total = self.pools.k[0].shape[1] - 1  # minus the null page
        s = self.scheduler.stats
        return {
            "admitted": s.admitted,
            "retired": s.retired,
            "steps": s.steps,
            "tokens_generated": s.tokens_generated,
            "active_slots": sum(r is not None for r in self.slot_request),
            "num_slots": self.num_slots,
            "queue_depth": len(self.scheduler.queue),
            "pages_total": total,
            "pages_free": free,
            "page_utilization": 1.0 - free / total,
            "rolling_window": 0,
            "streaming_window": 0,
            "attention_sinks": 0,
            "kv_dtype": str(self.kv_dtype),
        }

    # -- public API --------------------------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int = 16,
        max_steps: int = 10_000,
        sampling: Optional[SamplingParams] = None,
        return_logprobs: bool = False,
        burst: int = 1,
    ):
        """Generate for every prompt (continuous batching).  ``sampling``
        defaults to greedy.  ``return_logprobs=True`` returns
        (tokens, logprobs) — per-token log P_model(token | prefix)."""
        outputs: Dict[str, List[int]] = {}
        lps: Dict[str, List[float]] = {}
        for ev in self.generate_stream(
            prompts, max_new_tokens=max_new_tokens, max_steps=max_steps,
            sampling=sampling, logprobs=return_logprobs, burst=burst,
        ):
            if ev.token is not None:
                outputs.setdefault(ev.request_id, []).append(ev.token)
                lps.setdefault(ev.request_id, []).append(ev.logprob)
        toks = [outputs.get(f"req{i}", []) for i in range(len(prompts))]
        if return_logprobs:
            return toks, [lps.get(f"req{i}", []) for i in range(len(prompts))]
        return toks

    def generate_stream(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int = 16,
        max_steps: int = 10_000,
        sampling: Optional[SamplingParams] = None,
        logprobs: bool = False,
        burst: int = 1,
    ) -> Iterator[StreamEvent]:
        """Streaming form of :meth:`generate`: yields a ``StreamEvent`` per
        generated token as each batched decode step retires, then one
        ``done=True`` event per request (token=None)."""
        if burst > 1:
            raise NotImplementedError(_NOT_YET.format("burst decoding"))
        reqs = [
            Request(
                request_id=f"req{i}",
                prompt_tokens=list(p),
                max_new_tokens=max_new_tokens,
                eos_token=self.eos_token,
                sampling=sampling,
                want_logprobs=logprobs,
            )
            for i, p in enumerate(prompts)
        ]
        total_pages = self.pools.k[0].shape[1] - 1  # minus the null page
        for r in reqs:  # validate the WHOLE batch before submitting any
            need = -(-(len(r.prompt_tokens) + r.max_new_tokens) // self.page_size)
            if need > total_pages:
                raise MemoryError(
                    f"request {r.request_id!r} needs {need} pages but the pool "
                    f"only has {total_pages} — raise num_pages or shrink the request"
                )
            if need > self.pages_per_seq:
                raise ValueError(
                    f"request {r.request_id!r} needs {need} pages but page "
                    f"tables hold pages_per_seq={self.pages_per_seq} — raise "
                    "pages_per_seq (or page_size)"
                )
        for r in reqs:
            self.scheduler.submit(r)
        reported = {r.request_id: 0 for r in reqs}
        done = set()

        def drain():
            for r in reqs:
                while reported[r.request_id] < len(r.output_tokens):
                    i = reported[r.request_id]
                    lp = (r.output_logprobs[i]
                          if i < len(r.output_logprobs) else None)
                    reported[r.request_id] += 1
                    yield StreamEvent(r.request_id, r.output_tokens[i], False, lp)
                if r.finished and r.request_id not in done:
                    done.add(r.request_id)
                    yield StreamEvent(r.request_id, None, True)

        steps = 0
        while self.scheduler.has_work and steps < max_steps:
            self.scheduler.schedule()
            if not self.scheduler.active_slots:
                if self.scheduler.queue:
                    raise RuntimeError(
                        "scheduler deadlock: queued work but no active slots "
                        "and insufficient free pages"
                    )
                steps += 1
                continue
            self.step()
            steps += 1
            yield from drain()
        self.scheduler.schedule()  # final retirement
        yield from drain()
        for r in reqs:  # max_steps cutoff: close out unfinished requests
            if r.request_id not in done:
                done.add(r.request_id)
                yield StreamEvent(r.request_id, None, True)

    def generate_fused(self, *args, **kwargs):
        raise NotImplementedError(_NOT_YET.format("generate_fused"))

    def generate_speculative(self, *args, **kwargs):
        raise NotImplementedError(_NOT_YET.format("generate_speculative"))

    def generate_speculative_fused(self, *args, **kwargs):
        raise NotImplementedError(_NOT_YET.format("generate_speculative_fused"))
