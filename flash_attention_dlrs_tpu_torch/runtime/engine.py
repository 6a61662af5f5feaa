"""DecodeEngine, PyTorch port of ``flash_attention_dlrs_tpu/runtime/engine.py``.

Continuous-batching generation over the paged KV cache:
ContinuousBatchingScheduler (admission control) + a page allocator (page
accounting, shared across layers; the C++ one where it builds) +
models.decoding (dense prefill per admitted prompt and one batched decode
step per token) — greedy or seeded sampling, EOS/budget termination, slot
backfill at step boundaries.

Inactive slots decode against a reserved null page with length 0 (their
output is ignored), so the decode batch never changes shape.  KV pools may
be quantized (int8, int4, fp8), prompts may be prefilled in fixed chunks
through the multi-token verify step, and full-page prompt prefixes may be
shared through the prefix cache.  Bursts (:meth:`DecodeEngine.step_burst`,
``generate(burst=k)``, :meth:`~DecodeEngine.generate_fused`) run k decode
steps a dispatch and speculative serving (:meth:`~DecodeEngine.attach_draft`,
:meth:`~DecodeEngine.generate_speculative` and its fused form) whole rounds,
through ``runtime/speculative.py``: on the card each burst step and each
round is one CUDA graph, captured once and replayed.  The engine runs on
the card by default (``device="cuda"``) and on the CPU only when asked.
Sliding-window models are served past their window on a rolling KV ring,
full-attention models with StreamingLLM sinks on a sink + recent ring
(:func:`_ring`).

Tensor-parallel serving (``mesh``): every rank of the mesh builds the
engine with the same arguments and runs the same host scheduler, allocator
and page tables; it keeps its slice of the model (the training plan,
``models.train.shard_params``) and pools of its share of the kv heads, and
the model's all-reduces make every rank's logits, and so its tokens, the
same.  Under a mesh every step runs eagerly: no CUDA graph is captured
across a process group (gloo has no device-side collectives).
"""

from __future__ import annotations

import time
import warnings
import weakref
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import geometry as geo
from .._cuda import resolve_device
from ..models.decoding import (
    init_kv_pools,
    make_decode_step,
    make_prefill,
    make_verify_step,
    write_prompt_kv,
    write_prompt_kv_all,
    write_prompt_kv_batch,
)
from ..models.train import _check_tp_divisibility, shard_params
from ..models.transformer import ModelConfig, Transformer
from ..models.weights import params_from_jax, params_to_numpy
from .native_alloc import NativePageAllocator, make_page_allocator
from .prefix_cache import PrefixCache
from .sampling import GREEDY, SamplingParams, batch_params, sample_tokens
from .scheduler import ContinuousBatchingScheduler, Request
from .step_graph import EAGER
from .speculative import (
    make_draft_propose,
    make_plain_generate,
    make_spec_generate,
    make_verify_accept,
)

_NULL_SEQ = "__null__"


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


def _to_host(*tensors):
    """Device tensors (integers) to numpy in one transfer."""
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _samples(params_list) -> bool:
    """Whether any slot's SamplingParams (None: greedy) samples: the
    greedy-only programs skip the top-k / top-p sort."""
    return any(p is not None and p.temperature > 0 for p in params_list)


def _ring(cfg: ModelConfig, page_size: int, pages_per_seq: int,
          prefill_chunk: int, streaming_window: int, attention_sinks: int):
    """The ring a sequence's KV lives in: (rolling, streaming, wrap, sinks,
    pages_per_seq), with the JAX engine's refusals, classes and messages.

    Rolling: a uniformly sliding model whose page tables reach past its
    window (pages_per_seq·page_size > window) keeps each sequence's last
    ``window`` tokens in ``window // page_size`` pages, writing position p
    at slot p % window; the attention length is clamped to the window, and
    RoPE phases were applied at each token's true position on insert, so
    the ring's rotation never matters.  Streaming (StreamingLLM, for
    full-attention models): the first ``attention_sinks`` slots pin the
    first tokens, the ``streaming_window`` slots after them ring the most
    recent ones — an approximation once a sequence outgrows them."""
    window = int(cfg.window or 0)
    rolling = bool(window) and pages_per_seq * page_size > window
    if rolling:
        if cfg.position_encoding == "alibi":
            # The port's true ALiBi bias reads a cache index as a position,
            # which a rotated ring breaks.
            raise NotImplementedError(
                "rolling sliding-window serving does not support ALiBi "
                f"models — keep pages_per_seq*page_size <= {window}")
        if cfg.window_pattern != "all":
            raise NotImplementedError(
                f"window_pattern={cfg.window_pattern!r} (Gemma-2 style) mixes "
                "sliding and full layers; the shared-ring serving path "
                "supports uniformly-sliding models — keep "
                f"pages_per_seq*page_size <= {window} for exact "
                "full-residency serving")
        if window % page_size:
            raise ValueError(
                f"rolling sliding-window serving needs window "
                f"({window}) divisible by page_size ({page_size})")
        if prefill_chunk:
            raise NotImplementedError(
                "rolling sliding-window serving is incompatible with "
                "chunked prefill / speculative verification (tokens "
                "written in one multi-token step would overwrite slots "
                "earlier tokens of the same step must still attend)")
        pages_per_seq = window // page_size
    if streaming_window:
        if window:
            raise ValueError(
                "streaming_window is for full-attention models; "
                "sliding-window models get the exact rolling ring "
                "automatically")
        if streaming_window % page_size or attention_sinks % page_size:
            raise ValueError(
                f"streaming_window ({streaming_window}) and "
                f"attention_sinks ({attention_sinks}) must be "
                f"page_size ({page_size}) aligned")
        if prefill_chunk:
            raise NotImplementedError(
                "streaming eviction is incompatible with chunked "
                "prefill / speculative verification (multi-token "
                "writes overwrite slots earlier tokens still attend)")
        resident = attention_sinks + streaming_window
        if pages_per_seq * page_size < resident:
            raise ValueError(
                f"pages_per_seq*page_size ({pages_per_seq * page_size}) "
                f"is smaller than sinks+window ({resident})")
        return (False, True, streaming_window, attention_sinks,
                resident // page_size)
    if attention_sinks:
        raise ValueError("attention_sinks requires streaming_window > 0")
    if rolling:
        return True, False, window, 0, pages_per_seq
    return False, False, 0, 0, pages_per_seq


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
        pages_per_block: Optional[int] = None,
        prefill_chunk: int = 0,
        streaming_window: int = 0,
        attention_sinks: int = 0,
        enable_prefix_cache: bool = False,
        native_allocator: Optional[bool] = None,
        mesh=None,
        model_axis: str = "model",
        device="cuda",
    ):
        """``params`` is the port's model (models.weights.params_from_jax);
        it is moved to ``device`` if it lies elsewhere.  Pages are accounted
        by ``runtime.native_alloc.make_page_allocator(native=
        native_allocator)``: the C++ allocator where it builds (None), always
        (True: raises if it cannot be built or loaded) or never (False).

        ``quantized_kv`` stores K/V as ``kv_dtype`` payloads with per-token
        scales: ``torch.int8``, ``"int4"`` (two tokens per byte),
        ``torch.float8_e4m3fn`` or ``torch.float8_e5m2``.  fp8 KV is taken
        where the card converts fp8 natively (``geometry.supports_fast_fp8``:
        compute capability 8.9 and later, the H100 among them); elsewhere the
        engine warns and stores int8, as the JAX package does on TPUs
        without an fp8 datapath.  ``pages_per_block`` sets the pages of one
        key split of every paged decode and verify the engine runs (its
        steps, bursts, drafts and speculative rounds; a graph is captured
        with its split count fixed); None leaves them to the kernels'
        planner (``ops.decode.decode_splits``), and
        ``ops.decode.tuned_pages_per_block`` times the choices.
        ``prefill_chunk`` > 0 prefills
        every prompt in chunks of that many tokens through the verify step;
        ``enable_prefix_cache`` (which needs it) reuses the full-page
        prompt prefixes of earlier requests.

        A uniformly sliding model (``cfg.window``) whose page tables reach
        past its window is served on a rolling ring of ``window //
        page_size`` pages a sequence; ``streaming_window`` (with
        ``attention_sinks`` pinned first tokens) serves a full-attention
        model on a StreamingLLM ring (:func:`_ring`).

        ``mesh`` (a ``parallel.mesh.Mesh`` with a ``model_axis``): serve
        tensor-parallel; ``params`` is the whole model, of which this rank
        keeps its slice (or already a slice, made with the mesh)."""
        if mesh is not None:
            _check_tp_divisibility(cfg, mesh, model_axis)
        (self.rolling, self.streaming, self._wrap, self._sinks,
         pages_per_seq) = _ring(cfg, page_size, pages_per_seq, prefill_chunk,
                                streaming_window, attention_sinks)
        self.window = int(cfg.window or 0)
        if kv_dtype == "int4" and not quantized_kv:
            raise ValueError("kv_dtype='int4' requires quantized_kv=True")
        if enable_prefix_cache and not prefill_chunk:
            raise ValueError(
                "enable_prefix_cache requires prefill_chunk > 0 (the suffix "
                "prefill runs through the chunked path)")
        self.device = resolve_device(device)
        if (quantized_kv and kv_dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
                and not geo.supports_fast_fp8(geo.current_geometry(self.device))):
            warnings.warn(
                f"kv_dtype={kv_dtype} has no fp8 datapath on "
                f"{geo.current_geometry(self.device).device_name}: falling back to int8 "
                "KV.  Pass kv_dtype=torch.int8 explicitly to silence this.",
                stacklevel=2)
            kv_dtype = torch.int8
        if mesh is not None and params.tp is None:
            params = params_from_jax(
                shard_params(params_to_numpy(params), mesh, model_axis, cfg.n_kv_heads),
                cfg, device=self.device, mesh=mesh, model_axis=model_axis)
        self.params = params.to(self.device)
        self.mesh, self.model_axis = mesh, model_axis
        self.cfg = cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.num_slots = num_slots
        self.eos_token = eos_token
        self.kv_dtype = kv_dtype

        tp = 1 if mesh is None else mesh.size(model_axis)
        self.pools = init_kv_pools(cfg, num_pages=num_pages,
                                   page_size=page_size, dtype=kv_dtype,
                                   quantized=quantized_kv, device=self.device,
                                   num_kv_heads=cfg.n_kv_heads // tp)
        self.allocator = make_page_allocator(num_pages, page_size,
                                             native=native_allocator)
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
        self.pages_per_block = pages_per_block
        self._decode_step = make_decode_step(cfg, pages_per_block=pages_per_block)
        self._sample_cache_key = None
        self._sample_cache = None
        # Burst and speculative programs (runtime/speculative.py) by key,
        # and the memory pool their CUDA graphs share: dropped with the
        # engine.
        self._programs: Dict = {}
        self._graph_pool = None
        # Speculative serving (attach_draft): a draft engine mirroring this
        # engine's slots; step_burst then runs speculative rounds.
        self.spec_draft: Optional["DecodeEngine"] = None
        self.spec_gamma = 0
        self._draft_requests: Dict[int, Request] = {}
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.last_fused_seconds: Optional[float] = None
        self.prefill_chunk = prefill_chunk
        if prefill_chunk:
            self._chunk_prefill = make_verify_step(cfg, prefill_chunk,
                                                   pages_per_block=pages_per_block)
        self.prefix_cache = None
        if enable_prefix_cache:
            self.prefix_cache = PrefixCache(self.allocator, page_size)
            # the admission gate may free pages by evicting cache entries
            self.scheduler._can_allocate = self.prefix_cache.can_allocate

    # -- admission / retirement ------------------------------------------------

    def _can_admit(self, num_tokens: int) -> bool:
        """Scheduler admission gate: a ring allocates one resident set per
        sequence, whatever the request's length."""
        if self._wrap:
            num_tokens = min(num_tokens, self._sinks + self._wrap)
        return self.allocator.can_allocate(num_tokens)

    def _refuse_ring(self, message: str, *engines) -> None:
        if any(e._wrap for e in (self,) + engines):
            raise NotImplementedError(message)

    def attach_draft(self, draft: "DecodeEngine", gamma: int = 4) -> None:
        """Enable speculative continuous-batching serving: ``draft``
        mirrors every admission and retirement of this engine slot for slot
        (prompt prefill included), and :meth:`step_burst` switches from
        plain bursts to speculative rounds (draft steps → verify / accept →
        commit on the device, ``runtime.speculative.make_spec_generate``
        with per-slot budgets).  The draft conditions on the TARGET's
        committed stream: its own sampled tokens are proposals only, so
        outputs keep the target distribution (greedy output is identical
        to plain bursts).

        ``draft`` must share vocab and page size, have at least this
        engine's slots, and not be attached to anything itself.  Per-token
        logprobs are not produced under speculative serving (verification
        commits tokens, not per-step logits)."""
        if draft.page_size != self.page_size:
            raise ValueError("draft and target page sizes must match")
        if draft.num_slots < self.num_slots:
            raise ValueError("draft needs at least as many slots")
        self._refuse_ring(
            "speculative serving is incompatible with ring-based modes", draft)
        if gamma < 2:
            raise ValueError("gamma must be >= 2")
        self.spec_draft = draft
        self.spec_gamma = gamma

    def _mirror_admit(self, req: Request, slot: int) -> None:
        d = self.spec_draft
        d_req = Request(
            request_id=req.request_id,
            prompt_tokens=list(req.prompt_tokens),
            # + gamma: the draft's in-flight proposals overshoot the
            # committed prefix by up to gamma tokens
            max_new_tokens=req.max_new_tokens + self.spec_gamma,
            eos_token=d.eos_token,
        )
        d._admit(d_req, slot)
        # the draft conditions on the TARGET's committed stream
        d._slot_next_token[slot] = self._slot_next_token[slot]
        d.allocator.seq_lengths[req.request_id] = len(req.prompt_tokens)
        self._draft_requests[slot] = d_req

    def _admit(self, req: Request, slot: int) -> None:
        if not self._wrap:  # a ring holds any length in its resident set
            self._check_fits(req)
        if self.prefill_chunk:
            self._admit_chunked(req, slot)
        else:
            self._admit_dense(req, slot)
        if self.spec_draft is not None:
            self._mirror_admit(req, slot)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _overhang(self) -> int:
        """Speculative serving writes the verify window γ positions past
        the committed prefix: the cache needs that overhang even at a
        request's final length."""
        return self.spec_gamma if self.spec_draft is not None else 0

    def _check_fits(self, req: Request) -> None:
        need = -(-(len(req.prompt_tokens) + req.max_new_tokens + self._overhang())
                 // self.page_size)
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
        first = sample_tokens(logits, temp, top_k, top_p, seeds, lengths,
                              sample=_samples([req.sampling]))
        first_token = int(first[0])
        req.output_tokens.append(first_token)
        if req.want_logprobs:
            req.output_logprobs.append(float(_token_logprobs(logits, first)[0]))
        self.slot_request[slot] = req
        self._slot_next_token[slot] = first_token

    def _admit_dense(self, req: Request, slot: int) -> None:
        prompt = np.asarray(req.prompt_tokens, np.int64)
        t = len(prompt)
        resident = self._sinks + self._wrap
        self.allocator.allocate(
            req.request_id,
            resident if self._wrap else t + req.max_new_tokens + self._overhang())
        pages = np.asarray(self.allocator.page_tables[req.request_id], np.int64)

        toks = np.zeros((1, _next_pow2(t)), np.int64)
        toks[0, :t] = prompt
        lengths = np.asarray([t], np.int32)
        logits, kvs = self._prefill(self.params, self._to_device(toks),
                                    self._to_device(lengths))
        if self._wrap and t > resident:
            self._write_long_prompt(kvs, t, self._to_device(pages))
        else:
            n_pages_prompt = -(-t // self.page_size)
            write_prompt_kv_all(self.pools, kvs,
                                self._to_device(pages[:n_pages_prompt]),
                                self.page_size)
        self.allocator.seq_lengths[req.request_id] = t
        self._first_token(req, slot, logits[:1], t)

    def _write_long_prompt(self, kvs, t: int, pages) -> None:
        """A prompt longer than the ring's resident set: its first
        ``_sinks`` tokens pin in place and only its last ``_wrap`` tokens
        stay.  Position p >= sinks lives in slot sinks + (p − sinks) % wrap,
        so the last-wrap slice lands rolled by (t − sinks) % wrap: one roll
        lines the write up with whole pages (sinks are page-aligned)."""
        w, sk = self._wrap, self._sinks
        shift = (t - sk) % w
        with torch.inference_mode():
            for li, (k, v) in enumerate(kvs):
                kw, vw = (torch.cat([x[0, :, :sk], torch.roll(x[0, :, t - w:t], shift, dims=1)],
                                    dim=1) for x in (k, v))
                write_prompt_kv(self.pools, li, (kw, vw), pages, self.page_size)

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
        need = t + req.max_new_tokens + self._overhang()
        if self.prefix_cache is not None:
            shared_pages, cached_tokens = self.prefix_cache.match(req.prompt_tokens)
            self.prefix_cache.allocate_mixed_with_eviction(sid, shared_pages, need)
        else:
            self.allocator.allocate(sid, need)
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

    def _admit_batch(self, reqs: Sequence[Request], slots: Sequence[int]) -> None:
        """Admit a group of requests with ONE prefill, ONE batched KV write
        (``write_prompt_kv_batch``) and ONE read of the first tokens (the
        offline fixed-batch paths: generate_fused, generate_speculative*).
        Chunked prefill and the rings admit per request (their write paths
        are per sequence by construction)."""
        if self.prefill_chunk or self._wrap or len(reqs) == 1:
            for r, s in zip(reqs, slots):
                self._admit(r, s)
            return
        for r in reqs:
            self._check_fits(r)
        n = len(reqs)
        ts = [len(r.prompt_tokens) for r in reqs]
        toks = np.zeros((n, _next_pow2(max(ts))), np.int64)
        max_pages = max(-(-t // self.page_size) for t in ts)
        pages_b = np.full((n, max_pages), self._null_page, np.int64)
        for i, r in enumerate(reqs):
            toks[i, : ts[i]] = r.prompt_tokens
            self.allocator.allocate(
                r.request_id, ts[i] + r.max_new_tokens + self._overhang())
            npp = -(-ts[i] // self.page_size)
            pages_b[i, :npp] = self.allocator.page_tables[r.request_id][:npp]

        lengths = self._to_device(np.asarray(ts, np.int32))
        logits, kvs = self._prefill(self.params, self._to_device(toks), lengths)
        write_prompt_kv_batch(self.pools, kvs, self._to_device(pages_b),
                              self.page_size)
        sps = [r.sampling for r in reqs]
        temp, top_k, top_p, seeds = batch_params(sps, device=self.device)
        first_d = sample_tokens(logits, temp, top_k, top_p, seeds, lengths,
                                sample=_samples(sps))
        first = first_d.cpu().numpy()  # ONE read for the whole group
        lps = None
        if any(r.want_logprobs for r in reqs):
            lps = _token_logprobs(logits, first_d).cpu().numpy()
        for i, (r, slot) in enumerate(zip(reqs, slots)):
            self.allocator.seq_lengths[r.request_id] = ts[i]
            tok = int(first[i])
            r.output_tokens.append(tok)
            if r.want_logprobs:
                r.output_logprobs.append(float(lps[i]))
            self.slot_request[slot] = r
            self._slot_next_token[slot] = tok
            if self.spec_draft is not None:
                self._mirror_admit(r, slot)

    def _retire(self, req: Request, slot: int) -> None:
        self.allocator.free(req.request_id)
        self.slot_request[slot] = None
        if self.spec_draft is not None:
            d_req = self._draft_requests.pop(slot, None)
            if d_req is not None:
                self.spec_draft._retire(d_req, slot)

    # -- decode ----------------------------------------------------------------

    def _slot_sampling(self):
        """The slots' sampling tensors (temperature, top_k, top_p, seeds)
        and whether any slot samples; rebuilt only when the slots'
        requests change (at admission boundaries)."""
        cache_key = tuple(id(r) if r else None for r in self.slot_request)
        if self._sample_cache_key != cache_key:
            params = [r.sampling if r else None for r in self.slot_request]
            self._sample_cache = (batch_params(params, device=self.device),
                                  _samples(params))
            self._sample_cache_key = cache_key
        return self._sample_cache

    def _graphs(self):
        """The memory pool this engine's CUDA graphs share (None on the
        CPU, where nothing is captured; ``step_graph.EAGER`` under a mesh,
        where nothing is captured either)."""
        if self.mesh is not None:
            return EAGER
        if self._graph_pool is None and self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _program(self, key, make):
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = make()
        return program

    def _active(self):
        return [(i, r) for i, r in enumerate(self.slot_request)
                if r is not None and not r.finished]

    def step(self) -> int:
        """One batched decode step across all active slots; returns the number
        of tokens generated."""
        active = self._active()
        if not active:
            return 0
        if self.spec_draft is not None:
            # A plain step would commit a token the draft never saw (its
            # cache would hold a stale hole at that position): route
            # through a 1-token speculative burst instead.
            return self._step_burst_spec(active, 1)
        b = self.num_slots
        tokens = np.zeros(b, np.int64)
        positions = np.zeros(b, np.int64)
        rows = np.full(b, self._null_page, np.int64)
        offs = np.zeros(b, np.int64)
        tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
        lens = np.zeros(b, np.int32)

        sids = [req.request_id for _, req in active]
        rows_a, offs_a, tbl_a, pos_a, lens_a = (
            self.allocator.decode_step_bookkeeping(
                sids, self.pages_per_seq, self._wrap, self._sinks))
        if self._wrap:
            # attention covers the resident set: the sinks and the last
            # min(len − sinks, wrap) tokens; RoPE positions stay true
            lens_a = np.minimum(lens_a, self._sinks + self._wrap)
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
        (temp, top_k, top_p, seeds), sample = self._slot_sampling()
        next_dev = sample_tokens(logits, temp, top_k, top_p, seeds, lens_d,
                                 sample=sample)
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
        """Up to ``max_steps`` lockstep decode steps for the current active
        set in one program (``runtime.speculative.make_plain_generate`` with
        per-slot budgets; on the card one CUDA graph replayed a step);
        returns the number of tokens generated.

        The continuous-batching analogue of :meth:`generate_fused`:
        admission and retirement stay on the host (run the scheduler
        between bursts), the per-token loop does not.  Slots whose request
        budget ends mid-burst freeze in place (EOS freezes through the
        engine's eos token); the batch keeps lockstep.  Falls back to
        per-token :meth:`step` loops when a request wants logprobs (they
        need each step's logits on the host) and on a ring (its bookkeeping
        is per token, on the host): no graph is captured then."""
        active = self._active()
        if not active:
            return 0
        if self._wrap or any(r.want_logprobs for _, r in active):
            total = 0
            for _ in range(max_steps):
                got = self.step()
                if not got:
                    break
                total += got
                if any(r.finished for _, r in active):
                    break  # let the scheduler retire/admit between bursts
            return total
        if self.spec_draft is not None:
            return self._step_burst_spec(active, max_steps)

        b = self.num_slots
        k = max_steps
        x0 = np.zeros(b, np.int64)
        base_pos = np.zeros(b, np.int64)
        tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
        budget = np.zeros(b, np.int64)
        is_active = np.zeros(b, bool)
        for slot, req in active:
            sid = req.request_id
            x0[slot] = self._slot_next_token[slot]
            base_pos[slot] = self.allocator.seq_lengths[sid]
            tt = self.allocator.page_tables[sid]
            tbl[slot, : len(tt)] = tt
            budget[slot] = min(k, req.max_new_tokens - len(req.output_tokens))
            is_active[slot] = True

        fused = self._program(("burst", k), lambda: make_plain_generate(
            self.cfg, self.page_size, k, graph_pool=self._graphs(),
            pages_per_block=self.pages_per_block))
        (temp, top_k, top_p, seeds), sample = self._slot_sampling()
        out, n_out, self.pools = fused(
            self.params, self.pools, x0, base_pos, tbl, is_active, self._eos(),
            temp, top_k, top_p, seeds, budget, sample=sample)
        out, n_out = _to_host(out, n_out)  # one transfer, not two
        total = 0
        for slot, req in active:
            got = int(n_out[slot])
            if got == 0:
                continue
            toks = [int(t) for t in out[slot, :got]]
            req.output_tokens.extend(toks)
            self._slot_next_token[slot] = toks[-1]
            # K/V was written for each step's incoming token; the last
            # sampled token's K/V lands on the NEXT step, as in step()
            self.allocator.seq_lengths[req.request_id] = int(base_pos[slot]) + got
            total += got
        self.scheduler.record_step(total)
        return total

    def _eos(self) -> int:
        return -1 if self.eos_token is None else int(self.eos_token)

    def _step_burst_spec(self, active, max_steps: int) -> int:
        """Speculative continuous-batching burst: up to ``max_steps``
        committed tokens a slot, every draft / verify / accept / commit
        round in one program (``runtime.speculative.make_spec_generate``
        with per-slot budgets; on the card one CUDA graph replayed a round).
        Admission and retirement stay on the host between bursts, as in the
        plain burst; the attached draft's cache tracks the target's
        committed prefix (its in-flight overshoot rolled back by length
        bookkeeping)."""
        d = self.spec_draft
        gamma = self.spec_gamma
        b = self.num_slots
        k = max_steps
        x0 = np.zeros(b, np.int64)
        base_pos = np.zeros(b, np.int64)
        budget = np.zeros(b, np.int64)
        is_active = np.zeros(b, bool)
        t_tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
        d_tbl = np.full((b, d.pages_per_seq), d._null_page, np.int32)
        for slot, req in active:
            sid = req.request_id
            x0[slot] = self._slot_next_token[slot]
            base = self.allocator.seq_lengths[sid]
            base_pos[slot] = base
            budget[slot] = max(0, min(k, req.max_new_tokens - len(req.output_tokens)))
            is_active[slot] = True
            # the draft overshoots its committed prefix by up to gamma
            # in-flight proposals; both caches need the headroom
            self.allocator.ensure_capacity(sid, base + budget[slot] + gamma)
            d.allocator.ensure_capacity(sid, base + budget[slot] + gamma)
            d.allocator.seq_lengths[sid] = base
            tt = self.allocator.page_tables[sid]
            t_tbl[slot, : len(tt)] = tt
            dt = d.allocator.page_tables[sid]
            d_tbl[slot, : len(dt)] = dt

        fused = self._spec_program(("specburst", gamma, k), d, gamma, k)
        (temp, top_k, top_p, seeds), sample = self._slot_sampling()
        out, cnt, rounds, proposed, accepted, self.pools, d.pools = fused(
            self.params, self.pools, d.params, d.pools, x0, base_pos, t_tbl,
            d_tbl, is_active, self._eos(), temp, top_k, top_p, seeds, budget,
            sample=sample)
        out, cnt, rounds, proposed, accepted = _to_host(
            out, cnt, rounds, proposed, accepted)  # ONE transfer
        self.spec_stats["rounds"] += int(rounds)
        self.spec_stats["proposed"] += int(proposed)
        self.spec_stats["accepted"] += int(accepted)
        total = 0
        for slot, req in active:
            got = int(cnt[slot])
            if got == 0:
                continue
            toks = [int(t) for t in out[slot, :got]]
            req.output_tokens.extend(toks)
            self._slot_next_token[slot] = toks[-1]
            final = int(base_pos[slot]) + got
            self.allocator.seq_lengths[req.request_id] = final
            d.allocator.seq_lengths[req.request_id] = final
            total += got
        self.scheduler.record_step(total)
        return total

    def _spec_program(self, key, draft, gamma: int, max_new: int):
        """The speculative program of ``key`` for ``draft``, held with the
        draft by weakref: a program built for a dead engine's pools must
        never serve a new one whose id happens to match."""
        cached = self._programs.get(key)
        if cached is not None and cached[0]() is draft:
            return cached[1]
        fused = make_spec_generate(self.cfg, draft.cfg, gamma, self.page_size,
                                   max_new, graph_pool=self._graphs(),
                                   t_pages_per_block=self.pages_per_block,
                                   d_pages_per_block=draft.pages_per_block)
        self._programs[key] = (weakref.ref(draft), fused)
        return fused

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
            "rolling_window": self.window if self.rolling else 0,
            "streaming_window": self._wrap if self.streaming else 0,
            "attention_sinks": self._sinks,
            "kv_dtype": str(self.kv_dtype),
            "allocator": ("native" if isinstance(self.allocator, NativePageAllocator)
                          else "python"),
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
        (tokens, logprobs) — per-token log P_model(token | prefix).
        ``burst`` > 1 decodes through :meth:`step_burst`."""
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
        generated token as each batched decode step (or burst) retires,
        then one ``done=True`` event per request (token=None)."""
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
            need = ((self._sinks + self._wrap) // self.page_size if self._wrap
                    else -(-(len(r.prompt_tokens) + r.max_new_tokens) // self.page_size))
            if need > total_pages:
                raise MemoryError(
                    f"request {r.request_id!r} needs {need} pages but the pool "
                    f"only has {total_pages} — raise num_pages or shrink the request"
                )
            if not self._wrap and need > self.pages_per_seq:
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
            if burst > 1:
                self.step_burst(burst)
            else:
                self.step()
            steps += 1
            yield from drain()
        self.scheduler.schedule()  # final retirement
        yield from drain()
        for r in reqs:  # max_steps cutoff: close out unfinished requests
            if r.request_id not in done:
                done.add(r.request_id)
                yield StreamEvent(r.request_id, None, True)

    # -- speculative decoding ---------------------------------------------------

    def _single_decode_logits(self, sids, tokens_np):
        """One batched decode step for explicit (sid, token) pairs occupying
        slots 0..len(sids)−1; inserts the tokens' K/V and returns the raw
        next-token logits [num_slots, vocab]."""
        b = self.num_slots
        tokens = np.zeros(b, np.int64)
        positions = np.zeros(b, np.int64)
        rows = np.full(b, self._null_page, np.int64)
        offs = np.zeros(b, np.int64)
        tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
        lens = np.zeros(b, np.int32)
        for slot, (sid, tok) in enumerate(zip(sids, tokens_np)):
            pos = self.allocator.seq_lengths[sid]
            self.allocator.ensure_capacity(sid, pos + 1)
            table = self.allocator.page_tables[sid]
            tokens[slot] = tok
            positions[slot] = pos
            rows[slot] = table[pos // self.page_size]
            offs[slot] = pos % self.page_size
            tbl[slot, : len(table)] = table
            lens[slot] = pos + 1
            self.allocator.seq_lengths[sid] = pos + 1
        logits, self.pools = self._decode_step(
            self.params, self.pools,
            self._to_device(tokens), self._to_device(positions),
            self._to_device(rows), self._to_device(offs),
            self._to_device(tbl), self._to_device(lens),
        )
        return logits

    def _single_decode(self, sids, tokens_np):
        """Greedy form of :meth:`_single_decode_logits`."""
        return torch.argmax(self._single_decode_logits(sids, tokens_np),
                            dim=-1).cpu().numpy()

    def _check_spec(self, n: int, draft: "DecodeEngine", gamma: int) -> None:
        if n > self.num_slots or n > draft.num_slots:
            raise ValueError(
                f"{n} prompts exceed slots (target {self.num_slots}, "
                f"draft {draft.num_slots})"
            )
        if draft.page_size != self.page_size:
            raise ValueError("draft and target page sizes must match")
        if gamma < 2:
            raise ValueError("gamma must be >= 2 (draft proposes gamma-1)")

    def _lockstep_admit(self, prompts, prefix: str, max_new_tokens: int, sp,
                        draft=None):
        """Admit every prompt at once into slots 0..n−1 (bypassing the
        scheduler: fixed batch, lockstep) on this engine and on ``draft``;
        returns (target requests, draft requests)."""
        def requests(sampling):
            return [Request(request_id=f"{prefix}{i}", prompt_tokens=list(p),
                            max_new_tokens=max_new_tokens,
                            eos_token=self.eos_token, sampling=sampling)
                    for i, p in enumerate(prompts)]

        reqs = requests(sp)
        slots = list(range(len(prompts)))
        self._admit_batch(reqs, slots)
        d_reqs = None
        if draft is not None:
            d_reqs = requests(None)
            draft._admit_batch(d_reqs, slots)
        return reqs, d_reqs

    def generate_speculative(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        draft: "DecodeEngine",
        gamma: int = 4,
        max_new_tokens: int = 16,
        max_rounds: int = 10_000,
        sampling: Optional[SamplingParams] = None,
    ) -> List[List[int]]:
        """Speculative decoding, the host-loop form: the ``draft`` engine
        proposes ``gamma``−1 tokens a round (one eager program,
        ``runtime.speculative.make_draft_propose``), this (target) engine
        verifies them in ONE multi-token step and commits the accepted
        prefix plus a correction / bonus token (``make_verify_accept``);
        the host does the page bookkeeping between rounds.

        Greedy (``sampling`` None or temperature 0): output is IDENTICAL to
        plain greedy ``generate`` whatever the draft; only the round count
        changes.  temperature > 0 uses rejection sampling
        (``runtime.sampling.speculative_verify``), so the output's
        distribution is plain sampling's from the target.

        Both engines must share vocab and page size and have slots for all
        prompts (no mid-flight admission in this mode)."""
        n = len(prompts)
        self._check_spec(n, draft, gamma)
        self._refuse_ring(
            "speculative decoding is incompatible with ring-based "
            "serving (rolling window / streaming eviction): multi-token "
            "verification would overwrite ring slots its own earlier "
            "tokens still attend", draft)
        cached = self._programs.get(gamma)
        if cached is not None and cached[0]() is draft:
            propose, verify_accept = cached[1]
        else:
            propose = make_draft_propose(draft.cfg, gamma, draft.page_size,
                                         pages_per_block=draft.pages_per_block)
            verify_accept = make_verify_accept(self.cfg, gamma,
                                               pages_per_block=self.pages_per_block)
            self._programs[gamma] = (weakref.ref(draft), (propose, verify_accept))
        sp = sampling or GREEDY
        b = self.num_slots
        temp, top_k, top_p, seeds = batch_params([sp] * n + [None] * (b - n),
                                                 device=self.device)
        sample = _samples([sp])

        reqs, d_reqs = self._lockstep_admit(prompts, "spec", max_new_tokens, sp, draft)
        for slot, r in enumerate(reqs):
            # the draft conditions on the TARGET's committed stream
            draft._slot_next_token[slot] = r.output_tokens[0]
        sids = [r.request_id for r in reqs]
        outputs = [[r.output_tokens[0]] for r in reqs]
        # acceptance telemetry: rounds run, proposals offered, proposals
        # accepted (committed minus the round's correction / bonus token)
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0}

        for _ in range(max_rounds):
            live = [
                i for i in range(n)
                if len(outputs[i]) < max_new_tokens and not (
                    self.eos_token is not None and outputs[i][-1] == self.eos_token)
            ]
            if not live:
                break
            x0 = np.zeros(b, np.int64)
            x0[:n] = [outputs[i][-1] for i in range(n)]  # last committed token
            base_pos_d = np.zeros(b, np.int64)
            base_pos_d[:n] = [draft.allocator.seq_lengths[s] for s in sids]

            # the draft proposes gamma−1 tokens (and writes the last one's K/V)
            d_tbl = np.full((b, draft.pages_per_seq), draft._null_page, np.int32)
            for slot in range(n):
                sid, base = sids[slot], int(base_pos_d[slot])
                draft.allocator.ensure_capacity(sid, base + gamma)
                table = draft.allocator.page_tables[sid]
                d_tbl[slot, : len(table)] = table
                draft.allocator.seq_lengths[sid] = base + gamma
            props, draft_logits, draft.pools = propose(
                draft.params, draft.pools, draft._to_device(x0),
                draft._to_device(base_pos_d), draft._to_device(d_tbl),
                temp, top_k, top_p, seeds, sample=sample)

            # the target verifies and accepts / resamples
            positions = np.zeros((b, gamma), np.int64)
            rows = np.full((b, gamma), self._null_page, np.int64)
            offs = np.zeros((b, gamma), np.int64)
            tbl = np.full((b, self.pages_per_seq), self._null_page, np.int32)
            lens = np.zeros(b, np.int32)
            base_pos = np.zeros(b, np.int64)
            for slot in range(n):
                sid = sids[slot]
                p0 = self.allocator.seq_lengths[sid]
                base_pos[slot] = p0
                self.allocator.ensure_capacity(sid, p0 + gamma)
                table = np.asarray(self.allocator.page_tables[sid], np.int64)
                pos = p0 + np.arange(gamma)
                positions[slot] = pos
                rows[slot] = table[pos // self.page_size]
                offs[slot] = pos % self.page_size
                tbl[slot, : len(table)] = table
                lens[slot] = p0 + gamma
            round_tokens, n_committed, self.pools = verify_accept(
                self.params, self.pools, props, self._to_device(positions),
                self._to_device(rows), self._to_device(offs),
                self._to_device(tbl), self._to_device(lens), draft_logits,
                temp, top_k, top_p, seeds, self._to_device(base_pos),
                sample=sample)
            round_tokens, n_committed = _to_host(round_tokens, n_committed)
            self.spec_stats["rounds"] += 1
            self.spec_stats["proposed"] += len(live) * (gamma - 1)
            self.spec_stats["accepted"] += int(sum(n_committed[s] - 1 for s in live))

            for slot in live:
                sid = sids[slot]
                m = int(n_committed[slot]) - 1  # accepted proposals
                budget = max_new_tokens - len(outputs[slot])
                for tok in round_tokens[slot, : m + 1][:budget]:
                    outputs[slot].append(int(tok))
                    if self.eos_token is not None and tok == self.eos_token:
                        break
                # the cache holds x0, d1..d_m as its valid prefix (m+1 tokens)
                self.allocator.seq_lengths[sid] = int(base_pos[slot]) + 1 + m
                draft.allocator.seq_lengths[sid] = int(base_pos[slot]) + 1 + m
            for slot in set(range(n)) - set(live):
                # finished slots still ride the fixed-shape draft calls
                # (which advance their lengths by gamma a round): roll them
                # back so their page tables never grow
                draft.allocator.seq_lengths[sids[slot]] = int(base_pos_d[slot])

        for slot in range(n):
            self._retire(reqs[slot], slot)
            draft._retire(d_reqs[slot], slot)
        return outputs

    def _lockstep_tables(self, sids, extra: int, outputs, max_new: int, engines):
        """x0, base positions and each engine's page tables of a lockstep
        batch, every sequence's capacity ensured for its final length plus
        ``extra`` on each engine (nothing inside the program can allocate)."""
        b = self.num_slots
        x0 = np.zeros(b, np.int64)
        base_pos = np.zeros(b, np.int64)
        tables = [np.full((b, e.pages_per_seq), e._null_page, np.int32)
                  for e in engines]
        for slot, sid in enumerate(sids):
            x0[slot] = outputs[slot][0]
            base = self.allocator.seq_lengths[sid]
            base_pos[slot] = base
            for e, tbl in zip(engines, tables):
                e.allocator.ensure_capacity(sid, base + max_new + extra)
                table = e.allocator.page_tables[sid]
                tbl[slot, : len(table)] = table
        return x0, base_pos, tables

    def generate_speculative_fused(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        draft: "DecodeEngine",
        gamma: int = 4,
        max_new_tokens: int = 16,
        sampling: Optional[SamplingParams] = None,
    ) -> List[List[int]]:
        """Speculative decoding with every round in one program
        (``runtime.speculative.make_spec_generate``; on the card a CUDA
        graph replayed a round): page capacity for the final lengths is
        ensured up front, the draft / verify / commit loop runs on the
        device, and the host reads one flag a round and the tokens once.
        Same outputs as :meth:`generate_speculative`; lockstep fixed batch
        (no mid-flight admission)."""
        n = len(prompts)
        self._check_spec(n, draft, gamma)
        self._refuse_ring(
            "speculative decoding is incompatible with ring-based "
            "serving modes", draft)
        b = self.num_slots
        sp = sampling or GREEDY
        temp, top_k, top_p, seeds = batch_params([sp] * n + [None] * (b - n),
                                                 device=self.device)
        reqs, d_reqs = self._lockstep_admit(prompts, "specf", max_new_tokens, sp, draft)
        sids = [r.request_id for r in reqs]
        outputs = [[r.output_tokens[0]] for r in reqs]
        max_new = max_new_tokens - 1  # the first token came from prefill
        if max_new > 0:
            x0, base_pos, (t_tbl, d_tbl) = self._lockstep_tables(
                sids, gamma, outputs, max_new, (self, draft))
            fused = self._spec_program(("fused", gamma, max_new), draft, gamma, max_new)
            active = np.arange(b) < n
            t0 = time.perf_counter()
            out, cnt, rounds, proposed, accepted, self.pools, draft.pools = fused(
                self.params, self.pools, draft.params, draft.pools, x0, base_pos,
                t_tbl, d_tbl, active, self._eos(), temp, top_k, top_p, seeds,
                np.full(b, max_new), sample=_samples([sp]))
            out, cnt, rounds, proposed, accepted = _to_host(
                out, cnt, rounds, proposed, accepted)  # one transfer, not 5
            # the program's wall time (admission and prefill excluded)
            self.last_fused_seconds = time.perf_counter() - t0
            self.spec_stats = {"rounds": int(rounds), "proposed": int(proposed),
                               "accepted": int(accepted)}
            for slot in range(n):
                outputs[slot].extend(int(t) for t in out[slot, : cnt[slot]])
                final = int(base_pos[slot]) + int(cnt[slot])
                self.allocator.seq_lengths[sids[slot]] = final
                draft.allocator.seq_lengths[sids[slot]] = final
        for slot in range(n):
            self._retire(reqs[slot], slot)
            draft._retire(d_reqs[slot], slot)
        return outputs

    def generate_fused(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int = 16,
        sampling: Optional[SamplingParams] = None,
    ) -> List[List[int]]:
        """Plain generation with the whole decode loop in one program
        (``runtime.speculative.make_plain_generate``; on the card a CUDA
        graph replayed a step): the baseline of
        :meth:`generate_speculative_fused` and the lockstep offline path."""
        n = len(prompts)
        if n > self.num_slots:
            raise ValueError("prompts exceed slots")
        self._refuse_ring("fused generation does not support ring-based serving")
        b = self.num_slots
        sp = sampling or GREEDY
        temp, top_k, top_p, seeds = batch_params([sp] * n + [None] * (b - n),
                                                 device=self.device)
        reqs, _ = self._lockstep_admit(prompts, "plainf", max_new_tokens, sp)
        sids = [r.request_id for r in reqs]
        outputs = [[r.output_tokens[0]] for r in reqs]
        max_new = max_new_tokens - 1
        if max_new > 0:
            x0, base_pos, (tbl,) = self._lockstep_tables(sids, 0, outputs, max_new, (self,))
            fused = self._program(("plain_fused", max_new), lambda: make_plain_generate(
                self.cfg, self.page_size, max_new, graph_pool=self._graphs(),
                pages_per_block=self.pages_per_block))
            active = np.arange(b) < n
            t0 = time.perf_counter()
            out, n_out, self.pools = fused(
                self.params, self.pools, x0, base_pos, tbl, active, self._eos(),
                temp, top_k, top_p, seeds, np.full(b, max_new),
                sample=_samples([sp]))
            out, n_out = _to_host(out, n_out)  # one transfer
            self.last_fused_seconds = time.perf_counter() - t0
            for slot in range(n):
                outputs[slot].extend(int(t) for t in out[slot, : n_out[slot]])
                self.allocator.seq_lengths[sids[slot]] = (
                    int(base_pos[slot]) + int(n_out[slot]))
        for slot in range(n):
            self._retire(reqs[slot], slot)
        return outputs
