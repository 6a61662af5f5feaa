"""Continuous-batching scheduler: admission + retirement around a fixed
decode batch.  A copy of ``flash_attention_dlrs_tpu/runtime/scheduler.py``
(pure Python), kept in the port so that it imports nothing of the JAX
package.

The control plane is host-side Python: the device-side decode step runs with
static shapes (batch slots, max pages per sequence); the scheduler's job is
to keep those slots full.

Model: requests arrive with a prompt and a token budget; the scheduler
 - admits them into free slots when the KV cache has pages for the prompt,
 - tracks per-slot state across decode steps,
 - retires finished sequences (budget exhausted or EOS), frees their pages,
   and backfills the slot on the next step boundary.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_tokens: list
    max_new_tokens: int
    eos_token: Optional[int] = None
    sampling: Optional[object] = None  # runtime.sampling.SamplingParams
    state: RequestState = RequestState.QUEUED
    output_tokens: list = dataclasses.field(default_factory=list)
    # log P_target(token | prefix) per generated token (natural log), kept
    # in lockstep with output_tokens by the engine's standard decode path
    # WHEN want_logprobs is set (skipping it avoids a full-vocab
    # log-softmax + an extra host transfer per decode step).
    want_logprobs: bool = False
    output_logprobs: list = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        if len(self.output_tokens) >= self.max_new_tokens:
            return True
        return bool(
            self.eos_token is not None
            and self.output_tokens
            and self.output_tokens[-1] == self.eos_token
        )


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    retired: int = 0
    steps: int = 0
    tokens_generated: int = 0


class ContinuousBatchingScheduler:
    """Keeps `num_slots` decode lanes full from a FIFO request queue."""

    def __init__(
        self,
        *,
        num_slots: int,
        can_allocate: Callable[[int], bool],
        on_admit: Callable[[Request, int], None],
        on_retire: Callable[[Request, int], None],
    ):
        self.num_slots = num_slots
        self.queue: deque = deque()
        self.slots: list = [None] * num_slots  # slot -> Request | None
        self._can_allocate = can_allocate
        self._on_admit = on_admit
        self._on_retire = on_retire
        self.stats = SchedulerStats()

    # -- API -----------------------------------------------------------------

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    @property
    def active_slots(self) -> list:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def schedule(self) -> list:
        """Retire finished, admit queued; returns newly admitted (req, slot)."""
        admitted = []
        for i, req in enumerate(self.slots):
            if req is not None and req.finished:
                req.state = RequestState.DONE
                self._on_retire(req, i)
                self.slots[i] = None
                self.stats.retired += 1
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                nxt = self.queue[0]
                if not self._can_allocate(len(nxt.prompt_tokens) + nxt.max_new_tokens):
                    break  # FIFO: wait for pages rather than starving the head
                self.queue.popleft()
                nxt.state = RequestState.PREFILL
                self.slots[i] = nxt
                try:
                    self._on_admit(nxt, i)
                except MemoryError:
                    # Admission gate said yes but the allocator disagreed
                    # (e.g. evictable pages pinned by a matched prefix).
                    # Allocation is atomic on failure, so defer the request
                    # instead of crashing the engine.
                    self.slots[i] = None
                    nxt.state = RequestState.QUEUED
                    self.queue.appendleft(nxt)
                    break
                admitted.append((nxt, i))
                self.stats.admitted += 1
        return admitted

    def record_step(self, tokens: int) -> None:
        self.stats.steps += 1
        self.stats.tokens_generated += tokens
