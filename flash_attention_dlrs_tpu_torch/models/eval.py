"""Perplexity evaluation, PyTorch port of ``flash_attention_dlrs_tpu/models/eval.py``:
dense (the training path) and paged (the serving path, value or quantized KV).

The accuracy gate for quantized KV is int8 KV within 0.1 perplexity of
bf16 (``BASELINE.md``).  :func:`perplexity_paged` runs the serving
machinery itself — a prefill of the first token, then teacher-forced decode
steps over the paged pool, the new token's K/V quantized on write — so the
measured gap is exactly what quantization costs the serving path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._cuda import resolve_device
from ..runtime.kv_cache import PageAllocator
from ..runtime.step_graph import StepGraph
from .decoding import init_kv_pools, make_decode_step, make_prefill, write_prompt_kv_batch
from .transformer import ModelConfig, Transformer, forward


def _nll(logits, targets):
    """−log softmax(logits) at ``targets``, fp32: logits [..., V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _tokens(tokens, device) -> torch.Tensor:
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.array(tokens, np.int64))
    return tokens.to(device).long()


@torch.no_grad()
def perplexity_dense(model: Transformer, cfg: ModelConfig, tokens) -> float:
    """Teacher-forced perplexity of ``tokens`` [B, T] (a tensor or an array)
    through the dense causal forward, on the model's device."""
    tokens = _tokens(tokens, model.embed.device)
    logits = forward(model, tokens[:, :-1], cfg)
    return float(torch.exp(torch.mean(_nll(logits, tokens[:, 1:]))))


@torch.no_grad()
def perplexity_paged(
    model: Transformer,
    cfg: ModelConfig,
    tokens,  # [B, T]
    *,
    kv_dtype=torch.bfloat16,
    quantized: bool = False,
    page_size: int = 128,
    num_pages: Optional[int] = None,
    device="cuda",
) -> float:
    """Teacher-forced perplexity through the serving path: prefill the first
    token (padded to one page), then decode-step through the sequence
    against a paged pool of ``kv_dtype`` (``quantized``: int8, ``"int4"``,
    e4m3 or e5m2 payloads with per-token scales).  Runs on the card unless
    ``device`` says otherwise; the model is moved there.  The decode step
    runs over static buffers and reads its position on the device, so that
    on the card it is captured once into a CUDA graph
    (:class:`..runtime.step_graph.StepGraph`) and replayed a token; on the
    CPU it runs eagerly."""
    device = resolve_device(device)
    model = model.to(device)
    tokens = _tokens(tokens, device)
    b, t = tokens.shape
    pages_per_seq = -(-t // page_size)
    if num_pages is None:
        num_pages = b * pages_per_seq + 1
    pools = init_kv_pools(cfg, num_pages=num_pages, page_size=page_size,
                          dtype=kv_dtype, quantized=quantized, device=device)
    alloc = PageAllocator(num_pages, page_size)
    for row in range(b):
        alloc.allocate(row, t)
    tables = alloc.page_indices_for(range(b), pages_per_seq)
    tbl = torch.from_numpy(tables).to(device)
    prefill, decode_step = make_prefill(cfg), make_decode_step(cfg)

    # The prefill writes a whole page; only position 0 is valid (the
    # lengths mask the rest), and the decode steps overwrite it in turn.
    first = torch.nn.functional.pad(tokens[:, :1], (0, page_size - 1))
    logits0, kvs = prefill(model, first, torch.ones(b, dtype=torch.int32, device=device))
    write_prompt_kv_batch(pools, kvs, tbl[:, :1], page_size)
    nll_sum = _nll(logits0, tokens[:, 1])

    # One teacher-forced step over static buffers, its position on the
    # device: the loop replays it (a CUDA graph on the card, StepGraph).
    pos = torch.ones((1,), dtype=torch.long, device=device)
    rows_all = tbl.long()

    def step():
        here = pos.expand(b)
        logits, _ = decode_step(
            model, pools, tokens.index_select(1, pos)[:, 0], here.int(),
            rows_all.gather(1, (pos // page_size).expand(b, 1))[:, 0],
            (here % page_size).int(), tbl, (here + 1).int())
        nll_sum.add_(_nll(logits, tokens.index_select(1, pos + 1)[:, 0]))
        pos.add_(1)

    replay = StepGraph(step, device)
    for _ in range(1, t - 1):
        replay()
    return float(torch.exp(torch.mean(nll_sum / (t - 1))))
