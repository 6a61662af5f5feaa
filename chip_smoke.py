#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flash_attention_dlrs_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from csrc/ with nvcc (printing the registers,
spills and serialization warnings of the wgmma instances of the forward and
of the backward sweeps, and the registers, shared memory, spills and
warnings of every paged instance, and of every instance of the wide
builds, none of which may spill, the wide_wgmma ones of two owners at 168
registers), and beside them four broken copies of the dK/dV sweep (two at
head dim 256), two of the paged kernels (a decode merge that drops the
last key split, a verify that leaves a horizon-crossing tile unmasked),
two of the 16-bit wide forward (S summed without the last owner's
partial score, or with an owner's own partial in place of its peers'),
two of the 16-bit wide sweeps (dP summed without the last owner's
partial, or S with an owner's own partial in place of its peers'), one
of the column-chunked fp32 forward (S summed without the head dim's last
streamed slice) and two of route wide_scores' forward (a score pass that
drops the head dim's last slice, a product pass that drops the last key
tile);
holds each kernel (and each ALiBi / dropout / segment-id / fp8-V mode, each
route of the forward, of the backward sweeps and of verify: wgmma, fp32,
and the paged kernels at their key-split and tile edges) against its plain
PyTorch version on the card (the backward and paged kernels also against
themselves, bit for bit), checks that each broken copy fails that check,
and reads the forward kernel's dropout mask back against the plain mask.
Then drives every path of the port:

- serving: 8 requests through DecodeEngine at the full width of the repo's
  serving-bench model (scripts/bench_serving.py defaults: 16 layers,
  d_model 2048, 16 q / 8 kv heads, head_dim 128, d_ff 5504, vocab 32000,
  bf16, random weights from a seed);
- quantized serving (serve_quant): the same model from int8 KV at the
  serving bench's two batches (8 slots x 64 new tokens, 32 slots x 16) and
  from int4 / e4m3 / e5m2 / bf16 KV at 8 slots x 16, 2048-token prompts;
- chunked serving (serve_chunked): bf16 and int8 KV with prefill_chunk=256
  and the prefix cache, 8 requests sharing a 1024-token system prompt;
- ALiBi serving (serve_alibi): the serving model with
  position_encoding="alibi", bf16 KV at 4 slots x 32 new tokens, int8 KV at
  8 x 16, and bf16 KV with prefill_chunk=256 and the prefix cache;
- bursts (serve_burst): the serving requests at 4 slots through
  generate(burst=8), each burst step one replay of a CUDA graph, against
  the eager step in the order eager, graph, graph, eager (ms per step and
  per generated token), one step's logits graphed against eager, the
  graphed burst's device-busy share, a seeded burst against eager steps,
  and generate_fused at 8 slots against generate;
- speculative serving (serve_spec): attach_draft with gamma 4 and bursts
  of 8 (each round one replay of a CUDA graph), with the perfect draft
  (the target's weights) and a 2-layer independent draft on bf16 KV and
  the independent draft on int8 KV, tokens against plain greedy (bf16
  paths may part only at near-ties; a 2-layer fp32 copy exactly),
  acceptance and tokens/s, generate_speculative_fused at 8 slots, and
  verify at a round's shape;
- training: make_train_state / make_train_step on the repo's training-bench
  model (scripts/bench_train.py:68-74: the b7 widths, d_model 4096, 32 q /
  8 kv heads, head_dim 128, d_ff 11008, vocab 32000, 8 layers, bf16, block
  remat) at batch 8, sequence 2048, for 1 warm and 3 timed steps plus a
  profiled and a recorded one;
- ALiBi training (train_alibi): the same model with
  position_encoding="alibi" and attn_dropout=0.1, step i seeded with i;
- packed sequences (packed): the training-bench model's attention shape
  (B8, N2048, 32 q / 8 kv heads, head_dim 128, bf16) through the op API
  with a packed loader's segment ids and with SegmentIds(q, kv) of
  different lengths, through nn.dot_product_attention on padded batches,
  forward and backward, and fp8 V through the op API; then the same at
  Gemma-2-2B's attention shape (B2, N8192, 8 q / 4 kv heads of 256), with
  ALiBi and ALiBi + dropout besides;
- Gemma-2-2B (serve_gemma2): the published google/gemma-2-2b config at
  full width and depth (26 layers, head_dim 256, softcaps, a 4096 window
  on even layers), imported by import_hf_gemma from a random HF-named
  state dict and a SimpleNamespace config, served from bf16 KV at 4 slots
  (eager, then graphed bursts of 8: equal tokens), int8 KV at 8 slots and
  with chunked prefill and the prefix cache; a dense 8192-token forward; a
  2-layer fp32 copy;
- model variants (variants): Llama-3.1-8B, Qwen2-7B (YaRN, QKV biases),
  the same in weight-only int8 and Phi-3-mini-4k (head_dim 96, a 2047
  window) at their published widths and 4 layers, through their importers,
  eager and graphed with equal tokens, and 2-layer fp32 copies;
- ALiBi at head dim 256 (serve_alibi_d256): Gemma-2-2B's attention widths
  with position_encoding="alibi", 4 layers, served as serve_alibi serves
  (bf16 and int8 KV, chunked with the prefix cache);
- Gemma-2-2B trained (train_gemma2): the published config at full width
  and depth from random HF-named weights through import_hf_gemma, B2 x
  N8192 (its window bites), block remat, AdamW: ms/step, tokens/s, MFU,
  peak, exact launches of the head-dim-256 kernels (csrc/attn_*_d256.cu),
  the LM head in fp32 against half-precision operands, a windowed and a
  global layer's attention against the plain versions, a 2-layer fp32 copy;
  then the same weights under remat_policy="save_flash" and with the
  blockwise-int8 AdamW; and again under attn_dropout=0.1
  (train_gemma2_dropout: 1 warm and 2 timed steps, the d256 dropout
  kernels' launches exact, a windowed and a global layer and a 2-layer fp32
  copy against the plain path);
- the remat policies (remat): block, save_flash, save_dots and
  save_matmuls on the training-bench model (ms/step, peak, launches) and
  their 2-layer fp32 copies, bitwise equal;
- the bf16 projections' reduction (bf16_reduction): torch.matmul with
  PyTorch's reduced-precision bf16 reduction allowed and not, at the
  training-bench and Gemma-2-2B projection shapes, against fp32
  accumulation;
- rolling sliding-window serving (serve_rolling): the published
  mistralai/Mistral-7B-v0.1 config (4096 window) at 4 of its 32 layers,
  page tables past the window, so each sequence lives on a ring of 32
  pages: prompts of 3968 (wrapping), 6000 (rolled in at admission) and
  512 tokens, 256 new, from bf16 and int8 KV, greedy tokens against the
  dense windowed forward, a 2-layer fp32 copy step by step, and the same
  engine at full residency;
- StreamingLLM serving (serve_streaming): the serving-bench model with
  128 attention sinks and a 1920-token window, 1800-token prompts decoded
  past eviction and a 3000-token prompt, against dense greedy before
  eviction and, in a 2-layer fp32 copy, against a dense forward that sees
  exactly the resident keys;
- the native runtime library (native): built from native/src, its page
  allocator's bookkeeping against the Python allocator's (plain and both
  rings) and the serve requests through each;
- the perplexity gate (eval_gate): scripts/train_lm.py's default model
  trained by fit on a corpus of the interpreter's own Python sources
  (scripts/make_corpus.py, fed by native_batches), then perplexity dense
  and through paged decode from bf16, int8, int4, e4m3 and e5m2 KV: int8
  within 0.1 ppl of bf16;
- the encoder (encoder): bert-base-uncased's widths with the JAX
  encoder's blocks, masked-LM steps at B32 x 512 through the non-causal
  head-dim-64 kernels, a 2-layer fp32 copy and a bidirectionality check;
- the geometry model and the tuner (tune): current_geometry() against the
  H100's 132 SMs and 232,448 bytes, every built layout's shared memory
  against geometry.py's model; the other tiles (csrc/attn_fwd_tiles.cu:
  64-key forward tiles, csrc/attn_bwd_tiles.cu: 32-row sweep stages, at
  d 64 and 128) against their plain versions at the gate model's,
  BERT-base's and the training-bench attention shapes and at edges, two
  tile mutants caught, the op API pinned to them (exact launches per
  tile); tuned_block_sizes and tuned_pages_per_block (every candidate's
  time, the winner, a second call from the cache); the serving-bench
  engine with its tuned pages_per_block, eager and graphed, against the
  default engine (bf16 near-ties only, a 2-layer fp32 copy equal);
- the bench suite (bench): bench/suite.py run_bench for ours / sdpa at
  N 1024, 4096 and 16384 (naive to 4096), fwd and bwd, TFLOP/s and percent
  of the bf16 peak, and bench_torch.py's one JSON line;
- the golden gate (golden): scripts/run_golden_gate_torch.py's 200 fp32
  trials at B32 H32 N256 d128 against the oracle at the reference ladder;
- scale-out (parallel/ on torch.distributed; one card, so 4 ranks, 2 for
  serve_mesh, share cuda:0 in a gloo group and every collective passes
  through host memory): ring (causal, non-causal), zigzag, combine and
  head-parallel attention at the training-bench attention over 16384
  tokens, forward and backward, against the single-process op, exact
  launches per rank, dropout's kept fraction and bitwise replay
  (parallel_attention); context- and head-sharded paged decode at the
  serving-bench decode heads from bf16 and int8 pools (parallel_decode);
  the training-bench model (2 of its 8 layers) trained dp 2 x tp 2
  against the single-process step, and a 2-layer fp32 copy (train_mesh);
  the serving-bench model (4 of its 16 layers) served tp 2 from bf16 and
  int8 KV against the single-process engine,
  tokens equal on both ranks, and a 2-layer fp32 copy (serve_mesh);
  parallel/dryrun.py (dryrun); examples 01, 03 and 04 --world 4 --backend
  gloo (examples);
- head dims above 256 (csrc/wide.cuh, the wide builds): the forward, both
  sweeps, paged decode and verify against their plain versions at head dims
  320 (padded to 384), 512 and 640 in every mode and dtype (the 16-bit
  forward, verify and sweeps on wide_wgmma, the forward and the sweeps
  also at 768, 896 and 1024), the paged kernels at their key-split edges,
  the sweeps, paged kernels and wide_wgmma forward bit for bit, the wide
  forward's and sweeps' mutants caught, every instance's shared memory
  against geometry.py's model, and their times at the re-headed
  bench models' shapes (wide_heads); serving-bench-d512, the serving-bench
  model with 4 q / 2 kv heads of 512, served from bf16 KV eagerly and as
  graphed bursts of 8, from int8 KV and chunked with the prefix cache
  (serve_d512); training-bench-d512, the training-bench model with 8 q / 2
  kv heads of 512, trained at B8 x N2048 (train_d512); above 1024 (the
  bf16 / fp16 forward and sweeps as score and product passes, route
  wide_scores; verify and fp32 column-chunked, route wide_chunk /
  wide_fp32; decode's chunked build) the same checks at 1152 in every mode
  and dtype, at 1408, 2048 and 8192, the forward bit for bit on repeat,
  each pass against its plain version on the same inputs, a call in
  several waves of scratch bit for bit the call in one, the op at 1100
  (padded to 1152), the mutants caught, and the two models re-headed at
  2048 (serve_d2048: 1 q / 1 kv head; train_d2048: 2 q / 1 kv heads);

checks that each path went through its kernels (launch counts, counted
through CUDA graph replays for the bursts and rounds, and the
forward's, each backward sweep's and verify's launches per route, set to 0
just before the path and read just after: every bf16 forward, backward
sweep and verify of the model paths on the wgmma route, the packed calls on
the routes ops/fwd_kernel.py fwd_route and ops/bwd_kernel.py bwd_route
name), and times each kernel beside its bound, its plain version and, where
one exists, the PyTorch library call computing the same function (the
paged kernels also by device time, their key splits and CTAs).

Every phase prints one JSON line and raises on failure.  The line before
the last is the card's name and power limit as nvidia-smi reports them; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when no CUDA device is present.

Usage: python3 chip_smoke.py   (no arguments; needs one CUDA card)

       python3 chip_smoke.py --pair PARENT_DIR
           times the forward (mode-free, ALiBi, ALiBi + dropout), the
           backward family (mode-free, ALiBi + dropout, with a packed
           loader's segment ids), and decode and verify at the timing shapes
           (CUDA-event and device times) from an unpacked earlier commit
           (PARENT_DIR, its own chip_smoke.py and package) and from this
           tree in turns, parent, change, change, parent, each run in its
           own process on the same card, one JSON line per run.

       python3 chip_smoke.py --only PHASE[,PHASE...]
           builds the kernels and runs only the named phases of
           serve_rolling, serve_streaming, native, eval_gate, encoder,
           tune, bench, golden, parallel_attention, parallel_decode,
           train_mesh, serve_mesh, dryrun, examples, wide_heads,
           serve_d512, train_d512, serve_d2048 and train_d2048
           (development runs; prints no result line).
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16/fp16, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM

# the forward's bf16 / fp16 kernel body (built into the six attn_fwd*.cu)
FWD_SM90_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_sm90.cuh"
# the forward's head-dim-256 builds, without and with segment ids
FWD_D256_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_d256.cu"
FWD_D64_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_d64.cu"
FWD_D256_SEG_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_d256_seg.cu"
FWD_REPLACES = (
    "flash_attention_dlrs_tpu/ops/fwd_kernel.py:197; "
    "flash_attention_dlrs_tpu/ops/fwd_mid.py:211; "
    "flash_attention_dlrs_tpu/ops/fwd_mid.py:572; "
    "flash_attention_dlrs_tpu/ops/fwd_small.py:69"
)
# the paged kernels' bodies (csrc/paged_decode.cuh, paged_verify.cuh), each
# built once for each pool head dim (paged_decode.cu and paged_verify.cu at
# 128, *_d64.cu, *_d256.cu)
DECODE_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_decode.cuh"
DECODE_D256_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_decode_d256.cu"
DECODE_D64_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_decode_d64.cu"
DECODE_REPLACES = "flash_attention_dlrs_tpu/ops/decode.py:44 (called at decode.py:438)"
VERIFY_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_verify.cuh"
VERIFY_D256_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_verify_d256.cu"
VERIFY_REPLACES = ("flash_attention_dlrs_tpu/ops/decode.py:44 (multi-token mode, "
                   "num_tokens > 1; called at decode.py:438 via paged_verify_attention, "
                   "decode.py:716)")
QUANT_KINDS = ("int8", "int4", "e4m3", "e5m2")
# stored bytes per K or V element, and per-token scale bytes (K and V)
KV_BYTES = {"bf16": 2, "fp32": 4, "int8": 1, "int4": 0.5, "e4m3": 1, "e5m2": 1}
BWD_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd.cu"
# the sweeps' head-dim-256 instances (csrc/attn_bwd_sm90.cuh, attn_bwd.cuh)
BWD_D256_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_d256.cu"
BWD_D64_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_d64.cu"
BWD_D256_SEG_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_d256_seg.cu"
# the sweeps' bf16 / fp16 kernel bodies (built into the six attn_bwd*.cu)
BWD_SM90_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_sm90.cuh"
BWD_REPLACES = {
    "attn_bwd_preprocess": "flash_attention_dlrs_tpu/ops/bwd_kernel.py:59",
    "attn_bwd_dkv": (
        "flash_attention_dlrs_tpu/ops/bwd_kernel.py:203; dK/dV of "
        "flash_attention_dlrs_tpu/ops/fwd_small.py:239, "
        "flash_attention_dlrs_tpu/ops/bwd_fused.py:45, "
        "flash_attention_dlrs_tpu/ops/bwd_mid.py:76"),
    "attn_bwd_dq": (
        "flash_attention_dlrs_tpu/ops/bwd_kernel.py:504; dQ of "
        "flash_attention_dlrs_tpu/ops/fwd_small.py:239, "
        "flash_attention_dlrs_tpu/ops/bwd_fused.py:45, "
        "flash_attention_dlrs_tpu/ops/bwd_mid.py:76"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, warmup=3, reps=10):
    """Median of per-call times between CUDA events recorded around each
    call, warm: the call's host time is part of the reading (device_ms
    reads its kernels alone)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=20, between=None, floor_ms=None):
    """Device time of one ``fn()`` call: the median, over ``reps`` warm
    calls, of CUDA events recorded just before and just after the call,
    with a spin kernel (torch.cuda._sleep, touching no memory) queued ahead
    of the first event for at least three times the call's host time, so
    that the card is still spinning when the host has launched the call:
    the interval holds the call's kernels and the gaps between them, not
    the wrapper's host time.  ``between()`` runs before each call, ahead of
    the spin (an L2 flush: :func:`l2_flush`).  A call whose launch outlasted
    its spin is not read; None where fewer than half were read, or where
    the median is under ``floor_ms`` (the call's bound), so that no such
    reading is reported.  (The profiler's kernel records came back
    incomplete in whole runs of this script on the H100: under the bound,
    or empty.)"""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    host = []
    for _ in range(3):
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
    start, end = events()
    start.record()
    torch.cuda._sleep(1 << 20)
    end.record()
    end.synchronize()
    ms_per_cycle = start.elapsed_time(end) / (1 << 20)
    spin_ms = max(0.2, 3e3 * max(host))
    cycles = int(spin_ms / ms_per_cycle)
    times = []
    for _ in range(reps):
        if between is not None:
            between()
        start, end = events()
        t = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        launched_ms = (time.perf_counter() - t) * 1e3
        end.synchronize()
        if launched_ms < spin_ms:
            times.append(start.elapsed_time(end))
    if 2 * len(times) < reps:
        return None
    ms = float(np.median(times))
    return None if floor_ms is not None and ms < floor_ms else ms


def l2_flush(dev):
    """A function that reads 128 MB of random bytes on ``dev`` (2.5x the
    H100's 50 MB L2, and nothing the L2 could compress), so that the next
    call reads its inputs from device memory, as a decode step does (each
    layer's pages were last read a whole step ago), and finds the L2 clean:
    reading, not writing, leaves no write-back in the way of the call's own
    misses."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.rand(32 << 20, generator=gen, device=dev)
    return buf.sum


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fwd_work(b, hq, hkv, nq, nkv, d, causal, itemsize, pairs=None, v_itemsize=None,
             window=0):
    """Operations and bytes one forward needs: 4·d operations per visible
    (row, key) pair and head, where ``pairs`` (one head, the whole batch)
    counts them when the data decide them (segment ids, whose [B, N] int32
    reads then count too); by default causal counts the visible half of the
    score matrix (2·B·H·N²·d when Nq = Nkv), and a causal ``window`` w the
    keys each row sees, min(i + 1, w).  ``v_itemsize``: V's bytes per
    element when they differ from q's (fp8 V: 1)."""
    seg_bytes = 0 if pairs is None else 4 * b * (nq + nkv)
    if pairs is None and window and causal and nq == nkv and window < nq:
        pairs = b * (window * (window + 1) / 2 + (nq - window) * window)
    elif pairs is None:
        pairs = b * (nq * nkv / 2 if causal and nq == nkv else nq * nkv)
    v_itemsize = itemsize if v_itemsize is None else v_itemsize
    flops = 4 * hq * pairs * d
    nbytes = (itemsize * (2 * b * hq * nq * d + b * hkv * nkv * d)
              + v_itemsize * b * hkv * nkv * d + 4 * b * hq * nq + seg_bytes)
    return flops, nbytes


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


WGMMA_ENTRY = re.compile(r"attn_fwd_wgmma_kernelI\d+(__nv_bfloat16|__half)Li(\d+)E"
                         r"Lb([01])ELb([01])ELb([01])ELb([01])E")
WGMMA_FLAGS = ("alibi", "dropout", "seg", "fp8v")
# the backward sweeps' wgmma instances (csrc/attn_bwd_sm90.cuh; the d 256
# dK/dV sweep is attn_bwd_dkv_split_wgmma_kernel)
BWD_WGMMA_ENTRY = re.compile(r"attn_bwd_(dkv|dq)(?:_split)?_wgmma_kernelI\d+(__nv_bfloat16|__half)"
                             r"Li(\d+)ELb([01])ELb([01])ELb([01])E")
BWD_WGMMA_FLAGS = ("alibi", "dropout", "seg")
LAUNCH_REGS = 168  # csrc/sm90.cuh LAUNCH_REGS: 384 threads x 168 at launch


def wgmma_instances(log, entry=WGMMA_ENTRY, flags=WGMMA_FLAGS, marker="attn_fwd_wgmma_kernel"):
    """Registers and spills of each wgmma instance of one kernel family
    (``entry``: its mangled name, the dtype and head dim groups first, then
    the template flags ``flags``; a sweep name before them where the family
    has two) from nvcc's ``--ptxas-options=-v`` log, and ptxas's
    performance warnings about the family (``marker``; C7515: wgmmas
    serialized, which takes the overlap of products and element work
    away)."""
    out, cur, warnings = {}, None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = entry.search(m.group(1))
            cur = None
            if w is not None:
                groups = w.groups()
                sweep = [groups[0]] if len(groups) > len(flags) + 2 else []
                dtype, d = groups[len(sweep)], groups[len(sweep) + 1]
                cur = "_".join(
                    sweep + ["bf16" if dtype == "__nv_bfloat16" else "fp16", "d" + d]
                    + [f for f, on in zip(flags, groups[len(sweep) + 2:]) if on == "1"])
                out[cur] = {}
            continue
        if "Performance Loss" in line and marker in line:
            warnings.append(line.strip())
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out, warnings


# Broken copies of the bf16 / fp16 dK/dV sweep, each built beside the tree
# (flash_attention_dlrs_tpu_torch/_build/mutants/<name>/) from csrc/ with one
# set of text edits (source built, file edited, [(old, new)]): bwd_check
# must fail on each (phase mutants).
BWD_SM90 = "attn_bwd_sm90.cuh"
# the dK/dV step's stage released to the producer as soon as its score
# products are read, before the element loop and the update products
STAGE_RELEASED_AFTER_SCORES = (
    "      fence_regs(dp);\n      if (softcap > 0.f) {\n"
    "        if (masked) grads(m0, st, slope, stream, yes, yes);",
    "      fence_regs(dp);\n      release(empty(st));\n      if (softcap > 0.f) {\n"
    "        if (masked) grads(m0, st, slope, stream, yes, yes);")
BWD_MUTANTS = {
    # the causal diagonal's and the window's tiles run the unmasked loop
    "dkv_diagonal_tile_unmasked": ("attn_bwd.cu", BWD_SM90, [(
        "SEG || !tile_unmasked<BS, WG_ROWS>(m0, nw, Nq, Nkv, causal, window);",
        "SEG || nw + WG_ROWS > Nkv;")]),
    # the Q / dO stage (and its lse, D rows) released to the producer as soon
    # as the score products are done, before dK's product has read Q
    "dkv_stage_released_before_dk": ("attn_bwd.cu", BWD_SM90, [
        STAGE_RELEASED_AFTER_SCORES,
        ("      }\n      release(empty(st));  // dK's product has read Q, dV's dO",
         "      } else {\n        release(empty(st));\n      }"),
    ]),
    # d 256 (the one-pass split sweep): each step's Q / dO stage (and its
    # lse, D rows) released as soon as its score products are done, before
    # the element loop reads the rows and both warpgroups' update products
    # read Q and dO
    "d256_dkv_stage_released_before_updates": ("attn_bwd_d256.cu", BWD_SM90, [
        ("      fence_regs(dp);\n      if (softcap > 0.f) {\n"
         "        if (masked) grads(m0, st, slope, yes, yes);",
         "      fence_regs(dp);\n      release(empty(st));\n      if (softcap > 0.f) {\n"
         "        if (masked) grads(m0, st, slope, yes, yes);"),
        ("      release(tiles_empty);\n      release(empty(st));  // both updates have read Q and dO\n",
         "      release(tiles_empty);\n"),
    ]),
    # d 256 with dropout: dS built from dP without the keep mask, while
    # P o M (dV's operand) still drops
    "d256_dkv_ds_skips_keep_mask": ("attn_bwd_d256.cu", BWD_SM90, [(
        "const float dpv = DROP ? dp[e] * keep : dp[e];",
        "const float dpv = dp[e];")]),
}


def start_mutant_builds(mutants, csrc=None, every=False):
    """Writes each mutant's csrc/ copy (``mutants``: {name: (source,
    edited file, [(old, new)])}) and starts its nvcc on the source:
    {name: (process, library path, source)}, each nvcc (and the compilers
    it runs) at the lowest CPU priority.  ``csrc``: the sources to copy
    (another tree's; this one's by default); ``every``: an edit replaces
    every occurrence of its target (at least one), not exactly one."""
    import os
    import shutil
    from flash_attention_dlrs_tpu_torch import _cuda

    running = {}
    for name, (source, edited, edits) in mutants.items():
        root = _cuda.BUILD_DIR / "mutants" / name
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(csrc or _cuda.CSRC_DIR, root / "csrc")
        path = root / "csrc" / edited
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1 and not (every and text.count(old)):
                raise AssertionError(f"mutant {name}: edit target found "
                                     f"{text.count(old)} times: {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
        lib = root / source.replace(".cu", ".so")
        with open(root / "nvcc.log", "wb") as log:  # a file: no pipe to fill
            proc = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                                     str(root / "csrc" / source)],
                                    stdout=log, stderr=subprocess.STDOUT,
                                    preexec_fn=lambda: os.nice(19))
        running[name] = (proc, lib, source)
    return running


def wait_mutant_builds(builds) -> float:
    """Waits for the nvcc of every mutant of ``builds`` (from
    :func:`start_mutant_builds`); raises if one failed.  Returns the
    seconds it waited."""
    t0 = time.perf_counter()
    for name, (proc, lib, _) in builds.items():
        if proc.wait():
            log = (lib.parent / "nvcc.log").read_text(errors="replace")
            raise RuntimeError(f"mutant {name} did not build:\n{log[-4000:]}")
    return time.perf_counter() - t0


def _check_instances(rec, built, sources, entry, flags, marker, count, key):
    """Adds the registers, spills and ptxas warnings of one wgmma family
    built from ``sources`` to ``rec`` (under ``key``); raises unless there
    are ``count`` instances, each at the launch allocation."""
    instances, warnings = {}, []
    for src in sources:
        inst, warn = wgmma_instances(built[src]["log"], entry, flags, marker)
        instances.update(inst)
        warnings += warn
    rec.update({f"{key}_instances": instances, f"{key}_ptxas_warnings": warnings,
                f"{key}_spilling": {k: v for k, v in instances.items()
                                    if v.get("spill_stores") or v.get("spill_loads")}})
    if len(instances) != count:
        raise AssertionError(f"expected {count} {key} instances, found {sorted(instances)}")
    # setmaxnreg splits the 384 x 168 registers a CTA is launched with;
    # fewer at launch would hang it
    short = {k: v.get("registers") for k, v in instances.items()
             if v.get("registers") != LAUNCH_REGS}
    if short:
        raise AssertionError(f"{key} instances not at {LAUNCH_REGS} registers: {short}")
    return warnings


# The paged kernels' instances (csrc/paged_decode.cuh, paged_verify.cuh):
# pool kind codes of csrc/paged.cuh PoolKind.
PAGED_KIND_NAMES = ("fp32", "bf16", "fp16", "int8", "int4", "e4m3", "e5m2")
PAGED_ENTRIES = (
    (re.compile(r"paged_decode_kernelILi(\d)ELi(\d+)ELb([01])ELb([01])E"), "decode"),
    (re.compile(r"wide_decode_kernelILi(\d)ELi(\d)E"), "decode_wide"),
    (re.compile(r"paged_verify_wgmma_kernelI\d+(__nv_bfloat16|__half)Li(\d+)ELi(\d)E"
                r"Lb([01])ELb([01])E"), "verify_wgmma"),
    (re.compile(r"paged_verify_f32_kernelILi(\d+)E"), "verify_fp32"),
)


def paged_name(entry):
    """A readable name of one paged kernel instance from its mangled name:
    kernel, (q dtype,) pool kind, head dim, then "cap" / "alibi" where on
    (the wide decode kernel takes them at run time)."""
    for pattern, kernel in PAGED_ENTRIES:
        m = pattern.search(entry)
        if m is None:
            continue
        g = m.groups()
        if kernel == "decode":
            parts = [kernel, PAGED_KIND_NAMES[int(g[0])], "d" + g[1]]
            flags = g[2:]
        elif kernel == "decode_wide":  # kind, 128-column blocks
            return f"{kernel}_{PAGED_KIND_NAMES[int(g[0])]}_d{128 * int(g[1])}"
        elif kernel == "verify_wgmma":
            parts = [kernel, "bf16" if g[0] == "__nv_bfloat16" else "fp16",
                     PAGED_KIND_NAMES[int(g[2])], "d" + g[1]]
            flags = g[3:]
        else:
            return "_".join([kernel] + ["d" + x for x in g])
        return "_".join(parts + [f for f, on in zip(("cap", "alibi"), flags) if on == "1"])
    return None


def paged_instances(log, source):
    """Registers, dynamic shared memory, spills and ptxas performance
    warnings of every kernel instance built from a paged source (from
    nvcc's ``--ptxas-options=-v`` log; shared memory from the library's
    ``*_shared_bytes`` entry)."""
    import ctypes
    from flash_attention_dlrs_tpu_torch import _cuda

    lib = ctypes.CDLL(str(_cuda.library_path(source)))
    stem = source.split(".")[0]
    shared = getattr(lib, f"{stem}_shared_bytes")
    shared.argtypes, shared.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = paged_name(m.group(1))
            if cur is not None:
                out[cur] = {"ptxas_warnings": []}
            continue
        if cur is None:
            continue
        if "Performance Loss" in line:
            out[cur]["ptxas_warnings"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    for name, rec in out.items():
        parts = name.split("_")
        d = next((int(x[1:]) for x in parts if re.fullmatch(r"d\d+", x)), 0)
        if name.startswith("decode_"):
            kind = parts[2] if name.startswith("decode_wide_") else parts[1]
            rec["shared_bytes"] = shared(PAGED_KIND_NAMES.index(kind), d)
        else:
            rec["shared_bytes"] = shared(0 if name.startswith("verify_fp32") else 1, d)
    return out


def wide_wgmma_instances(log, source):
    """Registers, spills and ptxas performance warnings of every
    wide_wgmma_kernel instance of a wide source (csrc/wide.cuh), from nvcc's
    ``--ptxas-options=-v`` log, by "<dtype>_<fwd|verify>_d<head dim>" (the
    head dim from its cut: CTAs a cluster x owners a CTA x 64-column chunks
    an owner)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"wide_wgmma_kernelI(\w+?)Lb(\d)ELi(\d)ELi(\d)ELi(\d)E", m.group(1))
            cur = None
            if k:
                nc, nw, c = (int(x) for x in k.groups()[2:])
                cur = (f"{'bf16' if 'bfloat16' in k.group(1) else 'fp16'}_"
                       f"{'verify' if k.group(2) == '1' else 'fwd'}_d{64 * nc * nw * c}")
                out[cur] = {"source": source, "owners_a_cta": nw, "cluster": nc,
                            "ptxas_warnings": []}
            continue
        if cur is None:
            continue
        if "Performance Loss" in line or "serialized" in line:
            out[cur]["ptxas_warnings"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


SCORES_ENTRY = re.compile(r"ws_(fwd_scores|bwd_scores|product)_kernelI\d+(__nv_bfloat16|__half)"
                          r"(?:Li(\d)E)?E")
SCORES_PRODUCTS = ("o", "dq", "dkv")  # csrc/wide_scores.cuh kProductO / Dq / Dkv


def _scores_name(match):
    """"<pass>_<dtype>" of a SCORES_ENTRY match."""
    kind = match.group(1)
    if match.group(3) is not None:
        kind = f"product_{SCORES_PRODUCTS[int(match.group(3))]}"
    return f"{kind}_{'bf16' if 'bfloat16' in match.group(2) else 'fp16'}"


def scores_instances(log, source):
    """Registers, spills and ptxas performance warnings of every instance of
    route wide_scores' passes (csrc/wide_scores.cuh) in a source's nvcc
    log, by "<pass>_<dtype>" (fwd_scores, bwd_scores, product_o / _dq /
    _dkv)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = SCORES_ENTRY.search(m.group(1))
            cur = _scores_name(k) if k else None
            if cur:
                out[cur] = {"source": source, "ptxas_warnings": []}
            continue
        if "Performance Loss" in line or "serialized" in line:
            # ptxas names the function in the warning, before its own entry
            k = SCORES_ENTRY.search(line)
            # a warning of no instance by name still fails the build check
            name = _scores_name(k) if k else "unattributed"
            out.setdefault(name, {"source": source, "ptxas_warnings": []})
            out[name]["ptxas_warnings"].append(line.strip())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def wide_bwd_instances(log):
    """Registers, spills and ptxas performance warnings of every 16-bit
    wide sweep instance (csrc/wide.cuh wide_bwd_dkv_kernel /
    wide_bwd_dq_kernel) from attn_bwd_wide.cu's nvcc log, by
    "<sweep>_<dtype>_d<head dim>" (the head dim from its cut: CTAs a
    cluster x owners a CTA x 64-column chunks an owner)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"wide_bwd_(dkv|dq)_kernelI(\w+?)Li(\d)ELi(\d)ELi(\d)E", m.group(1))
            cur = None
            if k:
                nc, nw, c = (int(x) for x in k.groups()[2:])
                cur = (f"{k.group(1)}_{'bf16' if 'bfloat16' in k.group(2) else 'fp16'}"
                       f"_d{64 * nc * nw * c}")
                out[cur] = {"owners_a_cta": nw, "cluster": nc, "ptxas_warnings": []}
            continue
        if cur is None:
            continue
        if "Performance Loss" in line or "serialized" in line:
            out[cur]["ptxas_warnings"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# The wide decode mutants build the d 512 instances alone (the other widths'
# launches edited to refuse), which keeps their compile small.
_WIDE_DECODE_MUTANT_ONLY_512 = [
    (f"      case {d}: return f(kind, std::integral_constant<int, {d // 128}>{{}});",
     f"      case {d}: return int(cudaErrorInvalidValue);") for d in (384, 640, 768, 896, 1024)]
# Broken copies of the paged kernels, built as BWD_MUTANTS are:
# decode_check must fail on each (phase paged_mutants); the wide decode's on
# its d 512 cases of wide_paged_cases.
PAGED_MUTANTS = {
    # the merge of the splits drops the last split's partial
    "decode_combine_drops_last_split": ("paged_decode.cu", "paged.cuh", [(
        "    for (int s = 0; s < splits; ++s) {\n      const float ws",
        "    for (int s = 0; s < splits - 1; ++s) {\n      const float ws")]),
    # wide decode: the last CTA of a group merges all splits but the last
    "wide_decode_merge_drops_last_split": ("paged_decode_wide.cu", "wide.cuh", [(
        "merge_rows(a.part_o, a.part_lse, a.splits, size_t(a.B) * a.Hq, nh, D,",
        "merge_rows(a.part_o, a.part_lse, a.splits - 1, size_t(a.B) * a.Hq, nh, D,"),
    ] + _WIDE_DECODE_MUTANT_ONLY_512),
    # wide decode: the last stored row of every stage's tile left out
    "wide_decode_drops_last_tile_row": ("paged_decode_wide.cu", "wide.cuh", [(
        "own = v < n_rows && pos < len ? x : -INFINITY;  // the tile's rows",
        "own = v < n_rows && r != TILE - 1 && pos < len ? x : -INFINITY;"),
    ] + _WIDE_DECODE_MUTANT_ONLY_512),
    # a tile that crosses a row's horizon (but not the split's end) unmasked
    "verify_horizon_tile_unmasked": ("paged_verify.cu", "paged_verify.cuh", [(
        "const bool masked = n0 + V_BN > open;",
        "const bool masked = n0 + V_BN > k_hi;")]),
}


# The head-dim-256 builds of the forward and the backward sweeps.
D256_SOURCES = ("attn_fwd_d256.cu", "attn_fwd_d256_seg.cu", "attn_bwd_d256.cu",
                "attn_bwd_d256_seg.cu")


def d256_shared_bytes():
    """The dynamic shared memory (bytes, of the 232,448 a CTA may opt into)
    of every d256 instance's layout, from the builds' *_shared_bytes
    entries: the forward's by route and fp8 V, the sweeps' by sweep and
    route (the mode flags ALiBi and dropout add none)."""
    import ctypes
    from flash_attention_dlrs_tpu_torch import _cuda

    out = {}
    for source in D256_SOURCES:
        stem = source.split(".")[0]
        fn = getattr(ctypes.CDLL(str(_cuda.library_path(source))), f"{stem}_shared_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        if stem.startswith("attn_fwd"):
            out.update({f"{stem}_{route}{'_fp8v' if v8 else ''}": fn(code, v8)
                        for route, code in (("fp32", 0), ("wgmma", 1)) for v8 in (0, 1)})
        else:
            out.update({f"{stem}_{sweep}_{route}": fn(dkv, code)
                        for sweep, dkv in (("dkv", 1), ("dq", 0))
                        for route, code in (("fp32", 0), ("wgmma", 1))})
    return out


def phase_build(mutants=False):
    """Builds every source and, with ``mutants``, then starts the backward
    and paged mutant builds and returns them: they compile at the lowest CPU
    priority while the next phases run (phases mutants and paged_mutants
    wait for them), so the main build has every core."""
    from flash_attention_dlrs_tpu_torch import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    build_s = time.perf_counter() - t0
    global TILE_MUTANT_BUILDS, WIDE_MUTANT_BUILDS
    mutant_builds = ((start_mutant_builds(BWD_MUTANTS), start_mutant_builds(PAGED_MUTANTS))
                     if mutants else ({}, {}))
    if mutants:
        TILE_MUTANT_BUILDS = start_mutant_builds(TILE_MUTANTS)
        WIDE_MUTANT_BUILDS = start_mutant_builds(WIDE_MUTANTS)
    info = {}
    for src, rec in built.items():
        ptxas = [l.strip() for l in rec["log"].splitlines()
                 if "registers" in l or "spill" in l or "smem" in l]
        info[src] = {"seconds": round(rec["seconds"], 3), "ptxas": ptxas}
    rec = {"phase": "build", "seconds": build_s, "sources": _cuda.all_sources(),
           "built": info}
    fwd_warnings, bwd_warnings = [], []
    fwd_sources = tuple(f"attn_fwd{d}{s}.cu" for d in ("_d64", "", "_d256")
                        for s in ("", "_seg"))
    if all(src in built for src in fwd_sources):
        # 2 dtypes x 3 head dims x 2^4 modes
        fwd_warnings = _check_instances(rec, built, fwd_sources, WGMMA_ENTRY, WGMMA_FLAGS,
                                        "attn_fwd_wgmma_kernel", 96, "wgmma")
    bwd_sources = tuple(f"attn_bwd{d}{s}.cu" for d in ("_d64", "", "_d256")
                        for s in ("", "_seg"))
    if all(src in built for src in bwd_sources):
        # 2 sweeps x 2 dtypes x 3 head dims x 2^3 modes
        bwd_warnings = _check_instances(rec, built, bwd_sources, BWD_WGMMA_ENTRY,
                                        BWD_WGMMA_FLAGS, "_wgmma_kernel", 96, "bwd_wgmma")
    d256_wrong = {}
    if all(src in built for src in D256_SOURCES):
        rec["d256_shared_bytes"] = d256_shared_bytes()
        # the sweeps' layouts against geometry.py's model, to the byte
        from flash_attention_dlrs_tpu_torch import geometry as geo
        for seg in ("", "_seg"):
            for sweep, dkv in (("dkv", True), ("dq", False)):
                key = f"attn_bwd_d256{seg}_{sweep}_wgmma"
                want = geo.attention_bwd_smem_bytes(geo.default_block_kv_bwd(256), 256,
                                                    bool(seg), dkv)
                if rec["d256_shared_bytes"][key] != want:
                    d256_wrong[key] = [rec["d256_shared_bytes"][key], want]
    tiles_wrong = check_tile_builds(rec, built)
    paged = {}
    for src in [f"paged_{k}{d}.cu" for k in ("decode", "verify") for d in ("_d64", "", "_d256")
                ] + ["paged_verify_d256_f16.cu"]:
        if src in built:
            paged.update(paged_instances(built[src]["log"], src))
    serialized = {k: v["ptxas_warnings"] for k, v in paged.items()
                  if k.startswith("verify_wgmma") and v["ptxas_warnings"]}
    if paged:
        # 7 kinds x 3 head dims x 2^2 modes; 2 dtypes x 5 kinds x 3 head dims
        # x 2^2 modes, and 3 fp32 instances
        rec.update(paged_instances=paged, paged_spilling={
            k: v for k, v in paged.items() if v.get("spill_stores") or v.get("spill_loads")})
    emit(rec)
    if tiles_wrong:
        raise AssertionError(tiles_wrong)
    if fwd_warnings:
        raise AssertionError(f"forward wgmma instances with serialized wgmmas: {fwd_warnings}")
    if bwd_warnings:
        raise AssertionError(f"backward wgmma instances with serialized wgmmas: {bwd_warnings}")
    if d256_wrong:
        raise AssertionError(f"d 256 sweep layouts against geometry.py [C, Python]: {d256_wrong}")
    d256_spilling = {k: v for k, v in rec.get("bwd_wgmma_spilling", {}).items() if "_d256" in k}
    if d256_spilling:
        raise AssertionError(f"d 256 sweep instances that spill: {d256_spilling}")
    if serialized:
        raise AssertionError(f"verify wgmma instances with serialized wgmmas: {serialized}")
    # the wide builds (csrc/wide.cuh): every instance's ptxas lines, none
    # may spill; the wide_wgmma instances (2 dtypes x 6 head dims in each of
    # the forward, verify and both sweeps) by name, those of two owners a
    # CTA at the launch's 168 registers (setmaxnreg moves registers only
    # within them), none with serialized wgmmas; the decode instances (7
    # pool kinds x 6 head dims) by name, none spilling, each with its
    # layout's shared bytes
    wide = {src: info[src]["ptxas"] for src in built
            if src.endswith(("_wide.cu", "_scores.cu")) or src == "paged_decode_chunk.cu"}
    spilling = {src: [l for l in lines if re.search(r"[1-9]\d* bytes spill", l)]
                for src, lines in wide.items()}
    spilling = {src: lines for src, lines in spilling.items() if lines}
    wgmma = {}
    for src in ("attn_fwd_wide.cu", "paged_verify_wide.cu"):
        if src in built:
            wgmma.update(wide_wgmma_instances(built[src]["log"], src))
    sweeps = wide_bwd_instances(built["attn_bwd_wide.cu"]["log"]) if (
        "attn_bwd_wide.cu" in built) else {}
    wrong = {k: v for k, v in {**wgmma, **sweeps}.items()
             if v["ptxas_warnings"] or (v["owners_a_cta"] == 2 and v.get("registers") != LAUNCH_REGS)}
    decode = paged_instances(built["paged_decode_wide.cu"]["log"], "paged_decode_wide.cu") if (
        "paged_decode_wide.cu" in built) else {}
    # route wide_scores: 2 dtypes x (the forward's score and product
    # passes, the backward's score pass and two products), each at the
    # launch's 168 registers, none spilling or with serialized wgmmas
    scores = {}
    for src in SCORES_BUILDS.values():
        src = src.rsplit("/", 1)[1]
        if src in built:
            scores.update(scores_instances(built[src]["log"], src))
    scores_wrong = {k: v for k, v in scores.items()
                    if v["ptxas_warnings"] or v.get("registers") != LAUNCH_REGS
                    or v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "build_wide", "ptxas": wide, "spilling": spilling,
          "wide_wgmma_instances": wgmma, "wide_bwd_instances": sweeps,
          "wide_decode_instances": decode, "wide_scores_instances": scores})
    if scores and (len(scores) != 10 or scores_wrong):
        raise AssertionError(f"wide_scores instances off ({len(scores)} of 10): {scores_wrong}")
    if spilling:
        raise AssertionError(f"wide instances spill: {spilling}")
    if decode and (len(decode) != 42 or any(v.get("spill_stores") or v.get("spill_loads")
                                            for v in decode.values())):
        raise AssertionError(f"wide decode instances off ({len(decode)} of 42): {decode}")
    if wrong or (wgmma and len(wgmma) != 24) or (sweeps and len(sweeps) != 24):
        raise AssertionError(f"wide_wgmma instances off ({len(wgmma)} + {len(sweeps)} of "
                             f"24 + 24): {wrong}")
    counts = {k: sum(n.startswith(k) for n in paged)
              for k in ("decode_", "verify_wgmma_", "verify_fp32_")}
    if paged and counts != {"decode_": 84, "verify_wgmma_": 120, "verify_fp32_": 3}:
        raise AssertionError(f"unexpected paged instances: {counts}")
    return mutant_builds


def _rand(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def fwd_errors(got, want, dtype):
    """Errors of the forward kernel's (O, lse) against the plain version's,
    and whether they meet the tolerance for ``dtype``."""
    import torch

    (o, lse), (o_ref, lse_ref) = got, want
    err_o = (o.float() - o_ref.float()).abs()
    err_l = (lse - lse_ref).abs()
    if dtype == torch.float32:
        ok = bool((err_o <= 1e-4 + 1e-5 * o_ref.float().abs()).all()
                  and (err_l <= 1e-4 + 1e-5 * lse_ref.abs()).all())
        tol = "O and L: atol 1e-4, rtol 1e-5"
    else:
        # Kernel and plain version each round an fp32 O to the input type,
        # so an element near a rounding boundary can land one unit apart:
        # above |O| ~ 2.5 that unit (eps x |O| bounds it) exceeds 2e-2.
        eps = torch.finfo(dtype).eps
        ok = bool((err_o <= torch.clamp(eps * o_ref.float().abs(), min=2e-2)).all()
                  and (err_l <= 1e-3).all())
        tol = f"O: max(atol 2e-2, {eps:g} x |O|), L: atol 1e-3"
    ok &= bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    rec = {"max_abs_err_o": float(err_o.max()), "max_abs_err_lse": float(err_l.max()),
           "max_abs_plain_o": float(o_ref.float().abs().max()),
           "frac_o_differs": float((o != o_ref).float().mean()), "tolerance": tol}
    return rec, ok


def fwd_routes(zero=False):
    """The forward's launches per route (ops/fwd_kernel.py ROUTE_LAUNCHES),
    set to 0 when ``zero``."""
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import ROUTE_LAUNCHES

    if zero:
        for route in ROUTE_LAUNCHES:
            ROUTE_LAUNCHES[route] = 0
    return dict(ROUTE_LAUNCHES)


def all_on(routes, route, n):
    """Whether the per-route counts ``routes`` are exactly ``n`` launches,
    every one on ``route``."""
    return routes == {r: (n if r == route else 0) for r in routes}


def mods(hq, alibi=False, rate=0.0, seed=0):
    """The kernels' ALiBi and dropout keyword arguments: the standard slopes
    of ``hq`` heads when ``alibi``, dropout at ``rate`` with ``seed``."""
    from flash_attention_dlrs_tpu_torch.ops.reference import alibi_slopes_for

    return dict(alibi_slopes=alibi_slopes_for(hq) if alibi else None,
                dropout_rate=rate, dropout_seed=seed)


def loader_layout(rng, b, n, lo=64, hi=2048, max_docs=8):
    """[B, N] int32 segment ids as a packed pretraining loader fills its
    rows: documents of lengths drawn uniformly from [lo, hi] laid end to
    end, the last cut at the row's end, at most ``max_docs`` a row (the last
    takes the rest)."""
    ids = np.zeros((b, n), np.int32)
    for row in ids:
        pos = doc = 0
        while pos < n:
            length = n - pos if doc == max_docs - 1 else int(rng.integers(lo, hi + 1))
            row[pos:pos + length] = doc
            pos, doc = pos + length, doc + 1
    return ids


def segment_layout(kind, b, nq, nkv, dev, seed=0):
    """The kernels' (q_seg, kv_seg) for a check: "packed" documents of
    16..N/2 tokens (shorter and longer than a 64-key tile, boundaries inside
    tiles and on their edges), "loader" the loader's 64..2048, "cross"
    separate q and kv layouts (Nq != Nkv) whose last 40 q rows carry an id
    no key has (rows that see nothing, mid-batch); {} for None."""
    import torch

    if kind is None:
        return {}
    rng = np.random.default_rng(seed)
    if kind == "loader":
        qs = loader_layout(rng, b, nq)
    else:
        qs = loader_layout(rng, b, nq, 16, max(17, nq // 2))
    ks = qs
    if kind == "cross":
        ks = loader_layout(rng, b, nkv, 16, max(17, nkv // 2))
        qs[:, -40:] = 1000
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(q_seg=as_t(qs), kv_seg=as_t(ks))


FP8_V = {"e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2"}


def case_kwargs(hq, b, nq, nkv, dev, mod):
    """A check case's kernel keyword arguments from its mode dict: ALiBi
    and dropout (:func:`mods`) and segment ids (``seg``: a
    :func:`segment_layout` kind)."""
    kw = mods(hq, **{k: v for k, v in mod.items() if k in ("alibi", "rate", "seed")})
    return {**kw, **segment_layout(mod.get("seg"), b, nq, nkv, dev)}


def phase_fwd(dev):
    """Each forward mode and route against the plain version on the same
    inputs."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    alibi, drop, both = dict(alibi=True), dict(rate=0.1, seed=7), dict(alibi=True, rate=0.1,
                                                                       seed=-5)
    seg, cross = dict(seg="packed"), dict(seg="cross")
    cases = [
        # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, mods
        # (mods: ALiBi / dropout, seg = a segment_layout kind, v8 = fp8 V kind)
        ("serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0, {}),
        ("train_B8_H32_N2048", bf16, 8, 32, 8, 2048, 2048, 128, True, 0, 0.0, {}),
        ("noncausal_tail", bf16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0, {}),
        ("window_softcap", bf16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, {}),
        ("fp32_256", f32, 2, 4, 2, 256, 256, 64, True, 0, 0.0, {}),
        ("fp16_bottom_right", f16, 1, 4, 1, 100, 700, 64, True, 0, 0.0, {}),
        ("bf16_empty_rows", bf16, 1, 4, 2, 300, 200, 128, True, 0, 0.0, {}),
        ("alibi_serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0, alibi),
        ("alibi_fp32_gqa_tails", f32, 2, 8, 2, 300, 300, 128, True, 0, 0.0, alibi),
        ("alibi_fp32_cross", f32, 1, 4, 2, 100, 700, 64, True, 0, 0.0, alibi),
        ("alibi_bf16_cross_tails", bf16, 2, 4, 1, 333, 1000, 64, True, 0, 0.0, alibi),
        ("alibi_fp32_window_softcap", f32, 1, 4, 2, 512, 512, 64, True, 100, 25.0, alibi),
        ("alibi_window_softcap", bf16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, alibi),
        ("dropout_fp32", f32, 2, 4, 2, 256, 256, 64, True, 0, 0.0, drop),
        ("dropout_bf16", bf16, 2, 8, 2, 1024, 1024, 128, True, 0, 0.0, drop),
        ("alibi_dropout_train_B8_H32_N2048", bf16, 8, 32, 8, 2048, 2048, 128, True, 0,
         0.0, both),
        # segment ids (packed sequences)
        ("seg_fp32_causal_gqa_tails", f32, 2, 8, 2, 300, 300, 64, True, 0, 0.0, seg),
        ("seg_bf16_causal_gqa_tails", bf16, 2, 8, 2, 333, 333, 128, True, 0, 0.0, seg),
        ("seg_fp32_cross_empty_rows", f32, 2, 4, 2, 200, 500, 128, False, 0, 0.0, cross),
        ("seg_bf16_cross_empty_rows", bf16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0, cross),
        ("seg_fp16_cross_causal_d64", f16, 1, 4, 1, 300, 700, 64, True, 0, 0.0, cross),
        ("seg_fp32_window_softcap", f32, 1, 4, 2, 512, 512, 64, True, 100, 25.0, seg),
        ("seg_bf16_window_softcap", bf16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, seg),
        ("seg_fp32_alibi_dropout", f32, 2, 4, 2, 256, 256, 64, True, 0, 0.0,
         dict(both, seg="packed")),
        ("seg_bf16_alibi_dropout", bf16, 2, 8, 2, 1024, 1024, 128, True, 0, 0.0,
         dict(both, seg="packed")),
        # fp8 V, dequantized as the kernel stages it
        ("fp8v_e4m3_bf16_serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0,
         dict(v8="e4m3")),
        ("fp8v_e5m2_bf16_serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0,
         dict(v8="e5m2")),
        ("fp8v_e4m3_fp16_tail_d64", f16, 1, 4, 2, 300, 700, 64, True, 0, 0.0, dict(v8="e4m3")),
        ("fp8v_e5m2_fp16_noncausal", f16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0,
         dict(v8="e5m2")),
        ("fp8v_e4m3_fp32", f32, 2, 4, 2, 256, 256, 64, True, 0, 0.0, dict(v8="e4m3")),
        ("fp8v_e5m2_fp32_d128_tail", f32, 1, 4, 2, 300, 300, 128, True, 0, 0.0,
         dict(v8="e5m2")),
        ("fp8v_e4m3_bf16_seg_window_softcap", bf16, 1, 16, 8, 1024, 1024, 128, True, 256,
         30.0, dict(v8="e4m3", seg="packed")),
        # the wgmma route's tile edges (128-row q tiles, 128-key K/V tiles),
        # each mode in bf16 and fp16 (tests/test_torch_fwd_route.py holds
        # the plain version to JAX at these shapes)
        ("wg_n127_bf16", bf16, 1, 4, 2, 127, 127, 128, True, 0, 0.0, {}),
        ("wg_n128_fp16_d64", f16, 1, 4, 2, 128, 128, 64, True, 0, 0.0, {}),
        ("wg_n129_alibi_bf16_d64", bf16, 2, 4, 1, 129, 129, 64, True, 0, 0.0, alibi),
        ("wg_n257_dropout_fp16", f16, 1, 8, 2, 257, 257, 128, True, 0, 0.0, drop),
        ("wg_cross_129_385_bf16", bf16, 1, 4, 2, 129, 385, 128, True, 0, 0.0, {}),
        ("wg_cross_1_257_alibi_dropout_fp16_d64", f16, 1, 4, 2, 1, 257, 64, True, 0, 0.0,
         both),
        ("wg_window1_n300_bf16", bf16, 1, 4, 2, 300, 300, 128, True, 1, 0.0, {}),
        ("wg_window127_n300_alibi_fp16_d64", f16, 1, 4, 2, 300, 300, 64, True, 127, 0.0,
         alibi),
        ("wg_window128_n300_dropout_bf16_d64", bf16, 1, 4, 2, 300, 300, 64, True, 128, 0.0,
         drop),
        ("wg_window129_n300_softcap_alibi_dropout_fp16", f16, 1, 4, 2, 300, 300, 128, True,
         129, 30.0, both),
        ("wg_gqa4_bf16_d64", bf16, 2, 8, 2, 130, 130, 64, True, 0, 0.0, {}),
        ("wg_gqa8_noncausal_tail_fp16", f16, 1, 8, 1, 129, 1000, 128, False, 0, 0.0, {}),
        ("wg_noncausal_tail_alibi_dropout_bf16", bf16, 2, 4, 2, 300, 1000, 128, False, 0,
         0.0, both),
        ("wg_empty_rows_alibi_fp16_d64", f16, 1, 4, 2, 300, 200, 64, True, 0, 0.0, alibi),
        ("wg_empty_rows_dropout_bf16", bf16, 1, 4, 2, 300, 200, 128, True, 0, 0.0, drop),
        # head_dim 256 (Gemma, 64-key tiles): the modes Gemma uses, none,
        # softcap and window, on both routes, at Gemma-2-2B's heads
        ("d256_gemma_prefill_2048_softcap", bf16, 1, 8, 4, 2048, 2048, 256, True, 0, 50.0,
         {}),
        ("d256_gemma_window_softcap_8192", bf16, 1, 8, 4, 8192, 8192, 256, True, 4096, 50.0,
         {}),
        ("d256_none_bf16", bf16, 1, 8, 4, 1024, 1024, 256, True, 0, 0.0, {}),
        ("d256_window_fp16_tail", f16, 1, 4, 2, 300, 300, 256, True, 100, 0.0, {}),
        ("d256_cross_tails_bf16", bf16, 2, 4, 2, 129, 385, 256, True, 0, 0.0, {}),
        ("d256_window63_softcap_fp16", f16, 1, 4, 2, 200, 200, 256, True, 63, 30.0, {}),
        ("d256_noncausal_tail_fp16", f16, 1, 4, 1, 100, 700, 256, False, 0, 0.0, {}),
        ("d256_empty_rows_bf16", bf16, 1, 4, 2, 300, 200, 256, True, 0, 0.0, {}),
        ("d256_fp32_none", f32, 1, 4, 2, 256, 256, 256, True, 0, 0.0, {}),
        ("d256_fp32_softcap", f32, 1, 8, 4, 300, 300, 256, True, 0, 50.0, {}),
        ("d256_fp32_window", f32, 1, 4, 2, 512, 512, 256, True, 100, 0.0, {}),
        # head_dim 256 with every other mode (attn_fwd_d256.cu,
        # attn_fwd_d256_seg.cu): ALiBi, dropout, segment ids and fp8 V at
        # the 64-key tiles' and 128-row tiles' edges (ragged Nq / Nkv, GQA,
        # window, softcap where the mode allows it), in bf16, fp16 and fp32
        ("d256_alibi_gemma_prefill_2048", bf16, 1, 8, 4, 2048, 2048, 256, True, 0, 0.0,
         alibi),
        ("d256_alibi_softcap_window_fp16_n300", f16, 1, 8, 4, 300, 300, 256, True, 100, 50.0,
         alibi),
        ("d256_alibi_cross_tails_bf16", bf16, 2, 4, 2, 129, 385, 256, True, 0, 0.0, alibi),
        ("d256_alibi_fp32_cross", f32, 1, 4, 2, 100, 300, 256, True, 0, 0.0, alibi),
        ("d256_dropout_bf16_n1024", bf16, 2, 8, 4, 1024, 1024, 256, True, 0, 0.0, drop),
        ("d256_dropout_window_softcap_fp16_n8192", f16, 1, 8, 4, 8192, 8192, 256, True, 4096,
         50.0, drop),
        ("d256_dropout_fp32_tail", f32, 1, 4, 2, 130, 161, 256, True, 0, 0.0, drop),
        ("d256_alibi_dropout_noncausal_tail_bf16", bf16, 2, 4, 2, 300, 1000, 256, False, 0,
         0.0, both),
        ("d256_alibi_dropout_window63_fp16_n129", f16, 1, 4, 1, 129, 129, 256, True, 63, 0.0,
         both),
        ("d256_alibi_dropout_fp32_gqa", f32, 2, 8, 2, 256, 256, 256, True, 0, 0.0, both),
        ("d256_seg_loader_gemma_n8192", bf16, 2, 8, 4, 8192, 8192, 256, True, 0, 0.0,
         dict(seg="loader")),
        ("d256_seg_bf16_causal_gqa_tails", bf16, 2, 8, 2, 333, 333, 256, True, 0, 0.0, seg),
        ("d256_seg_fp16_cross_empty_rows", f16, 2, 4, 2, 300, 1000, 256, False, 0, 0.0, cross),
        ("d256_seg_bf16_cross_causal", bf16, 1, 4, 1, 300, 700, 256, True, 0, 0.0, cross),
        ("d256_seg_window_softcap_bf16", bf16, 1, 8, 4, 1024, 1024, 256, True, 256, 50.0, seg),
        ("d256_seg_alibi_dropout_fp16", f16, 2, 8, 4, 1024, 1024, 256, True, 0, 0.0,
         dict(both, seg="packed")),
        ("d256_seg_fp32_cross_empty_rows", f32, 2, 4, 2, 200, 500, 256, False, 0, 0.0, cross),
        ("d256_seg_fp32_alibi_dropout", f32, 2, 4, 2, 256, 256, 256, True, 0, 0.0,
         dict(both, seg="packed")),
        ("d256_fp8v_e4m3_gemma_prefill_2048", bf16, 1, 8, 4, 2048, 2048, 256, True, 0, 50.0,
         dict(v8="e4m3")),
        ("d256_fp8v_e5m2_gemma_prefill_2048", bf16, 1, 8, 4, 2048, 2048, 256, True, 0, 0.0,
         dict(v8="e5m2")),
        ("d256_fp8v_e4m3_fp16_window_tail", f16, 1, 4, 2, 300, 700, 256, True, 100, 0.0,
         dict(v8="e4m3")),
        ("d256_fp8v_e5m2_fp16_noncausal", f16, 2, 4, 2, 129, 385, 256, False, 0, 0.0,
         dict(v8="e5m2")),
        ("d256_fp8v_e4m3_seg_alibi_dropout_bf16", bf16, 2, 8, 4, 1024, 1024, 256, True, 0,
         0.0, dict(both, seg="packed", v8="e4m3")),
        ("d256_fp8v_e5m2_seg_cross_fp16", f16, 1, 4, 2, 300, 1000, 256, False, 0, 0.0,
         dict(seg="cross", v8="e5m2")),
        ("d256_fp8v_e4m3_fp32", f32, 1, 4, 2, 256, 256, 256, True, 0, 0.0, dict(v8="e4m3")),
        ("d256_fp8v_e5m2_fp32_seg_tail", f32, 1, 4, 2, 300, 300, 256, True, 0, 50.0,
         dict(v8="e5m2", seg="packed")),
    ]
    results = {}
    for case in cases:
        results[case[0]] = fwd_case(dev, gen, case)
    torch.cuda.empty_cache()
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"forward kernel disagrees with its plain version: {bad}")
    return results


def fwd_case(dev, gen, case, phase="fwd_check", repeat=False):
    """One forward check case (name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal,
    window, softcap, mods): the kernel once on the route fwd_route names
    (with ``repeat`` twice, O and lse bit for bit) and its plain version on
    the same inputs; emits and returns the record."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import (
        DEFAULT_MASK_VALUE, attn_fwd, attn_fwd_plain, fwd_route,
    )

    name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap, mod = case
    q = _rand(gen, (b, hq, nq, d), dt, dev)
    k = _rand(gen, (b, hkv, nkv, d), dt, dev)
    v = _rand(gen, (b, hkv, nkv, d), dt, dev)
    if mod.get("v8"):
        v = v.to(getattr(torch, FP8_V[mod["v8"]]))
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=cap,
              **case_kwargs(hq, b, nq, nkv, dev, mod))
    route = fwd_route(dt, d, "q_seg" in kw, bool(mod.get("v8")))
    fwd_routes(zero=True)
    got = attn_fwd(q, k, v, **kw)
    routes = fwd_routes()
    want = attn_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    rec, ok = fwd_errors(got, want, dt)
    rec["route"] = route
    rec["on_its_route"] = all_on(routes, route, 1)
    ok &= rec["on_its_route"]
    if repeat:
        rec["bitwise_repeatable"] = all(torch.equal(x, y)
                                        for x, y in zip(got, attn_fwd(q, k, v, **kw)))
        ok &= rec["bitwise_repeatable"]
    rec["ok"] = ok
    if "q_seg" in kw:
        rec["empty_rows"] = int((want[1] == DEFAULT_MASK_VALUE).sum())
    emit({"phase": phase, "case": name, "dtype": str(dt),
          "shape": [b, hq, hkv, nq, nkv, d], "causal": causal,
          "window": window, "softcap": cap, "alibi": bool(mod.get("alibi")),
          "dropout_rate": mod.get("rate", 0.0), "segments": mod.get("seg"),
          "fp8_v": mod.get("v8"), **rec})
    return rec


def phase_mask(dev):
    """The forward kernel's dropout mask read back directly: Nkv = d (128,
    and 256 for the head-dim-256 build), V = I and one q row per key,
    non-causal, so O = diag(1/l)·(P∘M) with every P > 0, and O is 0 exactly
    where the mask drops.  The zero pattern of O must equal
    ops/fwd_kernel.py dropout_keep_mask (the plain mask) at every element,
    in fp32 and bf16; the kept share must lie within 3σ of 1 − rate."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, dropout_keep_mask

    gen = torch.Generator(device=dev).manual_seed(5)
    b, hq, hkv, rate, seed = 4, 8, 2, 0.1, 1299709 * 3
    checks, rec = {}, {}
    for dt, n in ((torch.float32, 128), (torch.bfloat16, 128), (torch.float32, 256),
                  (torch.bfloat16, 256)):
        rows = torch.arange(n, device=dev)
        want_drop = dropout_keep_mask(seed, torch.arange(b, device=dev)[:, None, None, None],
                                      torch.arange(hq, device=dev)[None, :, None, None],
                                      rows[None, None, :, None], rows[None, None, None, :],
                                      rate) == 0
        q = _rand(gen, (b, hq, n, n), dt, dev)
        k = _rand(gen, (b, hkv, n, n), dt, dev)
        v = torch.eye(n, device=dev, dtype=dt).expand(b, hkv, n, n).contiguous()
        o, _ = attn_fwd(q, k, v, causal=False, sm_scale=n ** -0.5, dropout_rate=rate,
                        dropout_seed=seed)
        torch.cuda.synchronize()
        got_drop = o == 0
        mismatches = int((got_drop != want_drop).sum())
        kept = 1.0 - float(got_drop.float().mean())
        sigma = (rate * (1 - rate) / got_drop.numel()) ** 0.5
        name = f"{str(dt).split('.')[-1]}_d{n}"
        rec[name] = {"mismatches": mismatches, "elements": got_drop.numel(),
                     "kept_share": kept, "sigma": sigma}
        checks[f"{name}_zero_pattern_equals_mask"] = mismatches == 0
        checks[f"{name}_keep_rate_within_3_sigma"] = abs(kept - (1 - rate)) <= 3 * sigma
    emit({"phase": "mask_check", "rate": rate, "seed": seed,
          "shape": [b, hq, hkv, "n", "n", "n"], **rec, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dropout mask check failed: {failed}")
    return rec


# The reference's fp32 gradient ladder (tests/test_backward.py:25).
BWD_FP32_ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
BWD_FP32_RTOL = 1e-5
# bf16/fp16: max |kernel - plain| over max |plain| per gradient.  The
# kernels round P and dS to the input type before each product (2^-9 of
# relative error per term in bf16, 2^-12 in fp16) and the plain version
# does not; the sums of those roundings stay well under 1e-2 of the
# gradient's largest entry, while a wrong mask or scale moves whole rows.
BWD_LOWP_REL = 2e-2


def bwd_errors(got, want, dtype):
    """Per-gradient errors of (dq, dk, dv) against the plain version, and
    whether each meets the tolerance for ``dtype``."""
    import torch

    rec, ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        scale = float(b.abs().max())
        rec[f"max_abs_err_{name}"] = float(err.max())
        rec[f"rel_err_{name}"] = float(err.max()) / max(scale, 1e-30)
        if dtype == torch.float32:
            ok &= bool((err <= BWD_FP32_ATOL[name] + BWD_FP32_RTOL * b.abs()).all())
        else:
            ok &= float(err.max()) <= BWD_LOWP_REL * scale
        ok &= bool(torch.isfinite(a).all())
    rec["tolerance"] = ("fp32 ladder: dQ 9e-4, dK 7e-4, dV 7e-5, rtol 1e-5"
                        if dtype == torch.float32 else
                        f"max error <= {BWD_LOWP_REL} x max |plain| per gradient")
    return rec, ok


BF16, F16, F32 = "bfloat16", "float16", "float32"
_ALIBI, _DROP = dict(alibi=True), dict(rate=0.1, seed=11)
_BOTH = dict(alibi=True, rate=0.1, seed=2 ** 31 - 1)
BWD_CASES = [
    # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, sm_scale, mods
    ("train_B2_H32_N2048", BF16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0, None, {}),
    ("fp32_golden_causal", F32, 2, 2, 2, 256, 256, 128, True, 0, 0.0, 1.0, {}),
    ("fp32_golden_noncausal", F32, 2, 2, 2, 256, 256, 128, False, 0, 0.0, 1.0, {}),
    # fp32 twins of the masked bf16 cases: the fp32 kernels share the
    # tile ranges and masks, and the fp32 ladder sees a one-key slip
    ("fp32_window_softcap", F32, 1, 4, 2, 512, 512, 64, True, 100, 25.0, 1.0, {}),
    ("fp32_cross_empty_rows", F32, 1, 4, 2, 300, 200, 128, True, 0, 0.0, 1.0, {}),
    ("window256_softcap30", BF16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, None, {}),
    ("noncausal_cross_300_1000", BF16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0, None, {}),
    ("empty_rows_300_200", BF16, 1, 4, 2, 300, 200, 128, True, 0, 0.0, None, {}),
    ("fp16_mqa_bottom_right", F16, 1, 4, 1, 100, 700, 64, True, 0, 0.0, None, {}),
    ("causal_N16384", BF16, 1, 2, 2, 16384, 16384, 128, True, 0, 0.0, None, {}),
    ("alibi_train_B2_H32_N2048", BF16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0, None,
     _ALIBI),
    ("dropout_bf16", BF16, 1, 8, 2, 1024, 1024, 128, True, 0, 0.0, None, _DROP),
    ("alibi_dropout_train_B2_H32_N2048", BF16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0,
     None, _BOTH),
    ("fp32_alibi_dropout_gqa", F32, 2, 4, 2, 256, 256, 128, True, 0, 0.0, 1.0, _BOTH),
    ("fp32_alibi_cross_window_softcap", F32, 1, 4, 2, 300, 500, 64, True, 100, 25.0,
     1.0, _ALIBI),
    ("fp32_dropout_noncausal_tail", F32, 1, 4, 1, 100, 300, 64, False, 0, 0.0, 1.0,
     _DROP),
    # segment ids (packed sequences), alone and with ALiBi + dropout
    ("seg_train_B2_H32_N2048", BF16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0, None,
     dict(seg="loader")),
    ("seg_fp32_causal_gqa_tails", F32, 2, 4, 2, 300, 300, 128, True, 0, 0.0, 1.0,
     dict(seg="packed")),
    ("seg_fp32_cross_empty_rows", F32, 1, 4, 2, 200, 500, 64, False, 0, 0.0, 1.0,
     dict(seg="cross")),
    ("seg_bf16_cross_empty_rows", BF16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0, None,
     dict(seg="cross")),
    ("seg_fp16_cross_causal_d64", F16, 1, 4, 1, 300, 700, 64, True, 0, 0.0, None,
     dict(seg="cross")),
    ("seg_fp32_window_softcap", F32, 1, 4, 2, 512, 512, 64, True, 100, 25.0, 1.0,
     dict(seg="packed")),
    ("seg_bf16_window_softcap", BF16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, None,
     dict(seg="packed")),
    ("seg_alibi_dropout_bf16", BF16, 2, 8, 2, 1024, 1024, 128, True, 0, 0.0, None,
     dict(_BOTH, seg="packed")),
    ("seg_fp32_alibi_dropout_gqa", F32, 2, 4, 2, 256, 256, 128, True, 0, 0.0, 1.0,
     dict(_BOTH, seg="packed")),
    # the wgmma sweeps' tile edges (128-key / 128-row CTAs, 64-row steps):
    # every edge in bf16 and fp16 and at d 64 and 128
    # (tests/test_torch_bwd_route.py holds the plain version to JAX there)
    ("wg_n63_bf16_d64", BF16, 1, 4, 2, 63, 63, 64, True, 0, 0.0, None, {}),
    ("wg_n63_fp16", F16, 2, 4, 2, 63, 63, 128, True, 0, 0.0, None, {}),
    ("wg_n64_bf16", BF16, 1, 4, 2, 64, 64, 128, True, 0, 0.0, None, {}),
    ("wg_n64_fp16_d64", F16, 1, 4, 2, 64, 64, 64, True, 0, 0.0, None, {}),
    ("wg_n65_bf16_d64", BF16, 2, 4, 2, 65, 65, 64, True, 0, 0.0, None, {}),
    ("wg_n65_fp16", F16, 1, 4, 1, 65, 65, 128, False, 0, 0.0, None, {}),
    ("wg_n127_bf16", BF16, 1, 4, 2, 127, 127, 128, True, 0, 0.0, None, {}),
    ("wg_n127_fp16_d64", F16, 1, 4, 2, 127, 127, 64, True, 0, 0.0, None, {}),
    ("wg_n128_bf16_d64", BF16, 1, 4, 2, 128, 128, 64, True, 0, 0.0, None, {}),
    ("wg_n128_fp16", F16, 1, 4, 2, 128, 128, 128, True, 0, 0.0, None, {}),
    ("wg_n129_bf16", BF16, 2, 4, 2, 129, 129, 128, True, 0, 0.0, None, {}),
    ("wg_n129_fp16_d64", F16, 1, 4, 2, 129, 129, 64, False, 0, 0.0, None, {}),
    ("wg_n257_bf16_d64", BF16, 1, 4, 2, 257, 257, 64, True, 0, 0.0, None, {}),
    ("wg_n257_fp16", F16, 1, 4, 2, 257, 257, 128, True, 0, 0.0, None, {}),
    # bottom-right causal across lengths (Nq > Nkv: rows that see no key)
    ("wg_cross_63_257_bf16_d64", BF16, 1, 4, 2, 63, 257, 64, True, 0, 0.0, None, {}),
    ("wg_cross_129_385_fp16", F16, 1, 4, 2, 129, 385, 128, True, 0, 0.0, None, {}),
    ("wg_cross_257_129_bf16", BF16, 1, 4, 2, 257, 129, 128, True, 0, 0.0, None, {}),
    ("wg_cross_1_257_fp16_d64", F16, 1, 4, 2, 1, 257, 64, True, 0, 0.0, None, {}),
    # windows about one tile wide, with the softcap
    ("wg_window64_softcap_n300_bf16_d64", BF16, 1, 4, 2, 300, 300, 64, True, 64, 30.0,
     None, {}),
    ("wg_window127_softcap_n300_fp16", F16, 1, 4, 2, 300, 300, 128, True, 127, 30.0,
     None, {}),
    ("wg_window128_softcap_n300_bf16", BF16, 1, 4, 2, 300, 300, 128, True, 128, 30.0,
     None, {}),
    ("wg_window129_softcap_n300_fp16_d64", F16, 1, 4, 2, 300, 300, 64, True, 129, 30.0,
     None, {}),
    # GQA 8:1
    ("wg_gqa8_n129_bf16_d64", BF16, 1, 8, 1, 129, 129, 64, True, 0, 0.0, None, {}),
    ("wg_gqa8_noncausal_tail_fp16", F16, 1, 8, 1, 129, 257, 128, False, 0, 0.0, None, {}),
    # ALiBi + dropout, and segment ids, at an edge shape
    ("wg_alibi_dropout_n129_fp16_d64", F16, 2, 4, 2, 129, 129, 64, True, 0, 0.0, None,
     _BOTH),
    ("wg_seg_n257_bf16", BF16, 2, 4, 2, 257, 257, 128, True, 0, 0.0, None,
     dict(seg="packed")),
    # head dim 256 (Gemma's heads, 8 q / 4 kv; csrc/attn_bwd_d256.cu): none,
    # softcap 50 and window 4096 at Gemma-2-2B's training length (the window
    # bites at 8192), causal and not, Nq < Nkv, ragged tails at the 32-row
    # steps' edges, an explicit sm_scale, in bf16, fp16 and fp32
    ("d256_bf16_N2048", BF16, 1, 8, 4, 2048, 2048, 256, True, 0, 0.0, None, {}),
    ("d256_bf16_softcap50_N2048", BF16, 1, 8, 4, 2048, 2048, 256, True, 0, 50.0, None, {}),
    ("d256_bf16_window4096_softcap50_N8192", BF16, 1, 8, 4, 8192, 8192, 256, True, 4096,
     50.0, None, {}),
    ("d256_fp16_window4096_N8192", F16, 1, 8, 4, 8192, 8192, 256, True, 4096, 0.0, None,
     {}),
    ("d256_fp16_noncausal_tail_300_1000", F16, 1, 8, 4, 300, 1000, 256, False, 0, 0.0, None,
     {}),
    ("d256_bf16_noncausal_softcap_n97", BF16, 2, 8, 4, 97, 97, 256, False, 0, 50.0, None, {}),
    ("d256_fp16_cross_129_385_softcap", F16, 2, 8, 4, 129, 385, 256, True, 0, 50.0, None, {}),
    ("d256_bf16_cross_31_300", BF16, 1, 8, 4, 31, 300, 256, True, 0, 0.0, None, {}),
    ("d256_bf16_empty_rows_300_200", BF16, 1, 8, 4, 300, 200, 256, True, 0, 0.0, None, {}),
    ("d256_bf16_window33_n161", BF16, 1, 8, 4, 161, 161, 256, True, 33, 0.0, None, {}),
    ("d256_fp16_window100_softcap_n300_scale", F16, 1, 8, 4, 300, 300, 256, True, 100,
     50.0, 0.05, {}),
    ("d256_bf16_n32", BF16, 1, 8, 4, 32, 32, 256, True, 0, 0.0, None, {}),
    # near the cap: an sm_scale of 1.125 (18x the default 1/16) puts
    # |S sm_scale| at up to ~100, twice the cap of 50, where the tanh is
    # near saturation and the fast tanh's error shows most
    ("d256_bf16_nearcap_softcap50_N2048", BF16, 1, 8, 4, 2048, 2048, 256, True, 0, 50.0,
     1.125, {}),
    ("d256_fp16_nearcap_softcap50_window300_n1000", F16, 1, 8, 4, 1000, 1000, 256, True, 300,
     50.0, 1.125, {}),
    ("d256_fp16_n65_scale", F16, 1, 8, 4, 65, 65, 256, True, 0, 0.0, 0.1, {}),
    ("d256_fp32_causal_softcap", F32, 1, 8, 4, 256, 256, 256, True, 0, 50.0, None, {}),
    ("d256_fp32_window_softcap_cross", F32, 1, 8, 4, 200, 500, 256, True, 100, 50.0, None,
     {}),
    ("d256_fp32_noncausal_tail_scale", F32, 2, 8, 4, 130, 161, 256, False, 0, 0.0, 0.05, {}),
    ("d256_fp32_window_n8192", F32, 1, 8, 4, 8192, 8192, 256, True, 4096, 0.0, None, {}),
    # head dim 256 with ALiBi, dropout and segment ids (attn_bwd_d256.cu,
    # attn_bwd_d256_seg.cu), at the same edges: the training shape, windows
    # and softcaps, Nq != Nkv, rows that see no key, GQA 8:1 and 8:2
    ("d256_alibi_bf16_N2048", BF16, 1, 8, 4, 2048, 2048, 256, True, 0, 0.0, None, _ALIBI),
    ("d256_alibi_fp16_cross_129_385_softcap", F16, 2, 8, 4, 129, 385, 256, True, 0, 50.0,
     None, _ALIBI),
    ("d256_alibi_fp32_window_softcap_cross", F32, 1, 8, 4, 200, 500, 256, True, 100, 50.0,
     None, _ALIBI),
    ("d256_dropout_bf16_N2048", BF16, 1, 8, 4, 2048, 2048, 256, True, 0, 0.0, None, _DROP),
    ("d256_dropout_bf16_window4096_softcap50_N8192", BF16, 1, 8, 4, 8192, 8192, 256, True,
     4096, 50.0, None, _DROP),
    ("d256_dropout_fp16_noncausal_tail_300_1000", F16, 1, 8, 4, 300, 1000, 256, False, 0,
     0.0, None, _DROP),
    ("d256_dropout_fp32_noncausal_tail", F32, 2, 8, 4, 130, 161, 256, False, 0, 0.0, 0.05,
     _DROP),
    ("d256_alibi_dropout_bf16_window33_n161", BF16, 1, 8, 4, 161, 161, 256, True, 33, 0.0,
     None, _BOTH),
    ("d256_alibi_dropout_fp16_empty_rows_300_200", F16, 1, 8, 1, 300, 200, 256, True, 0,
     0.0, None, _BOTH),
    ("d256_alibi_dropout_fp32_gqa", F32, 2, 8, 2, 256, 256, 256, True, 0, 0.0, None, _BOTH),
    ("d256_seg_loader_bf16_N8192", BF16, 2, 8, 4, 8192, 8192, 256, True, 0, 0.0, None,
     dict(seg="loader")),
    ("d256_seg_bf16_cross_empty_rows", BF16, 2, 8, 4, 300, 1000, 256, False, 0, 0.0, None,
     dict(seg="cross")),
    ("d256_seg_fp16_window_softcap_n300", F16, 1, 8, 4, 300, 300, 256, True, 100, 50.0, None,
     dict(seg="packed")),
    ("d256_seg_alibi_dropout_bf16", BF16, 2, 8, 4, 1024, 1024, 256, True, 0, 0.0, None,
     dict(_BOTH, seg="packed")),
    ("d256_seg_fp32_cross_causal", F32, 1, 8, 4, 200, 500, 256, True, 0, 0.0, None,
     dict(seg="cross")),
    ("d256_seg_fp32_alibi_dropout_gqa", F32, 2, 8, 2, 130, 130, 256, True, 0, 0.0, None,
     dict(_BOTH, seg="packed")),
]


def bwd_routes(zero=False):
    """Each sweep's launches per route (ops/bwd_kernel.py
    BWD_ROUTE_LAUNCHES), set to 0 when ``zero``."""
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import BWD_ROUTE_LAUNCHES

    if zero:
        for routes in BWD_ROUTE_LAUNCHES.values():
            for route in routes:
                routes[route] = 0
    return {sweep: dict(routes) for sweep, routes in BWD_ROUTE_LAUNCHES.items()}


def bwd_case(dev, gen, case):
    """One bwd_check case: the three backward kernels twice (dQ/dK/dV must
    be bitwise equal, each sweep launched twice on the route bwd_route
    names) and the plain version once, on the same q/k/v/O/lse/dO; O and
    lse come from the forward kernel.  (record, ok)."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import (
        attn_bwd, attn_bwd_plain, bwd_route,
    )
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap, scale, mod = case
    dt = getattr(torch, dt)
    q = _rand(gen, (b, hq, nq, d), dt, dev)
    k = _rand(gen, (b, hkv, nkv, d), dt, dev)
    v = _rand(gen, (b, hkv, nkv, d), dt, dev)
    do = _rand(gen, (b, hq, nq, d), dt, dev)
    kw = dict(causal=causal, sm_scale=d ** -0.5 if scale is None else scale,
              window=window, softcap=cap, **case_kwargs(hq, b, nq, nkv, dev, mod))
    o, lse = attn_fwd(q, k, v, **kw)
    route = bwd_route(dt, d, "q_seg" in kw)
    bwd_routes(zero=True)
    got = attn_bwd(q, k, v, o, lse, do, **kw)
    again = attn_bwd(q, k, v, o, lse, do, **kw)
    routes = bwd_routes()
    want = attn_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    rec, ok = bwd_errors(got, want, dt)
    rec["bitwise_repeatable"] = all(torch.equal(a, c) for a, c in zip(got, again))
    rec["route"] = route
    rec["on_its_route"] = all(all_on(r, route, 2) for r in routes.values())
    rec["ok"] = ok and rec["bitwise_repeatable"] and rec["on_its_route"]
    rec = {"case": name, "dtype": str(dt), "shape": [b, hq, hkv, nq, nkv, d],
           "causal": causal, "window": window, "softcap": cap, "sm_scale": kw["sm_scale"],
           "alibi": bool(mod.get("alibi")), "dropout_rate": mod.get("rate", 0.0),
           "segments": mod.get("seg"), **rec}
    del q, k, v, do, o, lse, got, again, want
    return rec, rec["ok"]


def phase_bwd(dev):
    """Every case of BWD_CASES (:func:`bwd_case`)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    results = {}
    for case in BWD_CASES:
        rec, _ = bwd_case(dev, gen, case)
        results[case[0]] = rec
        emit({"phase": "bwd_check", **rec})
    torch.cuda.empty_cache()
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"backward kernels disagree with their plain version: {bad}")
    return results


# The bwd_check cases each mutant runs (those of its head dims): the
# training shapes (many q steps a CTA, so the producer refills stages the
# consumers still read), the tile edges, a window, ALiBi + dropout.
MUTANT_CASES = ("train_B2_H32_N2048", "alibi_dropout_train_B2_H32_N2048",
                "wg_n129_bf16", "wg_n257_bf16_d64", "wg_cross_129_385_fp16",
                "wg_window128_softcap_n300_bf16", "d256_bf16_N2048",
                "d256_fp16_cross_129_385_softcap", "d256_bf16_window33_n161",
                "d256_dropout_bf16_N2048", "d256_alibi_dropout_bf16_window33_n161")
# The dK/dV build a mutant of each source replaces (ops/bwd_kernel.py
# attribute, C entry, the build's head dim).
MUTANT_TARGETS = {"attn_bwd.cu": ("DKV_KERNEL", "attn_bwd_dkv", 128),
                  "attn_bwd_d256.cu": ("DKV_D256_KERNEL", "attn_bwd_dkv_d256", 256)}


def phase_mutants(dev, builds):
    """Each broken copy of BWD_MUTANTS (built by :func:`start_mutant_builds`)
    in place of the dK/dV build of its source (MUTANT_TARGETS), on the
    MUTANT_CASES of that build's head dims: every mutant must fail at least
    one case."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk

    checks, out = {}, {}
    wait = wait_mutant_builds(builds)
    for name, (_, lib, source) in builds.items():
        attr, symbol, head_dim = MUTANT_TARGETS[source]
        cases = [c for c in BWD_CASES if c[0] in MUTANT_CASES and c[7] == head_dim
                 and "seg" not in c[12]]
        gen = torch.Generator(device=dev).manual_seed(4)
        failed = []
        real = getattr(bk, attr)
        try:
            setattr(bk, attr, _cuda.CudaKernel(source, symbol, bk._DKV_ARGS, library=lib))
            for case in cases:
                rec, ok = bwd_case(dev, gen, case)
                if not ok:
                    failed.append(case[0])
                out.setdefault(name, {})[case[0]] = {
                    k: rec[k] for k in ("rel_err_dq", "rel_err_dk", "rel_err_dv",
                                        "bitwise_repeatable", "ok")}
        finally:
            setattr(bk, attr, real)
        checks[f"{name}_fails_bwd_check"] = bool(failed)
        emit({"phase": "mutants", "mutant": name, "edits": BWD_MUTANTS[name][2],
              "failed_cases": failed, "cases": out[name]})
    torch.cuda.empty_cache()
    emit({"phase": "mutants", "checks": checks, "build_wait_seconds": wait})
    survived = [k for k, ok in checks.items() if not ok]
    if survived:
        raise AssertionError(f"mutants passed bwd_check: {survived}")
    return checks


def kv_kind(name):
    """The port's KV dtype argument for a kind name."""
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16,
            "int8": torch.int8,
            "int4": "int4", "e4m3": torch.float8_e4m3fn,
            "e5m2": torch.float8_e5m2}[name]


def _paged_inputs(gen, dev, q_dtype, kind, b, hq, hkv, d, page_size, pps,
                  lengths, num_pages, t_new=0):
    """q ([B, Hq, d], or [B, Hq, T, d] when ``t_new``), the K/V pools of
    ``kind`` (value pools of q's dtype, or random pages quantized on the
    card), lengths and a shuffled page table."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.decode import quantize_kv_pages

    q = _rand(gen, (b, hq, t_new, d) if t_new else (b, hq, d), q_dtype, dev)
    quantized = kind in QUANT_KINDS
    pool_dtype = torch.float32 if quantized else q_dtype
    kp = _rand(gen, (hkv, num_pages, page_size, d), pool_dtype, dev)
    vp = _rand(gen, (hkv, num_pages, page_size, d), pool_dtype, dev)
    if quantized:
        kp, vp = quantize_kv_pages(kp, kv_kind(kind)), quantize_kv_pages(vp, kv_kind(kind))
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, table


def abs_v_pools(k, v):
    """(K, |V|) holding the same logical values as (K, V), in a kind the
    plain versions take: int4 becomes int8 payloads with the same scales."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.quantization import (
        Int4QuantizedTensor, QuantizedTensor, unpack_int4_rows,
    )

    if torch.is_tensor(v):
        return k, v.abs()
    if isinstance(v, Int4QuantizedTensor):
        k = QuantizedTensor(unpack_int4_rows(k.values).to(torch.int8), k.scales)
        v = QuantizedTensor(unpack_int4_rows(v.values).to(torch.int8), v.scales)
    return k, QuantizedTensor(v.values.float().abs().to(v.dtype), v.scales)


def paged_errors(got, want, dtype, spread=None):
    """Errors of a paged kernel's (O, lse or None) against its plain
    version's, and whether they meet the tolerance for q's ``dtype``.

    In bf16/fp16 each side rounds its fp32 O to q's dtype: per element they
    may differ by 1e-4 + eps x |O|.  Where both sides also round P (times
    the V scale) to q's dtype before P V -- quantized single-token pools and
    the verify kernel's tensor cores -- the kernel does so relative to each
    tile's running max and the plain version relative to the row's max, and
    ``spread`` = P|V| (the plain version's output over |V|) adds
    eps x P|V|.  On bf16 value pools the single-token kernel keeps P in
    fp32 and its plain version is the fp32 oracle: no ``spread``.  fp32
    computes in true fp32 on both sides: atol 1e-4."""
    import torch

    (o, lse), (o_ref, lse_ref) = got, want
    diff = (o.float() - o_ref.float()).abs()
    err_l = 0.0 if lse is None else float((lse - lse_ref).abs().max())
    if dtype == torch.float32:
        ok = float(diff.max()) <= 1e-4 and err_l <= 1e-4
        tol = "O and lse: atol 1e-4"
        slack = 0.0
    else:
        eps = torch.finfo(dtype).eps
        limit = 1e-4 + eps * o_ref.float().abs()
        if spread is not None:
            limit = limit + eps * spread.float()
        ok = bool((diff <= limit).all()) and err_l <= 1e-3
        pv = "" if spread is None else " + P|V|"
        tol = f"O: 1e-4 + {eps:g} x (|O|{pv}), lse: atol 1e-3"
        slack = float((diff / limit).max())
    ok &= bool(torch.isfinite(o).all())
    return {"max_abs_err_o": float(diff.max()), "max_abs_err_lse": err_l,
            "worst_err_over_limit": slack,
            "frac_o_differs": float((diff > 0).float().mean()),
            "tolerance": tol, "ok": ok}


# B8 x 2176 tokens of page table; ragged lengths up to 2112, an empty one
DECODE_B8_LENGTHS = [0, 1, 129, 700, 1337, 2047, 2048, 2112]


def edge_cases(num_sms):
    """decode_check cases at the key-split and tile edges, from the planner
    (ops/decode.py decode_splits) at this card's SM count: lengths 0, 1,
    exactly on the first split boundary, one past it and the full table at
    page sizes 16, 64 and 128 (bf16 and int4 pools); B1 and B32; softcap
    with ALiBi; verify at T = 1, 4, 64, 255 and 256 with row horizons
    inside tiles (lengths 1000 and 1717), on every pool kind at T = 4 and on
    16-token pages."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.decode import decode_splits, split_pages

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    hq, hkv, d, table = 16, 8, 128, 2176

    def edges(b, ps):
        pps = table // ps
        per, _ = split_pages(pps, decode_splits(b, hkv, pps, ps, num_sms))
        return pps, [0, 1, per * ps, per * ps + 1, pps * ps]

    cases = []
    for kind in ("bf16", "int4"):
        for ps in (16, 64, 128):
            pps, lengths = edges(5, ps)
            cases.append((f"edges_{kind}_page{ps}_B5", bf16, kind,
                          (5, hq, hkv, d, ps, pps, lengths), 0.0, 0, False))
    pps, lengths = edges(32, 128)
    b32 = lengths + [(37 * i * i + 11 * i) % (table + 1) for i in range(27)]
    cases += [
        ("edges_bf16_B1", bf16, "bf16", (1, hq, hkv, d, 128, pps, [1000]), 0.0, 0, False),
        ("edges_int4_B1_page16", bf16, "int4", (1, hq, hkv, d, 16, table // 16, [2176]), 0.0,
         0, False),
        ("edges_bf16_B32", bf16, "bf16", (32, hq, hkv, d, 128, pps, b32), 0.0, 0, False),
        ("edges_int8_B32", bf16, "int8", (32, hq, hkv, d, 128, pps, b32), 0.0, 0, False),
    ]
    pps, lengths = edges(5, 128)
    cases += [(f"softcap_alibi_{kind}_B5", bf16, kind, (5, hq, hkv, d, 128, pps, lengths),
               30.0, 0, True) for kind in ("bf16", "int8", "int4")]
    horizons = (2, hq, hkv, d, 128, pps, [1000, 1717])
    cases += [(f"verify_T{t}_bf16_horizons", bf16, "bf16", horizons, 0.0, t, False)
              for t in (1, 4, 64, 255, 256)]
    cases += [(f"verify_T255_{kind}_horizons_softcap_alibi", bf16, kind, horizons, 30.0, 255,
               True) for kind in ("bf16", "int8")]
    cases += [(f"verify_T4_{kind}_kinds", bf16, kind, horizons, 0.0, 4, False)
              for kind in ("int8", "int4", "e4m3", "e5m2")]
    cases += [("verify_T4_fp16_kinds", f16, "fp16", horizons, 0.0, 4, False),
              ("verify_T4_fp32_kinds", f32, "fp32", horizons, 0.0, 4, False)]
    page16 = (2, hq, hkv, d, 16, table // 16, [1000, 1717])
    cases += [(f"verify_T64_{kind}_page16", bf16, kind, page16, 0.0, 64, False)
              for kind in ("bf16", "int8", "int4")]
    cases.append(("verify_T256_bf16_page16_alibi", bf16, "bf16", page16, 0.0, 256, True))
    return cases


# Gemma-2-2B's paged shapes: 8 q / 4 kv heads of 256, 17 pages of 128 (a
# 2176-token table), ragged lengths; its attention softcap 50.
GEMMA_PAGED = (4, 8, 4, 256, 128, 17, [2048, 1300, 777, 200])
GEMMA_SOFTCAP = 50.0


def d256_cases():
    """decode_check cases at head_dim 256: decode on all seven pool kinds
    with the softcap off and on, without and with ALiBi, B8 with an empty
    sequence, 16-token pages (per-row copies); verify on the wgmma route
    (bf16 and fp16 pools, int8, int4, e4m3, e5m2) and the fp32 route, a
    256-token chunk and a round of 4, each pool kind also with ALiBi."""
    import torch

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    q_of = {"fp32": f32, "fp16": f16}
    cases = [(f"d256_{kind}_softcap{int(cap)}{'_alibi' if alibi else ''}",
              q_of.get(kind, bf16), kind, GEMMA_PAGED, cap, 0, alibi)
             for kind in ("bf16", "fp16", "fp32") + QUANT_KINDS for cap in (0.0, GEMMA_SOFTCAP)
             for alibi in (False, True)]
    b8 = (8, 8, 4, 256, 128, 17, DECODE_B8_LENGTHS)
    page16 = (2, 8, 4, 256, 16, 136, [1000, 2176])
    cases += [
        ("d256_bf16_B8_empty", bf16, "bf16", b8, GEMMA_SOFTCAP, 0, False),
        ("d256_int8_B8_empty", bf16, "int8", b8, 0.0, 0, False),
        ("d256_bf16_page16", bf16, "bf16", page16, GEMMA_SOFTCAP, 0, False),
        ("d256_int4_page16", bf16, "int4", page16, 0.0, 0, False),
        ("d256_verify_T256_bf16", bf16, "bf16", GEMMA_PAGED, GEMMA_SOFTCAP, 256, False),
        ("d256_verify_T256_int8", bf16, "int8", GEMMA_PAGED, GEMMA_SOFTCAP, 256, False),
        ("d256_verify_T4_bf16", bf16, "bf16", GEMMA_PAGED, 0.0, 4, False),
        ("d256_verify_T4_fp16", f16, "fp16", GEMMA_PAGED, GEMMA_SOFTCAP, 4, False),
        ("d256_verify_T4_int4", bf16, "int4", GEMMA_PAGED, GEMMA_SOFTCAP, 4, False),
        ("d256_verify_T4_e4m3", bf16, "e4m3", GEMMA_PAGED, 0.0, 4, False),
        ("d256_verify_T64_bf16_page16", bf16, "bf16", page16, GEMMA_SOFTCAP, 64, False),
        ("d256_verify_fp32_T32", f32, "fp32", GEMMA_PAGED, GEMMA_SOFTCAP, 32, False),
        ("d256_verify_fp32_int8_T5", f32, "int8", GEMMA_PAGED, 0.0, 5, False),
        # ALiBi: every pool kind, the softcap off and on, chunk and round
        ("d256_alibi_B8_empty_int4", bf16, "int4", b8, GEMMA_SOFTCAP, 0, True),
        ("d256_alibi_page16_bf16", bf16, "bf16", page16, 0.0, 0, True),
        ("d256_alibi_verify_T256_bf16", bf16, "bf16", GEMMA_PAGED, 0.0, 256, True),
        ("d256_alibi_verify_T256_bf16_softcap", bf16, "bf16", GEMMA_PAGED, GEMMA_SOFTCAP,
         256, True),
        ("d256_alibi_verify_T256_int8_softcap", bf16, "int8", GEMMA_PAGED, GEMMA_SOFTCAP,
         256, True),
        ("d256_alibi_verify_T4_fp16_softcap", f16, "fp16", GEMMA_PAGED, GEMMA_SOFTCAP, 4,
         True),
        ("d256_alibi_verify_T4_int4", bf16, "int4", GEMMA_PAGED, 0.0, 4, True),
        ("d256_alibi_verify_T4_e4m3_softcap", bf16, "e4m3", GEMMA_PAGED, GEMMA_SOFTCAP, 4,
         True),
        ("d256_alibi_verify_T4_e5m2", bf16, "e5m2", GEMMA_PAGED, 0.0, 4, True),
        ("d256_alibi_verify_T64_int8_page16", bf16, "int8", page16, 0.0, 64, True),
        ("d256_alibi_verify_fp32_T32_softcap", f32, "fp32", GEMMA_PAGED, GEMMA_SOFTCAP, 32,
         True),
        ("d256_alibi_verify_fp32_e5m2_T5", f32, "e5m2", GEMMA_PAGED, 0.0, 5, True),
    ]
    return cases


def paged_ctas(t_new, route, splits, b, hq, hkv, d=128):
    """CTAs one paged call launches: decode one per split, head pair, kv
    head and sequence; verify one per split, kv head, sequence and block
    of rows (ops/decode.py verify_ctas_per_split: 128 rows on the wgmma
    route; 64 on the others, a cluster of the CTAs that split the head dim
    on wide_wgmma, one 128-column chunk of it a CTA on wide_fp32)."""
    from flash_attention_dlrs_tpu_torch.ops.decode import verify_ctas_per_split

    g = hq // hkv
    if not t_new:
        return splits * -(-g // 2) * hkv * b
    return splits * verify_ctas_per_split(route, t_new * g, d) * hkv * b


def paged_case(dev, gen, case):
    """One decode_check case: the kernel twice (O and lse must repeat bit
    for bit), its plain version (decode: with the kernel's split count) on
    the same inputs, the errors, the split count, the route and the CTAs."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm

    name, dt, kind, (b, hq, hkv, d, ps, pps, lengths), cap, t_new, alibi = case
    q, kp, vp, lens, table = _paged_inputs(
        gen, dev, dt, kind, b, hq, hkv, d, ps, pps, lengths,
        num_pages=b * pps + 8, t_new=t_new)
    kw = dict(logit_softcap=cap, sm_scale=d ** -0.5,
              alibi_slopes=mods(hq, alibi)["alibi_slopes"])
    dm.DECODE_SPLITS.clear()
    dm.VERIFY_SPLITS.clear()
    for r in dm.VERIFY_ROUTE_LAUNCHES:
        dm.VERIFY_ROUTE_LAUNCHES[r] = 0
    if t_new:
        first = (dm.paged_verify_attention(q, kp, vp, lens, table, **kw), None)
        again = (dm.paged_verify_attention(q, kp, vp, lens, table, **kw), None)
        splits = list(dm.VERIFY_SPLITS)
        route = [r for r, n in dm.VERIFY_ROUTE_LAUNCHES.items() if n]
        want = (dm.paged_verify_plain(q, kp, vp, lens, table, **kw), None)
        spread = dm.paged_verify_plain(q, *abs_v_pools(kp, vp), lens, table, **kw)
    else:
        build = dm.paged_kernels(d)[0]
        before = build.launches
        first = dm.paged_decode_attention(q, kp, vp, lens, table, return_lse=True, **kw)
        again = dm.paged_decode_attention(q, kp, vp, lens, table, return_lse=True, **kw)
        # decode has one route a build: the build of the pool's head dim
        route = [build.symbol] if build.launches - before == 2 else ["not its build"]
        splits = list(dm.DECODE_SPLITS)
        kw["splits"] = splits[0]
        want = dm.paged_decode_plain(q, kp, vp, lens, table, return_lse=True, **kw)
        spread = (None if torch.is_tensor(vp) else
                  dm.paged_decode_plain(q, *abs_v_pools(kp, vp), lens, table, **kw))
    torch.cuda.synchronize()
    rec = paged_errors(first, want, dt, spread)
    rec["bitwise_repeatable"] = all(
        x is None or torch.equal(x, y) for x, y in zip(first, again))
    rec["ok"] &= rec["bitwise_repeatable"] and len(splits) == 1 and len(route) == 1
    rec.update(splits=splits[0] if len(splits) == 1 else splits,
               route=route[0] if len(route) == 1 else route,
               ctas=paged_ctas(t_new, route[0], splits[0], b, hq, hkv, d))
    del q, kp, vp, first, again, want
    return rec


def phase_decode(dev, cases=None, phase="decode_check"):
    """Each paged kernel mode against its plain version on the same inputs,
    twice (bitwise repeatable): the single-token kernel on value and
    quantized pools (int8 / int4 take the integer score route), softcap, an
    empty sequence; the verify kernel at T = 4 and T = 256 (a prefill
    chunk), bf16 on the tensor cores and fp32 on the CUDA cores; ALiBi; and
    the key-split and tile edges of :func:`edge_cases`.  ``cases`` (names)
    runs a subset."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    serve = (8, 16, 8, 128, 128, 17, DECODE_B8_LENGTHS)
    small = (3, 8, 2, 64, 64, 8, [0, 300, 512])
    all_cases = [
        # name, q dtype, kv kind, (B, Hq, Hkv, d, page, pps, lengths), softcap, T, ALiBi
        ("serve_decode", bf16, "bf16", (4, 16, 8, 128, 128, 16, [2048, 1300, 777, 200]), 0.0, 0, False),
        ("ragged_empty_softcap", bf16, "bf16", (4, 16, 8, 128, 128, 16, [0, 1, 129, 2047]), 30.0, 0, False),
        ("fp32_d64", f32, "fp32", (3, 8, 2, 64, 64, 8, [5, 300, 512]), 0.0, 0, False),
        *[(f"{k}_B8", bf16, k, serve, 0.0, 0, False) for k in QUANT_KINDS],
        ("int8_B8_softcap", bf16, "int8", serve, 30.0, 0, False),
        ("fp32_int4_d64", f32, "int4", (3, 8, 2, 64, 64, 8, [0, 300, 512]), 0.0, 0, False),
        ("verify_T4_bf16", bf16, "bf16", serve, 0.0, 4, False),
        ("verify_T4_int8", bf16, "int8", serve, 0.0, 4, False),
        ("verify_T256_bf16", bf16, "bf16", serve, 0.0, 256, False),
        ("verify_T256_int8", bf16, "int8", serve, 0.0, 256, False),
        ("verify_T4_int4_softcap", bf16, "int4", serve, 30.0, 4, False),
        ("verify_T4_e4m3", bf16, "e4m3", serve, 0.0, 4, False),
        ("verify_fp32_int8_d64", f32, "int8", (3, 8, 2, 64, 64, 8, [3, 300, 512]), 0.0, 5, False),
        ("verify_fp32_values_T32", f32, "fp32", (2, 16, 8, 128, 128, 17, [40, 2100]), 0.0, 32, False),
        # ALiBi on all seven pool kinds, and verify with ALiBi
        *[(f"alibi_{k}_B8", bf16, k, serve, 0.0, 0, True) for k in ("bf16",) + QUANT_KINDS],
        ("alibi_fp32_d64", f32, "fp32", small, 0.0, 0, True),
        ("alibi_fp16_softcap_d64", f16, "fp16", small, 30.0, 0, True),
        ("alibi_fp32_int8_d64", f32, "int8", small, 0.0, 0, True),
        ("alibi_verify_T4_bf16", bf16, "bf16", serve, 0.0, 4, True),
        ("alibi_verify_T4_int8", bf16, "int8", serve, 0.0, 4, True),
        ("alibi_verify_T256_bf16", bf16, "bf16", serve, 0.0, 256, True),
        ("alibi_verify_T256_int8", bf16, "int8", serve, 0.0, 256, True),
        ("alibi_verify_fp32_int4_d64", f32, "int4", small, 0.0, 5, True),
        *edge_cases(torch.cuda.get_device_properties(dev).multi_processor_count),
        *d256_cases(),
    ]
    if cases is not None:  # a mutant's cases may be wide ones
        all_cases += wide_paged_cases(torch.cuda.get_device_properties(dev).multi_processor_count)
    results = {}
    for case in all_cases:
        name, dt, kind, (b, hq, hkv, d, ps, pps, lengths), cap, t_new, alibi = case[:7]
        if cases is not None and name not in cases:
            continue
        results[name] = paged_case(dev, gen, case)
        emit({"phase": phase, "case": name, "kernel":
              "paged_verify" if t_new else "paged_decode", "q_dtype": str(dt),
              "kv": kind, "tokens": t_new or 1, "shape": [b, hq, hkv, d, ps, pps],
              "lengths": lengths, "softcap": cap, "alibi": alibi, **results[name]})
    torch.cuda.empty_cache()
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad and phase == "decode_check":
        raise AssertionError(f"paged kernels disagree with their plain versions: {bad}")
    return results


# decode_check cases each paged mutant runs: splits past the first with
# keys (decode), and row horizons inside tiles below the split's end (verify).
PAGED_MUTANT_CASES = {
    "decode_combine_drops_last_split": ("serve_decode", "edges_bf16_page128_B5",
                                        "edges_int4_page16_B5", "edges_bf16_B1"),
    "wide_decode_merge_drops_last_split": ("d512_edges_bf16_page128_B5",
                                           "d512_edges_int4_page16_B5",
                                           "d512_edges_int8_page16_softcap_alibi_B5"),
    "wide_decode_drops_last_tile_row": ("d512_decode_e4m3_B8", "d512_decode_fp16_softcap_alibi",
                                        "d512_decode_fp32_values", "d512_edges_int4_page16_B5"),
    "verify_horizon_tile_unmasked": ("verify_T256_bf16", "verify_T255_bf16_horizons",
                                     "verify_T64_bf16_page16", "verify_T64_int8_page16"),
}


def phase_paged_mutants(dev, builds):
    """Each broken copy of PAGED_MUTANTS (built by
    :func:`start_mutant_builds`) in place of its kernel on its
    PAGED_MUTANT_CASES: every mutant must fail at least one case."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import decode as dm

    checks = {}
    wait = wait_mutant_builds(builds)
    attrs = {"paged_decode.cu": "DECODE_KERNEL", "paged_decode_wide.cu": "DECODE_WIDE_KERNEL",
             "paged_verify.cu": "VERIFY_KERNEL"}
    for name, (_, lib, source) in builds.items():
        attr = attrs[source]
        real = getattr(dm, attr)
        try:
            setattr(dm, attr, _cuda.CudaKernel(source, real.symbol, real.argtypes, library=lib))
            res = phase_decode(dev, PAGED_MUTANT_CASES[name], phase="paged_mutants")
        finally:
            setattr(dm, attr, real)
        failed = [n for n, r in res.items() if not r["ok"]]
        checks[f"{name}_fails_decode_check"] = bool(failed)
        emit({"phase": "paged_mutants", "mutant": name, "edits": PAGED_MUTANTS[name][2],
              "failed_cases": failed, "cases": {
                  n: {k: r[k] for k in ("max_abs_err_o", "worst_err_over_limit",
                                        "bitwise_repeatable", "ok")} for n, r in res.items()}})
    torch.cuda.empty_cache()
    emit({"phase": "paged_mutants", "checks": checks, "build_wait_seconds": wait})
    survived = [k for k, ok in checks.items() if not ok]
    if survived:
        raise AssertionError(f"paged mutants passed decode_check: {survived}")
    return checks


_WEIGHTS: dict = {}


def seeded_weights(cfg, seed=0):
    """``init_params_numpy(cfg, seed)``, drawn once a run for each set of
    widths (the fp32 tree does not depend on the dtype or the position
    encoding, nor on how the q and kv widths split into heads): the phases
    that rebuild the serving-bench or training-bench model, or re-head it
    at 512, reuse the host copy instead of drawing 0.8 / 1.5 B numbers
    again.  A bench model cut in depth (the scale-out phases) takes the
    bench tree's first layers, and one re-headed at another kv width (head
    dim 2048) the bench tree with wk and wv drawn anew from (seed, kv
    width) in init_params_numpy's scheme."""
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy

    key = (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_q_heads * cfg.head_dim,
           cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.tie_embeddings, seed)
    if key in _WEIGHTS:
        return _WEIGHTS[key]
    bench = next((b for b in (SERVE_CFG, TRAIN_CFG)
                  if (key[:2] + key[3:4] + key[5:] == (
                      b["vocab_size"], b["d_model"], b["n_q_heads"] * b["head_dim"], b["d_ff"],
                      cfg.tie_embeddings, seed) and key[2] <= b["n_layers"])), None)
    if bench is None or key[2:5:2] == (bench["n_layers"], bench["n_kv_heads"] * bench["head_dim"]):
        _WEIGHTS[key] = init_params_numpy(cfg, seed)
        return _WEIGHTS[key]
    tree = seeded_weights(ModelConfig(**bench, tie_embeddings=cfg.tie_embeddings), seed)
    layers = tree["layers"][:cfg.n_layers]
    if key[4] != bench["n_kv_heads"] * bench["head_dim"]:
        rng = np.random.default_rng((seed, key[4]))
        layers = [dict(layer) for layer in layers]
        for layer in layers:
            for name in ("wk", "wv"):
                layer[name] = rng.standard_normal((cfg.d_model, key[4]), dtype=np.float32)
                layer[name] *= np.float32(cfg.d_model ** -0.5)
    _WEIGHTS[key] = {**tree, "layers": layers}
    return _WEIGHTS[key]


SERVE_CFG = dict(vocab_size=32000, d_model=2048, n_layers=16, n_q_heads=16,
                 n_kv_heads=8, head_dim=128, d_ff=5504)
SERVE_PROMPTS = (200, 2048, 512, 1300, 777, 1800, 1024, 1536)
SERVE_NEW_TOKENS = 32

# Limits of the prefill-logit checks, as multiples of the logits' std.  In
# bf16 the 16 random layers amplify rounding: the plain path with its q·k
# sums merely reversed moved the logits by 0.061 x std, and the kernel path
# read 0.050 (fp32 P) and 0.068 (bf16 P) x std on H100 runs (RoPE model).
# The ALiBi model's logits are more sensitive: reversed sums moved them by
# 0.079 x std and the kernel path read 0.112 x std.  Each bf16 limit sits
# above its model's noise (the run reports the reversed-sum gap beside
# it); the fp32 limit, where the kernel computes in true fp32, is what
# separates a right kernel from a wrong one.
BF16_LOGIT_LIMIT = {"rope": 0.1, "alibi": 0.15}
FP32_LOGIT_LIMIT = 1e-3


def _prefill_paths(cfg, model, toks, lens):
    """Last-token logits of one prefill through the kernel path, through the
    plain path, and through the plain path with q and k reversed along
    head_dim (the same function, its q·k sums in another order: the noise
    floor), and the attention inputs of every layer on the kernel path."""
    from flash_attention_dlrs_tpu_torch.models import decoding, make_prefill
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    prefill = make_prefill(cfg)
    kernel_attention = decoding.flash_attention
    inputs = []

    def recording(q, k, v, **kw):
        inputs.append((q, k, v, kw))
        return kernel_attention(q, k, v, **kw)

    def plain(q, k, v, **kw):
        return attn_fwd_plain(q, k, v, **kernel_kwargs(q, kw))[0]

    def reordered(q, k, v, **kw):
        return plain(q.flip(-1), k.flip(-1), v, **kw)

    try:
        decoding.flash_attention = recording
        logits_k, _ = prefill(model, toks, lens)
        decoding.flash_attention = plain
        logits_p, _ = prefill(model, toks, lens)
        decoding.flash_attention = reordered
        logits_r, _ = prefill(model, toks, lens)
    finally:
        decoding.flash_attention = kernel_attention
    return logits_k, logits_p, logits_r, inputs


def kernel_kwargs(q, kw):
    """The forward kernel's keyword arguments of a model's attention call
    (its ``flash_attention`` keywords): the softmax scale of q's head dim
    unless given, the window, the softcap and the ALiBi slopes."""
    sm_scale = kw.get("sm_scale")
    return dict(causal=kw["causal"], sm_scale=q.shape[-1] ** -0.5 if sm_scale is None
                else sm_scale, window=kw.get("window", 0),
                softcap=kw.get("logit_softcap", 0.0), alibi_slopes=kw.get("alibi_slopes"))


def attention_errors(q, k, v, kw):
    """One recorded attention call again through the forward kernel and its
    plain version (q, k and v zero-padded to the kernels' head dim, as the
    op API pads them): :func:`fwd_errors`."""
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import (
        attn_fwd, attn_fwd_plain, kernel_width, pad_head_dim,
    )

    kw = kernel_kwargs(q, kw)
    q, k, v = (pad_head_dim(t, kernel_width(q.shape[-1])) for t in (q, k, v))
    return fwd_errors(attn_fwd(q, k, v, **kw), attn_fwd_plain(q, k, v, **kw), q.dtype)


def check_prefill(model, cfg, dev, prompt):
    """One prompt's prefill, kernel path against plain path, three ways:
    the bf16 model's logits (within BF16_LOGIT_LIMIT x std, the reordered
    plain path's gap reported beside it); every layer's
    attention on the bf16 kernel path's own inputs, at the kernel's
    tolerances (fwd_errors: O within max(2e-2, eps x |O|), lse atol 1e-3);
    and the same model in fp32, whose kernel path computes in true fp32
    (within FP32_LOGIT_LIMIT x std)."""
    import copy
    import dataclasses

    import torch

    t = len(prompt)
    toks = torch.zeros((1, 1 << max(7, (t - 1).bit_length())), dtype=torch.long,
                       device=dev)
    toks[0, :t] = torch.tensor(prompt, device=dev)
    lens = torch.tensor([t], dtype=torch.int32, device=dev)

    logits_k, logits_p, logits_r, inputs = _prefill_paths(cfg, model, toks, lens)
    diff, std = float((logits_k - logits_p).abs().max()), float(logits_p.std())
    floor = float((logits_r - logits_p).abs().max()) / std
    limit = BF16_LOGIT_LIMIT[cfg.position_encoding]

    err_o, err_l, layers_ok = [], [], True
    for q, k, v, kw in inputs:
        rec, ok = attention_errors(q, k, v, kw)
        layers_ok &= ok
        err_o.append(rec["max_abs_err_o"])
        err_l.append(rec["max_abs_err_lse"])

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    logits_k32, logits_p32, _, _ = _prefill_paths(cfg32, model32, toks, lens)
    diff32, std32 = (float((logits_k32 - logits_p32).abs().max()),
                     float(logits_p32.std()))
    del model32
    torch.cuda.empty_cache()

    finite = bool(torch.isfinite(logits_k).all() and torch.isfinite(logits_k32).all())
    return {
        "prefill_check_prompt_len": t,
        "prefill_logit_diff_over_std_bf16": diff / std,
        "prefill_logit_reordered_plain_over_std_bf16": floor,
        "prefill_logit_limit_over_std_bf16": limit,
        "prefill_logit_diff_over_std_fp32": diff32 / std32,
        "prefill_attention_layers_checked": len(inputs),
        "prefill_attention_max_abs_err_o": max(err_o),
        "prefill_attention_max_abs_err_lse": max(err_l),
        "checks": {
            "prefill_logits_bf16_kernel_vs_plain": diff <= limit * std and finite,
            "prefill_attention_every_layer_kernel_vs_plain":
                len(inputs) == cfg.n_layers and layers_ok,
            "prefill_logits_fp32_kernel_vs_plain":
                diff32 <= FP32_LOGIT_LIMIT * std32 and finite,
        },
    }


def phase_serve(dev):
    import torch
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, params_from_jax
    from flash_attention_dlrs_tpu_torch.ops.decode import DECODE_KERNEL
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import FWD_KERNEL
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    cfg = ModelConfig(**SERVE_CFG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = params_from_jax(seeded_weights(cfg), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    setup_s = time.perf_counter() - t0

    engine = DecodeEngine(model, cfg, num_pages=80, page_size=128, num_slots=4,
                          pages_per_seq=17, kv_dtype=torch.bfloat16, device=dev)
    # warm-up: one prompt per padded-length bucket the run uses, so the timed
    # prefills pay no first-call cost (cuBLAS plans, allocator growth)
    buckets = sorted({1 << max(7, (n - 1).bit_length()) for n in SERVE_PROMPTS})
    engine.generate([[1] * n for n in buckets], max_new_tokens=2)

    prefill_ms, decode_ms = [], []
    orig_prefill, orig_decode = engine._prefill, engine._decode_step
    engine._prefill = _timed(orig_prefill, prefill_ms)
    engine._decode_step = _timed(orig_decode, decode_ms)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    steps_before = engine.scheduler.stats.steps
    FWD_KERNEL.launches = 0
    DECODE_KERNEL.launches = 0
    fwd_routes(zero=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"attn_fwd": FWD_KERNEL.launches, "paged_decode": DECODE_KERNEL.launches}
    routes = fwd_routes()
    steps = engine.scheduler.stats.steps - steps_before
    engine._prefill, engine._decode_step = orig_prefill, orig_decode

    n_tok = sum(len(o) for o in outs)
    checks = {
        "every_request_32_tokens": all(len(o) == SERVE_NEW_TOKENS for o in outs),
        "tokens_in_vocab": all(0 <= x < cfg.vocab_size for o in outs for x in o),
        "fwd_launches_16_per_prefill": launches["attn_fwd"] == cfg.n_layers * len(prompts),
        "fwd_launches_all_wgmma": all_on(routes, "wgmma", launches["attn_fwd"]),
        "decode_launches_16_per_step": launches["paged_decode"] == cfg.n_layers * steps > 0,
    }

    prefill_rec = check_prefill(model, cfg, dev, prompts[0])
    checks.update(prefill_rec.pop("checks"))

    per_len = {}
    admitted = [len(p) for p in prompts]  # FIFO admission: prompt order
    for n, ms in zip(admitted, prefill_ms):
        per_len[str(n)] = ms
    rec = {
        "phase": "serve", "config": SERVE_CFG, "dtype": "bfloat16",
        "params": n_params, "weights_setup_s": setup_s,
        "requests": len(prompts), "prompt_lengths": list(SERVE_PROMPTS),
        "new_tokens": SERVE_NEW_TOKENS, "num_slots": 4, "page_size": 128,
        "pages_per_seq": 17, "decode_steps": steps, "launches": launches,
        "fwd_routes": routes, "prefill_ms_by_prompt_len": per_len,
        "decode_ms_per_step_median": float(np.median(decode_ms)),
        "decode_ms_per_step_mean": float(np.mean(decode_ms)),
        "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
        **prefill_rec, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving checks failed: {failed}")
    phase_decode_profile(engine, cfg)
    return rec, model, cfg


def profile_window(fn, steps, retry=True):
    """Run ``fn`` ``steps`` times in one torch.profiler window synchronized
    at both edges.  Returns the wall ms per step, the device's busy ms per
    step (the union of its operations' intervals: operations that overlap
    count once), its operation count per step, and the device ms per step
    of every kernel name, largest first.  A window whose trace came back
    without device time is taken once more; raises
    if the second saw none either, or more than the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    if retry and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        return profile_window(fn, steps, retry=False)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3 / steps
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    if busy_ms > wall_ms:
        raise AssertionError(
            f"device busy {busy_ms} ms exceeds the window's wall {wall_ms} ms "
            "per step: the device time is miscounted")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return (wall_ms, busy_ms, sum(n for _, n in by_name.values()) / steps,
            {name: us / 1e3 / steps for name, (us, _) in ranked})


def top_kernels(by_name, n=6):
    return {name[:60]: ms for name, ms in list(by_name.items())[:n]}


def phase_decode_profile(engine, cfg, model_name="serving-bench"):
    """Where a steady decode step's time goes.  One torch.profiler window,
    synchronized at both edges, gives the wall time per step and the device's
    busy time and operation count per step (by kernel name) over the same
    steps; the idle share is 1 - busy / wall of that window.  The wall time
    per step without the profiler, over as many steps just before, shows
    what the profiler itself adds."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime.scheduler import Request

    rng = np.random.default_rng(1)
    for i, n in enumerate(SERVE_PROMPTS[:engine.num_slots]):
        engine.scheduler.submit(Request(
            request_id=f"profile{i}", max_new_tokens=24,
            prompt_tokens=rng.integers(0, cfg.vocab_size, n).tolist()))
    engine.scheduler.schedule()
    for _ in range(3):
        engine.step()
    steps = 6
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t) * 1e3 / steps
    wall_ms, busy_ms, n_ops, by_name = profile_window(engine.step, steps)
    rec = {
        "phase": "decode_profile", "model": model_name, "active_slots": engine.num_slots,
        "steps": steps, "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_unprofiled": unprofiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": n_ops,
        "top_device_ms_per_step": top_kernels(by_name),
        # the paged decode calls (the merge of the splits included)
        "paged_decode_device_ms_per_step": sum(
            ms for name, ms in by_name.items() if "paged_decode_kernel" in name),
    }
    emit(rec)
    while engine.scheduler.has_work:
        engine.scheduler.schedule()
        engine.step()
    return rec


# Quantized serving: (kv kind, slots, new tokens).  int8 at the serving
# bench's two batches (scripts/bench_serving.py:35-39: --kv bf16 int8 at
# batches 8 and 32, 2048-token context, 64 new tokens), the other kinds at 8.
SERVE_QUANT_RUNS = (("int8", 8, 64), ("int8", 32, 16), ("int4", 8, 16),
                    ("e4m3", 8, 16), ("e5m2", 8, 16), ("bf16", 8, 16))
SERVE_QUANT_PROMPT = 2048
SERVE_PAGE, SERVE_PPS = 128, 17


def _timed(fn, sink):
    """``fn`` with its device-synchronized wall ms appended to ``sink``."""
    import torch

    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        return out
    return run


class _Recorder:
    """Swaps a module-level attention function of models/decoding.py for
    one that records each call's arguments (kept for the latest engine step
    only) and passes it on."""

    def __init__(self, name):
        from flash_attention_dlrs_tpu_torch.models import decoding

        self.module, self.name = decoding, name
        self.kernel = getattr(decoding, name)
        self.calls = []

    def __enter__(self):
        def recording(*args, **kw):
            self.calls.append((args, kw))
            return self.kernel(*args, **kw)
        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kernel)

    def step(self, fn):
        """``fn`` (an engine step) with the record cleared before each call."""
        def run(*args):
            self.calls.clear()
            return fn(*args)
        return run


def check_layers(calls, verify):
    """Every recorded layer call again through the kernel and the plain
    version, on the engine's own q and pools: the worst errors and whether
    each layer met the kernel's tolerance."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.decode import (
        paged_decode_attention, paged_decode_plain, paged_verify_attention,
        paged_verify_plain,
    )

    worst, ok = {"max_abs_err_o": 0.0, "max_abs_err_lse": 0.0,
                 "worst_err_over_limit": 0.0}, True
    for (q, k, v, lens, tbl), kw in calls:
        kw = dict(sm_scale=kw["sm_scale"] or q.shape[-1] ** -0.5,
                  alibi_slopes=kw.get("alibi_slopes"),
                  logit_softcap=kw.get("logit_softcap", 0.0))
        if verify:
            got = (paged_verify_attention(q, k, v, lens, tbl, **kw), None)
            want = (paged_verify_plain(q, k, v, lens, tbl, **kw), None)
            spread = paged_verify_plain(q, *abs_v_pools(k, v), lens, tbl, **kw)
        else:
            got = paged_decode_attention(q, k, v, lens, tbl, return_lse=True, **kw)
            want = paged_decode_plain(q, k, v, lens, tbl, return_lse=True, **kw)
            spread = (None if torch.is_tensor(v) else paged_decode_plain(
                q, *abs_v_pools(k, v), lens, tbl, **kw))
        rec = paged_errors(got, want, q.dtype, spread)
        ok &= rec["ok"]
        for key in worst:
            worst[key] = max(worst[key], rec[key])
    return {"layers_checked": len(calls), **worst, "ok": ok}


def _serve_run(engine, prompts, new_tokens, record):
    """One ``engine.generate(prompts)``: the launch counts of the forward
    (in all and per route) and paged kernels (verify also per route) zeroed
    just before and read just after, the
    device-synchronized ms of every admission and decode step, the number
    of prefill chunks, and the calls of ``record`` (a paged attention
    function of models/decoding.py) of the last decode step, or of the last
    chunk when ``record`` is the verify function."""
    import torch

    admit_ms, decode_ms, chunks = [], [], []
    admit = "_admit_chunked" if engine.prefill_chunk else "_admit_dense"
    setattr(engine, admit, _timed(getattr(engine, admit), admit_ms))
    with _Recorder(record) as rec:
        decode_step = _timed(engine._decode_step, decode_ms)
        if record == "paged_verify_attention":
            chunk_step = rec.step(engine._chunk_prefill)
            engine._chunk_prefill = lambda *a: chunks.append(1) or chunk_step(*a)
        else:
            decode_step = rec.step(decode_step)
        engine._decode_step = decode_step
        steps_before = engine.scheduler.stats.steps
        _zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _launches()
        routes, verify_routes = launches.pop("fwd_routes"), launches.pop("verify_routes")
    return {"outs": outs, "launches": launches, "fwd_routes": routes,
            "verify_routes": verify_routes,
            "wall": wall, "admit_ms": admit_ms,
            "decode_ms": decode_ms, "chunks": len(chunks), "calls": rec.calls,
            "steps": engine.scheduler.stats.steps - steps_before}


def check_decode_fp32(dev, prompt, kinds, **variant):
    """The serving model (with the config fields ``variant``) at 2 layers
    in fp32: one prompt's first decode step from each KV kind, through the
    kernel and through the plain version (swapped into models/decoding.py),
    on pools filled alike by the dense prefill.  The fp32 kernels compute in
    true fp32, so the logits must agree to summation order: diff / std <=
    FP32_LOGIT_LIMIT."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, decoding, init_params_numpy, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.ops.decode import paged_decode_plain

    cfg = ModelConfig(**{**SERVE_CFG, "n_layers": 2, **variant}, dtype=torch.float32)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    t = len(prompt)
    toks = torch.zeros((1, 1 << (t - 1).bit_length()), dtype=torch.long, device=dev)
    toks[0, :t] = torch.tensor(prompt, device=dev)
    logits0, kvs = decoding.make_prefill(cfg)(
        model, toks, torch.tensor([t], dtype=torch.int32, device=dev))
    step = decoding.make_decode_step(cfg)
    n_prompt = -(-t // SERVE_PAGE)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (logits0.argmax(-1), torch.tensor([t], **i32),
            torch.tensor([t // SERVE_PAGE], **i32), torch.tensor([t % SERVE_PAGE], **i32),
            torch.arange(SERVE_PPS, **i32)[None], torch.tensor([t + 1], **i32))

    def first_decode(kind):
        pools = decoding.init_kv_pools(
            cfg, num_pages=SERVE_PPS, page_size=SERVE_PAGE, dtype=kv_kind(kind),
            quantized=kind in QUANT_KINDS, device=dev)
        decoding.write_prompt_kv_all(pools, kvs, torch.arange(n_prompt, device=dev),
                                     SERVE_PAGE)
        return step(model, pools, *args)[0]

    def plain(q, k, v, lens, tbl, *, sm_scale, alibi_slopes=None, logit_softcap=0.0,
              pages_per_block=None):
        assert pages_per_block is None  # the default engine's steps: no split asked
        return paged_decode_plain(q, k, v, lens, tbl, sm_scale=sm_scale,
                                  alibi_slopes=alibi_slopes, logit_softcap=logit_softcap)

    gaps = {}
    for kind in kinds:
        kernel = first_decode(kind)
        kernel_fn, decoding.paged_decode_attention = decoding.paged_decode_attention, plain
        try:
            want = first_decode(kind)
        finally:
            decoding.paged_decode_attention = kernel_fn
        gaps[kind] = float((kernel - want).abs().max() / want.std())
    del model, kvs
    torch.cuda.empty_cache()
    return gaps


def phase_serve_quant(dev, model, cfg):
    """DecodeEngine from each KV kind of SERVE_QUANT_RUNS: as many random
    2048-token prompts (numpy seed 0) as slots, all admitted at once, then
    decode to the budget.  Launch counts zeroed just before each run and
    read just after; the last decode step's every layer checked kernel
    against plain on the engine's own pools; a 2-layer fp32 copy's first
    decode step through kernels and plain versions."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    runs, checks = {}, {}
    for kind, slots, new_tokens in SERVE_QUANT_RUNS:
        engine = DecodeEngine(
            model, cfg, num_pages=slots * SERVE_PPS + 1, page_size=SERVE_PAGE,
            num_slots=slots, pages_per_seq=SERVE_PPS, kv_dtype=kv_kind(kind),
            quantized_kv=kind in QUANT_KINDS, device=dev)
        engine.generate([[1] * SERVE_QUANT_PROMPT], max_new_tokens=2)  # warm-up
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, SERVE_QUANT_PROMPT).tolist()
                   for _ in range(slots)]
        r = _serve_run(engine, prompts, new_tokens, "paged_decode_attention")
        steps, launches, outs, wall = r["steps"], r["launches"], r["outs"], r["wall"]
        decode_ms = r["decode_ms"]
        layers = check_layers(r["calls"], verify=False)
        n_tok = sum(len(o) for o in outs)
        name = f"{kind}_B{slots}"
        runs[name] = {
            "kv": kind, "slots": slots, "new_tokens": new_tokens,
            "decode_steps": steps, "launches": launches, "fwd_routes": r["fwd_routes"],
            "admit_ms_median": float(np.median(r["admit_ms"])),
            "decode_ms_per_step_median": float(np.median(decode_ms)),
            "decode_ms_per_step_mean": float(np.mean(decode_ms)),
            "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "decode_tokens_per_s": slots / (np.median(decode_ms) / 1e3),
            "last_step_layers": layers,
        }
        checks.update({
            f"{name}_every_request_{new_tokens}_tokens":
                all(len(o) == new_tokens for o in outs),
            f"{name}_tokens_in_vocab":
                all(0 <= x < cfg.vocab_size for o in outs for x in o),
            f"{name}_fwd_launches_16_per_prefill":
                launches["attn_fwd"] == cfg.n_layers * slots,
            f"{name}_fwd_launches_all_wgmma":
                all_on(r["fwd_routes"], "wgmma", launches["attn_fwd"]),
            f"{name}_decode_launches_{cfg.n_layers}_per_step":
                launches["paged_decode"] == cfg.n_layers * steps > 0,
            f"{name}_every_layer_kernel_vs_plain":
                layers["ok"] and layers["layers_checked"] == cfg.n_layers,
        })
        emit({"phase": "serve_quant", "run": name, **runs[name]})
        del engine
        torch.cuda.empty_cache()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, SERVE_QUANT_PROMPT)
    fp32 = check_decode_fp32(dev, prompt.tolist(), QUANT_KINDS + ("fp32",))
    for kind, gap in fp32.items():
        checks[f"fp32_2layer_first_decode_{kind}_kernel_vs_plain"] = gap <= FP32_LOGIT_LIMIT
    rec = {"phase": "serve_quant", "config": SERVE_CFG, "dtype": "bfloat16",
           "page_size": SERVE_PAGE, "pages_per_seq": SERVE_PPS,
           "prompt_tokens": SERVE_QUANT_PROMPT,
           "decode_ms_per_step": {n: r["decode_ms_per_step_median"] for n, r in runs.items()},
           "tokens_per_s": {n: r["tokens_per_s"] for n, r in runs.items()},
           "fp32_2layer_first_decode_diff_over_std": fp32, "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"quantized serving checks failed: {failed}")
    return runs


# Chunked serving: 8 requests, each a shared 1024-token system prompt and
# 1024 unique tokens, prefilled 256 tokens at a time with the prefix cache.
CHUNK, SYSTEM_TOKENS, UNIQUE_TOKENS = 256, 1024, 1024
CHUNKED_REQUESTS, CHUNKED_NEW_TOKENS = 8, 8


def check_chunked_fp32(dev, prompts, **variant):
    """The serving model (with the config fields ``variant``) at 2 layers
    in fp32, fp32 KV: the last-token logits of chunked admission (a miss,
    then a prefix-cache hit) against the dense prefill of the same prompt,
    both through the kernels."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, init_params_numpy, make_prefill, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    cfg = ModelConfig(**{**SERVE_CFG, "n_layers": 2, **variant}, dtype=torch.float32)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    engine = DecodeEngine(model, cfg, num_pages=3 * SERVE_PPS, page_size=SERVE_PAGE,
                          num_slots=1, pages_per_seq=SERVE_PPS, kv_dtype=torch.float32,
                          prefill_chunk=CHUNK, enable_prefix_cache=True, device=dev)
    last = []
    chunk_step = engine._chunk_prefill

    def capture(*args):
        out = chunk_step(*args)
        last.append(out[0][:, -1])
        return out

    engine._chunk_prefill = capture
    gaps = []
    for prompt in prompts[:2]:
        last.clear()
        engine.generate([prompt], max_new_tokens=1)
        t = len(prompt)
        toks = torch.tensor([prompt], device=dev)
        dense, _ = make_prefill(cfg)(model, toks, torch.tensor([t], dtype=torch.int32,
                                                                 device=dev))
        gaps.append(float((last[-1] - dense).abs().max() / dense.std()))
    hits = engine.prefix_cache.hits
    del engine, model
    torch.cuda.empty_cache()
    return {"miss": gaps[0], "hit": gaps[1], "hits": hits}


def phase_serve_chunked(dev, model, cfg, phase="serve_chunked", route="wgmma",
                        verify_route=None, **variant):
    """Chunked admission with the prefix cache from bf16 and int8 KV: the
    first request prefills 2048 tokens in 8 chunks and registers its pages;
    the next seven hit the cache for the 8 pages of the system prompt and
    prefill 4 chunks each.  Launch counts zeroed just before each run and
    read just after (every forward on ``route``, every verify on
    ``verify_route``, by default ``route``); the last
    chunk's every layer checked kernel against plain; admission ms dense /
    chunked / chunked with a hit; a 2-layer fp32 copy (with the config
    fields ``variant``) chunked logits against its dense prefill."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    verify_route = verify_route or route
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_TOKENS).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, UNIQUE_TOKENS).tolist()
               for _ in range(CHUNKED_REQUESTS)]
    total = SYSTEM_TOKENS + UNIQUE_TOKENS
    want_chunks = total // CHUNK + (CHUNKED_REQUESTS - 1) * (UNIQUE_TOKENS // CHUNK)
    shared_pages = SYSTEM_TOKENS // SERVE_PAGE
    kw = dict(num_pages=CHUNKED_REQUESTS * SERVE_PPS + 1, page_size=SERVE_PAGE,
              num_slots=CHUNKED_REQUESTS, pages_per_seq=SERVE_PPS, device=dev)

    # dense admission of the same prompts, for the prefill comparison
    dense = DecodeEngine(model, cfg, kv_dtype=torch.bfloat16, **kw)
    dense.generate([[1] * total], max_new_tokens=1)  # warm-up
    dense_ms = []
    dense._admit_dense = _timed(dense._admit_dense, dense_ms)
    _zero_launches()
    dense.generate(prompts, max_new_tokens=1)
    dense_fwd = _launches()["attn_fwd"]
    dense_routes = fwd_routes()
    del dense
    torch.cuda.empty_cache()

    runs, checks = {}, {"dense_fwd_launches_16_per_prefill":
                        dense_fwd == cfg.n_layers * CHUNKED_REQUESTS,
                        f"dense_fwd_launches_all_{route}": all_on(dense_routes, route,
                                                                  dense_fwd)}
    for kind in ("bf16", "int8"):
        engine = DecodeEngine(model, cfg, kv_dtype=kv_kind(kind),
                              quantized_kv=kind in QUANT_KINDS, prefill_chunk=CHUNK,
                              enable_prefix_cache=True, **kw)
        engine.generate([[2] * 1000], max_new_tokens=2)  # warm-up, shares nothing
        matched = []
        match = engine.prefix_cache.match
        engine.prefix_cache.match = lambda toks: matched.append(match(toks)) or matched[-1]
        hits_before = engine.prefix_cache.hits
        r = _serve_run(engine, prompts, CHUNKED_NEW_TOKENS, "paged_verify_attention")
        steps, launches, outs, wall = r["steps"], r["launches"], r["outs"], r["wall"]
        admit_ms, decode_ms, chunks = r["admit_ms"], r["decode_ms"], r["chunks"]
        hits = engine.prefix_cache.hits - hits_before
        layers = check_layers(r["calls"], verify=True)
        n_tok = sum(len(o) for o in outs)
        runs[kind] = {
            "kv": kind, "requests": CHUNKED_REQUESTS, "chunks": chunks,
            "prefix_hits": hits, "pages_reused": [len(p) for p, _ in matched],
            "decode_steps": steps, "launches": launches,
            "verify_routes": r["verify_routes"],
            "admit_ms_chunked_miss": admit_ms[0],
            "admit_ms_chunked_hit_median": float(np.median(admit_ms[1:])),
            "admit_ms_dense_median": float(np.median(dense_ms)),
            "decode_ms_per_step_median": float(np.median(decode_ms)),
            "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "last_chunk_layers": layers,
        }
        checks.update({
            f"{kind}_every_request_{CHUNKED_NEW_TOKENS}_tokens":
                all(len(o) == CHUNKED_NEW_TOKENS for o in outs),
            f"{kind}_7_prefix_hits_of_8_pages":
                hits == CHUNKED_REQUESTS - 1
                and [len(p) for p, _ in matched] == [0] + [shared_pages] * hits,
            f"{kind}_{want_chunks}_chunks": chunks == want_chunks,
            f"{kind}_verify_launches_16_per_chunk":
                launches["paged_verify"] == cfg.n_layers * want_chunks,
            f"{kind}_verify_launches_all_{verify_route}":
                all_on(r["verify_routes"], verify_route, launches["paged_verify"]),
            f"{kind}_decode_launches_16_per_step":
                launches["paged_decode"] == cfg.n_layers * steps > 0,
            f"{kind}_no_dense_prefill": (launches["attn_fwd"] == 0
                                         and all_on(r["fwd_routes"], route, 0)),
            f"{kind}_every_layer_verify_kernel_vs_plain":
                layers["ok"] and layers["layers_checked"] == cfg.n_layers,
        })
        emit({"phase": phase, "run": kind, **runs[kind]})
        del engine
        torch.cuda.empty_cache()
    fp32 = check_chunked_fp32(dev, prompts, **variant)
    checks["fp32_2layer_chunked_vs_dense_miss"] = fp32["miss"] <= FP32_LOGIT_LIMIT
    checks["fp32_2layer_chunked_vs_dense_hit"] = (fp32["hit"] <= FP32_LOGIT_LIMIT
                                                  and fp32["hits"] == 1)
    emit({"phase": phase, "chunk": CHUNK, "system_tokens": SYSTEM_TOKENS,
          "unique_tokens": UNIQUE_TOKENS, "dense_fwd_launches": dense_fwd,
          "dense_fwd_routes": dense_routes,
          "fp32_2layer_chunked_vs_dense_diff_over_std": fp32, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return runs, dense_fwd


# ALiBi serving: the serving model with position_encoding="alibi" (the same
# random weights: an ALiBi model has the same parameters), three ways:
# name, kv kind, slots, new tokens, prefill chunk (with the prefix cache).
SERVE_ALIBI_RUNS = (("bf16", "bf16", 4, SERVE_NEW_TOKENS, 0),
                    ("int8", "int8", 8, 16, 0),
                    ("bf16_chunked", "bf16", CHUNKED_REQUESTS, CHUNKED_NEW_TOKENS, CHUNK))


def phase_serve_alibi(dev, model, cfg=None, phase="serve_alibi", variant=None):
    """The serving path of an ALiBi model (the serving config with
    position_encoding="alibi", slopes alibi_slopes_for(16); or ``cfg``,
    the serving config with the fields ``variant``) through
    DecodeEngine, SERVE_ALIBI_RUNS: 8 requests of 200-2048 prompt tokens
    (numpy seed 0) from bf16 KV at 4 slots and int8 KV at 8, and 8 requests
    sharing a 1024-token system prompt (numpy seed 2) from bf16 KV with
    prefill_chunk=256 and the prefix cache, which runs the verify kernel
    with ALiBi.  Exact launch counts per run; the last decode step's (or
    chunk's) every layer checked kernel against plain; one prompt's
    prefill through kernels and plain versions, bf16 and a 2-layer fp32
    copy; the fp32 copy's first decode step from fp32 and int8 KV and its
    chunked admission against its dense prefill."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import ModelConfig
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    variant = {"position_encoding": "alibi", **(variant or {})}
    if cfg is None:
        cfg = ModelConfig(**SERVE_CFG, dtype=torch.bfloat16, position_encoding="alibi")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_TOKENS).tolist()
    shared = [system + rng.integers(0, cfg.vocab_size, UNIQUE_TOKENS).tolist()
              for _ in range(CHUNKED_REQUESTS)]
    want_chunks = ((SYSTEM_TOKENS + UNIQUE_TOKENS) // CHUNK
                   + (CHUNKED_REQUESTS - 1) * (UNIQUE_TOKENS // CHUNK))
    runs, checks = {}, {}
    for name, kind, slots, new_tokens, chunk in SERVE_ALIBI_RUNS:
        engine = DecodeEngine(
            model, cfg, num_pages=slots * SERVE_PPS + 1, page_size=SERVE_PAGE,
            num_slots=slots, pages_per_seq=SERVE_PPS, kv_dtype=kv_kind(kind),
            quantized_kv=kind in QUANT_KINDS, prefill_chunk=chunk,
            enable_prefix_cache=bool(chunk), device=dev)
        engine.generate([[2] * 1000], max_new_tokens=2)  # warm-up, shares nothing
        hits_before = engine.prefix_cache.hits if chunk else 0
        r = _serve_run(engine, shared if chunk else prompts, new_tokens,
                       "paged_verify_attention" if chunk else "paged_decode_attention")
        layers = check_layers(r["calls"], verify=bool(chunk))
        n_req, launches, outs = len(r["outs"]), r["launches"], r["outs"]
        n_tok = sum(len(o) for o in outs)
        runs[name] = {
            "kv": kind, "slots": slots, "requests": n_req, "new_tokens": new_tokens,
            "prefill_chunk": chunk, "decode_steps": r["steps"], "launches": launches,
            "fwd_routes": r["fwd_routes"], "verify_routes": r["verify_routes"],
            "admit_ms_median": float(np.median(r["admit_ms"])),
            "decode_ms_per_step_median": float(np.median(r["decode_ms"])),
            "decode_ms_per_step_mean": float(np.mean(r["decode_ms"])),
            "wall_s": r["wall"], "tokens": n_tok, "tokens_per_s": n_tok / r["wall"],
            "last_step_layers": layers,
        }
        checks.update({
            f"{name}_every_request_{new_tokens}_tokens":
                all(len(o) == new_tokens for o in outs),
            f"{name}_tokens_in_vocab": all(0 <= x < cfg.vocab_size for o in outs for x in o),
            f"{name}_decode_launches_{cfg.n_layers}_per_step":
                launches["paged_decode"] == cfg.n_layers * r["steps"] > 0,
            f"{name}_every_layer_kernel_vs_plain":
                layers["ok"] and layers["layers_checked"] == cfg.n_layers,
        })
        if chunk:
            hits = engine.prefix_cache.hits - hits_before
            runs[name].update(chunks=r["chunks"], prefix_hits=hits,
                              admit_ms_chunked_miss=r["admit_ms"][0],
                              admit_ms_chunked_hit_median=float(np.median(r["admit_ms"][1:])))
            checks.update({
                f"{name}_{want_chunks}_chunks": r["chunks"] == want_chunks,
                f"{name}_7_prefix_hits": hits == CHUNKED_REQUESTS - 1,
                f"{name}_verify_launches_{cfg.n_layers}_per_chunk":
                    launches["paged_verify"] == cfg.n_layers * want_chunks,
                f"{name}_verify_launches_all_wgmma":
                    all_on(r["verify_routes"], "wgmma", launches["paged_verify"]),
                f"{name}_no_dense_prefill": (launches["attn_fwd"] == 0
                                             and all_on(r["fwd_routes"], "wgmma", 0)),
            })
        else:
            checks[f"{name}_fwd_launches_{cfg.n_layers}_per_prefill"] = (
                launches["attn_fwd"] == cfg.n_layers * n_req and launches["paged_verify"] == 0)
            checks[f"{name}_fwd_launches_all_wgmma"] = all_on(
                r["fwd_routes"], "wgmma", launches["attn_fwd"])
        emit({"phase": phase, "run": name, **runs[name]})
        del engine
        torch.cuda.empty_cache()
    prefill_rec = check_prefill(model, cfg, dev, prompts[0])
    checks.update(prefill_rec.pop("checks"))
    fp32 = check_decode_fp32(dev, prompts[1], ("fp32", "int8"), **variant)
    for kind, gap in fp32.items():
        checks[f"fp32_2layer_first_decode_{kind}_kernel_vs_plain"] = gap <= FP32_LOGIT_LIMIT
    chunked = check_chunked_fp32(dev, shared, **variant)
    checks["fp32_2layer_chunked_vs_dense_miss"] = chunked["miss"] <= FP32_LOGIT_LIMIT
    checks["fp32_2layer_chunked_vs_dense_hit"] = (chunked["hit"] <= FP32_LOGIT_LIMIT
                                                  and chunked["hits"] == 1)
    rec = {"phase": phase, "card": card_line(),
           "config": {**SERVE_CFG, **variant, "n_layers": cfg.n_layers},
           "dtype": "bfloat16", "page_size": SERVE_PAGE, "pages_per_seq": SERVE_PPS,
           "decode_ms_per_step": {n: r["decode_ms_per_step_median"] for n, r in runs.items()},
           "admit_ms": {n: r["admit_ms_median"] for n, r in runs.items()},
           "tokens_per_s": {n: r["tokens_per_s"] for n, r in runs.items()},
           **prefill_rec, "fp32_2layer_first_decode_diff_over_std": fp32,
           "fp32_2layer_chunked_vs_dense_diff_over_std": chunked, "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return runs


# An ALiBi model at Gemma-2-2B's attention widths (serve_alibi_d256): no
# public ALiBi model has head dim 256 (BLOOM's and MPT's heads are 128 and
# below), so this configuration exists only to put ALiBi in the paged
# kernels at head dim 256 on an engine path.  google/gemma-2-2b's d_model,
# heads, d_ff, vocab, softcaps and its 4096 window on even layers, RoPE
# replaced by ALiBi; cut to ALIBI_D256_LAYERS of its 26 layers.
ALIBI_D256 = dict(vocab_size=256000, d_model=2304, n_q_heads=8, n_kv_heads=4, head_dim=256,
                  d_ff=9216, window=4096, window_pattern="even", attn_softcap=50.0,
                  final_softcap=30.0, position_encoding="alibi")
ALIBI_D256_LAYERS = 4


def phase_serve_alibi_d256(dev):
    """The serving path (:func:`phase_serve_alibi`'s runs and checks) of
    ALIBI_D256 at ALIBI_D256_LAYERS layers, random weights from seed 0: page
    128 x 17 (2176 tokens, under the 4096 window, so the whole context stays
    resident and no ring is needed), bf16 KV at 4 slots, int8 KV at 8 slots,
    and bf16 KV with prefill_chunk=256 and the prefix cache (verify with
    ALiBi at head dim 256); its 2-layer fp32 copies are the same widths."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, init_params_numpy, params_from_jax,
    )

    cfg = ModelConfig(**{**SERVE_CFG, **ALIBI_D256, "n_layers": ALIBI_D256_LAYERS},
                      dtype=torch.bfloat16)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    runs = phase_serve_alibi(dev, model, cfg, "serve_alibi_d256", ALIBI_D256)
    del model
    torch.cuda.empty_cache()
    return runs


# Bursts and speculative serving (phases serve_burst and serve_spec): the
# serving model, page 128, 17 pages a sequence (2048 + 32 + γ tokens fit),
# the serve phase's 8 requests at 4 slots (8 for the lockstep forms),
# bursts of 8, γ = 4; a 2-layer independent draft at the serving widths.
BURST, GAMMA, DRAFT_LAYERS = 8, 4, 2
SEEDED = dict(temperature=0.8, top_k=50, seed=20251017)


def serve_engine(model, cfg, dev, slots=4, kv="bf16"):
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    return DecodeEngine(model, cfg, num_pages=slots * SERVE_PPS + 1, page_size=SERVE_PAGE,
                        num_slots=slots, pages_per_seq=SERVE_PPS, kv_dtype=kv_kind(kv),
                        quantized_kv=kv in QUANT_KINDS, device=dev)


def serve_prompts(cfg):
    rng = np.random.default_rng(0)  # phase serve's prompts
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]


def step_graphs(engine):
    """Every StepGraph of the engine's burst and speculative programs."""
    graphs = []
    for value in engine._programs.values():
        fn = value[1] if isinstance(value, tuple) else value
        graphs += [run for _, run in getattr(fn, "programs", {}).values()]
    return graphs


def pages_back(*engines):
    return all(len(e.allocator.free_pages) == e.pools.k[0].shape[1] - 1 for e in engines)


def _serve_kernels():
    """The serving path's kernels by name, each over its builds (one for
    each head dim, and the wide ones; the forward's without segment ids,
    its score pass above 1024 under "attn_fwd", its product pass apart)."""
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    # above 1024 a bf16 forward is the score pass and the product pass
    return {"attn_fwd": (fk.FWD_D64_KERNEL, fk.FWD_KERNEL, fk.FWD_D256_KERNEL,
                         fk.FWD_WIDE_KERNEL, ws.FWD_SCORES_KERNEL),
            "attn_fwd_product": (ws.FWD_PRODUCT_KERNEL,),
            "paged_decode": (dm.DECODE_D64_KERNEL, dm.DECODE_KERNEL, dm.DECODE_D256_KERNEL,
                             dm.DECODE_WIDE_KERNEL, dm.DECODE_CHUNK_KERNEL),
            "paged_verify": (dm.VERIFY_D64_KERNEL, dm.VERIFY_KERNEL, dm.VERIFY_D256_KERNEL,
                             dm.VERIFY_D256_F16_KERNEL, dm.VERIFY_WIDE_KERNEL)}


def _zero_launches():
    from flash_attention_dlrs_tpu_torch.ops.decode import VERIFY_ROUTE_LAUNCHES

    for builds in _serve_kernels().values():
        for kern in builds:
            kern.launches = 0
    fwd_routes(zero=True)
    for r in VERIFY_ROUTE_LAUNCHES:
        VERIFY_ROUTE_LAUNCHES[r] = 0


def _launches():
    """The serving kernels' launches (_serve_kernels), decode's on its
    column-chunked build apart, and the forward's and verify's by route."""
    from flash_attention_dlrs_tpu_torch.ops import decode as dm

    return {**{name: sum(k.launches for k in builds) for name, builds in _serve_kernels().items()},
            "paged_decode_chunk": dm.DECODE_CHUNK_KERNEL.launches,
            "fwd_routes": fwd_routes(), "verify_routes": dict(dm.VERIFY_ROUTE_LAUNCHES)}


def graphed_run(engine, prompts, burst, call="generate", new_tokens=SERVE_NEW_TOKENS, **kw):
    """One ``engine.<call>(prompts, new_tokens, ...)`` (``burst`` for
    generate): the launch counts zeroed just before and read just after,
    the synchronized ms of every decode call (``step``, ``step_burst``, or
    the lockstep program), the decode steps (graph runs of the burst or
    round bodies, or eager ``step`` calls), the spec_stats it added, and
    each captured graph's capture seconds."""
    import torch

    lockstep = call != "generate"
    name = "step_burst" if burst > 1 else "step"
    decode_ms = []
    if not lockstep:
        setattr(engine, name, _timed(getattr(engine, name), decode_ms))
    runs_before = sum(g.runs for g in step_graphs(engine))
    stats_before = dict(engine.spec_stats)
    _zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if lockstep:
        outs = getattr(engine, call)(prompts, max_new_tokens=new_tokens, **kw)
    else:
        outs = engine.generate(prompts, max_new_tokens=new_tokens, burst=burst, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _launches()
    if not lockstep:
        delattr(engine, name)
    graph_steps = sum(g.runs for g in step_graphs(engine)) - runs_before
    steps = len(decode_ms) if burst == 1 and not lockstep else graph_steps
    n_tok = sum(len(o) for o in outs)
    decode_tokens = n_tok - len(prompts)  # first tokens come from the prefills
    rec = {"outs": outs, "launches": launches, "wall_s": wall, "steps": steps,
           "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "spec_stats": {k: engine.spec_stats[k] - stats_before.get(k, 0)
                          for k in engine.spec_stats},
           "capture_s": [g.capture_seconds for g in step_graphs(engine)]}
    if lockstep:
        rec["program_s"] = engine.last_fused_seconds
    else:
        rec["decode_ms_per_token"] = sum(decode_ms) / max(decode_tokens, 1)
        rec["decode_ms_per_step"] = sum(decode_ms) / max(steps, 1)
    return rec


def check_graph_logits(engine, cfg, prompts):
    """One decode step of 4 admitted requests, eager and as a replayed CUDA
    graph (StepGraph over the same static inputs; the step re-writes the
    same K/V): bitwise equal, or within the serving phases' bf16 logit
    limit when cuBLAS picks another algorithm under capture."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime.scheduler import Request
    from flash_attention_dlrs_tpu_torch.runtime.step_graph import StepGraph

    for i, p in enumerate(prompts[:engine.num_slots]):
        engine.scheduler.submit(Request(request_id=f"logits{i}", prompt_tokens=p,
                                        max_new_tokens=SERVE_NEW_TOKENS))
    engine.scheduler.schedule()
    b, pps = engine.num_slots, engine.pages_per_seq
    arrays = [np.zeros(b, np.int64) for _ in range(4)] + [
        np.zeros((b, pps), np.int32), np.zeros(b, np.int32)]
    tokens, positions, rows, offs, tbl, lens = arrays
    for slot, req in enumerate(engine.slot_request):
        table = engine.allocator.page_tables[req.request_id]
        pos = engine.allocator.seq_lengths[req.request_id]
        tokens[slot], positions[slot] = engine._slot_next_token[slot], pos
        rows[slot], offs[slot] = table[pos // SERVE_PAGE], pos % SERVE_PAGE
        tbl[slot, : len(table)], lens[slot] = table, pos + 1
    inputs = [torch.from_numpy(a).to(engine.device) for a in arrays]
    eager = engine._decode_step(engine.params, engine.pools, *inputs)[0].clone()
    out = torch.empty_like(eager)

    def body():
        out.copy_(engine._decode_step(engine.params, engine.pools, *inputs)[0])

    graph = StepGraph(body, engine.device, engine._graphs())
    graph()  # warm-up (eager, on the side stream) and capture
    graph()  # a replay
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, eager))
    diff, std = float((out - eager).abs().max()), float(eager.std())
    while engine.scheduler.has_work:  # finish the requests
        engine.scheduler.schedule()
        engine.step_burst(BURST)
    engine.scheduler.schedule()
    return {"logits_bitwise_equal": bitwise, "logit_diff_over_std": diff / std,
            "logit_limit_over_std": BF16_LOGIT_LIMIT["rope"],
            "held": "bitwise" if bitwise else (
                "bf16_limit" if diff <= BF16_LOGIT_LIMIT["rope"] * std else "neither"),
            "capture_s": graph.capture_seconds}


def profile_burst(engine, cfg, prompts):
    """Where a graphed burst's time goes: 4 requests admitted, one burst
    (its graph already captured), then 2 bursts of 8 replays in one
    torch.profiler window (profile_window): wall and device-busy ms per
    step, the idle share.  If the profiler sees no kernel inside the
    graphs, the device span of the same bursts by CUDA events stands in
    for busy (``busy_source`` says which)."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime.scheduler import Request

    for i, p in enumerate(prompts[:engine.num_slots]):
        engine.scheduler.submit(Request(request_id=f"profile{i}", prompt_tokens=p,
                                        max_new_tokens=SERVE_NEW_TOKENS))
    engine.scheduler.schedule()
    engine.step_burst(BURST)
    bursts = 2
    rec = {"steps_per_burst": BURST, "bursts": bursts}
    try:
        wall_ms, busy_ms, n_ops, by_name = profile_window(
            lambda: engine.step_burst(BURST), bursts)
        rec.update(busy_source="profiler", device_ops_per_step=n_ops / BURST,
                   top_device_ms_per_step={k: v / BURST for k, v in
                                           top_kernels(by_name).items()},
                   paged_decode_device_ms_per_step=sum(
                       ms for name, ms in by_name.items()
                       if "paged_decode_kernel" in name) / BURST)
    except AssertionError as err:  # the profiler saw nothing inside the graphs
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        for _ in range(bursts):
            engine.step_burst(BURST)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / bursts
        busy_ms = start.elapsed_time(end) / bursts
        rec.update(busy_source=f"cuda_events ({err})")
    rec.update(wall_ms_per_step=wall_ms / BURST, device_busy_ms_per_step=busy_ms / BURST,
               device_idle_share=1.0 - busy_ms / wall_ms)
    while engine.scheduler.has_work:
        engine.scheduler.schedule()
        engine.step_burst(BURST)
    engine.scheduler.schedule()
    return rec


def divergences(model, cfg, dev, prompts, want, got):
    """Where each greedy stream of ``got`` first leaves ``want`` (the same
    prompts): the request, the token index, and there the two tokens'
    logit gap over the logits' std, from one dense prefill of the common
    prefix.  Two paths of different bf16 arithmetic (verify against decode,
    a batched prefill against a lone one) pick differently only where the
    top two logits lie within their noise; a gap within
    BF16_LOGIT_LIMIT["rope"] x std is such a near-tie."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import make_prefill

    prefill, found = make_prefill(cfg), []
    for i, (prompt, w, g) in enumerate(zip(prompts, want, got)):
        j = next((k for k, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if j is None:
            if len(w) != len(g):
                found.append({"request": i, "index": min(len(w), len(g)),
                              "gap_over_std": float("inf")})
            continue
        toks = list(prompt) + list(w[:j])
        x = torch.zeros((1, 1 << max(7, (len(toks) - 1).bit_length())), dtype=torch.long,
                        device=dev)
        x[0, : len(toks)] = torch.tensor(toks, device=dev)
        logits = prefill(model, x, torch.tensor([len(toks)], dtype=torch.int32,
                                                device=dev))[0][0]
        found.append({"request": i, "index": j, "tokens": [w[j], g[j]],
                      "gap_over_std": float((logits[w[j]] - logits[g[j]]).abs()
                                            / logits.std())})
    return found


def near_ties_only(divs) -> bool:
    return all(d["gap_over_std"] <= BF16_LOGIT_LIMIT["rope"] for d in divs)


def phase_serve_burst(dev, model, cfg):
    """Decode bursts at full width: the serve phase's 8 requests at 4
    slots, 32 new tokens, eager (``step``) and graphed
    (``generate(burst=8)``: each burst step one replay of a CUDA graph), in
    the order eager, graph, graph, eager in one engine; the graphed tokens
    must equal the eager ones, the launches hold through replays
    (paged_decode 16 per step run, attn_fwd 16 per prefill), pages come
    back.  Beside it: one decode step's logits eager against graphed, the
    graphed burst's device-busy share, a seeded burst (temperature 0.8,
    top-k 50) against the same run through eager steps, and the lockstep
    generate_fused at 8 slots against generate."""
    import torch
    from flash_attention_dlrs_tpu_torch.runtime import SamplingParams

    prompts = serve_prompts(cfg)
    engine = serve_engine(model, cfg, dev)
    engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
    engine.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
    runs = {}
    for i, burst in enumerate((1, BURST, BURST, 1)):
        runs[f"{'graph' if burst > 1 else 'eager'}_{i + 1}"] = graphed_run(
            engine, prompts, burst)
    eager, graph = runs["eager_1"], runs["graph_2"]
    logits = check_graph_logits(engine, cfg, prompts)
    profile = profile_burst(engine, cfg, prompts)
    sp = SamplingParams(**SEEDED)
    seeded = {b: graphed_run(engine, prompts, b, sampling=sp) for b in (1, BURST)}
    wide = serve_engine(model, cfg, dev, slots=8)
    lock_plain = graphed_run(wide, prompts, 1)
    lock_fused = graphed_run(wide, prompts, 1, call="generate_fused")
    divs = {k: divergences(model, cfg, dev, prompts, eager["outs"], r["outs"])
            for k, r in runs.items() if k != "eager_1"}
    divs["lockstep_generate_fused"] = divergences(model, cfg, dev, prompts,
                                                  lock_plain["outs"], lock_fused["outs"])
    checks = {
        "graph_tokens_equal_eager_or_near_ties": all(
            near_ties_only(divs[k]) for k in runs if k != "eager_1"),
        "every_request_32_tokens": all(len(o) == SERVE_NEW_TOKENS for o in graph["outs"]),
        "graph_fwd_launches_16_per_prefill":
            graph["launches"]["attn_fwd"] == cfg.n_layers * len(prompts),
        "graph_fwd_launches_all_wgmma":
            all_on(graph["launches"]["fwd_routes"], "wgmma", graph["launches"]["attn_fwd"]),
        "graph_decode_launches_16_per_step_through_replays": all(
            runs[k]["launches"]["paged_decode"] == cfg.n_layers * runs[k]["steps"] > 0
            for k in runs),
        "every_burst_graph_captured_and_replayed": all(
            g.graph is not None and g.runs > 1 for g in step_graphs(engine)),
        "graph_logits_bitwise_or_within_bf16_limit": logits["held"] != "neither",
        "seeded_graph_tokens_equal_eager": seeded[BURST]["outs"] == seeded[1]["outs"],
        "seeded_tokens_in_vocab": all(0 <= x < cfg.vocab_size
                                      for o in seeded[BURST]["outs"] for x in o),
        "lockstep_generate_fused_equals_generate_or_near_ties":
            near_ties_only(divs["lockstep_generate_fused"]),
        "lockstep_decode_launches_16_per_step":
            lock_fused["launches"]["paged_decode"] == cfg.n_layers * lock_fused["steps"] > 0,
        "lockstep_one_batched_prefill": lock_fused["launches"]["attn_fwd"] == cfg.n_layers,
        "pages_back": pages_back(engine, wide),
    }
    drop = ("outs",)
    rec = {"phase": "serve_burst", "card": card_line(), "slots": 4, "burst": BURST,
           "new_tokens": SERVE_NEW_TOKENS,
           "runs": {k: {f: v for f, v in r.items() if f not in drop} for k, r in runs.items()},
           "decode_ms_per_token": {k: r["decode_ms_per_token"] for k, r in runs.items()},
           "decode_ms_per_step": {k: r["decode_ms_per_step"] for k, r in runs.items()},
           "graph_tokens_equal_eager": {k: r["outs"] == eager["outs"] for k, r in runs.items()},
           "lockstep_tokens_equal_generate": lock_fused["outs"] == lock_plain["outs"],
           "divergences": divs, "graph_logits": logits, "graph_profile": profile,
           "seeded": {b: {f: v for f, v in r.items() if f not in drop}
                      for b, r in seeded.items()},
           "lockstep_8_slots": {"generate": {f: v for f, v in lock_plain.items()
                                             if f not in drop},
                                "generate_fused": {f: v for f, v in lock_fused.items()
                                                   if f not in drop}},
           "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"burst serving checks failed: {failed}")
    launches = {"attn_fwd": sum(r["launches"]["attn_fwd"] for r in
                                list(runs.values()) + list(seeded.values())
                                + [lock_plain, lock_fused]),
                "paged_decode": sum(r["launches"]["paged_decode"] for r in
                                    list(runs.values()) + list(seeded.values())
                                    + [lock_plain, lock_fused])}
    del engine, wide
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_tokens": eager["outs"],
            "lockstep_tokens": lock_plain["outs"], "rec": rec}


def check_spec_fp32(dev, prompts):
    """The serving model at 2 layers in fp32 (weights from seed 0) on fp32
    KV: plain greedy serving, then speculative serving (γ 4, bursts of 8)
    with the perfect draft and with an independent one (the same shape,
    weights from seed 1).  The fp32 decode and verify kernels compute in
    true fp32, so the tokens must be identical."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, init_params_numpy, params_from_jax,
    )

    cfg32 = ModelConfig(**{**SERVE_CFG, "n_layers": 2}, dtype=torch.float32)
    model32, draft32 = (params_from_jax(init_params_numpy(cfg32, seed=s), cfg32, device=dev)
                        for s in (0, 1))
    plain = serve_engine(model32, cfg32, dev, kv="fp32").generate(
        prompts, max_new_tokens=SERVE_NEW_TOKENS)
    out = {}
    for name, dm in (("perfect", model32), ("independent", draft32)):
        tgt, draft = (serve_engine(m, cfg32, dev, kv="fp32") for m in (model32, dm))
        tgt.attach_draft(draft, gamma=GAMMA)
        got = tgt.generate(prompts, max_new_tokens=SERVE_NEW_TOKENS, burst=BURST)
        out[name] = {"tokens_equal_plain_greedy": got == plain,
                     "spec_stats": dict(tgt.spec_stats),
                     "pages_back_on_both": pages_back(tgt, draft)}
    del model32, draft32
    torch.cuda.empty_cache()
    return out


def phase_serve_spec(dev, model, cfg, burst_rec):
    """Speculative serving at full width: ``attach_draft`` (γ = 4) with the
    serve phase's 8 requests at 4 slots, bursts of 8 (each round one
    replay of a CUDA graph: γ−1 draft steps, the draft's last K/V write,
    the target's verify, the accept rule, the commit), with the perfect
    draft (the target's weights in a second engine) and the independent
    draft (2 layers at the serving widths, weights from seed 1) on bf16
    KV, and the independent draft on int8 KV.  Greedy tokens must equal
    plain greedy serving of the same KV kind; launches hold through the
    replays (paged_decode = draft layers × γ a round, paged_verify = 16 a
    round, every verify on wgmma, attn_fwd = target + draft layers a
    prefill); pages come back on both engines.  Then the lockstep
    generate_speculative_fused (perfect draft, 8 slots) against generate,
    a seeded speculative run twice, and verify at the round's shape."""
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.models import init_params_numpy, params_from_jax
    from flash_attention_dlrs_tpu_torch.runtime import SamplingParams

    prompts = serve_prompts(cfg)
    dcfg = dataclasses.replace(cfg, n_layers=DRAFT_LAYERS)
    dmodel = params_from_jax(init_params_numpy(dcfg, seed=1), dcfg, device=dev)
    drafts = {"perfect": (model, cfg), "independent": (dmodel, dcfg)}
    plain = {"bf16": burst_rec["eager_tokens"]}
    int8 = serve_engine(model, cfg, dev, kv="int8")
    plain["int8"] = graphed_run(int8, prompts, 1)["outs"]
    del int8
    runs, checks = {}, {}
    launches = {"attn_fwd": 0, "paged_decode": {"bf16": 0, "int8": 0},
                "paged_verify": {"bf16": 0, "int8": 0}}
    for name, kv in (("perfect", "bf16"), ("independent", "bf16"), ("independent", "int8")):
        dm, dc = drafts[name]
        tgt, draft = serve_engine(model, cfg, dev, kv=kv), serve_engine(dm, dc, dev, kv=kv)
        tgt.attach_draft(draft, gamma=GAMMA)
        tgt.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
        r = graphed_run(tgt, prompts, BURST)
        st, lc, key = r["spec_stats"], r["launches"], f"{name}_{kv}"
        runs[key] = {f: v for f, v in r.items() if f != "outs"}
        runs[key]["acceptance"] = st["accepted"] / max(st["proposed"], 1)
        runs[key]["tokens_equal_plain_greedy"] = r["outs"] == plain[kv]
        runs[key]["divergences"] = divergences(model, cfg, dev, prompts, plain[kv], r["outs"])
        checks.update({
            f"{key}_tokens_equal_plain_greedy_or_near_ties":
                near_ties_only(runs[key]["divergences"]),
            f"{key}_rounds_counted": st["rounds"] == r["steps"] > 0,
            f"{key}_decode_launches_draft_layers_x_gamma_per_round":
                lc["paged_decode"] == dc.n_layers * GAMMA * st["rounds"],
            f"{key}_verify_launches_16_per_round":
                lc["paged_verify"] == cfg.n_layers * st["rounds"],
            f"{key}_verify_all_wgmma": lc["verify_routes"]["wgmma"] == lc["paged_verify"],
            f"{key}_fwd_launches_per_prefill":
                lc["attn_fwd"] == (cfg.n_layers + dc.n_layers) * len(prompts),
            f"{key}_pages_back_on_both": pages_back(tgt, draft),
        })
        if name == "perfect":
            checks[f"{key}_acceptance_at_least_0.9"] = runs[key]["acceptance"] >= 0.9
        launches["attn_fwd"] += lc["attn_fwd"]
        launches["paged_decode"][kv] += lc["paged_decode"]
        launches["paged_verify"][kv] += lc["paged_verify"]
        emit({"phase": "serve_spec", "run": key, **runs[key]})
        if name == "independent" and kv == "bf16":
            sp = SamplingParams(**SEEDED)
            seeded = [graphed_run(tgt, prompts, BURST, sampling=sp)["outs"] for _ in range(2)]
            checks["seeded_spec_reproduces_itself"] = seeded[0] == seeded[1]
            checks["seeded_spec_tokens_in_vocab"] = all(
                0 <= x < cfg.vocab_size for o in seeded[0] for x in o)
            checks["seeded_spec_32_tokens"] = all(len(o) == SERVE_NEW_TOKENS for o in seeded[0])
        del tgt, draft
        torch.cuda.empty_cache()
    wide, wide_draft = serve_engine(model, cfg, dev, slots=8), serve_engine(model, cfg, dev, slots=8)
    lock = graphed_run(wide, prompts, 1, call="generate_speculative_fused",
                       draft=wide_draft, gamma=GAMMA)
    lock["tokens_equal_generate"] = lock["outs"] == burst_rec["lockstep_tokens"]
    lock["divergences"] = divergences(model, cfg, dev, prompts, burst_rec["lockstep_tokens"],
                                      lock["outs"])
    checks["lockstep_spec_fused_equals_generate_or_near_ties"] = near_ties_only(
        lock["divergences"])
    checks["lockstep_spec_pages_back"] = pages_back(wide, wide_draft)
    launches["attn_fwd"] += lock["launches"]["attn_fwd"]
    launches["paged_decode"]["bf16"] += lock["launches"]["paged_decode"]
    launches["paged_verify"]["bf16"] += lock["launches"]["paged_verify"]
    del wide, wide_draft, dmodel
    torch.cuda.empty_cache()
    fp32 = check_spec_fp32(dev, prompts)
    for name, r in fp32.items():
        checks[f"fp32_2layer_{name}_tokens_equal_plain_greedy"] = r["tokens_equal_plain_greedy"]
        checks[f"fp32_2layer_{name}_pages_back_on_both"] = r["pages_back_on_both"]
    gen = torch.Generator(device=dev).manual_seed(9)
    lengths = [n + SERVE_NEW_TOKENS // 2 + GAMMA for n in SERVE_PROMPTS[:4]]
    round_verify = time_paged(gen, dev, "bf16", 4, lengths, GAMMA)
    rec = {"phase": "serve_spec", "card": card_line(), "gamma": GAMMA, "burst": BURST,
           "slots": 4, "draft_layers": {k: c.n_layers for k, (_, c) in drafts.items()},
           "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
           "decode_ms_per_token": {k: r["decode_ms_per_token"] for k, r in runs.items()},
           "plain_graph_decode_ms_per_token":
               burst_rec["rec"]["decode_ms_per_token"]["graph_2"],
           "spec_stats": {k: r["spec_stats"] for k, r in runs.items()},
           "acceptance": {k: r["acceptance"] for k, r in runs.items()},
           "lockstep_spec_fused_8_slots": {f: v for f, v in lock.items() if f != "outs"},
           "verify_round_B4_T4": round_verify, "fp32_2layer": fp32, "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"speculative serving checks failed: {failed}")
    return {"launches": launches, "round_verify": round_verify, "rec": rec}


# ---------------------------------------------------------------------------
# Model variants through the HF import (phases serve_gemma2 and variants)
# ---------------------------------------------------------------------------

# The published config.json values of the checkpoints these phases build,
# written here (no download) and read by the port's converter through a
# types.SimpleNamespace, as it reads an HF config by attribute.
GEMMA2_2B = dict(  # google/gemma-2-2b
    vocab_size=256000, hidden_size=2304, intermediate_size=9216, num_hidden_layers=26,
    num_attention_heads=8, num_key_value_heads=4, head_dim=256, rms_norm_eps=1e-6,
    rope_theta=10000.0, sliding_window=4096, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, query_pre_attn_scalar=256,
    max_position_embeddings=8192, hidden_activation="gelu_pytorch_tanh")
LLAMA31_8B = dict(  # meta-llama/Llama-3.1-8B
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, tie_word_embeddings=False)
QWEN2_7B = dict(  # Qwen/Qwen2-7B, with the YaRN block of Qwen2.5's model card
    vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, rms_norm_eps=1e-6, rope_theta=1000000.0,
    sliding_window=131072, use_sliding_window=False, max_window_layers=28,
    max_position_embeddings=131072, tie_word_embeddings=False,
    rope_scaling={"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32768})
PHI3_MINI = dict(  # microsoft/Phi-3-mini-4k-instruct
    vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=2047, max_position_embeddings=4096, tie_word_embeddings=False)
# family: (the port's importer, its config function)
IMPORTERS = {"llama": ("import_hf_llama", "config_from_hf"),
             "qwen2": ("import_hf_llama", "config_from_hf"),
             "phi3": ("import_hf_phi3", "config_from_hf"),
             "gemma2": ("import_hf_gemma", "config_from_hf_gemma")}
# Gemma-2-2B's dense forward at twice its window; the fp32 copies' depth
GEMMA_DENSE_N, FP32_LAYERS = 8192, 2
# variants: name, config, family, weight-only int8; cut to 4 layers, served
# 4 greedy requests (prompts fit Phi-3's window: 15 pages of 128 <= 2047)
VARIANTS = (("llama3.1-8b", LLAMA31_8B, "llama", False),
            ("qwen2-7b", QWEN2_7B, "qwen2", False),
            ("qwen2-7b-int8", QWEN2_7B, "qwen2", True),
            ("phi3-mini-4k", PHI3_MINI, "phi3", False))
VARIANT_LAYERS, VARIANT_PROMPTS, VARIANT_NEW_TOKENS = 4, (200, 777, 1300, 1800), 16


def hf_state(spec, family, dev, seed, n_layers, dtype):
    """A random state dict of HF's names and [out, in] layouts for the
    config ``spec`` of ``family`` (IMPORTERS: "llama" and "qwen2" split
    projections, Qwen2's QKV biases, "phi3" fused ones, "gemma2" its
    sandwich norms), ``n_layers`` layers of ``dtype`` on ``dev`` from
    ``seed``: projections normal·in^-0.5, the embedding normal·0.02 (Gemma
    scales it by √d at run time), an untied head normal·d^-0.5, norm gains
    1 + normal·0.05 (Gemma stores gain − 1), biases normal·0.02."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    dm, dff, vocab = spec["hidden_size"], spec["intermediate_size"], spec["vocab_size"]
    nq, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    dh = spec.get("head_dim") or dm // nq

    def rnd(shape, std, offset=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + offset).to(dtype)

    def linear(dout, din):
        return rnd((dout, din), din ** -0.5)

    def gain():
        return rnd((dm,), 0.05, 0.0 if family == "gemma2" else 1.0)

    state = {"model.embed_tokens.weight": rnd((vocab, dm), 0.02), "model.norm.weight": gain()}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = gain()
        state[p + "post_attention_layernorm.weight"] = gain()
        if family == "phi3":
            state[p + "self_attn.qkv_proj.weight"] = linear((nq + 2 * nkv) * dh, dm)
            state[p + "mlp.gate_up_proj.weight"] = linear(2 * dff, dm)
        else:
            for name, rows in (("q", nq * dh), ("k", nkv * dh), ("v", nkv * dh)):
                state[p + f"self_attn.{name}_proj.weight"] = linear(rows, dm)
                if family == "qwen2":
                    state[p + f"self_attn.{name}_proj.bias"] = rnd((rows,), 0.02)
            state[p + "mlp.gate_proj.weight"] = linear(dff, dm)
            state[p + "mlp.up_proj.weight"] = linear(dff, dm)
        state[p + "self_attn.o_proj.weight"] = linear(dm, nq * dh)
        state[p + "mlp.down_proj.weight"] = linear(dm, dff)
        if family == "gemma2":
            state[p + "pre_feedforward_layernorm.weight"] = gain()
            state[p + "post_feedforward_layernorm.weight"] = gain()
    if not spec.get("tie_word_embeddings", True):
        state["lm_head.weight"] = rnd((vocab, dm), dm ** -0.5)
    return state


def import_model(spec, family, state, dev, dtype, **overrides):
    """(model, cfg): ``state`` through the family's importer, the config
    from ``spec`` read by attribute (a SimpleNamespace) with ``overrides``."""
    import types

    from flash_attention_dlrs_tpu_torch.models import convert

    importer, config_fn = IMPORTERS[family]
    cfg = getattr(convert, config_fn)(types.SimpleNamespace(**spec), dtype=dtype,
                                      **overrides)
    return getattr(convert, importer)(state, cfg=cfg, device=dev)


def first_layers(state, n, dtype):
    """The entries of ``state`` outside layers n.. , in ``dtype``."""
    return {k: v.to(dtype) for k, v in state.items()
            if not k.startswith("model.layers.") or int(k.split(".")[2]) < n}


def fp32_prefill_gap(model32, cfg32, dev, prompt):
    """The fp32 copy's last-token prefill logits through the kernels
    against the plain path, over their std."""
    import torch

    toks = torch.zeros((1, 1 << max(7, (len(prompt) - 1).bit_length())), dtype=torch.long,
                       device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    logits_k, logits_p, _, _ = _prefill_paths(
        cfg32, model32, toks, torch.tensor([len(prompt)], dtype=torch.int32, device=dev))
    return float((logits_k - logits_p).abs().max() / logits_p.std())


def dense_greedy(model, cfg, prompt, n):
    """``n`` greedy tokens of the dense forward, one full pass a token."""
    import torch
    from flash_attention_dlrs_tpu_torch.models.transformer import (
        forward_hidden, logits_from_hidden,
    )

    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            x = forward_hidden(model, torch.tensor([seq], device=model.embed.device), cfg)
            seq.append(int(logits_from_hidden(x[:, -1], model, cfg.final_softcap).argmax()))
    return seq[len(prompt):]


def eager_then_graphed(engine, cfg, prompts, new_tokens):
    """The requests eagerly (``_serve_run``: launches, admission and step
    ms, the last decode step's every layer held against the plain
    version), then as graphed bursts of BURST: the two runs' records and
    the checks that the tokens are equal and every launch count holds."""
    decode_step = engine._decode_step
    eager = _serve_run(engine, prompts, new_tokens, "paged_decode_attention")
    engine._decode_step = decode_step
    del engine._admit_dense  # the timed wrapper _serve_run left on the instance
    layers = check_layers(eager["calls"], verify=False)
    graph = graphed_run(engine, prompts, BURST, new_tokens=new_tokens)
    n = cfg.n_layers
    checks = {
        "graph_tokens_equal_eager": graph["outs"] == eager["outs"],
        f"every_request_{new_tokens}_tokens": all(len(o) == new_tokens for o in eager["outs"]),
        "fwd_launches_per_layer_and_prefill": eager["launches"]["attn_fwd"] == n * len(prompts),
        "fwd_launches_all_wgmma": all_on(eager["fwd_routes"], "wgmma",
                                         eager["launches"]["attn_fwd"]),
        "decode_launches_per_layer_and_step":
            eager["launches"]["paged_decode"] == n * eager["steps"] > 0,
        "graph_decode_launches_per_layer_and_step_through_replays":
            graph["launches"]["paged_decode"] == n * graph["steps"] > 0,
        "graph_fwd_launches_all_wgmma": all_on(graph["launches"]["fwd_routes"], "wgmma",
                                               n * len(prompts)),
        "last_step_every_layer_kernel_vs_plain": layers["ok"] and layers["layers_checked"] == n,
    }
    summary = {
        "eager": {"launches": eager["launches"], "steps": eager["steps"],
                  "admit_ms": eager["admit_ms"],
                  "decode_ms_per_step_median": float(np.median(eager["decode_ms"])),
                  "wall_s": eager["wall"],
                  "tokens_per_s": sum(map(len, eager["outs"])) / eager["wall"]},
        "graph": {k: v for k, v in graph.items() if k != "outs"},
        "last_step_layers": layers,
    }
    return summary, checks, eager, graph


def lm_head_ab_decode(model, cfg, dev, prompts, x):
    """The LM head in fp32 (:func:`lm_head_fp32`) against half-precision
    operands in turns fp32, bf16, bf16, fp32: each turn a fresh 4-slot bf16
    engine serving ``prompts`` as graphed bursts (its step graphs captured
    with that head), its ms per step, and the head's device ms on the
    hidden states ``x``."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import transformer

    out = {"fp32": [], "bf16": []}
    for head in ("fp32", "bf16", "bf16", "fp32"):
        undo = lm_head_as(lm_head_fp32) if head == "fp32" else (lambda: None)
        try:
            engine = serve_engine(model, cfg, dev)
            engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
            engine.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
            run = graphed_run(engine, prompts, BURST)
            _, busy, _, _ = profile_window(
                lambda: transformer.logits_from_hidden(x, model, cfg.final_softcap), 8)
        finally:
            undo()
        out[head].append({"graph_decode_ms_per_step": run["decode_ms_per_step"],
                          "lm_head_device_ms": busy})
        del engine
        torch.cuda.empty_cache()
    return out


def phase_serve_gemma2(dev):
    """Gemma-2-2B at full width and depth (GEMMA2_2B: 26 layers, head_dim
    256, softcaps 50 / 30, a 4096 window on even layers) from a random
    HF-named bf16 state dict (seed 0) through import_hf_gemma and a
    SimpleNamespace config, served with pages of 128 and 17 pages a
    sequence (2176 tokens, within the window, so the window never clips):
    bf16 KV at 4 slots, the 8 serving prompts (200-2048 tokens), 32 new
    tokens, eager then graphed bursts of 8, tokens equal; int8 KV at 8
    slots x 16; chunked admission (chunk 256, the prefix cache) of 8
    requests sharing a 1024-token prefix, verify at d 256; a dense
    forward_hidden of 8192 tokens (even layers windowed), its two last
    layers' attention held against the plain version; a decode profile and
    the LM head's device time; a 2-layer fp32 copy (prefill logits within
    FP32_LOGIT_LIMIT x std of the plain path, the engine's greedy tokens
    equal to the dense forward's)."""
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.models import transformer
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    t_phase = t0 = time.perf_counter()
    state = hf_state(GEMMA2_2B, "gemma2", dev, 0, GEMMA2_2B["num_hidden_layers"],
                     torch.bfloat16)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, cfg = import_model(GEMMA2_2B, "gemma2", state, dev, torch.bfloat16)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    state32 = first_layers(state, FP32_LAYERS, torch.float32)
    del state
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in model.parameters())
    checks = {"config_is_gemma2": (cfg.head_dim, cfg.window, cfg.window_pattern,
                                   cfg.attn_softcap, cfg.final_softcap, cfg.sm_scale)
              == (256, 4096, "even", 50.0, 30.0, 256 ** -0.5),
              "sandwich_norms_imported": hasattr(model.layers[0], "post_mlp_norm")}
    prompts = serve_prompts(cfg)
    engine = serve_engine(model, cfg, dev)
    engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
    engine.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
    bf16, bf16_checks, eager, graph = eager_then_graphed(engine, cfg, prompts,
                                                         SERVE_NEW_TOKENS)
    checks.update({f"bf16_{k}": v for k, v in bf16_checks.items()})
    per_len = dict(zip(map(str, SERVE_PROMPTS), eager["admit_ms"]))
    profile = phase_decode_profile(engine, cfg, "gemma-2-2b")
    x = torch.randn((engine.num_slots, cfg.d_model), device=dev, dtype=cfg.dtype)
    lm_wall, lm_busy, lm_ops, lm_kernels = profile_window(
        lambda: transformer.logits_from_hidden(x, model, cfg.final_softcap), 8)
    del engine
    torch.cuda.empty_cache()
    lm_ab = lm_head_ab_decode(model, cfg, dev, prompts, x)

    # int8 KV at 8 slots x 16 new tokens
    engine = serve_engine(model, cfg, dev, slots=8, kv="int8")
    engine.generate([[1] * 128], max_new_tokens=2)
    decode_step = engine._decode_step
    int8 = _serve_run(engine, prompts, 16, "paged_decode_attention")
    engine._decode_step = decode_step
    int8_layers = check_layers(int8["calls"], verify=False)
    checks.update({
        "int8_every_request_16_tokens": all(len(o) == 16 for o in int8["outs"]),
        "int8_decode_launches_per_layer_and_step":
            int8["launches"]["paged_decode"] == cfg.n_layers * int8["steps"] > 0,
        "int8_fwd_launches_all_wgmma": all_on(int8["fwd_routes"], "wgmma",
                                              cfg.n_layers * len(prompts)),
        "int8_last_step_every_layer_kernel_vs_plain":
            int8_layers["ok"] and int8_layers["layers_checked"] == cfg.n_layers,
    })
    del engine
    torch.cuda.empty_cache()

    # chunked admission with the prefix cache: verify at d 256
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_TOKENS).tolist()
    shared = [system + rng.integers(0, cfg.vocab_size, UNIQUE_TOKENS).tolist()
              for _ in range(CHUNKED_REQUESTS)]
    want_chunks = ((SYSTEM_TOKENS + UNIQUE_TOKENS) // CHUNK
                   + (CHUNKED_REQUESTS - 1) * (UNIQUE_TOKENS // CHUNK))
    engine = DecodeEngine(model, cfg, num_pages=CHUNKED_REQUESTS * SERVE_PPS + 1,
                          page_size=SERVE_PAGE, num_slots=CHUNKED_REQUESTS,
                          pages_per_seq=SERVE_PPS, kv_dtype=torch.bfloat16,
                          prefill_chunk=CHUNK, enable_prefix_cache=True, device=dev)
    engine.generate([[2] * 1000], max_new_tokens=2)  # warm-up, shares nothing
    hits_before = engine.prefix_cache.hits
    chunked = _serve_run(engine, shared, CHUNKED_NEW_TOKENS, "paged_verify_attention")
    hits = engine.prefix_cache.hits - hits_before
    verify_layers = check_layers(chunked["calls"], verify=True)
    checks.update({
        "chunked_7_prefix_hits": hits == CHUNKED_REQUESTS - 1,
        f"chunked_{want_chunks}_chunks": chunked["chunks"] == want_chunks,
        "chunked_verify_launches_per_layer_and_chunk":
            chunked["launches"]["paged_verify"] == cfg.n_layers * want_chunks,
        "chunked_verify_launches_all_wgmma":
            all_on(chunked["verify_routes"], "wgmma", chunked["launches"]["paged_verify"]),
        "chunked_no_dense_prefill": chunked["launches"]["attn_fwd"] == 0,
        "chunked_last_chunk_every_layer_verify_kernel_vs_plain":
            verify_layers["ok"] and verify_layers["layers_checked"] == cfg.n_layers,
    })
    del engine
    torch.cuda.empty_cache()

    # the dense forward at twice the window: even layers windowed
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, GEMMA_DENSE_N))).to(dev)
    calls, kernel_attention = [], transformer.flash_attention

    def recording(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return kernel_attention(q, k, v, **kw)

    _zero_launches()
    transformer.flash_attention = recording
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t = time.perf_counter()
            hidden = transformer.forward_hidden(model, toks, cfg)
            torch.cuda.synchronize()
            dense_s = time.perf_counter() - t
    finally:
        transformer.flash_attention = kernel_attention
    dense_launches = _launches()
    dense_layers = {}
    for li in (cfg.n_layers - 2, cfg.n_layers - 1):
        rec, ok = attention_errors(*calls[li])
        dense_layers[f"layer{li}_window{calls[li][3]['window']}"] = dict(rec, ok=ok)
    checks.update({
        "dense_8192_finite": bool(torch.isfinite(hidden).all()),
        "dense_8192_fwd_launches_one_per_layer":
            dense_launches["attn_fwd"] == cfg.n_layers
            and all_on(dense_launches["fwd_routes"], "wgmma", cfg.n_layers),
        "dense_8192_even_layers_windowed": [c[3]["window"] for c in calls[:2]] == [4096, 0],
        "dense_8192_last_two_layers_kernel_vs_plain":
            all(r["ok"] for r in dense_layers.values()),
    })
    del hidden, calls, toks
    torch.cuda.empty_cache()

    # a 2-layer fp32 copy
    cfg32 = dataclasses.replace(cfg, n_layers=FP32_LAYERS, dtype=torch.float32)
    model32, _ = import_model(GEMMA2_2B, "gemma2", state32, dev, torch.float32,
                              n_layers=FP32_LAYERS)
    del state32
    fp32_prompts = [p[:n] for p, n in zip(prompts[:2], (300, 1000))]
    fp32_gap = fp32_prefill_gap(model32, cfg32, dev, fp32_prompts[1])
    engine32 = serve_engine(model32, cfg32, dev, slots=2, kv="fp32")
    fp32_outs = engine32.generate(fp32_prompts, max_new_tokens=8)
    fp32_dense = [dense_greedy(model32, cfg32, p, 8) for p in fp32_prompts]
    checks.update({
        "fp32_2layer_prefill_logits_vs_plain": fp32_gap <= FP32_LOGIT_LIMIT,
        "fp32_2layer_engine_tokens_equal_dense_forward": fp32_outs == fp32_dense,
    })
    del engine32, model32
    torch.cuda.empty_cache()

    step_busy = profile["device_busy_ms_per_step"]
    rec = {
        "phase": "serve_gemma2", "seconds": time.perf_counter() - t_phase,
        "card": card_line(), "config": GEMMA2_2B,
        "config_source": "google/gemma-2-2b config.json", "dtype": "bfloat16",
        "params": n_params, "state_dict_s": state_s, "import_s": import_s,
        "page_size": SERVE_PAGE, "pages_per_seq": SERVE_PPS,
        "bf16_4_slots": {**bf16, "admit_ms_by_prompt_len": per_len},
        "decode_ms_per_step": {"eager": bf16["eager"]["decode_ms_per_step_median"],
                               "graph": bf16["graph"]["decode_ms_per_step"]},
        "decode_profile": {k: v for k, v in profile.items() if k != "phase"},
        "lm_head": {"shape": [cfg.vocab_size, cfg.d_model], "batch": x.shape[0],
                    "device_ms": lm_busy, "wall_ms": lm_wall, "ops": lm_ops,
                    "kernels": top_kernels(lm_kernels),
                    "share_of_step_device_ms": lm_busy / step_busy},
        "lm_head_fp32_vs_bf16_operands": lm_ab,
        "int8_8_slots": {"launches": int8["launches"], "steps": int8["steps"],
                         "decode_ms_per_step_median": float(np.median(int8["decode_ms"])),
                         "wall_s": int8["wall"], "last_step_layers": int8_layers},
        "chunked": {"launches": chunked["launches"], "verify_routes": chunked["verify_routes"],
                    "chunks": chunked["chunks"], "prefix_hits": hits,
                    "admit_ms_chunked_miss": chunked["admit_ms"][0],
                    "admit_ms_chunked_hit_median": float(np.median(chunked["admit_ms"][1:])),
                    "last_chunk_layers": verify_layers},
        "dense_8192": {"seconds": dense_s, "launches": dense_launches,
                       "layers": dense_layers},
        "fp32_2layer": {"prefill_logit_diff_over_std": fp32_gap, "tokens": fp32_outs,
                        "dense_tokens": fp32_dense},
        "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"Gemma-2-2B serving checks failed: {failed}")
    del model
    torch.cuda.empty_cache()
    bf16_decode = (eager["launches"]["paged_decode"] + graph["launches"]["paged_decode"]
                   + chunked["launches"]["paged_decode"])
    return {"rec": rec, "launches": {
        "attn_fwd": eager["launches"]["attn_fwd"] + graph["launches"]["attn_fwd"]
        + int8["launches"]["attn_fwd"],
        "attn_fwd_window": dense_launches["attn_fwd"],
        "paged_decode_bf16": bf16_decode,
        "paged_decode_int8": int8["launches"]["paged_decode"],
        "paged_verify_bf16": chunked["launches"]["paged_verify"]}}


def phase_variants(dev):
    """VARIANTS at their published widths, cut to VARIANT_LAYERS layers:
    each from a random HF-named bf16 state dict through its own importer
    and a SimpleNamespace config (Qwen2's int8 copy through
    quantize_params), 4 greedy requests (VARIANT_PROMPTS, 16 new tokens)
    eagerly and as graphed bursts of 8 with equal tokens and exact launch
    counts, and a 2-layer fp32 copy's prefill logits within
    FP32_LOGIT_LIMIT x std of the plain path."""
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.models import quantize_params
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import kernel_width
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    rng = np.random.default_rng(4)
    t_phase = time.perf_counter()
    records, launches, checks = {}, {"attn_fwd": 0, "paged_decode": 0}, {}
    for i, (name, spec, family, int8) in enumerate(VARIANTS):
        t0 = time.perf_counter()
        state = hf_state(spec, family, dev, 10 + i, VARIANT_LAYERS, torch.bfloat16)
        model, cfg = import_model(spec, family, state, dev, torch.bfloat16,
                                  n_layers=VARIANT_LAYERS)
        state32 = first_layers(state, FP32_LAYERS, torch.float32)
        del state
        if int8:
            quantize_params(model)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        # pages of 128 within the window (Phi-3: 2047 -> 15 pages)
        pps = min(SERVE_PPS, cfg.window // SERVE_PAGE) if cfg.window else SERVE_PPS
        engine = DecodeEngine(model, cfg, num_pages=4 * pps + 1, page_size=SERVE_PAGE,
                              num_slots=4, pages_per_seq=pps, kv_dtype=torch.bfloat16,
                              device=dev)
        engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
        engine.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in VARIANT_PROMPTS]
        summary, run_checks, eager, graph = eager_then_graphed(engine, cfg, prompts,
                                                               VARIANT_NEW_TOKENS)
        del engine
        cfg32 = dataclasses.replace(cfg, n_layers=FP32_LAYERS, dtype=torch.float32)
        model32, _ = import_model(spec, family, state32, dev, torch.float32,
                                  n_layers=FP32_LAYERS)
        if int8:
            quantize_params(model32)
        gap = fp32_prefill_gap(model32, cfg32, dev, prompts[1])
        del model32, state32
        run_checks["fp32_2layer_prefill_logits_vs_plain"] = gap <= FP32_LOGIT_LIMIT
        run_checks["imported_as_published"] = {
            "llama": lambda: cfg.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 8192.0)
            and not cfg.tie_embeddings,
            "qwen2": lambda: cfg.rope_scaling[0] == "yarn"
            and hasattr(model.layers[0], "bq") and cfg.window == 0,
            "phi3": lambda: cfg.head_dim == 96 and cfg.window == 2047 and pps == 15,
        }[family]()
        for key in ("attn_fwd", "paged_decode"):
            launches[key] += eager["launches"][key] + graph["launches"][key]
        records[name] = {"config_source": name, "layers": VARIANT_LAYERS,
                         "head_dim": cfg.head_dim, "kernel_head_dim": kernel_width(cfg.head_dim),
                         "window": cfg.window, "rope_scaling": cfg.rope_scaling,
                         "int8_weights": int8, "pages_per_seq": pps,
                         "params": sum(p.numel() for p in model.parameters())
                         + sum(b.numel() for b in model.buffers()),
                         "import_s": import_s, **summary,
                         "fp32_2layer_prefill_logit_diff_over_std": gap,
                         "checks": run_checks}
        emit({"phase": "variants", "model": name, **records[name]})
        checks.update({f"{name}_{k}": v for k, v in run_checks.items()})
        del model
        torch.cuda.empty_cache()
    emit({"phase": "variants", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"variant serving checks failed: {failed}")
    return {"launches": launches, "records": records}


TRAIN_CFG = dict(vocab_size=32000, d_model=4096, n_layers=8, n_q_heads=32,
                 n_kv_heads=8, head_dim=128, d_ff=11008)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARM_STEPS, TRAIN_TIMED_STEPS = 1, 3
TRAIN_ALIBI_DROPOUT = 0.1  # train_alibi: the ALiBi model with attention dropout
# The fp32 copy of the training model: 2 layers at full width, batch 2.  Its
# kernel path computes in true fp32, so its loss and gradients must match
# the plain path's to summation order: 1e-3 x each gradient's std.
TRAIN_FP32_LAYERS, TRAIN_FP32_BATCH = 2, 2
FP32_GRAD_LIMIT = 1e-3
FP32_LOSS_RTOL = 1e-5
# Device time of the profiled train step by kind, from kernel names: the
# first group whose marker a name contains takes it.
TRAIN_PROFILE_GROUPS = (
    ("attention kernels (csrc/attn_*.cu)", ("attn_",)),
    ("fp32 GEMMs (the LM head's gradients in true fp32)", ("f32f32", "sgemm")),
    ("other GEMMs (bf16 projections, cuBLAS)", ("nvjet", "gemm")),
    ("AdamW (multi-tensor kernels)", ("multi_tensor",)),
)


def model_flops_per_token(cfg, seq: int) -> float:
    """The repo's MFU convention (scripts/bench_train.py:26-36): 3 x the
    forward's matmul flops per token (projections, causal attention, LM
    head), so the remat recompute is not counted as useful work."""
    d, ff, n_layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    h_q, h_kv, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = 2 * d * (h_q * hd + 2 * h_kv * hd)  # qkv proj
    per_layer += 2 * (h_q * hd) * d  # out proj
    per_layer += 2 * d * ff * 3  # swiglu gate/up/down
    attn = 2 * 2 * h_q * hd * seq / 2  # QK^T + PV, causal half
    embed = 2 * d * cfg.vocab_size  # lm head
    return 3 * (n_layers * (per_layer + attn) + embed)


def _attention_ops():
    """The module ops/flash_attention.py (the package exports a function of
    the same name), whose attn_fwd / attn_bwd the checks swap."""
    return importlib.import_module("flash_attention_dlrs_tpu_torch.ops.flash_attention")


def _kernels():
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import FWD_KERNEL

    return {"attn_fwd": FWD_KERNEL,
            "attn_bwd_preprocess": bwd_kernel.PREPROCESS_KERNEL,
            "attn_bwd_dkv": bwd_kernel.DKV_KERNEL,
            "attn_bwd_dq": bwd_kernel.DQ_KERNEL}


def check_train_attention(model, opt_state, step, tokens, seed, pick=None):
    """One more train step (dropout seed ``seed``) with every layer's
    attention backward inputs recorded; then, on that step's own
    q/k/v/O/lse/dO and the same ALiBi and dropout arguments, each layer's
    forward kernel output (O, lse) against the plain forward at the
    fwd_check tolerances, and its backward kernels against the plain
    backward at the bwd_check tolerances.  With ``pick`` (the kernels'
    keyword arguments -> a key, or None) only the first layer of each key
    is kept and checked."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd, attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    fa_ops = _attention_ops()
    recorded = []
    kernel_bwd = fa_ops.attn_bwd

    keys = set()

    def recording(q, k, v, o, lse, do, **kw):
        key = None if pick is None else pick(kw)
        if pick is None or (key is not None and key not in keys):
            keys.add(key)
            recorded.append((q, k, v, o, lse, do, kw))
        return kernel_bwd(q, k, v, o, lse, do, **kw)

    try:
        fa_ops.attn_bwd = recording
        loss = float(step(model, opt_state, tokens, seed))
    finally:
        fa_ops.attn_bwd = kernel_bwd
    worst, ok = {}, True
    for q, k, v, o, lse, do, kw in recorded:
        with torch.no_grad():
            fwd_rec, fwd_ok = fwd_errors((o, lse), attn_fwd_plain(q, k, v, **kw),
                                         q.dtype)
            bwd_rec, bwd_ok = bwd_errors(attn_bwd(q, k, v, o, lse, do, **kw),
                                         attn_bwd_plain(q, k, v, o, lse, do, **kw),
                                         q.dtype)
        ok &= fwd_ok and bwd_ok
        for key, val in {**fwd_rec, **bwd_rec}.items():
            if key.startswith(("max_abs", "rel_err")):
                worst[key] = max(worst.get(key, 0.0), val)
    n = len(recorded)
    recorded.clear()
    return loss, n, worst, ok


def _grad_gaps(grads, ref, ids):
    """max |g - ref| / std(ref) per leaf; the worst leaf outside the
    embedding and the worst of each layer; and the embedding's gap split
    into the rows of the input tokens ``ids`` and the other rows (which
    only the tied LM head reaches), each still over the whole leaf's std."""
    import torch

    ratios = {n: float((grads[n] - g).abs().max() / g.std()) for n, g in ref.items()}
    rest = {n: r for n, r in ratios.items() if n != "embed"}
    layers = {}
    for n, r in rest.items():
        if n.startswith("layers."):
            key = ".".join(n.split(".")[:2])
            layers[key] = max(layers.get(key, 0.0), r)
    diff = (grads["embed"] - ref["embed"]).abs().amax(dim=1)
    on_input = torch.zeros_like(diff, dtype=torch.bool).index_fill_(0, ids, True)
    std = float(ref["embed"].std())
    return {
        "per_leaf": ratios,
        "worst_non_embed": max(rest, key=rest.get),
        "worst_non_embed_diff_over_std": max(rest.values()),
        "worst_per_layer": layers,
        "embed_input_rows": float(diff[on_input].max()) / std,
        "embed_other_rows": float(diff[~on_input].max()) / std,
    }


def check_train_fp32(tokens, dev, seed=None, build=None, batch=None, loss=None, **variant):
    """The training model (with the config fields ``variant``; or the
    (model, cfg) that ``build()`` makes, its loss ``loss(model, tokens,
    cfg, dropout_seed=)`` when given) in fp32 at 2 layers: loss and
    gradients of one step on ``batch`` rows (dropout seed ``seed``, the same
    masks on both sides) through the kernels and through the plain versions.  A third run
    takes the plain path with the plain backward's q-row chunks cut to a
    quarter, which only reorders the fp32 sums of dK and dV: its gap to the
    plain run is the gradients' own sensitivity to summation order, against
    which the kernel path's gap is read."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, init_params_numpy, loss_fn, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    if build is None:
        cfg = ModelConfig(**{**TRAIN_CFG, "n_layers": TRAIN_FP32_LAYERS, **variant},
                          dtype=torch.float32)
        model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    else:
        model, cfg = build()
    toks = tokens[:batch or TRAIN_FP32_BATCH]
    objective = loss or loss_fn

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        value = objective(model, toks, cfg, dropout_seed=seed)
        value.backward()
        return value.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    fa_ops = _attention_ops()
    kernels = fa_ops.attn_fwd, fa_ops.attn_bwd
    chunk = bwd_kernel._PLAIN_CHUNK_ELEMS
    try:
        fa_ops.attn_fwd, fa_ops.attn_bwd = attn_fwd_plain, attn_bwd_plain
        loss_p, grads_p = loss_and_grads()
        bwd_kernel._PLAIN_CHUNK_ELEMS = chunk // 4
        _, grads_r = loss_and_grads()
    finally:
        fa_ops.attn_fwd, fa_ops.attn_bwd = kernels
        bwd_kernel._PLAIN_CHUNK_ELEMS = chunk
    ids = toks[:, :-1].unique()
    gaps = _grad_gaps(grads_k, grads_p, ids)
    floor = _grad_gaps(grads_r, grads_p, ids)
    ratios = gaps.pop("per_leaf")
    worst = max(ratios, key=ratios.get)
    del model, grads_k, grads_p, grads_r
    torch.cuda.empty_cache()
    return {
        "fp32_layers": cfg.n_layers, "fp32_batch": toks.shape[0],
        "fp32_loss_kernel": loss_k, "fp32_loss_plain": loss_p,
        "fp32_worst_grad": worst, "fp32_worst_grad_diff_over_std": ratios[worst],
        "fp32_kernel_vs_plain": {"per_leaf": ratios, **gaps},
        "fp32_plain_reordered_vs_plain": floor,
        "ok": (abs(loss_k - loss_p) <= FP32_LOSS_RTOL * abs(loss_p)
               and ratios[worst] <= FP32_GRAD_LIMIT
               and all(np.isfinite(list(ratios.values())))),
    }


def profiled_train_step(run):
    """One train step (``run``) in a profiler window: wall and device-busy
    ms, the idle share, the device operations and the device ms by kind
    (TRAIN_PROFILE_GROUPS) and of the top kernels."""
    wall, busy, ops, by_name = profile_window(run, 1)
    by_group = {label: 0.0 for label, _ in TRAIN_PROFILE_GROUPS}
    by_group["everything else"] = 0.0
    for kname, ms in by_name.items():
        label = next((label for label, marks in TRAIN_PROFILE_GROUPS
                      if any(m in kname for m in marks)), "everything else")
        by_group[label] += ms
    return {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "device_ops": ops, "device_ms_by_kind": by_group,
            "top_device_ms": top_kernels(by_name, 8)}


def phase_train(dev, name="train", kernels=None, route="wgmma", warm=TRAIN_WARM_STEPS,
                timed=TRAIN_TIMED_STEPS, bwd_route=None, **variant):
    """The training path at the bench-train config (with the config fields
    ``variant``), full width and depth: make_train_state (weights from
    init_params_numpy, seed 0), AdamW lr 3e-4 / wd 0.01, one batch of tokens
    [8, 2049] from numpy seed 1, step i called with dropout seed i.
    ``warm`` (2) warm steps, ``timed`` (4) timed ones (synchronized at the
    edges, launch counts of ``kernels`` (the d128 builds: _kernels())
    zeroed just before and read just after, every forward on ``route`` and
    every sweep on ``bwd_route``, by default ``route``), one profiled step (the rope model only), one step whose
    attention backward inputs are recorded and checked layer by layer, then
    the 2-layer fp32 comparison of kernel and plain paths."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, make_train_state, make_train_step,
    )

    cfg = ModelConfig(**{**TRAIN_CFG, **variant}, dtype=torch.bfloat16, remat=True,
                      remat_policy="block")
    t0 = time.perf_counter()
    model, opt_state, optimizer = make_train_state(
        cfg, params=seeded_weights(cfg), device=dev, learning_rate=3e-4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)

    losses = [float(step(model, opt_state, tokens, i)) for i in range(warm)]
    torch.cuda.reset_peak_memory_stats()
    kernels = kernels or _kernels()
    for kern in kernels.values():
        kern.launches = 0
    fwd_routes(zero=True)
    bwd_routes(zero=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    timed_losses = [step(model, opt_state, tokens, warm + i) for i in range(timed)]
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t) * 1e3 / timed
    launches = {kname: kern.launches for kname, kern in kernels.items()}
    routes = fwd_routes()
    sweep_routes = bwd_routes()
    losses += [float(x) for x in timed_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    profiled = {}
    if not variant:
        profiled = {"profiled_step": profiled_train_step(
            lambda: losses.append(float(step(model, opt_state, tokens, len(losses)))))}

    loss, layers_checked, attn_err, attn_ok = check_train_attention(
        model, opt_state, step, tokens, len(losses))
    losses.append(loss)
    del model, opt_state, optimizer
    torch.cuda.empty_cache()
    fp32 = check_train_fp32(tokens, dev, seed=3, **variant)

    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (ms_per_step / 1e3)
    fpt = model_flops_per_token(cfg, TRAIN_SEQ)
    # block remat: two forwards a layer and step (each with its product pass
    # on route wide_scores), one of each backward kernel
    expected = {kname: (2 if kname.startswith("attn_fwd") else 1) * cfg.n_layers * timed
                for kname in kernels}
    checks = {
        "loss_finite": all(np.isfinite(losses)),
        "loss_falls": losses[-1] < losses[0],
        "launches_exact_per_step": launches == expected,
        f"fwd_launches_all_{route}": all_on(routes, route, launches["attn_fwd"]),
        f"bwd_sweep_launches_all_{bwd_route or route}": all(
            all_on(sweep_routes[sweep], bwd_route or route, launches[sweep])
            for sweep in sweep_routes),
        "attention_every_layer_fwd_and_bwd_kernel_vs_plain":
            layers_checked == cfg.n_layers and attn_ok,
        "fp32_2layer_kernel_vs_plain": fp32.pop("ok"),
    }
    rec = {
        "phase": name, "config": {**TRAIN_CFG, **variant}, "dtype": "bfloat16",
        "remat_policy": "block", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "params": n_params, "weights_setup_s": setup_s,
        "optimizer": "AdamW (optax.adamw semantics) lr 3e-4, wd 0.01",
        "losses": losses, "warm_steps": warm, "timed_steps": timed,
        "ms_per_step": ms_per_step, "tokens_per_s": tokens_per_s,
        "model_flops_per_token": fpt,
        "mfu": tokens_per_s * fpt / PEAK_BF16_FLOPS,
        "mfu_formula": ("tokens/s x model_flops_per_token (3 x forward matmul "
                        "flops: projections, causal attention, LM head; "
                        "scripts/bench_train.py:26-36) / 989e12"),
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_expected": expected, "fwd_routes": routes,
        "bwd_routes": sweep_routes, **profiled,
        "attention_layers_checked": layers_checked,
        **{f"attention_{k}": v for k, v in attn_err.items()},
        **fp32, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")
    return rec


# Gemma-2-2B trained at its published width and depth (train_gemma2):
# google/gemma-2-2b's config (GEMMA2_2B), random HF-named bf16 weights from
# seed 0 through import_hf_gemma, block remat, B2 x N8192 (its
# max_position_embeddings, twice the 4096 window, so the even layers' window
# bites in the backward; 16,384 tokens a step, as the training bench's 8 x
# 2048), the cross entropy in chunks of GEMMA_LOSS_CHUNK positions.
GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ, GEMMA_LOSS_CHUNK = 2, 8192, 1024
# the save_flash run's warm and timed steps; the adamw8bit run takes the
# AdamW run's (its losses are printed beside AdamW's)
GEMMA_SAVE_FLASH_WARM, GEMMA_SAVE_FLASH_TIMED = 1, 2
# steps per turn of the LM-head comparison (fp32, bf16, bf16, fp32)
LM_HEAD_AB_STEPS = 1


def gemma_train_model(dev, dtype, n_layers, **overrides):
    """(model, cfg): Gemma-2-2B at ``n_layers`` layers in ``dtype`` from a
    random HF-named state dict (seed 0: every call makes the same weights)
    through import_hf_gemma, with the training overrides (loss chunk) and
    ``overrides``."""
    import torch

    state = hf_state(GEMMA2_2B, "gemma2", dev, 0, n_layers, dtype)
    model, cfg = import_model(GEMMA2_2B, "gemma2", state, dev, dtype, n_layers=n_layers,
                              loss_chunk=GEMMA_LOSS_CHUNK, **overrides)
    del state
    torch.cuda.empty_cache()
    return model, cfg


def _d256_kernels():
    """The kernels of a training step at head dim 256 (its builds of the
    forward and the sweeps), beside those of head dims 64 and 128."""
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel

    return {"attn_fwd": fwd_kernel.FWD_D256_KERNEL,
            "attn_bwd_preprocess": bwd_kernel.PREPROCESS_KERNEL,
            "attn_bwd_dkv": bwd_kernel.DKV_D256_KERNEL,
            "attn_bwd_dq": bwd_kernel.DQ_D256_KERNEL,
            "attn_fwd[d64/128]": fwd_kernel.FWD_KERNEL,
            "attn_bwd_dkv[d64/128]": bwd_kernel.DKV_KERNEL,
            "attn_bwd_dq[d64/128]": bwd_kernel.DQ_KERNEL}


def windowed_calls():
    """Wraps ops/flash_attention.py's attn_fwd and attn_bwd to count their
    calls with and without a window; returns (counts, undo)."""
    fa_ops = _attention_ops()
    real = fa_ops.attn_fwd, fa_ops.attn_bwd
    counts = {"attn_fwd_window": 0, "attn_fwd_global": 0,
              "attn_bwd_window": 0, "attn_bwd_global": 0}

    def counting(name, fn):
        def call(*args, **kw):
            counts[f"{name}_{'window' if kw.get('window') else 'global'}"] += 1
            return fn(*args, **kw)
        return call

    fa_ops.attn_fwd, fa_ops.attn_bwd = counting("attn_fwd", real[0]), counting("attn_bwd", real[1])

    def undo():
        fa_ops.attn_fwd, fa_ops.attn_bwd = real
    return counts, undo


def lm_head_fp32(x, embed):
    """The LM head as the port computed it before it took half-precision
    operands on the card: both operands upcast, one fp32 GEMM."""
    return x.float() @ embed.float().t()


def lm_head_as(fn):
    """Puts ``fn`` in place of models/transformer.py lm_logits (every LM
    head of the port calls it); returns the undo."""
    from flash_attention_dlrs_tpu_torch.models import transformer

    real = transformer.lm_logits
    transformer.lm_logits = fn

    def undo():
        transformer.lm_logits = real
    return undo


def timed_steps(step, model, opt_state, tokens, n, seed0=None):
    """``n`` train steps synchronized at both edges, step i with dropout
    seed ``seed0`` + i when ``seed0`` is given: (losses, ms per step)."""
    import torch

    seeds = [()] * n if seed0 is None else [(seed0 + i,) for i in range(n)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = [step(model, opt_state, tokens, *seed) for seed in seeds]
    torch.cuda.synchronize()
    return [float(x) for x in losses], (time.perf_counter() - t) * 1e3 / n


def optimizer_update_ms(optimizer, model, opt_state, reps=3):
    """CUDA-event ms of one optimizer update on the gradients in place."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    optimizer.update(model, opt_state)  # warm
    start.record()
    for _ in range(reps):
        optimizer.update(model, opt_state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gemma_train_run(dev, tokens, warm, timed, optimizer_name="adamw", seeded=False,
                    **overrides):
    """One training run of Gemma-2-2B (:func:`gemma_train_model`, config
    ``overrides``) with ``optimizer_name`` (AdamW lr 3e-4, wd 0.01, or the
    blockwise-int8 AdamW): ``warm`` steps, then ``timed`` ones with every
    launch count set to 0 just before and read just after; with ``seeded``
    step i takes dropout seed i.  Returns the record and (model, cfg,
    optimizer, opt_state, step) to go on with."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import AdamW, make_train_step
    from flash_attention_dlrs_tpu_torch.models.optim import AdamW8bit, moment_bytes

    t0 = time.perf_counter()
    model, cfg = gemma_train_model(dev, torch.bfloat16, GEMMA2_2B["num_hidden_layers"],
                                   **overrides)
    optimizer = (AdamW8bit if optimizer_name == "adamw8bit" else AdamW)(
        3e-4, weight_decay=0.01)
    opt_state = optimizer.init(model)
    step = make_train_step(cfg, optimizer)
    setup_s = time.perf_counter() - t0
    losses = [float(step(model, opt_state, tokens, *((i,) if seeded else ())))
              for i in range(warm)]
    torch.cuda.reset_peak_memory_stats()
    kernels = _d256_kernels()
    for kern in kernels.values():
        kern.launches = 0
    fwd_routes(zero=True)
    bwd_routes(zero=True)
    split, undo = windowed_calls()
    try:
        timed_losses, ms = timed_steps(step, model, opt_state, tokens, timed,
                                       warm if seeded else None)
    finally:
        undo()
    launches = {name: kern.launches for name, kern in kernels.items()}
    rec = {
        "optimizer": optimizer_name, "remat_policy": cfg.remat_policy,
        "setup_s": setup_s, "losses": losses + timed_losses, "timed_steps": timed,
        "ms_per_step": ms, "tokens_per_s": GEMMA_TRAIN_BATCH * GEMMA_TRAIN_SEQ / (ms / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "launches_by_window": dict(split),
        "fwd_routes": fwd_routes(), "bwd_routes": bwd_routes(),
        "moment_bytes": dict(zip(("adamw_bf16", "adamw8bit"), moment_bytes(model))),
    }
    return rec, (model, cfg, optimizer, opt_state, step)


def gemma_launches_exact(run, fwd_per_layer, n_layers):
    """Whether a Gemma-2-2B training run's timed steps (``run``, from
    :func:`gemma_train_run`) launched exactly ``fwd_per_layer`` forwards and
    one of each backward kernel a layer and step, all of the head-dim-256
    builds and on the wgmma route, half of them on the windowed (even)
    layers."""
    per = run["timed_steps"] * n_layers
    want = {"attn_fwd": fwd_per_layer * per, "attn_bwd_preprocess": per,
            "attn_bwd_dkv": per, "attn_bwd_dq": per, "attn_fwd[d64/128]": 0,
            "attn_bwd_dkv[d64/128]": 0, "attn_bwd_dq[d64/128]": 0}
    half = n_layers // 2 * run["timed_steps"]  # even layers slide
    return (run["launches"] == want
            and all_on(run["fwd_routes"], "wgmma", want["attn_fwd"])
            and all(all_on(run["bwd_routes"][s], "wgmma", per) for s in run["bwd_routes"])
            and run["launches_by_window"] == {
                "attn_fwd_window": fwd_per_layer * half,
                "attn_fwd_global": fwd_per_layer * half,
                "attn_bwd_window": half, "attn_bwd_global": half})


def phase_train_gemma2(dev):
    """Gemma-2-2B trained at full width and depth (26 layers, head dim 256,
    softcaps 50 / 30, the 4096 window on even layers; B2 x N8192, block
    remat, AdamW): 1 warm and 3 timed steps with exact launch counts per
    kernel and route (the head-dim-256 backward sweeps on the wgmma route);
    ms/step, tokens/s, MFU, peak; the optimizer update's time; one profiled
    step's device time by kind; the LM head
    in fp32 against half-precision operands (turns of LM_HEAD_AB_STEPS
    steps: fp32, bf16, bf16, fp32); one step whose attention is held
    against the plain versions on one windowed and one global layer; a
    2-layer fp32 copy (the fp32 d256 route) against the plain path.  Then
    the same weights under remat_policy="save_flash" (the attention
    forward launched once a layer and step) and with the blockwise-int8
    AdamW (its moment bytes; its first loss equal to AdamW's, the rest
    finite beside AdamW's)."""
    import torch

    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, GEMMA2_2B["vocab_size"], (GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ + 1))).to(dev)
    n_layers = GEMMA2_2B["num_hidden_layers"]
    warm, timed = TRAIN_WARM_STEPS, TRAIN_TIMED_STEPS
    block, (model, cfg, optimizer, opt_state, step) = gemma_train_run(dev, tokens, warm, timed)
    n_params = sum(p.numel() for p in model.parameters())
    block["optimizer_update_ms"] = optimizer_update_ms(optimizer, model, opt_state)
    block["profiled_step"] = profiled_train_step(lambda: step(model, opt_state, tokens))
    lm_ab = {"fp32": [], "bf16": []}
    for head in ("fp32", "bf16", "bf16", "fp32"):
        undo = lm_head_as(lm_head_fp32) if head == "fp32" else (lambda: None)
        try:
            lm_ab[head].append(timed_steps(step, model, opt_state, tokens, LM_HEAD_AB_STEPS)[1])
        finally:
            undo()
    _, layers_checked, attn_err, attn_ok = check_train_attention(
        model, opt_state, step, tokens, None,
        pick=lambda kw: "window" if kw["window"] else "global")
    del model, opt_state, optimizer, step
    torch.cuda.empty_cache()
    fp32 = check_train_fp32(tokens, dev, batch=1,
                            build=lambda: gemma_train_model(dev, torch.float32, 2))

    flash, rest = gemma_train_run(dev, tokens, GEMMA_SAVE_FLASH_WARM, GEMMA_SAVE_FLASH_TIMED,
                                  remat_policy="save_flash")
    del rest
    torch.cuda.empty_cache()
    adam8, (model8, _, optimizer8, opt_state8, _) = gemma_train_run(
        dev, tokens, warm, timed, optimizer_name="adamw8bit")
    adam8["optimizer_update_ms"] = optimizer_update_ms(optimizer8, model8, opt_state8)
    del model8, optimizer8, opt_state8
    torch.cuda.empty_cache()

    fpt = model_flops_per_token(cfg, GEMMA_TRAIN_SEQ)
    tokens_per_s = block["tokens_per_s"]

    def exact(run, fwd_per_layer):
        return gemma_launches_exact(run, fwd_per_layer, n_layers)

    losses = block["losses"]
    checks = {
        "config_is_gemma2": (cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.window,
                             cfg.window_pattern, cfg.attn_softcap, cfg.final_softcap)
        == (26, 2304, 256, 4096, "even", 50.0, 30.0),
        "loss_finite": all(np.isfinite(losses)),
        "loss_falls": losses[-1] < losses[0],
        "launches_exact_per_step_all_wgmma": exact(block, 2),
        "attention_windowed_and_global_layer_fwd_and_bwd_kernel_vs_plain":
            layers_checked == 2 and attn_ok,
        "fp32_2layer_kernel_vs_plain": fp32.pop("ok"),
        "save_flash_fwd_launched_once_per_layer_and_step": exact(flash, 1),
        "save_flash_loss_finite": all(np.isfinite(flash["losses"])),
        "adamw8bit_first_loss_equals_adamw":
            abs(adam8["losses"][0] - losses[0]) <= 1e-5 * abs(losses[0]),
        "adamw8bit_losses_finite": all(np.isfinite(adam8["losses"])),
        "adamw8bit_launches_exact": exact(adam8, 2),
        "adamw8bit_moments_bytes": adam8["moment_bytes"]["adamw8bit"]
        < 0.52 * adam8["moment_bytes"]["adamw_bf16"],
    }
    rec = {
        "phase": "train_gemma2", "card": card_line(), "config": GEMMA2_2B,
        "config_source": "google/gemma-2-2b config.json", "dtype": "bfloat16",
        "params": n_params, "batch": GEMMA_TRAIN_BATCH, "seq": GEMMA_TRAIN_SEQ,
        "loss_chunk": GEMMA_LOSS_CHUNK, "remat_policy": "block",
        "optimizer": "AdamW (optax.adamw semantics) lr 3e-4, wd 0.01",
        **{k: v for k, v in block.items() if k not in ("optimizer", "remat_policy")},
        "model_flops_per_token": fpt, "mfu": tokens_per_s * fpt / PEAK_BF16_FLOPS,
        "mfu_formula": ("tokens/s x model_flops_per_token (3 x forward matmul flops: "
                        "projections, causal attention, LM head; scripts/bench_train.py:"
                        "26-36; its convention counts the windowed layers as fully causal) "
                        "/ 989e12"),
        "lm_head_ab_ms_per_step": lm_ab,
        "attention_layers_checked": layers_checked,
        **{f"attention_{k}": v for k, v in attn_err.items()}, **fp32,
        "save_flash": flash, "adamw8bit": adam8,
        "losses_adamw_vs_adamw8bit": list(zip(losses, adam8["losses"])),
        "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_gemma2 checks failed: {failed}")
    return rec


# Gemma-2-2B trained under attention dropout (train_gemma2_dropout): HF
# Gemma2Config's attention_dropout, which import_hf_gemma does not read, set
# on the imported config; the shape and optimizer of train_gemma2, cut to 1
# warm and 2 timed steps (step i seeded with i) to keep the script's time.
GEMMA_ATTN_DROPOUT = 0.1
GEMMA_DROPOUT_WARM, GEMMA_DROPOUT_TIMED = 1, 2


def phase_train_gemma2_dropout(dev, gemma_rec):
    """Gemma-2-2B at full width and depth with attn_dropout=0.1 (B2 x
    N8192, block remat, AdamW): the timed steps' exact launches per kernel
    and route (every head-dim-256 forward and both sweeps on the wgmma
    route, the dropout instances of attn_fwd_d256.cu and attn_bwd_d256.cu),
    ms/step, tokens/s and MFU beside train_gemma2's (``gemma_rec``); one
    more step whose attention, on one windowed and one global layer, is
    held against the plain versions under the same dropout mask at the
    kernel tolerances; a 2-layer fp32 copy with dropout on the fp32 d256
    route against the plain path."""
    import torch

    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, GEMMA2_2B["vocab_size"], (GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ + 1))).to(dev)
    n_layers = GEMMA2_2B["num_hidden_layers"]
    run, (model, cfg, optimizer, opt_state, step) = gemma_train_run(
        dev, tokens, GEMMA_DROPOUT_WARM, GEMMA_DROPOUT_TIMED, seeded=True,
        attn_dropout=GEMMA_ATTN_DROPOUT)
    # only calls that carry the dropout are kept: one windowed, one global
    loss, layers_checked, attn_err, attn_ok = check_train_attention(
        model, opt_state, step, tokens, GEMMA_DROPOUT_WARM + GEMMA_DROPOUT_TIMED,
        pick=lambda kw: (("window" if kw["window"] else "global")
                         if kw["dropout_rate"] == GEMMA_ATTN_DROPOUT else None))
    del model, opt_state, optimizer, step
    torch.cuda.empty_cache()
    fp32 = check_train_fp32(tokens, dev, seed=3, batch=1, build=lambda: gemma_train_model(
        dev, torch.float32, 2, attn_dropout=GEMMA_ATTN_DROPOUT))
    fpt = model_flops_per_token(cfg, GEMMA_TRAIN_SEQ)
    losses = run["losses"] + [loss]
    checks = {
        "config_is_gemma2_with_dropout": (cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.window,
                                          cfg.attn_dropout)
        == (26, 2304, 256, 4096, GEMMA_ATTN_DROPOUT),
        "loss_finite": all(np.isfinite(losses)),
        "launches_exact_per_step_all_wgmma": gemma_launches_exact(run, 2, n_layers),
        "attention_windowed_and_global_layer_fwd_and_bwd_kernel_vs_plain":
            layers_checked == 2 and attn_ok,
        "fp32_2layer_kernel_vs_plain": fp32.pop("ok"),
    }
    rec = {
        "phase": "train_gemma2_dropout", "card": card_line(),
        "config": {**GEMMA2_2B, "attention_dropout": GEMMA_ATTN_DROPOUT},
        "config_source": "google/gemma-2-2b config.json, attention_dropout set",
        "dtype": "bfloat16", "batch": GEMMA_TRAIN_BATCH, "seq": GEMMA_TRAIN_SEQ,
        **{k: v for k, v in run.items() if k not in ("moment_bytes",)},
        "model_flops_per_token": fpt, "mfu": run["tokens_per_s"] * fpt / PEAK_BF16_FLOPS,
        "train_gemma2": {"ms_per_step": gemma_rec["ms_per_step"],
                         "tokens_per_s": gemma_rec["tokens_per_s"], "mfu": gemma_rec["mfu"]},
        "attention_layers_checked": layers_checked,
        **{f"attention_{k}": v for k, v in attn_err.items()}, **fp32,
        "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_gemma2_dropout checks failed: {failed}")
    return rec


# The remat policies (remat): the training-bench model (TRAIN_CFG, the shape
# the JAX package's comments size the policies for, transformer.py:387-400)
# under each, from the same weights; steps per policy.
REMAT_POLICIES = ("block", "save_flash", "save_dots", "save_matmuls")
REMAT_WARM, REMAT_TIMED = 1, 2


def phase_remat(dev):
    """Each remat policy on the training-bench model at full width and
    depth (B8 x 2048, bf16, AdamW), from the same weights: ms/step, peak and
    launches (the attention forward twice a layer and step under block
    remat, once under the others); then the 2-layer fp32 copy's loss and
    gradients under the four, which must be bitwise equal (the kernels are
    deterministic and the policies only choose what is kept)."""
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        AdamW, ModelConfig, init_params_numpy, loss_fn, make_train_step, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.models.transformer import REMAT_SAVED

    cfg0 = ModelConfig(**TRAIN_CFG, dtype=torch.bfloat16, remat=True)
    model = params_from_jax(seeded_weights(cfg0), cfg0, device=dev)
    initial = {n: t.clone() for n, t in model.state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg0.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    kernels = _kernels()
    runs, checks = {}, {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        model.load_state_dict(initial)
        optimizer = AdamW(3e-4, weight_decay=0.01)
        opt_state = optimizer.init(model)
        step = make_train_step(cfg, optimizer)
        losses = [float(step(model, opt_state, tokens)) for _ in range(REMAT_WARM)]
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        timed, ms = timed_steps(step, model, opt_state, tokens, REMAT_TIMED)
        launches = {name: kern.launches for name, kern in kernels.items()}
        runs[policy] = {"ms_per_step": ms,
                        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": launches, "losses": losses + timed}
        per = cfg.n_layers * REMAT_TIMED
        checks[f"{policy}_launches_exact"] = launches == {
            "attn_fwd": (2 if policy == "block" else 1) * per, "attn_bwd_preprocess": per,
            "attn_bwd_dkv": per, "attn_bwd_dq": per}
        del optimizer, opt_state, step
        torch.cuda.empty_cache()
    del model, initial
    torch.cuda.empty_cache()

    cfg32 = ModelConfig(**{**TRAIN_CFG, "n_layers": TRAIN_FP32_LAYERS}, dtype=torch.float32)
    model32 = params_from_jax(init_params_numpy(cfg32, seed=0), cfg32, device=dev)
    toks = tokens[:TRAIN_FP32_BATCH]
    fp32 = {}
    for policy in REMAT_POLICIES:
        model32.zero_grad(set_to_none=True)
        loss = loss_fn(model32, toks, dataclasses.replace(cfg32, remat_policy=policy))
        loss.backward()
        fp32[policy] = (loss.detach(), {n: p.grad.clone() for n, p in model32.named_parameters()})
    ref_loss, ref_grads = fp32["block"]
    bitwise = {policy: bool(torch.equal(loss, ref_loss)) and all(
        torch.equal(g, ref_grads[n]) for n, g in grads.items())
        for policy, (loss, grads) in fp32.items()}
    checks.update({f"fp32_2layer_{p}_bitwise_equal_block": ok for p, ok in bitwise.items()})
    del model32, fp32, ref_grads
    torch.cuda.empty_cache()
    rec = {"phase": "remat", "card": card_line(), "config": TRAIN_CFG, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "timed_steps": REMAT_TIMED,
           "saved": {p: list(REMAT_SAVED.get(p, ())) for p in REMAT_POLICIES},
           "runs": runs, "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"remat checks failed: {failed}")
    return rec


# The bf16 projections' reduction (bf16_reduction): PyTorch lets cuBLAS
# reduce bf16 products in reduced precision unless
# torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is off;
# the JAX package accumulates in fp32 and rounds once.  The projections of
# the training-bench model and of Gemma-2-2B at their training tokens
# (M = 16,384): (name, K, N).
BF16_REDUCTION_SHAPES = {
    "bench_train": (16384, (("wq", 4096, 4096), ("wk", 4096, 1024), ("w_gate", 4096, 11008),
                            ("w_down", 11008, 4096))),
    "gemma2_2b": (16384, (("wq", 2304, 2048), ("wk", 2304, 1024), ("wo", 2048, 2304),
                          ("w_gate", 2304, 9216), ("w_down", 9216, 2304))),
}


def bf16_gap(got, ref, bound):
    """How far a bf16 product ``got`` lies from the fp32-accumulated one
    ``ref`` (fp32): the elements more than one bf16 unit (at |ref|) plus
    ``bound`` (the two fp32 accumulations' own rounding, K 2^-23 |A||B|) off,
    and the largest gap over that allowance."""
    import torch

    # one bf16 unit at |ref|: 2^(exponent - 8), at least the least normal one
    unit = torch.ldexp(torch.ones_like(ref), torch.frexp(ref.abs().clamp_min(2.0 ** -126))[1] - 8)
    err = (got.float() - ref).abs()
    return int((err > unit + bound).sum()), float((err / (unit + bound)).max())


def phase_bf16_reduction(dev):
    """Each projection's forward product X W and its two gradient products
    dY Wᵀ and Xᵀ dY (K up to 16,384 tokens) in bf16 through torch.matmul with
    the reduced-precision reduction allowed (PyTorch's default) and not:
    the elements where the two differ, and each against the same product
    accumulated in fp32 (operands upcast, TF32 off; :func:`bf16_gap`)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(6)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for model, (m, shapes) in BF16_REDUCTION_SHAPES.items():
            for name, k, n in shapes:
                x = _rand(gen, (m, k), torch.bfloat16, dev)
                w = (_rand(gen, (k, n), torch.bfloat16, dev).float() * k ** -0.5).bfloat16()
                dy = _rand(gen, (m, n), torch.bfloat16, dev)
                for prod, (a, b) in (("forward", (x, w)), ("grad_x", (dy, w.t())),
                                     ("grad_w", (x.t(), dy))):
                    ref = a.float() @ b.float()
                    bound = a.shape[1] * 2.0 ** -23 * (a.float().abs() @ b.float().abs())
                    got, rec = {}, {}
                    for allowed in (True, False):
                        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allowed
                        got[allowed] = a @ b
                        n_off, worst = bf16_gap(got[allowed], ref, bound)
                        rec["allowed" if allowed else "off"] = {
                            "elements_off": n_off, "max_gap_over_allowance": worst}
                    rec["elements_allowed_vs_off"] = int((got[True] != got[False]).sum())
                    out[f"{model}_{name}_{prod}"] = rec
                    del ref, bound, got
                del x, w, dy
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    torch.cuda.empty_cache()
    rec = {"phase": "bf16_reduction", "card": card_line(), "flag_default": flag,
           "products": out,
           "elements_off_allowed": sum(r["allowed"]["elements_off"] for r in out.values()),
           "elements_off_off": sum(r["off"]["elements_off"] for r in out.values()),
           "elements_allowed_vs_off": sum(r["elements_allowed_vs_off"] for r in out.values())}
    emit(rec)
    return rec


# The packed-sequence slice: the training-bench model's attention
# (scripts/bench_train.py:68-74: B=8, N=2048, 32 q / 8 kv heads, head_dim
# 128, bf16) through the op API and the nn adapter, forward and backward.
PACKED_B, PACKED_N, PACKED_HQ, PACKED_HKV, PACKED_D = 8, 2048, 32, 8, 128
PACKED_SHAPE = (PACKED_B, PACKED_HQ, PACKED_HKV, PACKED_N, PACKED_D)
# the head-dim-256 block of phase packed: Gemma-2-2B's attention (8 q / 4 kv
# heads of 256) at its training shape B2 x N8192 (B, Hq, Hkv, N, d); the
# cross-length SegmentIds' Nq; the padded batches' lengths
PACKED_D256_SHAPE = (2, 8, 4, 8192, 256)
PACKED_D256_CROSS_NQ = 4096
PACKED_D256_LENGTHS = [8192, 5000]
PACKED_D256_DROPOUT = dict(rate=0.1, seed=12345)
PACKED_CROSS_NQ = 1024
PACKED_LENGTHS = [2048, 1900, 1536, 1024, 777, 512, 2048, 300]
PACKED_WINDOW = (255, 0)
PACKED_FP32_B = 2
# fp8 V: the serving prefill shape (scripts/bench_serving.py:28-34) and the
# training shape, as (B, Hq, Hkv, N)
FP8_SHAPES = {"serve_prefill_2048": (1, 16, 8, 2048), "train_B8_H32_N2048": (8, 32, 8, 2048)}


def _all_attention_kernels():
    """Every build of the attention forward and backward kernels, by name."""
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel

    return {**_kernels(), "attn_fwd_seg": fwd_kernel.FWD_SEG_KERNEL,
            "attn_bwd_dkv_seg": bwd_kernel.DKV_SEG_KERNEL,
            "attn_bwd_dq_seg": bwd_kernel.DQ_SEG_KERNEL,
            "attn_fwd_d64": fwd_kernel.FWD_D64_KERNEL,
            "attn_fwd_d64_seg": fwd_kernel.FWD_D64_SEG_KERNEL,
            "attn_bwd_dkv_d64": bwd_kernel.DKV_D64_KERNEL,
            "attn_bwd_dq_d64": bwd_kernel.DQ_D64_KERNEL,
            "attn_bwd_dkv_d64_seg": bwd_kernel.DKV_D64_SEG_KERNEL,
            "attn_bwd_dq_d64_seg": bwd_kernel.DQ_D64_SEG_KERNEL,
            "attn_fwd_d256": fwd_kernel.FWD_D256_KERNEL,
            "attn_fwd_d256_seg": fwd_kernel.FWD_D256_SEG_KERNEL,
            "attn_bwd_dkv_d256": bwd_kernel.DKV_D256_KERNEL,
            "attn_bwd_dq_d256": bwd_kernel.DQ_D256_KERNEL,
            "attn_bwd_dkv_d256_seg": bwd_kernel.DKV_D256_SEG_KERNEL,
            "attn_bwd_dq_d256_seg": bwd_kernel.DQ_D256_SEG_KERNEL,
            "attn_fwd_wide": fwd_kernel.FWD_WIDE_KERNEL,
            "attn_bwd_dkv_wide": bwd_kernel.DKV_WIDE_KERNEL,
            "attn_bwd_dq_wide": bwd_kernel.DQ_WIDE_KERNEL,
            **_scores_kernels()}


def _scores_kernels():
    """Route wide_scores' passes (ops/wide_scores.py), by name."""
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    return {"attn_fwd_scores": ws.FWD_SCORES_KERNEL, "attn_fwd_product": ws.FWD_PRODUCT_KERNEL,
            "attn_bwd_scores": ws.BWD_SCORES_KERNEL,
            "attn_bwd_product_dkv": ws.DKV_PRODUCT_KERNEL,
            "attn_bwd_product_dq": ws.DQ_PRODUCT_KERNEL}


def counted(fn):
    """``fn()`` with every attention kernel's launch count, and the
    forward's and each backward sweep's per route ("attn_fwd@<route>",
    "attn_bwd_dkv@<route>", "attn_bwd_dq@<route>", over all builds), set
    to 0 just before and read just after (synchronized): (result,
    launches)."""
    import torch

    kernels = _all_attention_kernels()
    for kern in kernels.values():
        kern.launches = 0
    fwd_routes(zero=True)
    bwd_routes(zero=True)
    out = fn()
    torch.cuda.synchronize()
    return out, {**{name: kern.launches for name, kern in kernels.items()},
                 **{f"attn_fwd@{r}": n for r, n in fwd_routes().items()},
                 **{f"{sweep}@{r}": n for sweep, routes in bwd_routes().items()
                    for r, n in routes.items()}}


def launches_are(got, **want):
    """Whether the counts ``got`` are exactly ``want`` (1 where named with
    1, 0 for every kernel not named)."""
    return all(got[name] == want.get(name, 0) for name in got)


SEG_CALL = dict(attn_fwd_seg=1, attn_bwd_preprocess=1, attn_bwd_dkv_seg=1,
                attn_bwd_dq_seg=1)
# one call of the op and its backward at head dim 256, with and without
# segment ids
SEG_D256_CALL = dict(attn_fwd_d256_seg=1, attn_bwd_preprocess=1, attn_bwd_dkv_d256_seg=1,
                     attn_bwd_dq_d256_seg=1)
D256_CALL = dict(attn_fwd_d256=1, attn_bwd_preprocess=1, attn_bwd_dkv_d256=1,
                 attn_bwd_dq_d256=1)


def on_route(dtype, segments=False, fp8_v=False, d=PACKED_D, **want):
    """``want`` with the forward's one launch on the route the static rule
    (ops/fwd_kernel.py fwd_route) names for a call of these types, and,
    where ``want`` has a backward, each sweep's one launch on the route of
    ops/bwd_kernel.py bwd_route."""
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import bwd_route
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import fwd_route

    want = {**want, f"attn_fwd@{fwd_route(dtype, d, segments, fp8_v)}": 1}
    if want.get("attn_bwd_preprocess"):
        route = bwd_route(dtype, d, segments)
        want.update({f"attn_bwd_dkv@{route}": 1, f"attn_bwd_dq@{route}": 1})
    return want


def _packed_grads_check(q, k, v, do, kw, grads, o, lse):
    """The op's output and gradients (kernel path) against the plain
    versions on the same inputs: the forward kernel's (O, lse) against the
    plain forward, and its gradients against the plain backward of the
    kernel's O and lse (the bwd_check comparison)."""
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    fwd_rec, fwd_ok = fwd_errors((o, lse), attn_fwd_plain(q, k, v, **kw), q.dtype)
    bwd_rec, bwd_ok = bwd_errors(grads, attn_bwd_plain(q, k, v, o, lse, do, **kw), q.dtype)
    rec = {**fwd_rec, **bwd_rec, "tolerance": [fwd_rec["tolerance"], bwd_rec["tolerance"]]}
    return rec, fwd_ok and bwd_ok


def _op_packed(dev, gen, dtype, b, nq, seg, causal, shape=PACKED_SHAPE, mod=None):
    """One flash_attention call with ``seg`` (a SegmentIds, a [B, N]
    tensor, or None) and the ALiBi / dropout arguments of :func:`mods`
    ``mod``, and its .backward(), counted; then the kernels against their
    plain versions on the same inputs (heads, N and d from ``shape``)."""
    import torch
    from flash_attention_dlrs_tpu_torch import SegmentIds, flash_attention
    from flash_attention_dlrs_tpu_torch.ops.flash_attention import flash_attention_forward
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE

    _, hq, hkv, n, d = shape
    md = mods(hq, **(mod or {}))
    q = _rand(gen, (b, hq, nq, d), dtype, dev).requires_grad_(True)
    k = _rand(gen, (b, hkv, n, d), dtype, dev).requires_grad_(True)
    v = _rand(gen, (b, hkv, n, d), dtype, dev).requires_grad_(True)
    do = _rand(gen, (b, hq, nq, d), dtype, dev)

    def call():
        out = flash_attention(q, k, v, causal=causal, segment_ids=seg, **md)
        out.backward(do)
        return out

    o, launches = counted(call)
    grads = (q.grad, k.grad, v.grad)
    qs, ks = (seg.q, seg.kv) if isinstance(seg, SegmentIds) else (seg, seg)
    kw = dict(causal=causal, sm_scale=d ** -0.5, q_seg=qs, kv_seg=ks, **md)
    with torch.no_grad():
        o2, lse = flash_attention_forward(q, k, v, causal=causal, segment_ids=seg, **md)
        rec, ok = _packed_grads_check(q.detach(), k.detach(), v.detach(), do, kw, grads,
                                      o2, lse)
    rec["op_output_equals_forward"] = bool(torch.equal(o.detach(), o2))
    rec["empty_rows"] = int((lse == DEFAULT_MASK_VALUE).sum())
    rec["empty_rows_zero"] = bool((o2[lse == DEFAULT_MASK_VALUE] == 0).all())
    ok &= rec["op_output_equals_forward"] and rec["empty_rows_zero"]
    return rec, ok, launches


def _nn_packed(dev, gen, lengths, window=None, shape=PACKED_SHAPE):
    """nn.dot_product_attention on padded BTNH batches (per-batch lengths,
    is_causal, optionally a window) and its .backward(), counted; padded
    query rows must come out exactly 0; then the same call with the op's
    kernels swapped for their plain versions, output and gradients held
    against the kernel path's (batch, heads, length and d from ``shape``)."""
    import torch
    from flash_attention_dlrs_tpu_torch import nn as fnn
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    b, hq, hkv, t, d = shape
    q = _rand(gen, (b, t, hq, d), torch.bfloat16, dev)
    k = _rand(gen, (b, t, hkv, d), torch.bfloat16, dev)
    v = _rand(gen, (b, t, hkv, d), torch.bfloat16, dev)
    do = _rand(gen, (b, t, hq, d), torch.bfloat16, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

    def run():
        qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        out = fnn.dot_product_attention(qr, kr, vr, is_causal=True, query_seq_lengths=lens,
                                        key_value_seq_lengths=lens, local_window_size=window)
        out.backward(do)
        return out.detach(), (qr.grad, kr.grad, vr.grad)

    (o, grads), launches = counted(run)
    fa_ops = _attention_ops()
    kernels = fa_ops.attn_fwd, fa_ops.attn_bwd
    try:
        fa_ops.attn_fwd, fa_ops.attn_bwd = attn_fwd_plain, attn_bwd_plain
        o_p, grads_p = run()
    finally:
        fa_ops.attn_fwd, fa_ops.attn_bwd = kernels
    torch.cuda.synchronize()
    pad = torch.arange(t, device=dev)[None, :] >= lens[:, None]
    fwd_rec, fwd_ok = fwd_errors((o, torch.zeros(1, device=dev)),
                                 (o_p, torch.zeros(1, device=dev)), torch.bfloat16)
    bwd_rec, bwd_ok = bwd_errors(grads, grads_p, torch.bfloat16)
    rec = {"max_abs_err_o": fwd_rec["max_abs_err_o"], **bwd_rec,
           "padded_rows": int(pad.sum()), "padded_rows_exactly_zero": bool((o[pad] == 0).all()),
           "padded_rows_dq_zero": bool((grads[0][pad] == 0).all()),
           "finite": bool(torch.isfinite(o).all())}
    ok = fwd_ok and bwd_ok and rec["padded_rows_exactly_zero"] and rec["finite"]
    return rec, ok, launches, (q, k, v, lens, o)


def phase_packed(dev):
    """The packed-sequence slice at the training-bench model's attention
    shape (B8, N2048, 32 q / 8 kv heads, head_dim 128, bf16), through the
    entry points a user calls, each call's kernel launches counted exactly:

    1. the op API: flash_attention(causal=True, segment_ids=[B, N] ids of
       a packed loader (numpy seed 0: 1-8 documents a row, 64-2048 tokens))
       and .backward(); then SegmentIds(q, kv) with Nq 1024 against Nkv
       2048, non-causal, some q ids absent from kv;
    2. the nn adapter on padded batches (per-batch lengths), is_causal, then
       with local_window_size=(255, 0), each with .backward(); a call with a
       bias, which defers to the plain jax.nn semantics and launches
       nothing (its output, with a zero bias, held against the kernel
       path's); implementation="flash" with a bias, which raises;
    3. fp8 V (e4m3, e5m2) through the op API, forward only, at the serving
       prefill and training shapes and once with segments; .backward()
       through fp8 V raises;
    4. an fp32 copy of the packed call at B2, kernel against plain at the
       fp32 ladder (O 1e-4; dQ/dK/dV 9e-4 / 7e-4 / 7e-5).
    Every output is also held against the plain versions on the same inputs
    (the bf16 limits of fwd_check / bwd_check)."""
    import torch
    from flash_attention_dlrs_tpu_torch import SegmentIds, flash_attention
    from flash_attention_dlrs_tpu_torch import nn as fnn
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(0)
    b, n = PACKED_B, PACKED_N
    layout = loader_layout(rng, b, n)
    seg = torch.from_numpy(layout).to(dev)
    calls, checks = {}, {}

    def record(name, rec, ok, launches, want):
        rec = {**rec, "launches": launches}
        checks[f"{name}_kernel_vs_plain"] = ok
        checks[f"{name}_launches_exact"] = launches_are(launches, **want)
        calls[name] = rec
        emit({"phase": "packed", "call": name, **rec})

    rec, ok, launches = _op_packed(dev, gen, torch.bfloat16, b, n, seg, True)
    rec["documents_per_row"] = [int(r.max()) + 1 for r in layout]
    record("op_causal_packed", rec, ok, launches, on_route(torch.bfloat16, True, **SEG_CALL))

    cross_q = loader_layout(rng, b, PACKED_CROSS_NQ)
    cross_q[1::2, -64:] = 1000  # ids no key has: rows that see nothing
    cross = SegmentIds(q=torch.from_numpy(cross_q).to(dev),
                       kv=torch.from_numpy(loader_layout(rng, b, n)).to(dev))
    rec, ok, launches = _op_packed(dev, gen, torch.bfloat16, b, PACKED_CROSS_NQ, cross, False)
    record("op_cross_segment_ids", rec, ok, launches,
           on_route(torch.bfloat16, True, **SEG_CALL))
    checks["op_cross_segment_ids_has_empty_rows"] = rec["empty_rows"] > 0

    rec, ok, launches, (q, k, v, lens, o_kernel) = _nn_packed(dev, gen, PACKED_LENGTHS)
    record("nn_padded_causal", rec, ok, launches, on_route(torch.bfloat16, True, **SEG_CALL))
    rec, ok, launches, _ = _nn_packed(dev, gen, PACKED_LENGTHS, PACKED_WINDOW)
    record("nn_padded_causal_window", rec, ok, launches,
           on_route(torch.bfloat16, True, **SEG_CALL))

    bias = torch.zeros((1, 1, n, n), dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        o_def, launches = counted(lambda: fnn.dot_product_attention(
            q, k, v, bias, is_causal=True, query_seq_lengths=lens,
            key_value_seq_lengths=lens))
    def_rec, def_ok = fwd_errors((o_def, torch.zeros(1, device=dev)),
                                 (o_kernel, torch.zeros(1, device=dev)), torch.bfloat16)
    record("nn_bias_deferred", {"max_abs_err_o_vs_kernel_path": def_rec["max_abs_err_o"],
                                "tolerance": def_rec["tolerance"]}, def_ok, launches, {})
    del o_def, bias

    def flash_with_bias():
        try:
            fnn.dot_product_attention(q, k, v, torch.zeros((1, 1, n, n), dtype=torch.bfloat16,
                                                           device=dev), implementation="flash")
        except ValueError as err:
            return "fallback" in str(err)
        return False

    checks["nn_flash_with_bias_raises"], launches = counted(flash_with_bias)
    checks["nn_flash_with_bias_launches_nothing"] = launches_are(launches)
    del q, k, v, o_kernel
    torch.cuda.empty_cache()

    fp8 = {}
    for kind in FP8_V:
        v_dtype = getattr(torch, FP8_V[kind])
        for shape_name, (fb, fhq, fhkv, fn) in FP8_SHAPES.items():
            for with_seg in (False, True) if shape_name.startswith("train") else (False,):
                name = f"fp8v_{kind}_{shape_name}" + ("_packed" if with_seg else "")
                q = _rand(gen, (fb, fhq, fn, PACKED_D), torch.bfloat16, dev)
                k = _rand(gen, (fb, fhkv, fn, PACKED_D), torch.bfloat16, dev)
                v8 = _rand(gen, (fb, fhkv, fn, PACKED_D), torch.bfloat16, dev).to(v_dtype)
                sg = seg if with_seg else None
                with torch.no_grad():
                    o, launches = counted(lambda: flash_attention(q, k, v8, causal=True,
                                                                  segment_ids=sg))
                kw = dict(causal=True, sm_scale=PACKED_D ** -0.5,
                          **({"q_seg": seg, "kv_seg": seg} if with_seg else {}))
                want_o = attn_fwd_plain(q, k, v8, **kw)[0]
                o_rec, o_ok = fwd_errors((o, torch.zeros(1, device=dev)),
                                         (want_o, torch.zeros(1, device=dev)), torch.bfloat16)
                rec = {"shape": [fb, fhq, fhkv, fn, PACKED_D], "v": FP8_V[kind],
                       "segments": with_seg, "max_abs_err_o": o_rec["max_abs_err_o"],
                       "tolerance": o_rec["tolerance"]}
                record(name, rec, o_ok, launches,
                       on_route(torch.bfloat16, with_seg, True,
                                **{"attn_fwd_seg" if with_seg else "attn_fwd": 1}))
                fp8.setdefault(kind, 0)
                fp8[kind] += launches["attn_fwd_seg" if with_seg else "attn_fwd"]
                del q, k, v8, o, want_o
    q = _rand(gen, (1, 16, 256, PACKED_D), torch.bfloat16, dev).requires_grad_(True)
    k = _rand(gen, (1, 8, 256, PACKED_D), torch.bfloat16, dev)
    v8 = _rand(gen, (1, 8, 256, PACKED_D), torch.bfloat16, dev).to(torch.float8_e5m2)
    try:
        flash_attention(q, k, v8, causal=True).float().sum().backward()
        checks["fp8v_backward_raises"] = False
    except NotImplementedError as err:
        checks["fp8v_backward_raises"] = "fp8 V" in str(err)
    torch.cuda.empty_cache()

    rec, ok, launches = _op_packed(dev, gen, torch.float32, PACKED_FP32_B, n,
                                   seg[:PACKED_FP32_B].contiguous(), True)
    record("fp32_op_causal_packed_B2", rec, ok, launches,
           on_route(torch.float32, True, **SEG_CALL))
    torch.cuda.empty_cache()

    layout_d256 = _packed_d256(dev, gen, rng, record, checks)
    out = {"phase": "packed", "shape": [b, PACKED_HQ, PACKED_HKV, n, PACKED_D],
           "d256_shape": list(PACKED_D256_SHAPE), "dtype": "bfloat16", "layout_seed": 0,
           "lengths": PACKED_LENGTHS, "d256_lengths": PACKED_D256_LENGTHS,
           "window": list(PACKED_WINDOW), "fp8_launches": fp8, "checks": checks}
    emit(out)
    failed = [key for key, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"packed-sequence checks failed: {failed}")
    return {"calls": calls, "layout": layout, "fp8_launches": fp8,
            "layout_d256": layout_d256}


def _packed_d256(dev, gen, rng, record, checks):
    """The head-dim-256 block of phase packed, at PACKED_D256_SHAPE (bf16),
    each call counted exactly and held against the plain versions: the op
    API with a packed loader's segment ids (causal) and with SegmentIds(q,
    kv) of different lengths (non-causal, some q ids absent from kv);
    nn.dot_product_attention on padded batches; fp8 V (e4m3, e5m2), forward
    only; ALiBi, and ALiBi with dropout, forward and backward.  Returns the
    loader layout (for the timings)."""
    import torch
    from flash_attention_dlrs_tpu_torch import SegmentIds, flash_attention
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    bf16, shape = torch.bfloat16, PACKED_D256_SHAPE
    b, hq, hkv, n, d = shape
    layout = loader_layout(rng, b, n)
    seg = torch.from_numpy(layout).to(dev)
    rec, ok, launches = _op_packed(dev, gen, bf16, b, n, seg, True, shape)
    rec["documents_per_row"] = [int(r.max()) + 1 for r in layout]
    record("d256_op_causal_packed", rec, ok, launches,
           on_route(bf16, True, d=d, **SEG_D256_CALL))

    cross_q = loader_layout(rng, b, PACKED_D256_CROSS_NQ)
    cross_q[1::2, -64:] = 1000  # ids no key has: rows that see nothing
    cross = SegmentIds(q=torch.from_numpy(cross_q).to(dev),
                       kv=torch.from_numpy(loader_layout(rng, b, n)).to(dev))
    rec, ok, launches = _op_packed(dev, gen, bf16, b, PACKED_D256_CROSS_NQ, cross, False,
                                   shape)
    record("d256_op_cross_segment_ids", rec, ok, launches,
           on_route(bf16, True, d=d, **SEG_D256_CALL))
    checks["d256_op_cross_segment_ids_has_empty_rows"] = rec["empty_rows"] > 0

    rec, ok, launches, _ = _nn_packed(dev, gen, PACKED_D256_LENGTHS, shape=shape)
    record("d256_nn_padded_causal", rec, ok, launches,
           on_route(bf16, True, d=d, **SEG_D256_CALL))
    torch.cuda.empty_cache()

    for kind in FP8_V:
        q = _rand(gen, (b, hq, n, d), bf16, dev)
        k = _rand(gen, (b, hkv, n, d), bf16, dev)
        v8 = _rand(gen, (b, hkv, n, d), bf16, dev).to(getattr(torch, FP8_V[kind]))
        with torch.no_grad():
            o, launches = counted(lambda: flash_attention(q, k, v8, causal=True))
        want_o = attn_fwd_plain(q, k, v8, causal=True, sm_scale=d ** -0.5)[0]
        o_rec, o_ok = fwd_errors((o, torch.zeros(1, device=dev)),
                                 (want_o, torch.zeros(1, device=dev)), bf16)
        record(f"d256_fp8v_{kind}", {"shape": list(shape), "v": FP8_V[kind],
                                     "max_abs_err_o": o_rec["max_abs_err_o"],
                                     "tolerance": o_rec["tolerance"]},
               o_ok, launches, on_route(bf16, False, True, d=d, attn_fwd_d256=1))
        del q, k, v8, o, want_o

    for name, mod in (("d256_op_alibi", dict(alibi=True)),
                      ("d256_op_alibi_dropout", dict(alibi=True, **PACKED_D256_DROPOUT))):
        rec, ok, launches = _op_packed(dev, gen, bf16, b, n, None, True, shape, mod)
        record(name, rec, ok, launches, on_route(bf16, d=d, **D256_CALL))
    torch.cuda.empty_cache()
    return layout


def visible_pairs(q_ids, kv_ids, causal):
    """Visible (q row, key) pairs of one head summed over the batch for
    [B, Nq] / [B, Nkv] segment ids (numpy): per row, equal-id keys, and with
    ``causal`` only those at or before the row (bottom-right aligned)."""
    total = 0
    nq, nkv = q_ids.shape[1], kv_ids.shape[1]
    for qs, ks in zip(q_ids, kv_ids):
        if causal and nq == nkv and np.array_equal(qs, ks):
            _, counts = np.unique(qs, return_counts=True)
            total += int((counts * (counts + 1) // 2).sum())  # documents are runs
        else:
            same = qs[:, None] == ks[None, :]
            if causal:
                same &= np.arange(nkv)[None, :] <= np.arange(nq)[:, None] + nkv - nq
            total += int(same.sum())
    return total


def bwd_work(b, hq, hkv, nq, nkv, d, causal, itemsize, pairs=None, segments=None):
    """Operations and bytes each backward kernel needs, and the whole
    backward ("attn_bwd"), each input read once and each output written
    once.  With p visible (q, key) pairs: the dK/dV sweep computes S, dP,
    dV and dK (8·p·d flops per head), the dQ sweep S, dP and dQ (6·p·d);
    the backward as a whole needs the five products of the minimal
    backward, 2.5 x the forward's 4·p·d.  ``pairs`` (one head, the whole
    batch) counts p when the data or a window decide it; with ``segments``
    (default: whenever ``pairs`` is given) the int32 ids' reads count in
    each sweep."""
    if segments is None:
        segments = pairs is not None
    seg_bytes = 0 if pairs is None or not segments else 4 * b * (nq + nkv)
    if pairs is None:
        pairs = b * (nq * nkv / 2 if causal and nq == nkv else nq * nkv)
    q_bytes = itemsize * b * hq * nq * d  # one of q, O, dO, dQ
    kv_bytes = itemsize * b * hkv * nkv * d  # one of K, V, dK, dV
    stat_bytes = 4 * b * hq * nq  # one of lse, D
    return {
        "attn_bwd_preprocess": (2 * b * hq * nq * d, 2 * q_bytes + stat_bytes),
        "attn_bwd_dkv": (8 * hq * pairs * d,
                         2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes + seg_bytes),
        "attn_bwd_dq": (6 * hq * pairs * d,
                        3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes),
        "attn_bwd": (10 * hq * pairs * d,
                     4 * q_bytes + 4 * kv_bytes + stat_bytes + seg_bytes),
    }


def block_causal_mask(ids):
    """The boolean ``attn_mask`` [B, 1, N, N] of causal attention within
    equal segment ids, for scaled_dot_product_attention (True attends): the
    library yardstick of the segmented kernels."""
    import torch

    n = ids.shape[1]
    tril = torch.ones((n, n), dtype=torch.bool, device=ids.device).tril()
    return ((ids[:, :, None] == ids[:, None, :]) & tril)[:, None]


def window_pairs(n: int, window: int) -> int:
    """Visible (q row, key) pairs of one causal head of length n whose
    rows see at most ``window`` keys."""
    return sum(min(i + 1, window) for i in range(n))


def time_bwd(dev, gen, b, hq, hkv, n, d, mod=None, seg=None, window=0, softcap=0.0,
             causal=True, blocks=None):
    """The three backward kernels one by one and together at one bf16
    shape (causal unless ``causal`` is false) (with the ALiBi and dropout arguments of :func:`mods`
    ``mod``, the [B, N] segment ids ``seg`` (numpy), a ``window`` and a
    ``softcap`` when given), each with its bound (with segments or a window,
    of the visible pairs), its plain version's time and its error against
    the plain version on the same inputs; SDPA's backward
    (torch.autograd.grad through scaled_dot_product_attention, graph kept;
    with segments on the block-diagonal causal boolean mask, with a window
    on its boolean band) as the library time of the whole backward,
    torch.linalg.vecdot on the fp32 casts of O and dO as that of the
    preprocess.  Dropout and the softcap have no library time: SDPA's
    dropout draws other bits, and no PyTorch call softcaps the scores.
    ``blocks``: the kernels' tiles (a tuning.BlockSizes), when given."""
    import torch
    import torch.nn.functional as F
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    route = bk.bwd_route(torch.bfloat16, d, seg is not None, bool((mod or {}).get("alibi")),
                         bool((mod or {}).get("rate")))
    q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    do = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    ids = None if seg is None else torch.from_numpy(seg).to(dev)
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=softcap,
              **mods(hq, **(mod or {})),
              **({} if ids is None else dict(q_seg=ids, kv_seg=ids)), block_sizes=blocks)
    o, lse = attn_fwd(q, k, v, **kw)
    delta = bk.attn_bwd_preprocess(o, do)
    calls = {
        "attn_bwd_preprocess": (lambda: bk.attn_bwd_preprocess(o, do),
                                lambda: bk.attn_bwd_preprocess_plain(o, do)),
        "attn_bwd_dkv": (lambda: bk.attn_bwd_dkv(q, k, v, do, lse, delta, **kw),
                         lambda: bk.attn_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)),
        "attn_bwd_dq": (lambda: bk.attn_bwd_dq(q, k, v, do, lse, delta, **kw),
                        lambda: bk.attn_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        "attn_bwd": (lambda: bk.attn_bwd(q, k, v, o, lse, do, **kw),
                     lambda: bk.attn_bwd_plain(q, k, v, o, lse, do, **kw)),
    }
    lib_ms = {"attn_bwd_preprocess": median_ms(
        lambda: torch.linalg.vecdot(o.float(), do.float()))}
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = None
    if not kw["dropout_rate"] and not softcap:
        mask = (block_causal_mask(ids) if ids is not None
                else sdpa_bias(kw["alibi_slopes"], n, q.dtype, dev))
        if window:
            pos = torch.arange(n, device=dev)
            mask = (pos[None] <= pos[:, None]) & (pos[:, None] - pos[None] < window)
        out = F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask, is_causal=mask is None and causal, enable_gqa=True)
        lib_ms["attn_bwd"] = median_ms(lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True))
    pairs = (visible_pairs(seg, seg, True) if seg is not None
             else b * window_pairs(n, window) if window else None)
    work = bwd_work(b, hq, hkv, n, n, d, causal, 2, pairs=pairs, segments=seg is not None)
    rows = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, warmup=0, reps=1)  # warm: it ran for the error
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms.get(name),
                      **({} if name == "attn_bwd_preprocess" else {"route": route}),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "tflops": flops / ms / 1e9, "max_abs_err": err}
    rows["sum_of_three"] = sum(rows[name]["ms"] for name in calls if name != "attn_bwd")
    del qr, kr, vr, out
    torch.cuda.empty_cache()
    return rows


def sdpa_bias(slopes, n, dtype, dev):
    """The causal ALiBi bias −m_h·(i − j) (−inf above the diagonal) as a
    float ``attn_mask`` [1, H, n, n] for scaled_dot_product_attention, the
    library yardstick of the ALiBi kernels; None without slopes."""
    import torch

    if slopes is None:
        return None
    i = torch.arange(n, device=dev)
    dist = (i[:, None] - i[None, :]).float()
    m = torch.tensor(slopes, device=dev)[:, None, None]
    return torch.where(dist >= 0, -m * dist, float("-inf"))[None].to(dtype)


def time_fwd(gen, dev, b, hq, hkv, n, d, mod, seg=None, v8=None, window=0, softcap=0.0,
             causal=True, blocks=None):
    """The forward kernel at one bf16 shape (causal unless ``causal`` is
    false) with the ALiBi and
    dropout arguments of :func:`mods` ``mod``, the [B, N] segment ids
    ``seg`` (numpy) and V in the fp8 kind ``v8`` when given: its time, its
    plain version's, its bound (ALiBi and dropout add no bytes and their
    operations are not counted; segments count their layout's visible pairs
    and their ids' bytes; fp8 V one byte per element), its error against the
    plain version, and SDPA's time where no dropout is asked: with the ALiBi
    bias as a float mask, with segments on the block-diagonal causal
    boolean mask, with a causal ``window`` on its boolean band mask; none
    computes a ``softcap`` or takes fp8 V.  ``blocks``: the kernel's tiles
    (a tuning.BlockSizes), when given."""
    import torch
    import torch.nn.functional as F
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import (
        attn_fwd, attn_fwd_plain, fwd_route,
    )

    q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    if v8:
        v = v.to(getattr(torch, FP8_V[v8]))
    ids = None if seg is None else torch.from_numpy(seg).to(dev)
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=softcap,
              **mods(hq, **mod), **({} if ids is None else dict(q_seg=ids, kv_seg=ids)),
              block_sizes=blocks)
    err = float((attn_fwd(q, k, v, **kw)[0].float()
                 - attn_fwd_plain(q, k, v, **kw)[0].float()).abs().max())
    ms = median_ms(lambda: attn_fwd(q, k, v, **kw))
    route = fwd_route(q.dtype, d, ids is not None, bool(v8))
    plain_ms = median_ms(lambda: attn_fwd_plain(q, k, v, **kw), warmup=0, reps=1)
    lib_ms = None
    if softcap:
        pass  # no PyTorch call softcaps the scores
    elif window:
        pos = torch.arange(n, device=dev)
        band = (pos[None] <= pos[:, None]) & (pos[:, None] - pos[None] < window)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, enable_gqa=True))
    elif ids is not None:
        mask = block_causal_mask(ids)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
    elif v8:
        pass  # no single PyTorch call takes fp8 V (SDPA needs a cast of V first)
    elif not kw["dropout_rate"]:
        bias = sdpa_bias(kw["alibi_slopes"], n, q.dtype, dev)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, is_causal=bias is None and causal, enable_gqa=True))
    flops, nbytes = fwd_work(b, hq, hkv, n, n, d, causal, 2,
                             pairs=None if seg is None else visible_pairs(seg, seg, True),
                             v_itemsize=1 if v8 else 2, window=window)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    del q, k, v
    torch.cuda.empty_cache()
    return {"ms": ms, "route": route, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / ms / 1e9, "max_abs_err": err}


def gemma_train_launches(gemma_rec, kernel):
    """Launches of ``kernel`` ("attn_fwd_window", "attn_bwd_global", ...,
    or a kernel name of the launch counts) over train_gemma2's three
    runs."""
    runs = (gemma_rec, gemma_rec["save_flash"], gemma_rec["adamw8bit"])
    if kernel in gemma_rec["launches_by_window"]:
        return sum(r["launches_by_window"][kernel] for r in runs)
    return sum(r["launches"][kernel] for r in runs)


def phase_time(dev, train_rec, train_alibi_rec, packed_rec, gemma_train_rec):
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    timings = {}
    serve, train = (1, 16, 8, 2048, 128), (8, 32, 8, 2048, 128)
    alibi, both = dict(alibi=True), dict(alibi=True, rate=0.1, seed=1)
    for name, shape, mod in (
        ("fwd_serve_prefill_2048", serve, {}),
        ("fwd_train_B8_H32_N2048", train, {}),
        ("fwd_bench_B8_H16_N4096", (8, 16, 16, 4096, 128), {}),
        ("fwd_alibi_serve_prefill_2048", serve, alibi),
        ("fwd_alibi_train_B8_H32_N2048", train, alibi),
        ("fwd_alibi_dropout_serve_prefill_2048", serve, both),
        ("fwd_alibi_dropout_train_B8_H32_N2048", train, both),
    ):
        timings[name] = time_fwd(gen, dev, *shape, mod)
        emit({"phase": "time", "kernel": "attn_fwd", "case": name, "shape": list(shape),
              "dtype": "bfloat16", "causal": True, "alibi": bool(mod),
              "dropout_rate": mod.get("rate", 0.0),
              "library": ("none: SDPA's dropout draws other bits" if mod.get("rate") else
                          "torch.nn.functional.scaled_dot_product_attention"
                          + (" with the ALiBi bias as a float attn_mask" if mod else "")),
              **timings[name]})
    # the packed phase's layout (segments) and fp8 V
    layout = packed_rec["layout"]
    timings["fwd_seg_train_B8_H32_N2048"] = time_fwd(gen, dev, *train, {}, seg=layout)
    emit({"phase": "time", "kernel": "attn_fwd[seg]", "case": "fwd_seg_train_B8_H32_N2048",
          "shape": list(train), "dtype": "bfloat16", "causal": True, "segments": "packed",
          "visible_pairs_per_head": visible_pairs(layout, layout, True),
          "library": ("torch.nn.functional.scaled_dot_product_attention with the "
                      "block-diagonal causal boolean attn_mask"),
          **timings["fwd_seg_train_B8_H32_N2048"]})
    for kind in FP8_V:
        for shape_name, shape in (("serve_prefill_2048", serve),
                                  ("train_B8_H32_N2048", train)):
            name = f"fwd_fp8v_{kind}_{shape_name}"
            timings[name] = time_fwd(gen, dev, *shape, {}, v8=kind)
            emit({"phase": "time", "kernel": f"attn_fwd[fp8v-{kind}]", "case": name,
                  "shape": list(shape), "dtype": "bfloat16 q/k, " + FP8_V[kind] + " V",
                  "causal": True,
                  "library": FP8_LIBRARY, **timings[name]})

    # launches per train step; one attn_bwd call launches each of its three
    # kernels once
    per_step = {name: n // TRAIN_TIMED_STEPS
                for name, n in train_rec["launches"].items()}
    per_step["attn_bwd"] = per_step["attn_bwd_dq"]
    alibi_per_step = {name: n // TRAIN_TIMED_STEPS
                      for name, n in train_alibi_rec["launches"].items()}
    alibi_per_step["attn_bwd"] = alibi_per_step["attn_bwd_dq"]
    for name, shape, mod, seg in (
            ("bwd_train_B8_H32_N2048", train, None, None),
            ("bwd_bench_B8_H16_N4096", (8, 16, 16, 4096, 128), None, None),
            ("bwd_alibi_dropout_train_B8_H32_N2048", train, both, None),
            ("bwd_seg_train_B8_H32_N2048", train, None, layout)):
        rows = time_bwd(dev, gen, *shape, mod=mod, seg=seg)
        timings[name] = rows
        library = {
            "attn_bwd": ("backward of torch.nn.functional.scaled_dot_product_attention"
                         " (enable_gqa), torch.autograd.grad on a kept graph"
                         + ("" if seg is None else
                            ", on the block-diagonal causal boolean attn_mask")),
            "attn_bwd_preprocess": ("torch.linalg.vecdot(o.float(), do.float()), "
                                    "the casts included"),
        }
        if mod:
            library["attn_bwd"] = "none: SDPA's dropout draws other bits"
        launches = alibi_per_step if mod else per_step
        for kernel in ("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq", "attn_bwd"):
            emit({"phase": "time", "kernel": kernel + ("" if seg is None else "[seg]"),
                  "case": name, "shape": list(shape),
                  "dtype": "bfloat16", "causal": True, "alibi": bool(mod),
                  "dropout_rate": (mod or {}).get("rate", 0.0),
                  "segments": None if seg is None else "packed",
                  "launches_per_train_step": None if seg is not None else launches[kernel],
                  "library": library.get(kernel, "none: SDPA's backward computes all "
                                         "three kernels' outputs at once (see attn_bwd)"),
                  **rows[kernel]})
        emit({"phase": "time", "kernel": "attn_bwd (sum of the three launches)",
              "case": name, "ms": rows["sum_of_three"]})

    b, hq, hkv, d, ps, pps = 4, 16, 8, 128, 128, 17
    lengths = [n + SERVE_NEW_TOKENS for n in SERVE_PROMPTS[:4]]
    timings["decode_serve"] = time_paged(gen, dev, "bf16", b, lengths, 0)
    emit({"phase": "time", "kernel": "paged_decode", "case": "decode_serve",
          "shape": [b, hq, hkv, d, ps, pps], "lengths": lengths, "kv": "bf16",
          "library": PAGED_LIBRARY, **timings["decode_serve"]})
    # the serving bench's context (2048 tokens) at its two batches
    for kind in ("bf16",) + QUANT_KINDS:
        for batch in (8, 32):
            name = f"decode_{kind}_B{batch}_ctx2048"
            timings[name] = time_paged(gen, dev, kind, batch, [2048] * batch, 0)
            emit({"phase": "time", "kernel": "paged_decode", "case": name,
                  "shape": [batch, hq, hkv, d, ps, pps], "kv": kind,
                  "library": PAGED_LIBRARY, **timings[name]})
    for kind in ("bf16", "int8"):
        name = f"verify_{kind}_T256_ctx2048"
        timings[name] = time_paged(gen, dev, kind, 1, [2048], CHUNK)
        emit({"phase": "time", "kernel": "paged_verify", "case": name,
              "shape": [1, hq, hkv, d, ps, pps], "tokens": CHUNK, "kv": kind,
              "library": PAGED_LIBRARY, **timings[name]})
    # a speculative verify's shape: 4 tokens of 8 sequences of 2048
    name = "verify_bf16_T4_B8_ctx2048"
    timings[name] = time_paged(gen, dev, "bf16", 8, [2048] * 8, 4)
    emit({"phase": "time", "kernel": "paged_verify", "case": name,
          "shape": [8, hq, hkv, d, ps, pps], "tokens": 4, "kv": "bf16",
          "library": PAGED_LIBRARY, **timings[name]})
    # ALiBi: decode from bf16 and int8 KV (8 sequences of 2048), verify of a
    # 256-token chunk from bf16 KV
    for name, kind, batch, t_new in (("decode_bf16_B8_ctx2048_alibi", "bf16", 8, 0),
                                     ("decode_int8_B8_ctx2048_alibi", "int8", 8, 0),
                                     ("verify_bf16_T256_ctx2048_alibi", "bf16", 1, CHUNK)):
        timings[name] = time_paged(gen, dev, kind, batch, [2048] * batch, t_new, alibi=True)
        emit({"phase": "time", "kernel": "paged_verify" if t_new else "paged_decode",
              "case": name, "shape": [batch, hq, hkv, d, ps, pps], "tokens": t_new or 1,
              "kv": kind, "alibi": True, "library": PAGED_LIBRARY, **timings[name]})
    # head_dim 256 at Gemma-2-2B's heads (8 q / 4 kv): the prefill, the
    # windowed dense forward, decode and verify with its softcap
    gemma = (GEMMA2_2B["num_attention_heads"], GEMMA2_2B["num_key_value_heads"], 256)
    for name, n, window, cap in (("fwd_d256_prefill_2048", 2048, 0, 0.0),
                                 ("fwd_d256_prefill_2048_softcap", 2048, 0, GEMMA_SOFTCAP),
                                 ("fwd_d256_window4096_8192", GEMMA_DENSE_N, 4096, 0.0),
                                 ("fwd_d256_window4096_8192_softcap", GEMMA_DENSE_N, 4096,
                                  GEMMA_SOFTCAP)):
        timings[name] = time_fwd(gen, dev, 1, gemma[0], gemma[1], n, 256, {},
                                 window=window, softcap=cap)
        emit({"phase": "time", "kernel": "attn_fwd[d256]", "case": name,
              "shape": [1, gemma[0], gemma[1], n, 256], "dtype": "bfloat16", "causal": True,
              "window": window, "softcap": cap,
              "library": ("none: no PyTorch call softcaps the scores" if cap else
                          "torch.nn.functional.scaled_dot_product_attention"
                          + (" with the causal band as a boolean attn_mask" if window
                             else " (is_causal)")),
              **timings[name]})
    # the head-dim-256 backward at Gemma-2-2B's training shape (B2, 8 q / 4
    # kv heads, N8192): global causal and the 4096 window, each without and
    # with the softcap 50 (its layers' own config; no library call then)
    g_steps = gemma_train_rec["timed_steps"]
    for name, window, cap in (("bwd_d256_B2_H8_N8192", 0, 0.0),
                              ("bwd_d256_B2_H8_N8192_softcap", 0, GEMMA_SOFTCAP),
                              ("bwd_d256_window4096_B2_H8_N8192", 4096, 0.0),
                              ("bwd_d256_window4096_B2_H8_N8192_softcap", 4096, GEMMA_SOFTCAP)):
        shape = (GEMMA_TRAIN_BATCH, gemma[0], gemma[1], GEMMA_TRAIN_SEQ, 256)
        rows = time_bwd(dev, gen, *shape, window=window, softcap=cap)
        timings[name] = rows
        per_step = gemma_train_rec["launches_by_window"][
            "attn_bwd_window" if window else "attn_bwd_global"] // g_steps
        library = {
            "attn_bwd_preprocess": "torch.linalg.vecdot(o.float(), do.float()), the casts "
                                   "included",
            "attn_bwd": ("none: no PyTorch call softcaps the scores" if cap else
                         "backward of torch.nn.functional.scaled_dot_product_attention "
                         "(enable_gqa), torch.autograd.grad on a kept graph"
                         + (", on the causal band as a boolean attn_mask" if window else "")),
        }
        for kernel in ("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq", "attn_bwd"):
            emit({"phase": "time", "kernel": kernel + "[d256]", "case": name,
                  "shape": list(shape), "dtype": "bfloat16", "causal": True,
                  "window": window, "softcap": cap,
                  "launches_per_train_gemma2_step": per_step,
                  "library": library.get(kernel, "none: SDPA's backward computes all three "
                                         "kernels' outputs at once (see attn_bwd)"),
                  **rows[kernel]})
        emit({"phase": "time", "kernel": "attn_bwd[d256] (sum of the three launches)",
              "case": name, "ms": rows["sum_of_three"]})
    for kind in ("bf16", "int8"):
        for batch in (4, 8):
            name = f"decode_d256_{kind}_B{batch}_ctx2048"
            timings[name] = time_paged(gen, dev, kind, batch, [2048] * batch, 0,
                                       heads=gemma, softcap=GEMMA_SOFTCAP)
            emit({"phase": "time", "kernel": "paged_decode[d256]", "case": name,
                  "shape": [batch, *gemma, SERVE_PAGE, SERVE_PPS], "kv": kind,
                  "softcap": GEMMA_SOFTCAP, "library": PAGED_LIBRARY, **timings[name]})
    for kind in ("bf16", "int8"):
        name = f"verify_d256_{kind}_T256_ctx2048"
        timings[name] = time_paged(gen, dev, kind, 1, [2048], CHUNK, heads=gemma,
                                   softcap=GEMMA_SOFTCAP)
        emit({"phase": "time", "kernel": "paged_verify[d256]", "case": name,
              "shape": [1, *gemma, SERVE_PAGE, SERVE_PPS], "tokens": CHUNK, "kv": kind,
              "softcap": GEMMA_SOFTCAP, "library": PAGED_LIBRARY, **timings[name]})
    timings.update(time_d256_modes(dev, gen, packed_rec["layout_d256"]))
    return timings


def time_d256_modes(dev, gen, layout):
    """The head-dim-256 modes at Gemma-2-2B's heads (8 q / 4 kv): the
    forward with ALiBi, dropout, both and fp8 V at its 2048-token prefill,
    and with the packed phase's segment ids (``layout``) at its training
    shape B2 x N8192; the backward family at that training shape with
    ALiBi, dropout, both and the segment ids; decode (8 sequences of 2048
    from bf16 and int8 KV) and verify (a 256-token chunk from bf16 KV) with
    ALiBi and the softcap of serve_alibi_d256."""
    heads = (GEMMA2_2B["num_attention_heads"], GEMMA2_2B["num_key_value_heads"], 256)
    alibi, drop = dict(alibi=True), dict(rate=0.1, seed=1)
    both = dict(alibi, **drop)
    prefill, train = (1, heads[0], heads[1], 2048, 256), (
        GEMMA_TRAIN_BATCH, heads[0], heads[1], GEMMA_TRAIN_SEQ, 256)
    timings = {}
    for name, shape, mod, seg, v8, library in (
            ("fwd_d256_alibi_prefill_2048", prefill, alibi, None, None,
             "torch.nn.functional.scaled_dot_product_attention with the ALiBi bias as a "
             "float attn_mask"),
            ("fwd_d256_dropout_prefill_2048", prefill, drop, None, None, DROPOUT_LIBRARY),
            ("fwd_d256_alibi_dropout_prefill_2048", prefill, both, None, None,
             DROPOUT_LIBRARY),
            ("fwd_d256_fp8v_e4m3_prefill_2048", prefill, {}, None, "e4m3", FP8_LIBRARY),
            ("fwd_d256_fp8v_e5m2_prefill_2048", prefill, {}, None, "e5m2", FP8_LIBRARY),
            ("fwd_d256_seg_B2_N8192", train, {}, layout, None,
             "torch.nn.functional.scaled_dot_product_attention with the block-diagonal "
             "causal boolean attn_mask")):
        timings[name] = time_fwd(gen, dev, *shape, mod, seg=seg, v8=v8)
        emit({"phase": "time", "kernel": "attn_fwd[d256]", "case": name, "shape": list(shape),
              "dtype": "bfloat16" + (f" q/k, {FP8_V[v8]} V" if v8 else ""), "causal": True,
              "alibi": bool(mod.get("alibi")), "dropout_rate": mod.get("rate", 0.0),
              "segments": None if seg is None else "packed",
              **({} if seg is None else
                 {"visible_pairs_per_head": visible_pairs(layout, layout, True)}),
              "library": library, **timings[name]})
    for name, mod, seg in (("bwd_d256_alibi_B2_H8_N8192", alibi, None),
                           ("bwd_d256_dropout_B2_H8_N8192", drop, None),
                           ("bwd_d256_alibi_dropout_B2_H8_N8192", both, None),
                           ("bwd_d256_seg_B2_H8_N8192", None, layout)):
        rows = time_bwd(dev, gen, *train, mod=mod, seg=seg)
        timings[name] = rows
        whole = (DROPOUT_LIBRARY if (mod or {}).get("rate") else
                 "backward of torch.nn.functional.scaled_dot_product_attention (enable_gqa), "
                 "torch.autograd.grad on a kept graph, on the "
                 + ("ALiBi bias as a float attn_mask" if mod else
                    "block-diagonal causal boolean attn_mask"))
        library = {"attn_bwd_preprocess": ("torch.linalg.vecdot(o.float(), do.float()), "
                                           "the casts included"), "attn_bwd": whole}
        for kernel in ("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq", "attn_bwd"):
            emit({"phase": "time", "kernel": kernel + "[d256]", "case": name,
                  "shape": list(train), "dtype": "bfloat16", "causal": True,
                  "alibi": bool((mod or {}).get("alibi")),
                  "dropout_rate": (mod or {}).get("rate", 0.0),
                  "segments": None if seg is None else "packed",
                  "library": library.get(kernel, "none: SDPA's backward computes all three "
                                         "kernels' outputs at once (see attn_bwd)"),
                  **rows[kernel]})
        emit({"phase": "time", "kernel": "attn_bwd[d256] (sum of the three launches)",
              "case": name, "ms": rows["sum_of_three"]})
    for name, kind, batch, t_new in (("decode_d256_bf16_B8_ctx2048_alibi", "bf16", 8, 0),
                                     ("decode_d256_int8_B8_ctx2048_alibi", "int8", 8, 0),
                                     ("verify_d256_bf16_T256_ctx2048_alibi", "bf16", 1,
                                      CHUNK)):
        timings[name] = time_paged(gen, dev, kind, batch, [2048] * batch, t_new, alibi=True,
                                   heads=heads, softcap=ALIBI_D256["attn_softcap"])
        emit({"phase": "time", "kernel": ("paged_verify" if t_new else "paged_decode")
              + "[d256]", "case": name, "shape": [batch, *heads, SERVE_PAGE, SERVE_PPS],
              "tokens": t_new or 1, "kv": kind, "alibi": True,
              "softcap": ALIBI_D256["attn_softcap"], "library": PAGED_LIBRARY,
              **timings[name]})
    return timings


PAGED_LIBRARY = "none: no single PyTorch call attends through a page table"
FP8_LIBRARY = ("none: no single PyTorch call takes fp8 V (scaled_dot_product_attention "
               "needs V cast to bf16 first, a second call)")
DROPOUT_LIBRARY = ("none: scaled_dot_product_attention's dropout draws other bits, so it "
                   "is not the same function")


def paged_work(kind, b, hq, hkv, d, lengths, t_new):
    """Operations and bytes of one paged call: each live K/V row (and its
    two fp32 scales, when quantized) read once, q read and O written once,
    lengths and table read; the operations 4·d per visible (q row, key)
    pair, row t of T seeing length − (T−1−t) keys."""
    rows = max(t_new, 1)
    pairs = sum(hq * max(0, n - (rows - 1) + t) for n in lengths for t in range(rows))
    live = sum(lengths) * hkv
    nbytes = (2 * 2 * b * hq * rows * d + 2 * live * d * KV_BYTES[kind]
              + (8 * live if kind in QUANT_KINDS else 0) + 4 * b * (1 + SERVE_PPS))
    return 4 * pairs * d, nbytes


def time_paged(gen, dev, kind, b, lengths, t_new, alibi=False, heads=None, softcap=0.0):
    """One paged kernel (decode, or verify of ``t_new`` tokens) at the
    serving model's heads (or ``heads``: (Hq, Hkv, d)) from bf16 q and
    ``kind`` pools, with ALiBi when ``alibi`` and the logit ``softcap``: its
    time (``ms``: CUDA events around one wrapper call, warm,
    host time included; ``device_ms``: the call's kernels alone, each call
    after an L2 flush, :func:`device_ms`), its plain version's, its bound (the bias
    adds no bytes), its error against the plain version, its key splits,
    route and CTAs."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.ops.decode import (
        paged_decode_attention, paged_decode_plain, paged_verify_attention,
        paged_verify_plain,
    )

    hq, hkv, d = heads or (SERVE_CFG["n_q_heads"], SERVE_CFG["n_kv_heads"],
                           SERVE_CFG["head_dim"])
    q, kp, vp, lens, table = _paged_inputs(
        gen, dev, torch.bfloat16, kind, b, hq, hkv, d, SERVE_PAGE, SERVE_PPS,
        lengths, num_pages=b * SERVE_PPS + 8, t_new=t_new)
    args = (q, kp, vp, lens, table)
    kw = dict(sm_scale=d ** -0.5, alibi_slopes=mods(hq, alibi)["alibi_slopes"],
              logit_softcap=softcap)
    if t_new:
        kernel = lambda: paged_verify_attention(*args, **kw)  # noqa: E731
        plain = lambda: paged_verify_plain(*args, **kw)  # noqa: E731
    else:
        kernel = lambda: paged_decode_attention(*args, **kw)  # noqa: E731
        plain = lambda: paged_decode_plain(*args, **kw)  # noqa: E731
    dm.DECODE_SPLITS.clear()
    dm.VERIFY_SPLITS.clear()
    for r in dm.VERIFY_ROUTE_LAUNCHES:
        dm.VERIFY_ROUTE_LAUNCHES[r] = 0
    err = float((kernel().float() - plain().float()).abs().max())
    splits = next(iter(dm.VERIFY_SPLITS if t_new else dm.DECODE_SPLITS))
    route = (next(r for r, n in dm.VERIFY_ROUTE_LAUNCHES.items() if n) if t_new else "cuda")
    ms = median_ms(kernel)
    flops, nbytes = paged_work(kind, b, hq, hkv, d, lengths, t_new)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    dev_ms = device_ms(kernel, between=l2_flush(dev), floor_ms=bound_ms)
    plain_ms = median_ms(plain, warmup=0, reps=1)
    del q, kp, vp, args
    torch.cuda.empty_cache()
    per_dev = ({"device_ms_unread": "under its bound, or launches outlasting the spin"}
               if dev_ms is None else
               {"share_of_bound": bound_ms / dev_ms, "gb_per_s": nbytes / dev_ms / 1e6,
                "tflops": flops / dev_ms / 1e9})
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, **per_dev, "bytes": nbytes,
            "flops": flops, "max_abs_err": err, "splits": splits,
            "route": route, "ctas": paged_ctas(t_new, route, splits, b, hq, hkv, d)}


# Rolling sliding-window serving (serve_rolling): mistralai/Mistral-7B-v0.1's
# published config.json, cut to ROLLING_LAYERS of its 32 layers, random
# HF-named bf16 weights through import_hf_llama.  Page tables of
# ROLLING_PPS pages reach past the 4096-token window, so the engine serves
# on a rolling ring of 4096 / 128 = 32 pages a sequence.  Two prompts of
# 3968 tokens wrap the ring at their 129th generated token, one of 6000 is
# rolled into it at admission.  The same engine at full residency
# (RESIDENT_PPS pages = the window, prompts + new tokens <= 4096) is its
# step-time yardstick.
MISTRAL_7B = dict(  # mistralai/Mistral-7B-v0.1
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, max_position_embeddings=32768, tie_word_embeddings=False)
ROLLING_LAYERS, ROLLING_PPS, RESIDENT_PPS = 4, 64, 32
ROLLING_PROMPTS, ROLLING_NEW_TOKENS = (3968, 3968, 6000, 512), 256
RESIDENT_PROMPTS = (3840, 3840, 3840, 512)
# the 2-layer fp32 copies' requests: a prompt that wraps and one rolled in
ROLLING_FP32_PROMPTS, ROLLING_FP32_NEW_TOKENS = (3968, 6000), 160
# StreamingLLM serving (serve_streaming) on the serving-bench model: 128
# sink tokens (the smallest page-aligned count) and a 1920-token window, a
# resident set of 2048; prompts of 1800 tokens evict from their 249th
# generated token on, and a 3000-token prompt is longer than the set.
STREAM_SINKS, STREAM_WINDOW = 128, 1920
STREAM_PROMPT, STREAM_NEW_TOKENS, STREAM_LONG_PROMPT, STREAM_LONG_NEW = 1800, 512, 3000, 64
STREAM_FP32_NEW_TOKENS = 400


def teacher_forced_logits(model, cfg, prompt, generated):
    """The dense forward's fp32 logits at the positions that produced each
    token of ``generated`` (the last prompt token's, then each generated
    token's but the last), fed the prompt and ``generated``: [n, vocab]."""
    import torch
    from flash_attention_dlrs_tpu_torch.models.transformer import (
        forward_hidden, logits_from_hidden,
    )

    seq = list(prompt) + list(generated[:-1])
    with torch.inference_mode():
        x = forward_hidden(model, torch.tensor([seq], device=model.embed.device), cfg)
        return logits_from_hidden(x[0, len(prompt) - 1:], model, cfg.final_softcap)


def greedy_gaps(model, cfg, prompts, outs, upto=None):
    """Each request's greedy tokens (the first ``upto`` of each, all by
    default) against the teacher-forced dense forward: the positions where
    the dense argmax differs, each with the two tokens' logit gap over the
    logits' std (a near-tie when within BF16_LOGIT_LIMIT["rope"])."""
    found, compared = [], 0
    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        out = out[:upto] if upto else out
        logits = teacher_forced_logits(model, cfg, prompt, out)
        want = logits.argmax(-1).tolist()
        compared += len(out)
        for j, (w, g) in enumerate(zip(want, out)):
            if w != g:
                row = logits[j]
                found.append({"request": i, "index": j, "tokens": [w, g],
                              "gap_over_std": float((row[w] - row[g]).abs() / row.std())})
    return found, compared


def captured_decode_logits(engine):
    """Wrap the engine's decode step so that each step's logits [slots, V]
    are kept (a copy) in the returned list."""
    kept, step = [], engine._decode_step

    def run(*args):
        out = step(*args)
        kept.append(out[0].clone())
        return out
    engine._decode_step = run
    return kept


def fp32_decode_gap(engine, prompts, new_tokens, reference):
    """The engine's fp32 decode-step logits of every request against
    ``reference(prompt, generated)`` (fp32 logits at the same positions),
    over the reference's std: the worst gap per request and in all."""
    import torch

    kept = captured_decode_logits(engine)
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    gaps = []
    for slot, (prompt, out) in enumerate(zip(prompts, outs)):
        got = torch.stack([k[slot] for k in kept])  # steps feed out[0..n-2]
        want = reference(prompt, out)[1:]  # the prefill made out[0]
        gaps.append(float((got - want).abs().max() / want.std()))
    return gaps, outs


def mistral_model(dev, dtype, n_layers, seed=20):
    state = hf_state(MISTRAL_7B, "llama", dev, seed, n_layers, dtype)
    return import_model(MISTRAL_7B, "llama", state, dev, dtype, n_layers=n_layers)


def ring_engine(model, cfg, dev, pps, kv="bf16", slots=4, resident=None, **kw):
    """A DecodeEngine of ``slots`` slots and page tables of ``pps`` pages,
    its pool sized for ``resident`` pages a sequence (default ``pps``: a
    ring's resident set is smaller than its tables) and the null page."""
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    return DecodeEngine(model, cfg, num_pages=slots * (resident or pps) + 1,
                        page_size=SERVE_PAGE,
                        num_slots=slots, pages_per_seq=pps, kv_dtype=kv_kind(kv),
                        quantized_kv=kv in QUANT_KINDS, device=dev, **kw)


def ring_run(engine, prompts, new_tokens, cfg):
    """``_serve_run`` of the requests with the checks every ring run makes:
    each request's budget of tokens in the vocabulary, exact forward and
    decode launches (all forwards on the wgmma route), the last decode
    step's every layer against the plain paged decode, the pool wholly
    reclaimed."""
    r = _serve_run(engine, prompts, new_tokens, "paged_decode_attention")
    layers = check_layers(r["calls"], verify=False)
    n = cfg.n_layers
    checks = {
        "every_request_its_tokens": all(len(o) == new_tokens for o in r["outs"]),
        "tokens_in_vocab": all(0 <= x < cfg.vocab_size for o in r["outs"] for x in o),
        "fwd_launches_per_layer_and_prefill": r["launches"]["attn_fwd"] == n * len(prompts),
        "fwd_launches_all_wgmma": all_on(r["fwd_routes"], "wgmma", r["launches"]["attn_fwd"]),
        "decode_launches_per_layer_and_step": r["launches"]["paged_decode"] == n * r["steps"] > 0,
        "last_step_every_layer_kernel_vs_plain": layers["ok"] and layers["layers_checked"] == n,
        "pages_all_reclaimed": pages_back(engine),
    }
    summary = {"launches": r["launches"], "steps": r["steps"], "admit_ms": r["admit_ms"],
               "decode_ms_per_step_median": float(np.median(r["decode_ms"])),
               "wall_s": r["wall"], "tokens_per_s": sum(map(len, r["outs"])) / r["wall"],
               "last_step_layers": layers}
    return r, summary, checks


def phase_serve_rolling(dev):
    """Mistral-7B-v0.1 (MISTRAL_7B) at published widths, ROLLING_LAYERS
    layers, served past its 4096-token window on the rolling ring: bf16 KV
    and int8 KV at 4 slots (ROLLING_PROMPTS, 256 new tokens each), every
    greedy token against the teacher-forced dense windowed forward (bf16:
    near-ties only), the last step's layers against the plain paged
    decode, 32 pages a sequence all reclaimed; a 2-layer fp32 copy on the
    fp32 routes, its every decode step's logits within FP32_LOGIT_LIMIT x
    std of the dense windowed forward; the eager ring step against the same
    engine at full residency, and the 6000-token admission's ms."""
    import dataclasses

    import torch

    t_phase = time.perf_counter()
    model, cfg = mistral_model(dev, torch.bfloat16, ROLLING_LAYERS)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in ROLLING_PROMPTS]
    runs, checks, launches = {}, {}, {"attn_fwd": 0, "paged_decode_bf16": 0,
                                      "paged_decode_int8": 0}
    outs, engines = {}, {}
    for kv in ("bf16", "int8"):
        engine = ring_engine(model, cfg, dev, ROLLING_PPS, kv, resident=RESIDENT_PPS)
        engine.generate([[1] * n for n in sorted(set(ROLLING_PROMPTS))],
                        max_new_tokens=2)  # warm-up: each padded prefill length
        r, summary, run_checks = ring_run(engine, prompts, ROLLING_NEW_TOKENS, cfg)
        stats = engine.stats()
        run_checks["ring_of_window_pages"] = (
            engine.rolling and engine.pages_per_seq == cfg.window // SERVE_PAGE
            and stats["rolling_window"] == cfg.window == MISTRAL_7B["sliding_window"])
        outs[kv] = r["outs"]
        longest = max(ROLLING_PROMPTS)  # admitted in prompt order
        summary[f"prefill_{longest}_admit_ms"] = r["admit_ms"][ROLLING_PROMPTS.index(longest)]
        launches["attn_fwd"] += r["launches"]["attn_fwd"]
        launches[f"paged_decode_{kv}"] += r["launches"]["paged_decode"]
        runs[kv] = summary
        checks.update({f"{kv}_{k}": v for k, v in run_checks.items()})
        engines[kv] = engine
    del engines["int8"], engine
    torch.cuda.empty_cache()
    divs, compared = greedy_gaps(model, cfg, prompts, outs["bf16"])
    checks["bf16_tokens_vs_dense_windowed_near_ties_only"] = near_ties_only(divs)
    int8_divs, _ = greedy_gaps(model, cfg, prompts, outs["int8"])

    engine = ring_engine(model, cfg, dev, RESIDENT_PPS)
    engine.generate([[1] * max(RESIDENT_PROMPTS)], max_new_tokens=2)  # warm-up
    resident_prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in RESIDENT_PROMPTS]
    checks["full_residency_is_no_ring"] = not engine.rolling
    # eager step times in turns: ring (above), resident, resident, ring
    step_ms = {"ring": [runs["bf16"]["decode_ms_per_step_median"]], "resident": []}
    for turn, (eng, reqs) in enumerate(((engine, resident_prompts), (engine, resident_prompts),
                                        (engines["bf16"], prompts))):
        r, summary, run_checks = ring_run(eng, reqs, ROLLING_NEW_TOKENS, cfg)
        resident = summary if turn == 0 else resident
        step_ms["ring" if eng.rolling else "resident"].append(
            summary["decode_ms_per_step_median"])
        checks.update({f"turn{turn + 2}_{k}": v for k, v in run_checks.items()})
        launches["attn_fwd"] += r["launches"]["attn_fwd"]
        launches["paged_decode_bf16"] += r["launches"]["paged_decode"]
    del engine, engines, model
    torch.cuda.empty_cache()

    model32, cfg32 = mistral_model(dev, torch.float32, FP32_LAYERS)
    engine = ring_engine(model32, cfg32, dev, ROLLING_PPS, "fp32", slots=2,
                         resident=RESIDENT_PPS)
    fp32_prompts = [prompts[ROLLING_PROMPTS.index(n)] for n in ROLLING_FP32_PROMPTS]
    gaps, _ = fp32_decode_gap(engine, fp32_prompts, ROLLING_FP32_NEW_TOKENS,
                              lambda p, o: teacher_forced_logits(model32, cfg32, p, o))
    checks["fp32_2layer_every_step_logits_vs_dense_windowed"] = max(gaps) <= FP32_LOGIT_LIMIT
    del engine, model32
    torch.cuda.empty_cache()
    rec = {
        "phase": "serve_rolling", "config_source": "mistralai/Mistral-7B-v0.1 config.json",
        "config": {k: getattr(cfg, k) for k in ("d_model", "n_q_heads", "n_kv_heads",
                                                 "head_dim", "d_ff", "vocab_size", "window")},
        "layers": ROLLING_LAYERS, "page_size": SERVE_PAGE, "pages_per_seq_asked": ROLLING_PPS,
        "prompt_lengths": list(ROLLING_PROMPTS), "new_tokens": ROLLING_NEW_TOKENS,
        "runs": runs, "full_residency": {"prompt_lengths": list(RESIDENT_PROMPTS),
                                         **resident},
        "step_ms_in_turns": step_ms,
        "ring_over_resident_step_ms": (float(np.median(step_ms["ring"]))
                                       / float(np.median(step_ms["resident"]))),
        "bf16_tokens_compared": compared, "bf16_divergences": divs,
        "int8_divergences_from_dense": len(int8_divs),
        "fp32_2layer_step_logit_gap_over_std": gaps,
        "launches": launches, "seconds": time.perf_counter() - t_phase, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"rolling serving checks failed: {failed}")
    return rec


def streaming_attention(sinks, window):
    """A plain attention with flash_attention's signature in which query i
    sees exactly the keys [0, sinks) and (i − window, i] (the StreamingLLM
    resident set of a sequence at length i + 1), in the inputs' dtype."""
    import torch
    import torch.nn.functional as F

    def attend(q, k, v, *, causal=True, sm_scale=None, **_):
        n = q.shape[-2]
        i = torch.arange(n, device=q.device)
        keep = (i[None] <= i[:, None]) & ((i[None] < sinks) | (i[:, None] - i[None] < window))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=keep, scale=sm_scale,
                                              enable_gqa=True)
    return attend


def streaming_reference(model, cfg, sinks, window):
    """``reference(prompt, generated)`` of :func:`fp32_decode_gap`: the
    teacher-forced dense forward through :func:`streaming_attention`."""
    from flash_attention_dlrs_tpu_torch.models import transformer

    def reference(prompt, generated):
        kernel = transformer.flash_attention
        transformer.flash_attention = streaming_attention(sinks, window)
        try:
            return teacher_forced_logits(model, cfg, prompt, generated)
        finally:
            transformer.flash_attention = kernel
    return reference


def serving_bench_model(dev, dtype=None, n_layers=None):
    import torch
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, params_from_jax

    cfg = ModelConfig(**{**SERVE_CFG, **({"n_layers": n_layers} if n_layers else {})},
                      dtype=dtype or torch.bfloat16)
    return params_from_jax(seeded_weights(cfg), cfg, device=dev), cfg


def phase_serve_streaming(dev):
    """The serving-bench model (SERVE_CFG, nothing cut) on a StreamingLLM
    ring: STREAM_SINKS sinks and a STREAM_WINDOW window (16 pages a
    sequence), 4 slots of STREAM_PROMPT-token prompts with STREAM_NEW_TOKENS
    new tokens, then one STREAM_LONG_PROMPT-token prompt, longer than the
    resident set.  Tokens before eviction against the dense greedy forward
    (near-ties only); a 2-layer fp32 copy's every decode step, before and
    after eviction, within FP32_LOGIT_LIMIT x std of a dense fp32 forward in
    which each query sees exactly its resident keys (and, as a control, far
    from the unevicted dense forward after eviction); the last step's
    layers against the plain paged decode.  Returns the record and the
    model (the native phase serves it too)."""
    import torch

    t_phase = time.perf_counter()
    model, cfg = serving_bench_model(dev)
    ring = dict(attention_sinks=STREAM_SINKS, streaming_window=STREAM_WINDOW)
    resident = STREAM_SINKS + STREAM_WINDOW
    engine = ring_engine(model, cfg, dev, SERVE_PPS, resident=resident // SERVE_PAGE, **ring)
    engine.generate([[1] * n for n in (STREAM_PROMPT, STREAM_LONG_PROMPT)], max_new_tokens=2)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, STREAM_PROMPT).tolist() for _ in range(4)]
    long_prompt = rng.integers(0, cfg.vocab_size, STREAM_LONG_PROMPT).tolist()
    r, summary, checks = ring_run(engine, prompts, STREAM_NEW_TOKENS, cfg)
    r_long, summary_long, checks_long = ring_run(engine, [long_prompt], STREAM_LONG_NEW, cfg)
    checks.update({f"long_prompt_{k}": v for k, v in checks_long.items()})
    stats = engine.stats()
    checks["ring_of_resident_pages"] = (
        engine.streaming and engine.pages_per_seq == resident // SERVE_PAGE
        and (stats["attention_sinks"], stats["streaming_window"]) == (STREAM_SINKS,
                                                                       STREAM_WINDOW))
    exact = resident - STREAM_PROMPT + 1  # tokens made with the whole context resident
    divs, compared = greedy_gaps(model, cfg, prompts, r["outs"], upto=exact)
    checks["tokens_before_eviction_vs_dense_near_ties_only"] = near_ties_only(divs)
    launches = {"attn_fwd": r["launches"]["attn_fwd"] + r_long["launches"]["attn_fwd"],
                "paged_decode": (r["launches"]["paged_decode"]
                                 + r_long["launches"]["paged_decode"])}
    del engine

    model32, cfg32 = serving_bench_model(dev, torch.float32, FP32_LAYERS)
    engine = ring_engine(model32, cfg32, dev, SERVE_PPS, "fp32", slots=1,
                         resident=resident // SERVE_PAGE, **ring)
    gaps, outs32 = fp32_decode_gap(engine, prompts[:1], STREAM_FP32_NEW_TOKENS,
                                   streaming_reference(model32, cfg32, STREAM_SINKS,
                                                       STREAM_WINDOW))
    # control: the unevicted dense forward parts from the ring after eviction
    full = teacher_forced_logits(model32, cfg32, prompts[0], outs32[0])
    ring_ref = streaming_reference(model32, cfg32, STREAM_SINKS, STREAM_WINDOW)(
        prompts[0], outs32[0])
    after = slice(exact, None)  # rows made with keys evicted
    evicted_gap = float((full[after] - ring_ref[after]).abs().max() / ring_ref.std())
    checks["fp32_2layer_every_step_logits_vs_dense_resident_keys"] = max(gaps) <= FP32_LOGIT_LIMIT
    checks["fp32_eviction_changes_logits_vs_full_attention"] = evicted_gap > 10 * FP32_LOGIT_LIMIT
    del engine, model32
    torch.cuda.empty_cache()
    rec = {
        "phase": "serve_streaming", "config": SERVE_CFG, "dtype": "bfloat16",
        "attention_sinks": STREAM_SINKS, "streaming_window": STREAM_WINDOW,
        "page_size": SERVE_PAGE, "pages_per_seq": resident // SERVE_PAGE,
        "prompt_tokens": STREAM_PROMPT,
        "new_tokens": STREAM_NEW_TOKENS, "eviction_from_token": exact + 1,
        "run": summary, "long_prompt": {"prompt_tokens": STREAM_LONG_PROMPT,
                                        "new_tokens": STREAM_LONG_NEW, **summary_long},
        "tokens_compared_before_eviction": compared, "divergences": divs,
        "fp32_2layer_step_logit_gap_over_std": gaps,
        "fp32_full_attention_gap_after_eviction_over_std": evicted_gap,
        "launches": launches, "seconds": time.perf_counter() - t_phase, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"streaming serving checks failed: {failed}")
    return rec, model, cfg


# The native phase's replays of a serving run's bookkeeping: (name, wrap,
# sinks, pages_per_seq, prompt lengths, new tokens) at page 128, 4 slots.
BOOKKEEPING_RUNS = (("plain", 0, 0, SERVE_PPS, SERVE_PROMPTS, SERVE_NEW_TOKENS),
                    ("streaming", STREAM_WINDOW, STREAM_SINKS, 16, (1800,) * 4 + (3000,), 300),
                    ("rolling", 4096, 0, 32, ROLLING_PROMPTS, ROLLING_NEW_TOKENS))


def replay_bookkeeping(alloc, wrap, sinks, pps, lengths, new_tokens, slots=4):
    """The page bookkeeping of a serving run on ``alloc``, as DecodeEngine
    makes it: the null sequence, FIFO admission into ``slots`` slots (one
    resident set on a ring), one decode_step_bookkeeping call a step for the
    active sequences, retirement at the budget.  Returns every call's
    outputs (copies) and the seconds spent in the calls."""
    alloc.allocate("null", 1)
    queue = list(enumerate(lengths))
    active, outs, spent = {}, [], 0.0
    while queue or active:
        while queue and len(active) < slots:
            i, t = queue.pop(0)
            sid = f"req{i}"
            alloc.allocate(sid, sinks + wrap if wrap else t + new_tokens)
            alloc.seq_lengths[sid] = t
            active[sid] = new_tokens - 1
        sids = list(active)
        t0 = time.perf_counter()
        got = alloc.decode_step_bookkeeping(sids, pps, wrap, sinks)
        spent += time.perf_counter() - t0
        outs.append(tuple(np.array(a) for a in got))
        for sid in sids:
            active[sid] -= 1
            if not active[sid]:
                del active[sid]
                alloc.free(sid)
    return outs, spent


def phase_native(dev, model, cfg):
    """The native runtime library (runtime/_native.py): built afresh into a
    private directory, timed; NativePageAllocator's decode_step_bookkeeping
    equal to the Python allocator's over BOOKKEEPING_RUNS (plain, streaming
    and rolling rings), µs per call of each; then phase serve's requests
    (SERVE_PROMPTS, 4 slots, 32 new tokens) through DecodeEngine with
    native_allocator=False and True: equal tokens, exact launches, µs per
    bookkeeping call in the engine."""
    import pathlib
    import shutil
    import tempfile

    import torch
    from flash_attention_dlrs_tpu_torch.runtime import _native
    from flash_attention_dlrs_tpu_torch.runtime.kv_cache import PageAllocator
    from flash_attention_dlrs_tpu_torch.runtime.native_alloc import NativePageAllocator

    t_phase = time.perf_counter()
    built = _native.library_path()
    scratch = pathlib.Path(tempfile.mkdtemp(dir=_native.BUILD_DIR))
    keep = _native.NATIVE_BUILD_DIR
    try:
        _native.NATIVE_BUILD_DIR = scratch
        t = time.perf_counter()
        fresh = _native.build()
        build_s = time.perf_counter() - t
    finally:
        _native.NATIVE_BUILD_DIR = keep
        shutil.rmtree(scratch, ignore_errors=True)
    checks = {"library_built_beside_the_package": fresh.name == built.name
              and pathlib.Path(_native.load_lib()._name) == _native.library_path()}
    replays = {}
    for name, wrap, sinks, pps, lengths, new in BOOKKEEPING_RUNS:
        py, py_s = replay_bookkeeping(PageAllocator(129, SERVE_PAGE), wrap, sinks, pps,
                                      lengths, new)
        cc, cc_s = replay_bookkeeping(NativePageAllocator(129, SERVE_PAGE), wrap, sinks, pps,
                                      lengths, new)
        same = len(py) == len(cc) and all(
            all(np.array_equal(a, b) for a, b in zip(x, y)) for x, y in zip(py, cc))
        checks[f"bookkeeping_{name}_native_equals_python"] = same
        replays[name] = {"calls": len(py), "python_us_per_call": py_s / len(py) * 1e6,
                         "native_us_per_call": cc_s / len(cc) * 1e6}
    runs, launches = {}, {"attn_fwd": 0, "paged_decode": 0}
    prompts = serve_prompts(cfg)
    for native in (False, True):
        engine = ring_engine(model, cfg, dev, SERVE_PPS, native_allocator=native)
        engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
        spent, calls = [], engine.allocator.decode_step_bookkeeping

        def timed(*args, calls=calls, spent=spent):
            t = time.perf_counter()
            out = calls(*args)
            spent.append(time.perf_counter() - t)
            return out
        engine.allocator.decode_step_bookkeeping = timed
        r, summary, run_checks = ring_run(engine, prompts, SERVE_NEW_TOKENS, cfg)
        name = "native" if native else "python"
        checks.update({f"{name}_{k}": v for k, v in run_checks.items()})
        checks[f"{name}_allocator_in_stats"] = engine.stats()["allocator"] == name
        runs[name] = {"outs": r["outs"], "bookkeeping_calls": len(spent),
                      "bookkeeping_us_per_call": float(np.mean(spent[1:]) * 1e6),
                      "decode_ms_per_step_median": summary["decode_ms_per_step_median"]}
        for key in launches:
            launches[key] += r["launches"][key]
        del engine
        torch.cuda.empty_cache()
    checks["engine_tokens_native_equal_python"] = runs["native"].pop("outs") == runs[
        "python"].pop("outs")
    rec = {"phase": "native", "library": str(built.relative_to(_native.BUILD_DIR.parent.parent)),
           "build_s": build_s, "replays": replays, "engine": runs, "launches": launches,
           "seconds": time.perf_counter() - t_phase, "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"native checks failed: {failed}")
    return rec


# The perplexity gate (eval_gate): scripts/train_lm.py's default model
# (GATE_CFG: ~51M parameters, byte-level vocab 512, block remat, bf16)
# trained by fit on a corpus that scripts/make_corpus.py builds from the
# interpreter's own site-packages (GATE_CORPUS_MB), fed by native_batches;
# B16 x 2048, lr 6e-4, warmup 200 (train_lm.py's), AdamW8bit, clip 1.0,
# cut from 3000 steps to GATE_STEPS; then perplexity over GATE_EVAL rows of
# 2048 tokens of val.bin, dense and paged from every KV kind.
GATE_CFG = dict(vocab_size=512, d_model=768, n_layers=8, n_q_heads=12, n_kv_heads=4,
                head_dim=64, d_ff=2048)
GATE_BATCH, GATE_SEQ, GATE_STEPS, GATE_WARMUP, GATE_LR = 16, 2048, 40, 200, 6e-4
GATE_CORPUS_MB, GATE_EVAL, GATE_PPL, GATE_PAGED_RTOL = 32, 2, 0.1, 1e-2
GATE_KINDS = ("bf16", "int8", "int4", "e4m3", "e5m2")


def _d64_kernels():
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops.decode import DECODE_D64_KERNEL
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import FWD_D64_KERNEL

    return {"attn_fwd": FWD_D64_KERNEL, "attn_bwd_preprocess": bwd_kernel.PREPROCESS_KERNEL,
            "attn_bwd_dkv": bwd_kernel.DKV_D64_KERNEL, "attn_bwd_dq": bwd_kernel.DQ_D64_KERNEL,
            "paged_decode": DECODE_D64_KERNEL}


def _zero_d64():
    for kern in _d64_kernels().values():
        kern.launches = 0
    fwd_routes(zero=True)
    bwd_routes(zero=True)


def _d64_launches():
    return ({name: kern.launches for name, kern in _d64_kernels().items()},
            fwd_routes(), bwd_routes())


def train_launches_exact(launches, routes, sweeps, n_layers, steps, fwd_per_layer=2):
    """Block remat: two forwards a layer and step, one of each backward
    kernel; every forward and sweep on the wgmma route."""
    want = {"attn_fwd": fwd_per_layer * n_layers * steps,
            **dict.fromkeys(("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq"),
                            n_layers * steps), "paged_decode": 0}
    return (launches == want and all_on(routes, "wgmma", want["attn_fwd"])
            and all(all_on(sweeps[s], "wgmma", want[s]) for s in sweeps))


def phase_eval_gate(dev):
    """The perplexity gate on a model the port trains itself: the corpus
    (scripts/make_corpus.py in a subprocess, --roots the interpreter's
    purelib), GATE_STEPS steps of fit over native_batches of train.bin
    (exact launches), then perplexity_dense and perplexity_paged from
    every KV kind of GATE_KINDS over val.bin, each paged run's decode
    launches exact and its last step's layers against the plain paged
    decode.  Gates: int8 within GATE_PPL ppl of bf16, paged bf16 within
    GATE_PAGED_RTOL of dense, dense well below the byte-random 256."""
    import pathlib
    import sysconfig

    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, TrainSpec, fit, make_optimizer, make_train_step,
    )
    from flash_attention_dlrs_tpu_torch.models.eval import perplexity_dense, perplexity_paged
    from flash_attention_dlrs_tpu_torch.runtime import native_batches
    from flash_attention_dlrs_tpu_torch.runtime._native import BUILD_DIR

    t_phase = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    corpus = BUILD_DIR / "corpus"
    t = time.perf_counter()
    made = subprocess.run(
        [sys.executable, str(repo / "scripts" / "make_corpus.py"), "--roots",
         sysconfig.get_paths()["purelib"], "--out", str(corpus), "--max-mb",
         str(GATE_CORPUS_MB)], capture_output=True, text=True, timeout=300)
    if made.returncode:
        raise RuntimeError(f"make_corpus.py failed:\n{made.stderr[-2000:]}")
    corpus_s = time.perf_counter() - t

    cfg = ModelConfig(**GATE_CFG, dtype=torch.bfloat16, remat=True)
    spec = TrainSpec(learning_rate=GATE_LR, warmup_steps=min(GATE_WARMUP, GATE_STEPS // 10),
                     total_steps=GATE_STEPS, weight_decay=0.01, grad_clip_norm=1.0,
                     optimizer="adamw8bit")
    losses = []
    train_bin = str(corpus / "train.bin")
    _zero_d64()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = fit(cfg, lambda cursor: native_batches(
        train_bin, seq_len=GATE_SEQ, batch_size=GATE_BATCH, seed=0, state=cursor),
        spec=spec, steps=GATE_STEPS, device=dev, seed=0,
        on_step=lambda i, loss: losses.append(loss.detach()))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_counts, routes, sweeps = _d64_launches()
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    losses = [float(x) for x in losses]
    checks = {"train_launches_exact": train_launches_exact(train_counts, routes, sweeps,
                                                           cfg.n_layers, GATE_STEPS),
              "loss_finite_and_falls": all(np.isfinite(losses)) and losses[-1] < losses[0]}

    val = np.fromfile(corpus / "val.bin", dtype=np.uint16)
    tokens = torch.from_numpy(val[: GATE_EVAL * GATE_SEQ].astype(np.int64)).reshape(
        GATE_EVAL, GATE_SEQ).to(dev)
    _zero_d64()
    ppl = {"dense": perplexity_dense(model, cfg, tokens)}
    eval_counts = {"dense": _d64_launches()[0]}
    layers = {}
    for kind in GATE_KINDS:
        _zero_d64()
        with _Recorder("paged_decode_attention") as rec:
            t = time.perf_counter()
            ppl[kind] = perplexity_paged(model, cfg, tokens, kv_dtype=kv_kind(kind),
                                         quantized=kind in QUANT_KINDS, device=dev)
            seconds = time.perf_counter() - t
        eval_counts[kind] = _d64_launches()[0]
        layers[kind] = {**check_layers(rec.calls[-cfg.n_layers:], verify=False),
                        "seconds": seconds}
        rec.calls.clear()
        steps = GATE_SEQ - 2
        checks[f"{kind}_decode_launches_per_layer_and_step"] = (
            eval_counts[kind]["paged_decode"] == cfg.n_layers * steps
            and eval_counts[kind]["attn_fwd"] == cfg.n_layers)
        checks[f"{kind}_last_step_every_layer_kernel_vs_plain"] = layers[kind]["ok"]
    gaps = {kind: abs(ppl[kind] - ppl["bf16"]) for kind in GATE_KINDS if kind != "bf16"}
    paged_rel = abs(ppl["bf16"] - ppl["dense"]) / ppl["dense"]
    checks.update({
        "dense_launches_one_forward_a_layer": eval_counts["dense"]["attn_fwd"] == cfg.n_layers,
        "dense_ppl_well_below_byte_random_256": ppl["dense"] < 256 / 10,
        "gate_int8_within_0.1_ppl_of_bf16": gaps["int8"] < GATE_PPL,
        "paged_bf16_within_1e-2_of_dense": paged_rel < GATE_PAGED_RTOL,
    })
    head = np.fromfile(train_bin, dtype=np.uint16, count=GATE_BATCH * (GATE_SEQ + 1))
    batch = torch.from_numpy(head.astype(np.int64)).reshape(GATE_BATCH, -1).to(dev)
    loss, layers_checked, attn_err, attn_ok = check_train_attention(
        model, state["opt_state"], make_train_step(cfg, make_optimizer(spec)), batch, None)
    checks["train_attention_every_layer_fwd_and_bwd_kernel_vs_plain"] = (
        attn_ok and layers_checked == cfg.n_layers)
    gen = torch.Generator(device=dev).manual_seed(17)
    timings = {"attn_fwd": time_fwd(gen, dev, GATE_BATCH, 12, 4, GATE_SEQ, 64, {}),
               "bwd": time_bwd(dev, gen, GATE_BATCH, 12, 4, GATE_SEQ, 64)}
    for kind in GATE_KINDS:
        timings[f"paged_decode_{kind}"] = time_paged(
            gen, dev, kind, GATE_EVAL, [GATE_SEQ] * GATE_EVAL, 0, heads=(12, 4, 64))
    del model, state
    torch.cuda.empty_cache()
    rec = {
        "phase": "eval_gate", "config_source": "scripts/train_lm.py model_config (default)",
        "config": GATE_CFG, "dtype": "bfloat16", "remat": "block",
        "params": n_params, "corpus_mb": GATE_CORPUS_MB, "corpus_s": corpus_s,
        "corpus_log": made.stdout.strip()[-300:], "batch": GATE_BATCH, "seq": GATE_SEQ,
        "steps": GATE_STEPS, "steps_published": 3000, "train_s": train_s,
        "ms_per_step": train_s * 1e3 / GATE_STEPS,
        "tokens_per_s": GATE_BATCH * GATE_SEQ * GATE_STEPS / train_s,
        "losses_first_last": [losses[0], losses[-1]], "loss_every_50": losses[::50],
        "eval_rows": GATE_EVAL, "eval_tokens": GATE_SEQ, "ppl": ppl,
        "gap_vs_bf16": gaps, "paged_bf16_vs_dense_rel": paged_rel, "gate_ppl": GATE_PPL,
        "train_launches": train_counts, "eval_launches": eval_counts,
        "eval_last_step_layers": layers, "train_attention_layers_checked": layers_checked,
        **{f"train_attention_{k}": v for k, v in attn_err.items()},
        "timings": timings, "seconds": time.perf_counter() - t_phase, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"eval gate checks failed: {failed}")
    return rec


# The encoder (encoder): bert-base-uncased's published widths (BERT_BASE),
# the JAX encoder's own blocks (RMSNorm, RoPE, SwiGLU) in bf16 with block
# remat, masked-LM steps at B32 x 512 (BERT's phase-2 length), 15% of the
# positions masked to [MASK] = 103, AdamW lr 1e-4.
BERT_BASE = dict(vocab_size=30522, d_model=768, n_layers=12, n_q_heads=12, n_kv_heads=12,
                 head_dim=64, d_ff=3072)
ENC_BATCH, ENC_SEQ, ENC_MASK_ID, ENC_MASK_RATE = 32, 512, 103, 0.15
ENC_WARM_STEPS, ENC_TIMED_STEPS = 2, 4


def mlm_batch(rng, vocab, b, n):
    import torch

    tokens = rng.integers(1000, vocab, (b, n))
    mask = rng.random((b, n)) < ENC_MASK_RATE
    masked = np.where(mask, ENC_MASK_ID, tokens)
    return tuple(torch.from_numpy(a) for a in (tokens, masked, mask))


def phase_encoder(dev):
    """The bidirectional encoder at BERT-base widths: ENC_WARM_STEPS warm
    and ENC_TIMED_STEPS timed mlm_loss steps (forward, backward through
    the non-causal d64 sweeps, AdamW) with exact launches on the wgmma
    route, ms a step, tokens/s and peak memory; one more step's every layer
    forward and backward against the plain versions; a 2-layer fp32 copy's
    loss and gradients within FP32_GRAD_LIMIT x std of the plain path; and
    bidirectionality: changing the last token moves the first position's
    embedding."""
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        AdamW, ModelConfig, init_params_numpy, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.models.encoder import encode, mlm_loss

    t_phase = time.perf_counter()
    cfg = ModelConfig(**BERT_BASE, dtype=torch.bfloat16, remat=True)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer = AdamW(1e-4, weight_decay=0.01)
    opt_state = optimizer.init(model)
    tokens, masked, mask = (x.to(dev) for x in mlm_batch(
        np.random.default_rng(15), cfg.vocab_size, ENC_BATCH, ENC_SEQ))

    def step(model, opt_state, batch, seed=None):
        model.zero_grad(set_to_none=True)
        loss = mlm_loss(model, tokens, masked, mask, cfg)
        loss.backward()
        optimizer.update(model, opt_state)
        return loss.detach()

    losses = [float(step(model, opt_state, None)) for _ in range(ENC_WARM_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    _zero_d64()
    torch.cuda.synchronize()
    t = time.perf_counter()
    timed = [step(model, opt_state, None) for _ in range(ENC_TIMED_STEPS)]
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t) * 1e3 / ENC_TIMED_STEPS
    launches, routes, sweeps = _d64_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses += [float(x) for x in timed]
    checks = {"launches_exact_per_step": train_launches_exact(
        launches, routes, sweeps, cfg.n_layers, ENC_TIMED_STEPS),
        "loss_finite_and_falls": all(np.isfinite(losses)) and losses[-1] < losses[0]}
    loss, layers_checked, attn_err, attn_ok = check_train_attention(
        model, opt_state, step, None, None)
    checks["attention_every_layer_fwd_and_bwd_kernel_vs_plain"] = (
        attn_ok and layers_checked == cfg.n_layers)
    with torch.no_grad():
        toks = tokens[:1].clone()
        first = encode(model, toks, cfg)[0, 0]
        toks[0, -1] = (toks[0, -1] + 1) % cfg.vocab_size
        moved = float((encode(model, toks, cfg)[0, 0] - first).abs().max())
    checks["bidirectional_last_token_moves_first_embedding"] = moved > 0
    del model, opt_state
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=FP32_LAYERS, dtype=torch.float32, remat=False)

    def build():
        return params_from_jax(init_params_numpy(cfg32, seed=0), cfg32, device=dev), cfg32

    def loss32(model, toks, cfg, dropout_seed=None):
        rows = toks.shape[0]
        return mlm_loss(model, toks, masked[:rows], mask[:rows], cfg)

    fp32 = check_train_fp32(tokens, dev, build=build, loss=loss32)
    checks["fp32_2layer_loss_and_grads_kernel_vs_plain"] = fp32.pop("ok")
    gen = torch.Generator(device=dev).manual_seed(18)
    timings = {"attn_fwd": time_fwd(gen, dev, ENC_BATCH, 12, 12, ENC_SEQ, 64, {}, causal=False),
               "bwd": time_bwd(dev, gen, ENC_BATCH, 12, 12, ENC_SEQ, 64, causal=False)}
    tokens_per_s = ENC_BATCH * ENC_SEQ / (ms_per_step / 1e3)
    rec = {
        "phase": "encoder", "config_source": "bert-base-uncased config.json (widths)",
        "config": BERT_BASE, "dtype": "bfloat16", "remat": "block", "params": n_params,
        "batch": ENC_BATCH, "seq": ENC_SEQ, "mask_rate": ENC_MASK_RATE,
        "losses": losses, "timed_steps": ENC_TIMED_STEPS, "ms_per_step": ms_per_step,
        "tokens_per_s": tokens_per_s, "peak_memory_gb": peak_gb, "launches": launches,
        "fwd_routes": routes, "bwd_routes": sweeps,
        "attention_layers_checked": layers_checked,
        **{f"attention_{k}": v for k, v in attn_err.items()},
        "first_embedding_moved_by": moved, **fp32, "timings": timings,
        "seconds": time.perf_counter() - t_phase, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"encoder checks failed: {failed}")
    return rec


# ---------------------------------------------------------------------------
# The tiles, the tuner, the bench suite and the golden gate
# ---------------------------------------------------------------------------

FWD_TILES_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_tiles.cu"
BWD_TILES_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_tiles.cu"
# The other tiles' instances (csrc/attn_fwd_tiles.cu, attn_bwd_tiles.cu): the
# mangled names end in the tile after four (forward) or three (sweeps) mode
# flags, all off.
TILE_ENTRY = re.compile(r"attn_(fwd|bwd_dkv|bwd_dq)_wgmma_kernelI\d+(__nv_bfloat16|__half)"
                        r"Li(\d+)E(?:Lb0E){3,4}Li(\d+)E")
# Check cases of the other tiles: name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal,
# window, softcap.  The gate model's attention (scripts/train_lm.py), BERT-base
# widths (the encoder) and the training-bench attention shape at d 128, in
# bf16; fp16 at two of them; ragged and cross-length edges with a window and
# the softcap.
TILE_CASES = (
    ("gate_d64", BF16, 16, 12, 4, 2048, 2048, 64, True, 0, 0.0),
    ("bert_d64", BF16, 32, 12, 12, 512, 512, 64, False, 0, 0.0),
    ("train_d128", BF16, 8, 32, 8, 2048, 2048, 128, True, 0, 0.0),
    ("bert_d64_fp16", F16, 32, 12, 12, 512, 512, 64, False, 0, 0.0),
    ("train_d128_fp16", F16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0),
    ("edge_d128_cross_129_385", BF16, 2, 8, 2, 129, 385, 128, True, 0, 0.0),
    ("edge_d64_window128_softcap_n300", F16, 2, 8, 2, 300, 300, 64, True, 128, 30.0),
)
# The shapes the tuner and the kernels line time the tiles at: (B, Hq, Hkv,
# N, d, causal).
TUNE_SHAPES = {"gate_d64": (16, 12, 4, 2048, 64, True),
               "bert_d64": (32, 12, 12, 512, 64, False),
               "train_d128": (8, 32, 8, 2048, 128, True)}
# Broken copies of the other tiles' instances, built as BWD_MUTANTS are:
# each drops the last key tile of its CTA's range (the producer and the
# consumers alike), only where the tile is not the head dim's own; the
# tiles check must fail on each.
TILE_MUTANTS = {
    "fwd_tiles_skip_last_key_tile": ("attn_fwd_tiles.cu", "attn_fwd_sm90.cuh", [(
        "  const TileRange tiles = kv_tiles<BM, BN>(m0, Nq, Nkv, causal, window);\n",
        "  TileRange tiles = kv_tiles<BM, BN>(m0, Nq, Nkv, causal, window);\n"
        "  if (KT != key_tile(D) && tiles.hi - tiles.lo > 1) --tiles.hi;\n")]),
    "dq_tiles_skip_last_key_tile": ("attn_bwd_tiles.cu", "attn_bwd_sm90.cuh", [(
        "  const TileRange tiles = kv_tiles<BR, BS>(m0, Nq, Nkv, causal, window);\n",
        "  TileRange tiles = kv_tiles<BR, BS>(m0, Nq, Nkv, causal, window);\n"
        "  if (ST != stream_tile(D, false) && tiles.hi - tiles.lo > 1) --tiles.hi;\n")]),
}
# The C entry each tile mutant replaces (ops module, attribute, symbol).
TILE_MUTANT_TARGETS = {"fwd_tiles_skip_last_key_tile": ("fwd_kernel", "FWD_TILES_KERNEL",
                                                        "attn_fwd_tiles"),
                       "dq_tiles_skip_last_key_tile": ("bwd_kernel", "DQ_TILES_KERNEL",
                                                       "attn_bwd_dq_tiles")}
TILE_MUTANT_BUILDS = None  # started by phase_build(mutants=True)
# Paged tuner cases: (name, kv kind, B, Hq, Hkv, d, softcap), context 2048
# in 128-token pages, tables of 17 pages (the serving model's and
# Gemma-2-2B's decode shapes).
PAGED_TUNE_CASES = tuple(
    (f"{kind}_B{b}_d{d}", kind, b, hq, hkv, d, cap)
    for d, hq, hkv, cap in ((128, 16, 8, 0.0), (256, 8, 4, GEMMA_SOFTCAP))
    for kind in ("bf16", "int8") for b in (4, 8))
BENCH_SEQ_LENS = (1024, 4096, 16384)


def tile_instances(log):
    """Registers, spills and ptxas performance warnings of each instance of
    the other tiles from nvcc's ``--ptxas-options=-v`` log:
    {"<kernel>_<dtype>_d<d>_kv<tile>": {...}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = TILE_ENTRY.search(m.group(1))
            cur = None
            if w is not None:
                kernel, dtype, d, tile = w.groups()
                cur = (f"{kernel}_{'bf16' if dtype == '__nv_bfloat16' else 'fp16'}"
                       f"_d{d}_kv{tile}")
                out[cur] = {"ptxas_warnings": []}
            continue
        if cur is None:
            continue
        if "Performance Loss" in line:
            out[cur]["ptxas_warnings"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def check_tile_builds(rec, built):
    """Adds the other tiles' instances to the build record; what is wrong
    with them (a message, or None): there must be 4 forward and 8 sweep
    instances, each at the launch allocation, none with serialized
    wgmmas."""
    tiles = {}
    for src in ("attn_fwd_tiles.cu", "attn_bwd_tiles.cu"):
        if src in built:
            tiles.update(tile_instances(built[src]["log"]))
    if not tiles:
        return None
    rec["tile_instances"] = tiles
    bad = {k: v for k, v in tiles.items()
           if v.get("registers") != LAUNCH_REGS or v["ptxas_warnings"]}
    if len(tiles) != 12 or bad:
        return (f"tile instances: expected 12 at {LAUNCH_REGS} registers without "
                f"warnings, found {sorted(tiles)}; at fault {bad}")
    return None


def shared_bytes_check():
    """Every built layout's dynamic shared memory, from each build's
    ``*_shared_bytes`` entry, against geometry.py's model (the forward's
    by head dim, segment flag and fp8 V; the sweeps' by head dim, segment
    flag and sweep; the other tiles' by head dim): {layout: [C, Python]}."""
    import ctypes
    from flash_attention_dlrs_tpu_torch import _cuda, geometry as geo

    def entry(source, nargs):
        stem = source.split(".")[0]
        fn = getattr(ctypes.CDLL(str(_cuda.library_path(source))), f"{stem}_shared_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
        return fn

    out = {}
    for d, dim in ((64, "_d64"), (128, ""), (256, "_d256")):
        for seg in (False, True):
            fwd = entry(f"attn_fwd{dim}{'_seg' if seg else ''}.cu", 2)
            bwd = entry(f"attn_bwd{dim}{'_seg' if seg else ''}.cu", 2)
            bkv, bs = geo.default_block_kv(d), geo.default_block_kv_bwd(d)
            for v8 in (False, True):
                out[f"fwd_d{d}_kv{bkv}{'_seg' if seg else ''}{'_fp8v' if v8 else ''}"] = [
                    fwd(1, int(v8)), geo.attention_fwd_smem_bytes(
                        bkv, d, geo.fwd_stages(bkv, d, seg, v8), seg, v8)]
            for dkv in (True, False):
                rows = geo.bwd_stream_rows(d, bs, dkv)
                out[f"{'dkv' if dkv else 'dq'}_d{d}_kv{rows}{'_seg' if seg else ''}"] = [
                    bwd(int(dkv), 1), geo.attention_bwd_smem_bytes(bs, d, seg, dkv)]
    fwd_tiles, bwd_tiles = entry("attn_fwd_tiles.cu", 2), entry("attn_bwd_tiles.cu", 3)
    for d in (64, 128):
        out[f"fwd_d{d}_kv64"] = [fwd_tiles(d, 64), geo.attention_fwd_smem_bytes(
            64, d, geo.fwd_stages(64, d))]
        for dkv in (True, False):
            out[f"{'dkv' if dkv else 'dq'}_d{d}_kv32"] = [
                bwd_tiles(int(dkv), d, 32), geo.attention_bwd_smem_bytes(32, d, False, dkv)]
    return out


def tile_launches(zero=False):
    """The forward's and each sweep's wgmma launches by head dim and tile
    (ops/fwd_kernel.py TILE_LAUNCHES, ops/bwd_kernel.py BWD_TILE_LAUNCHES),
    cleared when ``zero``."""
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import BWD_TILE_LAUNCHES
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import TILE_LAUNCHES

    counts = {"attn_fwd": TILE_LAUNCHES, **BWD_TILE_LAUNCHES}
    if zero:
        for c in counts.values():
            c.clear()
    return {k: dict(c) for k, c in counts.items()}


def other_tiles(d):
    from flash_attention_dlrs_tpu_torch.tuning import BlockSizes

    return BlockSizes(block_kv=64, block_kv_bwd=32) if d in (64, 128) else None


def tile_case(dev, gen, case):
    """One tiles check case: the forward on its other key tile (64) and the
    three backward kernels on the other streamed tile (32) against the plain
    versions on the same inputs (fwd_check's and bwd_check's limits), the
    backward twice (bitwise equal), each launch on its tile.  (record, ok)."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd, attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, attn_fwd_plain

    name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap = case
    dt = getattr(torch, dt)
    q, do = (_rand(gen, (b, hq, nq, d), dt, dev) for _ in range(2))
    k, v = (_rand(gen, (b, hkv, nkv, d), dt, dev) for _ in range(2))
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=cap,
              block_sizes=other_tiles(d))
    tile_launches(zero=True)
    o, lse = attn_fwd(q, k, v, **kw)
    got = attn_bwd(q, k, v, o, lse, do, **kw)
    again = attn_bwd(q, k, v, o, lse, do, **kw)
    launches = tile_launches()
    fwd_rec, fwd_ok = fwd_errors((o, lse), attn_fwd_plain(q, k, v, **kw), dt)
    bwd_rec, bwd_ok = bwd_errors(got, attn_bwd_plain(q, k, v, o, lse, do, **kw), dt)
    torch.cuda.synchronize()
    want = {"attn_fwd": {f"d{d}_kv64": 1}, "attn_bwd_dkv": {f"d{d}_kv32": 2},
            "attn_bwd_dq": {f"d{d}_kv32": 2}}
    rec = {"case": name, "dtype": str(dt), "shape": [b, hq, hkv, nq, nkv, d],
           "causal": causal, "window": window, "softcap": cap, "fwd": fwd_rec, "bwd": bwd_rec,
           "bitwise_repeatable": all(torch.equal(a, c) for a, c in zip(got, again)),
           "tile_launches": launches, "launches_exact": launches == want}
    rec["ok"] = fwd_ok and bwd_ok and rec["bitwise_repeatable"] and rec["launches_exact"]
    return rec, rec["ok"]


def tile_mutants_caught(dev, builds):
    """Each broken copy of TILE_MUTANTS in place of its C entry on every
    TILE_CASES case: each must fail at least one."""
    import importlib

    import torch
    from flash_attention_dlrs_tpu_torch import _cuda

    wait = wait_mutant_builds(builds)
    caught = {}
    for name, (_, lib, source) in builds.items():
        module, attr, symbol = TILE_MUTANT_TARGETS[name]
        mod = importlib.import_module(f"flash_attention_dlrs_tpu_torch.ops.{module}")
        real = getattr(mod, attr)
        failed = []
        gen = torch.Generator(device=dev).manual_seed(8)
        try:
            setattr(mod, attr, _cuda.CudaKernel(source, symbol, real.argtypes, library=lib))
            for case in TILE_CASES:
                if not tile_case(dev, gen, case)[1]:
                    failed.append(case[0])
        finally:
            setattr(mod, attr, real)
        caught[name] = failed
    return caught, wait


def tuner_run(fn, *args, **kw):
    """``fn(*args, **kw)`` and the number of candidates it timed
    (tuning._time_call calls)."""
    from flash_attention_dlrs_tpu_torch import tuning

    timed, real = [], tuning._time_call

    def counting(*a, **k):
        timed.append(1)
        return real(*a, **k)

    tuning._time_call = counting
    try:
        out = fn(*args, **kw)
    finally:
        tuning._time_call = real
    return out, len(timed)


def search_times(key_prefix):
    """The candidates' times (ms) of the tuner's searches whose key starts
    with ``key_prefix`` in this process (tuning.TIMINGS)."""
    from flash_attention_dlrs_tpu_torch import tuning

    return {key: {str(c): (None if t is None else t * 1e3) for c, t in rows}
            for key, rows in tuning.TIMINGS.items() if json.loads(key)[1] == key_prefix}


def phase_tune(dev):
    """The geometry model, the other tiles and the tuner:

    (a) ``current_geometry()`` against the H100's 132 SMs and 232,448 bytes,
        and every built layout's shared memory against geometry.py's;
    (b) each other-tile instance against its plain version (TILE_CASES),
        its launches counted exactly, and each tile mutant caught; the
        tiles driven through the op API (``flash_attention`` with
        ``block_sizes``, forward and backward) at the TUNE_SHAPES, their
        launches counted exactly, and timed beside their bounds;
    (c) ``tuned_block_sizes`` at the TUNE_SHAPES: every candidate's ms, the
        winner, a second call that times nothing;
    (d) ``tuned_pages_per_block`` at PAGED_TUNE_CASES: every candidate's
        device ms, the winner, decode_splits' choice, a second call that
        times nothing;
    (e) the serving-bench engine with its tuned ``pages_per_block``, eager
        and graphed: its tokens against the default engine's (bf16 at full
        width: near-ties only; a 2-layer fp32 copy: equal)."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda, geometry as geo, tuning
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.ops.flash_attention import (
        flash_attention, tuned_block_sizes,
    )

    t0 = time.perf_counter()
    builds = TILE_MUTANT_BUILDS or start_mutant_builds(TILE_MUTANTS)
    tuning._CACHE_PATH = str(_cuda.BUILD_DIR / "tune_cache.json")
    tuning._TUNE_CACHE.clear()
    tuning.TIMINGS.clear()
    checks = {}
    # (a) the geometry model
    g = geo.current_geometry()
    shared = shared_bytes_check()
    checks["geometry_is_h100"] = (g.sm_count, g.smem_per_block_optin) == (132, 232448)
    checks["model_bytes_equal_kernels"] = all(c == p for c, p in shared.values())
    emit({"phase": "tune", "part": "geometry", "geometry": dataclasses_dict(g),
          "supports_fast_fp8": geo.supports_fast_fp8(g), "shared_bytes": shared})
    # (b) the other tiles against their plain versions, and their mutants
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = {}
    for case in TILE_CASES:
        rec, _ = tile_case(dev, gen, case)
        cases[case[0]] = rec
        emit({"phase": "tune", "part": "tile_check", **rec})
    checks["tiles_within_limits"] = all(r["ok"] for r in cases.values())
    caught, wait = tile_mutants_caught(dev, builds)
    checks["tile_mutants_caught"] = all(caught.values())
    emit({"phase": "tune", "part": "tile_mutants", "failed_cases": caught,
          "build_wait_seconds": wait})
    # the op API on the other tiles: the path the kernels line counts
    tile_launches(zero=True)
    drive = {}
    for name, (b, hq, hkv, n, d, causal) in TUNE_SHAPES.items():
        q, k, v = (_rand(gen, (b, h, n, d), torch.bfloat16, dev).requires_grad_(True)
                   for h in (hq, hkv, hkv))
        before = tile_launches()
        o = flash_attention(q, k, v, causal=causal, block_sizes=other_tiles(d))
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        after = tile_launches()
        drive[name] = {s: {t: n_ - before[s].get(t, 0) for t, n_ in c.items()}
                       for s, c in after.items()}
        del q, k, v, o
    launches = tile_launches()
    checks["op_api_launches_exact"] = launches == {
        "attn_fwd": {"d64_kv64": 2, "d128_kv64": 1},
        "attn_bwd_dkv": {"d64_kv32": 2, "d128_kv32": 1},
        "attn_bwd_dq": {"d64_kv32": 2, "d128_kv32": 1}}
    timings = {}
    for name, (b, hq, hkv, n, d, causal) in TUNE_SHAPES.items():
        blocks = other_tiles(d)
        timings[name] = {"fwd": time_fwd(gen, dev, b, hq, hkv, n, d, {}, causal=causal,
                                         blocks=blocks),
                         "bwd": time_bwd(dev, gen, b, hq, hkv, n, d, causal=causal,
                                         blocks=blocks)}
    emit({"phase": "tune", "part": "op_api", "launches": launches, "by_shape": drive,
          "timings": timings})
    # (c) the tile tuner
    tuned = {}
    for name, (b, hq, hkv, n, d, causal) in TUNE_SHAPES.items():
        q, k, v = (_rand(gen, (b, h, n, d), torch.bfloat16, dev) for h in (hq, hkv, hkv))
        first, timed = tuner_run(tuned_block_sizes, q, k, v, causal=causal)
        second, timed_again = tuner_run(tuned_block_sizes, q, k, v, causal=causal)
        tuned[name] = {"winner": dataclasses_dict(first), "timed": timed,
                       "timed_on_second_call": timed_again, "same_on_second_call":
                       first == second}
        del q, k, v
    searches = search_times("fwd") | search_times("bwd")
    checks["tile_tuner_caches"] = all(r["timed"] > 0 and r["timed_on_second_call"] == 0
                                      and r["same_on_second_call"] for r in tuned.values())
    emit({"phase": "tune", "part": "tile_tuner", "tuned": tuned, "candidate_ms": searches})
    # (d) the paged tuner
    paged = {}
    for name, kind, b, hq, hkv, d, cap in PAGED_TUNE_CASES:
        q, kp, vp, lens, table = _paged_inputs(gen, dev, torch.bfloat16, kind, b, hq, hkv, d,
                                               SERVE_PAGE, SERVE_PPS, [2048] * b,
                                               num_pages=b * SERVE_PPS + 8)
        kw = dict(sm_scale=d ** -0.5, logit_softcap=cap)
        ppb, timed = tuner_run(dm.tuned_pages_per_block, q, kp, vp, lens, table, **kw)
        again, timed_again = tuner_run(dm.tuned_pages_per_block, q, kp, vp, lens, table, **kw)
        planner = dm.decode_splits(b, hkv, SERVE_PPS, SERVE_PAGE, g.sm_count)
        paged[name] = {"winner_pages_per_block": ppb,
                       "winner_splits": dm.key_splits(SERVE_PPS, ppb),
                       "decode_splits": planner, "timed": timed,
                       "timed_on_second_call": timed_again, "same": ppb == again}
        del q, kp, vp
    checks["paged_tuner_caches"] = all(r["timed"] > 0 and r["timed_on_second_call"] == 0
                                       and r["same"] for r in paged.values())
    emit({"phase": "tune", "part": "paged_tuner", "tuned": paged,
          "candidate_device_ms": search_times("decode")})
    # (e) the serving engine with the tuned pages_per_block
    serve = tuned_engine_check(dev, gen)
    checks.update(serve.pop("checks"))
    torch.cuda.empty_cache()
    rec = {"phase": "tune", "part": "result", "checks": checks, "engine": serve,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tune checks failed: {bad}")
    return {"launches": launches, "timings": timings, "cases": cases, "tuned": tuned,
            "paged": paged}


def dataclasses_dict(obj):
    import dataclasses

    return dataclasses.asdict(obj)


def tuned_engine_check(dev, gen):
    """The serving-bench engine (4 slots, phase serve's 8 prompts, 32 new
    tokens) with ``pages_per_block`` from ``tuned_pages_per_block`` at its
    decode shape, eager (``generate``) and graphed (``generate(burst=8)``),
    against the default engine eagerly: bf16 at full width may part only at
    near-ties; a 2-layer fp32 copy must be equal.  Every decode call of the
    tuned engine runs the tuned split count."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    slots = 4
    lengths = [n + SERVE_NEW_TOKENS for n in SERVE_PROMPTS[:slots]]
    q, kp, vp, lens, table = _paged_inputs(gen, dev, torch.bfloat16, "bf16", slots, 16, 8,
                                           128, SERVE_PAGE, SERVE_PPS, lengths,
                                           num_pages=slots * SERVE_PPS + 1)
    ppb = dm.tuned_pages_per_block(q, kp, vp, lens, table, sm_scale=128 ** -0.5)
    splits = dm.key_splits(SERVE_PPS, ppb)
    del q, kp, vp
    out, checks = {"pages_per_block": ppb, "splits": splits,
                   "decode_splits": dm.decode_splits(slots, 8, SERVE_PPS, SERVE_PAGE,
                                                     torch.cuda.get_device_properties(
                                                         dev).multi_processor_count)}, {}
    for dtype, layers in ((torch.bfloat16, None), (torch.float32, 2)):
        model, cfg = serving_bench_model(dev, dtype=dtype, n_layers=layers)
        prompts = serve_prompts(cfg)
        kv = "bf16" if dtype == torch.bfloat16 else "fp32"

        def engine(**kw):
            return DecodeEngine(model, cfg, num_pages=slots * SERVE_PPS + 1,
                                page_size=SERVE_PAGE, num_slots=slots,
                                pages_per_seq=SERVE_PPS, kv_dtype=kv_kind(kv), device=dev,
                                **kw)

        want = engine().generate(prompts, max_new_tokens=SERVE_NEW_TOKENS)
        tuned = engine(pages_per_block=ppb)
        dm.DECODE_SPLITS.clear()
        eager = tuned.generate(prompts, max_new_tokens=SERVE_NEW_TOKENS)
        eager_splits = dict(dm.DECODE_SPLITS)
        dm.DECODE_SPLITS.clear()
        graphed = tuned.generate(prompts, max_new_tokens=SERVE_NEW_TOKENS, burst=8)
        graphed_splits = dict(dm.DECODE_SPLITS)
        tag = "bf16" if layers is None else "fp32_2layer"
        rec = {"eager_splits": eager_splits, "graphed_splits": graphed_splits,
               "graphs": len(step_graphs(tuned))}
        checks[f"{tag}_splits_as_tuned"] = (set(eager_splits) == {splits}
                                            and set(graphed_splits) == {splits})
        if layers is None:
            rec["divergences_eager"] = divergences(model, cfg, dev, prompts, want, eager)
            rec["divergences_graphed"] = divergences(model, cfg, dev, prompts, want, graphed)
            checks["bf16_near_ties_only"] = (near_ties_only(rec["divergences_eager"])
                                             and near_ties_only(rec["divergences_graphed"]))
        else:
            checks["fp32_tokens_equal"] = eager == want and graphed == want
        rec["tokens_equal"] = eager == want and graphed == want
        out[tag] = rec
        del model, tuned
        torch.cuda.empty_cache()
    out["checks"] = checks
    return out


def phase_bench(dev):
    """bench/suite.py run_bench at B8 H16 d128 bf16 causal, N in
    BENCH_SEQ_LENS, fwd and bwd, for ours and sdpa (naive to 4096): each
    row's TFLOP/s and percent of the bf16 peak (utils/profiling.py); the
    ``ours`` rows finite.  Then bench_torch.py's one JSON line (a process of
    its own)."""
    import os

    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.bench.suite import run_bench
    from flash_attention_dlrs_tpu_torch.utils.profiling import device_peaks, percent_of_sol

    t0 = time.perf_counter()
    results = run_bench(seq_lens=BENCH_SEQ_LENS, providers=("ours", "sdpa", "naive"),
                        modes=("fwd", "bwd"), out_dir=str(_cuda.BUILD_DIR / "bench_out"),
                        device=dev, max_n={"naive": 4096})
    rows = [{"provider": r.provider, "mode": r.mode, "N": r.n, "ms": r.ms,
             "tflops": r.tflops, "percent_of_sol": percent_of_sol(r.tflops, dev)}
            for r in results]
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True, text=True,
                         timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode:
        raise RuntimeError(f"bench_torch.py failed:\n{out.stderr[-4000:]}")
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)  # bench_torch.py's own line, as it prints it
    headline = json.loads(line)
    ours_finite = all(r["ms"] == r["ms"] for r in rows if r["provider"] == "ours")
    rec = {"phase": "bench", "peaks": device_peaks(dev), "rows": rows,
           "bench_torch": headline, "ours_finite": ours_finite,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not ours_finite or not headline["value"] > 0:
        raise AssertionError("bench: a row of ours is NaN or the headline is not positive")
    return rec


def phase_golden(dev):
    """scripts/run_golden_gate_torch.py's gate: 200 fp32 trials at B32 H32
    N256 d128, sm_scale 1, non-causal (the reference harness), forward and
    backward against the oracle at the reference ladder."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "run_golden_gate_torch.py")
    spec = importlib.util.spec_from_file_location("run_golden_gate_torch", path)
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    t0 = time.perf_counter()
    rec = gate.run_gate(200, small=False, causal=False, device=dev)
    rec = {"phase": "golden", **rec, "seconds": time.perf_counter() - t0}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"golden gate: {rec['fwd_pass']} / {rec['bwd_pass']} of 200")
    return rec


def tile_entries(entry, tune):
    """The kernels line's entries of the other tiles: launches from phase
    tune's op-API run, times at the gate model's causal d64 shape and the
    training-bench d128 shape (the BERT shape's in phase tune's record)."""
    out = []
    for d, shape in ((64, "gate_d64"), (128, "train_d128")):
        t = tune["timings"][shape]
        out.append(entry(f"attn_fwd[d{d},kv64]", FWD_SM90_SOURCE, FWD_REPLACES,
                         tune["launches"]["attn_fwd"].get(f"d{d}_kv64", 0), t["fwd"],
                         built_from=FWD_TILES_SOURCE))
        for name in ("attn_bwd_dkv", "attn_bwd_dq"):
            out.append(entry(f"{name}[d{d},kv32]", BWD_SM90_SOURCE, BWD_REPLACES[name],
                             tune["launches"][name].get(f"d{d}_kv32", 0), t["bwd"][name],
                             built_from=BWD_TILES_SOURCE))
    return out


def emit_kernels(fwd_res, dec_res, paths, timings, graphed, models, gemma_train, d256_modes,
                 later):
    """The kernels line: every kernel of every path, the paged kernels once
    per pool kind they serve, and one entry per ALiBi / dropout mode.
    Launches are the counts of the path runs (serving, quantized serving,
    chunked serving and the dense admissions beside it, the training run's
    timed steps; the modes: ALiBi serving and the ALiBi + dropout training
    run's timed steps); times, bounds and errors are at the serving shapes
    for attn_fwd, attn_fwd[alibi] and the paged kernels (decode at 8
    sequences of 2048 tokens, verify a 256-token chunk at 2048) and at the
    training shape for attn_fwd[alibi+dropout] and the backward kernels.
    ``graphed`` holds phases serve_burst and serve_spec: their launches
    (through CUDA graph replays) join attn_fwd's and the paged kernels' of
    their KV kind, and verify at a speculative round's shape (B4, T = γ)
    has an entry of its own.  ``models`` holds phases serve_gemma2 and
    variants: the variants' launches (head dims 128 and 96, padded to 128)
    join attn_fwd's and paged_decode[bf16]'s, and Gemma-2-2B's head dim 256
    has entries of its own (the forward at its prefill and its windowed
    dense forward, decode from bf16 and int8 KV at 8 sequences of 2048,
    verify of a 256-token chunk), timed with its softcap.  ``gemma_train``
    is phase train_gemma2: its launches join attn_fwd[d256] (global and
    windowed) and attn_bwd_preprocess, and the head-dim-256 backward sweeps
    have entries of their own (global and windowed), timed at its training
    shape with its softcap.  ``d256_modes`` holds phases train_gemma2_dropout
    and serve_alibi_d256: with the packed phase's head-dim-256 block they
    give the head-dim-256 modes' launches (each mode's builds named in
    "built_from").  ``later`` holds the phases serve_rolling,
    serve_streaming, native, eval_gate, encoder and tune: the rings' and the
    native phase's launches join attn_fwd's and the paged kernels' of their
    KV kind, the two training runs' join attn_bwd_preprocess, head dim
    64 has entries of its own (:func:`later_entries`), and so have the
    other tiles (:func:`tile_entries`).  Every kernel of the
    line must have been launched on its path."""
    serve, quant, chunked, dense_fwd, train, serve_alibi, train_alibi, packed = paths
    rolling, streaming, native = (later[k]["launches"] for k in (
        "serve_rolling", "serve_streaming", "native"))
    burst, spec = graphed
    gemma, variants = models
    fwd_t = timings["fwd_serve_prefill_2048"]
    kernels = [
        {"name": "attn_fwd", "route": "cuda", "source": FWD_SM90_SOURCE,
         "fwd_route": fwd_t["route"], "replaces": FWD_REPLACES,
         "launches": serve["launches"]["attn_fwd"] + train["launches"]["attn_fwd"]
         + sum(r["launches"]["attn_fwd"] for r in quant.values()) + dense_fwd
         + burst["launches"]["attn_fwd"] + spec["launches"]["attn_fwd"]
         + variants["launches"]["attn_fwd"] + rolling["attn_fwd"] + streaming["attn_fwd"]
         + native["attn_fwd"],
         "max_abs_err": fwd_res["serve_prefill_2048"]["max_abs_err_o"],
         "ms": fwd_t["ms"], "plain_ms": fwd_t["plain_ms"],
         "bound_ms": fwd_t["bound_ms"], "bound_by": fwd_t["bound_by"],
         "library_ms": fwd_t["library_ms"]},
    ]
    for kind in ("bf16",) + QUANT_KINDS:
        launches = sum(r["launches"]["paged_decode"] for r in quant.values()
                       if r["kv"] == kind)
        launches += chunked[kind]["launches"]["paged_decode"] if kind in chunked else 0
        if kind == "bf16":
            launches += (serve["launches"]["paged_decode"] + burst["launches"]["paged_decode"]
                         + variants["launches"]["paged_decode"] + rolling["paged_decode_bf16"]
                         + streaming["paged_decode"] + native["paged_decode"])
        if kind == "int8":
            launches += rolling["paged_decode_int8"]
        launches += spec["launches"]["paged_decode"].get(kind, 0)
        t = timings[f"decode_{kind}_B8_ctx2048"]
        err = dec_res["serve_decode" if kind == "bf16" else f"{kind}_B8"]["max_abs_err_o"]
        kernels.append({
            "name": f"paged_decode[{kind}]", "route": "cuda", "source": DECODE_SOURCE,
            "replaces": DECODE_REPLACES, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "splits": t["splits"], "ctas": t["ctas"]})
    for kind in ("bf16", "int8"):
        t = timings[f"verify_{kind}_T256_ctx2048"]
        kernels.append({
            "name": f"paged_verify[{kind}]", "route": "cuda", "source": VERIFY_SOURCE,
            "verify_route": t["route"], "replaces": VERIFY_REPLACES,
            "launches": chunked[kind]["launches"]["paged_verify"]
            + (spec["launches"]["paged_verify"]["int8"] if kind == "int8" else 0),
            "max_abs_err": dec_res[f"verify_T256_{kind}"]["max_abs_err_o"],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "splits": t["splits"], "ctas": t["ctas"]})
    def entry(name, source, replaces, launches, t, err=None, built_from=None):
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": t["max_abs_err"] if err is None else err,
               "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if built_from:  # the source the kernel body (source) is built in
            rec["built_from"] = built_from
        if name.startswith("paged_"):  # device time, key splits, CTAs
            rec.update(device_ms=t["device_ms"], splits=t["splits"], ctas=t["ctas"])
            if name.startswith("paged_verify"):
                rec["verify_route"] = t["route"]
        elif "route" in t:  # ops/fwd_kernel.py fwd_route, ops/bwd_kernel.py bwd_route
            rec["bwd_route" if name.startswith("attn_bwd") else "fwd_route"] = t["route"]
        return rec

    kernels.append(entry("paged_verify[bf16,round_B4_T4]", VERIFY_SOURCE, VERIFY_REPLACES,
                         spec["launches"]["paged_verify"]["bf16"], spec["round_verify"]))
    rows = timings["bwd_train_B8_H32_N2048"]
    for name, replaces in BWD_REPLACES.items():
        source = BWD_SOURCE if name == "attn_bwd_preprocess" else BWD_SM90_SOURCE
        launches = train["launches"][name]
        if name == "attn_bwd_preprocess":
            launches += (gemma_train_launches(gemma_train, name)
                         + later["eval_gate"]["train_launches"][name]
                         + later["encoder"]["launches"][name]
                         + later["train_d512"]["launches"][name])
        kernels.append(entry(name, source, replaces, launches, rows[name]))

    alibi_fwd = sum(r["launches"]["attn_fwd"] for r in serve_alibi.values())
    rows = timings["bwd_alibi_dropout_train_B8_H32_N2048"]
    kernels += [
        entry("attn_fwd[alibi]", FWD_SM90_SOURCE, FWD_REPLACES, alibi_fwd,
              timings["fwd_alibi_serve_prefill_2048"]),
        entry("attn_fwd[alibi+dropout]", FWD_SM90_SOURCE, FWD_REPLACES,
              train_alibi["launches"]["attn_fwd"],
              timings["fwd_alibi_dropout_train_B8_H32_N2048"]),
        entry("attn_bwd_dkv[alibi+dropout]", BWD_SM90_SOURCE, BWD_REPLACES["attn_bwd_dkv"],
              train_alibi["launches"]["attn_bwd_dkv"], rows["attn_bwd_dkv"]),
        entry("attn_bwd_dq[alibi+dropout]", BWD_SM90_SOURCE, BWD_REPLACES["attn_bwd_dq"],
              train_alibi["launches"]["attn_bwd_dq"], rows["attn_bwd_dq"]),
        entry("paged_decode[bf16+alibi]", DECODE_SOURCE, DECODE_REPLACES,
              sum(r["launches"]["paged_decode"] for r in serve_alibi.values()
                  if r["kv"] == "bf16"),
              timings["decode_bf16_B8_ctx2048_alibi"],
              dec_res["alibi_bf16_B8"]["max_abs_err_o"]),
        entry("paged_decode[int8+alibi]", DECODE_SOURCE, DECODE_REPLACES,
              serve_alibi["int8"]["launches"]["paged_decode"],
              timings["decode_int8_B8_ctx2048_alibi"],
              dec_res["alibi_int8_B8"]["max_abs_err_o"]),
        entry("paged_verify[bf16+alibi]", VERIFY_SOURCE, VERIFY_REPLACES,
              serve_alibi["bf16_chunked"]["launches"]["paged_verify"],
              timings["verify_bf16_T256_ctx2048_alibi"],
              dec_res["alibi_verify_T256_bf16"]["max_abs_err_o"]),
    ]
    # segment ids and fp8 V: launches of the packed phase's calls
    seg_launches = {name: sum(c["launches"][name] for c in packed["calls"].values())
                    for name in ("attn_fwd_seg", "attn_bwd_dkv_seg", "attn_bwd_dq_seg")}
    rows = timings["bwd_seg_train_B8_H32_N2048"]
    kernels += [
        entry("attn_fwd[seg]", FWD_SM90_SOURCE, FWD_REPLACES, seg_launches["attn_fwd_seg"],
              timings["fwd_seg_train_B8_H32_N2048"]),
        entry("attn_bwd_dkv[seg]", BWD_SM90_SOURCE, BWD_REPLACES["attn_bwd_dkv"],
              seg_launches["attn_bwd_dkv_seg"], rows["attn_bwd_dkv"]),
        entry("attn_bwd_dq[seg]", BWD_SM90_SOURCE, BWD_REPLACES["attn_bwd_dq"],
              seg_launches["attn_bwd_dq_seg"], rows["attn_bwd_dq"]),
    ]
    for kind in FP8_V:
        kernels.append(entry(f"attn_fwd[fp8v-{kind}]", FWD_SM90_SOURCE, FWD_REPLACES,
                             packed["fp8_launches"][kind],
                             timings[f"fwd_fp8v_{kind}_serve_prefill_2048"]))
    g = gemma["launches"]
    kernels += [
        entry("attn_fwd[d256]", FWD_SM90_SOURCE, FWD_REPLACES,
              g["attn_fwd"] + gemma_train_launches(gemma_train, "attn_fwd_global"),
              timings["fwd_d256_prefill_2048_softcap"],
              fwd_res["d256_gemma_prefill_2048_softcap"]["max_abs_err_o"], FWD_D256_SOURCE),
        entry("attn_fwd[d256,window]", FWD_SM90_SOURCE, FWD_REPLACES,
              g["attn_fwd_window"] + gemma_train_launches(gemma_train, "attn_fwd_window"),
              timings["fwd_d256_window4096_8192_softcap"],
              fwd_res["d256_gemma_window_softcap_8192"]["max_abs_err_o"], FWD_D256_SOURCE),
        entry("paged_decode[d256,bf16]", DECODE_SOURCE, DECODE_REPLACES,
              g["paged_decode_bf16"], timings["decode_d256_bf16_B8_ctx2048"],
              dec_res["d256_bf16_softcap50"]["max_abs_err_o"], DECODE_D256_SOURCE),
        entry("paged_decode[d256,int8]", DECODE_SOURCE, DECODE_REPLACES,
              g["paged_decode_int8"], timings["decode_d256_int8_B8_ctx2048"],
              dec_res["d256_int8_softcap50"]["max_abs_err_o"], DECODE_D256_SOURCE),
        entry("paged_verify[d256,bf16]", VERIFY_SOURCE, VERIFY_REPLACES,
              g["paged_verify_bf16"], timings["verify_d256_bf16_T256_ctx2048"],
              dec_res["d256_verify_T256_bf16"]["max_abs_err_o"], VERIFY_D256_SOURCE),
    ]
    for tag, key, case in (("d256", "global", "bwd_d256_B2_H8_N8192_softcap"),
                           ("d256,window", "window", "bwd_d256_window4096_B2_H8_N8192_softcap")):
        for name in ("attn_bwd_dkv", "attn_bwd_dq"):
            kernels.append(entry(f"{name}[{tag}]", BWD_SM90_SOURCE, BWD_REPLACES[name],
                                 gemma_train_launches(gemma_train, f"attn_bwd_{key}"),
                                 timings[case][name], built_from=BWD_D256_SOURCE))
    kernels += d256_mode_entries(entry, packed, timings, dec_res, d256_modes)
    kernels += later_entries(entry, later["eval_gate"], later["encoder"])
    kernels += tile_entries(entry, later["tune"])
    kernels += wide_entries(entry, later)
    # the scale-out phases' launches, every rank's, join their kernels' entries
    for name in ("parallel_attention", "parallel_decode", "train_mesh", "serve_mesh", "dryrun"):
        for kernel in kernels:
            kernel["launches"] += later[name]["entry_launches"].get(kernel["name"], 0)
    emit({"kernels": kernels})
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels of the line not launched on their paths: {idle}")


def d256_mode_entries(entry, packed, timings, dec_res, d256_modes):
    """The kernels line's entries of the head-dim-256 modes (``entry`` is
    emit_kernels' maker): launches from the packed phase's head-dim-256
    block (ALiBi, ALiBi + dropout, segment ids, fp8 V), train_gemma2_dropout's
    timed steps (dropout) and serve_alibi_d256's runs (the paged kernels
    with ALiBi); times at the shapes of time_d256_modes."""
    calls = packed["calls"]

    def launched(kernel, *names):
        return sum(calls[n]["launches"][kernel] for n in names)

    seg_calls = ("d256_op_causal_packed", "d256_op_cross_segment_ids", "d256_nn_padded_causal")
    drop = d256_modes["train_gemma2_dropout"]["launches"]
    serve = d256_modes["serve_alibi_d256"]
    fwd = [
        ("attn_fwd[d256+alibi]", launched("attn_fwd_d256", "d256_op_alibi"),
         "fwd_d256_alibi_prefill_2048", FWD_D256_SOURCE),
        ("attn_fwd[d256+dropout]", drop["attn_fwd"], "fwd_d256_dropout_prefill_2048",
         FWD_D256_SOURCE),
        ("attn_fwd[d256+alibi+dropout]", launched("attn_fwd_d256", "d256_op_alibi_dropout"),
         "fwd_d256_alibi_dropout_prefill_2048", FWD_D256_SOURCE),
        ("attn_fwd[d256+seg]", launched("attn_fwd_d256_seg", *seg_calls),
         "fwd_d256_seg_B2_N8192", FWD_D256_SEG_SOURCE),
        *[(f"attn_fwd[d256+fp8v-{kind}]", launched("attn_fwd_d256", f"d256_fp8v_{kind}"),
           f"fwd_d256_fp8v_{kind}_prefill_2048", FWD_D256_SOURCE) for kind in FP8_V],
    ]
    out = [entry(name, FWD_SM90_SOURCE, FWD_REPLACES, n, timings[case], built_from=src)
           for name, n, case, src in fwd]
    for tag, case, src, counts in (
            ("d256+dropout", "bwd_d256_dropout_B2_H8_N8192", BWD_D256_SOURCE,
             {s: drop[s] for s in ("attn_bwd_dkv", "attn_bwd_dq")}),
            ("d256+alibi", "bwd_d256_alibi_B2_H8_N8192", BWD_D256_SOURCE,
             {s: launched(s + "_d256", "d256_op_alibi") for s in ("attn_bwd_dkv", "attn_bwd_dq")}),
            ("d256+alibi+dropout", "bwd_d256_alibi_dropout_B2_H8_N8192", BWD_D256_SOURCE,
             {s: launched(s + "_d256", "d256_op_alibi_dropout")
              for s in ("attn_bwd_dkv", "attn_bwd_dq")}),
            ("d256+seg", "bwd_d256_seg_B2_H8_N8192", BWD_D256_SEG_SOURCE,
             {s: launched(s + "_d256_seg", *seg_calls) for s in ("attn_bwd_dkv", "attn_bwd_dq")})):
        for name in ("attn_bwd_dkv", "attn_bwd_dq"):
            out.append(entry(f"{name}[{tag}]", BWD_SM90_SOURCE, BWD_REPLACES[name],
                             counts[name], timings[case][name], built_from=src))
    out += [
        entry("paged_decode[d256,bf16+alibi]", DECODE_SOURCE, DECODE_REPLACES,
              serve["bf16"]["launches"]["paged_decode"]
              + serve["bf16_chunked"]["launches"]["paged_decode"],
              timings["decode_d256_bf16_B8_ctx2048_alibi"],
              dec_res["d256_bf16_softcap50_alibi"]["max_abs_err_o"], DECODE_D256_SOURCE),
        entry("paged_decode[d256,int8+alibi]", DECODE_SOURCE, DECODE_REPLACES,
              serve["int8"]["launches"]["paged_decode"],
              timings["decode_d256_int8_B8_ctx2048_alibi"],
              dec_res["d256_int8_softcap50_alibi"]["max_abs_err_o"], DECODE_D256_SOURCE),
        entry("paged_verify[d256,bf16+alibi]", VERIFY_SOURCE, VERIFY_REPLACES,
              serve["bf16_chunked"]["launches"]["paged_verify"],
              timings["verify_d256_bf16_T256_ctx2048_alibi"],
              dec_res["d256_alibi_verify_T256_bf16_softcap"]["max_abs_err_o"],
              VERIFY_D256_SOURCE),
    ]
    return out


def later_entries(entry, gate, encoder):
    """The kernels line's head-dim-64 entries (``entry`` is emit_kernels'
    maker): the causal forward and sweeps of eval_gate's training run (the
    forward also its dense and paged evaluations' prefills), timed at its
    training shape; the non-causal forward and sweeps of the encoder's
    timed steps, timed at its shape; the d64 decode from each KV kind of
    eval_gate's paged runs, timed at its evaluation shape."""
    fwd = gate["train_launches"]["attn_fwd"] + sum(
        counts["attn_fwd"] for counts in gate["eval_launches"].values())
    out = [
        entry("attn_fwd[d64]", FWD_SM90_SOURCE, FWD_REPLACES, fwd, gate["timings"]["attn_fwd"],
              built_from=FWD_D64_SOURCE),
        entry("attn_fwd[d64,noncausal]", FWD_SM90_SOURCE, FWD_REPLACES,
              encoder["launches"]["attn_fwd"], encoder["timings"]["attn_fwd"],
              built_from=FWD_D64_SOURCE),
    ]
    for tag, rec, counts in (("d64", gate, gate["train_launches"]),
                             ("d64,noncausal", encoder, encoder["launches"])):
        for name in ("attn_bwd_dkv", "attn_bwd_dq"):
            out.append(entry(f"{name}[{tag}]", BWD_SM90_SOURCE, BWD_REPLACES[name],
                             counts[name], rec["timings"]["bwd"][name],
                             built_from=BWD_D64_SOURCE))
    for kind in GATE_KINDS:
        out.append(entry(f"paged_decode[d64,{kind}]", DECODE_SOURCE, DECODE_REPLACES,
                         gate["eval_launches"][kind]["paged_decode"],
                         gate["timings"][f"paged_decode_{kind}"], built_from=DECODE_D64_SOURCE))
    return out


# One run of --pair: the tree's own chip_smoke.py builds its kernels and
# times the forward (mode-free at the serving prefill, training and bench
# shapes; ALiBi and ALiBi + dropout at the serving and training shapes),
# the backward family at the training shape (mode-free, ALiBi + dropout,
# and with the packed loader's segment ids of phase packed) with time_fwd /
# time_bwd, and the paged kernels at the timing shapes of phase time
# (decode_serve, decode at 8 and 32 sequences of 2048 tokens from bf16 and
# int8 KV, verify of a 256-token chunk at 2048 from bf16 and int8 KV and
# of 4 tokens at 8 x 2048): each call's ms (CUDA events, warm) and
# device_ms (this script's device_ms after an L2 flush, loaded from SMOKE,
# on the tree's own package); and the serving model's decode step at 4
# slots (phase serve's model and first four prompts, 32 new tokens), its
# median wall ms synchronized around each step.
PAIR_RUN = """
import importlib.util, json, numpy as np, torch
import chip_smoke as c
spec = importlib.util.spec_from_file_location("smoke_change", "SMOKE")
change = importlib.util.module_from_spec(spec)
spec.loader.exec_module(change)
from flash_attention_dlrs_tpu_torch.ops.decode import (
    paged_decode_attention, paged_verify_attention)
dev = torch.device("cuda", 0)
flush = change.l2_flush(dev)
c.phase_build()
gen = torch.Generator(device=dev).manual_seed(3)
out = {}
serve, train = (1, 16, 8, 2048, 128), (8, 32, 8, 2048, 128)
alibi, both = dict(alibi=True), dict(alibi=True, rate=0.1, seed=1)
for name, shape, mod in (("attn_fwd_serve_prefill_2048", serve, {}),
                         ("attn_fwd_train_B8_H32_N2048", train, {}),
                         ("attn_fwd_bench_B8_H16_N4096", (8, 16, 16, 4096, 128), {}),
                         ("attn_fwd[alibi]_serve_prefill_2048", serve, alibi),
                         ("attn_fwd[alibi]_train_B8_H32_N2048", train, alibi),
                         ("attn_fwd[alibi+dropout]_serve_prefill_2048", serve, both),
                         ("attn_fwd[alibi+dropout]_train_B8_H32_N2048", train, both)):
    out[name] = c.time_fwd(gen, dev, *shape, mod)["ms"]
layout = c.loader_layout(np.random.default_rng(0), 8, 2048)
for tag, mod, seg in (("", None, None), ("[alibi+dropout]", both, None),
                      ("[seg]", None, layout)):
    rows = c.time_bwd(dev, gen, 8, 32, 8, 2048, 128, mod=mod, seg=seg)
    for k in ("attn_bwd_dkv", "attn_bwd_dq", "attn_bwd"):
        out[k + tag + "_train_B8_H32_N2048"] = rows[k]["ms"]
serve_lengths = [n + c.SERVE_NEW_TOKENS for n in c.SERVE_PROMPTS[:4]]
for name, kind, b, lengths, t_new in (
        ("decode_serve", "bf16", 4, serve_lengths, 0),
        ("decode_bf16_B8_ctx2048", "bf16", 8, [2048] * 8, 0),
        ("decode_int8_B8_ctx2048", "int8", 8, [2048] * 8, 0),
        ("decode_bf16_B32_ctx2048", "bf16", 32, [2048] * 32, 0),
        ("decode_int8_B32_ctx2048", "int8", 32, [2048] * 32, 0),
        ("verify_bf16_T256_ctx2048", "bf16", 1, [2048], c.CHUNK),
        ("verify_int8_T256_ctx2048", "int8", 1, [2048], c.CHUNK),
        ("verify_bf16_T4_B8_ctx2048", "bf16", 8, [2048] * 8, 4)):
    q, kp, vp, lens, table = c._paged_inputs(
        gen, dev, torch.bfloat16, kind, b, 16, 8, 128, c.SERVE_PAGE, c.SERVE_PPS, lengths,
        num_pages=b * c.SERVE_PPS + 8, t_new=t_new)
    attend = paged_verify_attention if t_new else paged_decode_attention
    call = lambda: attend(q, kp, vp, lens, table, sm_scale=128 ** -0.5)
    out[name] = c.median_ms(call)
    out[name + "_device"] = change.device_ms(call, between=flush)
del q, kp, vp
from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy, params_from_jax
from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine
cfg = ModelConfig(**c.SERVE_CFG, dtype=torch.bfloat16)
model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
engine = DecodeEngine(model, cfg, num_pages=80, page_size=128, num_slots=4, pages_per_seq=17,
                      kv_dtype=torch.bfloat16, device=dev)
engine.generate([[1] * n for n in (128, 256, 512, 1024, 2048)], max_new_tokens=2)  # warm-up
steps = []
engine._decode_step = c._timed(engine._decode_step, steps)
rng = np.random.default_rng(0)
engine.generate([rng.integers(0, cfg.vocab_size, n).tolist() for n in c.SERVE_PROMPTS[:4]],
                max_new_tokens=c.SERVE_NEW_TOKENS)
out["serve_decode_step_ms"] = float(np.median(steps))
print("PAIR " + json.dumps(out), flush=True)
"""


def pair(parent_dir) -> None:
    """The parent/change comparison of the mode-free kernels: PAIR_RUN from
    ``parent_dir`` and from this tree in turns, parent, change, change,
    parent, on one card; raises if a run fails."""
    from pathlib import Path

    trees = {"parent": Path(parent_dir).resolve(), "change": Path(__file__).resolve().parent}
    print(card_line(), flush=True)
    for i, name in enumerate(("parent", "change", "change", "parent")):
        code = PAIR_RUN.replace("SMOKE", str(Path(__file__).resolve()))
        out = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"pair run {i + 1} ({name}) failed:\n{out.stderr[-4000:]}")
        line = next(l for l in out.stdout.splitlines() if l.startswith("PAIR "))
        emit({"phase": "pair", "run": i + 1, "tree": name, "ms": json.loads(line[5:])})


# ---------------------------------------------------------------------------
# Scale-out (parallel/ on torch.distributed).  One card: each phase runs its
# ranks as processes that share cuda:0 in a gloo group (NCCL refuses two
# ranks on one device), so every collective passes through host memory.
# What one card shows: the sharded algorithms are right, each rank launches
# the kernels it should, the zigzag ring balances them.  Its times are
# gloo times of ranks that share one card, not scaling figures.
# ---------------------------------------------------------------------------

PAR_RANKS, PAR_BACKEND, PAR_DEVICE = 4, "gloo", "cuda"
PAR_ATTN = (1, 32, 8, 16384, 128)  # B, Hq, Hkv, global N, d: the training-bench attention
PAR_FP32_N, PAR_COMBINE_NQ, PAR_DROPOUT = 2048, 16, 0.1
PAR_DECODE = (8, 16, 8, 128, 128)  # B, Hq, Hkv, d, page: the serving-bench decode heads
PAR_DECODE_TOKENS = 2048  # a rank's tokens of each sequence, context-sharded
# train_mesh: the training-bench model (TRAIN_CFG, bf16, block remat) at dp 2
# x tp 2, cut to TRAIN_MESH_LAYERS of its 8 layers (cut from 8 for the
# script's time: gloo ranks on one card measure host transport, and every
# layer runs the same exchanges), the global batch TRAIN_BATCH x TRAIN_SEQ,
# TRAIN_MESH_STEPS steps; a 2-layer fp32 copy at B4 x 512 for one step.  The bf16 loss averages 16k tokens' cross
# entropy: a bf16 reordering of the model's sums moves it far less than
# TRAIN_MESH_LOSS_REL of itself.
TRAIN_MESH_STEPS, TRAIN_MESH_LOSS_REL, TRAIN_MESH_LAYERS = 1, 5e-3, 2
TRAIN_MESH_FP32 = (4, 512)
MESH_FP32_GAP = 1e-3  # x std: the fp32 copies' loss and weights
# Adam's first update moves every weight by about lr·sign(g): where g sits at
# the summation-order noise the two runs move it by up to 2 lr apart (3% of
# a weight's std at lr 3e-4), so a handful of weights may pass the limit.
MESH_FP32_LR, MESH_FP32_PAST = 3e-4, 1e-4
# serve_mesh: tp 2, phase serve's 8 requests at 4 slots, 8 new tokens each
# (cut from serve's 32 for the script's time), the model cut to
# SERVE_MESH_LAYERS of its 16 layers (cut for the same reason)
SERVE_MESH_TP, SERVE_MESH_NEW_TOKENS, SERVE_MESH_LAYERS = 2, 8, 4
PAR_EXAMPLES = (("01_attention_features_torch.py", []), ("03_serve_paged_torch.py", []),
                ("04_multichip_mesh_torch.py", ["--world", "4", "--backend", "gloo"]))
# kernels-line entries by kernel symbol (paged decode by its pool kind)
PAR_ENTRIES = {"attn_fwd": "attn_fwd", "attn_fwd_d64": "attn_fwd[d64]",
               "attn_bwd_preprocess": "attn_bwd_preprocess", "attn_bwd_dkv": "attn_bwd_dkv",
               "attn_bwd_dq": "attn_bwd_dq", "attn_bwd_dkv_d64": "attn_bwd_dkv[d64]",
               "attn_bwd_dq_d64": "attn_bwd_dq[d64]"}


def par_group(fn, world, *args, timeout=900):
    """``fn(*args, PAR_DEVICE)`` on ``world`` gloo ranks of the card (a
    failing rank fails the group and raises here); (per-rank results,
    seconds)."""
    from flash_attention_dlrs_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    out = launch(fn, world, *args, PAR_DEVICE, backend=PAR_BACKEND, device=PAR_DEVICE,
                 timeout=timeout)
    return out, time.perf_counter() - t0


def par_record(phase, world, seconds, **rest):
    import torch

    return {"phase": phase, "backend": PAR_BACKEND, "ranks": world,
            "cards": torch.cuda.device_count(), "card": card_line(),
            "timing": f"{PAR_BACKEND}, {world} ranks on one card", "seconds": seconds, **rest}


def entry_launches(ranks, key="launches", kinds=None):
    """The kernels-line launches of a group's runs: per-rank counts summed by
    entry (:data:`PAR_ENTRIES`); ``kinds`` maps a run name to its pool kind,
    whose paged decode launches go to ``paged_decode[<kind>]``."""
    out = {}
    for rank in ranks:
        for name, rec in rank.items():
            for sym, n in rec[key].items():
                entry = PAR_ENTRIES.get(sym)
                if sym == "paged_decode" and kinds and kinds.get(name):
                    entry = f"paged_decode[{kinds[name]}]"
                if entry:
                    out[entry] = out.get(entry, 0) + n
    return out


def par_attention_cases():
    b, hq, hkv, n, d = PAR_ATTN
    shapes = [(b, hq, n, d), (b, hkv, n, d), (b, hkv, n, d), (b, hq, n, d)]
    ctx = ("data", None, "context", None)
    cp = dict(axes=[1, PAR_RANKS], names=("data", "context"), q_spec=ctx, kv_spec=ctx,
              gather=False)
    bf16 = lambda seed, s=shapes: {"seed": seed, "shapes": s, "dtype": "bfloat16"}
    fp32_shapes = [(b, 8, PAR_FP32_N, d), (b, 2, PAR_FP32_N, d), (b, 2, PAR_FP32_N, d),
                   (b, 8, PAR_FP32_N, d)]
    uniform = {"uniform": True, "shapes": shapes[:3], "dtype": "bfloat16"}
    heads = ("data", "model", None, None)
    return [
        dict(name="ring_causal", strategy="ring", kw=dict(causal=True, model_axis=None),
             inputs=bf16(1), grads=True, check=True, **cp),
        dict(name="ring_noncausal", strategy="ring", kw=dict(causal=False, model_axis=None),
             inputs=bf16(2), grads=True, check=True, **cp),
        dict(name="zigzag", strategy="zigzag", kw=dict(model_axis=None), inputs=bf16(3),
             zigzag=True, grads=True, check=True, **cp),
        dict(name="combine", strategy="combine", kw={}, check=True,
             inputs=bf16(4, [(b, hq, PAR_COMBINE_NQ, d)] + shapes[1:3]),
             **{**cp, "q_spec": ("data", None, None, None)}),
        dict(name="head", strategy="head", kw=dict(causal=True), inputs=bf16(5), grads=True,
             check=True, axes=[1, PAR_RANKS], names=("data", "model"), q_spec=heads,
             kv_spec=heads, gather=False),
        dict(name="ring_causal_fp32", strategy="ring", kw=dict(causal=True, model_axis=None),
             inputs={"seed": 6, "shapes": fp32_shapes, "dtype": "float32"}, grads=True,
             check=True, **cp),
        dict(name="ring_dropout", strategy="ring", seed=7, repeat=True, inputs=uniform,
             kw=dict(causal=False, model_axis=None, dropout_rate=PAR_DROPOUT), **cp),
        dict(name="zigzag_dropout", strategy="zigzag", seed=7, repeat=True, inputs=uniform,
             zigzag=True, kw=dict(model_axis=None, dropout_rate=PAR_DROPOUT), **cp),
    ]


def par_expected(name, r, n):
    """The launches rank ``r`` of ``n`` must make in case ``name``: the
    causal ring r + 1 forwards and sweeps (the blocks it sees), the zigzag
    n + 2 on every rank, the non-causal ring n, the combine and the
    head-parallel call one; bf16 on the wgmma route, fp32 on its own."""
    per = {"ring_causal": r + 1, "ring_causal_fp32": r + 1, "ring_noncausal": n,
           "zigzag": n + 2, "combine": 1, "head": 1, "ring_dropout": n,
           "zigzag_dropout": n + 2}[name]
    route = "fp32" if name.endswith("fp32") else "wgmma"
    want = {"attn_fwd": per, f"attn_fwd@{route}": per}
    if name in ("ring_causal", "ring_noncausal", "zigzag", "head", "ring_causal_fp32"):
        for k in ("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq"):
            want[k] = per
        want[f"attn_bwd_dkv@{route}"] = want[f"attn_bwd_dq@{route}"] = per
    return want


def phase_parallel_attention(dev):
    """Ring (causal, non-causal), zigzag, combine and head-parallel attention
    over 4 gloo ranks of the card at the training-bench attention (B1, 32 q /
    8 kv heads of 128, bf16, 16384 tokens: 4096 a rank), forward and
    backward, each rank's shards held against the single-process op on the
    whole sequence on the same card (bf16_check / bwd_check limits); an fp32
    causal ring at 2048 tokens at the fp32 ladder; each rank's launches
    exact (the causal ring's rank r launches r + 1 forwards and sweeps, the
    zigzag's every rank n + 2); ring and zigzag with dropout 0.1 on uniform
    scores: two calls bitwise equal, finite, the kept fraction (read back as
    0.9 x mean O) within 1% of 0.9."""
    from flash_attention_dlrs_tpu_torch.parallel import workloads

    cases = par_attention_cases()
    ranks, seconds = par_group(workloads.attention_cases, PAR_RANKS, cases)
    rec = par_record("parallel_attention", PAR_RANKS, seconds, cases={})
    ok = True
    for case in cases:
        name = case["name"]
        per = [r[name] for r in ranks]
        exact = all(p["launches"] == par_expected(name, i, PAR_RANKS) for i, p in enumerate(per))
        row = {"launches": [p["launches"] for p in per], "launches_exact": exact,
               "seconds": [p["seconds"] for p in per]}
        ok &= exact
        if case.get("check"):
            row["held"] = [p["held"] for p in per]
            ok &= all(h["ok"] for p in per for h in p["held"])
        if case.get("repeat"):
            keep = (1 - PAR_DROPOUT) * float(np.mean([p["mean_o"] for p in per]))
            row.update(keep_rate=keep, bitwise=all(p["bitwise"] for p in per),
                       finite=all(p["finite"] for p in per))
            ok &= (row["bitwise"] and row["finite"]
                   and abs(keep - (1 - PAR_DROPOUT)) <= 0.01 * (1 - PAR_DROPOUT))
        rec["cases"][name] = row
    rec["entry_launches"] = entry_launches(ranks)
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("parallel_attention: a case failed its check (see its line)")
    return rec


def par_decode_cases():
    b, hq, hkv, d, ps = PAR_DECODE
    rng = np.random.default_rng(11)
    per_rank = PAR_DECODE_TOKENS // ps  # pages a rank holds of each sequence
    local_pool = b * per_rank
    # context-sharded: every rank holds 2048 tokens of each sequence, but the
    # last sequence ends 1000 tokens into rank 1 (ranks 2-3 hold none of it)
    tok = np.full((b, PAR_RANKS), PAR_DECODE_TOKENS, np.int32)
    tok[-1, 1:] = 0
    tok[-1, 1] = 1000 * PAR_DECODE_TOKENS // 2048
    tables = np.stack([np.stack([rng.permutation(local_pool)[:per_rank]
                                 for _ in range(PAR_RANKS)]) for _ in range(b)]).astype(np.int32)
    g_tbl = np.zeros((b, PAR_RANKS * per_rank), np.int32)
    for s in range(b):
        pages = [c * local_pool + tables[s, c, j] for c in range(PAR_RANKS)
                 for j in range(-(-int(tok[s, c]) // ps))]
        g_tbl[s, :len(pages)] = pages
    pool = PAR_RANKS * local_pool
    ctx = dict(layout="context", axes=[PAR_RANKS], names=("context",), lengths=tok,
               tables=tables, global_lengths=tok.sum(1).astype(np.int32), global_tables=g_tbl,
               check=True, gather=False)
    shapes = [(b, hq, d), (hkv, pool, ps, d), (hkv, pool, ps, d)]
    # head-sharded: the serving pool of phase serve (17 pages a sequence)
    h_pool = b * SERVE_PPS + 1
    h_tbl = rng.permutation(h_pool)[: b * SERVE_PPS].reshape(b, SERVE_PPS).astype(np.int32)
    h_len = np.array(DECODE_B8_LENGTHS, np.int32)
    head = dict(layout="head", lengths=h_len, tables=h_tbl, global_lengths=h_len,
                global_tables=h_tbl, check=True, gather=False)
    h_shapes = [(b, hq, d), (hkv, h_pool, ps, d), (hkv, h_pool, ps, d)]
    cases = []
    for kind in ("bf16", "int8"):
        cases.append(dict(name=f"context_{kind}", kind=kind,
                          inputs={"seed": 21, "shapes": shapes, "dtype": "bfloat16"}, **ctx))
        for tp, axes in ((2, [2, 2]), (4, [1, 4])):
            cases.append(dict(name=f"head_tp{tp}_{kind}", kind=kind, axes=axes,
                              names=("data", "model"),
                              inputs={"seed": 22, "shapes": h_shapes, "dtype": "bfloat16"},
                              **head))
    return cases


def phase_parallel_decode(dev):
    """Context-sharded paged decode (4 ranks x 2048 tokens of each of 8
    sequences, one sequence on 1.5 ranks only) and head-sharded decode (tp 2
    with the batch over 2 data ranks, tp 4) at the serving-bench decode
    heads (16 q / 8 kv of 128, page 128, B8) from bf16 and int8 pools, over
    4 gloo ranks of the card, each held against the single-process paged
    decode of the whole context on the same card (decode_check's limits,
    with P|V| for the partials each rounded to bf16)."""
    from flash_attention_dlrs_tpu_torch.parallel import workloads

    cases = par_decode_cases()
    ranks, seconds = par_group(workloads.decode_cases, PAR_RANKS, cases)
    rec = par_record("parallel_decode", PAR_RANKS, seconds, cases={})
    ok = True
    for case in cases:
        per = [r[case["name"]] for r in ranks]
        launched = all(p["launches"].get("paged_decode", 0) == 1 for p in per)
        held = all(h["ok"] for p in per for h in p["held"])
        ok &= launched and held
        rec["cases"][case["name"]] = {
            "launches": [p["launches"] for p in per], "one_launch_a_rank": launched,
            "held": [p["held"][0] for p in per], "seconds": [p["seconds"] for p in per]}
    rec["entry_launches"] = entry_launches(
        ranks, kinds={c["name"]: c["kind"] for c in cases})
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("parallel_decode: a case failed its check (see its line)")
    return rec


def phase_train_mesh(dev):
    """The training-bench model at full width (TRAIN_CFG: b7 widths, bf16,
    block remat; TRAIN_MESH_LAYERS of its 8 layers) trained dp 2 x tp 2
    over 4 gloo ranks of the card, global batch 8 x 2048, TRAIN_MESH_STEPS steps: each step's loss
    held against the single-process steps on the same batch and weights
    (run on the same card by rank 0 after the mesh run, from the weights
    it drew), every rank's launches exact (2 forwards and one of each
    backward kernel a layer and step, on the wgmma route); a 2-layer fp32
    copy (B4 x 512, one step) against the single-process step on every
    rank: the loss within 1e-3 of itself, each rank's shard of the updated
    weights within 1e-3 x std of the same shard but for a fraction
    MESH_FP32_PAST, none past 2 lr."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import ModelConfig
    from flash_attention_dlrs_tpu_torch.parallel import workloads

    import tempfile

    cfg = ModelConfig(**{**TRAIN_CFG, "n_layers": TRAIN_MESH_LAYERS}, dtype=torch.bfloat16,
                      remat=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int64)
    b32, n32 = TRAIN_MESH_FP32
    cfg32 = ModelConfig(**{**TRAIN_CFG, "n_layers": 2}, dtype=torch.float32, remat=True)
    tok32 = rng.integers(0, cfg.vocab_size, (b32, n32 + 1)).astype(np.int64)
    with tempfile.TemporaryDirectory() as tmp:  # the seed-0 weights, drawn once a run
        saved = {}
        for name, c in (("bf16", cfg), ("fp32", cfg32)):
            os.mkdir(os.path.join(tmp, name))
            saved[name] = workloads.save_weights(seeded_weights(c), os.path.join(tmp, name))
        runs = [dict(name="bf16", cfg=cfg, params=saved["bf16"], tokens=tokens, axes=[2, 2],
                     steps=TRAIN_MESH_STEPS, gather=False, reference="losses"),
                dict(name="fp32_2layer", cfg=cfg32, params=saved["fp32"], tokens=tok32,
                     axes=[2, 2], steps=1, gather=False, reference="weights",
                     learning_rate=MESH_FP32_LR, gap_limit=MESH_FP32_GAP)]
        ranks, seconds = par_group(workloads.models_suite, PAR_RANKS, runs, [])
    per = [r["bf16"] for r in ranks]
    n_fwd = 2 * cfg.n_layers * TRAIN_MESH_STEPS
    n_bwd = cfg.n_layers * TRAIN_MESH_STEPS
    want = {"attn_fwd": n_fwd, "attn_fwd@wgmma": n_fwd,
            **dict.fromkeys(("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq",
                             "attn_bwd_dkv@wgmma", "attn_bwd_dq@wgmma"), n_bwd)}
    exact = all(p["launches"] == want for p in per)
    losses, single = per[0]["losses"], per[0]["ref_losses"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, single))
    f32 = ranks[0]["fp32_2layer"]
    f32_loss_gap = abs(f32["losses"][0] - f32["ref_losses"][0]) / abs(f32["ref_losses"][0])
    gaps = [r["fp32_2layer"]["weight_gaps"] for r in ranks]
    weights_ok = all(g["frac_past_limit"] <= MESH_FP32_PAST
                     and g["max_abs_gap"] <= 2 * MESH_FP32_LR for g in gaps)
    ok = (exact and all(p["losses"] == losses for p in per) and weights_ok
          and loss_gap <= TRAIN_MESH_LOSS_REL and f32_loss_gap <= MESH_FP32_GAP
          and all(np.isfinite(losses)))
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    rec = par_record(
        "train_mesh", PAR_RANKS, seconds, mesh={"data": 2, "model": 2}, model="training-bench",
        layers=cfg.n_layers, batch=[TRAIN_BATCH, TRAIN_SEQ], losses=losses,
        single_process_losses=single,
        loss_gap_rel=loss_gap, loss_limit_rel=TRAIN_MESH_LOSS_REL,
        launches=[p["launches"] for p in per], launches_exact=exact,
        step_seconds=[p["step_seconds"] for p in per],
        tokens_per_s=[tokens_per_step / s for s in per[0]["step_seconds"]],
        fp32_2layer={"losses": f32["losses"], "ref_losses": f32["ref_losses"],
                     "loss_gap_rel": f32_loss_gap, "loss_limit_rel": MESH_FP32_GAP,
                     "weights_by_rank": gaps, "weights_ok": weights_ok,
                     "weights_rule": f"at most {MESH_FP32_PAST:g} of the weights past "
                                     f"{MESH_FP32_GAP:g} x std, none past 2 lr"},
        entry_launches=entry_launches(ranks), ok=bool(ok))
    emit(rec)
    if not ok:
        raise AssertionError("train_mesh: a check failed (see its line)")
    return rec


def phase_serve_mesh(dev):
    """The serving-bench model at full width (SERVE_CFG: d_model 2048, 16 q
    / 8 kv heads; SERVE_MESH_LAYERS of its 16 layers) served tensor-parallel, tp 2
    over 2 gloo ranks of the card: phase serve's 8 requests at 4 slots
    (SERVE_MESH_NEW_TOKENS new tokens each) from bf16 and int8 KV, greedy tokens against the single-process engine on
    the same card (bf16 / int8 may part only at near-ties, divergences), the
    tokens equal on both ranks, each rank's pools holding 4 of the 8 kv
    heads; a 2-layer fp32 copy's tokens equal to the single-process
    engine's."""
    import tempfile

    import torch
    from flash_attention_dlrs_tpu_torch.parallel import workloads

    model, cfg = serving_bench_model(dev, n_layers=SERVE_MESH_LAYERS)
    prompts = serve_prompts(cfg)
    kw = lambda kv: dict(num_pages=4 * SERVE_PPS + 1, page_size=SERVE_PAGE, num_slots=4,
                         pages_per_seq=SERVE_PPS, kv_dtype=kv_kind(kv),
                         quantized_kv=kv in QUANT_KINDS)
    single = {}
    for kv in ("bf16", "int8"):
        single[kv] = serve_engine(model, cfg, dev, kv=kv).generate(
            prompts, max_new_tokens=SERVE_MESH_NEW_TOKENS)
        torch.cuda.empty_cache()
    model32, cfg32 = serving_bench_model(dev, torch.float32, 2)
    single["fp32_2layer"] = serve_engine(model32, cfg32, dev, kv="fp32").generate(
        prompts, max_new_tokens=SERVE_MESH_NEW_TOKENS)
    del model32
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:  # the seed-0 weights, drawn once a run
        weights = workloads.save_weights(seeded_weights(cfg), tmp)
        runs = [dict(name=kv, cfg=cfg, params=weights, prompts=prompts,
                     new_tokens=SERVE_MESH_NEW_TOKENS, axes=[SERVE_MESH_TP], names=("model",),
                     engine_kw=kw(kv)) for kv in ("bf16", "int8")]
        runs.append(dict(name="fp32_2layer", cfg=cfg32, params=0, prompts=prompts,
                         new_tokens=SERVE_MESH_NEW_TOKENS, axes=[SERVE_MESH_TP],
                         names=("model",), engine_kw=kw("fp32")))
        ranks, seconds = par_group(workloads.models_suite, SERVE_MESH_TP, [], runs)
    rec = par_record("serve_mesh", SERVE_MESH_TP, seconds, model="serving-bench",
                     layers=cfg.n_layers, mesh={"model": SERVE_MESH_TP}, runs={})
    ok = True
    for run in runs:
        name = run["name"]
        per = [r[name] for r in ranks]
        got = per[0]["tokens"]["generate"]
        want = [list(map(int, t)) for t in single[name]]
        row = {"equal_on_every_rank": all(p["all_ranks_equal"] for p in per),
               "pool_heads": [p["pool_heads"] for p in per],
               "launches": [p["launches"] for p in per],
               "seconds": [p["seconds"]["generate"] for p in per],
               "tokens_equal_single_process": got == want}
        ok &= row["equal_on_every_rank"] and all(
            h == cfg.n_kv_heads // SERVE_MESH_TP for h in row["pool_heads"])
        ok &= all(p["launches"].get("attn_fwd", 0) > 0 and p["launches"].get("paged_decode", 0) > 0
                  for p in per)
        if name == "fp32_2layer":
            ok &= row["tokens_equal_single_process"]
        else:
            row["divergences"] = divergences(model, cfg, dev, prompts, want, got)
            row["near_ties_only"] = near_ties_only(row["divergences"])
            ok &= row["near_ties_only"]
        rec["runs"][name] = row
    del model
    torch.cuda.empty_cache()
    rec["entry_launches"] = entry_launches(ranks, kinds={"bf16": "bf16", "int8": "int8"})
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("serve_mesh: a check failed (see its line)")
    return rec


def phase_dryrun(dev):
    """parallel/dryrun.py over 4 gloo ranks of the card: a dp 2 x tp 2 train
    step with dropout 0.1, ring fwd + bwd with dropout, the zigzag ring
    against the oracle (< 2e-4), context-sharded paged decode and a tp 2
    engine's generate."""
    from flash_attention_dlrs_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    steps = dryrun_multichip(PAR_RANKS, device=PAR_DEVICE, backend=PAR_BACKEND)
    rec = par_record("dryrun", PAR_RANKS, time.perf_counter() - t0, steps=steps,
                     ok=[s["step"] for s in steps] == ["train", "ring", "zigzag",
                                                       "context_decode", "engine"],
                     entry_launches=entry_launches(
                         [{s["step"]: {"launches": n} for s in steps
                           for n in [s["launches_by_rank"][r]]} for r in range(PAR_RANKS)]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("dryrun: steps missing")
    return rec


def phase_examples(dev):
    """examples/01, 03 and 04 (--world 4 --backend gloo) of the port on the
    card, each in a process of its own, the three at once."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(root / "examples" / name), *args],
                                    cwd=root, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in PAR_EXAMPLES}
    runs, failed = {}, []
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        runs[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                      "tail": out.strip().splitlines()[-3:]}
        if proc.returncode:
            failed.append(f"{name}:\n{err[-3000:]}")
    rec = par_record("examples", PAR_RANKS, time.perf_counter() - t0, runs=runs)
    emit(rec)
    if failed:
        raise RuntimeError("examples failed: " + "\n".join(failed))
    return rec


# ---------------------------------------------------------------------------
# Head dims above 256 (csrc/wide.cuh): the wide kernels held against their
# plain versions, a broken copy caught, their times; the serving- and
# training-bench models re-headed at head dim 512 served and trained on them
# ---------------------------------------------------------------------------

# the wide kernels' body, and the source each is built from
WIDE_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/wide.cuh"
WIDE_BUILDS = {"attn_fwd": "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_wide.cu",
               "attn_bwd": "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_wide.cu",
               "paged_decode": "flash_attention_dlrs_tpu_torch/csrc/paged_decode_wide.cu",
               "paged_decode_chunk": "flash_attention_dlrs_tpu_torch/csrc/paged_decode_chunk.cu",
               "paged_verify": "flash_attention_dlrs_tpu_torch/csrc/paged_verify_wide.cu"}
# route wide_scores (bf16 / fp16 forward and sweeps above 1024): the passes'
# body and the two sources it is built as
SCORES_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/wide_scores.cuh"
SCORES_BUILDS = {"fwd": "flash_attention_dlrs_tpu_torch/csrc/attn_fwd_scores.cu",
                 "bwd": "flash_attention_dlrs_tpu_torch/csrc/attn_bwd_scores.cu"}
# The bench models re-headed at head dim 512: every projection keeps its
# bench shape (serving 16 q x 128 = 4 q x 512 and 8 kv x 128 = 2 kv x 512;
# training 32 x 128 = 8 x 512 and 8 x 128 = 2 x 512), so parameters, GEMMs
# and attention FLOPs stay the bench models'; only the head width changes.
D512_SERVE_HEADS = dict(n_q_heads=4, n_kv_heads=2, head_dim=512)
D512_TRAIN_HEADS = dict(n_q_heads=8, n_kv_heads=2, head_dim=512)
SERVE_RE_HEADED_NEW_TOKENS = 16
TRAIN_RE_HEADED_WARM, TRAIN_RE_HEADED_TIMED = 1, 2
# The bench models re-headed at head dim 2048, above the wgmma cuts (every
# 16-bit forward and backward on route "wide_scores", every verify on
# "wide_chunk"): the q projections keep their
# bench shapes (serving 16 x 128 = 1 x 2048, training 32 x 128 = 2 x 2048);
# the kv projections cannot (one kv head of 2048 is twice serving's 8 x 128
# and as wide as training's 8 x 128 x 2).
D2048_SERVE_HEADS = dict(n_q_heads=1, n_kv_heads=1, head_dim=2048)
D2048_TRAIN_HEADS = dict(n_q_heads=2, n_kv_heads=1, head_dim=2048)
# The 16-bit wide forward (csrc/wide.cuh wide_wgmma_kernel) broken in its
# exchange of partial scores, the class of fault the split of the head dim
# among owners can bring: S summed without the last owner's partial, and S
# summed with each owner's own partial in place of its peers'.
# fwd_check's wide cases at d 512 and 640 must catch each.  A mutant builds
# only the cuts of those two widths (the other widths' launches refuse,
# and none of its cases makes one), a third of the wide_wgmma instances, so
# that its compile takes less of the host beside the serving phases.
_WIDE_MUTANT_ONLY_512_640 = [
    (f"    case {d}: return launch_wgmma_cut<T, PAGED, {cut}>(a, tm_q, tm_k, tm_v, tma, grid);",
     f"    case {d}: return int(cudaErrorInvalidValue);")
    for d, cut in ((384, "1, 2, 3"), (768, "2, 2, 3"), (896, "7, 1, 2"), (1024, "2, 2, 4"))]
# The 16-bit wide sweeps (wide_bwd_dkv_kernel, wide_bwd_dq_kernel) broken
# alike in their exchange (BwdExchange, shared by both): dP summed without
# the last owner's partial, and S summed with each owner's own partial in
# place of its peers'.  bwd_check's wide cases at d 512 and 640 must catch
# each; the mutants build only those widths' cuts.
_WIDE_BWD_MUTANT_ONLY_512_640 = [
    (f"      case {d}: return launch_bwd_cut<T, true, {cut}>(a, maps, grid);",
     f"      case {d}: return int(cudaErrorInvalidValue);")
    for d, cut in ((384, "3, 1, 2"), (768, "6, 1, 2"), (896, "7, 1, 2"), (1024, "8, 1, 2"))] + [
    (f"    case {d}: return launch_bwd_cut<T, false, {cut}>(a, maps, grid);",
     f"    case {d}: return int(cudaErrorInvalidValue);")
    for d, cut in ((384, "3, 1, 2"), (768, "3, 1, 4"), (896, "7, 1, 2"), (1024, "4, 1, 4"))]
# The column-chunked forward (csrc/wide.cuh wide_fwd_chunk_kernel, fp32 and
# verify since route wide_scores took the 16-bit forward above 1024) broken
# in its score sum: S summed without the head dim's last streamed slice (32
# columns in fp32).  fwd_check's fp32 cases at d 1152 must catch it.  It
# builds the column-chunked instances alone (the wgmma cuts' launches edited
# to refuse), so its compile is a few seconds.
_WIDE_CHUNK_MUTANT_ONLY = [
    (f"    case {d}: return launch_wgmma_cut<T, PAGED, {cut}>(a, tm_q, tm_k, tm_v, tma, grid);",
     f"    case {d}: return int(cudaErrorInvalidValue);")
    for d, cut in ((384, "1, 2, 3"), (512, "1, 2, 4"), (640, "5, 1, 2"), (768, "2, 2, 3"),
                   (896, "7, 1, 2"), (1024, "2, 2, 4"))]
WIDE_MUTANTS = {
    "wide_chunk_drops_last_slice": ("attn_fwd_wide.cu", "wide.cuh", [(
        "const int nc = cols / L::KC;  // the head dim's slices, every one summed",
        "const int nc = (cols - 32) / L::KC;  // the head dim's slices, every one summed"),
    ] + _WIDE_CHUNK_MUTANT_ONLY),
    "wide_fwd_drops_last_chunk": ("attn_fwd_wide.cu", "wide.cuh", [(
        "for (int p = 0; p < OWNERS; ++p) {  // every owner's partial, in owner order",
        "for (int p = 0; p < OWNERS - 1; ++p) {  // every owner's partial, in owner order"),
    ] + _WIDE_MUTANT_ONLY_512_640),
    "wide_fwd_adds_own_partial": ("attn_fwd_wide.cu", "wide.cuh", [(
        "const int src = p;  // the owner whose partial is added",
        "const int src = p == 0 ? p : me;  // the owner whose partial is added"),
    ] + _WIDE_MUTANT_ONLY_512_640),
    "wide_bwd_drops_last_dp": ("attn_bwd_wide.cu", "wide.cuh", [(
        "for (int p = 0; p < OWNERS; ++p) {  // dP: each owner's partial in owner order",
        "for (int p = 0; p < OWNERS - 1; ++p) {  // dP: each owner's partial in owner order"),
    ] + _WIDE_BWD_MUTANT_ONLY_512_640),
    "wide_bwd_adds_own_s": ("attn_bwd_wide.cu", "wide.cuh", [(
        "const int src_s = p;  // the owner whose S partial is added",
        "const int src_s = p == 0 ? p : me;  // the owner whose S partial is added"),
    ] + _WIDE_BWD_MUTANT_ONLY_512_640),
    # route wide_scores' forward (csrc/wide_scores.cuh): its score pass
    # summing S without the head dim's last 64-column slice, and its product
    # pass leaving out the last key tile a q tile sees; fwd_check's 16-bit
    # cases at d 1152 must catch each
    "scores_drops_last_slice": ("attn_fwd_scores.cu", "wide_scores.cuh", [(
        "return D / SLICE;  // every slice of the head dim, summed in order",
        "return D / SLICE - 1;  // every slice of the head dim, summed in order")]),
    "product_drops_last_key_tile": ("attn_fwd_scores.cu", "wide_scores.cuh", [(
        "for (int kt = tr.lo; kt < tr.hi; ++kt) {  // every key tile the q tile sees, in order",
        "for (int kt = tr.lo; kt < tr.hi - 1; ++kt) {  // every key tile the q tile sees, in order")]),
}
WIDE_MUTANT_BUILDS = None  # started by phase_build(mutants=True)
WIDE_WIDTHS = (384, 512, 640)  # the kernel widths of the checks; 1024, the cuts' widest, below
WIDE_ALL = (384, 512, 640, 768, 896, 1024)  # every width of the wgmma cuts
CHUNK_WIDTHS = (1152, 1408, 2048, 8192)  # column-chunked widths the checks reach
# the op API and the nn adapter at head dims the op pads (320 -> 384, 1100 ->
# 1152, column-chunked) and does not (640): (B, Hq, Hkv, Nq, Nkv, d)
WIDE_OP_SHAPES = {320: (2, 4, 2, 300, 300, 320), 640: (2, 4, 2, 257, 257, 640),
                  1100: (2, 4, 2, 300, 300, 1100)}


def _wide_fwd_modes(d):
    """fwd_check cases of the wide forward at kernel width ``d``: every mode
    (GQA, tails, window, softcap, ALiBi, dropout, segment ids with rows that
    see nothing, fp8 V) in bf16, fp16 and fp32."""
    import torch

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    both = dict(alibi=True, rate=0.1, seed=-5)
    tag = f"d{d}"
    return [
        (f"{tag}_causal_gqa_bf16", bf16, 1, 8, 2, 300, 300, d, True, 0, 0.0, {}),
        (f"{tag}_noncausal_tail_fp16", f16, 2, 4, 2, 130, 200, d, False, 0, 0.0, {}),
        (f"{tag}_window_softcap_bf16", bf16, 1, 4, 1, 257, 257, d, True, 100, 30.0, {}),
        (f"{tag}_alibi_dropout_fp16", f16, 2, 4, 2, 333, 333, d, True, 0, 0.0, both),
        (f"{tag}_seg_packed_bf16", bf16, 2, 4, 2, 300, 300, d, True, 0, 0.0,
         dict(seg="packed")),
        (f"{tag}_seg_cross_fp16", f16, 1, 4, 2, 300, 700, d, False, 0, 0.0, dict(seg="cross")),
        (f"{tag}_fp8v_e4m3_bf16", bf16, 1, 4, 2, 300, 300, d, True, 0, 0.0, dict(v8="e4m3")),
        (f"{tag}_fp8v_e5m2_fp16_window", f16, 1, 4, 2, 200, 300, d, True, 63, 0.0,
         dict(v8="e5m2")),
        (f"{tag}_empty_rows_bf16", bf16, 1, 4, 2, 300, 200, d, True, 0, 0.0, {}),
        (f"{tag}_fp32_causal_gqa", f32, 1, 4, 2, 200, 200, d, True, 0, 0.0, {}),
        (f"{tag}_fp32_window_softcap_alibi_dropout", f32, 1, 4, 2, 130, 161, d, True, 50, 25.0,
         both),
        (f"{tag}_fp32_seg_cross_fp8v_e5m2", f32, 1, 2, 1, 200, 500, d, False, 0, 0.0,
         dict(seg="cross", v8="e5m2")),
    ]


def wide_fwd_cases():
    """fwd_check cases of the wide forward at d 384, 512 and 640 in every
    mode and dtype (:func:`_wide_fwd_modes`), the bench models' shapes, d
    1024, the cuts' widest, and bf16 at 768 and 896, whose cuts of the head
    dim (clusters of 2 and 7 CTAs) no other width takes."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    both = dict(alibi=True, rate=0.1, seed=-5)
    return [c for d in WIDE_WIDTHS for c in _wide_fwd_modes(d)] + [
        ("d512_train_B8_H8_N2048", bf16, 8, 8, 2, 2048, 2048, 512, True, 0, 0.0, {}),
        ("d512_serve_prefill_2048", bf16, 1, 4, 2, 2048, 2048, 512, True, 0, 0.0, {}),
        ("d1024_causal_bf16", bf16, 1, 2, 1, 256, 256, 1024, True, 0, 0.0, {}),
        # the widths whose cut (csrc/wide.cuh wide_cut) the others do not reach
        ("d768_causal_gqa_bf16", bf16, 1, 4, 2, 300, 300, 768, True, 0, 0.0, {}),
        ("d896_causal_gqa_bf16", bf16, 1, 4, 2, 300, 300, 896, True, 0, 0.0, {}),
        ("d1024_fp32_window_softcap_alibi_dropout", f32, 1, 2, 1, 130, 161, 1024, True, 50,
         25.0, both),
    ]


def chunk_fwd_cases():
    """fwd_check cases of the column-chunked forward above 1024: every mode
    and dtype at d 1152 (9 chunks), causal GQA at 1408 (11 chunks, a prime
    count no cluster cut takes), the re-headed models' shapes at 2048 and a
    tiny call at 8192."""
    import torch

    bf16 = torch.bfloat16
    return _wide_fwd_modes(1152) + [
        ("d1408_causal_gqa_bf16", bf16, 1, 4, 2, 300, 300, 1408, True, 0, 0.0, {}),
        ("d2048_train_B8_H2_N2048", bf16, 8, 2, 1, 2048, 2048, 2048, True, 0, 0.0, {}),
        ("d2048_serve_prefill_2048", bf16, 1, 1, 1, 2048, 2048, 2048, True, 0, 0.0, {}),
        ("d8192_causal_bf16", bf16, 1, 2, 1, 130, 130, 8192, True, 0, 0.0, {}),
    ]


def _wide_bwd_modes(d):
    """bwd_check cases of the wide sweeps at kernel width ``d``: every mode
    but fp8 V, in bf16, fp16 and fp32."""
    tag = f"d{d}"
    return [
        (f"{tag}_causal_gqa_bf16", BF16, 1, 4, 2, 300, 300, d, True, 0, 0.0, None, {}),
        (f"{tag}_window_softcap_fp16", F16, 1, 4, 1, 257, 257, d, True, 100, 30.0, None, {}),
        (f"{tag}_noncausal_cross_bf16", BF16, 2, 4, 2, 130, 300, d, False, 0, 0.0, None, {}),
        (f"{tag}_alibi_dropout_seg_bf16", BF16, 2, 4, 2, 333, 333, d, True, 0, 0.0, None,
         dict(_BOTH, seg="packed")),
        (f"{tag}_empty_rows_fp16", F16, 1, 4, 2, 300, 200, d, True, 0, 0.0, None, {}),
        (f"{tag}_fp32_causal", F32, 1, 2, 1, 200, 200, d, True, 0, 0.0, None, {}),
        (f"{tag}_fp32_window_softcap_alibi_dropout", F32, 1, 4, 2, 300, 300, d, True, 100,
         25.0, None, _BOTH),
        (f"{tag}_fp32_seg_cross", F32, 1, 2, 1, 200, 500, d, True, 0, 0.0, None,
         dict(seg="cross")),
    ]


def wide_bwd_cases():
    """bwd_check cases of the wide sweeps at d 384, 512, 640 and 1024 (the
    cuts' widest) in every mode and dtype (:func:`_wide_bwd_modes`), the
    training model's attention, and bf16 at 768 and 896, whose cuts of the
    head dim (clusters of 6 and 3 CTAs, of 7) no other width takes."""
    return [c for d in WIDE_WIDTHS for c in _wide_bwd_modes(d)] + [
        ("d512_train_B2_H8_N2048", BF16, 2, 8, 2, 2048, 2048, 512, True, 0, 0.0, None, {}),
        ("d1024_alibi_dropout_seg_bf16", BF16, 1, 2, 1, 300, 300, 1024, True, 0, 0.0, None,
         dict(_BOTH, seg="packed")),
        ("d1024_fp32_window_softcap", F32, 1, 2, 1, 200, 200, 1024, True, 64, 25.0, None, {}),
        ("d768_causal_gqa_bf16", BF16, 1, 4, 2, 300, 300, 768, True, 0, 0.0, None, {}),
        ("d896_window_softcap_alibi_bf16", BF16, 1, 4, 2, 257, 257, 896, True, 100, 30.0,
         None, _ALIBI),
    ]


def chunk_bwd_cases():
    """bwd_check cases of the column-chunked sweeps above 1024: every mode
    and dtype at d 1152, causal GQA at 1408, the re-headed training model's
    attention at 2048 (two of its rows) and a tiny call at 8192."""
    return _wide_bwd_modes(1152) + [
        ("d1408_causal_gqa_bf16", BF16, 1, 4, 2, 300, 300, 1408, True, 0, 0.0, None, {}),
        ("d2048_train_B2_H2_N2048", BF16, 2, 2, 1, 2048, 2048, 2048, True, 0, 0.0, None, {}),
        ("d8192_causal_bf16", BF16, 1, 2, 1, 130, 130, 8192, True, 0, 0.0, None, {}),
    ]


def _wide_split_edges(b, d, ps, num_sms, hkv=None):
    """(pages_per_seq, lengths) of the key-split edges at page size ``ps``
    over a table of 2176 tokens: lengths 0, 1, on the first split boundary
    the planner gives, one past it and the full table (the first ``b``)."""
    from flash_attention_dlrs_tpu_torch.ops.decode import decode_splits, split_pages

    hkv = hkv or D512_SERVE_HEADS["n_kv_heads"]
    pps = 2176 // ps
    per, _ = split_pages(pps, decode_splits(b, hkv, pps, ps, num_sms))
    return pps, [0, 1, per * ps, per * ps + 1, pps * ps][:b]


def _wide_paged_modes(d, num_sms):
    """decode_check cases of the wide paged kernels at pool width ``d``, at
    the serving-d512 model's heads: the key-split edges at page sizes 16 and
    128, every pool kind, softcap and ALiBi; verify at T = 1, 4, 64, 255 and
    256 with row horizons inside tiles; quantized pools from bf16 (or fp32)
    q, value pools of q's dtype."""
    import torch

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    hq, hkv, table = D512_SERVE_HEADS["n_q_heads"], D512_SERVE_HEADS["n_kv_heads"], 2176
    tag = f"d{d}"
    pps, lengths = _wide_split_edges(5, d, 128, num_sms)
    cases = [(f"{tag}_edges_{kind}_page128_B5", bf16, kind, (5, hq, hkv, d, 128, pps, lengths),
              0.0, 0, False) for kind in ("bf16", "int4")]
    pps16, lengths16 = _wide_split_edges(5, d, 16, num_sms)
    cases.append((f"{tag}_edges_int8_page16_softcap_alibi_B5", bf16, "int8",
                  (5, hq, hkv, d, 16, pps16, lengths16), 30.0, 0, True))
    # int4 pages of 16 store 8 rows: decode's rows copied one by one
    cases.append((f"{tag}_edges_int4_page16_B5", bf16, "int4",
                  (5, hq, hkv, d, 16, pps16, lengths16), 0.0, 0, False))
    serve = (8, hq, hkv, d, 128, 17, DECODE_B8_LENGTHS)
    small = (3, 8, 2, d, 64, 8, [0, 300, 512])
    cases += [(f"{tag}_decode_{kind}_B8", bf16, kind, serve, 0.0, 0, False)
              for kind in ("e4m3", "e5m2")]
    cases += [
        (f"{tag}_decode_fp16_softcap_alibi", f16, "fp16", small, 30.0, 0, True),
        (f"{tag}_decode_fp32_int8_alibi", f32, "int8", small, 0.0, 0, True),
        (f"{tag}_decode_fp32_values", f32, "fp32", small, 0.0, 0, False),
    ]
    horizons = (2, hq, hkv, d, 128, 17, [1000, 1717])
    cases += [(f"{tag}_verify_T{t}_bf16", bf16, "bf16", horizons, 0.0, t, False)
              for t in (1, 4, 255, 256)]
    cases += [(f"{tag}_verify_T64_{kind}_softcap_alibi", bf16, kind, horizons, 30.0, 64, True)
              for kind in QUANT_KINDS]
    return cases + [
        (f"{tag}_verify_T4_fp16", f16, "fp16", horizons, 0.0, 4, False),
        (f"{tag}_verify_T5_fp32_int4_alibi", f32, "int4", small, 0.0, 5, True),
        (f"{tag}_verify_T32_fp32_values", f32, "fp32", (2, hq, hkv, d, 128, 17, [40, 2100]),
         0.0, 32, False),
        (f"{tag}_verify_T256_bf16_page16_alibi", bf16, "bf16",
         (2, hq, hkv, d, 16, table // 16, [1000, 1717]), 0.0, 256, True),
    ]


def wide_paged_cases(num_sms):
    """decode_check cases of the wide paged kernels at pool widths 384, 512
    and 640 in every mode (:func:`_wide_paged_modes`) and at 1024, the cuts'
    widest."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    hq, hkv = D512_SERVE_HEADS["n_q_heads"], D512_SERVE_HEADS["n_kv_heads"]
    pps, lengths = _wide_split_edges(5, 1024, 128, num_sms)
    return [c for d in WIDE_WIDTHS for c in _wide_paged_modes(d, num_sms)] + [
        ("d1024_edges_int8_page128_softcap_alibi_B5", bf16, "int8",
         (5, hq, hkv, 1024, 128, pps, lengths), 30.0, 0, True),
        ("d1024_decode_fp32_values", f32, "fp32", (3, 8, 2, 1024, 64, 8, [0, 300, 512]), 0.0,
         0, False),
        ("d1024_verify_T64_int4_softcap_alibi", bf16, "int4",
         (2, hq, hkv, 1024, 128, 17, [1000, 1717]), 30.0, 64, True),
        ("d1024_verify_T5_fp32_values", f32, "fp32", (3, 8, 2, 1024, 64, 8, [0, 300, 512]),
         0.0, 5, False),
    ]


def chunk_paged_cases(num_sms):
    """decode_check cases of the column-chunked paged kernels above 1024:
    every mode, pool kind and q dtype at d 1152 (:func:`_wide_paged_modes`),
    decode and verify from bf16 q at 1408, the re-headed serving model's
    heads at 2048 (decode of 8 sequences from bf16 and int8 pools, a chunk
    of 256 verified) and a tiny pair of calls at 8192."""
    import torch

    bf16 = torch.bfloat16
    hq, hkv = D512_SERVE_HEADS["n_q_heads"], D512_SERVE_HEADS["n_kv_heads"]
    s_hq, s_hkv = D2048_SERVE_HEADS["n_q_heads"], D2048_SERVE_HEADS["n_kv_heads"]
    serve = (8, s_hq, s_hkv, 2048, 128, 17, DECODE_B8_LENGTHS)
    tiny = (2, 2, 1, 8192, 64, 4, [130, 200])
    return _wide_paged_modes(1152, num_sms) + [
        ("d1408_decode_bf16_B8", bf16, "bf16", (8, hq, hkv, 1408, 128, 17, DECODE_B8_LENGTHS),
         0.0, 0, False),
        ("d1408_verify_T64_bf16", bf16, "bf16", (2, hq, hkv, 1408, 128, 17, [1000, 1717]),
         0.0, 64, False),
        ("d2048_decode_bf16_B8", bf16, "bf16", serve, 0.0, 0, False),
        ("d2048_decode_int8_B8", bf16, "int8", serve, 0.0, 0, False),
        ("d2048_verify_T256_bf16", bf16, "bf16", (1, s_hq, s_hkv, 2048, 128, 17, [2048]), 0.0,
         256, False),
        ("d8192_decode_bf16", bf16, "bf16", tiny, 0.0, 0, False),
        ("d8192_verify_T4_bf16", bf16, "bf16", tiny, 0.0, 4, False),
    ]


# one op call and its backward on the wide kernels
WIDE_CALL = dict(attn_fwd_wide=1, attn_bwd_preprocess=1, attn_bwd_dkv_wide=1,
                 attn_bwd_dq_wide=1)
# the same on route wide_scores (bf16 / fp16 above 1024), one wave: a score
# pass and a product pass forward, the preprocess, one backward score pass
# and the two products
SCORES_FWD_CALL = dict(attn_fwd_scores=1, attn_fwd_product=1)
SCORES_CALL = dict(SCORES_FWD_CALL, attn_bwd_preprocess=1, attn_bwd_scores=1,
                   attn_bwd_product_dkv=1, attn_bwd_product_dq=1)


def wide_call(dtype, width, forward_only=False):
    """The launches of one op call (and its backward) at kernel width
    ``width`` in ``dtype``: the wide builds', or route wide_scores' passes
    for bf16 / fp16 above 1024."""
    import torch
    from flash_attention_dlrs_tpu_torch import geometry as geo

    if geo.chunked(width) and dtype != torch.float32:
        return SCORES_FWD_CALL if forward_only else SCORES_CALL
    return {"attn_fwd_wide": 1} if forward_only else WIDE_CALL


def _op_wide(dev, gen, dt, shape, v8=None, seg=None, **kw):
    """One flash_attention call (the op API) on inputs of ``shape`` (B, Hq,
    Hkv, Nq, Nkv, d; d the model's head dim, which the op pads to its
    kernels' width) with a :func:`segment_layout` ``seg`` as SegmentIds,
    and its .backward() (forward only with fp8 V ``v8``), counted; then the
    same call with the op's kernels swapped for their plain versions, the
    output and gradients held against the kernel path's: (record, ok,
    launches)."""
    import torch
    from flash_attention_dlrs_tpu_torch import SegmentIds, flash_attention
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    b, hq, hkv, nq, nkv, d = shape
    q = _rand(gen, (b, hq, nq, d), dt, dev)
    k = _rand(gen, (b, hkv, nkv, d), dt, dev)
    v = _rand(gen, (b, hkv, nkv, d), dt, dev)
    do = _rand(gen, (b, hq, nq, d), dt, dev)
    if v8:
        v = v.to(getattr(torch, FP8_V[v8]))
    ids = segment_layout(seg, b, nq, nkv, dev)
    segment_ids = SegmentIds(q=ids["q_seg"], kv=ids["kv_seg"]) if ids else None

    def run():
        if v8:
            with torch.no_grad():
                return flash_attention(q, k, v, segment_ids=segment_ids, **kw), None
        qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        out = flash_attention(qr, kr, vr, segment_ids=segment_ids, **kw)
        out.backward(do)
        return out.detach(), (qr.grad, kr.grad, vr.grad)

    (o, grads), launches = counted(run)
    fa_ops = _attention_ops()
    kernels = fa_ops.attn_fwd, fa_ops.attn_bwd
    try:
        fa_ops.attn_fwd, fa_ops.attn_bwd = attn_fwd_plain, attn_bwd_plain
        o_p, grads_p = run()
    finally:
        fa_ops.attn_fwd, fa_ops.attn_bwd = kernels
    torch.cuda.synchronize()
    zero = torch.zeros(1, device=dev)
    fwd_rec, ok = fwd_errors((o, zero), (o_p, zero), dt)
    rec = {"max_abs_err_o": fwd_rec["max_abs_err_o"], "tolerance_o": fwd_rec["tolerance"],
           "out_shape": list(o.shape)}
    ok &= rec["out_shape"] == [b, hq, nq, d]
    if grads is not None:
        bwd_rec, bwd_ok = bwd_errors(grads, grads_p, dt)
        rec.update(bwd_rec)
        ok &= bwd_ok and all(g.shape == x.shape for g, x in zip(grads, (q, k, v)))
    return rec, ok, launches


def _paged_wide_op(dev, gen, kind, t_new, d=320):
    """Paged decode (``t_new`` 0) or verify of ``t_new`` tokens through its
    entry point from bf16 q of head dim ``d`` on ``kind`` pools of the
    kernels' width (384 for 320, 1152 for 1100: an engine's pools for such a
    model, padded as the JAX package pads them), with softcap and ALiBi, the
    wide kernel's launches counted (decode's column-chunked build above
    1024); against the plain version on the same inputs: (record, ok,
    launches)."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm

    hq, hkv = D512_SERVE_HEADS["n_q_heads"], D512_SERVE_HEADS["n_kv_heads"]
    width = -(-d // 128) * 128
    q, kp, vp, lens, table = _paged_inputs(
        gen, dev, torch.bfloat16, kind, 2, hq, hkv, width, 128, 17, [1000, 2100],
        num_pages=2 * 17 + 8, t_new=t_new)
    q = q[..., :d].contiguous()
    kw = dict(sm_scale=d ** -0.5, logit_softcap=30.0,
              alibi_slopes=mods(hq, True)["alibi_slopes"])
    wide = dm.VERIFY_WIDE_KERNEL if t_new else dm.paged_kernels(width)[0]
    attend, plain = ((dm.paged_verify_attention, dm.paged_verify_plain) if t_new
                     else (dm.paged_decode_attention, dm.paged_decode_plain))
    dm.DECODE_SPLITS.clear()
    wide.launches = 0
    got = attend(q, kp, vp, lens, table, **kw)
    torch.cuda.synchronize()
    launches = wide.launches
    if dm.DECODE_SPLITS:  # the kernel's split count (none recorded off the card)
        kw["splits"] = next(iter(dm.DECODE_SPLITS))
    want = plain(q, kp, vp, lens, table, **kw)
    spread = (plain(q, *abs_v_pools(kp, vp), lens, table, **kw)
              if t_new or not torch.is_tensor(vp) else None)
    rec = paged_errors((got, None), (want, None), torch.bfloat16, spread)
    rec["out_shape"] = list(got.shape)
    ok = rec.pop("ok") and list(got.shape) == list(q.shape)
    return rec, ok, launches


def wide_op_checks(dev, gen):
    """The entry points a user calls, at head dims 320 (which the op pads
    to 384 and slices back), 640 and 1100 (padded to 1152, column-chunked):
    flash_attention forward and backward in bf16, fp16 and fp32 with causal
    GQA, window, softcap, ALiBi, dropout and SegmentIds, fp8 V forward
    only; nn.dot_product_attention on padded batches, causal and with a
    window; paged decode and verify from q of 320 on pools of 384 and of
    1100 on pools of 1152.  Each call's launches counted exactly
    (one wide forward, and with a backward the preprocess and each wide
    sweep once, on the route of its types; bf16 / fp16 at 1100 each pass
    of route wide_scores once) and held against the same call on the plain
    versions: (records, checks)."""
    import torch

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    both = mods(4, True, 0.1, -5)
    calls, checks = {}, {}

    def record(name, rec, ok, launches, want):
        calls[name] = {**rec, "launches": launches}
        checks[f"{name}_vs_plain"] = ok
        checks[f"{name}_launches_exact"] = (launches == want if isinstance(want, int)
                                            else launches_are(launches, **want))
        emit({"phase": "wide_op_check", "call": name, **rec,
              "launches": launches if isinstance(launches, int)
              else {k: n for k, n in launches.items() if n}})

    for d, shape in WIDE_OP_SHAPES.items():
        width = -(-d // 128) * 128
        for name, dt, v8, seg, kw in (
                ("causal_gqa_bf16", bf16, None, None, dict(causal=True)),
                ("window_softcap_fp16", f16, None, None,
                 dict(causal=True, window=100, logit_softcap=30.0)),
                ("alibi_dropout_segments_bf16", bf16, None, "packed",
                 dict(causal=True, **both)),
                ("fp32_window_softcap_alibi_dropout", f32, None, None,
                 dict(causal=True, window=64, logit_softcap=25.0, **both)),
                ("fp8v_e4m3_bf16_forward", bf16, "e4m3", None, dict(causal=True))):
            want = wide_call(dt, width, forward_only=bool(v8))
            record(f"op_d{d}_{name}", *_op_wide(dev, gen, dt, shape, v8, seg, **kw),
                   on_route(dt, seg is not None, bool(v8), d=width, **want))
        b, hq, hkv, n = shape[:4]
        lengths = [n, n - 77]
        for name, window in (("causal", None), ("causal_window", (63, 0))):
            rec, ok, launches, _ = _nn_packed(dev, gen, lengths, window, shape=(b, hq, hkv, n, d))
            record(f"nn_d{d}_padded_{name}", rec, ok, launches,
                   on_route(bf16, True, d=width, **wide_call(bf16, width)))
    for d in (320, 1100):
        record(f"paged_decode_d{d}_int8", *_paged_wide_op(dev, gen, "int8", 0, d), 1)
        record(f"paged_verify_d{d}_T64_bf16", *_paged_wide_op(dev, gen, "bf16", 64, d), 1)
    torch.cuda.empty_cache()
    return calls, checks


def sdpa_backend(q, k, v, causal=True):
    """The backend scaled_dot_product_attention picks for (q, k, v) with GQA
    (torch._fused_sdp_choice), by name."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                                  enable_gqa=True)).name
    except (RuntimeError, TypeError, ValueError) as exc:  # a private entry point
        return f"not read ({type(exc).__name__}: {exc})"


def sdpa_expanded_ms(gen, dev, b, hq, hkv, n, d, backward=False):
    """scaled_dot_product_attention (causal, bf16) on the memory-efficient
    backend with K/V expanded to q's heads (repeat_interleave before the
    timing, so the GQA that backend lacks costs it nothing): the forward's
    ms, or with ``backward`` that of torch.autograd.grad on a kept graph
    (dK and dV then per q head: their sum over each group is not timed);
    a string saying why where it does not run."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = hq // hkv
    q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev).requires_grad_(backward)
    k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev).repeat_interleave(g, 1)
    v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev).repeat_interleave(g, 1)
    k.requires_grad_(backward)
    v.requires_grad_(backward)
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            if not backward:
                return median_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                         is_causal=True))
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        do = torch.randn_like(out)
        return median_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True))
    except RuntimeError as exc:
        return f"did not run: {str(exc)[:300]}"
    finally:
        del q, k, v
        torch.cuda.empty_cache()


def _faster_library(row, expanded, backend):
    """``row``'s library_ms the faster of SDPA with enable_gqa (on
    ``backend``) and SDPA on expanded K/V (``expanded``: ms, or why it did
    not run), ``library`` naming the one kept."""
    if isinstance(expanded, float) and (row["library_ms"] is None
                                        or expanded < row["library_ms"]):
        row["library_ms"] = expanded
        row["library"] = "scaled_dot_product_attention, EFFICIENT_ATTENTION, K/V expanded"
    else:
        row["library"] = f"scaled_dot_product_attention, {backend}, enable_gqa"


# The times of the column-chunked mma.sync kernels that the wide_wgmma
# kernels replaced, at the shapes wide_timings measures (H100 80GB HBM3,
# 700 W; PERF.md section 6), printed beside the new ones: the forward,
# verify, the sweeps and their family with the preprocess.
WIDE_MMA_SYNC_MS = {
    "fwd_train_d512": {"ms": 8.06}, "fwd_serve_prefill_d512": {"ms": 0.900},
    "verify_d512_bf16_T256_ctx2048": {"ms": 0.624, "device_ms": 0.541},
    "verify_d512_int8_T256_ctx2048": {"ms": 0.500, "device_ms": 0.437},
    "bwd_train_d512": {"attn_bwd_dkv": 25.10, "attn_bwd_dq": 12.81, "attn_bwd": 37.70},
}
# The times of the decode kernel on the CUDA cores that the one on page
# copies replaced (one key a warp, splits merged by a second kernel), at the
# same shapes (H100 80GB HBM3, 700 W; PERF.md section 6).
WIDE_CUDA_CORE_DECODE_MS = {
    "decode_d512_bf16_B8_ctx2048": {"ms": 0.123, "device_ms": 0.0771},
    "decode_d512_int8_B8_ctx2048": {"ms": 0.119, "device_ms": 0.0749},
}


def fwd_device_ms(gen, dev, b, hq, hkv, n, d, floor_ms):
    """:func:`device_ms` of the bf16 forward (causal) at one shape, none
    read under ``floor_ms`` (its bound)."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    ms = device_ms(lambda: attn_fwd(q, k, v, causal=True, sm_scale=d ** -0.5),
                   floor_ms=floor_ms)
    del q, k, v
    torch.cuda.empty_cache()
    return ms


def wide_timings(dev, gen):
    """The wide kernels at the re-headed bench models' shapes: the forward
    at the training shape (B8 Hq8 Hkv2 N2048) and the serving prefill (B1
    Hq4 Hkv2 N2048), the sweeps at the training shape, decode from bf16 and
    int8 KV at 8 sequences of 2048 and verify of a 256-token chunk at 2048
    (the serving heads Hq4 Hkv2).  The library time is the faster of SDPA
    with enable_gqa on the backend it picks at d 512 and SDPA's
    memory-efficient backend on expanded K/V (:func:`sdpa_expanded_ms`)."""
    import torch

    heads = (D512_SERVE_HEADS["n_q_heads"], D512_SERVE_HEADS["n_kv_heads"], 512)
    t = {"fwd_train_d512": time_fwd(gen, dev, 8, 8, 2, 2048, 512, {}),
         "fwd_serve_prefill_d512": time_fwd(gen, dev, 1, 4, 2, 2048, 512, {}),
         "bwd_train_d512": time_bwd(dev, gen, 8, 8, 2, 2048, 512)}
    for key, shape in (("fwd_train_d512", (8, 8, 2)), ("fwd_serve_prefill_d512", (1, 4, 2))):
        t[key]["device_ms"] = fwd_device_ms(gen, dev, *shape, 2048, 512, t[key]["bound_ms"])
    expanded = {"fwd_train_d512": sdpa_expanded_ms(gen, dev, 8, 8, 2, 2048, 512),
                "fwd_serve_prefill_d512": sdpa_expanded_ms(gen, dev, 1, 4, 2, 2048, 512),
                "bwd_train_d512": sdpa_expanded_ms(gen, dev, 8, 8, 2, 2048, 512, True)}
    t["sdpa_expanded_efficient_ms"] = expanded
    for kind in ("bf16", "int8"):
        t[f"decode_d512_{kind}_B8_ctx2048"] = time_paged(gen, dev, kind, 8, [2048] * 8, 0,
                                                         heads=heads)
        t[f"verify_d512_{kind}_T256_ctx2048"] = time_paged(gen, dev, kind, 1, [2048], 256,
                                                           heads=heads)
    q = _rand(gen, (8, 8, 2048, 512), torch.bfloat16, dev)
    k = _rand(gen, (8, 2, 2048, 512), torch.bfloat16, dev)
    t["sdpa_backend_d512"] = sdpa_backend(q, k, k)
    del q, k
    torch.cuda.empty_cache()
    for key in ("fwd_train_d512", "fwd_serve_prefill_d512"):
        _faster_library(t[key], expanded[key], t["sdpa_backend_d512"])
    _faster_library(t["bwd_train_d512"]["attn_bwd"], expanded["bwd_train_d512"],
                    t["sdpa_backend_d512"])
    for key, before in WIDE_MMA_SYNC_MS.items():
        t[key]["mma_sync_kernel"] = before
    for key, before in WIDE_CUDA_CORE_DECODE_MS.items():
        t[key]["cuda_core_kernel"] = before
    family = t["bwd_train_d512"]["attn_bwd"]
    t["bwd_train_d512"]["family_vs_sdpa"] = (family["ms"] / family["library_ms"]
                                             if family["library_ms"] else None)
    return t


def chunk_timings(dev, gen):
    """The kernels above 1024 at the d 2048 re-headed bench models'
    shapes, as :func:`wide_timings` times the wgmma ones at d 512: the
    forward (route wide_scores) at the training shape (B8 Hq2 Hkv1 N2048)
    and the serving prefill (B1 Hq1 Hkv1 N2048), the sweeps at the
    training shape, each of the route's passes alone at both
    (:func:`scores_pass_timings`), decode from bf16 and int8 KV at 8
    sequences of 2048 and verify of a 256-token chunk at 2048 (the serving
    heads Hq1 Hkv1, column-chunked).  The library time is the
    faster of SDPA with enable_gqa on the backend it picks and SDPA's
    memory-efficient backend on expanded K/V, where either runs."""
    import torch

    heads = (D2048_SERVE_HEADS["n_q_heads"], D2048_SERVE_HEADS["n_kv_heads"], 2048)
    train, serve = (8, 2, 1), (1, 1, 1)
    t = {"fwd_train_d2048": time_fwd(gen, dev, *train, 2048, 2048, {}),
         "fwd_serve_prefill_d2048": time_fwd(gen, dev, *serve, 2048, 2048, {}),
         "bwd_train_d2048": time_bwd(dev, gen, *train, 2048, 2048)}
    for key, shape in (("fwd_train_d2048", train), ("fwd_serve_prefill_d2048", serve)):
        t[key]["device_ms"] = fwd_device_ms(gen, dev, *shape, 2048, 2048, t[key]["bound_ms"])
    expanded = {"fwd_train_d2048": sdpa_expanded_ms(gen, dev, *train, 2048, 2048),
                "fwd_serve_prefill_d2048": sdpa_expanded_ms(gen, dev, *serve, 2048, 2048),
                "bwd_train_d2048": sdpa_expanded_ms(gen, dev, *train, 2048, 2048, True)}
    t["sdpa_expanded_efficient_ms"] = expanded
    for kind in ("bf16", "int8"):
        t[f"decode_d2048_{kind}_B8_ctx2048"] = time_paged(gen, dev, kind, 8, [2048] * 8, 0,
                                                          heads=heads)
        t[f"verify_d2048_{kind}_T256_ctx2048"] = time_paged(gen, dev, kind, 1, [2048], 256,
                                                            heads=heads)
    q = _rand(gen, (8, 2, 2048, 2048), torch.bfloat16, dev)
    k = _rand(gen, (8, 1, 2048, 2048), torch.bfloat16, dev)
    t["sdpa_backend_d2048"] = sdpa_backend(q, k, k)
    del q, k
    torch.cuda.empty_cache()
    for key in ("fwd_train_d2048", "fwd_serve_prefill_d2048"):
        _faster_library(t[key], expanded[key], t["sdpa_backend_d2048"])
    _faster_library(t["bwd_train_d2048"]["attn_bwd"], expanded["bwd_train_d2048"],
                    t["sdpa_backend_d2048"])
    family = t["bwd_train_d2048"]["attn_bwd"]
    t["bwd_train_d2048"]["family_vs_sdpa"] = (family["ms"] / family["library_ms"]
                                              if family["library_ms"] else None)
    t["passes_train_d2048"] = scores_pass_timings(dev, gen, *train, 2048, 2048)
    t["passes_serve_prefill_d2048"] = scores_pass_timings(dev, gen, *serve, 2048, 2048,
                                                          backward=False)
    return t


# Route wide_scores' passes held one by one against their plain versions on
# the same inputs (each product on the kernel score pass's own scratch):
# the d 2048 training model's attention, every mode at 1152, fp8 V at 1408.
SCORES_PASS_CASES = [
    # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, mods
    ("d2048_train_B8_H2_N2048", "bfloat16", 8, 2, 1, 2048, 2048, 2048, True, 0, 0.0, {}),
    ("d1152_window_softcap_alibi_dropout_seg_fp16", "float16", 2, 4, 2, 333, 333, 1152, True,
     100, 30.0, dict(alibi=True, rate=0.1, seed=-5, seg="packed")),
    ("d1408_noncausal_tail_fp8v_e4m3", "bfloat16", 1, 4, 2, 130, 300, 1408, False, 0, 0.0,
     dict(v8="e4m3")),
]
# a call long enough that the default scratch cap runs it in waves: B1 Hq2
# Hkv1 N16384 d1152 causal (5 forward and 4 backward waves)
SCORES_WAVE_SHAPE = (1, 2, 1, 16384, 1152)


def _near(got, want, mask, eps):
    """Max error of ``got`` against ``want`` where ``mask`` holds (equal
    infinities count as 0), and whether every element is within eps x
    |want| + 1e-3 x max |want| (a 16-bit rounding of an fp32 value summed
    in another order)."""
    import torch

    g, w = got.float()[mask], want.float()[mask]
    same_inf = torch.isinf(g) & torch.isinf(w) & (torch.sign(g) == torch.sign(w))
    err = torch.where(same_inf, 0.0, (g - w).abs())
    finite_w = torch.where(torch.isinf(w), 0.0, w)
    limit = eps * finite_w.abs() + 1e-3 * float(finite_w.abs().max())
    return float(err.max()), bool((err <= limit).all())


def scores_pass_case(dev, gen, case):
    """One SCORES_PASS_CASES case: each pass of route wide_scores (one wave)
    against its plain version on the same inputs: S and each tile's row max
    and sum, O and lse from the kernel's own S, P o M and dS, dQ and dK / dV
    from the kernel's own P o M and dS (no backward with fp8 V).  Returns
    {pass: {"max_abs_err", "ok"}}."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap, mod = case
    dt = getattr(torch, dt)
    eps = torch.finfo(dt).eps
    q, k, v, do = (_rand(gen, (b, h, n, d), dt, dev)
                   for h, n in ((hq, nq), (hkv, nkv), (hkv, nkv), (hq, nq)))
    if mod.get("v8"):
        v = v.to(getattr(torch, FP8_V[mod["v8"]]))
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=cap,
              **case_kwargs(hq, b, nq, nkv, dev, mod))
    plan = ws.waves(q, k, False)
    assert len(plan) == 1, plan
    wave = plan[0]
    mask = ws.scratch_mask(q, k, wave, causal, window)
    out = {}
    s_k, st_k = ws.fwd_scores(q, k, wave, **kw)
    s_p, st_p = ws.fwd_scores_plain(q, k, wave, **kw)
    err_s, ok_s = _near(s_k, s_p, mask, 1e-4)
    tiles = mask.view(mask.shape[0], -1, ws.TILE).any(dim=-1)
    err_m, ok_m = _near(st_k[..., 0], st_p[..., 0], tiles, 1e-4)
    err_l, ok_l = _near(st_k[..., 1], st_p[..., 1], tiles, 1e-4)
    out["fwd_scores"] = {"max_abs_err": max(err_s, err_m, err_l), "ok": ok_s and ok_m and ok_l}
    got = torch.empty_like(q), torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    want = torch.empty_like(q), torch.empty_like(got[1])
    ws.fwd_product(s_k, st_k, v, *got, wave, **kw)
    ws.fwd_product_plain(s_k, st_k, v, *want, wave, **kw)
    rec, ok = fwd_errors(got, want, dt)
    out["fwd_product"] = {"max_abs_err": rec["max_abs_err_o"],
                          "max_abs_err_lse": rec["max_abs_err_lse"], "ok": ok}
    if not mod.get("v8"):
        o, lse = fk.attn_fwd(q, k, v, **kw)
        delta = bk.attn_bwd_preprocess(o, do)
        bwave = ws.waves(q, k, True)[0]
        p_k, ds_k = ws.bwd_scores(q, k, v, do, lse, delta, bwave, **kw)
        p_p, ds_p = ws.bwd_scores_plain(q, k, v, do, lse, delta, bwave, **kw)
        err_p, ok_p = _near(p_k, p_p, mask, eps)
        err_ds, ok_ds = _near(ds_k, ds_p, mask, eps)
        out["bwd_scores"] = {"max_abs_err": max(err_p, err_ds), "ok": ok_p and ok_ds}
        dq_k, dq_p = torch.empty_like(q), torch.empty_like(q)
        ws.dq_product(ds_k, q, k, dq_k, bwave, **kw)
        ws.dq_product_plain(ds_k, q, k, dq_p, bwave, **kw)
        full = torch.ones_like(dq_k, dtype=torch.bool)
        out["dq_product"] = dict(zip(("max_abs_err", "ok"), _near(dq_k, dq_p, full, eps)))
        dkv_k = torch.empty_like(k), torch.empty_like(v)
        dkv_p = torch.empty_like(k), torch.empty_like(v)
        ws.dkv_product(p_k, ds_k, q, k, do, *dkv_k, (None, None), bwave, **kw)
        ws.dkv_product_plain(p_k, ds_k, q, k, do, *dkv_p, (None, None), bwave, **kw)
        full = torch.ones_like(dkv_k[0], dtype=torch.bool)
        errs = [_near(a, w, full, eps) for a, w in zip(dkv_k, dkv_p)]
        out["dkv_product"] = {"max_abs_err": max(e for e, _ in errs),
                              "ok": all(o_ for _, o_ in errs)}
    torch.cuda.synchronize()
    emit({"phase": "wide_scores_pass_check", "case": name, "dtype": str(dt),
          "shape": [b, hq, hkv, nq, nkv, d], "causal": causal, "window": window,
          "softcap": cap, "mods": mod, "passes": out})
    return out


def scores_wave_check(dev, gen):
    """A call of route wide_scores that the default scratch cap runs in
    waves (SCORES_WAVE_SHAPE), forward and backward, bit for bit the same
    call in one wave (a cap it fits), and the forward and backward held to
    attn_fwd_plain / attn_bwd_plain: a record with its checks."""
    import torch
    from flash_attention_dlrs_tpu_torch import geometry as geo
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    b, hq, hkv, n, d = SCORES_WAVE_SHAPE
    q, do = (_rand(gen, (b, hq, n, d), torch.bfloat16, dev) for _ in range(2))
    k, v = (_rand(gen, (b, hkv, n, d), torch.bfloat16, dev) for _ in range(2))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    fwd_waves, bwd_waves = len(ws.waves(q, k, False)), len(ws.waves(q, k, True))
    many = ws.attn_fwd_scores(q, k, v, **kw)
    delta = bk.attn_bwd_preprocess(many[0], do)
    g_many = ws.attn_bwd_scores(q, k, v, do, many[1], delta, **kw)
    cap = geo.WIDE_SCORES_SCRATCH_BYTES
    try:
        geo.WIDE_SCORES_SCRATCH_BYTES = 1 << 40  # a cap the whole call fits: one wave
        single = ws.attn_fwd_scores(q, k, v, **kw)
        g_single = ws.attn_bwd_scores(q, k, v, do, many[1], delta, **kw)
    finally:
        geo.WIDE_SCORES_SCRATCH_BYTES = cap
    torch.cuda.synchronize()
    fwd_rec, fwd_ok = fwd_errors(many, fk.attn_fwd_plain(q, k, v, **kw), torch.bfloat16)
    grads = tuple(g_many[x] for x in ("dq", "dk", "dv"))
    bwd_rec, bwd_ok = bwd_errors(grads, bk.attn_bwd_plain(q, k, v, many[0], many[1], do, **kw),
                                 torch.bfloat16)
    checks = {
        "waves_forward_and_backward_several": fwd_waves > 1 and bwd_waves > 1,
        "forward_waves_bitwise_one_wave": all(torch.equal(x, y) for x, y in zip(many, single)),
        "backward_waves_bitwise_one_wave": all(torch.equal(g_many[x], g_single[x])
                                               for x in g_many),
        "forward_vs_plain": fwd_ok, "backward_vs_plain": bwd_ok}
    rec = {"phase": "wide_scores_waves", "shape": list(SCORES_WAVE_SHAPE),
           "scratch_cap_bytes": geo.WIDE_SCORES_SCRATCH_BYTES,
           "waves": {"forward": fwd_waves, "backward": bwd_waves}, "fwd": fwd_rec,
           "bwd": bwd_rec, "checks": checks}
    emit(rec)
    del q, k, v, do, many, single, g_many, g_single
    torch.cuda.empty_cache()
    return rec


def scores_pass_work(b, hq, hkv, n, d):
    """Operations and bytes of each pass of route wide_scores at one causal
    bf16 shape (p visible pairs a head): each input read once, each output
    written once (the scratch at 4 bytes a pair forward, 2 + 2 backward)."""
    pairs = b * hq * n * (n + 1) / 2
    q_bytes, kv_bytes, rows = 2 * b * hq * n * d, 2 * b * hkv * n * d, 4 * b * hq * n
    return {"fwd_scores": (2 * pairs * d, q_bytes + kv_bytes + 4 * pairs),
            "fwd_product": (2 * pairs * d, 4 * pairs + kv_bytes + q_bytes + rows),
            "bwd_scores": (4 * pairs * d, 2 * q_bytes + 2 * kv_bytes + 2 * rows + 4 * pairs),
            "dkv_product": (4 * pairs * d, 4 * pairs + 2 * q_bytes + 2 * kv_bytes),
            "dq_product": (2 * pairs * d, 2 * pairs + kv_bytes + q_bytes)}


def scores_pass_timings(dev, gen, b, hq, hkv, n, d, backward=True):
    """Each pass of route wide_scores at one causal bf16 shape (one wave):
    ms (warm, host time in it), device ms, its plain version's ms on the
    same inputs, its bound; no PyTorch call computes a pass alone (each
    reads or writes the route's scratch of visible tiles), so library_ms is
    null and the call's SDPA time stands beside the whole call."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    q, do = (_rand(gen, (b, hq, n, d), torch.bfloat16, dev) for _ in range(2))
    k, v = (_rand(gen, (b, hkv, n, d), torch.bfloat16, dev) for _ in range(2))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    wave = (0, b * hq * ws.n_tiles(n))
    o, lse = fk.attn_fwd(q, k, v, **kw)
    s, st = ws.fwd_scores(q, k, wave, **kw)
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    calls = {"fwd_scores": (lambda: ws.fwd_scores(q, k, wave, **kw),
                            lambda: ws.fwd_scores_plain(q, k, wave, **kw)),
             "fwd_product": (lambda: ws.fwd_product(s, st, v, o2, lse2, wave, **kw),
                             lambda: ws.fwd_product_plain(s, st, v, o2, lse2, wave, **kw))}
    if backward:
        delta = bk.attn_bwd_preprocess(o, do)
        p, ds = ws.bwd_scores(q, k, v, do, lse, delta, wave, **kw)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        calls.update({
            "bwd_scores": (lambda: ws.bwd_scores(q, k, v, do, lse, delta, wave, **kw),
                           lambda: ws.bwd_scores_plain(q, k, v, do, lse, delta, wave, **kw)),
            "dkv_product": (lambda: ws.dkv_product(p, ds, q, k, do, dk, dv, (None, None), wave,
                                                   **kw),
                            lambda: ws.dkv_product_plain(p, ds, q, k, do, dk, dv, (None, None),
                                                         wave, **kw)),
            "dq_product": (lambda: ws.dq_product(ds, q, k, dq, wave, **kw),
                           lambda: ws.dq_product_plain(ds, q, k, dq, wave, **kw))})
    work = scores_pass_work(b, hq, hkv, n, d)
    rows = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms = median_ms(kernel)
        rows[name] = {"ms": ms, "device_ms": device_ms(kernel, floor_ms=bound_ms),
                      "plain_ms": median_ms(plain, warmup=1, reps=1),
                      "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
                      "library_ms": None,
                      "library": "none: no PyTorch call computes one pass of the route alone"}
    del q, k, v, do, o, lse, s, st
    torch.cuda.empty_cache()
    return rows


def wide_fwd_repeats(dev, gen):
    """The 16-bit wide forward twice on the same inputs, O and lse bit for
    bit (its owners sum their partial scores in a fixed order; no atomics),
    at the cuts of d 512 (one CTA of two owners), 640 (a cluster of 5) and
    1024 (a cluster of 2), with segment ids, ALiBi and dropout at 512:
    {case: equal}."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    out = {}
    for name, dt, b, hq, hkv, n, d, mod in (
            ("d512_causal_gqa_bf16", torch.bfloat16, 2, 8, 2, 1000, 512, {}),
            ("d512_seg_alibi_dropout_fp16", torch.float16, 2, 4, 2, 700, 512,
             dict(seg="packed", alibi=True, rate=0.1, seed=3)),
            ("d640_causal_bf16", torch.bfloat16, 1, 4, 2, 700, 640, {}),
            ("d1024_causal_bf16", torch.bfloat16, 1, 2, 1, 500, 1024, {})):
        q = _rand(gen, (b, hq, n, d), dt, dev)
        k = _rand(gen, (b, hkv, n, d), dt, dev)
        v = _rand(gen, (b, hkv, n, d), dt, dev)
        kw = dict(causal=True, sm_scale=d ** -0.5, **case_kwargs(hq, b, n, n, dev, mod))
        first, again = attn_fwd(q, k, v, **kw), attn_fwd(q, k, v, **kw)
        out[name] = all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()
    return out


def wide_mutants_caught(dev, builds):
    """Each broken copy of WIDE_MUTANTS in place of its build's kernels:
    the forward's (FWD_WIDE_KERNEL) on the wide forward cases at d 512 and
    640 (the column-chunked one's on the fp32 ones at d 1152), the sweeps'
    (DKV_WIDE_KERNEL and DQ_WIDE_KERNEL) on the 16-bit wide bwd_check cases
    at d 512 and 640, route wide_scores' forward passes (FWD_SCORES_KERNEL
    and FWD_PRODUCT_KERNEL) on the 16-bit cases at d 1152: each must fail
    at least one."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    wait = wait_mutant_builds(builds)
    fwd_cases = [c for c in wide_fwd_cases() if c[7] in (512, 640) and c[2] * c[5] <= 2048]
    chunk_cases = [c for c in chunk_fwd_cases() if c[7] == 1152 and c[1] == torch.float32]
    score_cases = [c for c in chunk_fwd_cases() if c[7] == 1152 and c[1] != torch.float32]
    bwd_cases = [c for c in wide_bwd_cases() if c[7] in (512, 640) and c[1] != F32
                 and c[2] * c[5] <= 2048]
    caught = {}
    for name, (_, lib, source) in builds.items():
        sweeps = source == "attn_bwd_wide.cu"
        scores = source == "attn_fwd_scores.cu"
        slots = ((bk, "DKV_WIDE_KERNEL"), (bk, "DQ_WIDE_KERNEL")) if sweeps else (
            ((ws, "FWD_SCORES_KERNEL"), (ws, "FWD_PRODUCT_KERNEL")) if scores
            else ((fk, "FWD_WIDE_KERNEL"),))
        real = [getattr(mod, attr) for mod, attr in slots]
        failed = []
        gen = torch.Generator(device=dev).manual_seed(9)
        try:
            for (mod, attr), kernel in zip(slots, real):
                setattr(mod, attr, _cuda.CudaKernel(source, kernel.symbol, kernel.argtypes,
                                                    library=lib))
            for case in (bwd_cases if sweeps else score_cases if scores
                         else chunk_cases if name.startswith("wide_chunk") else fwd_cases):
                ok = (bwd_case(dev, gen, case)[1] if sweeps
                      else fwd_case(dev, gen, case, phase="wide_mutants")["ok"])
                if not ok:
                    failed.append(case[0])
        finally:
            for (mod, attr), kernel in zip(slots, real):
                setattr(mod, attr, kernel)
        caught[name] = failed
    return caught, wait


def wide_shared_bytes():
    """Every wide instance's dynamic shared memory, from its build's
    ``*_shared_bytes`` entry, against geometry.py's model: the wide_wgmma
    forward by dtype, head dim and modes (segment ids, fp8 V), its verify by
    dtype and head dim, the 16-bit sweeps by sweep, dtype, head dim and
    segment ids, the column-chunked kernels' one layout a dtype (fp32, and
    the 16-bit verify at the chunked widths), each pass of route
    wide_scores (one layout a pass), decode by pool kind and head dim and
    its column-chunked layout: {layout: [C, Python]}."""
    import ctypes
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch import geometry as geo

    def entry(source, nargs):
        fn = getattr(ctypes.CDLL(str(_cuda.library_path(source))),
                     f"{source.split('.')[0]}_shared_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
        return fn

    import torch

    fwd, verify = entry("attn_fwd_wide.cu", 3), entry("paged_verify_wide.cu", 2)
    bwd, decode = entry("attn_bwd_wide.cu", 3), entry("paged_decode_wide.cu", 2)
    chunk_decode = entry("paged_decode_chunk.cu", 0)
    f32 = geo.wide_chunk_smem_bytes(torch.float32)
    out = {"attn_fwd_wide_fp32": [fwd(0, 512, 0), f32],
           "paged_verify_wide_fp32": [verify(0, 512), f32],
           "attn_bwd_wide_fp32": [bwd(0, 512, 0), f32],
           "paged_decode_chunk": [chunk_decode(), geo.wide_chunk_decode_smem_bytes()]}
    for dtype, name, dt in ((1, "bf16", torch.bfloat16), (2, "fp16", torch.float16)):
        for d in CHUNK_WIDTHS:
            out[f"paged_verify_chunk_{name}_d{d}"] = [verify(dtype, d),
                                                      geo.wide_chunk_smem_bytes(dt, paged=True)]
    scores = {"attn_fwd_scores.cu": ("fwd_scores", "fwd_product"),
              "attn_bwd_scores.cu": ("bwd_scores", "dq_product", "dkv_product")}
    for source, kinds in scores.items():
        fn = entry(source, 1)
        for code, kind in enumerate(kinds):
            out[f"wide_scores_{kind}"] = [fn(code), geo.wide_scores_smem_bytes(kind)]
    for dtype, name in ((1, "bf16"), (2, "fp16")):
        for d in WIDE_ALL:
            for seg, v8 in ((False, False), (True, False), (False, True), (True, True)):
                tag = f"attn_fwd_wide_{name}_d{d}{'_seg' if seg else ''}{'_fp8v' if v8 else ''}"
                out[tag] = [fwd(dtype, d, int(seg) | 2 * int(v8)),
                            geo.wide_fwd_smem_bytes(d, segments=seg)]
            out[f"paged_verify_wide_{name}_d{d}"] = [verify(dtype, d),
                                                     geo.wide_fwd_smem_bytes(d, paged=True)]
            for sweep, dkv in (("dkv", True), ("dq", False)):
                for seg in (False, True):
                    out[f"attn_bwd_{sweep}_wide_{name}_d{d}{'_seg' if seg else ''}"] = [
                        bwd(dtype, d, int(seg) | 2 * int(dkv)),
                        geo.wide_bwd_smem_bytes(d, segments=seg, dkv=dkv)]
    for code, kind in enumerate(PAGED_KIND_NAMES):
        for d in WIDE_ALL:
            out[f"paged_decode_wide_{kind}_d{d}"] = [decode(code, d),
                                                     geo.wide_decode_smem_bytes(d, kind)]
    return out


def wide_decode_ctas():
    """CTAs of each wide decode instance one SM holds at once, by the
    runtime's occupancy calculator (paged_decode_wide_ctas_per_sm), beside
    the design's (geometry.wide_decode_ctas_per_sm: two up to 512 columns,
    else one): {instance: [card, design]}."""
    import ctypes
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch import geometry as geo

    fn = ctypes.CDLL(str(_cuda.library_path("paged_decode_wide.cu"))).paged_decode_wide_ctas_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return {f"{kind}_d{d}": [fn(code, d), geo.wide_decode_ctas_per_sm(d)]
            for code, kind in enumerate(PAGED_KIND_NAMES) for d in WIDE_ALL}


def phase_wide_heads(dev):
    """The wide kernels (csrc/wide.cuh, csrc/wide_scores.cuh) against their
    plain versions at kernel widths 384, 512, 640 and 1024 in every mode and
    dtype (the forward also at 768 and 896), and above 1024 at 1152 in
    every mode and dtype, at 1408, at the d 2048 models' shapes and at
    8192: the forward once (fwd_case; route wide_scores' twice, bit for
    bit), the sweeps twice, bit for bit (bwd_case), the paged kernels
    twice, bit for bit, at their key-split edges (paged_case); each call on
    the route its route function names (the 16-bit forward, verify and
    sweeps on wide_wgmma to 1024; above, the 16-bit forward and sweeps on
    wide_scores, verify on wide_chunk; decode on its head dim's build).
    Then each pass of route wide_scores against its plain version on the
    same inputs (scores_pass_case), a call in several waves of scratch bit
    for bit the call in one (scores_wave_check), the entry points at head
    dims 320, 640 and 1100 (wide_op_checks), each mutant of WIDE_MUTANTS
    caught (the forward's by fwd_check, the sweeps' by bwd_check, at d 512
    and 640; the column-chunked fp32 forward's and route wide_scores' at
    1152), every instance's shared memory against geometry.py's model
    (wide_shared_bytes), decode's CTAs an SM as designed
    (wide_decode_ctas), and the kernels timed at the re-headed bench
    models' shapes (d 512 and 2048)."""
    import torch

    global WIDE_MUTANT_BUILDS
    builds = WIDE_MUTANT_BUILDS or start_mutant_builds(WIDE_MUTANTS)
    gen = torch.Generator(device=dev).manual_seed(5)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # route wide_scores' forward (16-bit above 1024) also bit for bit on repeat
    fwd = {c[0]: fwd_case(dev, gen, c, phase="wide_fwd_check",
                          repeat=c[7] > 1024 and c[1] != torch.float32)
           for c in wide_fwd_cases() + chunk_fwd_cases()}
    bwd = {}
    for case in wide_bwd_cases() + chunk_bwd_cases():
        bwd[case[0]], _ = bwd_case(dev, gen, case)
        emit({"phase": "wide_bwd_check", **bwd[case[0]]})
    paged = {}
    for case in wide_paged_cases(num_sms) + chunk_paged_cases(num_sms):
        name, dt, kind, shape, cap, t_new, alibi = case
        paged[name] = paged_case(dev, gen, case)
        emit({"phase": "wide_paged_check", "case": name,
              "kernel": "paged_verify" if t_new else "paged_decode", "q_dtype": str(dt),
              "kv": kind, "tokens": t_new or 1, "shape": list(shape[:6]),
              "lengths": shape[6], "softcap": cap, "alibi": alibi,
              **paged[name]})
    torch.cuda.empty_cache()
    repeats = wide_fwd_repeats(dev, gen)
    passes = {c[0]: scores_pass_case(dev, gen, c) for c in SCORES_PASS_CASES}
    waves = scores_wave_check(dev, gen)
    op_calls, op_checks = wide_op_checks(dev, gen)
    caught, wait = wide_mutants_caught(dev, builds)
    shared = wide_shared_bytes()
    decode_ctas = wide_decode_ctas()
    timings = {**wide_timings(dev, gen), **chunk_timings(dev, gen)}
    chunk = {w: [n for n in (*fwd, *bwd, *paged) if n.startswith(f"d{w}_")]
             for w in CHUNK_WIDTHS}
    checks = {
        "fwd_every_case_kernel_vs_plain_on_its_route": all(r["ok"] for r in fwd.values()),
        "fwd_wide_wgmma_bitwise_repeatable": all(repeats.values()),
        "wide_scores_every_pass_kernel_vs_plain": all(
            r["ok"] for c in passes.values() for r in c.values()),
        **{f"wide_scores_{k}": ok for k, ok in waves["checks"].items()},
        "bwd_every_case_kernel_vs_plain_bitwise_on_its_route":
            all(r["ok"] for r in bwd.values()),
        "paged_every_case_kernel_vs_plain_bitwise": all(r["ok"] for r in paged.values()),
        **op_checks,
        "column_chunked_widths_checked": all(chunk.values()),
        "mutants_fail_their_check": all(bool(f) for f in caught.values()),
        "shared_bytes_match_geometry": all(c == p for c, p in shared.values()),
        "decode_ctas_per_sm_as_designed": all(c == p for c, p in decode_ctas.values()),
    }
    rec = {"phase": "wide_heads", "cases": {"fwd": len(fwd), "bwd": len(bwd),
                                            "paged": len(paged), "entry_points": len(op_calls),
                                            "column_chunked": {w: len(n) for w, n in chunk.items()}},
           "failed": {"fwd": [n for n, r in fwd.items() if not r["ok"]],
                      "bwd": [n for n, r in bwd.items() if not r["ok"]],
                      "paged": [n for n, r in paged.items() if not r["ok"]]},
           "fwd_repeats": repeats, "wide_scores_passes": passes,
           "wide_scores_waves": {k: waves[k] for k in ("waves", "checks")},
           "mutants": {"edits": {n: m[2] for n, m in WIDE_MUTANTS.items()},
                       "failed_cases": caught, "build_wait_seconds": wait},
           "shared_bytes": shared, "decode_ctas_per_sm": decode_ctas, "timings": timings,
           "card": card_line(),
           "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"wide_heads checks failed: {failed}")
    return {"timings": timings, "fwd": fwd, "paged": paged, "scores_passes": passes}


def phase_serve_d512(dev):
    """serving-bench-d512: the serving-bench model re-headed at head dim 512
    (scripts/bench_serving.py:28-34 with 4 q / 2 kv heads of 512; bf16,
    pages of 128, weights from seed 0) served on the wide kernels (route
    wide_wgmma): :func:`serve_reheaded`."""
    return serve_reheaded(dev, "serve_d512", D512_SERVE_HEADS, "wide_wgmma")


def phase_serve_d2048(dev):
    """serving-bench-d2048: the serving-bench model re-headed at head dim
    2048 (scripts/bench_serving.py:28-34 with 1 q / 1 kv head of 2048; bf16,
    pages of 128, weights from seed 0) served above the wgmma cuts: every
    prefill on route wide_scores (its score and product passes), every
    verify column-chunked (route wide_chunk), decode on
    paged_decode_chunk.cu: :func:`serve_reheaded`."""
    return serve_reheaded(dev, "serve_d2048", D2048_SERVE_HEADS, "wide_scores", "wide_chunk")


def serve_reheaded(dev, phase, heads, route, verify_route=None):
    """The serving-bench model with the head fields ``heads`` served through
    DecodeEngine at full width and depth on the wide kernels: the serve
    phase's 8 requests at 8 slots from bf16 KV eagerly, then as graphed
    bursts of 8 (tokens equal, or apart at near-ties only), from int8 KV at
    8 slots, and chunked (prefill_chunk=256, the prefix cache: the wide
    verify) from bf16 and int8 KV; every forward on ``route`` (on route
    wide_scores each score pass with its product pass), every verify on
    ``verify_route`` (by default ``route``), above 1024 every decode on the
    column-chunked build.  Launch counts
    zeroed just before each run and read just after; every layer of a
    decode step checked against the plain version on the engine's own
    pools; the prefill check (every layer's attention at the kernel's
    tolerances, the bf16 logits, the model in fp32); 2-layer fp32 copies of
    decode and of chunked admission within FP32_LOGIT_LIMIT x std."""
    import torch
    from flash_attention_dlrs_tpu_torch import geometry as geo
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, params_from_jax

    cfg = ModelConfig(**{**SERVE_CFG, **heads}, dtype=torch.bfloat16)
    chunked = geo.chunked(cfg.head_dim)
    t0 = time.perf_counter()
    model = params_from_jax(seeded_weights(cfg), cfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts, new, n = serve_prompts(cfg), SERVE_RE_HEADED_NEW_TOKENS, cfg.n_layers
    slots = len(prompts)
    engine = serve_engine(model, cfg, dev, slots=slots)
    engine.generate([[1] * 128], max_new_tokens=2)  # warm-up
    engine.generate([[1] * 128], max_new_tokens=BURST + 1, burst=BURST)  # capture
    eager = _serve_run(engine, prompts, new, "paged_decode_attention")
    eager_layers = check_layers(eager["calls"], verify=False)
    graph = graphed_run(engine, prompts, BURST, new_tokens=new)
    divs = divergences(model, cfg, dev, prompts, eager["outs"], graph["outs"])
    q8 = serve_engine(model, cfg, dev, slots=slots, kv="int8")
    q8.generate([[1] * 128], max_new_tokens=2)
    int8 = _serve_run(q8, prompts, new, "paged_decode_attention")
    int8_layers = check_layers(int8["calls"], verify=False)
    pages = pages_back(engine, q8)
    captured = all(g.graph is not None and g.runs > 1 for g in step_graphs(engine))
    del engine, q8
    torch.cuda.empty_cache()
    prefill = check_prefill(model, cfg, dev, prompts[0])
    fp32 = check_decode_fp32(dev, prompts[0], ("fp32", "int8"), **heads)
    chunked_runs, dense_fwd = phase_serve_chunked(dev, model, cfg, phase=f"{phase}_chunked",
                                                  route=route, verify_route=verify_route,
                                                  **heads)
    del model
    torch.cuda.empty_cache()

    def run_checks(tag, r, fwd_routes_, decode, layers=None):
        out = {
            f"{tag}_every_request_{new}_tokens": all(len(o) == new for o in r["outs"]),
            f"{tag}_fwd_launches_{n}_per_prefill": r["launches"]["attn_fwd"] == n * slots,
            f"{tag}_fwd_launches_all_{route}":
                all_on(fwd_routes_, route, r["launches"]["attn_fwd"]),
            f"{tag}_fwd_product_launches_{'one_a_forward' if route == 'wide_scores' else 'none'}":
                r["launches"]["attn_fwd_product"] == (
                    r["launches"]["attn_fwd"] if route == "wide_scores" else 0),
            f"{tag}_decode_launches_{n}_per_step": r["launches"]["paged_decode"] == decode > 0,
            f"{tag}_decode_launches_{'all' if chunked else 'none'}_column_chunked":
                r["launches"]["paged_decode_chunk"] == (decode if chunked else 0),
        }
        if layers is not None:
            out[f"{tag}_every_layer_decode_kernel_vs_plain"] = (
                layers["ok"] and layers["layers_checked"] == n)
        return out

    checks = {
        **run_checks("bf16_eager", eager, eager["fwd_routes"], n * eager["steps"],
                     eager_layers),
        **run_checks("bf16_graph", graph, graph["launches"]["fwd_routes"], n * graph["steps"]),
        **run_checks("int8", int8, int8["fwd_routes"], n * int8["steps"], int8_layers),
        "graph_tokens_equal_eager_or_near_ties": near_ties_only(divs),
        "every_burst_graph_captured_and_replayed": captured,
        "pages_back": pages,
        **prefill.pop("checks"),
        "fp32_2layer_decode_kernel_vs_plain":
            all(g <= FP32_LOGIT_LIMIT for g in fp32.values()),
    }

    def summary(r, steps_ms):
        n_tok = sum(len(o) for o in r["outs"])
        wall = r.get("wall", r.get("wall_s"))
        admit = r.get("admit_ms") or []
        return {"admit_ms_median": float(np.median(admit)) if admit else None,
                "admit_ms_by_prompt_len": dict(zip(map(str, SERVE_PROMPTS), admit)),
                "decode_ms_per_step": steps_ms, "wall_s": wall, "tokens": n_tok,
                "tokens_per_s": n_tok / wall, "decode_steps": r["steps"],
                "launches": {k: v for k, v in r["launches"].items() if k != "fwd_routes"}}

    runs = {"bf16_eager": summary(eager, float(np.median(eager["decode_ms"]))),
            "bf16_graph_burst8": summary(graph, graph["decode_ms_per_step"]),
            "int8_eager": summary(int8, float(np.median(int8["decode_ms"])))}
    launches = {
        "attn_fwd": eager["launches"]["attn_fwd"] + graph["launches"]["attn_fwd"]
        + int8["launches"]["attn_fwd"] + dense_fwd,
        "attn_fwd_product": eager["launches"]["attn_fwd_product"]
        + graph["launches"]["attn_fwd_product"] + int8["launches"]["attn_fwd_product"]
        + (dense_fwd if route == "wide_scores" else 0),
        "paged_decode_bf16": eager["launches"]["paged_decode"]
        + graph["launches"]["paged_decode"] + chunked_runs["bf16"]["launches"]["paged_decode"],
        "paged_decode_int8": int8["launches"]["paged_decode"]
        + chunked_runs["int8"]["launches"]["paged_decode"],
        "paged_verify_bf16": chunked_runs["bf16"]["launches"]["paged_verify"],
        "paged_verify_int8": chunked_runs["int8"]["launches"]["paged_verify"],
    }
    rec = {"phase": phase, "config": {**SERVE_CFG, **heads},
           "dtype": "bfloat16", "params": n_params, "weights_setup_s": setup_s, "slots": slots,
           "prompt_lengths": list(SERVE_PROMPTS), "new_tokens": new, "burst": BURST,
           "page_size": SERVE_PAGE, "pages_per_seq": SERVE_PPS, "runs": runs,
           "graph_tokens_equal_eager": graph["outs"] == eager["outs"], "divergences": divs,
           "decode_layers": {"bf16": eager_layers, "int8": int8_layers},
           "chunked": {k: {f: r[f] for f in ("admit_ms_chunked_miss",
                                              "admit_ms_chunked_hit_median",
                                              "admit_ms_dense_median",
                                              "decode_ms_per_step_median", "tokens_per_s",
                                              "chunks", "prefix_hits", "launches")}
                       for k, r in chunked_runs.items()},
           **prefill, "fp32_2layer_decode_diff_over_std": fp32, "launches": launches,
           "card": card_line(), "checks": checks}
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return rec


def phase_train_d512(dev):
    """training-bench-d512: the training-bench model re-headed at head dim
    512 (scripts/bench_train.py:68-74 with 8 q / 2 kv heads of 512; 8
    layers, bf16, block remat) trained through make_train_state /
    make_train_step at B8 x N2048 on the wide kernels (phase_train: 1 warm
    and 2 timed steps, exact launches: the forward and the sweeps on the
    wide_wgmma route; every layer's
    attention forward and backward against the plain versions, a 2-layer
    fp32 copy within 1e-3 x std)."""
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel, fwd_kernel

    kernels = {"attn_fwd": fwd_kernel.FWD_WIDE_KERNEL,
               "attn_bwd_preprocess": bwd_kernel.PREPROCESS_KERNEL,
               "attn_bwd_dkv": bwd_kernel.DKV_WIDE_KERNEL,
               "attn_bwd_dq": bwd_kernel.DQ_WIDE_KERNEL}
    return phase_train(dev, "train_d512", kernels=kernels, route="wide_wgmma",
                       bwd_route="wide_wgmma", warm=TRAIN_RE_HEADED_WARM, timed=TRAIN_RE_HEADED_TIMED,
                       **D512_TRAIN_HEADS)


def phase_train_d2048(dev):
    """training-bench-d2048: the training-bench model re-headed at head dim
    2048 (scripts/bench_train.py:68-74 with 2 q / 1 kv heads of 2048; 8
    layers, bf16, block remat) trained at B8 x N2048 on route wide_scores,
    as train_d512 is on the wgmma cuts (1 warm and 2 timed steps, exact
    launches of every pass: a score pass and a product pass a forward, the
    preprocess, one backward score pass and the dK / dV and dQ products a
    backward; every forward and sweep on wide_scores, every layer's
    attention against the plain versions, a 2-layer fp32 copy)."""
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    kernels = {"attn_fwd": ws.FWD_SCORES_KERNEL, "attn_fwd_product": ws.FWD_PRODUCT_KERNEL,
               "attn_bwd_preprocess": bwd_kernel.PREPROCESS_KERNEL,
               "attn_bwd_scores": ws.BWD_SCORES_KERNEL,
               "attn_bwd_dkv": ws.DKV_PRODUCT_KERNEL,
               "attn_bwd_dq": ws.DQ_PRODUCT_KERNEL}
    return phase_train(dev, "train_d2048", kernels=kernels, route="wide_scores",
                       bwd_route="wide_scores", warm=TRAIN_RE_HEADED_WARM,
                       timed=TRAIN_RE_HEADED_TIMED, **D2048_TRAIN_HEADS)


def wide_entries(entry, later):
    """The kernels line's entries of the wide kernels (``entry`` is
    emit_kernels' maker): launches from serve_d512's and train_d512's runs
    (the wgmma cuts) and from serve_d2048's and train_d2048's (route
    wide_scores' passes; verify column-chunked), times at the shapes of
    wide_timings and chunk_timings, each built from its own source (the
    kernel bodies wide.cuh and wide_scores.cuh); each pass's error from
    wide_heads' pass check at the d 2048 training shape, and the whole
    forward and backward calls beside SDPA on the first pass of each."""
    t = later["wide_heads"]["timings"]
    out = []
    serve, train = later["serve_d512"]["launches"], later["train_d512"]["launches"]
    fwd = entry("attn_fwd[wide,d512]", WIDE_SOURCE, FWD_REPLACES,
                serve["attn_fwd"] + train["attn_fwd"], t["fwd_train_d512"],
                built_from=WIDE_BUILDS["attn_fwd"])
    fwd["device_ms"] = t["fwd_train_d512"]["device_ms"]
    prefill = t["fwd_serve_prefill_d512"]
    fwd["serving_prefill"] = {k: prefill[k] for k in ("ms", "device_ms", "plain_ms",
                                                      "bound_ms", "library_ms", "library")}
    fwd["library"] = t["fwd_train_d512"]["library"]
    out.append(fwd)
    for name in ("attn_bwd_dkv", "attn_bwd_dq"):
        out.append(entry(f"{name}[wide,d512]", WIDE_SOURCE, BWD_REPLACES[name], train[name],
                         t["bwd_train_d512"][name], built_from=WIDE_BUILDS["attn_bwd"]))
    serve, train = later["serve_d2048"]["launches"], later["train_d2048"]["launches"]
    errs = later["wide_heads"]["scores_passes"]["d2048_train_B8_H2_N2048"]
    rows, prefill = t["passes_train_d2048"], t["passes_serve_prefill_d2048"]
    for name, key, replaces, launches, build in (
            ("attn_fwd_scores", "fwd_scores", FWD_REPLACES,
             serve["attn_fwd"] + train["attn_fwd"], "fwd"),
            ("attn_fwd_product", "fwd_product", FWD_REPLACES,
             serve["attn_fwd_product"] + train["attn_fwd_product"], "fwd"),
            ("attn_bwd_scores", "bwd_scores",
             f"{BWD_REPLACES['attn_bwd_dkv']}; {BWD_REPLACES['attn_bwd_dq']}",
             train["attn_bwd_scores"], "bwd"),
            ("attn_bwd_dkv", "dkv_product", BWD_REPLACES["attn_bwd_dkv"], train["attn_bwd_dkv"],
             "bwd"),
            ("attn_bwd_dq", "dq_product", BWD_REPLACES["attn_bwd_dq"], train["attn_bwd_dq"],
             "bwd")):
        rec = entry(f"{name}[wide_scores,d2048]", SCORES_SOURCE, replaces, launches,
                    {**rows[key], "route": "wide_scores"}, err=errs[key]["max_abs_err"],
                    built_from=SCORES_BUILDS[build])
        rec.update(device_ms=rows[key]["device_ms"], library=rows[key]["library"])
        if key in prefill:
            rec["serving_prefill"] = {k: prefill[key][k]
                                      for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        out.append(rec)
    fwd_call, bwd_call = t["fwd_train_d2048"], t["bwd_train_d2048"]
    out[-5]["call"] = {  # the whole forward: both passes, one wave
        **{k: fwd_call[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                    "library", "max_abs_err")},
        "serving_prefill": {k: t["fwd_serve_prefill_d2048"][k]
                            for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                      "library")}}
    out[-3]["call"] = {  # the whole backward: preprocess, score pass, two products
        **{k: bwd_call["attn_bwd"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "library", "max_abs_err")},
        "family_vs_sdpa": bwd_call["family_vs_sdpa"]}
    for d, tag, decode_build in ((512, "wide,d512", "paged_decode"),
                                 (2048, "wide_chunk,d2048", "paged_decode_chunk")):
        serve = later[f"serve_d{d}"]["launches"]
        for kind in ("bf16", "int8"):
            out.append(entry(f"paged_decode[{tag},{kind}]", WIDE_SOURCE, DECODE_REPLACES,
                             serve[f"paged_decode_{kind}"], t[f"decode_d{d}_{kind}_B8_ctx2048"],
                             built_from=WIDE_BUILDS[decode_build]))
            out.append(entry(f"paged_verify[{tag},{kind}]", WIDE_SOURCE, VERIFY_REPLACES,
                             serve[f"paged_verify_{kind}"],
                             t[f"verify_d{d}_{kind}_T256_ctx2048"],
                             built_from=WIDE_BUILDS["paged_verify"]))
    return out


LATER_PHASES = ("serve_rolling", "serve_streaming", "native", "eval_gate", "encoder", "tune",
                "bench", "golden", "parallel_attention", "parallel_decode", "train_mesh",
                "serve_mesh", "dryrun", "examples", "wide_heads", "serve_d512", "train_d512",
                "serve_d2048", "train_d2048")


def later_phases(dev, only=None):
    """The phases that follow phase time, in order (``only``: those named):
    the rings, the native library, the perplexity gate, the encoder, the
    tiles and the tuner, the bench suite, the golden gate, the scale-out
    phases and the head dims above 256; their records by name."""
    import torch

    names = LATER_PHASES if only is None else [n for n in LATER_PHASES if n in only]
    out, model, seconds = {}, None, {}
    for name in names:
        t0 = time.perf_counter()
        if name == "serve_streaming":
            out[name], model, cfg = phase_serve_streaming(dev)
        elif name == "native":
            if model is None:
                model, cfg = serving_bench_model(dev)
            out[name] = phase_native(dev, model, cfg)
            model = None
        else:
            out[name] = globals()[f"phase_{name}"](dev)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "later_seconds", "seconds": seconds})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import flash_attention_dlrs_tpu_torch  # noqa: F401  (fails outside the repo)

    if sys.argv[1:2] == ["--pair"]:
        pair(sys.argv[2])
        return 0
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else None

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if only is not None:  # the build and the named later phases, no result line
        phase_build()
        later_phases(dev, only)
        print(card_line(), flush=True)
        return 0
    early = {}  # seconds of each phase before the later ones

    def run(name, phase, *args, **kw):
        t0 = time.perf_counter()
        out = phase(*args, **kw)
        early[name] = time.perf_counter() - t0
        return out

    bwd_mutants, paged_mutants = run("build", phase_build, mutants=True)
    run("mask", phase_mask, dev)
    fwd_res = run("fwd", phase_fwd, dev)
    run("bwd", phase_bwd, dev)
    dec_res = run("decode", phase_decode, dev)
    serve_rec, model, cfg = run("serve", phase_serve, dev)
    quant_runs = run("serve_quant", phase_serve_quant, dev, model, cfg)
    chunked_runs, dense_fwd = run("serve_chunked", phase_serve_chunked, dev, model, cfg)
    alibi_runs = run("serve_alibi", phase_serve_alibi, dev, model)
    burst = run("serve_burst", phase_serve_burst, dev, model, cfg)
    spec = run("serve_spec", phase_serve_spec, dev, model, cfg, burst)
    del model
    torch.cuda.empty_cache()
    run("mutants", phase_mutants, dev, bwd_mutants)  # their builds ran beside the serving phases
    run("paged_mutants", phase_paged_mutants, dev, paged_mutants)
    gemma = run("serve_gemma2", phase_serve_gemma2, dev)
    alibi_d256_runs = run("serve_alibi_d256", phase_serve_alibi_d256, dev)
    variants = run("variants", phase_variants, dev)
    train_rec = run("train", phase_train, dev)
    train_alibi_rec = run("train_alibi", phase_train, dev, "train_alibi",
                          position_encoding="alibi", attn_dropout=TRAIN_ALIBI_DROPOUT)
    packed_rec = run("packed", phase_packed, dev)
    gemma_train_rec = run("train_gemma2", phase_train_gemma2, dev)
    gemma_dropout_rec = run("train_gemma2_dropout", phase_train_gemma2_dropout, dev,
                            gemma_train_rec)
    run("remat", phase_remat, dev)
    run("bf16_reduction", phase_bf16_reduction, dev)
    timings = run("time", phase_time, dev, train_rec, train_alibi_rec, packed_rec,
                  gemma_train_rec)
    emit({"phase": "early_seconds", "seconds": early})
    later = later_phases(dev)
    emit_kernels(fwd_res, dec_res,
                 (serve_rec, quant_runs, chunked_runs, dense_fwd, train_rec,
                  alibi_runs, train_alibi_rec, packed_rec), timings, (burst, spec),
                 (gemma, variants), gemma_train_rec,
                 {"train_gemma2_dropout": gemma_dropout_rec,
                  "serve_alibi_d256": alibi_d256_runs}, later)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
