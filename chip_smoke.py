#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flash_attention_dlrs_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from csrc/ with nvcc, holds each kernel
against its plain PyTorch version on the card, serves 8 requests through
DecodeEngine at the full width of the repo's serving-bench model
(scripts/bench_serving.py defaults: 16 layers, d_model 2048, 16 q / 8 kv
heads, head_dim 128, d_ff 5504, vocab 32000, bf16, random weights from a
seed), checks that the serving path went through both kernels, and times
each kernel beside its bound, its plain version and, where one exists, the
PyTorch library call computing the same function.

Every phase prints one JSON line and raises on failure.  The line before
the last is the card's name and power limit as nvidia-smi reports them; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when no CUDA device is present.

Usage: python3 chip_smoke.py   (no arguments; needs one CUDA card)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16/fp16, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM

FWD_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_fwd.cu"
FWD_REPLACES = (
    "flash_attention_dlrs_tpu/ops/fwd_kernel.py:197; "
    "flash_attention_dlrs_tpu/ops/fwd_mid.py:211; "
    "flash_attention_dlrs_tpu/ops/fwd_mid.py:572; "
    "flash_attention_dlrs_tpu/ops/fwd_small.py:69"
)
DECODE_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/paged_decode.cu"
DECODE_REPLACES = "flash_attention_dlrs_tpu/ops/decode.py:44"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, warmup=3, reps=10):
    """Median of per-call device times (CUDA events), warm."""
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


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fwd_work(b, hq, hkv, nq, nkv, d, causal, itemsize):
    """Operations and bytes one forward needs: causal counts the visible
    half of the score matrix (2·B·H·N²·d when Nq = Nkv)."""
    pairs = nq * nkv / 2 if causal and nq == nkv else nq * nkv
    flops = 4 * b * hq * pairs * d
    nbytes = itemsize * (2 * b * hq * nq * d + 2 * b * hkv * nkv * d) + 4 * b * hq * nq
    return flops, nbytes


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from flash_attention_dlrs_tpu_torch import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    info = {}
    for src, rec in built.items():
        ptxas = [l.strip() for l in rec["log"].splitlines()
                 if "registers" in l or "spill" in l or "smem" in l]
        info[src] = {"seconds": round(rec["seconds"], 3), "ptxas": ptxas}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": _cuda.all_sources(), "built": info})


def _rand(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def phase_fwd(dev):
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, attn_fwd_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap
        ("serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0),
        ("noncausal_tail", bf16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0),
        ("window_softcap", bf16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0),
        ("fp32_256", f32, 2, 4, 2, 256, 256, 64, True, 0, 0.0),
        ("fp16_bottom_right", f16, 1, 4, 1, 100, 700, 64, True, 0, 0.0),
        ("bf16_empty_rows", bf16, 1, 4, 2, 300, 200, 128, True, 0, 0.0),
    ]
    results = {}
    for name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap in cases:
        q = _rand(gen, (b, hq, nq, d), dt, dev)
        k = _rand(gen, (b, hkv, nkv, d), dt, dev)
        v = _rand(gen, (b, hkv, nkv, d), dt, dev)
        kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, softcap=cap)
        o, lse = attn_fwd(q, k, v, **kw)
        o_ref, lse_ref = attn_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs()
        err_l = (lse - lse_ref).abs()
        if dt == f32:
            ok_o = bool((err_o <= 1e-4 + 1e-5 * o_ref.float().abs()).all())
            ok_l = bool((err_l <= 1e-4 + 1e-5 * lse_ref.abs()).all())
            tol = "O and L: atol 1e-4, rtol 1e-5"
        else:
            ok_o = bool((err_o <= 2e-2).all())
            ok_l = bool((err_l <= 1e-3).all())
            tol = "O: atol 2e-2, L: atol 1e-3"
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        rec = {"max_abs_err_o": float(err_o.max()), "max_abs_err_lse": float(err_l.max()),
               "frac_o_differs": float((o != o_ref).float().mean()),
               "tolerance": tol, "ok": ok_o and ok_l and finite}
        results[name] = rec
        emit({"phase": "fwd_check", "case": name, "dtype": str(dt),
              "shape": [b, hq, hkv, nq, nkv, d], "causal": causal,
              "window": window, "softcap": cap, **rec})
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"forward kernel disagrees with its plain version: {bad}")
    return results


def _decode_inputs(gen, dev, dtype, b, hq, hkv, d, page_size, pps, lengths,
                   num_pages):
    import torch

    q = _rand(gen, (b, hq, d), dtype, dev)
    kp = _rand(gen, (hkv, num_pages, page_size, d), dtype, dev)
    vp = _rand(gen, (hkv, num_pages, page_size, d), dtype, dev)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, table


def phase_decode(dev):
    import torch
    from flash_attention_dlrs_tpu_torch.ops.decode import (
        paged_decode_attention, paged_reference_attention,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [
        # name, dtype, B, Hq, Hkv, d, page, pps, lengths, softcap
        ("serve_decode", torch.bfloat16, 4, 16, 8, 128, 128, 16,
         [2048, 1300, 777, 200], 0.0),
        ("ragged_empty_softcap", torch.bfloat16, 4, 16, 8, 128, 128, 16,
         [0, 1, 129, 2047], 30.0),
        ("fp32_d64", torch.float32, 3, 8, 2, 64, 64, 8, [5, 300, 512], 0.0),
    ]
    results = {}
    for name, dt, b, hq, hkv, d, ps, pps, lengths, cap in cases:
        q, kp, vp, lens, table = _decode_inputs(
            gen, dev, dt, b, hq, hkv, d, ps, pps, lengths, num_pages=b * pps + 8)
        o, lse = paged_decode_attention(q, kp, vp, lens, table,
                                        logit_softcap=cap, return_lse=True)
        o_ref, lse_ref = paged_reference_attention(
            q, kp, vp, lens, table, logit_softcap=cap, return_lse=True)
        torch.cuda.synchronize()
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_l = float((lse - lse_ref).abs().max())
        if dt == torch.float32:
            ok = err_o <= 1e-4 and err_l <= 1e-4
            tol = "O and lse: atol 1e-4"
        else:
            # |O| is ~0.04 at length 2048: an O limit of 2e-2 would pass
            # nearly anything, so O is held to 1e-3 too
            ok = err_o <= 1e-3 and err_l <= 1e-3
            tol = "O and lse: atol 1e-3"
        ok = ok and bool(torch.isfinite(o).all())
        results[name] = {"max_abs_err_o": err_o, "max_abs_err_lse": err_l,
                         "tolerance": tol, "ok": ok}
        emit({"phase": "decode_check", "case": name, "dtype": str(dt),
              "shape": [b, hq, hkv, d, ps, pps], "lengths": lengths,
              "softcap": cap, **results[name]})
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"decode kernel disagrees with its plain version: {bad}")
    return results


SERVE_CFG = dict(vocab_size=32000, d_model=2048, n_layers=16, n_q_heads=16,
                 n_kv_heads=8, head_dim=128, d_ff=5504)
SERVE_PROMPTS = (200, 2048, 512, 1300, 777, 1800, 1024, 1536)
SERVE_NEW_TOKENS = 32

# Limits of the prefill-logit checks, as multiples of the logits' std.  In
# bf16 the 16 random layers amplify rounding: the plain path with its q·k
# sums merely reversed moved the logits by 0.061 x std, and the kernel path
# read 0.050 (fp32 P) and 0.068 (bf16 P) x std on H100 runs.  The bf16
# limit sits above that noise; the fp32 limit, where the kernel computes in
# true fp32, is what separates a right kernel from a wrong one.
BF16_LOGIT_LIMIT = 0.1
FP32_LOGIT_LIMIT = 1e-3


def _prefill_paths(cfg, model, toks, lens):
    """Last-token logits of one prefill through the kernel path and through
    the plain path, and the attention inputs of every layer on the kernel
    path."""
    from flash_attention_dlrs_tpu_torch.models import decoding, make_prefill
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    prefill = make_prefill(cfg)
    kernel_attention = decoding.flash_attention
    inputs = []

    def recording(q, k, v, *, causal, sm_scale=None):
        inputs.append((q, k, v, causal, sm_scale))
        return kernel_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    def plain(q, k, v, *, causal, sm_scale=None):
        scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
        return attn_fwd_plain(q, k, v, causal=causal, sm_scale=scale)[0]

    try:
        decoding.flash_attention = recording
        logits_k, _ = prefill(model, toks, lens)
        decoding.flash_attention = plain
        logits_p, _ = prefill(model, toks, lens)
    finally:
        decoding.flash_attention = kernel_attention
    return logits_k, logits_p, inputs


def check_prefill(model, cfg, dev, prompt):
    """One prompt's prefill, kernel path against plain path, three ways:
    the bf16 model's logits (within BF16_LOGIT_LIMIT x std); every layer's
    attention on the bf16 kernel path's own inputs, at the kernel's
    tolerances (O atol 2e-2, lse atol 1e-3); and the same model in fp32,
    whose kernel path computes in true fp32 (within FP32_LOGIT_LIMIT x std)."""
    import copy
    import dataclasses

    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, attn_fwd_plain

    t = len(prompt)
    toks = torch.zeros((1, 1 << max(7, (t - 1).bit_length())), dtype=torch.long,
                       device=dev)
    toks[0, :t] = torch.tensor(prompt, device=dev)
    lens = torch.tensor([t], dtype=torch.int32, device=dev)

    logits_k, logits_p, inputs = _prefill_paths(cfg, model, toks, lens)
    diff, std = float((logits_k - logits_p).abs().max()), float(logits_p.std())

    err_o, err_l = [], []
    for q, k, v, causal, sm_scale in inputs:
        scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
        o, lse = attn_fwd(q, k, v, causal=causal, sm_scale=scale)
        o_ref, lse_ref = attn_fwd_plain(q, k, v, causal=causal, sm_scale=scale)
        err_o.append(float((o.float() - o_ref.float()).abs().max()))
        err_l.append(float((lse - lse_ref).abs().max()))

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    logits_k32, logits_p32, _ = _prefill_paths(cfg32, model32, toks, lens)
    diff32, std32 = (float((logits_k32 - logits_p32).abs().max()),
                     float(logits_p32.std()))
    del model32
    torch.cuda.empty_cache()

    finite = bool(torch.isfinite(logits_k).all() and torch.isfinite(logits_k32).all())
    return {
        "prefill_check_prompt_len": t,
        "prefill_logit_diff_over_std_bf16": diff / std,
        "prefill_logit_diff_over_std_fp32": diff32 / std32,
        "prefill_attention_layers_checked": len(inputs),
        "prefill_attention_max_abs_err_o": max(err_o),
        "prefill_attention_max_abs_err_lse": max(err_l),
        "checks": {
            "prefill_logits_bf16_kernel_vs_plain":
                diff <= BF16_LOGIT_LIMIT * std and finite,
            "prefill_attention_every_layer_kernel_vs_plain":
                len(inputs) == cfg.n_layers
                and max(err_o) <= 2e-2 and max(err_l) <= 1e-3,
            "prefill_logits_fp32_kernel_vs_plain":
                diff32 <= FP32_LOGIT_LIMIT * std32 and finite,
        },
    }


def phase_serve(dev):
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, init_params_numpy, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.ops.decode import DECODE_KERNEL
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import FWD_KERNEL
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    cfg = ModelConfig(**SERVE_CFG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
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

    def timed(fn, sink):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    engine._prefill = timed(orig_prefill, prefill_ms)
    engine._decode_step = timed(orig_decode, decode_ms)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    steps_before = engine.scheduler.stats.steps
    FWD_KERNEL.launches = 0
    DECODE_KERNEL.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"attn_fwd": FWD_KERNEL.launches, "paged_decode": DECODE_KERNEL.launches}
    steps = engine.scheduler.stats.steps - steps_before
    engine._prefill, engine._decode_step = orig_prefill, orig_decode

    n_tok = sum(len(o) for o in outs)
    checks = {
        "every_request_32_tokens": all(len(o) == SERVE_NEW_TOKENS for o in outs),
        "tokens_in_vocab": all(0 <= x < cfg.vocab_size for o in outs for x in o),
        "fwd_launches_16_per_prefill": launches["attn_fwd"] == cfg.n_layers * len(prompts),
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
        "prefill_ms_by_prompt_len": per_len,
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
    return rec


def phase_decode_profile(engine, cfg):
    """Where a steady decode step's time goes.  One torch.profiler window,
    synchronized at both edges, gives the wall time per step and the device's
    busy time and operation count per step (by kernel name) over the same
    steps; the idle share is 1 - busy / wall of that window.  The wall time
    per step without the profiler, over as many steps just before, shows
    what the profiler itself adds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    rec = {
        "phase": "decode_profile", "active_slots": engine.num_slots,
        "steps": steps, "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_unprofiled": unprofiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": sum(n for _, n in by_name.values()) / steps,
        "top_device_ms_per_step": {name[:60]: us / 1e3 / steps
                                   for name, (us, _) in top},
    }
    emit(rec)
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    if busy_ms > wall_ms:
        raise AssertionError(
            f"device busy {busy_ms} ms exceeds the window's wall {wall_ms} ms "
            "per step: the device time is miscounted")
    while engine.scheduler.has_work:
        engine.scheduler.schedule()
        engine.step()
    return rec


def phase_time(dev, fwd_res, dec_res, serve_rec):
    import torch
    import torch.nn.functional as F
    from flash_attention_dlrs_tpu_torch.ops.decode import (
        paged_decode_attention, paged_reference_attention,
    )
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, attn_fwd_plain

    gen = torch.Generator(device=dev).manual_seed(3)
    timings = {}
    for name, (b, hq, hkv, n, d) in {
        "fwd_serve_prefill_2048": (1, 16, 8, 2048, 128),
        "fwd_bench_B8_H16_N4096": (8, 16, 16, 4096, 128),
    }.items():
        q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
        k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
        v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
        kw = dict(causal=True, sm_scale=d ** -0.5)
        ms = median_ms(lambda: attn_fwd(q, k, v, **kw))
        plain_ms = median_ms(lambda: attn_fwd_plain(q, k, v, **kw), warmup=1, reps=3)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        flops, nbytes = fwd_work(b, hq, hkv, n, n, d, True, 2)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        timings[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "tflops": flops / ms / 1e9}
        emit({"phase": "time", "kernel": "attn_fwd", "case": name,
              "shape": [b, hq, hkv, n, d], "dtype": "bfloat16", "causal": True,
              "library": "torch.nn.functional.scaled_dot_product_attention",
              **timings[name]})

    b, hq, hkv, d, ps, pps = 4, 16, 8, 128, 128, 17
    lengths = [n + SERVE_NEW_TOKENS for n in SERVE_PROMPTS[:4]]
    q, kp, vp, lens, table = _decode_inputs(
        gen, dev, torch.bfloat16, b, hq, hkv, d, ps, pps, lengths,
        num_pages=80)
    ms = median_ms(lambda: paged_decode_attention(q, kp, vp, lens, table))
    plain_ms = median_ms(lambda: paged_reference_attention(q, kp, vp, lens, table))
    total = sum(lengths)
    nbytes = 2 * (2 * b * hq * d) + 2 * total * hkv * d * 2 + 4 * b * (1 + pps)
    flops = 4 * total * hq * d
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    timings["decode_serve"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "gb_per_s": nbytes / ms / 1e6}
    emit({"phase": "time", "kernel": "paged_decode", "case": "decode_serve",
          "shape": [b, hq, hkv, d, ps, pps], "lengths": lengths,
          "dtype": "bfloat16",
          "library": "none: no single PyTorch call computes paged decode",
          **timings["decode_serve"]})

    fwd_t, dec_t = timings["fwd_serve_prefill_2048"], timings["decode_serve"]
    emit({"kernels": [
        {"name": "attn_fwd", "route": "cuda", "source": FWD_SOURCE,
         "replaces": FWD_REPLACES,
         "launches": serve_rec["launches"]["attn_fwd"],
         "max_abs_err": fwd_res["serve_prefill_2048"]["max_abs_err_o"],
         "ms": fwd_t["ms"], "plain_ms": fwd_t["plain_ms"],
         "bound_ms": fwd_t["bound_ms"], "bound_by": fwd_t["bound_by"],
         "library_ms": fwd_t["library_ms"]},
        {"name": "paged_decode", "route": "cuda", "source": DECODE_SOURCE,
         "replaces": DECODE_REPLACES,
         "launches": serve_rec["launches"]["paged_decode"],
         "max_abs_err": dec_res["serve_decode"]["max_abs_err_o"],
         "ms": dec_t["ms"], "plain_ms": dec_t["plain_ms"],
         "bound_ms": dec_t["bound_ms"], "bound_by": dec_t["bound_by"],
         "library_ms": None},
    ]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import flash_attention_dlrs_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    fwd_res = phase_fwd(dev)
    dec_res = phase_decode(dev)
    serve_rec = phase_serve(dev)
    phase_time(dev, fwd_res, dec_res, serve_rec)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
