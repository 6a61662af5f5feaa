#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flash_attention_dlrs_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from csrc/ with nvcc and holds each kernel
against its plain PyTorch version on the card (the backward kernels also
against themselves, bit for bit).  Then drives both paths of the port:

- serving: 8 requests through DecodeEngine at the full width of the repo's
  serving-bench model (scripts/bench_serving.py defaults: 16 layers,
  d_model 2048, 16 q / 8 kv heads, head_dim 128, d_ff 5504, vocab 32000,
  bf16, random weights from a seed);
- training: make_train_state / make_train_step on the repo's training-bench
  model (scripts/bench_train.py:68-74: the b7 widths, d_model 4096, 32 q /
  8 kv heads, head_dim 128, d_ff 11008, vocab 32000, 8 layers, bf16, block
  remat) at batch 8, sequence 2048, for 2 warm and 4 timed steps plus a
  profiled and a recorded one;

checks that each path went through its kernels (launch counts set to 0
just before the path and read just after), and times each kernel beside its
bound, its plain version and, where one exists, the PyTorch library call
computing the same function.

Every phase prints one JSON line and raises on failure.  The line before
the last is the card's name and power limit as nvidia-smi reports them; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when no CUDA device is present.

Usage: python3 chip_smoke.py   (no arguments; needs one CUDA card)
"""

from __future__ import annotations

import importlib
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
BWD_SOURCE = "flash_attention_dlrs_tpu_torch/csrc/attn_bwd.cu"
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


def phase_fwd(dev):
    import torch
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd, attn_fwd_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap
        ("serve_prefill_2048", bf16, 1, 16, 8, 2048, 2048, 128, True, 0, 0.0),
        ("train_B8_H32_N2048", bf16, 8, 32, 8, 2048, 2048, 128, True, 0, 0.0),
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
        got = attn_fwd(q, k, v, **kw)
        want = attn_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        rec, ok = fwd_errors(got, want, dt)
        rec["ok"] = ok
        results[name] = rec
        emit({"phase": "fwd_check", "case": name, "dtype": str(dt),
              "shape": [b, hq, hkv, nq, nkv, d], "causal": causal,
              "window": window, "softcap": cap, **rec})
        del q, k, v, got, want
    torch.cuda.empty_cache()
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"forward kernel disagrees with its plain version: {bad}")
    return results


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


def phase_bwd(dev):
    """Each case: the three backward kernels twice (dQ/dK/dV must be
    bitwise equal) and the plain version once, on the same q/k/v/O/lse/dO;
    O and lse come from the forward kernel."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd, attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # name, dtype, B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, sm_scale
        ("train_B2_H32_N2048", bf16, 2, 32, 8, 2048, 2048, 128, True, 0, 0.0, None),
        ("fp32_golden_causal", f32, 2, 2, 2, 256, 256, 128, True, 0, 0.0, 1.0),
        ("fp32_golden_noncausal", f32, 2, 2, 2, 256, 256, 128, False, 0, 0.0, 1.0),
        # fp32 twins of the masked bf16 cases: the fp32 kernels share the
        # tile ranges and masks, and the fp32 ladder sees a one-key slip
        ("fp32_window_softcap", f32, 1, 4, 2, 512, 512, 64, True, 100, 25.0, 1.0),
        ("fp32_cross_empty_rows", f32, 1, 4, 2, 300, 200, 128, True, 0, 0.0, 1.0),
        ("window256_softcap30", bf16, 1, 16, 8, 1024, 1024, 128, True, 256, 30.0, None),
        ("noncausal_cross_300_1000", bf16, 2, 4, 2, 300, 1000, 128, False, 0, 0.0, None),
        ("empty_rows_300_200", bf16, 1, 4, 2, 300, 200, 128, True, 0, 0.0, None),
        ("fp16_mqa_bottom_right", f16, 1, 4, 1, 100, 700, 64, True, 0, 0.0, None),
        ("causal_N16384", bf16, 1, 2, 2, 16384, 16384, 128, True, 0, 0.0, None),
    ]
    results = {}
    for name, dt, b, hq, hkv, nq, nkv, d, causal, window, cap, scale in cases:
        q = _rand(gen, (b, hq, nq, d), dt, dev)
        k = _rand(gen, (b, hkv, nkv, d), dt, dev)
        v = _rand(gen, (b, hkv, nkv, d), dt, dev)
        do = _rand(gen, (b, hq, nq, d), dt, dev)
        kw = dict(causal=causal, sm_scale=d ** -0.5 if scale is None else scale,
                  window=window, softcap=cap)
        o, lse = attn_fwd(q, k, v, **kw)
        got = attn_bwd(q, k, v, o, lse, do, **kw)
        again = attn_bwd(q, k, v, o, lse, do, **kw)
        want = attn_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        rec, ok = bwd_errors(got, want, dt)
        rec["bitwise_repeatable"] = all(torch.equal(a, c) for a, c in zip(got, again))
        rec["ok"] = ok and rec["bitwise_repeatable"]
        results[name] = rec
        emit({"phase": "bwd_check", "case": name, "dtype": str(dt),
              "shape": [b, hq, hkv, nq, nkv, d], "causal": causal,
              "window": window, "softcap": cap, "sm_scale": kw["sm_scale"], **rec})
        del q, k, v, do, o, lse, got, again, want
    torch.cuda.empty_cache()
    bad = [n for n, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"backward kernels disagree with their plain version: {bad}")
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


def profile_window(fn, steps):
    """Run ``fn`` ``steps`` times in one torch.profiler window synchronized
    at both edges.  Returns the wall ms per step, the device's busy ms per
    step (the union of its operations' intervals: operations that overlap
    count once), its operation count per step, and the device ms per step
    of every kernel name, largest first; raises if the profiler saw no
    device time or more than the wall."""
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


def phase_decode_profile(engine, cfg):
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
        "phase": "decode_profile", "active_slots": engine.num_slots,
        "steps": steps, "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_unprofiled": unprofiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": n_ops,
        "top_device_ms_per_step": top_kernels(by_name),
    }
    emit(rec)
    while engine.scheduler.has_work:
        engine.scheduler.schedule()
        engine.step()
    return rec


TRAIN_CFG = dict(vocab_size=32000, d_model=4096, n_layers=8, n_q_heads=32,
                 n_kv_heads=8, head_dim=128, d_ff=11008)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARM_STEPS, TRAIN_TIMED_STEPS = 2, 4
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
    ("fp32 GEMMs (the LM head in true fp32)", ("f32f32", "sgemm")),
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


def check_train_attention(model, opt_state, step, tokens):
    """One more train step with every layer's attention backward inputs
    recorded; then, on that step's own q/k/v/O/lse/dO, each layer's forward
    kernel output (O, lse) against the plain forward at the fwd_check
    tolerances, and its backward kernels against the plain backward at the
    bwd_check tolerances."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.bwd_kernel import attn_bwd, attn_bwd_plain
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd_plain

    fa_ops = _attention_ops()
    recorded = []
    kernel_bwd = fa_ops.attn_bwd

    def recording(q, k, v, o, lse, do, **kw):
        recorded.append((q, k, v, o, lse, do, kw))
        return kernel_bwd(q, k, v, o, lse, do, **kw)

    try:
        fa_ops.attn_bwd = recording
        loss = float(step(model, opt_state, tokens))
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


def check_train_fp32(tokens, dev):
    """The training model in fp32 at 2 layers: loss and gradients of one
    step through the kernels and through the plain versions.  A third run
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

    cfg = ModelConfig(**{**TRAIN_CFG, "n_layers": TRAIN_FP32_LAYERS},
                      dtype=torch.float32)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device=dev)
    toks = tokens[:TRAIN_FP32_BATCH]

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, toks, cfg)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

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
        "fp32_layers": TRAIN_FP32_LAYERS, "fp32_batch": TRAIN_FP32_BATCH,
        "fp32_loss_kernel": loss_k, "fp32_loss_plain": loss_p,
        "fp32_worst_grad": worst, "fp32_worst_grad_diff_over_std": ratios[worst],
        "fp32_kernel_vs_plain": {"per_leaf": ratios, **gaps},
        "fp32_plain_reordered_vs_plain": floor,
        "ok": (abs(loss_k - loss_p) <= FP32_LOSS_RTOL * abs(loss_p)
               and ratios[worst] <= FP32_GRAD_LIMIT
               and all(np.isfinite(list(ratios.values())))),
    }


def phase_train(dev):
    """The training path at the bench-train config, full width and depth:
    make_train_state (weights from init_params_numpy, seed 0), AdamW
    lr 3e-4 / wd 0.01, one batch of tokens [8, 2049] from numpy seed 1.
    2 warm steps, 4 timed ones (synchronized at the edges, launch counts
    zeroed just before and read just after), one profiled step, one step
    whose attention backward inputs are recorded and checked layer by
    layer, then the 2-layer fp32 comparison of kernel and plain paths."""
    import torch
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, make_train_state, make_train_step,
    )

    cfg = ModelConfig(**TRAIN_CFG, dtype=torch.bfloat16, remat=True,
                      remat_policy="block")
    t0 = time.perf_counter()
    model, opt_state, optimizer = make_train_state(
        cfg, seed=0, device=dev, learning_rate=3e-4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)

    losses = [float(step(model, opt_state, tokens)) for _ in range(TRAIN_WARM_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    kernels = _kernels()
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    timed = [step(model, opt_state, tokens) for _ in range(TRAIN_TIMED_STEPS)]
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t) * 1e3 / TRAIN_TIMED_STEPS
    launches = {name: kern.launches for name, kern in kernels.items()}
    losses += [float(x) for x in timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof_wall, prof_busy, prof_ops, prof_by_name = profile_window(
        lambda: losses.append(float(step(model, opt_state, tokens))), 1)
    by_group = {label: 0.0 for label, _ in TRAIN_PROFILE_GROUPS}
    by_group["everything else"] = 0.0
    for name, ms in prof_by_name.items():
        label = next((label for label, marks in TRAIN_PROFILE_GROUPS
                      if any(m in name for m in marks)), "everything else")
        by_group[label] += ms

    loss, layers_checked, attn_err, attn_ok = check_train_attention(
        model, opt_state, step, tokens)
    losses.append(loss)
    del model, opt_state, optimizer
    torch.cuda.empty_cache()
    fp32 = check_train_fp32(tokens, dev)

    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (ms_per_step / 1e3)
    fpt = model_flops_per_token(cfg, TRAIN_SEQ)
    expected = {"attn_fwd": 2 * cfg.n_layers * TRAIN_TIMED_STEPS,
                **{name: cfg.n_layers * TRAIN_TIMED_STEPS for name in kernels
                   if name != "attn_fwd"}}
    checks = {
        "loss_finite": all(np.isfinite(losses)),
        "loss_falls": losses[-1] < losses[0],
        "launches_exact_per_step": launches == expected,
        "attention_every_layer_fwd_and_bwd_kernel_vs_plain":
            layers_checked == cfg.n_layers and attn_ok,
        "fp32_2layer_kernel_vs_plain": fp32.pop("ok"),
    }
    rec = {
        "phase": "train", "config": TRAIN_CFG, "dtype": "bfloat16",
        "remat_policy": "block", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "params": n_params, "weights_setup_s": setup_s,
        "optimizer": "AdamW (optax.adamw semantics) lr 3e-4, wd 0.01",
        "losses": losses, "timed_steps": TRAIN_TIMED_STEPS,
        "ms_per_step": ms_per_step, "tokens_per_s": tokens_per_s,
        "model_flops_per_token": fpt,
        "mfu": tokens_per_s * fpt / PEAK_BF16_FLOPS,
        "mfu_formula": ("tokens/s x model_flops_per_token (3 x forward matmul "
                        "flops: projections, causal attention, LM head; "
                        "scripts/bench_train.py:26-36) / 989e12"),
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_expected": expected,
        "profiled_step": {"wall_ms": prof_wall, "device_busy_ms": prof_busy,
                          "device_idle_share": 1.0 - prof_busy / prof_wall,
                          "device_ops": prof_ops, "device_ms_by_kind": by_group,
                          "top_device_ms": top_kernels(prof_by_name, 8)},
        "attention_layers_checked": layers_checked,
        **{f"attention_{k}": v for k, v in attn_err.items()},
        **fp32, "checks": checks,
    }
    emit(rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training checks failed: {failed}")
    return rec


def bwd_work(b, hq, hkv, nq, nkv, d, causal, itemsize):
    """Operations and bytes each backward kernel needs, and the whole
    backward ("attn_bwd"), each input read once and each output written
    once.  With p visible (q, key) pairs: the dK/dV sweep computes S, dP,
    dV and dK (8·p·d flops per head), the dQ sweep S, dP and dQ (6·p·d);
    the backward as a whole needs the five products of the minimal
    backward, 2.5 x the forward's 4·p·d."""
    pairs = nq * nkv / 2 if causal and nq == nkv else nq * nkv
    q_bytes = itemsize * b * hq * nq * d  # one of q, O, dO, dQ
    kv_bytes = itemsize * b * hkv * nkv * d  # one of K, V, dK, dV
    stat_bytes = 4 * b * hq * nq  # one of lse, D
    return {
        "attn_bwd_preprocess": (2 * b * hq * nq * d, 2 * q_bytes + stat_bytes),
        "attn_bwd_dkv": (8 * b * hq * pairs * d,
                         2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes),
        "attn_bwd_dq": (6 * b * hq * pairs * d,
                        3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes),
        "attn_bwd": (10 * b * hq * pairs * d,
                     4 * q_bytes + 4 * kv_bytes + stat_bytes),
    }


def time_bwd(dev, gen, b, hq, hkv, n, d):
    """The three backward kernels one by one and together at one causal
    bf16 shape, each with its bound, its plain version's time and its
    error against the plain version on the same inputs; SDPA's backward
    (torch.autograd.grad through scaled_dot_product_attention, graph kept)
    as the library time of the whole backward, torch.linalg.vecdot on the
    fp32 casts of O and dO as that of the preprocess."""
    import torch
    import torch.nn.functional as F
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    q = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    k = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    v = _rand(gen, (b, hkv, n, d), torch.bfloat16, dev)
    do = _rand(gen, (b, hq, n, d), torch.bfloat16, dev)
    kw = dict(causal=True, sm_scale=d ** -0.5)
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
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True)
    lib_ms = {
        "attn_bwd": median_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                          retain_graph=True)),
        "attn_bwd_preprocess": median_ms(
            lambda: torch.linalg.vecdot(o.float(), do.float())),
    }
    work = bwd_work(b, hq, hkv, n, n, d, True, 2)
    rows = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, warmup=1, reps=3)
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms.get(name),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "tflops": flops / ms / 1e9, "max_abs_err": err}
    rows["sum_of_three"] = sum(rows[name]["ms"] for name in calls if name != "attn_bwd")
    del qr, kr, vr, out
    torch.cuda.empty_cache()
    return rows


def phase_time(dev, train_rec):
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
        "fwd_train_B8_H32_N2048": (8, 32, 8, 2048, 128),
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

    # launches per train step; one attn_bwd call launches each of its three
    # kernels once
    per_step = {name: n // TRAIN_TIMED_STEPS
                for name, n in train_rec["launches"].items()}
    per_step["attn_bwd"] = per_step["attn_bwd_dq"]
    for name, shape in {"bwd_train_B8_H32_N2048": (8, 32, 8, 2048, 128),
                        "bwd_bench_B8_H16_N4096": (8, 16, 16, 4096, 128)}.items():
        rows = time_bwd(dev, gen, *shape)
        timings[name] = rows
        library = {
            "attn_bwd": ("backward of torch.nn.functional.scaled_dot_product_attention"
                         " (enable_gqa), torch.autograd.grad on a kept graph"),
            "attn_bwd_preprocess": ("torch.linalg.vecdot(o.float(), do.float()), "
                                    "the casts included"),
        }
        for kernel in ("attn_bwd_preprocess", "attn_bwd_dkv", "attn_bwd_dq", "attn_bwd"):
            emit({"phase": "time", "kernel": kernel, "case": name, "shape": list(shape),
                  "dtype": "bfloat16", "causal": True,
                  "launches_per_train_step": per_step[kernel],
                  "library": library.get(kernel, "none: SDPA's backward computes all "
                                         "three kernels' outputs at once (see attn_bwd)"),
                  **rows[kernel]})
        emit({"phase": "time", "kernel": "attn_bwd (sum of the three launches)",
              "case": name, "ms": rows["sum_of_three"]})

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
    return timings


def emit_kernels(fwd_res, dec_res, serve_rec, train_rec, timings):
    """The kernels line: every kernel of both paths.  Launches are the
    counts of the path runs (serving, and the training run's timed steps);
    times, bounds and errors are at the serving shape for attn_fwd and
    paged_decode and at the training shape for the backward kernels."""
    fwd_t, dec_t = timings["fwd_serve_prefill_2048"], timings["decode_serve"]
    kernels = [
        {"name": "attn_fwd", "route": "cuda", "source": FWD_SOURCE,
         "replaces": FWD_REPLACES,
         "launches": serve_rec["launches"]["attn_fwd"]
         + train_rec["launches"]["attn_fwd"],
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
    ]
    rows = timings["bwd_train_B8_H32_N2048"]
    for name, replaces in BWD_REPLACES.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": replaces, "launches": train_rec["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})


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
    phase_bwd(dev)
    dec_res = phase_decode(dev)
    serve_rec = phase_serve(dev)
    train_rec = phase_train(dev)
    timings = phase_time(dev, train_rec)
    emit_kernels(fwd_res, dec_res, serve_rec, train_rec, timings)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
