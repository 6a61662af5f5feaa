"""Headline benchmark of the PyTorch port: fused attention TFLOP/s on one card.

Prints ONE JSON line, as bench.py does for the JAX package on the same
workload: {"metric", "value", "unit", "vs_baseline"}, where value is the
port's flash-attention forward throughput and vs_baseline its speedup over
the naive attention (the port's reference_attention: softmax(QKᵀ)V with
the scores materialized in fp32) on the same inputs.

Workload: B=8, H=16, d=128 (the reference's bench family,
reference: src/bench.py:8-10), N=4096, bf16, causal.
Run on the card:  python3 bench_torch.py
On the CPU:       python3 bench_torch.py --device cpu --small   (B1 H2 N256)
Full sweep (N=2^7..2^15, fwd / bwd, CSVs): python3 scripts/run_bench_suite_torch.py
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="B1 H2 N256 (a CPU smoke run)")
    args = ap.parse_args()

    import torch
    from flash_attention_dlrs_tpu_torch._cuda import resolve_device
    from flash_attention_dlrs_tpu_torch.bench.suite import attention_flops, time_fn
    from flash_attention_dlrs_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_dlrs_tpu_torch.ops.reference import reference_attention

    device = resolve_device(args.device)
    b, h, n, d = (1, 2, 256, 128) if args.small else (8, 16, 4096, 128)
    causal = True
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16) for _ in range(3))

    with torch.no_grad():
        sec_ours = time_fn(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal),
                           q, k, v)
        fl = attention_flops(b, h, n, n, d, causal=causal, mode="fwd")
        tflops_ours = fl / sec_ours / 1e12
        try:
            sec_naive = time_fn(lambda q_, k_, v_: reference_attention(
                q_, k_, v_, causal=causal, sm_scale=d ** -0.5), q, k, v)
            vs_baseline = sec_naive / sec_ours
        except RuntimeError:  # the naive scores do not fit
            vs_baseline = float("nan")

    print(json.dumps({
        "metric": f"fused causal flash-attention fwd TFLOP/s "
                  f"(bf16, B={b} H={h} N={n} d={d}, 1 card)",
        "value": round(tflops_ours, 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(vs_baseline, 3),
    }))


if __name__ == "__main__":
    main()
