"""Full golden-reference gate of the PyTorch port: 200 seeded trials,
forward and backward.

Reproduces the reference harness protocol end to end
(reference: src/test_correctness.py:9-14,28-84), as scripts/run_golden_gate.py
does for the JAX package: NUM_TESTS=200 deterministic seeds at B=32, H=32,
N=256, d=128, fp32, unscaled scores (sm_scale=1), with tolerances fwd atol
1e-4 and dQ/dK/dV atol 9e-4 / 7e-4 / 7e-5 (rtol 1e-5), against the port's
oracle (reference_attention, reference_attention_grads), with a real exit
code.  fp32 runs the kernels' true-fp32 route (the CUDA cores, never TF32).

Run on the card:  python3 scripts/run_golden_gate_torch.py
On the CPU:       python3 scripts/run_golden_gate_torch.py --device cpu --small --trials 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FWD_ATOL = 1e-4
GRAD_ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5


def run_gate(trials: int, small: bool, causal: bool, device) -> dict:
    """The gate's counts and worst gaps: {"trials", "fwd_pass", "bwd_pass",
    "worst": [fwd, dq, dk, dv], "ok"}; a gap is max(|got − want| − rtol
    |want|), the reference's allclose slack."""
    import torch
    from flash_attention_dlrs_tpu_torch import flash_attention
    from flash_attention_dlrs_tpu_torch.ops import (
        reference_attention, reference_attention_grads,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the oracle in true fp32 too
    b, h, n, d = (2, 2, 256, 128) if small else (32, 32, 256, 128)

    def gap(a, want):
        return float((a - want).abs().sub(RTOL * want.abs()).max())

    fwd_pass = bwd_pass = 0
    worst = [0.0] * 4
    for trial in range(trials):
        gen = torch.Generator(device=device).manual_seed(trial)
        q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device=device,
                                   dtype=torch.float32) for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention(*leaves, causal=causal, sm_scale=1.0)
        grads = torch.autograd.grad(o, leaves, do)
        with torch.no_grad():
            o_ref = reference_attention(q, k, v, causal=causal, sm_scale=1.0)
        grads_ref = reference_attention_grads(q, k, v, do, causal=causal, sm_scale=1.0)
        gaps = [gap(o.detach(), o_ref)] + [gap(g, r) for g, r in zip(grads, grads_ref)]
        worst = [max(w, g) for w, g in zip(worst, gaps)]
        fwd_pass += gaps[0] <= FWD_ATOL
        bwd_pass += all(g <= GRAD_ATOL[key] for g, key in zip(gaps[1:], ("dq", "dk", "dv")))
    ok = fwd_pass == trials and bwd_pass == trials
    return {"trials": trials, "shape": [b, h, n, d], "fwd_pass": fwd_pass,
            "bwd_pass": bwd_pass, "worst": worst, "ok": ok}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--small", action="store_true", help="B=2, H=2 workload")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from flash_attention_dlrs_tpu_torch._cuda import resolve_device

    rec = run_gate(args.trials, args.small, args.causal, resolve_device(args.device))
    print(f"forward : {rec['fwd_pass']}/{rec['trials']} within atol {FWD_ATOL}")
    print(f"backward: {rec['bwd_pass']}/{rec['trials']} within {GRAD_ATOL}")
    print(f"worst gaps (fwd,dq,dk,dv): {[f'{w:.2e}' for w in rec['worst']]}")
    print("GATE:", "PASS" if rec["ok"] else "FAIL")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
