"""Quantized-KV perplexity gate of the PyTorch port (int8 KV within 0.1 ppl
of the unquantized cache; BASELINE.md), the port's counterpart of
scripts/eval_ppl.py.

Runs teacher-forced perplexity through the serving path (a prefill, then
paged decode steps, models/eval.py) from value and quantized KV pools and
reports the gaps.  Two modes:

- Markov toy (default): trains a small fp32 model for --train-steps steps
  on a noisy first-order Markov chain (a quantization gate on a random
  model measures only rounding noise at an arbitrary scale), then gates
  int8 against fp32 KV.  Runs on the CPU with --device cpu:
      python scripts/eval_ppl_torch.py --device cpu
- Checkpoint: a training run directory (model_config.json + params_only/,
  as models/convert.py load_trained reads it) over the head of --data's
  val.bin (scripts/make_corpus.py); bf16, int8, int4 KV (e4m3 and e5m2
  reported); int8 gated against bf16:
      python scripts/eval_ppl_torch.py --checkpoint RUN_DIR --data CORPUS \
          --seq 2048 --out results.json

Exits 0 when the gate passes.  Imports torch and the port, nothing of JAX.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from flash_attention_dlrs_tpu_torch._cuda import resolve_device
from flash_attention_dlrs_tpu_torch.models import (
    ModelConfig, load_trained, make_train_state, make_train_step,
)
from flash_attention_dlrs_tpu_torch.models.eval import perplexity_dense, perplexity_paged

# name -> perplexity_paged keywords; "fp" is the unquantized pool
POOLS = {
    "fp32": dict(kv_dtype=torch.float32, quantized=False),
    "bf16": dict(kv_dtype=torch.bfloat16, quantized=False),
    "int8": dict(kv_dtype=torch.int8, quantized=True),
    "int4": dict(kv_dtype="int4", quantized=True),
    "e4m3": dict(kv_dtype=torch.float8_e4m3fn, quantized=True),
    "e5m2": dict(kv_dtype=torch.float8_e5m2, quantized=True),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--gate", type=float, default=0.1)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--checkpoint", default=None,
                    help="training run directory: evaluate the trained model on "
                    "held-out corpus data instead of the Markov toy")
    ap.add_argument("--data", default=None, help="corpus directory with val.bin")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON results here")
    return ap.parse_args(argv)


def markov_sampler(vocab: int, seed: int = 0):
    """draw(batch, seq, seed) -> int64 [batch, seq]: a chain that follows a
    fixed random successor 90% of the time, else a uniform token."""
    succ = np.random.default_rng(seed).integers(0, vocab, size=vocab)

    def draw(batch, seq, seed):
        r = np.random.default_rng(seed)
        out = np.zeros((batch, seq), np.int64)
        out[:, 0] = r.integers(0, vocab, size=batch)
        for t in range(1, seq):
            follow = r.random(batch) < 0.9
            out[:, t] = np.where(follow, succ[out[:, t - 1]],
                                 r.integers(0, vocab, size=batch))
        return out

    return draw


def gate(results, base, gate_ppl):
    """Add each pool's gap to ``base`` and the int8 gate's verdict."""
    for name in POOLS:
        if name in results and name != base:
            results[f"{name}_gap"] = abs(results[name] - results[base])
    results["machinery_gap"] = abs(results[base] - results["dense"])
    results["gate"] = gate_ppl
    results["pass"] = bool(results["int8_gap"] < gate_ppl)
    return results


def eval_markov(args, device):
    cfg = ModelConfig(
        vocab_size=512, d_model=args.d_model, n_layers=args.layers,
        n_q_heads=max(4, args.d_model // 64), n_kv_heads=max(2, args.d_model // 128),
        head_dim=32, d_ff=args.d_model * 2, dtype=torch.float32, remat=False)
    draw = markov_sampler(cfg.vocab_size)
    model, opt_state, optimizer = make_train_state(cfg, seed=0, device=device,
                                                   learning_rate=1e-3)
    step = make_train_step(cfg, optimizer)
    for i in range(args.train_steps):
        batch = torch.from_numpy(draw(8, args.seq + 1, seed=100 + i)).to(device)
        loss = step(model, opt_state, batch)
        if i % 50 == 0:
            print(f"[train] step {i}: loss {float(loss):.3f}", flush=True)
    tokens = draw(args.batch, args.seq, seed=9999)
    results = {"mode": "markov", "batch": args.batch, "seq": args.seq,
               "train_steps": args.train_steps,
               "dense": perplexity_dense(model, cfg, tokens)}
    for name in ("fp32", "int8", "int4", "e4m3", "e5m2"):
        results[name] = perplexity_paged(model, cfg, tokens, device=device, **POOLS[name])
    return gate(results, "fp32", args.gate)


def eval_checkpoint(args, device):
    model, cfg = load_trained(args.checkpoint, device=device)
    val = np.memmap(os.path.join(args.data, "val.bin"), dtype=np.uint16, mode="r")
    need = args.batch * (args.seq + 1)
    if len(val) < need:
        raise ValueError(f"val.bin holds {len(val)} tokens, fewer than {need}")
    tokens = np.asarray(val[:need], np.int64).reshape(args.batch, args.seq + 1)
    results = {"mode": "checkpoint", "checkpoint": args.checkpoint, "batch": args.batch,
               "seq": args.seq, "vocab": cfg.vocab_size,
               "dense": perplexity_dense(model, cfg, tokens)}
    for name in ("bf16", "int8", "int4", "e4m3", "e5m2"):
        results[name] = perplexity_paged(model, cfg, tokens, device=device, **POOLS[name])
    return gate(results, "bf16", args.gate)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.checkpoint and not args.data:
        raise SystemExit("--checkpoint needs --data (the corpus directory with val.bin)")
    results = eval_checkpoint(args, device) if args.checkpoint else eval_markov(args, device)
    results["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu")
    base = "bf16" if args.checkpoint else "fp32"
    print(f"ppl dense: {results['dense']:.4f}  (machinery gap of paged {base}: "
          f"{results['machinery_gap']:.2e})")
    for name in POOLS:
        if name in results:
            gap = "" if name == base else f"  (gap {results[name + '_gap']:.4f})"
            print(f"ppl paged {name}-KV: {results[name]:.4f}{gap}")
    print(f"GATE (int8 within {args.gate} ppl of {base}):",
          "PASS" if results["pass"] else "FAIL")
    print(json.dumps(results), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0 if results["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
