#!/usr/bin/env python3
"""Where the time of the 16-bit wide kernels goes, on one NVIDIA card.

Builds copies of ``csrc/attn_fwd_wide.cu`` and ``csrc/attn_bwd_wide.cu``
with one piece of the kernels of ``csrc/wide.cuh`` cut out at a time, as
``chip_smoke.py`` builds its mutants, and times each in one process beside
the kernels as built: device ms by CUDA events behind a spin kernel
(``chip_smoke.device_ms``).  A cut copy computes wrong values; only its
time is read.

- ``forward``: the ``wide_wgmma_kernel`` without the exchange of partial
  scores, the softmax, P V or the partial Q K^T, and one copy with the
  register split the kernel had before its owners got 232 registers
  (producer 72, owners 216), at the training-bench-d512 attention (B8 Hq8
  Hkv2 N2048 d 512, causal bf16) and the serving-d512 prefill (B1 Hq4
  Hkv2 N2048).
- ``sweeps``: ``wide_bwd_dkv_kernel`` and ``wide_bwd_dq_kernel`` (each cut
  in both) without the exchange of partial S and dP, the element loop, the
  score products (partial S and dP) or the update products, each sweep
  timed alone at the training-bench-d512 attention.

Each variant is timed twice, the kernels as built first and last (the
spread).  Prints one JSON record, then the card's name and power limit:

    python3 wide_breakdown_torch.py [forward] [sweeps]   # default: both
"""

import sys

import chip_smoke as cs

# {name: text edits of csrc/wide.cuh}; each target occurs once
FWD_CUTS = {
    "no_exchange": [("      exchange(i);\n", "")],   # each owner keeps its own partial S
    "no_softmax": [("      softmax(n0, st);\n", "")],
    "no_pv": [("        issue_pv(prev);\n", ""), ("      issue_pv(last);\n", "")],
    "no_qk": [("      issue_s(st);\n", "")],
    "split_72_216": [("WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232",
                      "WG_PRODUCER_REGS = 72, WG_CONSUMER_REGS = 216")],
}
SWEEP_CUTS = {
    "no_exchange": [("      xchg.run(s, dp, i);  // the dQ sweep's exchange\n", ""),
                    ("      xchg.run(s, dp, i);  // the dK/dV sweep's exchange\n", "")],
    "no_element_loop": [("                   grads(n0, tile_ids(st), cap, msk, alibi);\n", ""),
                        ("                   grads(m0, st, slope, stream, cap, msk, alibi);\n",
                         "")],
    "no_score_products": [
        ("      issue_partial<T, OC>(s, q_own, own_cols(k_tile(st)));\n", ""),
        ("      issue_partial<T, OC>(dp, do_own, own_cols(v_tile(st)));\n", ""),
        ("      issue_partial<T, OC>(s, k_own, own_cols(q_tile(st)));\n", ""),
        ("      issue_partial<T, OC>(dp, v_own, own_cols(do_tile(st)));\n", "")],
    "no_update_products": [
        ("        issue_update<T, C>(acc, da, own_cols(k_tile(prev)));  // dQ: tile i - 1\n", ""),
        ("      issue_update<T, C>(acc, da, own_cols(k_tile(last)));  // dQ: the last tile\n",
         ""),
        ("      issue_update<T, C>(dv, pa, own_cols(do_tile(st)));  // dV += (P o M)^T dO\n", ""),
        ("      issue_update<T, C>(dk, da, own_cols(q_tile(st)));   // dK += dS^T Q\n", "")],
}
SHAPES = {"train_d512": (8, 8, 2), "serve_prefill_d512": (1, 4, 2)}
TRAIN = (8, 8, 2, 2048, 512)  # B, Hq, Hkv, N, d of the training-bench-d512 attention


def sweep_device_ms(gen, dev):
    """Device ms of each 16-bit sweep alone (causal bf16) at TRAIN."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    b, hq, hkv, n, d = TRAIN
    q, do = (cs._rand(gen, (b, hq, n, d), torch.bfloat16, dev) for _ in range(2))
    k, v = (cs._rand(gen, (b, hkv, n, d), torch.bfloat16, dev) for _ in range(2))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    o, lse = attn_fwd(q, k, v, **kw)
    delta = bk.attn_bwd_preprocess(o, do)
    out = {"attn_bwd_dkv": cs.device_ms(lambda: bk.attn_bwd_dkv(q, k, v, do, lse, delta, **kw)),
           "attn_bwd_dq": cs.device_ms(lambda: bk.attn_bwd_dq(q, k, v, do, lse, delta, **kw))}
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


def breakdown(source, cuts, slots, timer, instance):
    """Builds ``source`` and its cut copies, then times each with ``timer``
    (its kernels swapped into ``slots``: [(module, attribute)]); the
    variants' records by name, each with ``instance(log)`` of its build."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda

    built = _cuda.build([source])
    builds = cs.start_mutant_builds({n: (source, "wide.cuh", e) for n, e in cuts.items()})
    cs.wait_mutant_builds(builds)
    log = built[source]["log"] if built else ""
    logs = {"as_built": log, **{n: (lib.parent / "nvcc.log").read_text()
                                for n, (_, lib, _) in builds.items()}}
    real = [getattr(mod, attr) for mod, attr in slots]
    kernels = {"as_built": real,
               **{n: [_cuda.CudaKernel(src, k.symbol, k.argtypes, library=lib) for k in real]
                  for n, (_, lib, src) in builds.items()}}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    try:
        for name in [*kernels, "as_built"]:  # as built first and last: the spread
            for (mod, attr), kernel in zip(slots, kernels[name]):
                setattr(mod, attr, kernel)
            rec = out.setdefault(name, {"edits": cuts.get(name, []), "device_ms": [],
                                        "d512_instances": instance(logs[name])})
            rec["device_ms"].append(timer(gen, dev))
    finally:
        for (mod, attr), kernel in zip(slots, real):
            setattr(mod, attr, kernel)
    return out


def main() -> int:
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk

    if not torch.cuda.is_available():
        print("wide_breakdown_torch: no CUDA device is available", file=sys.stderr)
        return 2
    parts = sys.argv[1:] or ["forward", "sweeps"]
    rec = {"phase": "wide_breakdown"}
    if "forward" in parts:
        rec["forward"] = breakdown(
            "attn_fwd_wide.cu", FWD_CUTS, [(fk, "FWD_WIDE_KERNEL")],
            lambda gen, dev: {s: cs.fwd_device_ms(gen, dev, *heads, 2048, 512, None)
                              for s, heads in SHAPES.items()},
            lambda log: cs.wide_wgmma_instances(log, "attn_fwd_wide.cu").get("bf16_fwd_d512"))
    if "sweeps" in parts:
        rec["sweeps"] = breakdown(
            "attn_bwd_wide.cu", SWEEP_CUTS, [(bk, "DKV_WIDE_KERNEL"), (bk, "DQ_WIDE_KERNEL")],
            sweep_device_ms,
            lambda log: {k: v for k, v in cs.wide_bwd_instances(log).items()
                         if k.endswith("bf16_d512")})
    rec["card"] = cs.card_line()
    cs.emit(rec)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
