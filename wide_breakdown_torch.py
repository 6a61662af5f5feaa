#!/usr/bin/env python3
"""Where the time of the 16-bit wide forward goes, on one NVIDIA card.

Builds copies of ``csrc/attn_fwd_wide.cu`` with one piece of the
``wide_wgmma_kernel`` (``csrc/wide.cuh``) cut out at a time, as
``chip_smoke.py`` builds its mutants, and times each in one process beside
the kernel as built, at the training-bench-d512 attention (B8 Hq8 Hkv2 N2048
d 512, causal bf16) and the serving-d512 prefill (B1 Hq4 Hkv2 N2048): device
ms by CUDA events behind a spin kernel (``chip_smoke.device_ms``).  A cut
copy computes wrong values; only its time is read.  One more copy keeps the
register split the kernel had before its owners got 232 registers (producer
72, owners 216), with the spills ptxas reports for its d 512 instance.
Prints one JSON record, then the card's name and power limit:

    python3 wide_breakdown_torch.py
"""

import sys

import chip_smoke as cs

# {name: text edits of csrc/wide.cuh}; each target occurs once
CUTS = {
    "no_exchange": [("      exchange(i);\n", "")],   # each owner keeps its own partial S
    "no_softmax": [("      softmax(n0, st);\n", "")],
    "no_pv": [("        issue_pv(prev);\n", ""), ("      issue_pv(last);\n", "")],
    "no_qk": [("      issue_s(st);\n", "")],
    "split_72_216": [("WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232",
                      "WG_PRODUCER_REGS = 72, WG_CONSUMER_REGS = 216")],
}
SHAPES = {"train_d512": (8, 8, 2), "serve_prefill_d512": (1, 4, 2)}


def main() -> int:
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk

    if not torch.cuda.is_available():
        print("wide_breakdown_torch: no CUDA device is available", file=sys.stderr)
        return 2
    built = _cuda.build(["attn_fwd_wide.cu"])
    builds = cs.start_mutant_builds({n: ("attn_fwd_wide.cu", "wide.cuh", e)
                                     for n, e in CUTS.items()})
    cs.wait_mutant_builds(builds)
    log = built["attn_fwd_wide.cu"]["log"] if built else ""
    logs = {"as_built": log, **{n: (lib.parent / "nvcc.log").read_text()
                                for n, (_, lib, _) in builds.items()}}
    real = fk.FWD_WIDE_KERNEL
    kernels = {"as_built": real,
               **{n: _cuda.CudaKernel(src, real.symbol, real.argtypes, library=lib)
                  for n, (_, lib, src) in builds.items()}}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    try:
        for name in [*kernels, "as_built"]:  # as built first and last: the spread
            fk.FWD_WIDE_KERNEL = kernels[name]
            times = {s: cs.fwd_device_ms(gen, dev, *heads, 2048, 512, None)
                     for s, heads in SHAPES.items()}
            d512 = cs.wide_wgmma_instances(logs[name], "attn_fwd_wide.cu").get("bf16_fwd_d512")
            rec = out.setdefault(name, {"edits": CUTS.get(name, []), "device_ms": [],
                                        "bf16_d512_instance": d512})
            rec["device_ms"].append(times)
    finally:
        fk.FWD_WIDE_KERNEL = real
    cs.emit({"phase": "wide_breakdown", "variants": out, "card": cs.card_line()})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
