#!/usr/bin/env python3
"""Where the time of the 16-bit wide and d 256 kernels goes, on one NVIDIA card.

Builds copies of ``csrc/attn_fwd_wide.cu``, ``csrc/attn_bwd_wide.cu``,
``csrc/paged_decode_wide.cu`` (the kernels of ``csrc/wide.cuh``) and
``csrc/attn_fwd_scores.cu``, ``csrc/attn_bwd_scores.cu``,
``csrc/paged_verify_wide.cu`` (those of ``csrc/wide_scores.cuh``) with one
piece of a kernel cut out at a time, as
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
- ``decode``: ``wide_decode_kernel`` without the scores (the partial dots
  and their warp sums), without P V, without the merge of the key splits
  inside the launch, and with the page copies only (all three cut), from
  bf16 and int8 pools at the serving-d512 heads (B8 Hq4 Hkv2, 2048 tokens
  each), each call after an L2 flush as ``chip_smoke.time_paged`` reads it;
  the cut copies build the d 512 instances only.
- ``scores``: route wide_scores above 1024 at the d 2048 re-headed bench
  models' attention (training B8 Hq2 Hkv1 N2048, causal bf16; the forward
  also at the serving prefill B1 Hq1 Hkv1): each pass alone (the
  forward's score and product passes, the backward's score pass and its
  dQ and dK / dV products), as built and with the product passes' wgmma
  products cut (P is still formed from the stored S in the forward), which
  leaves their scratch and operand traffic; the passes' bounds beside.
- ``verify``: route wide_scores' paged verify above 1024 at the
  serving-d2048 chunk (B1 Hq1 Hkv1, T 256 at a length of 2048, pages of
  128, 17 a sequence; bf16 q from bf16 and int8 pools): its score pass, its
  product pass (the call's key splits) and the merge of the splits, each
  alone, and the whole call, each call after an L2 flush as
  ``chip_smoke.time_paged`` reads it; as built, with the product's wgmma
  products cut, and with the score pass's quantized payloads neither
  loaded nor converted (its K stages stale: the int8 score pass's cost of
  its K traffic); the bounds beside.
- ``verify_splits``: the whole verify call above 1024 (no cut copy) at
  the serving-d2048 chunk, the same chunk at a context of 8192 and a
  speculative round of 8 sequences of T 8, from bf16 and int8 pools, at
  every key split count whole pages give, beside the count
  ``decode.verify_splits`` picks.
- ``d256``: the d 256 backward sweeps (``csrc/attn_bwd_d256.cu`` over
  ``csrc/attn_bwd_sm90.cuh``) at Gemma-2-2B's training attention (B2 Hq8
  Hkv4 N8192, causal bf16; global and window 4096, each without and with
  the softcap 50): each sweep alone and the family (``attn_bwd``: the
  preprocess and both sweeps), as built, without the element loop and
  without the softcap (the scores run the no-softcap loop), and without
  the update products; with ``--parent DIR`` (an unpacked tree, e.g. the
  parent commit's ``git archive``) the same cuts of that tree's sweeps
  and its dK/dV sweep's first pass alone where it has two, built and timed
  in the same process; SDPA's backward at the global shape beside them.

Each variant is timed twice, the kernels as built first and last (the
spread).  Prints one JSON record, then the card's name and power limit:

    python3 wide_breakdown_torch.py [forward] [sweeps] [decode] [scores] [verify]
                                    [verify_splits] [d256] [--parent DIR]
                                                                  # default: the first three
"""

import pathlib
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
_NO_SCORES = [("      const Dot dot = spread_sum<N>(part, lane);\n",
                "      const Dot dot = Dot(0);\n")]
_NO_PV = [("      if (sc[i][0][0] == -INFINITY) continue;\n", "      if (i >= 0) continue;\n")]
_NO_MERGE = [("      merge();\n    } else {\n", "    } else {\n"),
             ("  if (a.splits > 1) merge();\n}\n", "}\n")]
DECODE_CUTS = {
    "no_scores": _NO_SCORES,
    "no_pv": _NO_PV,
    "no_merge": _NO_MERGE,
    "copies_only": _NO_SCORES + _NO_PV + _NO_MERGE,
}
# the cut copies of decode build its d 512 instances alone
_DECODE_ONLY_512 = [
    (f"      case {d}: return f(kind, std::integral_constant<int, {d // 128}>{{}});",
     f"      case {d}: return int(cudaErrorInvalidValue);") for d in (384, 640, 768, 896, 1024)]
# The d 256 sweeps' cuts (csrc/attn_bwd_sm90.cuh), every occurrence of each
# target replaced; the parent's text where it differs.
_D256_NO_LOOP = [("    auto grads = [&](int n0, int st, auto cap, auto masked) {\n",
                  "    auto grads = [&](int n0, int st, auto cap, auto masked) {\n"
                  "      if (n0 >= 0) return;\n")]
D256_CUTS = {
    "no_element_loop": _D256_NO_LOOP + [(
        "    auto grads = [&](int m0, int st, float slope, auto cap, auto masked) {\n",
        "    auto grads = [&](int m0, int st, float slope, auto cap, auto masked) {\n"
        "      if (m0 >= 0) return;\n")],
    "no_softcap": [("if (softcap > 0.f) {", "if (false) {")],
    # the producer completes each stage's full barrier without copying it:
    # the sweeps on stale Q / dO (K / V) stages, their compute alone
    "no_stage_loads": [
        (f"mbar_expect_tx(full(s), 2 * L::STEP_BYTES);\n#pragma unroll\n"
         f"          for (int c = 0; c < CHUNKS; ++c) {{\n            tma_load_3d({t}(s)",
         f"mbar_arrive(full(s));\n#pragma unroll\n"
         f"          for (int c = 0; c < 0; ++c) {{\n            tma_load_3d({t}(s)")
        for t in ("q_tile", "k_tile")],
    "no_score_products": [
        ("      issue_scores_to<T, D, HALF, BS * 128, BN * 128>(s, q_tile(st), k_keys);\n"
         "      issue_scores_to<T, D, HALF, BS * 128, BN * 128>(dp, do_tile(st), v_keys);\n", ""),
        ("issue_scores<T, D>(s, q_rows, k_tile(0));", ""),
        ("issue_scores<T, D>(dp, do_rows, v_tile(0));", ""),
        ("issue_scores<T, D>(s, q_rows, k_tile(st));", ""),
        ("issue_scores<T, D>(dp, do_rows, v_tile(st));", "")],
    # dK/dV: the updates read the tiles without waiting for the other
    # warpgroup's half, and the tiles are rewritten without waiting for its
    # updates
    "no_exchange_waits": [("      mbar_wait(tiles_full, x & 1);\n", ""),
                          ("      if (x > 0) mbar_wait(tiles_empty, (x - 1) & 1);\n", "")],
    "no_update_products": [("      issue_updates(st);\n", ""),
                           ("issue_update<T, D>(acc, da, k_tile(prev));  // dQ: tile i - 1", ""),
                           ("issue_update<T, D>(acc, da, k_tile(last));  // dQ: the last tile", "")],
}
D256_PARENT_CUTS = {
    "no_element_loop": _D256_NO_LOOP + [(
        "    auto grads = [&](int m0, int st, float slope, uint32_t stream, auto cap, auto masked,\n"
        "                     auto with_ds) {\n",
        "    auto grads = [&](int m0, int st, float slope, uint32_t stream, auto cap, auto masked,\n"
        "                     auto with_ds) {\n      if (m0 >= 0) return;\n")],
    "no_softcap": [("if (softcap > 0.f) {", "if (false) {")],
    # the dV pass alone: the producer streams the steps once
    "first_pass_only": [("      pass(std::true_type{});\n", ""),
                        ("for (int i = 0; i < PASSES * n_steps; ++i) {",
                         "for (int i = 0; i < n_steps; ++i) {")],
}
# Route wide_scores' product passes without their wgmma products (csrc/
# wide_scores.cuh): the forward's P still formed (a bit of it kept live),
# the stages still loaded and released.
SCORES_CUTS = {
    "no_products": [
        ("          WgmmaRS<128, T>::run(*reinterpret_cast<float(*)[64]>(acc + 64 * hh), pa[kk],\n"
         "                               smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));\n",
         "          acc[hh] += __uint_as_float(pa[kk][hh] & 1u);\n"),
        ("          WsSS<T, DKV ? 1 : 0>::run(acc + 64 * hh, da,\n"
         "                                    smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));\n",
         "          acc[hh] += float(da & 1u);\n")],
}
# Route wide_scores' paged verify (csrc/wide_scores.cuh): its product without
# the wgmma products (as SCORES_CUTS), its score pass's producer without the
# quantized payloads (the loads, dead, go with the conversions).
VERIFY_CUTS = {
    "no_products": [
        ("        WgmmaRS<128, T>::run(*reinterpret_cast<float(*)[64]>(acc + 64 * hh), pa[kk],\n"
         "                             smem_desc(sb + hh * 2 * 8192 + kk * 2048, 8192, 1024));\n",
         "        acc[hh] += __uint_as_float(pa[kk][hh] & 1u);\n")],
    "no_quantized_payloads": [(
        "          store_converted_rows<T>(smem + s * L::STAGE + L::TILE, BN, tid / 4 + 32 * j, "
        "tid % 4,\n                                  raw[j], (hi >> j) & 1, a.kind);\n", "")],
}
VERIFY_SERVE = (256, 2048, (1, 1, 2048))  # T, length, (Hq, Hkv, d) of the serving-d2048 chunk
SCORES_TRAIN = (8, 2, 1, 2048, 2048)  # B, Hq, Hkv, N, d of the training-bench-d2048 attention
SCORES_SERVE = (1, 1, 1, 2048, 2048)  # the serving-bench-d2048 prefill
D256 = (2, 8, 4, 8192, 256)  # B, Hq, Hkv, N, d of Gemma-2-2B's training attention
D256_CASES = {"global": (0, 0.0), "global_softcap50": (0, 50.0),
              "window4096": (4096, 0.0), "window4096_softcap50": (4096, 50.0)}
SHAPES = {"train_d512": (8, 8, 2), "serve_prefill_d512": (1, 4, 2)}
DECODE = (8, [2048] * 8, (4, 2, 512))  # B, lengths, (Hq, Hkv, d) of the serving-d512 decode
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


def d256_device_ms(gen, dev):
    """Device ms of each 16-bit d 256 sweep alone and of the family
    (``attn_bwd``) at D256 in each of D256_CASES, with their bounds."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import attn_fwd

    b, hq, hkv, n, d = D256
    q, do = (cs._rand(gen, (b, hq, n, d), torch.bfloat16, dev) for _ in range(2))
    k, v = (cs._rand(gen, (b, hkv, n, d), torch.bfloat16, dev) for _ in range(2))
    out = {}
    for case, (window, cap) in D256_CASES.items():
        kw = dict(causal=True, sm_scale=d ** -0.5, window=window, softcap=cap)
        o, lse = attn_fwd(q, k, v, **kw)
        delta = bk.attn_bwd_preprocess(o, do)
        pairs = b * cs.window_pairs(n, window) if window else None
        work = cs.bwd_work(b, hq, hkv, n, n, d, True, 2, pairs=pairs, segments=False)
        out[case] = {
            name: {"device_ms": cs.device_ms(fn),
                   "bound_ms": cs.bound(*work[name], cs.PEAK_BF16_FLOPS)[0]}
            for name, fn in (
                ("attn_bwd_dkv", lambda: bk.attn_bwd_dkv(q, k, v, do, lse, delta, **kw)),
                ("attn_bwd_dq", lambda: bk.attn_bwd_dq(q, k, v, do, lse, delta, **kw)),
                ("attn_bwd", lambda: bk.attn_bwd(q, k, v, o, lse, do, **kw)))}
        del o, lse, delta
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


def sdpa_bwd_device_ms(gen, dev):
    """Device ms of SDPA's backward (enable_gqa, torch.autograd.grad on a
    kept graph) at D256, global causal: the yardstick of the no-softcap
    family."""
    import torch
    import torch.nn.functional as F

    b, hq, hkv, n, d = D256
    q = cs._rand(gen, (b, hq, n, d), torch.bfloat16, dev).requires_grad_(True)
    k, v = (cs._rand(gen, (b, hkv, n, d), torch.bfloat16, dev).requires_grad_(True)
            for _ in range(2))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    do = torch.randn_like(out)
    ms = cs.device_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True))
    backend = cs.sdpa_backend(q, k, v)
    del q, k, v, out, do
    torch.cuda.empty_cache()
    return {"device_ms": ms, "backend": backend}


def d256_breakdown(parent):
    """The d 256 sweeps as built and cut (D256_CUTS), and with ``parent``
    (a tree's root) that tree's sweeps as built and cut
    (D256_PARENT_CUTS), timed by :func:`d256_device_ms` in the order
    parent, tree, the cuts, tree, parent; each build's d 256 instances'
    registers, spills and ptxas warnings."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk

    source, header = "attn_bwd_d256.cu", "attn_bwd_sm90.cuh"
    edits = {"as_built": [], **D256_CUTS}
    builds = {}
    if parent is not None:
        csrc = pathlib.Path(parent) / "flash_attention_dlrs_tpu_torch" / "csrc"
        parent_edits = {"as_built": [], **D256_PARENT_CUTS}
        builds = cs.start_mutant_builds(
            {f"parent_{n}": (source, header, e) for n, e in parent_edits.items()},
            csrc=csrc, every=True)
        edits.update({f"parent_{n}": e for n, e in parent_edits.items()})
    builds.update(cs.start_mutant_builds({n: (source, header, e) for n, e in edits.items()
                                          if not n.startswith("parent_")}, every=True))
    wait = cs.wait_mutant_builds(builds)
    slots = [(bk, "DKV_D256_KERNEL"), (bk, "DQ_D256_KERNEL")]
    real = [getattr(mod, attr) for mod, attr in slots]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = [n for n in ("parent_as_built", "as_built") if n in builds]
    order += [n for n in builds if n not in order] + order[::-1]
    out = {"build_wait_seconds": wait, "sdpa_bwd_global": sdpa_bwd_device_ms(gen, dev)}
    try:
        for name in order:
            _, lib, src = builds[name]
            for (mod, attr), kernel in zip(slots, real):
                setattr(mod, attr, _cuda.CudaKernel(src, kernel.symbol, kernel.argtypes,
                                                    library=lib))
            instances, warnings = cs.wgmma_instances(
                (lib.parent / "nvcc.log").read_text(errors="replace"), cs.BWD_WGMMA_ENTRY,
                cs.BWD_WGMMA_FLAGS, "_wgmma_kernel")
            rec = out.setdefault(name, {
                "edits": edits[name], "device_ms": [], "ptxas_warnings": warnings,
                "d256_instances": {k: v for k, v in instances.items() if k.endswith("_d256")}})
            rec["device_ms"].append(d256_device_ms(gen, dev))
    finally:
        for (mod, attr), kernel in zip(slots, real):
            setattr(mod, attr, kernel)
    return out


def scores_device_ms(backward):
    """A timer of route wide_scores' passes: device ms of each pass alone
    (one wave, causal bf16) at SCORES_TRAIN, and with ``backward`` false
    the forward's at SCORES_SERVE too, with their bounds."""

    def timer(gen, dev):
        import torch
        from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
        from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk
        from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

        out = {}
        for shape_name, (b, hq, hkv, n, d) in (("train_d2048", SCORES_TRAIN),
                                              ("serve_prefill_d2048", SCORES_SERVE)):
            if backward and shape_name != "train_d2048":
                continue
            q, do = (cs._rand(gen, (b, hq, n, d), torch.bfloat16, dev) for _ in range(2))
            k, v = (cs._rand(gen, (b, hkv, n, d), torch.bfloat16, dev) for _ in range(2))
            kw = dict(causal=True, sm_scale=d ** -0.5)
            wave = (0, b * hq * ws.n_tiles(n))
            work = cs.scores_pass_work(b, hq, hkv, n, d)
            o, lse = fk.attn_fwd_plain(q, k, v, **kw)  # the plain forward: nothing cut in it
            if backward:
                delta = bk.attn_bwd_preprocess(o, do)
                p, ds = ws.bwd_scores(q, k, v, do, lse, delta, wave, **kw)
                dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                calls = {"bwd_scores": lambda: ws.bwd_scores(q, k, v, do, lse, delta, wave, **kw),
                         "dq_product": lambda: ws.dq_product(ds, q, k, dq, wave, **kw),
                         "dkv_product": lambda: ws.dkv_product(p, ds, q, k, do, dk, dv,
                                                               (None, None), wave, **kw)}
            else:
                s, st = ws.fwd_scores(q, k, wave, **kw)
                calls = {"fwd_scores": lambda: ws.fwd_scores(q, k, wave, **kw),
                         "fwd_product": lambda: ws.fwd_product(s, st, v, o, lse, wave, **kw)}
            out[shape_name] = {name: {"device_ms": cs.device_ms(fn),
                                      "bound_ms": cs.bound(*work[name], cs.PEAK_BF16_FLOPS)[0]}
                               for name, fn in calls.items()}
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
        return out

    return timer


def verify_device_ms(gen, dev):
    """Device ms of route wide_scores' paged verify at VERIFY_SERVE from
    bf16 and int8 pools, each call after an L2 flush: each pass alone (the
    score pass, the product pass over the call's key splits, the merge of
    the splits) and the whole call, with their bounds
    (``chip_smoke.verify_pass_work``, ``chip_smoke.paged_work``)."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

    t_new, length, (hq, hkv, d) = VERIFY_SERVE
    out = {}
    for kind in ("bf16", "int8"):
        case = ("breakdown", "bfloat16", kind, (1, hq, hkv, d, cs.SERVE_PAGE, cs.SERVE_PPS,
                                                [length]), 0.0, t_new, False)
        q, (kp, vp), lens, table, call_kw, kw, qs, wave = cs._verify_setup(dev, gen, case)
        pools = dm._Pools(kp, vp)
        splits = dm.verify_splits("wide_scores", 1, hq, hkv, t_new, d, cs.SERVE_PPS,
                                  cs.SERVE_PAGE,
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
        s, st = ws.verify_scores(qs, pools, lens, table, wave, **kw)
        rows = t_new * hq
        parts = (torch.zeros((splits, rows, d), device=dev), torch.zeros((splits, rows), device=dev))
        o = torch.empty_like(q)
        pk = dict(num_q_heads=hq, tokens=t_new, dtype=q.dtype)
        pairs = sum(length - (t_new - 1) + t for t in range(t_new))
        work = cs.verify_pass_work(kind, rows, length, pairs, d, splits)
        calls = {"verify_scores": lambda: ws.verify_scores(qs, pools, lens, table, wave, **kw),
                 "verify_product": lambda: ws.verify_product(s, st, pools, lens, table, wave,
                                                             parts, splits=splits, **pk),
                 "verify_combine": lambda: ws.verify_combine(*parts, o),
                 "call": lambda: dm.paged_verify_attention(q, kp, vp, lens, table, **call_kw)}
        work["call"] = cs.paged_work(kind, 1, hq, hkv, d, [length], t_new)
        out[kind] = {name: {"device_ms": cs.device_ms(fn, between=cs.l2_flush(dev)),
                            "bound_ms": cs.bound(*work[name], cs.PEAK_BF16_FLOPS)[0]}
                     for name, fn in calls.items()}
        out[kind]["splits"] = splits
        del q, kp, vp, s, st, parts, o
        torch.cuda.empty_cache()
    return out


# Verify calls above 1024 whose key splits verify_split_sweep times: the
# serving-d2048 chunk, the same chunk at a context of 8192, and a
# speculative round of 8 sequences (T 8) at 2048; (B, T, length, pages a
# sequence), Hq1 Hkv1 d2048, pages of 128.
VERIFY_SPLIT_SHAPES = {"serve_chunk_T256_ctx2048": (1, 256, 2048, 17),
                       "serve_chunk_T256_ctx8192": (1, 256, 8192, 65),
                       "spec_B8_T8_ctx2048": (8, 8, 2048, 17)}


def verify_split_sweep(gen, dev):
    """Device ms of the whole verify call on route wide_scores (score pass,
    product pass, merge), each call after an L2 flush, from bf16 and int8
    pools at VERIFY_SPLIT_SHAPES, at every key split count that whole pages
    give (paged_verify_attention's pages_per_block), beside the count that
    decode.verify_splits picks from the shapes."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops import decode as dm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, (b, t_new, length, pps) in VERIFY_SPLIT_SHAPES.items():
        for kind in ("bf16", "int8"):
            case = ("sweep", "bfloat16", kind, (b, 1, 1, 2048, cs.SERVE_PAGE, pps, [length] * b),
                    0.0, t_new, False)
            q, (kp, vp), lens, table, call_kw, _, _, _ = cs._verify_setup(dev, gen, case)
            rule = dm.verify_splits("wide_scores", b, 1, 1, t_new, 2048, pps, cs.SERVE_PAGE, sms)
            by = {}
            for ppb in sorted({-(-pps // n) for n in range(1, pps + 1)}, reverse=True):
                splits = dm.scores_splits(pps * cs.SERVE_PAGE, dm.key_splits(pps, ppb, 64))
                by[splits] = cs.device_ms(
                    lambda: dm.paged_verify_attention(q, kp, vp, lens, table,
                                                      pages_per_block=ppb, **call_kw),
                    between=cs.l2_flush(dev))
            out[f"{name}_{kind}"] = {"rule": rule, "device_ms_by_splits": by}
            del q, kp, vp
            torch.cuda.empty_cache()
    return out


def decode_device_ms(gen, dev):
    """Device ms of one decode call (bf16 q) from bf16 and int8 pools at
    DECODE, each call after an L2 flush, and the call's byte bound."""
    import torch
    from flash_attention_dlrs_tpu_torch.ops.decode import paged_decode_attention

    b, lengths, (hq, hkv, d) = DECODE
    out = {}
    for kind in ("bf16", "int8"):
        q, kp, vp, lens, table = cs._paged_inputs(
            gen, dev, torch.bfloat16, kind, b, hq, hkv, d, cs.SERVE_PAGE, cs.SERVE_PPS, lengths,
            num_pages=b * cs.SERVE_PPS + 8)
        bound_ms, _ = cs.bound(*cs.paged_work(kind, b, hq, hkv, d, lengths, 0),
                               cs.PEAK_BF16_FLOPS)
        ms = cs.device_ms(lambda: paged_decode_attention(q, kp, vp, lens, table,
                                                         sm_scale=d ** -0.5),
                          between=cs.l2_flush(dev))
        out[kind] = {"device_ms": ms, "bound_ms": bound_ms}
        del q, kp, vp
        torch.cuda.empty_cache()
    return out


def breakdown(source, cuts, slots, timer, instance, header="wide.cuh"):
    """Builds ``source`` and its cut copies (edits of ``header``), then
    times each with ``timer`` (its kernels swapped into ``slots``:
    [(module, attribute)]); the variants' records by name, each with
    ``instance(log)`` of its build."""
    import torch
    from flash_attention_dlrs_tpu_torch import _cuda

    built = _cuda.build([source])
    only = _DECODE_ONLY_512 if source == "paged_decode_wide.cu" else []
    builds = cs.start_mutant_builds({n: (source, header, e + only)
                                     for n, e in cuts.items()}, every=header != "wide.cuh")
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
                                        "instances": instance(logs[name])})
            rec["device_ms"].append(timer(gen, dev))
    finally:
        for (mod, attr), kernel in zip(slots, real):
            setattr(mod, attr, kernel)
    return out


def main() -> int:
    import torch
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as bk
    from flash_attention_dlrs_tpu_torch.ops import decode as dm
    from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as fk

    if not torch.cuda.is_available():
        print("wide_breakdown_torch: no CUDA device is available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        at = args.index("--parent")
        parent = args[at + 1]
        del args[at:at + 2]
    parts = args or ["forward", "sweeps", "decode"]
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
    if "decode" in parts:
        rec["decode"] = breakdown(
            "paged_decode_wide.cu", DECODE_CUTS, [(dm, "DECODE_WIDE_KERNEL")], decode_device_ms,
            lambda log: {k: v for k, v in cs.paged_instances(log, "paged_decode_wide.cu").items()
                         if k in ("decode_wide_bf16_d512", "decode_wide_int8_d512")})
    if "scores" in parts:
        from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

        for half, source, slots in (
                ("forward", "attn_fwd_scores.cu",
                 [(ws, "FWD_SCORES_KERNEL"), (ws, "FWD_PRODUCT_KERNEL")]),
                ("backward", "attn_bwd_scores.cu",
                 [(ws, "BWD_SCORES_KERNEL"), (ws, "DQ_PRODUCT_KERNEL"),
                  (ws, "DKV_PRODUCT_KERNEL")])):
            rec[f"scores_{half}"] = breakdown(
                source, SCORES_CUTS, slots, scores_device_ms(half == "backward"),
                lambda log, source=source: cs.scores_instances(log, source),
                header="wide_scores.cuh")
    if "verify" in parts:
        from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws

        rec["verify"] = breakdown(
            "paged_verify_wide.cu", VERIFY_CUTS,
            [(ws, "VERIFY_SCORES_KERNEL"), (ws, "VERIFY_PRODUCT_KERNEL"),
             (ws, "VERIFY_COMBINE_KERNEL")], verify_device_ms,
            lambda log: {k: v for k, v in cs.scores_instances(log, "paged_verify_wide.cu").items()
                         if k.startswith("verify_")},
            header="wide_scores.cuh")
    if "verify_splits" in parts:
        dev = torch.device("cuda", 0)
        rec["verify_splits"] = verify_split_sweep(torch.Generator(device=dev).manual_seed(0),
                                                  dev)
    if "d256" in parts:
        rec["d256"] = d256_breakdown(parent)
    rec["card"] = cs.card_line()
    cs.emit(rec)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
