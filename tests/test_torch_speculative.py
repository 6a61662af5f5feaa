"""Decode bursts and speculative serving of the PyTorch port, against the JAX
package on the CPU.

The port's ``runtime/speculative.py`` runs each burst step and each
speculative round as one body over static buffers: in a Python loop here,
replayed as a CUDA graph on the card (``chip_smoke.py`` phases
``serve_burst`` and ``serve_spec``).  Both packages serve the JAX tiny
config in fp32 with the same weights (``params_from_jax``).  The JAX engine
runs three times, in one module fixture (plain greedy serving, then
speculative serving with a bad and with a perfect draft, on one target
engine); every other case holds the port's forms against each other and
against those outputs.  Greedy tokens and greedy ``spec_stats``
must be identical.  Seeded sampling draws from a hash of (seed, position)
that cannot match ``jax.random``'s bits, so it is held to its contract: a
stream reproduces itself, the burst equals the step loop, and rejection
sampling keeps the target distribution (chi-square).
"""

import ast
import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.runtime import sampling as jsampling
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from flash_attention_dlrs_tpu_torch.models import params_from_jax
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.runtime import sampling as tsampling
from flash_attention_dlrs_tpu_torch.runtime import speculative as tspec
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)
TCFG = TConfig.tiny(dtype=torch.float32, remat=False)
# a structurally smaller draft (tests/test_speculative.py:51)
JSMALL = dataclasses.replace(JCFG, n_layers=1, d_ff=128)
TSMALL = dataclasses.replace(TCFG, n_layers=1, d_ff=128)
MANY = [[i + 1, i + 2, i + 3, i + 4] for i in range(5)]  # tests/test_engine.py:437
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]  # tests/test_speculative.py:24
RAGGED = [[5, 7, 11], [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8]]
KW = dict(num_pages=64, page_size=128, num_slots=2, pages_per_seq=4)


@pytest.fixture(scope="module")
def jparams():
    return {name: init_params(jax.random.PRNGKey(seed), cfg)
            for name, seed, cfg in (("target", 0, JCFG), ("bad", 1, JCFG),
                                    ("small", 2, JSMALL))}


@pytest.fixture(scope="module")
def models(jparams):
    cfgs = {"target": TCFG, "bad": TCFG, "small": TSMALL}
    return {name: params_from_jax(jax.tree.map(np.asarray, p), cfgs[name], device="cpu")
            for name, p in jparams.items()}


@pytest.fixture(scope="module")
def jax_runs(jparams):
    """The JAX engine's three runs, on one target and one draft engine
    (their programs compile once): plain greedy serving of MANY (2 slots,
    9 new tokens), then speculative serving of MANY (γ 3, bursts of 4) with
    the bad draft's weights and with the target's (the perfect draft)."""
    kw = dict(KW, kv_dtype=jnp.float32)
    tgt = JEngine(jparams["target"], JCFG, **kw)
    runs = {"plain": tgt.generate(MANY, max_new_tokens=9)}
    draft = JEngine(jparams["bad"], JCFG, **kw)
    tgt.attach_draft(draft, gamma=3)
    for name in ("bad", "target"):
        draft.params = jparams[name]  # the same programs, other weights
        tgt.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        runs[name] = (tgt.generate(MANY, max_new_tokens=9, burst=4),
                      dict(tgt.spec_stats))
    return runs


def _port(models, name="target", cfg=TCFG, **kw):
    kw = {**KW, "kv_dtype": torch.float32, **kw}
    return TEngine(models[name], cfg, device="cpu", **kw)


def _pages_back(*engines):
    return all(len(e.allocator.free_pages) == e.pools.k[0].shape[1] - 1
               for e in engines)


# ---------------------------------------------------------------------------
# speculative_verify
# ---------------------------------------------------------------------------


def _verify_both(t_logits, d_logits, proposals):
    """The greedy rule (temperature 0) through both packages."""
    slots = proposals.shape[0]
    temp = np.zeros(slots, np.float32)
    ints = np.zeros(slots, np.int32)
    ones = np.ones(slots, np.float32)
    want = jsampling.speculative_verify(
        jnp.asarray(t_logits), jnp.asarray(d_logits), jnp.asarray(proposals),
        jnp.asarray(temp), jnp.asarray(ints), jnp.asarray(ones), jnp.asarray(ints),
        jnp.asarray(ints))
    got = tsampling.speculative_verify(
        torch.from_numpy(t_logits), torch.from_numpy(d_logits),
        torch.from_numpy(proposals).long(), torch.from_numpy(temp),
        torch.from_numpy(ints), torch.from_numpy(ones), torch.from_numpy(ints),
        torch.from_numpy(ints))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_speculative_verify_greedy_rule_matches_jax():
    """JAX's own case (tests/test_speculative.py:155)."""
    vocab, gamma = 8, 3
    t_logits = np.zeros((2, gamma, vocab), np.float32)
    for j, g in enumerate([3, 5, 1]):
        t_logits[0, j, g] = 5.0
    for j, g in enumerate([2, 6, 4]):
        t_logits[1, j, g] = 5.0
    d_logits = np.zeros((2, gamma - 1, vocab), np.float32)
    proposals = np.asarray([[0, 3, 5], [0, 7, 6]], np.int32)
    (w_tok, w_n), (g_tok, g_n) = _verify_both(t_logits, d_logits, proposals)
    assert g_n.tolist() == w_n.tolist() == [3, 1]
    np.testing.assert_array_equal(g_tok, w_tok)
    assert g_tok[0].tolist() == [3, 5, 1] and g_tok[1, 0] == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_verify_greedy_random_logits_match_jax(seed):
    """Random logits; each proposal is the target's argmax or, with
    probability 1/3, another token, so every acceptance length occurs."""
    rng = np.random.default_rng(seed)
    slots, gamma, vocab = 16, 5, 50
    t_logits = rng.standard_normal((slots, gamma, vocab), dtype=np.float32)
    d_logits = rng.standard_normal((slots, gamma - 1, vocab), dtype=np.float32)
    greedy = t_logits.argmax(-1)
    other = rng.integers(0, vocab, (slots, gamma))
    proposals = np.where(rng.random((slots, gamma)) < 1 / 3, other, greedy)
    proposals[:, 1:] = np.where(rng.random((slots, gamma - 1)) < 1 / 3,
                                other[:, 1:], greedy[:, :-1])
    (w_tok, w_n), (g_tok, g_n) = _verify_both(t_logits, d_logits,
                                              proposals.astype(np.int32))
    np.testing.assert_array_equal(g_n, w_n)
    np.testing.assert_array_equal(g_tok, w_tok)
    assert len(set(g_n.tolist())) > 1


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
def test_speculative_verify_preserves_target_distribution(top_k, top_p):
    """Rejection sampling with the port's own draws: the first committed
    token's marginal is the filtered target distribution, for an
    arbitrary draft (tests/test_speculative.py:112), with and without
    top-k / top-p."""
    rng = np.random.default_rng(7)
    vocab, gamma, trials = 8, 3, 4000
    t_logits = torch.from_numpy(rng.normal(size=(1, gamma, vocab)).astype(np.float32))
    d_logits = torch.from_numpy(rng.normal(size=(1, gamma - 1, vocab)).astype(np.float32))
    temp = torch.ones(trials)
    k = torch.full((trials,), top_k, dtype=torch.int32)
    p = torch.full((trials,), top_p)
    seeds = torch.arange(trials, dtype=torch.int32)
    q0 = torch.softmax(tsampling.filtered_logits(d_logits[:, 0], temp[:1], k[:1], p[:1]),
                       dim=-1)[0].double().numpy()
    d1 = rng.choice(vocab, size=trials, p=q0 / q0.sum())  # drawn from the draft
    proposals = torch.from_numpy(np.stack(
        [np.zeros(trials), d1, rng.integers(0, vocab, trials)], 1).astype(np.int64))
    tokens, n_committed = tsampling.speculative_verify(
        t_logits.expand(trials, -1, -1), d_logits.expand(trials, -1, -1), proposals,
        temp, k, p, seeds, torch.zeros(trials, dtype=torch.int32))
    assert bool((n_committed >= 1).all())
    expected = torch.softmax(tsampling.filtered_logits(
        t_logits[:, 0], temp[:1], k[:1], p[:1]), dim=-1)[0].double().numpy()
    counts = np.bincount(tokens[:, 0].numpy(), minlength=vocab)
    kept = expected > 1e-12
    assert counts[~kept].sum() == 0  # nothing outside the filter
    e = trials * expected[kept]
    chi2 = float(np.sum((counts[kept] - e) ** 2 / e))
    # chi2(kept - 1) at 99.9%: 24.3 for 7 degrees of freedom, less below
    assert chi2 < 24.3, (chi2, counts.tolist(), e.tolist())


# ---------------------------------------------------------------------------
# sample_tokens
# ---------------------------------------------------------------------------


def test_sampled_stream_reproduces_in_any_slot_and_batch():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((1, 500), dtype=np.float32))
    sp = tsampling.SamplingParams(temperature=1.0, seed=77)

    def draw(slot, batch, pos):
        params = [tsampling.SamplingParams(temperature=0.5, seed=slot + 100 * i)
                  for i in range(batch)]
        params[slot] = sp
        temp, k, p, seeds = tsampling.batch_params(params, device="cpu")
        filler = torch.from_numpy(rng.standard_normal((batch, 500), dtype=np.float32))
        filler[slot] = logits[0]
        positions = torch.full((batch,), pos, dtype=torch.int32)
        return int(tsampling.sample_tokens(filler, temp, k, p, seeds, positions)[slot])

    for pos in (0, 5, 1 << 20):
        drawn = {draw(slot, batch, pos) for slot, batch in ((0, 1), (2, 4), (6, 7))}
        assert len(drawn) == 1
    assert len({draw(0, 1, pos) for pos in range(20)}) > 5  # positions differ


def test_greedy_is_argmax_and_sampled_tokens_stay_in_the_top_k():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 300), dtype=np.float32))
    pos = torch.arange(4, dtype=torch.int32)
    temp, k, p, seeds = tsampling.batch_params([None] * 4, device="cpu")
    want = torch.argmax(logits, dim=-1)
    assert torch.equal(tsampling.sample_tokens(logits, temp, k, p, seeds, pos), want)
    assert torch.equal(tsampling.sample_tokens(logits, temp, k, p, seeds, pos,
                                               sample=False), want)
    temp, k, p, seeds = tsampling.batch_params(
        [tsampling.SamplingParams(temperature=1.5, top_k=5, seed=s) for s in range(4)],
        device="cpu")
    allowed = torch.topk(logits, 5, dim=-1).indices
    for step in range(30):
        tok = tsampling.sample_tokens(logits, temp, k, p, seeds, pos + step)
        assert all(int(tok[i]) in allowed[i].tolist() for i in range(4))


def test_sampled_marginal_is_the_softmax():
    """Gumbel-max over the hash's uniforms draws from softmax(logits / T):
    one slot's logits at 4000 positions, chi-square."""
    rng = np.random.default_rng(5)
    vocab, trials = 8, 4000
    row = rng.normal(size=vocab).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (trials, 1)))
    temp, k, p, seeds = tsampling.batch_params(
        [tsampling.SamplingParams(temperature=0.8, seed=9)] * trials, device="cpu")
    tok = tsampling.sample_tokens(logits, temp, k, p, seeds,
                                  torch.arange(trials, dtype=torch.int32))
    expected = torch.softmax(torch.from_numpy(row) / 0.8, dim=-1).double().numpy()
    counts = np.bincount(tok.numpy(), minlength=vocab)
    e = trials * expected
    assert float(np.sum((counts - e) ** 2 / e)) < 24.3


class _NoHostRead(TorchDispatchMode):
    """Refuses the operations that read a device value back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.nonzero.default):
            raise RuntimeError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def _programs(models, sample):
    """A plain and a speculative program of the tiny model, each made by
    one normal call: ``{name: StepGraph}``."""
    tgt, d = _port(models), _port(models, "bad")
    (temp, k, p, seeds), _ = tgt._slot_sampling()
    if sample:
        temp.fill_(0.9)
    x0, base, active = np.asarray([5, 6]), np.asarray([4, 4]), np.asarray([True, True])
    for e in (tgt, d):
        for sid in ("a", "b"):
            e.allocator.allocate(sid, 20)
    tbl = np.asarray([tgt.allocator.page_tables["a"], tgt.allocator.page_tables["b"]]
                     + [], np.int32)
    tbl = np.pad(tbl, ((0, 0), (0, KW["pages_per_seq"] - tbl.shape[1])))
    plain = tspec.make_plain_generate(TCFG, KW["page_size"], 3)
    plain(tgt.params, tgt.pools, x0, base, tbl, active, -1, temp, k, p, seeds,
          np.asarray([3, 3]), sample=sample)
    spec = tspec.make_spec_generate(TCFG, TCFG, 3, KW["page_size"], 4)
    spec(tgt.params, tgt.pools, d.params, d.pools, x0, base, tbl, tbl, active, -1,
         temp, k, p, seeds, np.asarray([4, 4]), sample=sample)
    return {"plain": next(iter(plain.programs.values()))[1],
            "spec": next(iter(spec.programs.values()))[1]}


def test_dispatch_mode_catches_item_but_not_tolist():
    """The mode below sees ``.item()`` and ``nonzero`` but not ``.tolist()``
    in this torch, so the bodies are also scanned for host reads."""
    t = torch.arange(3)
    with _NoHostRead():
        t.tolist()
        with pytest.raises(RuntimeError, match="host read"):
            t[0].item()
        with pytest.raises(RuntimeError, match="host read"):
            t.nonzero()


@pytest.mark.parametrize("sample", [False, True])
def test_burst_and_round_bodies_make_no_host_read(models, sample):
    """The burst step and the speculative round run under a dispatch mode
    that refuses host reads, and no function of theirs calls .tolist(),
    .item(), .cpu() or .numpy()."""
    programs = _programs(models, sample)
    with _NoHostRead():
        for run in programs.values():
            run.body()
    funcs = [run.body for run in programs.values()] + [
        tspec._propose, tspec._verify_accept, tspec._rows_offs,
        tsampling.sample_tokens, tsampling.filtered_logits,
        tsampling.speculative_verify, tsampling._uniforms, tsampling._gumbel_argmax,
        tfwd.lowbias32]
    for fn in funcs:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        reads = [n.func.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                 and n.func.attr in ("tolist", "item", "cpu", "numpy")]
        assert not reads, (fn.__qualname__, reads)


# ---------------------------------------------------------------------------
# write_prompt_kv_batch
# ---------------------------------------------------------------------------


KV = {"fp32": (jnp.float32, torch.float32, False),
      "bf16": (jnp.bfloat16, torch.bfloat16, False),
      "int8": (jnp.int8, torch.int8, True),
      "int4": ("int4", "int4", True),
      "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, True)}


@pytest.mark.parametrize("kv", list(KV))
def test_write_prompt_kv_batch_matches_jax(kv):
    """Three ragged prompts (5, 70 and 33 tokens at page 32), every layer,
    rows padded with the null page 0: the pools of both packages agree
    within one quantization step (XLA may fold the division by qmax under
    jit), value pools exactly."""
    jd, td, quantized = KV[kv]
    ps, lens = 32, [5, 70, 33]
    rng = np.random.default_rng(11)
    kvs = [tuple(rng.standard_normal((3, TCFG.n_kv_heads, 128, TCFG.head_dim))
                 .astype(np.float32) for _ in range(2)) for _ in range(TCFG.n_layers)]
    pages_b = np.zeros((3, 3), np.int32)  # null-page padded
    pages_b[0, :1], pages_b[1, :3], pages_b[2, :2] = [4], [1, 7, 2], [3, 5]
    jpools = jdecoding.init_kv_pools(JCFG, num_pages=8, page_size=ps, dtype=jd,
                                     quantized=quantized)
    jpools = jdecoding.write_prompt_kv_batch(
        jpools, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in kvs),
        jnp.asarray(pages_b), ps)
    tpools = tdecoding.init_kv_pools(TCFG, num_pages=8, page_size=ps, dtype=td,
                                     quantized=quantized, device="cpu")
    tdecoding.write_prompt_kv_batch(
        tpools, [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in kvs],
        torch.from_numpy(pages_b), ps)
    live = [p for row, n in zip(pages_b, lens) for p in row[:-(-n // ps)]]
    d = tpools.k[0].shape[-1]  # the kernels' width; both packages zero-pad to it
    for li in range(TCFG.n_layers):
        for t_pool, j_pool in zip(tpools.layer(li), _jax_layer(jpools, li)):
            if not quantized:
                np.testing.assert_array_equal(
                    t_pool.float().numpy()[:, live],
                    np.asarray(j_pool.astype(jnp.float32))[:, live, :, :d])
                continue
            want = np.asarray(j_pool.dequantize())[:, live, :, :d]
            got = t_pool.dequantize().numpy()[:, live]
            sc = t_pool.scales.numpy()[:, live]
            np.testing.assert_allclose(sc, np.asarray(j_pool.scales)[:, live], rtol=1e-5)
            step = float(sc.max()) * (1.0 if kv in ("int8", "int4") else 32.0)
            np.testing.assert_allclose(got, want, atol=step, rtol=0)


def _jax_layer(pools, li):
    from flash_attention_dlrs_tpu.ops import quantization as jq

    if not pools.quantized:
        return pools.k[li], pools.v[li]
    kind = jq.Int4QuantizedTensor if pools.int4 else jq.QuantizedTensor
    return (kind(pools.k[li], pools.k_scales[li]), kind(pools.v[li], pools.v_scales[li]))


# ---------------------------------------------------------------------------
# The engine: bursts (tests/test_engine.py:437-472)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("burst,n,new", [(4, 5, 9), (16, 2, 7)])
def test_step_burst_matches_per_token_step_and_jax(models, jax_runs, burst, n, new):
    """generate(burst=k) equals the step loop and the JAX engine, across
    admissions (more requests than slots) and budgets that are no
    multiple of the burst."""
    want = _port(models).generate(MANY[:n], max_new_tokens=new)
    eng = _port(models)
    assert eng.generate(MANY[:n], max_new_tokens=new, burst=burst) == want
    assert want == [w[:new] for w in jax_runs["plain"][:n]]
    assert eng.scheduler.stats.retired == n and _pages_back(eng)


def test_step_burst_eos_stops_early(models):
    ref = _port(models, num_slots=1).generate(PROMPTS[:1], max_new_tokens=10)[0]
    eos = ref[3]  # forces an early stop mid-burst
    want = _port(models, num_slots=1, eos_token=eos).generate(
        PROMPTS[:1], max_new_tokens=10)[0]
    got = _port(models, num_slots=1, eos_token=eos).generate(
        PROMPTS[:1], max_new_tokens=10, burst=8)[0]
    assert got == want and got[-1] == eos and len(got) < len(ref)


def test_generate_stream_bursts_match_generate(models):
    events = list(_port(models).generate_stream(MANY, max_new_tokens=6, burst=4))
    toks = {}
    for ev in events:
        if ev.token is not None:
            toks.setdefault(ev.request_id, []).append(ev.token)
    assert sum(ev.done for ev in events) == len(MANY)
    assert [toks[f"req{i}"] for i in range(len(MANY))] == _port(models).generate(
        MANY, max_new_tokens=6)


def test_burst_with_logprobs_gives_the_step_loops_tokens_and_logprobs(models):
    want = _port(models).generate(MANY, max_new_tokens=5, return_logprobs=True)
    got = _port(models).generate(MANY, max_new_tokens=5, return_logprobs=True,
                                 burst=4)
    assert got[0] == want[0]
    np.testing.assert_allclose(np.concatenate(got[1]), np.concatenate(want[1]),
                               rtol=1e-6, atol=1e-6)


def test_seeded_burst_equals_the_step_loop(models):
    sp = tsampling.SamplingParams(temperature=0.8, top_k=20, seed=41)
    want = _port(models).generate(MANY, max_new_tokens=8, sampling=sp)
    assert _port(models).generate(MANY, max_new_tokens=8, sampling=sp, burst=4) == want
    # tests/test_speculative.py:290: the fused loop keys draws like the host loop
    assert _port(models).generate_fused(PROMPTS, max_new_tokens=8, sampling=sp) == \
        _port(models).generate(PROMPTS, max_new_tokens=8, sampling=sp)
    assert want != _port(models).generate(
        MANY, max_new_tokens=8, sampling=dataclasses.replace(sp, seed=42), burst=4)


# ---------------------------------------------------------------------------
# The engine: attach_draft (tests/test_engine.py:475-526)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["bad", "target"])
def test_speculative_serving_matches_plain_and_jax(models, jax_runs, draft):
    """attach_draft + bursts: greedy tokens equal plain serving whatever
    the draft, spec_stats equal the JAX engine's, and pages come back on
    both engines."""
    tgt, d = _port(models), _port(models, draft)
    tgt.attach_draft(d, gamma=3)
    got = tgt.generate(MANY, max_new_tokens=9, burst=4)
    want, stats = jax_runs[draft]
    assert got == want == jax_runs["plain"]
    assert tgt.spec_stats == stats
    assert _pages_back(tgt, d)
    if draft == "target":
        assert stats["accepted"] / stats["proposed"] > 0.9
    else:
        assert stats["rounds"] > 0


def test_speculative_serving_eos(models):
    ref = _port(models, num_slots=1).generate(PROMPTS[:1], max_new_tokens=10)[0]
    eos = ref[3]
    want = _port(models, num_slots=1, eos_token=eos).generate(
        PROMPTS[:1], max_new_tokens=10)[0]
    tgt = _port(models, num_slots=1, eos_token=eos)
    d = _port(models, num_slots=1, eos_token=eos)
    tgt.attach_draft(d, gamma=3)
    got = tgt.generate(PROMPTS[:1], max_new_tokens=10, burst=8)[0]
    assert got == want and got[-1] == eos and _pages_back(tgt, d)


def test_step_with_a_draft_runs_one_token_rounds(models, jax_runs):
    """step() with a draft attached commits through a 1-token speculative
    burst: the draft's cache never misses a committed token."""
    tgt, d = _port(models), _port(models, "bad")
    tgt.attach_draft(d, gamma=3)
    assert tgt.generate(MANY, max_new_tokens=9) == jax_runs["plain"]
    assert tgt.spec_stats["rounds"] > 0 and _pages_back(tgt, d)


# ---------------------------------------------------------------------------
# generate_speculative, generate_speculative_fused, generate_fused
# (tests/test_speculative.py:28-306)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gamma", [2, 4])
def test_speculative_forms_equal_greedy(models, fused, gamma):
    plain = _port(models, num_slots=3).generate(RAGGED, max_new_tokens=12)
    tgt, d = _port(models, num_slots=3), _port(models, "bad", num_slots=3)
    form = tgt.generate_speculative_fused if fused else tgt.generate_speculative
    assert form(RAGGED, draft=d, gamma=gamma, max_new_tokens=12) == plain
    st = tgt.spec_stats
    assert st["rounds"] >= 1 and 0 <= st["accepted"] <= st["proposed"]
    assert _pages_back(tgt, d)


def test_speculative_forms_agree_on_spec_stats(models):
    stats, outs = [], []
    for form in ("generate_speculative", "generate_speculative_fused"):
        tgt = _port(models)
        outs.append(getattr(tgt, form)(PROMPTS, draft=_port(models, "bad"), gamma=3,
                                       max_new_tokens=10))
        stats.append(tgt.spec_stats)
    assert outs[0] == outs[1]
    assert stats[0]["accepted"] == stats[1]["accepted"]
    assert stats[0]["proposed"] == stats[1]["proposed"]


def test_perfect_draft_takes_the_minimal_rounds(models):
    """Draft == target accepts every proposal: rounds == ceil((T − 1) / γ)
    in both forms (a stale draft K/V would cost extra rounds)."""
    gamma, max_new = 4, 13  # 12 post-admission tokens = 3 full rounds
    for form in ("generate_speculative", "generate_speculative_fused"):
        tgt = _port(models)
        out = getattr(tgt, form)([[1, 2, 3, 4, 5]], draft=_port(models), gamma=gamma,
                                 max_new_tokens=max_new)
        assert len(out[0]) == max_new
        assert tgt.spec_stats["rounds"] == -(-(max_new - 1) // gamma) == 3


def test_smaller_draft_config(models):
    """A draft of one layer and half the MLP: both speculative forms give
    plain greedy's tokens and agree on spec_stats."""
    want = _port(models, num_slots=3).generate(RAGGED, max_new_tokens=12)
    stats = []
    for form in ("generate_speculative", "generate_speculative_fused"):
        tgt = _port(models, num_slots=3)
        d = _port(models, "small", cfg=TSMALL, num_slots=3)
        assert getattr(tgt, form)(RAGGED, draft=d, gamma=4, max_new_tokens=12) == want
        stats.append(tgt.spec_stats)
    assert stats[0]["accepted"] == stats[1]["accepted"]
    assert stats[0]["proposed"] == stats[1]["proposed"]


def test_speculative_with_int8_kv(models):
    def eng(name="target"):
        return _port(models, name, quantized_kv=True, kv_dtype=torch.int8)

    plain = eng().generate(PROMPTS, max_new_tokens=8)
    assert eng().generate_speculative(PROMPTS, draft=eng(), gamma=3,
                                      max_new_tokens=8) == plain
    tgt = eng()
    tgt.attach_draft(eng("bad"), gamma=3)
    assert tgt.generate(PROMPTS, max_new_tokens=8, burst=4) == plain


def test_finished_slot_draft_lengths_stay_bounded(models):
    """A slot that stops at EOS keeps riding the fixed-shape draft calls;
    its draft lengths are rolled back every round, so its capacity stays
    near its short stream."""
    plain = _port(models).generate(PROMPTS, max_new_tokens=12)
    eos = plain[0][1]  # slot 0 stops after 2 tokens
    assert eos not in plain[1][:8]
    tgt = _port(models, eos_token=eos)
    d = _port(models, "bad", eos_token=eos)
    seen = {}
    orig = d.allocator.ensure_capacity

    def spy(sid, n):
        seen[sid] = max(seen.get(sid, 0), n)
        return orig(sid, n)

    d.allocator.ensure_capacity = spy
    out = tgt.generate_speculative(PROMPTS, draft=d, gamma=4, max_new_tokens=12)
    assert out[0][:2] == plain[0][:2] and out[0][-1] == eos
    assert len(out[1]) == 12
    assert seen["spec0"] <= len(PROMPTS[0]) + 2 + 2 * 4, seen


def test_generate_fused_ragged_prompt_lengths(models):
    want = _port(models, num_slots=3).generate(RAGGED, max_new_tokens=6)
    eng = _port(models, num_slots=3)
    assert eng.generate_fused(RAGGED, max_new_tokens=6) == want
    assert eng.last_fused_seconds > 0 and _pages_back(eng)


def test_seeded_speculative_reproduces_itself(models):
    """temperature > 0 through both speculative forms: each reproduces
    itself, a seed changes the stream, and max_new_tokens holds."""
    def run(form, seed):
        tgt = _port(models)
        return getattr(tgt, form)(
            PROMPTS, draft=_port(models, "bad"), gamma=3, max_new_tokens=10,
            sampling=tsampling.SamplingParams(temperature=1.0, seed=seed))

    for form in ("generate_speculative", "generate_speculative_fused"):
        a = run(form, 5)
        assert a == run(form, 5) != run(form, 11)
        assert all(len(o) == 10 for o in a)
        assert all(0 <= t < TCFG.vocab_size for o in a for t in o)
