"""Quantized-KV serving, chunked prefill and the prefix cache of the
PyTorch port, against the JAX package on the CPU.

The same weights (``params_from_jax``) serve through both packages'
``DecodeEngine``: greedy tokens must be identical for int8, int4 and fp8
KV, for chunked prefill and with the prefix cache (hits counted the same).
``make_verify_step`` logits agree to 1e-5 and ``PagedKVCache`` pools bit
for bit.  The int4 write of a chunk longer than half a page, where the JAX
package loses a nibble (ROADMAP.md queue 3), is held against the oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.ops import quantization as jq
from flash_attention_dlrs_tpu.ops.decode import paged_decode_attention as jpaged
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu.runtime.kv_cache import PagedKVCache as JCache
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from flash_attention_dlrs_tpu_torch.models import params_from_jax
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.runtime import PagedKVCache as TCache
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

# tests/test_engine.py:91-110 and tests/test_prefix_cache.py
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
           head_dim=32, d_ff=128)
JCFG = JConfig(**CFG, dtype=jnp.float32)
TCFG = TConfig(**CFG, dtype=torch.float32)
PS = 32
PROMPTS = [list(range(1, 40)), [7, 6, 5], list(range(60, 100))]
SHARED = list(range(1, 1 + 3 * PS))  # three full pages
PREFIXED = [SHARED + [100, 101], SHARED + [90, 91, 92], SHARED + [5] * 20]
KV = {
    "fp32": (jnp.float32, torch.float32, False),
    "int8": (jnp.int8, torch.int8, True),
    "int4": ("int4", "int4", True),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, True),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2, True),
}
# (kv, prefill_chunk, prefix cache): the JAX int4 write is right only for
# chunks up to page_size / 2, so int4 takes chunk 16 here.
ENGINE_RUNS = [
    ("int8", 0, False), ("int4", 0, False), ("e4m3", 0, False),
    ("fp32", 16, False), ("int8", 64, False), ("int4", 16, True),
]


@pytest.fixture(scope="module")
def jparams():
    return init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")


def _engine_kw(kv, chunk, cached):
    _, _, quantized = KV[kv]
    return dict(num_pages=64, page_size=PS, pages_per_seq=8, num_slots=3,
                quantized_kv=quantized, prefill_chunk=chunk,
                enable_prefix_cache=cached)


def _serve(engine, cached):
    prompts = PREFIXED if cached else PROMPTS
    out = engine.generate(prompts, max_new_tokens=6)
    if cached:  # one request at a time after the first, so later ones hit
        out += [engine.generate([p], max_new_tokens=6)[0] for p in PREFIXED]
    return out


@pytest.fixture(scope="module")
def jax_runs(jparams):
    runs = {}
    for kv, chunk, cached in ENGINE_RUNS:
        eng = JEngine(jparams, JCFG, kv_dtype=KV[kv][0], **_engine_kw(kv, chunk, cached))
        hits = None
        out = _serve(eng, cached)
        if cached:
            hits = (eng.prefix_cache.hits, eng.prefix_cache.misses)
        runs[kv, chunk, cached] = (out, hits)
    return runs


@pytest.mark.parametrize("kv,chunk,cached", ENGINE_RUNS,
                         ids=[f"{kv}-chunk{c}{'-prefix' if p else ''}"
                              for kv, c, p in ENGINE_RUNS])
def test_engine_greedy_tokens_identical_to_jax(model, jax_runs, kv, chunk, cached):
    eng = TEngine(model, TCFG, kv_dtype=KV[kv][1], device="cpu",
                  **_engine_kw(kv, chunk, cached))
    out = _serve(eng, cached)
    want, hits = jax_runs[kv, chunk, cached]
    assert out == want
    assert all(len(o) == 6 for o in out)
    if cached:
        assert (eng.prefix_cache.hits, eng.prefix_cache.misses) == hits
        assert eng.prefix_cache.hits >= 3
    # every page but the null page and the cache's own is back
    held = len(eng.prefix_cache._entries) if cached else 0
    assert len(eng.allocator.free_pages) == eng.pools.k[0].shape[1] - 1 - held
    assert eng.stats()["kv_dtype"] == str(KV[kv][1])


@pytest.mark.parametrize("kv", ["int8", "int4", "e4m3", "e5m2"])
def test_every_quantized_kind_serves_with_the_prefix_cache(model, kv):
    """Chunked prefill (chunk 24 > page_size/2, so int4 writes nibble
    pairs in one step) with the prefix cache gives the greedy tokens of the
    same chunked engine without it: the shared pages hold what each request
    would have written."""
    def serve(cached):
        eng = TEngine(model, TCFG, kv_dtype=KV[kv][1], device="cpu",
                      **_engine_kw(kv, 24, cached))
        return [eng.generate([p], max_new_tokens=4)[0] for p in PREFIXED], eng
    plain, _ = serve(False)
    cached, eng = serve(True)
    assert cached == plain and eng.prefix_cache.hits == 2
    assert all(len(o) == 4 and all(0 <= x < CFG["vocab_size"] for x in o)
               for o in plain)


def test_chunked_prefill_skips_the_cached_prefix(model):
    eng = TEngine(model, TCFG, kv_dtype=torch.int8, device="cpu",
                  **_engine_kw("int8", 32, True))
    calls = []
    orig = eng._chunk_prefill
    eng._chunk_prefill = lambda *a: calls.append(1) or orig(*a)
    shared = list(range(4 * PS))
    eng.generate([shared], max_new_tokens=2)
    assert len(calls) == 4
    calls.clear()
    eng.generate([shared + [99]], max_new_tokens=2)
    # all four pages are cached: only the final token is prefilled
    assert len(calls) == 1 and eng.prefix_cache.hits == 1


def test_engine_options_are_checked(model):
    with pytest.raises(ValueError, match="requires quantized_kv"):
        TEngine(model, TCFG, kv_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        TEngine(model, TCFG, enable_prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        TEngine(model, TCFG, kv_dtype=torch.bfloat16, quantized_kv=True, device="cpu")
    with pytest.raises(ValueError, match="quantized=True"):
        TEngine(model, TCFG, kv_dtype=torch.int8, device="cpu")


# ---------------------------------------------------------------------------
# The verify step and the pools' writes
# ---------------------------------------------------------------------------


def _prompt_pools(pkg, kv, model, jparams, prompt, page_size=PS, num_pages=8):
    """Pools with ``prompt``'s K/V in pages 0.. (dense prefill)."""
    t = len(prompt)
    n_pages = -(-t // page_size)
    toks = np.zeros((1, 128), np.int32)
    toks[0, :t] = prompt
    if pkg == "jax":
        jd, _, quantized = KV[kv]
        pools = jdecoding.init_kv_pools(JCFG, num_pages=num_pages, page_size=page_size,
                                        dtype=jd, quantized=quantized)
        _, kvs = jdecoding.make_prefill(JCFG)(jparams, jnp.asarray(toks),
                                             jnp.asarray([t], jnp.int32))
        for li, (k, v) in enumerate(kvs):
            pools = jdecoding.write_prompt_kv(
                pools, li, (k[0, :, :n_pages * page_size], v[0, :, :n_pages * page_size]),
                jnp.arange(n_pages, dtype=jnp.int32), page_size)
        return pools
    _, td, quantized = KV[kv]
    pools = tdecoding.init_kv_pools(TCFG, num_pages=num_pages, page_size=page_size,
                                    dtype=td, quantized=quantized, device="cpu")
    _, kvs = tdecoding.make_prefill(TCFG)(model, torch.from_numpy(toks).long(),
                                          torch.tensor([t], dtype=torch.int32))
    return tdecoding.write_prompt_kv_all(pools, kvs, torch.arange(n_pages), page_size)


def _verify_args(t0, t_new, page_size=PS, draft=(5, 7, 9, 11, 13, 17)):
    positions = np.arange(t0, t0 + t_new, dtype=np.int32)[None]
    return (np.asarray(draft[:t_new], np.int32)[None], positions,
            positions // page_size, positions % page_size,
            np.arange(8, dtype=np.int32)[None], np.asarray([t0 + t_new], np.int32))


@pytest.mark.parametrize("kv", ["fp32", "int4"])
def test_make_verify_step_logits_match_jax(model, jparams, kv):
    prompt = list(range(1, 11))
    t_new = 3
    args = _verify_args(len(prompt), t_new)
    jpools = _prompt_pools("jax", kv, model, jparams, prompt)
    want, jpools = jdecoding.make_verify_step(JCFG, t_new)(
        jparams, jpools, *(jnp.asarray(a) for a in args))
    tpools = _prompt_pools("torch", kv, model, jparams, prompt)
    got, tpools = tdecoding.make_verify_step(TCFG, t_new)(
        model, tpools, *(torch.from_numpy(a).long() if i < 4 else torch.from_numpy(a)
                         for i, a in enumerate(args)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for li in range(TCFG.n_layers):  # the written pools, quantized on write
        for t_pool, j_pool in zip(tpools.layer(li), _jax_layer(jpools, li)):
            _assert_same_pool(t_pool, j_pool)


def _jax_layer(pools, li):
    if not pools.quantized:
        return pools.k[li], pools.v[li]
    kind = jq.Int4QuantizedTensor if pools.int4 else jq.QuantizedTensor
    return (kind(pools.k[li], pools.k_scales[li]),
            kind(pools.v[li], pools.v_scales[li]))


def _assert_same_pool(t_pool, j_pool):
    """Pools from both packages within one quantization step: the K/V that
    fed them differ in the last bits (matmul summation order, and XLA may
    fold a division by the qmax into a multiply under jit), which can flip
    a rounding."""
    if torch.is_tensor(t_pool):
        d = t_pool.shape[-1]
        np.testing.assert_allclose(t_pool.numpy(), np.asarray(j_pool)[..., :d],
                                   atol=1e-5, rtol=1e-5)
        return
    d = t_pool.values.shape[-1]
    np.testing.assert_allclose(t_pool.scales.numpy(), np.asarray(j_pool.scales),
                               rtol=1e-5, atol=0)
    step = float(t_pool.scales.max()) * (1.0 if t_pool.dtype == torch.int8 else 32.0)
    np.testing.assert_allclose(t_pool.dequantize().numpy(),
                               np.asarray(j_pool.dequantize())[..., :d], atol=step,
                               rtol=0)


@pytest.mark.parametrize("kv", ["e5m2"])
def test_quantized_decode_step_logits_match_jax(model, jparams, kv):
    prompt = list(range(3, 40))
    t0 = len(prompt)
    jpools = _prompt_pools("jax", kv, model, jparams, prompt)
    tpools = _prompt_pools("torch", kv, model, jparams, prompt)
    args = ([13], [t0], [t0 // PS], [t0 % PS], np.arange(8)[None], [t0 + 1])
    want, _ = jdecoding.make_decode_step(JCFG)(
        jparams, jpools, *(jnp.asarray(a, jnp.int32) for a in args))
    got, _ = tdecoding.make_decode_step(TCFG)(
        model, tpools, *(torch.tensor(a, dtype=torch.int32) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_int4_chunk_longer_than_half_a_page_keeps_every_nibble(model, jparams):
    """A 24-token write into 16-token int4 pages puts offsets o and o + 8 of
    one page in one write.  The port's write must equal a whole-sequence
    quantization of the same K/V; the JAX package's loses nibbles here
    (ROADMAP.md queue 3), so it is the oracle that judges, not JAX."""
    ps, t0, t_new, hkv, d = 16, 6, 24, TCFG.n_kv_heads, TCFG.head_dim
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((hkv, t0 + t_new, d),
                                                 dtype=np.float32)) for _ in range(2))
    pages = torch.arange(2)

    def fresh():
        return tdecoding.init_kv_pools(TCFG, num_pages=4, page_size=ps,
                                       dtype="int4", quantized=True, device="cpu")

    pools = tdecoding.write_prompt_kv(fresh(), 0, (k[:, :t0], v[:, :t0]), pages, ps)
    pos = torch.arange(t0, t0 + t_new)[None]
    tdecoding._write_tokens(pools, 0, pos // ps, pos % ps, k[:, None, t0:],
                            v[:, None, t0:])
    whole = tdecoding.write_prompt_kv(fresh(), 0, (k, v), pages, ps)
    for got, want in zip(pools, whole):
        assert torch.equal(got[0], want[0])
    # the JAX write of the same chunk into the same bytes drops nibbles
    jpool = jnp.asarray(tdecoding.write_prompt_kv(
        fresh(), 0, (k[:, :t0], v[:, :t0]), pages, ps).k[0].numpy())
    width = jpool.shape[-1]  # the pools' head dim: both packages zero-pad to it
    kq, _ = jdecoding._quantize_rows_int4(jnp.asarray(
        torch.nn.functional.pad(k[:, t0:], (0, width - d)).numpy()))
    jpool = jdecoding._int4_insert(jpool, jnp.asarray((pos // ps)[0].numpy()),
                                   jnp.asarray((pos % ps)[0].numpy()), kq)
    assert not np.array_equal(np.asarray(jpool), whole.k[0].numpy())


def test_int4_verify_step_with_a_long_chunk_against_the_oracle(model, jparams,
                                                               monkeypatch):
    """The verify step with a 24-token chunk into 16-token int4 pages: its
    logits through the plain verify version and through the per-token
    oracle over the pools it wrote agree."""
    ps, t_new = 16, 24
    prompt = list(range(1, 7))
    args = _verify_args(len(prompt), t_new, page_size=ps,
                        draft=tuple(range(20, 20 + t_new)))
    targs = [torch.from_numpy(a).long() if i < 4 else torch.from_numpy(a)
             for i, a in enumerate(args)]
    step = tdecoding.make_verify_step(TCFG, t_new)
    pools = _prompt_pools("torch", "int4", model, jparams, prompt, page_size=ps)
    got, pools = step(model, pools, *targs)

    def oracle(q, k_pages, v_pages, lengths, tbl, *, sm_scale, alibi_slopes,
               logit_softcap, pages_per_block=None):
        del pages_per_block  # key splits change no value of the oracle
        t = q.shape[2]
        return torch.stack([tdec.paged_reference_attention(
            q[:, :, i], k_pages, v_pages, lengths - (t - 1 - i), tbl,
            sm_scale=sm_scale, alibi_slopes=alibi_slopes, logit_softcap=logit_softcap)
            for i in range(t)], dim=2)

    monkeypatch.setattr(tdecoding, "paged_verify_attention", oracle)
    pools2 = _prompt_pools("torch", "int4", model, jparams, prompt, page_size=ps)
    want, pools2 = step(model, pools2, *targs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for li in range(TCFG.n_layers):
        assert torch.equal(pools.k[li], pools2.k[li])


def test_int4_insert_merges_both_nibbles_of_a_byte():
    ps, d = 8, 4
    pool = torch.zeros((1, 3, ps // 2, d), dtype=torch.int8)
    vals = torch.from_numpy(np.random.default_rng(0).integers(
        -8, 8, (1, 1, ps, d))).to(torch.int32)
    rows = torch.full((1, ps), 2, dtype=torch.long)
    offs = torch.arange(ps)[None]
    tdecoding._int4_insert(pool, rows, offs, vals)
    want = np.asarray(jq.pack_int4_rows(jnp.asarray(vals[0, 0].numpy())))
    np.testing.assert_array_equal(pool[0, 2].numpy(), want)
    assert (pool[:, :2] == 0).all()


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["fp32", "int8", "e4m3"])
def test_paged_kv_cache_matches_jax(kv):
    jd, td, quantized = KV[kv]
    hkv, d, ps, t = 2, 128, 16, 37
    rng = np.random.default_rng(len(kv))
    k, v = (rng.standard_normal((hkv, t, d), dtype=np.float32) for _ in range(2))
    new = [rng.standard_normal((2, 1, hkv, d), dtype=np.float32) for _ in range(3)]
    caches = (JCache.create(num_kv_heads=hkv, head_dim=d, num_pages=12, page_size=ps,
                            dtype=jd, quantized=quantized),
              TCache.create(num_kv_heads=hkv, head_dim=d, num_pages=12, page_size=ps,
                            dtype=td, quantized=quantized, device="cpu"))
    for cache, conv in zip(caches, (jnp.asarray, torch.from_numpy)):
        cache.allocate("a", t + 3)
        cache.allocate("b", 1)
        cache.write_prompt("a", conv(k), conv(v))
        for kn, vn in new:
            cache.append_tokens(["a"], conv(kn), conv(vn))
    jc, tc = caches
    assert tc.seq_lengths == jc.seq_lengths and tc.free_pages == jc.free_pages
    assert tc.quantized == jc.quantized and tc.num_pages == jc.num_pages
    for t_pool, j_pool in zip(tc.kv_for_attention(), jc.kv_for_attention()):
        _assert_same_pool(t_pool, j_pool)
    # the prompt's pages are written eagerly on both sides: bit for bit
    pages = np.asarray(tc.page_tables["a"][:2])
    np.testing.assert_array_equal(tc.k_pages[:, pages].view(torch.uint8).numpy(),
                                  np.asarray(jc.k_pages)[:, pages].view(np.uint8))
    q = rng.standard_normal((1, 4, d), dtype=np.float32)
    tbl = tc.page_indices_for(["a"], 4)
    lens = tc.lengths_for(["a"])
    want = jpaged(jnp.asarray(q), *jc.kv_for_attention(), jnp.asarray(lens),
                  jnp.asarray(tbl))
    got = tdec.paged_decode_attention(torch.from_numpy(q), *tc.kv_for_attention(),
                                      torch.from_numpy(lens), torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    tc.free("a")
    assert len(tc.free_pages) == 11
