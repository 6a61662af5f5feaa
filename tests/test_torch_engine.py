"""The PyTorch port's DecodeEngine against the JAX package's, on the CPU.

Both engines serve the same ``ModelConfig.tiny(dtype=float32)`` weights
(carried across with ``params_from_jax``); greedy tokens must be identical.
Seeded sampling cannot match JAX's random bits, so it is held to its own
contract instead: a (seed, position) stream reproduces itself, and top-k
holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.runtime import kv_cache as jkv
from flash_attention_dlrs_tpu.runtime import sampling as jsampling
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import params_from_jax
from flash_attention_dlrs_tpu_torch.runtime import kv_cache as tkv
from flash_attention_dlrs_tpu_torch.runtime import sampling as tsampling
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)
TCFG = TConfig.tiny(dtype=torch.float32, remat=False)
PROMPTS = [[5, 7, 11, 13, 17], [3, 1, 4, 1, 5, 9, 2, 6]]  # tests/test_engine.py
MANY = [[i + 1, i + 2, i + 3] for i in range(5)]


@pytest.fixture(scope="module")
def jparams():
    return init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")


def _engines(jparams, model, **kw):
    kw = dict(num_pages=32, page_size=128, pages_per_seq=4, **kw)
    return (JEngine(jparams, JCFG, kv_dtype=jnp.float32, **kw),
            TEngine(model, TCFG, kv_dtype=torch.float32, device="cpu", **kw))


@pytest.fixture(scope="module")
def jax_runs(jparams):
    """The JAX engine's greedy outputs, computed once for the module."""
    kw = dict(num_pages=32, page_size=128, pages_per_seq=4,
              kv_dtype=jnp.float32)
    greedy = JEngine(jparams, JCFG, num_slots=2, **kw).generate(
        PROMPTS, max_new_tokens=6)
    many = JEngine(jparams, JCFG, num_slots=2, **kw).generate(
        MANY, max_new_tokens=3)
    eos = greedy[0][2]
    stopped = JEngine(jparams, JCFG, num_slots=2, eos_token=eos, **kw).generate(
        PROMPTS, max_new_tokens=6)
    return {"greedy": greedy, "many": many, "eos": eos, "stopped": stopped}


def _port(model, **kw):
    return TEngine(model, TCFG, num_pages=32, page_size=128, pages_per_seq=4,
                   kv_dtype=torch.float32, device="cpu", **kw)


def test_greedy_tokens_identical_to_jax(model, jax_runs):
    got = _port(model, num_slots=2).generate(PROMPTS, max_new_tokens=6)
    assert got == jax_runs["greedy"]


def test_more_requests_than_slots_identical_to_jax(model, jax_runs):
    eng = _port(model, num_slots=2)
    got = eng.generate(MANY, max_new_tokens=3)
    assert got == jax_runs["many"]
    assert eng.scheduler.stats.admitted == 5 and eng.scheduler.stats.retired == 5
    # pages fully reclaimed (only the reserved null page remains)
    assert len(eng.allocator.free_pages) == eng.pools.k[0].shape[1] - 1


def test_eos_stop_identical_to_jax(model, jax_runs):
    eos = jax_runs["eos"]
    got = _port(model, num_slots=2, eos_token=eos).generate(
        PROMPTS, max_new_tokens=6)
    assert got == jax_runs["stopped"]
    assert got[0][-1] == eos and len(got[0]) == 3


def test_stream_events_match_generate(model):
    eng = _port(model, num_slots=2)
    events = list(eng.generate_stream(PROMPTS, max_new_tokens=4))
    toks = {}
    for ev in events:
        if ev.token is not None:
            assert not ev.done
            toks.setdefault(ev.request_id, []).append(ev.token)
    assert sum(ev.done for ev in events) == len(PROMPTS)
    assert [toks[f"req{i}"] for i in range(2)] == _port(
        model, num_slots=2).generate(PROMPTS, max_new_tokens=4)


def test_logprobs_are_log_softmax_of_the_chosen_tokens(model):
    toks, lps = _port(model, num_slots=2).generate(
        PROMPTS, max_new_tokens=3, return_logprobs=True)
    assert [len(x) for x in lps] == [3, 3]
    assert all(lp <= 0.0 for row in lps for lp in row)


def test_seeded_sampling_reproduces_itself(model):
    sp = tsampling.SamplingParams(temperature=1.0, seed=11)
    a = _port(model, num_slots=2).generate(PROMPTS, max_new_tokens=8, sampling=sp)
    b = _port(model, num_slots=2).generate(PROMPTS, max_new_tokens=8, sampling=sp)
    assert a == b
    # the stream depends on (seed, position), not on the slot or the batch
    alone = _port(model, num_slots=1).generate(PROMPTS[1:], max_new_tokens=8,
                                               sampling=sp)
    assert alone[0] == a[1]
    other = _port(model, num_slots=2).generate(
        PROMPTS, max_new_tokens=8,
        sampling=tsampling.SamplingParams(temperature=1.0, seed=12))
    assert other != a


def test_top_k_one_sampling_is_greedy(model, jax_runs):
    sp = tsampling.SamplingParams(temperature=0.7, top_k=1, seed=5)
    got = _port(model, num_slots=2).generate(PROMPTS, max_new_tokens=6, sampling=sp)
    assert got == jax_runs["greedy"]


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_sampled_tokens_stay_in_the_top_k(top_k):
    rng = np.random.default_rng(top_k)
    logits = torch.from_numpy(rng.standard_normal((4, 300), dtype=np.float32))
    temp, k, p, seeds = tsampling.batch_params(
        [tsampling.SamplingParams(temperature=1.5, top_k=top_k, seed=s)
         for s in range(4)], device="cpu")
    allowed = torch.topk(logits, top_k, dim=-1).indices
    for pos in range(40):
        tok = tsampling.sample_tokens(logits, temp, k, p, seeds,
                                      torch.full((4,), pos, dtype=torch.int32))
        assert all(int(tok[i]) in allowed[i].tolist() for i in range(4))


# top_p = 1 with no top-k is left out: whether the last tail entries pass
# (cum - prob < 1) then turns on the last bit of a float32 cumsum, whose
# summation order differs between XLA and PyTorch.
@pytest.mark.parametrize("t,k,p", [
    (1.0, 0, 0.95), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 40, 0.5), (0.0, 3, 0.9),
])
def test_filtered_logits_match_jax(t, k, p):
    rng = np.random.default_rng(int(t * 10) + k)
    logits = rng.standard_normal((3, 200), dtype=np.float32) * 3
    jt, jk, jp, _ = jsampling.batch_params(
        [jsampling.SamplingParams(temperature=t, top_k=k, top_p=p)] * 3)
    tt, tk, tp_, _ = tsampling.batch_params(
        [tsampling.SamplingParams(temperature=t, top_k=k, top_p=p)] * 3,
        device="cpu")
    want = np.asarray(jsampling.filtered_logits(jnp.asarray(logits), jt, jk, jp))
    got = tsampling.filtered_logits(torch.from_numpy(logits), tt, tk, tp_).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_greedy_sampling_matches_jax_on_ties():
    logits = np.zeros((2, 16), np.float32)
    logits[0, [3, 9]] = 5.0  # a tie: both take the first maximum
    logits[1, 12] = 1.0
    jt, jk, jp, js = jsampling.batch_params([None, None])
    tt, tk, tp_, ts = tsampling.batch_params([None, None], device="cpu")
    pos = np.asarray([4, 4], np.int32)
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), jt, jk, jp,
                                              js, jnp.asarray(pos)))
    got = tsampling.sample_tokens(torch.from_numpy(logits), tt, tk, tp_, ts,
                                  torch.from_numpy(pos))
    assert got.tolist() == want.tolist() == [3, 12]


@pytest.mark.parametrize("kwargs", [
    dict(temperature=-1.0), dict(top_k=-2), dict(top_p=0.0), dict(top_p=1.5),
])
def test_sampling_params_validation(kwargs):
    with pytest.raises(ValueError):
        tsampling.SamplingParams(**kwargs)


def test_page_allocator_bookkeeping_matches_jax():
    ja, ta = jkv.PageAllocator(12, 4), tkv.PageAllocator(12, 4)
    for alloc in (ja, ta):
        alloc.allocate("null", 1)
        alloc.allocate("a", 5)
        alloc.allocate("b", 2)
        alloc.seq_lengths["a"], alloc.seq_lengths["b"] = 5, 2
    for _ in range(6):
        want = ja.decode_step_bookkeeping(["a", "b"], 4)
        got = ta.decode_step_bookkeeping(["a", "b"], 4)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    ja.free("a"), ta.free("a")
    assert ja.free_pages == ta.free_pages
    assert ja.can_allocate(30) == ta.can_allocate(30)


def test_stats_have_the_jax_keys(jparams, model):
    jeng, teng = _engines(jparams, model, num_slots=2)
    teng.generate(PROMPTS, max_new_tokens=2)
    assert set(teng.stats()) == set(jeng.stats())
    assert teng.stats()["admitted"] == 2 and teng.stats()["pages_free"] == 31


@pytest.mark.parametrize("kwargs", [
    dict(prefill_chunk=16), dict(streaming_window=128),
    dict(enable_prefix_cache=True), dict(mesh=object()),
    dict(quantized_kv=True),
])
def test_unported_engine_options_raise(model, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(model, num_slots=1, **kwargs)


def test_unported_engine_modes_raise(model):
    eng = _port(model, num_slots=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.attach_draft(eng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.step_burst(4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.generate(PROMPTS, burst=4)
    with pytest.raises(ValueError, match="pages_per_seq"):
        eng.generate([list(range(600))], max_new_tokens=1)
