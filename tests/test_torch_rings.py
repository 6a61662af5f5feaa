"""The port's KV rings against the JAX package's DecodeEngine, on the CPU.

Rolling sliding-window serving (a uniformly sliding model past its window)
and StreamingLLM serving (attention sinks + a recent ring on a
full-attention model): the same ``ModelConfig.tiny(dtype=float32)`` weights
(carried across with ``params_from_jax``) through both engines must give
identical greedy tokens, across the ring's wrap, for prompts longer than the
resident set and after streaming eviction; int8 and int4 pools included.
Every JAX ring refusal is kept with its class and message.  The JAX engine
runs once per configuration, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import forward, params_from_jax
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine
from flash_attention_dlrs_tpu_torch.runtime.scheduler import Request

WINDOW = 128
JBASE = JConfig.tiny(dtype=jnp.float32, remat=False)
TBASE = TConfig.tiny(dtype=torch.float32, remat=False)
JCFG = dataclasses.replace(JBASE, window=WINDOW)
TCFG = dataclasses.replace(TBASE, window=WINDOW)
KW = dict(num_pages=8, page_size=128, num_slots=2, pages_per_seq=4)
STREAM = dict(streaming_window=128, attention_sinks=128)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


WRAP_PROMPT = _prompt(5, 120)  # 20 new tokens cross length 128 at the 8th
# longer than the ring: the last-window slice lands rolled by t % 128 = 22
# (under page_size/2) and 102 (over it)
LONG_PROMPTS = [_prompt(7, 150), _prompt(8, 230)]
STREAM_PROMPTS = [_prompt(9, 200), _prompt(10, 300)]  # evicts at 256 / at once
JAX_DTYPES = {"fp32": (jnp.float32, False), "int8": (jnp.int8, True),
              "int4": ("int4", True)}
PORT_DTYPES = {"fp32": (torch.float32, False), "int8": (torch.int8, True),
               "int4": ("int4", True)}


@pytest.fixture(scope="module")
def weights():
    jp = init_params(jax.random.PRNGKey(4), JCFG)
    tree = jax.tree.map(np.asarray, jp)
    return jp, {"rolling": params_from_jax(tree, TCFG, device="cpu"),
                "full": params_from_jax(tree, TBASE, device="cpu")}


def _jax_engine(jp, kv="fp32", cfg=JCFG, **kw):
    dtype, quantized = JAX_DTYPES[kv]
    return JEngine(jp, cfg, kv_dtype=dtype, quantized_kv=quantized, **{**KW, **kw})


def _port(weights, kv="fp32", ring="rolling", **kw):
    dtype, quantized = PORT_DTYPES[kv]
    cfg = TCFG if ring == "rolling" else TBASE
    return TEngine(weights[1][ring], cfg, kv_dtype=dtype, quantized_kv=quantized,
                   device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engines' greedy tokens, pools and stats, once per module."""
    jp = weights[0]
    out = {}
    eng = _jax_engine(jp)
    out["wrap"] = eng.generate([WRAP_PROMPT], max_new_tokens=20)
    out["long"] = eng.generate(LONG_PROMPTS, max_new_tokens=6)
    out["rolling_stats"] = eng.stats()
    eng = _jax_engine(jp, cfg=JBASE, **STREAM)
    out["stream_exact"] = eng.generate([STREAM_PROMPTS[0]], max_new_tokens=20)
    out["stream_evicted"] = eng.generate(STREAM_PROMPTS, max_new_tokens=100)
    out["stream_stats"] = eng.stats()
    for kv in ("int8", "int4"):
        eng = _jax_engine(jp, kv)
        out[kv] = eng.generate([WRAP_PROMPT] + LONG_PROMPTS[:1], max_new_tokens=12)
        out[kv + "_long"] = eng.generate(LONG_PROMPTS, max_new_tokens=4)
    eng = _jax_engine(jp, "int4")
    for i, p in enumerate(LONG_PROMPTS):  # the pools right after admission
        eng.scheduler.submit(_request(f"r{i}", p))
    eng.scheduler.schedule()
    out["int4_admitted"] = [_int4_resident(eng, f"r{i}") for i in range(2)]
    return out


def _request(rid, prompt):
    return Request(request_id=rid, prompt_tokens=list(prompt), max_new_tokens=1)


def _int4_resident(eng, sid):
    """Layer 0's dequantized K of a sequence's resident pages [Hkv, slots,
    head_dim] and the largest scale (split-half int4: byte row r holds
    offset r in its low nibble and r + page_size/2 in its high one)."""
    pages = np.asarray(eng.allocator.page_tables[sid], np.int64)
    payload = np.asarray(eng.pools.k[0])[:, pages].astype(np.int32) & 0xFF
    scales = np.asarray(eng.pools.k_scales[0])[:, pages][..., 0]
    q = np.concatenate([payload & 0xF, payload >> 4], axis=2)
    q = np.where(q > 7, q - 16, q)[..., :TBASE.head_dim]
    deq = q * scales[..., None]
    return deq.reshape(deq.shape[0], -1, deq.shape[-1]), float(scales.max())


def _dense_greedy(model, cfg, prompt, n):
    ctx, out = list(prompt), []
    for _ in range(n):
        logits = forward(model, torch.tensor([ctx]), cfg)
        out.append(int(torch.argmax(logits[0, -1])))
        ctx.append(out[-1])
    return out


def test_rolling_across_the_wrap_identical_to_jax(weights, jax_runs):
    eng = _port(weights)
    assert eng.rolling and not eng.streaming and eng.pages_per_seq == WINDOW // 128
    got = eng.generate([WRAP_PROMPT], max_new_tokens=20)
    assert got == jax_runs["wrap"]
    assert got[0] == _dense_greedy(weights[1]["rolling"], TCFG, WRAP_PROMPT, 20)
    # one resident page a sequence, all reclaimed (the null page stays)
    assert len(eng.allocator.free_pages) == KW["num_pages"] - 1


def test_rolling_long_prompts_identical_to_jax(weights, jax_runs):
    eng = _port(weights)
    got = eng.generate(LONG_PROMPTS, max_new_tokens=6)
    assert got == jax_runs["long"]
    assert got[0] == _dense_greedy(weights[1]["rolling"], TCFG, LONG_PROMPTS[0], 6)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_rolling_quantized_identical_to_jax(weights, jax_runs, kv):
    eng = _port(weights, kv)
    assert eng.generate([WRAP_PROMPT] + LONG_PROMPTS[:1], max_new_tokens=12) == jax_runs[kv]
    assert eng.generate(LONG_PROMPTS, max_new_tokens=4) == jax_runs[kv + "_long"]
    assert len(eng.allocator.free_pages) == KW["num_pages"] - 1


@pytest.mark.parametrize("i", [0, 1], ids=["roll22", "roll102"])
def test_rolled_int4_prompt_write_matches_jax(weights, jax_runs, i):
    """The long prompt's rolled write into int4 pools, shifted by less and
    by more than page_size/2: every resident slot holds the token JAX's
    write puts there, within one quantization step (JAX's jitted scales
    may differ by an ulp)."""
    eng = _port(weights, "int4")
    for j, p in enumerate(LONG_PROMPTS):
        eng.scheduler.submit(_request(f"r{j}", p))
    eng.scheduler.schedule()
    got, _ = _int4_resident(eng, f"r{i}")
    want, top = jax_runs["int4_admitted"][i]
    assert got.shape == want.shape == (TCFG.n_kv_heads, WINDOW, TBASE.head_dim)
    assert np.max(np.abs(got - want)) <= 1.01 * top
    # and not merely close: most slots agree exactly
    assert np.mean(np.isclose(got, want, rtol=1e-5, atol=1e-7)) > 0.99


def test_streaming_exact_before_eviction(weights, jax_runs):
    eng = _port(weights, ring="full", **STREAM)
    assert eng.streaming and eng.pages_per_seq == 2
    got = eng.generate([STREAM_PROMPTS[0]], max_new_tokens=20)  # 220 <= 256
    assert got == jax_runs["stream_exact"]
    assert got[0] == _dense_greedy(weights[1]["full"], TBASE, STREAM_PROMPTS[0], 20)


def test_streaming_after_eviction_identical_to_jax(weights, jax_runs):
    """Past sinks + window (and a prompt longer than both): the port's
    tokens are still JAX's, not merely finite."""
    eng = _port(weights, ring="full", **STREAM)
    got = eng.generate(STREAM_PROMPTS, max_new_tokens=100)
    assert got == jax_runs["stream_evicted"]
    assert len(eng.allocator.free_pages) == KW["num_pages"] - 1


def test_step_burst_on_a_ring_steps_one_token_at_a_time(weights, jax_runs):
    eng = _port(weights)
    assert eng.generate([WRAP_PROMPT], max_new_tokens=20, burst=4) == jax_runs["wrap"]
    assert not eng._programs  # no burst program (and no graph) was made


@pytest.mark.parametrize("ring", ["rolling", "streaming"])
def test_ring_stats_match_jax(weights, jax_runs, ring):
    if ring == "rolling":
        eng, want = _port(weights), jax_runs["rolling_stats"]
        eng.generate([WRAP_PROMPT], max_new_tokens=20)
        eng.generate(LONG_PROMPTS, max_new_tokens=6)
    else:
        eng, want = _port(weights, ring="full", **STREAM), jax_runs["stream_stats"]
        eng.generate([STREAM_PROMPTS[0]], max_new_tokens=20)
        eng.generate(STREAM_PROMPTS, max_new_tokens=100)
    got = eng.stats()
    keys = ("admitted", "retired", "steps", "tokens_generated", "pages_total",
            "pages_free", "rolling_window", "streaming_window", "attention_sinks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def _raised(make):
    with pytest.raises(Exception) as info:
        make()
    return type(info.value), str(info.value)


def _guard_cases():
    alibi = dict(position_encoding="alibi")
    return {
        "misaligned_window": (dict(window=100), {}),
        "window_pattern_even": (dict(window=128, window_pattern="even"), {}),
        "alibi": (dict(window=128, **alibi), {}),
        "rolling_prefill_chunk": (dict(window=128), dict(prefill_chunk=16)),
        "streaming_misaligned": ({}, dict(streaming_window=100)),
        "sinks_without_window": ({}, dict(attention_sinks=128)),
        "streaming_on_windowed": (dict(window=512), dict(streaming_window=128)),
        "streaming_on_rolling": (dict(window=128), dict(streaming_window=128)),
        "streaming_prefill_chunk": ({}, dict(streaming_window=128, prefill_chunk=16)),
        "resident_over_tables": ({}, dict(streaming_window=512, attention_sinks=128)),
    }


@pytest.mark.parametrize("case", list(_guard_cases()))
def test_ring_guards_match_jax(weights, case):
    cfg_kw, eng_kw = _guard_cases()[case]
    jcfg = dataclasses.replace(JBASE, **cfg_kw)
    tcfg = dataclasses.replace(TBASE, **cfg_kw)
    model = params_from_jax(jax.tree.map(np.asarray, weights[0]), tcfg, device="cpu")
    want = _raised(lambda: JEngine(weights[0], jcfg, kv_dtype=jnp.float32, **KW, **eng_kw))
    got = _raised(lambda: TEngine(model, tcfg, kv_dtype=torch.float32, device="cpu",
                                  **KW, **eng_kw))
    assert got == want


def test_window_at_or_past_the_tables_is_plain_serving(weights):
    cfg = dataclasses.replace(TBASE, window=512)
    model = params_from_jax(jax.tree.map(np.asarray, weights[0]), cfg, device="cpu")
    eng = TEngine(model, cfg, kv_dtype=torch.float32, device="cpu", **KW)
    assert not eng.rolling and eng.pages_per_seq == KW["pages_per_seq"]
    assert eng.stats()["rolling_window"] == 0


@pytest.mark.parametrize("call", ["attach_draft", "generate_speculative",
                                  "generate_speculative_fused", "generate_fused"])
@pytest.mark.parametrize("ring", ["rolling", "streaming"])
def test_ring_refusals_match_jax(weights, call, ring):
    """The four calls JAX refuses on a ring raise the same class and
    message in the port, whether the ring is the target's or the draft's."""
    jp = weights[0]
    if ring == "rolling":
        jring, tring = _jax_engine(jp), _port(weights)
    else:
        jring = _jax_engine(jp, cfg=JBASE, **STREAM)
        tring = _port(weights, ring="full", **STREAM)
    jplain = _jax_engine(jp, cfg=JBASE)
    tplain = _port(weights, ring="full")
    calls = {
        "attach_draft": lambda e, d: e.attach_draft(d, gamma=4),
        "generate_speculative": lambda e, d: e.generate_speculative(
            [[1, 2, 3]], draft=d, gamma=4, max_new_tokens=4),
        "generate_speculative_fused": lambda e, d: e.generate_speculative_fused(
            [[1, 2, 3]], draft=d, gamma=4, max_new_tokens=4),
        "generate_fused": lambda e, d: e.generate_fused([[1, 2, 3]], max_new_tokens=4),
    }
    fn = calls[call]
    want = _raised(lambda: fn(jring, jplain))
    assert want[0] is NotImplementedError
    assert _raised(lambda: fn(tring, tplain)) == want
    if call != "generate_fused":  # a ring as the draft is refused too
        assert _raised(lambda: fn(tplain, tring)) == _raised(lambda: fn(jplain, jring))
