"""The port's geometry model and tuner against the kernels' byte counts and
the JAX package.

geometry.py's shared-memory model against the byte counts the card's
builds reported (PERF.md §6: the d256 forward with fp8 V 230,488 B, with
segment ids too 231,000 B; the d256 dQ sweep with segment ids 230,840 B), the
d256 dK/dV sweep's one-pass layout from its definition, and the other tiles'
layouts; every d256 sweep layout within a CTA's 232,448 bytes; ``BlockSizes`` on Hopper's tiles by head dim
and mode; the candidates (the built tiles, d256's 128-key tile pruned); the
default tiles; ``_tune_cached`` with a stubbed timer beside JAX's; the op
with tiles pinned and tuned against JAX's op (fp32, forward atol 1e-4,
gradients 9e-4 / 7e-4 / 7e-5, ``tests/test_forward.py:21``,
``tests/test_backward.py:25``); ``pages_per_block`` through the plain
split-and-merge against JAX ``paged_decode_attention`` in interpret mode;
the decode tuner; the engine and the steps with ``pages_per_block``, and the
engine's fp8 gate.  Inputs are made by numpy from a seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

import flash_attention_dlrs_tpu.tuning as jtuning
from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu.ops.flash_attention import flash_attention as jflash
from flash_attention_dlrs_tpu_torch import geometry as geo
from flash_attention_dlrs_tpu_torch import tuning
from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy, params_from_jax
from flash_attention_dlrs_tpu_torch.models.decoding import make_decode_step, make_verify_step
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_forward, tuned_block_sizes,
)
from flash_attention_dlrs_tpu_torch.ops.reference import alibi_slopes_for
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine

FWD_TOL = dict(atol=1e-4, rtol=1e-5)  # tests/test_forward.py:21
GRAD_ATOL = (9e-4, 7e-4, 7e-5)  # dQ, dK, dV: tests/test_backward.py:25
OTHER = tuning.BlockSizes(block_kv=64, block_kv_bwd=32)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Both tuners' caches in process and on disk, emptied, under tmp_path."""
    monkeypatch.setattr(tuning, "_CACHE_PATH", str(tmp_path / "torch_cache.json"))
    monkeypatch.setattr(jtuning, "_CACHE_PATH", str(tmp_path / "jax_cache.json"))
    for cache in (tuning._TUNE_CACHE, jtuning._TUNE_CACHE, tuning.TIMINGS):
        cache.clear()
    yield tmp_path
    for cache in (tuning._TUNE_CACHE, jtuning._TUNE_CACHE, tuning.TIMINGS):
        cache.clear()


# ---------------------------------------------------------------------------
# The geometry model
# ---------------------------------------------------------------------------

# The d 256 dK/dV sweep's layout (csrc/attn_bwd_sm90.cuh DkvD256Layout): K
# and V for 64 keys, 2 stages of Q and dO of 64 q rows, the P o M and dS
# tiles (64 x 64), 2 stages of lse, D (and q ids) for 64 rows, 7 barriers,
# 1024 bytes of alignment.
D256_DKV_BYTES = (2 * 64 * 256 * 2 + 2 * 2 * 64 * 256 * 2 + 2 * 64 * 64 * 2 + 2 * 2 * 64 * 4
                  + 8 * 7 + 1024)
D256_DKV_SEG_BYTES = D256_DKV_BYTES + 2 * 64 * 4

# (model call, bytes): the card's own counts (PERF.md §6, the builds'
# *_shared_bytes entries), the d 256 dK/dV layout's and
# csrc/attn_fwd_sm90.cuh's 165,032 for 64-key tiles at d 128.
CARD_BYTES = [
    (lambda: geo.attention_fwd_smem_bytes(64, 256, 2, segments=False, fp8_v=True), 230488),
    (lambda: geo.attention_fwd_smem_bytes(64, 256, 2, segments=True, fp8_v=True), 231000),
    (lambda: geo.attention_bwd_smem_bytes(32, 256, segments=True, dkv=True),
     D256_DKV_SEG_BYTES),
    (lambda: geo.attention_bwd_smem_bytes(32, 256, segments=True, dkv=False), 230840),
    (lambda: geo.attention_fwd_smem_bytes(64, 128, geo.fwd_stages(64, 128)), 165032),
]


@pytest.mark.parametrize("case", range(len(CARD_BYTES)))
def test_geometry_model_matches_the_cards_byte_counts(case):
    model, want = CARD_BYTES[case]
    assert model() == want


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("dkv", [True, False])
def test_d256_sweep_layouts_fit_a_cta(segments, dkv):
    """Each d 256 sweep layout, with and without segment ids, fits the
    232,448 bytes a CTA may opt into; dK/dV's is its one-pass layout
    whatever block_kv_bwd, dQ's streams block_kv_bwd keys in 3 stages."""
    nbytes = geo.attention_bwd_smem_bytes(geo.default_block_kv_bwd(256), 256, segments, dkv)
    assert nbytes <= 232448
    if dkv:
        assert nbytes == (D256_DKV_SEG_BYTES if segments else D256_DKV_BYTES)
        assert geo.attention_bwd_smem_bytes(64, 256, segments, dkv) == nbytes
        assert geo.bwd_stream_rows(256, 32, True) == 64 and geo.bwd_stages(256, True) == 2
    else:
        assert geo.bwd_stream_rows(256, 32, False) == 32 and geo.bwd_stages(256, False) == 3


def test_geometry_on_the_cpu_is_the_h100_table():
    g = geo.current_geometry("cpu")
    assert (g.sm_count, g.smem_per_block_optin, g.capability) == (132, 232448, (9, 0))
    assert geo.supports_fast_fp8(g)
    assert not geo.supports_fast_fp8(geo.HopperGeometry("an Ampere", 108, 166912, 65536,
                                                        40 << 20, (8, 0)))


def test_stages_keep_the_builds_and_fill_the_rest():
    # the builds' own tiles keep their rings; 64-key tiles take 4 stages
    assert [geo.fwd_stages(geo.default_block_kv(d), d) for d in (64, 128, 256)] == [4, 2, 2]
    assert geo.fwd_stages(64, 64) == geo.fwd_stages(64, 128) == 4
    # 128 keys at d 256: 65,536 + 2·2·65,536 bytes do not fit
    assert geo.attention_fwd_smem_bytes(128, 256, 2) > 232448
    assert geo.fwd_stages(128, 256) == 0


# ---------------------------------------------------------------------------
# BlockSizes, candidates, defaults
# ---------------------------------------------------------------------------

BLOCK_CHECKS = [
    # fields, head dim, modes, accepted
    (dict(), 128, {}, True),
    (dict(block_kv=64, block_kv_bwd=32), 128, {}, True),
    (dict(block_kv=64, block_kv_bwd=32), 64, {}, True),
    (dict(block_kv=64, block_kv_bwd=32), 256, {}, True),
    (dict(block_kv=128, block_kv_bwd=32), 256, {}, False),
    (dict(block_kv=64, block_kv_bwd=64), 256, {}, False),
    (dict(block_kv=64), 128, dict(alibi=True), False),
    (dict(block_kv_bwd=32), 64, dict(dropout=True), False),
    (dict(block_kv=64), 128, dict(segments=True), False),
    (dict(block_kv=64), 128, dict(fp8_v=True), False),
    (dict(block_kv=64, block_kv_bwd=32), 256, dict(alibi=True, segments=True), True),
    (dict(), 64, dict(alibi=True, dropout=True), True),
]


@pytest.mark.parametrize("fields,d,modes,accepted", BLOCK_CHECKS)
def test_block_sizes_checked_by_head_dim_and_mode(fields, d, modes, accepted):
    bs = tuning.BlockSizes(**fields)
    if accepted:
        bs.check(d, **modes)
    else:
        with pytest.raises(ValueError, match="built with"):
            bs.check(d, **modes)


@pytest.mark.parametrize("fields", [dict(block_q=64), dict(block_q_bwd=256),
                                    dict(block_kv=256), dict(block_kv_bwd=128)])
def test_block_sizes_refuse_tiles_hopper_has_not(fields):
    with pytest.raises(ValueError):
        tuning.BlockSizes(**fields)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_candidates_are_the_built_tiles(d):
    fwd = [bkv for _, bkv in tuning.candidate_fwd_configs(d)]
    bwd = [bs for _, bs in tuning.candidate_bwd_configs(d)]
    assert fwd == list(tuning.BUILT_BLOCK_KV[d])
    assert bwd == list(tuning.BUILT_BLOCK_KV_BWD[d])
    # a mode leaves the build's own tile only
    assert tuning.candidate_fwd_configs(d, alibi=True) == [(128, geo.default_block_kv(d))]
    assert tuning.candidate_bwd_configs(d, segments=True) == [
        (128, geo.default_block_kv_bwd(d))]


def test_d256_128_key_tiles_are_pruned_by_the_model():
    """Even were they built, 128-key tiles at d 256 do not fit a CTA."""
    tuning.BUILT_BLOCK_KV[256], real = (64, 128), tuning.BUILT_BLOCK_KV[256]
    try:
        assert tuning.candidate_fwd_configs(256) == [(128, 64)]
    finally:
        tuning.BUILT_BLOCK_KV[256] = real


def test_default_block_sizes_are_the_builds_tiles():
    assert tuning.default_block_sizes(64) == tuning.BlockSizes(128, 128, 128, 64)
    assert tuning.default_block_sizes(128) == tuning.BlockSizes(128, 128, 128, 64)
    assert tuning.default_block_sizes(256) == tuning.BlockSizes(128, 64, 128, 32)


# ---------------------------------------------------------------------------
# _tune_cached beside JAX's
# ---------------------------------------------------------------------------

STUB_TIMES = {1: 3.0, 2: 1.0, 3: 2.0}


def _stub_build(cand):
    return lambda: STUB_TIMES[cand]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_tune_cached_picks_the_fastest_and_caches(which, fresh_cache, monkeypatch):
    mod = tuning if which == "torch" else jtuning
    timed = []

    def stub_time(fn, *args, **kw):
        timed.append(1)
        return fn()

    monkeypatch.setattr(mod, "_time_call", stub_time)
    assert mod._tune_cached(["k"], [1, 2, 3], _stub_build, ()) == 2
    assert len(timed) == 3
    assert mod._tune_cached(["k"], [1, 2, 3], _stub_build, ()) == 2 and len(timed) == 3
    # on disk: a fresh process (empty in-process cache) reads it back
    mod._TUNE_CACHE.clear()
    assert mod._tune_cached(["k"], [3, 1], _stub_build, ()) == 2 and len(timed) == 3
    on_disk = json.load(open(mod._CACHE_PATH))
    assert list(on_disk.values()) == [2] and json.loads(next(iter(on_disk)))[1:] == ["k"]


def _raising(message):
    def build(cand):
        def fn():
            if cand == 1:
                raise RuntimeError(message)
            return STUB_TIMES[cand]
        return fn
    return build


@pytest.mark.parametrize("message,skipped", [
    ("CUDA out of memory. Tried to allocate 34.00 GiB", True),
    ("RESOURCE_EXHAUSTED: out of memory", True),
    ("out of resource: shared memory, Required: 262144", True),
    ("attn_fwd failed: CUDA error 1 (invalid argument)", False),
    ("consts leaked into custom_partitioning", False),
])
def test_tune_cached_skips_resource_errors_and_raises_on_others_as_jax_does(
        message, skipped, fresh_cache, monkeypatch):
    for mod in (tuning, jtuning):
        monkeypatch.setattr(mod, "_time_call", lambda fn, *a, **k: fn())
    results = []
    for mod in (tuning, jtuning):
        try:
            results.append(mod._tune_cached([message], [1, 3], _raising(message), ()))
        except RuntimeError as e:
            assert "non-resource error" in str(e)
            results.append("raised")
    assert results[0] == results[1] == (3 if skipped else "raised")


@pytest.mark.parametrize("message", [
    "attn_fwd failed: CUDA error 701 (too many resources requested for launch)",
    "cudaErrorLaunchOutOfResources",
])
def test_tune_cached_skips_cudas_launch_resource_errors(message, fresh_cache, monkeypatch):
    """CUDA's own words for a launch that does not fit (JAX's TPU markers
    do not name them)."""
    monkeypatch.setattr(tuning, "_time_call", lambda fn, *a, **k: fn())
    assert tuning._tune_cached([message], [1, 3], _raising(message), ()) == 3


# ---------------------------------------------------------------------------
# The op with tiles pinned and tuned, against JAX's op
# ---------------------------------------------------------------------------


def _qkv(seed, b, hq, hkv, n, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, hq, n, d), (b, hkv, n, d), (b, hkv, n, d), (b, hq, n, d))]


def _jax_grads(q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, **kw), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(q, k, v, do, **kw):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*leaves, **kw)
    return o.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        o, leaves, torch.from_numpy(do))]


@pytest.mark.parametrize("d,causal", [(64, True), (128, False)])
def test_pinned_tiles_match_jax(d, causal):
    q, k, v, do = _qkv(d, 1, 4, 2, 200, d)
    kw = dict(causal=causal, sm_scale=1.0)
    want_o = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), **kw,
                               block_sizes=jtuning.BlockSizes(128, 128, 128, 128)))
    want_g = _jax_grads(q, k, v, do, **kw)
    got_o, got_g = _torch_grads(q, k, v, do, **kw, block_sizes=OTHER)
    np.testing.assert_allclose(got_o, want_o, **FWD_TOL)
    for got, want, atol in zip(got_g, want_g, GRAD_ATOL):
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)
    # the split entry points take the same tiles
    o, lse = flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw,
                                     block_sizes=OTHER)
    grads = flash_attention_backward(*map(torch.from_numpy, (q, k, v)), o,
                                     torch.from_numpy(do), lse, **kw, block_sizes=OTHER)
    for got, want, atol in zip(grads, want_g, GRAD_ATOL):
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-5)


def test_tune_picks_caches_both_directions_and_matches_jax(fresh_cache, monkeypatch):
    """tests/test_forward.py:136-192 for the port: tune=True times the
    forward and the backward, caches a "fwd" and a "bwd" key, and a second
    call times nothing."""
    q, k, v, do = _qkv(9, 1, 1, 1, 256, 64)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), sm_scale=1.0))
    got, grads = _torch_grads(q, k, v, do, sm_scale=1.0, tune=True)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for g, w, atol in zip(grads, _jax_grads(q, k, v, do, sm_scale=1.0), GRAD_ATOL):
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-5)
    keys = [json.loads(key)[1] for key in tuning._TUNE_CACHE]
    assert sorted(keys) == ["bwd", "fwd"]
    timed = []
    real = tuning._time_call
    monkeypatch.setattr(tuning, "_time_call",
                        lambda *a, **k_: timed.append(1) or real(*a, **k_))
    flash_attention(*map(torch.from_numpy, (q, k, v)), sm_scale=1.0, tune=True)
    assert len(tuning._TUNE_CACHE) == 2 and not timed
    bs = tuned_block_sizes(*map(torch.from_numpy, (q, k, v)), sm_scale=1.0)
    assert (bs.block_q, bs.block_kv) in tuning.candidate_fwd_configs(64)
    assert (bs.block_q_bwd, bs.block_kv_bwd) in tuning.candidate_bwd_configs(64)


def test_tiles_the_modes_lack_raise_and_tune_takes_their_own(fresh_cache):
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 64, 128))
    slopes = alibi_slopes_for(2)
    with pytest.raises(ValueError, match=r"block_kv in \(128,\)"):
        flash_attention(q, k, v, causal=True, alibi_slopes=slopes, block_sizes=OTHER)
    with pytest.raises(ValueError, match="built with"):
        flash_attention_forward(q, k, v, segment_ids=torch.zeros(1, 64, dtype=torch.int32),
                                block_sizes=OTHER)
    with pytest.raises(TypeError):
        flash_attention(q, k, v, block_sizes=(128, 64, 128, 32))
    o = flash_attention(q, k, v, causal=True, alibi_slopes=slopes, tune=True)
    assert o.shape == q.shape and not tuning._TUNE_CACHE  # one candidate: nothing timed


# ---------------------------------------------------------------------------
# pages_per_block: pages per key split
# ---------------------------------------------------------------------------

# B, Hq, Hkv, page_size, pages_per_seq, lengths (tests/test_torch_decode_split.py)
PAGED = (4, 4, 2, 16, 8, [0, 5, 49, 128])


def _paged(seed, d=128):
    b, hq, hkv, ps, pps, lengths = PAGED
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), tbl


@pytest.mark.parametrize("ppb", [1, 2, 4])
def test_pages_per_block_splits_and_merges_as_jax_decodes(ppb):
    q, kp, vp, lens, tbl = _paged(11)
    want, want_lse = jdec.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, lens, tbl)), pages_per_block=ppb, return_lse=True,
        logit_softcap=25.0)
    got, lse = tdec.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, lens, tbl)), pages_per_block=ppb,
        return_lse=True, logit_softcap=25.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    # the split the kernel would run: ceil(8 / ppb) runs of whole pages
    splits = tdec.key_splits(PAGED[4], ppb)
    assert splits == -(-PAGED[4] // ppb)
    plain = tdec.paged_decode_plain(*map(torch.from_numpy, (q, kp, vp, lens, tbl)),
                                    logit_softcap=25.0, splits=splits)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_key_splits_follow_pages_per_block():
    assert [tdec.key_splits(17, p) for p in (1, 2, 4, 8, 16, 17, 64)] == [
        17, 9, 5, 3, 2, 1, 1]
    assert tdec.key_splits(200, 1, tdec.VERIFY_MAX_SPLITS) == 50  # 4 pages a split
    for bad in (0, -2):
        with pytest.raises(ValueError):
            tdec.key_splits(17, bad)
    with pytest.raises(TypeError):
        tdec.key_splits(17, 2.0)


def test_verify_takes_pages_per_block():
    b, hq, hkv, ps, pps, _ = PAGED
    q, kp, vp, _, tbl = _paged(12)
    qv = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, hq, 3, q.shape[-1]), dtype=np.float32))
    lens = torch.tensor([3, 9, 60, 128], dtype=torch.int32)
    args = (torch.from_numpy(kp), torch.from_numpy(vp), lens, torch.from_numpy(tbl))
    base = tdec.paged_verify_attention(qv, *args)
    for ppb in (1, 3):
        np.testing.assert_array_equal(
            tdec.paged_verify_attention(qv, *args, pages_per_block=ppb).numpy(), base.numpy())
    with pytest.raises(ValueError):
        tdec.paged_verify_attention(qv, *args, pages_per_block=0)


def test_tuned_pages_per_block_caches_and_runs(fresh_cache, monkeypatch):
    """tests/test_decode.py:42-60 for the port."""
    q, kp, vp, lens, tbl = map(torch.from_numpy, _paged(3))
    ppb = tdec.tuned_pages_per_block(q, kp, vp, lens, tbl)
    # powers of two up to 8 pages covering a 64-token tile: 4 and 8
    assert ppb in (4, 8)
    (key, rows), = tuning.TIMINGS.items()
    assert json.loads(key)[1] == "decode" and [c for c, _ in rows] == [4, 8]
    timed = []
    monkeypatch.setattr(tuning, "_time_call", lambda *a, **k_: timed.append(1) or 0.0)
    assert tdec.tuned_pages_per_block(q, kp, vp, lens, tbl) == ppb and not timed
    got = tdec.paged_decode_attention(q, kp, vp, lens, tbl, pages_per_block=ppb)
    want = tdec.paged_reference_attention(q, kp, vp, lens, tbl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The steps and the engine with pages_per_block; the engine's fp8 gate
# ---------------------------------------------------------------------------

TCFG = ModelConfig.tiny(dtype=torch.float32, remat=False)
PROMPTS = [[5, 7, 11, 13, 17], [3, 1, 4, 1, 5, 9, 2, 6]]  # tests/test_engine.py


@pytest.fixture(scope="module")
def model():
    return params_from_jax(init_params_numpy(TCFG, seed=0), TCFG, device="cpu")


def _engine(model, **kw):
    kw.setdefault("kv_dtype", torch.float32)
    return DecodeEngine(model, TCFG, num_pages=32, page_size=16, pages_per_seq=8,
                        num_slots=2, device="cpu", **kw)


def test_engine_pages_per_block_keeps_the_tokens(model):
    want = _engine(model).generate(PROMPTS, max_new_tokens=8)
    engine = _engine(model, pages_per_block=1)
    assert engine.pages_per_block == 1
    assert engine.generate(PROMPTS, max_new_tokens=8) == want
    chunked = _engine(model, pages_per_block=2, prefill_chunk=16)
    assert chunked.generate(PROMPTS, max_new_tokens=8) == want


def test_steps_take_pages_per_block(model):
    pools = _engine(model).pools
    rng = np.random.default_rng(5)
    b, t = 2, 3
    tbl = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]],
                       dtype=torch.int32)
    for p in (pools.k, pools.v):
        for pool in p:
            pool.copy_(torch.from_numpy(rng.standard_normal(pool.shape, dtype=np.float32)))
    lengths = torch.tensor([70, 100], dtype=torch.int32)
    pos = (lengths - 1).long()
    rows, offs = tbl.long()[torch.arange(b), pos // 16], pos % 16
    tokens = torch.tensor([3, 9])
    base, _ = make_decode_step(TCFG)(model, pools, tokens, pos, rows, offs, tbl, lengths)
    split, _ = make_decode_step(TCFG, pages_per_block=2)(model, pools, tokens, pos, rows,
                                                         offs, tbl, lengths)
    np.testing.assert_allclose(split.numpy(), base.numpy(), atol=1e-5, rtol=1e-5)
    vpos = pos[:, None] - t + 1 + torch.arange(t)
    vrows, voffs = tbl.long().gather(1, vpos // 16), vpos % 16
    vtok = torch.tensor([[3, 4, 5], [6, 7, 8]])
    vbase, _ = make_verify_step(TCFG, t)(model, pools, vtok, vpos, vrows, voffs, tbl, lengths)
    vsplit, _ = make_verify_step(TCFG, t, pages_per_block=3)(model, pools, vtok, vpos, vrows,
                                                             voffs, tbl, lengths)
    np.testing.assert_array_equal(vsplit.numpy(), vbase.numpy())


def test_engine_takes_fp8_kv_where_the_card_converts_it(model, monkeypatch):
    """JAX runtime/engine.py:203-223: fp8 KV falls back to int8, with a
    warning, where the part has no fp8 datapath; on the H100 (and the CPU)
    fp8 is taken as asked."""
    engine = _engine(model, kv_dtype=torch.float8_e4m3fn, quantized_kv=True)
    assert engine.kv_dtype == torch.float8_e4m3fn
    monkeypatch.setattr(geo, "supports_fast_fp8", lambda geom=None: False)
    with pytest.warns(UserWarning, match="falling back to int8"):
        engine = _engine(model, kv_dtype=torch.float8_e5m2, quantized_kv=True)
    assert engine.kv_dtype == torch.int8 and engine.pools.k[0].dtype == torch.int8
    assert _engine(model, kv_dtype="int4", quantized_kv=True).kv_dtype == "int4"
