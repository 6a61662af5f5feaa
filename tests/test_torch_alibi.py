"""ALiBi in the PyTorch port against the JAX package.

The same seeded numpy inputs go through both packages: the attention
forward (O and the TRUE logsumexp), its gradients, the paged decode and
verify kernels on every pool kind, and an ALiBi model's prefill, decode and
verify steps and greedy serving.  The JAX side runs as its own tests run it
on the CPU (Pallas in interpret mode); the port runs its kernels' plain
versions, which CPU tensors take.  The port's kernels add the true bias
−m_h·(q_pos − col), the TPU kernels the separable +m_h·col; outputs agree to
summation order.  Tolerances: forward O and lse atol 1e-4 / rtol 1e-5
(tests/test_alibi.py:28); gradients the fp32 ladder dQ 9e-4, dK 7e-4,
dV 7e-5; paged atol 2e-4 / rtol 1e-4 (tests/test_alibi.py:301); model
logits 1e-4 × their std.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from flash_attention_dlrs_tpu_torch.models import params_from_jax
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

FWD = dict(atol=1e-4, rtol=1e-5)
GRAD_ATOL = (9e-4, 7e-4, 7e-5)  # dQ, dK, dV
PAGED = dict(atol=2e-4, rtol=1e-4)

CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, window)
    "causal_gqa": (1, 4, 2, 128, 128, 64, 0),
    "cross_length": (1, 4, 2, 72, 200, 64, 0),
    "window_mha_tails": (2, 2, 2, 136, 136, 32, 48),
}


def _inputs(seed, b, hq, hkv, nq, nkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, nq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, nkv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, nkv, d), dtype=np.float32),
            rng.standard_normal((b, hq, nq, d), dtype=np.float32))


def _kw(name):
    b, hq, *_, window = CASES[name]
    return dict(causal=True, window=window, alibi_slopes=fa.alibi_slopes_for(hq))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_true_lse_match_jax(name):
    q, k, v, _ = _inputs(len(name), *CASES[name][:6])
    kw = _kw(name)
    oj, lj = fa.flash_attention_forward(*map(jnp.asarray, (q, k, v)), **kw)
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FWD)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD)
    # the lse is the true logsumexp of scale·QKᵀ − m·(q_pos − col)
    _, lref = fa.reference_attention(*map(jnp.asarray, (q, k, v)), sm_scale=q.shape[-1] ** -0.5,
                                     with_lse=True, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lref), **FWD)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    q, k, v, do = _inputs(len(name) + 1, *CASES[name][:6])
    kw = _kw(name)

    def loss(q_, k_, v_):
        return jnp.sum(fa.flash_attention(q_, k_, v_, **kw) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for t, w, atol in zip(leaves, want, GRAD_ATOL):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=atol, rtol=1e-5)


def test_backward_rederives_the_stats_under_alibi():
    """rederive_stats defaults to True under ALiBi: the forward kernel's own
    lse is replayed and the passed one is only a shape witness; False
    honours the passed lse."""
    q, k, v, do = map(torch.from_numpy, _inputs(5, *CASES["causal_gqa"][:6]))
    kw = _kw("causal_gqa")
    o, lse = tp.flash_attention_forward(q, k, v, **kw)
    want = tp.flash_attention_backward(q, k, v, o, do, lse, rederive_stats=False, **kw)
    got = tp.flash_attention_backward(q, k, v, o, do, torch.zeros_like(lse), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    off = tp.flash_attention_backward(q, k, v, o, do, lse + 1.0, rederive_stats=False, **kw)
    assert not torch.allclose(off[0], want[0])


def test_alibi_validation_and_scalar_slope():
    q, k, v, _ = map(torch.from_numpy, _inputs(6, 1, 4, 2, 64, 64, 32))
    with pytest.raises(ValueError, match="causal"):
        tp.flash_attention(q, k, v, causal=False, alibi_slopes=fa.alibi_slopes_for(4))
    with pytest.raises(ValueError, match="per q head"):
        tp.flash_attention(q, k, v, causal=True, alibi_slopes=fa.alibi_slopes_for(6))
    one = tp.flash_attention(q, k, v, causal=True, alibi_slopes=(0.25,))
    every = tp.flash_attention(q, k, v, causal=True, alibi_slopes=(0.25,) * 4)
    assert torch.equal(one, every)
    assert not torch.allclose(one, tp.flash_attention(q, k, v, causal=True))


# ---------------------------------------------------------------------------
# Paged decode and verify
# ---------------------------------------------------------------------------

POOLS = {
    "fp32": None, "bf16": None,
    "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
}
# B, Hq, Hkv, page_size, pages_per_seq, d
PAGED_SHAPE = (3, 8, 2, 16, 4, 128)


def _paged(seed, kind, t_new=0, lengths=(0, 37, 64)):
    b, hq, hkv, ps, pps, d = PAGED_SHAPE
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, hq, t_new, d) if t_new else (b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    if kind == "fp32":
        pools = (jnp.asarray(kp), jnp.asarray(vp)), (torch.from_numpy(kp), torch.from_numpy(vp))
    elif kind == "bf16":
        pools = ((jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)),
                 (torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()))
    else:
        jd, td = POOLS[kind]
        pools = ((jdec.quantize_kv_pages(jnp.asarray(kp), jd),
                  jdec.quantize_kv_pages(jnp.asarray(vp), jd)),
                 (tdec.quantize_kv_pages(torch.from_numpy(kp), td),
                  tdec.quantize_kv_pages(torch.from_numpy(vp), td)))
    return q, pools, lens, tbl


@pytest.mark.parametrize("kind", list(POOLS))
def test_paged_decode_matches_jax_with_the_shifted_lse(kind):
    q, ((kj, vj), (kt, vt)), lens, tbl = _paged(len(kind), kind)
    slopes = fa.alibi_slopes_for(q.shape[1])
    oj, lj = jdec.paged_decode_attention(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                                         jnp.asarray(tbl), return_lse=True,
                                         alibi_slopes=slopes)
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl))
    ot, lt = tdec.paged_decode_attention(*args, return_lse=True, alibi_slopes=slopes)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **PAGED)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PAGED)
    # the published lse is the true one (the dequantized oracle's, at the
    # JAX package's oracle tolerance, tests/test_decode.py:82) shifted by
    # +m·(length − 1)
    _, true_lse = tdec.paged_reference_attention(*args, alibi_slopes=slopes,
                                                 return_lse=True)
    shift = np.asarray(slopes)[None, :] * (lens[:, None] - 1)
    np.testing.assert_allclose(lt[1:].numpy(), (true_lse.numpy() + shift)[1:],
                               atol=2e-3, rtol=1e-3)
    assert (ot[0] == 0).all() and (lt[0] == DEFAULT_MASK_VALUE).all()
    assert float((ot - tdec.paged_decode_attention(*args)).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", list(POOLS))
def test_paged_verify_matches_jax(kind):
    t_new = 4
    q, ((kj, vj), (kt, vt)), lens, tbl = _paged(len(kind) + 7, kind, t_new,
                                                 lengths=(2, 37, 64))
    slopes = fa.alibi_slopes_for(q.shape[1])
    oj = np.asarray(jdec.paged_verify_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(lens), jnp.asarray(tbl), alibi_slopes=slopes))
    ot = tdec.paged_verify_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
                                     torch.from_numpy(tbl), alibi_slopes=slopes).numpy()
    seen = (lens[:, None] - (t_new - 1) + np.arange(t_new)[None, :] > 0)[:, None, :, None]
    np.testing.assert_allclose(np.where(seen, ot, 0), np.where(seen, oj, 0), **PAGED)
    assert (np.where(seen, 0, ot) == 0).all()


def test_verify_rows_are_decode_at_their_own_position():
    """Row t of T is single-token ALiBi decode at length − (T−1−t): its
    query sits at that length − 1."""
    t_new = 3
    q, (_, (kt, vt)), lens, tbl = _paged(11, "fp32", t_new, lengths=(5, 40, 64))
    slopes = fa.alibi_slopes_for(q.shape[1])
    o = tdec.paged_verify_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
                                    torch.from_numpy(tbl), alibi_slopes=slopes)
    for t in range(t_new):
        want = tdec.paged_decode_attention(
            torch.from_numpy(q[:, :, t].copy()), kt, vt,
            torch.from_numpy(lens - (t_new - 1 - t)), torch.from_numpy(tbl),
            alibi_slopes=slopes)
        np.testing.assert_allclose(o[:, :, t].numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# An ALiBi model: prefill, decode and verify steps, greedy serving
# ---------------------------------------------------------------------------

MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
             head_dim=32, d_ff=128, position_encoding="alibi")
JCFG = JConfig(**MODEL, dtype=jnp.float32)
TCFG = TConfig(**MODEL, dtype=torch.float32)
PS = 32


@pytest.fixture(scope="module")
def jparams():
    return init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * want.std()


def _pools(pkg, model, jparams, prompt, num_pages=8):
    """fp32 pools holding ``prompt``'s K/V from each package's prefill, and
    that prefill's last-token logits."""
    t, n_pages = len(prompt), -(-len(prompt) // PS)
    toks = np.zeros((1, 128), np.int32)
    toks[0, :t] = prompt
    if pkg == "jax":
        pools = jdecoding.init_kv_pools(JCFG, num_pages=num_pages, page_size=PS,
                                        dtype=jnp.float32)
        logits, kvs = jdecoding.make_prefill(JCFG)(jparams, jnp.asarray(toks),
                                                   jnp.asarray([t], jnp.int32))
        for li, (k, v) in enumerate(kvs):
            pools = jdecoding.write_prompt_kv(
                pools, li, (k[0, :, :n_pages * PS], v[0, :, :n_pages * PS]),
                jnp.arange(n_pages, dtype=jnp.int32), PS)
        return pools, logits
    pools = tdecoding.init_kv_pools(TCFG, num_pages=num_pages, page_size=PS,
                                    dtype=torch.float32, device="cpu")
    logits, kvs = tdecoding.make_prefill(TCFG)(model, torch.from_numpy(toks).long(),
                                               torch.tensor([t], dtype=torch.int32))
    return tdecoding.write_prompt_kv_all(pools, kvs, torch.arange(n_pages), PS), logits


def test_prefill_decode_and_verify_steps_match_jax(model, jparams):
    prompt = list(range(3, 43))
    t0 = len(prompt)
    jpools, lj = _pools("jax", model, jparams, prompt)
    tpools, lt = _pools("torch", model, jparams, prompt)
    _close(lt.numpy(), lj)
    # one decode step
    args = ([13], [t0], [t0 // PS], [t0 % PS], np.arange(8)[None], [t0 + 1])
    want, jpools = jdecoding.make_decode_step(JCFG)(  # donates its pools
        jparams, jpools, *(jnp.asarray(a, jnp.int32) for a in args))
    got, tpools = tdecoding.make_decode_step(TCFG)(
        model, tpools, *(torch.tensor(np.asarray(a), dtype=torch.int32) for a in args))
    _close(got.numpy(), want)
    # then a chunk of 3 tokens through the verify step
    t1, t_new = t0 + 1, 3
    pos = np.arange(t1, t1 + t_new, dtype=np.int32)[None]
    args = (np.asarray([[5, 7, 9]], np.int32), pos, pos // PS, pos % PS,
            np.arange(8, dtype=np.int32)[None], np.asarray([t1 + t_new], np.int32))
    want, _ = jdecoding.make_verify_step(JCFG, t_new)(
        jparams, jpools, *(jnp.asarray(a) for a in args))
    got, _ = tdecoding.make_verify_step(TCFG, t_new)(
        model, tpools, *(torch.from_numpy(a) for a in args))
    _close(got.numpy(), want)


def test_decode_step_matches_the_dense_forward(model, jparams):
    """An ALiBi model served from pages is the dense causal forward: the
    prefill's logits at the last prompt token and the decode step's at the
    next one (the JAX package's own consistency check)."""
    from flash_attention_dlrs_tpu_torch.models import forward

    prompt = list(range(1, 11))
    t0, nxt = len(prompt), 42
    tpools, lt = _pools("torch", model, jparams, prompt)
    args = ([nxt], [t0], [t0 // PS], [t0 % PS], np.arange(8)[None], [t0 + 1])
    ld, _ = tdecoding.make_decode_step(TCFG)(
        model, tpools, *(torch.tensor(np.asarray(a), dtype=torch.int32) for a in args))
    with torch.no_grad():
        full = forward(model, torch.tensor([prompt + [nxt]]), TCFG)
    np.testing.assert_allclose(lt[0].numpy(), full[0, t0 - 1].numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(ld[0].numpy(), full[0, t0].numpy(), atol=2e-4, rtol=1e-4)


SERVE_PROMPTS = [list(range(1, 40)), [7, 6, 5], list(range(60, 100))]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_greedy_tokens_identical_to_jax(model, jparams, kv):
    jd, td, quantized = {"bf16": (jnp.bfloat16, torch.bfloat16, False),
                         "int8": (jnp.int8, torch.int8, True)}[kv]
    kw = dict(num_pages=32, page_size=PS, pages_per_seq=4, num_slots=3,
              quantized_kv=quantized)
    want = JEngine(jparams, JCFG, kv_dtype=jd, **kw).generate(SERVE_PROMPTS,
                                                               max_new_tokens=5)
    got = TEngine(model, TCFG, kv_dtype=td, device="cpu", **kw).generate(
        SERVE_PROMPTS, max_new_tokens=5)
    assert got == want and all(len(o) == 5 for o in got)
