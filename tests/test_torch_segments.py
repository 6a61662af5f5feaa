"""Packed sequences (segment ids) and fp8 V in the PyTorch port, against the
JAX package.

Same seeded numpy inputs through both packages.  The JAX side runs its
Pallas routes as its own tests do on the CPU (interpret mode); the port runs
the kernels' plain versions, which CPU tensors take.  Tolerances: the
oracles agree to 1e-6 in fp32 (the same function, summation order apart);
the forward ladder O and lse atol 1e-4 / rtol 1e-5 (tests/test_forward.py:21);
the fp32 gradient ladder dQ 9e-4 / dK 7e-4 / dV 7e-5, rtol 1e-5
(tests/test_backward.py:25); bf16 q/k with fp8 V at 2e-2 / 2e-2, the JAX
package's own fp8-V tolerance (tests/test_forward.py:530-544).  Rows whose
segment id occurs nowhere in the keys see nothing: O = 0 and L =
DEFAULT_MASK_VALUE in both flash packages, NaN in both oracles, which are
compared on finite rows only (tests/test_forward.py:243-245).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.ops import reference as jref
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.ops import reference as tref

ATOL, RTOL = 1e-4, 1e-5
GRAD_ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _packed(rng, b, n, max_segs=4):
    """A packed layout as tests/test_forward.py:200-210 makes it: each row
    split at max_segs - 1 random boundaries into up to max_segs documents
    (ids 0, 1, ...), so documents run shorter and longer than a 64-key tile
    and their boundaries fall inside tiles and on their edges alike."""
    ids = np.zeros((b, n), np.int32)
    for row in ids:
        for bound in np.sort(rng.integers(1, n, max_segs - 1)):
            row[bound:] += 1
    return ids


CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, kwargs, cross)
    # N = 200 does not divide 64: the kernels mask the tail by bounds.
    "causal_gqa_n200": (2, 4, 2, 200, 200, 64, dict(causal=True), False),
    "noncausal_n256": (1, 2, 2, 256, 256, 64, dict(causal=False), False),
    # SegmentIds(q, kv) of different lengths; the last 20 q rows carry an id
    # that no key has, so they see nothing.
    "cross_pair_nq128_nkv320": (2, 2, 1, 128, 320, 64, dict(causal=False), True),
    "window_softcap": (1, 2, 1, 256, 256, 64,
                       dict(causal=True, window=48, logit_softcap=20.0), False),
    "alibi": (1, 4, 2, 192, 192, 64,
              dict(causal=True, alibi_slopes=fa.alibi_slopes_for(4)), False),
    "dropout": (1, 2, 2, 160, 160, 64,
                dict(causal=True, dropout_rate=0.1, dropout_seed=-9), False),
}


def _inputs(name):
    b, hq, hkv, nq, nkv, d, kw, cross = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    if cross:
        qs, ks = _packed(rng, b, nq), _packed(rng, b, nkv)
        qs[:, -20:] = 99
        return (q, k, v, do), (qs, ks), kw
    return (q, k, v, do), (_packed(rng, b, nq),), kw


def _seg(ids, mod):
    """The segment ids as the package ``mod`` takes them: a SegmentIds pair,
    or the single [B, N] array."""
    conv = jnp.asarray if mod is fa else torch.from_numpy
    if len(ids) == 1:
        return conv(ids[0])
    return mod.SegmentIds(q=conv(ids[0]), kv=conv(ids[1]))


def _empty_rows(ids):
    """[B, Nq] mask of the rows whose id occurs nowhere among the keys."""
    qs, ks = (ids[0], ids[0]) if len(ids) == 1 else ids
    return np.stack([~np.isin(a, b) for a, b in zip(qs, ks)])


@pytest.mark.parametrize("name", ["causal_gqa_n200", "noncausal_n256",
                                  "cross_pair_nq128_nkv320", "single_array_gqa"])
def test_reference_segments_match_jax(name):
    if name == "single_array_gqa":  # one [B, N] array for both sides
        (q, k, v, _), ids, kw = _inputs("causal_gqa_n200")
        kw = dict(causal=False)
    else:
        (q, k, v, _), ids, kw = _inputs(name)
    oj, lj = jref.reference_attention(*map(jnp.asarray, (q, k, v)), sm_scale=64 ** -0.5,
                                      segment_ids=_seg(ids, fa), with_lse=True, **kw)
    ot, lt = tref.reference_attention(*map(torch.from_numpy, (q, k, v)), sm_scale=64 ** -0.5,
                                      segment_ids=_seg(ids, tp), with_lse=True, **kw)
    oj, lj = np.asarray(oj), np.asarray(lj)
    finite = np.isfinite(oj)
    assert (finite == np.isfinite(ot.numpy())).all()
    assert finite.all() == (not _empty_rows(ids).any())
    np.testing.assert_allclose(ot.numpy()[finite], oj[finite], atol=1e-6, rtol=0)
    np.testing.assert_allclose(lt.numpy()[np.isfinite(lj)], lj[np.isfinite(lj)],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmented_forward_matches_jax(name):
    (q, k, v, _), ids, kw = _inputs(name)
    oj, lj = fa.flash_attention_forward(*map(jnp.asarray, (q, k, v)), sm_scale=1.0,
                                        segment_ids=_seg(ids, fa), **kw)
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), sm_scale=1.0,
                                        segment_ids=_seg(ids, tp), **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=RTOL)


def test_rows_matching_no_key_are_zero_with_the_sentinel_lse():
    (q, k, v, _), ids, kw = _inputs("cross_pair_nq128_nkv320")
    empty = _empty_rows(ids)
    assert empty[:, -20:].all() and empty.sum() >= 40
    oj, lj = fa.flash_attention_forward(*map(jnp.asarray, (q, k, v)),
                                        segment_ids=_seg(ids, fa), **kw)
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)),
                                        segment_ids=_seg(ids, tp), **kw)
    for o, lse in ((np.asarray(oj), np.asarray(lj)), (ot.numpy(), lt.numpy())):
        assert (o.transpose(0, 2, 1, 3)[empty] == 0).all()
        assert (lse.transpose(0, 2, 1)[empty] == tfwd.DEFAULT_MASK_VALUE).all()
        assert np.isfinite(o).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmented_grads_match_jax(name):
    (q, k, v, do), ids, kw = _inputs(name)
    _, vjp = jax.vjp(lambda a, b_, c: fa.flash_attention(
        a, b_, c, sm_scale=1.0, segment_ids=_seg(ids, fa), **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tp.flash_attention(qt, kt, vt, sm_scale=1.0, segment_ids=_seg(ids, tp),
                       **kw).backward(torch.from_numpy(do))
    for gname, got, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL[gname],
                                   rtol=RTOL, err_msg=gname)


def test_segment_ids_of_any_integer_type_and_negative_ids():
    """Any integer ids are cast to int32 once; no sentinel is reserved, so
    ids of -1 and -2 behave as in the oracle."""
    (q, k, v, _), (ids,), _ = _inputs("causal_gqa_n200")
    ids = ids.astype(np.int64) - 2
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    before = tfwd.FWD_SEG_KERNEL.launches
    o64, l64 = tp.flash_attention_forward(qt, kt, vt, causal=True, segment_ids=ids)
    o32, l32 = tp.flash_attention_forward(qt, kt, vt, causal=True,
                                          segment_ids=torch.from_numpy(ids).int())
    assert torch.equal(o64, o32) and torch.equal(l64, l32)
    want = tref.reference_attention(qt, kt, vt, causal=True, sm_scale=64 ** -0.5,
                                    segment_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(o64.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    assert tfwd.FWD_SEG_KERNEL.launches == before  # CPU tensors: the plain version


def _fp8_inputs(n, kind, qk_dtype=torch.bfloat16, seed=81):
    """q, k (bf16 or fp32) and fp8 V for both packages, from one numpy draw;
    the two packages' fp8 roundings of V are checked equal."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 2, n, 64), dtype=np.float32) for _ in range(3))
    jdt, tdt = FP8[kind]
    jqk = jnp.bfloat16 if qk_dtype == torch.bfloat16 else jnp.float32
    jax_in = (jnp.asarray(q).astype(jqk), jnp.asarray(k).astype(jqk),
              jnp.asarray(v).astype(jdt))
    port_in = (torch.from_numpy(q).to(qk_dtype), torch.from_numpy(k).to(qk_dtype),
               torch.from_numpy(v).to(tdt))
    assert np.array_equal(np.asarray(jax_in[2].astype(jnp.float32)), port_in[2].float().numpy())
    return jax_in, port_in


@pytest.mark.parametrize("kind", sorted(FP8))
@pytest.mark.parametrize("n", [256, 640])  # the JAX package's xla-small and pane routes
def test_fp8_v_forward_matches_jax(n, kind):
    (qj, kj, vj), (qt, kt, vt) = _fp8_inputs(n, kind)
    oj = fa.flash_attention(qj, kj, vj, causal=True, sm_scale=0.5)
    ot = tp.flash_attention(qt, kt, vt, causal=True, sm_scale=0.5)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", sorted(FP8))
def test_fp8_v_n2100_against_the_oracle(kind):
    """At N = 2100 the JAX package's strip route fails its own fp8-V test
    (ROADMAP queue 3), so the port is held against the oracles: its own,
    and JAX's on V upcast to fp32."""
    (qj, kj, vj), (qt, kt, vt) = _fp8_inputs(2100, kind)
    ot = tp.flash_attention(qt, kt, vt, causal=True, sm_scale=0.5).float().numpy()
    want = tref.reference_attention(qt, kt, vt, causal=True, sm_scale=0.5).float().numpy()
    np.testing.assert_allclose(ot, want, atol=2e-2, rtol=2e-2)
    wj = jref.reference_attention(qj.astype(jnp.float32), kj.astype(jnp.float32),
                                  vj.astype(jnp.float32), causal=True, sm_scale=0.5)
    np.testing.assert_allclose(ot, np.asarray(wj), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", sorted(FP8))
def test_fp8_v_with_fp32_qk(kind):
    """fp32 q/k with fp8 V computes in fp32 on V's exact values: the forward
    ladder against the JAX oracle on V upcast to fp32, with segments too."""
    (qj, kj, vj), (qt, kt, vt) = _fp8_inputs(300, kind, torch.float32, seed=5)
    ids = _packed(np.random.default_rng(6), 1, 300)
    for seg in (None, ids):
        ot, lt = tp.flash_attention_forward(
            qt, kt, vt, causal=True, sm_scale=0.5,
            segment_ids=None if seg is None else torch.from_numpy(seg))
        oj, lj = jref.reference_attention(
            qj, kj, vj.astype(jnp.float32), causal=True, sm_scale=0.5, with_lse=True,
            segment_ids=None if seg is None else jnp.asarray(seg))
        assert ot.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=RTOL)


def test_fp8_v_backward_raises():
    """As tests/test_forward.py:547-558: fp8 V is forward-only."""
    _, (qt, kt, vt) = _fp8_inputs(256, "e5m2", seed=82)
    qt.requires_grad_(True)
    o = tp.flash_attention(qt, kt, vt, causal=True)
    with pytest.raises(NotImplementedError, match="fp8 V"):
        o.float().sum().backward()
    with pytest.raises(NotImplementedError, match="fp8 V"):
        tp.flash_attention_backward(qt.detach(), kt, vt, o.detach(), o.detach(),
                                    torch.zeros(o.shape[:3]), causal=True)
