"""The PyTorch port's attention forward (O and L) against the JAX package's.

Same seeded numpy inputs through ``flash_attention_forward`` of both
packages.  The JAX side runs its Pallas routes as its own tests do on the
CPU (interpret mode); the port runs the forward kernel's plain version,
which CPU tensors take.  Tolerances: the repo's fp32 forward ladder, atol
1e-4 / rtol 1e-5 (tests/test_forward.py:21); bf16 against the fp32 oracle
at atol 2e-2 (bf16 output rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.ops import fwd_kernel as jfwd
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.ops.flash_attention import flash_attention

ATOL, RTOL = 1e-4, 1e-5

CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap)
    # N = 256: JAX's one-shot small route; 640 and 1024: its mid pane route.
    "n256_causal_gqa": (1, 4, 2, 256, 256, 64, True, 0, 0.0),
    "n640_causal": (1, 2, 2, 640, 640, 64, True, 0, 0.0),
    "n1024_causal_gqa": (1, 4, 2, 1024, 1024, 64, True, 0, 0.0),
    "n256_noncausal": (2, 2, 2, 256, 256, 64, False, 0, 0.0),
    "window_softcap": (1, 2, 1, 512, 512, 64, True, 96, 25.0),
    "bottom_right_tail": (1, 2, 2, 100, 300, 64, True, 0, 0.0),
    "noncausal_tail": (1, 2, 1, 77, 333, 128, False, 0, 0.0),
}


def _inputs(seed, b, hq, hkv, nq, nkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    return q, k, v


def _both(q, k, v, **kw):
    oj, lj = fa.flash_attention_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    ot, lt = tp.flash_attention_forward(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), **kw)
    return (np.asarray(oj), np.asarray(lj)), (ot.numpy(), lt.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_fp32(name):
    b, hq, hkv, nq, nkv, d, causal, window, cap = CASES[name]
    q, k, v = _inputs(len(name), b, hq, hkv, nq, nkv, d)
    (oj, lj), (ot, lt) = _both(q, k, v, causal=causal, window=window,
                               logit_softcap=cap)
    np.testing.assert_allclose(ot, oj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


def test_forward_bf16_against_fp32_oracle():
    q, k, v = _inputs(7, 1, 4, 2, 384, 384, 64)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qb, kb, vb = to_bf16(q), to_bf16(k), to_bf16(v)
    o, lse = tp.flash_attention_forward(qb, kb, vb, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    oj, lj = fa.reference_attention(
        jnp.asarray(qb.float().numpy()), jnp.asarray(kb.float().numpy()),
        jnp.asarray(vb.float().numpy()), causal=True, sm_scale=64 ** -0.5,
        with_lse=True)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(oj), atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lj), atol=1e-4, rtol=0)


def test_empty_rows_zero_output_and_sentinel_lse():
    # causal with Nq > Nkv: rows i < Nq - Nkv see no key
    q, k, v = _inputs(3, 1, 2, 2, 160, 64, 64)
    (oj, lj), (ot, lt) = _both(q, k, v, causal=True)
    empty = 160 - 64
    assert (ot[:, :, :empty] == 0).all()
    assert (lt[:, :, :empty] == tfwd.DEFAULT_MASK_VALUE).all()
    np.testing.assert_allclose(ot, oj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


def test_constants_match_jax():
    assert tfwd.DEFAULT_MASK_VALUE == jfwd.DEFAULT_MASK_VALUE
    assert tfwd.LOG2E == jfwd.LOG2E and tfwd.LN2 == jfwd.LN2


def test_default_sm_scale_is_rsqrt_d():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 2, 64, 64, 32))
    o1, l1 = tp.flash_attention_forward(q, k, v, causal=True)
    o2, l2 = tp.flash_attention_forward(q, k, v, causal=True, sm_scale=32 ** -0.5)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_flash_attention_op_forward_and_unported_backward():
    """The op's forward equals the functional forward, and its backward
    equals the functional backward on the forward's own (O, L)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 4, 2, 96, 96, 32))
    o_fn, lse = tp.flash_attention_forward(q, k, v, causal=True)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg, causal=True)
    assert torch.equal(o.detach(), o_fn)
    do = torch.ones_like(o)
    o.backward(do)
    want = tp.flash_attention_backward(q, k, v, o_fn, do, lse, causal=True)
    assert all(torch.equal(g, w) for g, w in zip((qg.grad, kg.grad, vg.grad), want))


def test_cpu_tensors_take_the_plain_version():
    before = tfwd.FWD_KERNEL.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 1, 50, 70, 64))
    o, lse = tfwd.attn_fwd(q, k, v, causal=True, sm_scale=0.125)
    o_p, lse_p = tfwd.attn_fwd_plain(q, k, v, causal=True, sm_scale=0.125)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tfwd.FWD_KERNEL.launches == before


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kwargs,exc", [
    ((_t((2, 8, 16)), _t((2, 8, 16)), _t((2, 8, 16))), {}, ValueError),
    ((_t((1, 2, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 9, 16))), {}, ValueError),
    ((_t((1, 2, 8, 16)), _t((1, 2, 8, 32)), _t((1, 2, 8, 32))), {}, ValueError),
    ((_t((1, 3, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 8, 16))), {}, ValueError),
    ((_t((1, 2, 8, 16)), _t((1, 2, 8, 16), torch.bfloat16),
      _t((1, 2, 8, 16), torch.bfloat16)), {}, ValueError),
    ((_t((1, 2, 8, 16), torch.float64), _t((1, 2, 8, 16), torch.float64),
      _t((1, 2, 8, 16), torch.float64)), {}, NotImplementedError),
    # fp8 V is ported: with fp64 q/k it meets the fp64 refusal, as in JAX.
    ((_t((1, 2, 8, 16), torch.float64), _t((1, 2, 8, 16), torch.float64),
      _t((1, 2, 8, 16), torch.float8_e4m3fn)), {}, NotImplementedError),
    ((_t((1, 2, 8, 16)),) * 3, {"window": 4}, ValueError),
    ((_t((1, 2, 8, 16)),) * 3, {"causal": True, "window": -1}, ValueError),
    ((_t((1, 2, 8, 16)),) * 3, {"logit_softcap": -1.0}, ValueError),
    # ALiBi and dropout are ported: their misuse raises as in the JAX package
    # (ALiBi without causal; dropout at rate 1).  The ids predate the port.
    pytest.param((_t((1, 2, 8, 16)),) * 3, {"alibi_slopes": (0.5, 0.25)}, ValueError,
                 id="args10-kwargs10-NotImplementedError"),
    pytest.param((_t((1, 2, 8, 16)),) * 3, {"dropout_rate": 1.0, "dropout_seed": 1},
                 ValueError, id="args11-kwargs11-NotImplementedError"),
    # Segments are ported: ids of the wrong shape raise as in JAX.
    pytest.param((_t((1, 2, 8, 16)),) * 3,
                 {"segment_ids": torch.zeros(1, 7, dtype=torch.int32)}, ValueError,
                 id="args12-kwargs12-NotImplementedError"),
])
def test_validation_errors(args, kwargs, exc):
    with pytest.raises(exc):
        tp.flash_attention_forward(*args, **kwargs)
    with pytest.raises(exc):
        flash_attention(*args, **kwargs)
