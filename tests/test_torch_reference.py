"""The PyTorch port's attention oracle against the JAX package's.

Same seeded numpy inputs through ``flash_attention_dlrs_tpu.ops.reference``
and ``flash_attention_dlrs_tpu_torch.ops.reference``; fp32, atol 1e-5 (both
compute fp32 scores and softmax from the same inputs; only the summation
order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.ops import reference as jref
from flash_attention_dlrs_tpu_torch.ops import reference as tref

ATOL = 1e-5

CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap)
    "noncausal": (2, 4, 4, 96, 96, 32, False, 0, 0.0),
    "causal_square": (1, 4, 4, 128, 128, 64, True, 0, 0.0),
    "causal_nq_lt_nkv": (1, 2, 2, 40, 150, 32, True, 0, 0.0),
    "causal_nq_gt_nkv_empty_rows": (1, 2, 2, 150, 40, 32, True, 0, 0.0),
    "gqa": (2, 8, 2, 64, 64, 32, True, 0, 0.0),
    "window": (1, 4, 2, 200, 200, 32, True, 48, 0.0),
    "softcap": (1, 4, 4, 100, 100, 32, True, 0, 20.0),
    "kv_tail": (1, 2, 1, 77, 333, 64, False, 0, 0.0),
}


def _inputs(seed, b, hq, hkv, nq, nkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_attention_matches_jax(name):
    b, hq, hkv, nq, nkv, d, causal, window, cap = CASES[name]
    q, k, v = _inputs(len(name), b, hq, hkv, nq, nkv, d)
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window,
              logit_softcap=cap, with_lse=True)
    oj, lj = jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    ot, lt = tref.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), **kw)
    # rows that see no key are NaN in both oracles (equal_nan holds them)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)


def test_reference_empty_rows_are_nan_like_jax():
    b, hq, hkv, nq, nkv, d, *_ = CASES["causal_nq_gt_nkv_empty_rows"]
    q, k, v = _inputs(0, b, hq, hkv, nq, nkv, d)
    ot = tref.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    empty = nq - nkv  # rows i with i + (nkv - nq) < 0
    assert torch.isnan(ot[:, :, :empty]).all()
    assert torch.isfinite(ot[:, :, empty:]).all()


@pytest.mark.parametrize("n_heads", [1, 2, 3, 5, 8, 12, 16, 24])
def test_alibi_slopes_for_matches_jax(n_heads):
    assert tref.alibi_slopes_for(n_heads) == jref.alibi_slopes_for(n_heads)


@pytest.mark.parametrize("kwarg", [
    dict(segment_ids=np.zeros((1, 8), np.int32)),
    dict(alibi_slopes=(0.5,)),
    dict(dropout_rate=0.1, dropout_seed=0),
])
def test_reference_unported_features_raise(kwarg):
    x = torch.zeros(1, 1, 8, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tref.reference_attention(x, x, x, causal=True, **kwarg)
