"""The PyTorch port's paged decode attention against the JAX package's.

Same seeded numpy inputs through ``paged_decode_attention`` of both
packages: ragged lengths (an empty sequence included), a shuffled page
table, GQA, softcap, O and lse.  The JAX kernel runs in interpret mode on
the CPU; the port runs its plain version.  fp32, atol 1e-5.  d = 128, the
width the JAX pools are padded to, so both sides see the same pools.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE

ATOL = 1e-5

CASES = {
    # name: (B, Hq, Hkv, page_size, pages_per_seq, lengths, softcap)
    "gqa_ragged": (3, 4, 2, 16, 4, [5, 40, 64], 0.0),
    "mha_softcap": (2, 2, 2, 16, 4, [17, 33], 30.0),
    "gqa4_with_empty": (4, 8, 2, 8, 6, [0, 1, 47, 48], 0.0),
    "long_pages": (2, 4, 1, 32, 3, [96, 50], 10.0),
}


def _inputs(seed, b, hq, hkv, ps, pps, lengths, d=128):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), tbl


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_matches_jax(name):
    b, hq, hkv, ps, pps, lengths, cap = CASES[name]
    arrays = _inputs(len(name), b, hq, hkv, ps, pps, lengths)
    oj, lj = jdec.paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), return_lse=True, logit_softcap=cap)
    ot, lt = tdec.paged_decode_attention(
        *_torch(*arrays), return_lse=True, logit_softcap=cap)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_reference_matches_jax(name):
    b, hq, hkv, ps, pps, lengths, cap = CASES[name]
    arrays = _inputs(len(name) + 1, b, hq, hkv, ps, pps, lengths)
    oj = jdec.paged_reference_attention(
        *(jnp.asarray(a) for a in arrays), logit_softcap=cap)
    ot = tdec.paged_reference_attention(*_torch(*arrays), logit_softcap=cap)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)


def test_empty_sequence_gives_zero_and_sentinel():
    arrays = _inputs(0, 2, 4, 2, 16, 2, [0, 20])
    o, lse = tdec.paged_decode_attention(*_torch(*arrays), return_lse=True)
    assert (o[0] == 0).all() and (lse[0] == DEFAULT_MASK_VALUE).all()
    assert torch.isfinite(o[1]).all() and (lse[1] > DEFAULT_MASK_VALUE).all()


def test_lengths_past_the_table_are_clamped():
    arrays = list(_inputs(1, 2, 4, 2, 16, 2, [32, 20]))
    o_full = tdec.paged_decode_attention(*_torch(*arrays))
    arrays[3] = np.asarray([500, 20], np.int32)
    o_over = tdec.paged_decode_attention(*_torch(*arrays))
    assert torch.equal(o_full, o_over)


def test_pages_per_block_is_ignored_and_cpu_takes_plain_version():
    before = tdec.DECODE_KERNEL.launches
    args = _torch(*_inputs(2, 2, 4, 2, 16, 3, [9, 40]))
    o1 = tdec.paged_decode_attention(*args)
    o2 = tdec.paged_decode_attention(*args, pages_per_block=2)
    o3 = tdec.paged_reference_attention(*args)
    assert torch.equal(o1, o2) and torch.equal(o1, o3)
    assert tdec.DECODE_KERNEL.launches == before


def test_bf16_pools_with_bf16_q():
    arrays = _inputs(4, 2, 4, 2, 16, 3, [9, 40])
    q, kp, vp, lens, tbl = _torch(*arrays)
    o = tdec.paged_decode_attention(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                                    lens, tbl)
    ref = tdec.paged_reference_attention(q, kp.bfloat16().float(),
                                         vp.bfloat16().float(), lens, tbl)
    assert o.dtype == torch.bfloat16
    # q rounded to bf16 and the output rounded to bf16
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), atol=2e-2, rtol=0)


def test_unported_modes_raise():
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 4, 2, 16, 2, [3, 4]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.paged_decode_attention(q, kp, vp, lens, tbl, alibi_slopes=(0.5,) * 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                    lens, tbl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdec.paged_verify_attention(q[:, :, None], kp, vp, lens, tbl)


def test_shape_errors():
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 3, 2, 16, 2, [3, 4]))
    with pytest.raises(ValueError, match="divide"):
        tdec.paged_decode_attention(q, kp, vp, lens, tbl)
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 4, 2, 16, 2, [3, 4]))
    with pytest.raises(ValueError, match="head_dim"):
        tdec.paged_decode_attention(q[..., :64], kp, vp, lens, tbl)
    with pytest.raises(ValueError):
        tdec.paged_decode_attention(q, kp, vp[:, :, :8], lens, tbl)
