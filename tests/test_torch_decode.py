"""The PyTorch port's paged attention against the JAX package's.

Same seeded numpy inputs through ``paged_decode_attention`` and
``paged_verify_attention`` of both packages: ragged lengths (an empty
sequence included), a shuffled page table, GQA, softcap, O and lse, value
pools and int8 / int4 / fp8 pools.  The JAX kernel runs in interpret mode on
the CPU; the port runs its plain versions.  fp32, atol 1e-5 (quantized:
atol and rtol 1e-5); against the dequantized oracle both sides are held to
the JAX package's own 2e-3 / 1e-3 (``tests/test_decode.py``).  d = 128, the
width the JAX pools are padded to, so both sides see the same pools.  Each
JAX call runs under one ``jax.jit`` (:func:`_jit`): the same function on
the same inputs, compiled once, where eager dispatch compiles each
operation of its wrapper apart.
"""

import functools

import jax
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


def _jit(fn, **static):
    """``fn`` of the JAX package with the keyword arguments ``static``
    bound, under one jax.jit."""
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_matches_jax(name):
    b, hq, hkv, ps, pps, lengths, cap = CASES[name]
    arrays = _inputs(len(name), b, hq, hkv, ps, pps, lengths)
    oj, lj = _jit(jdec.paged_decode_attention, return_lse=True, logit_softcap=cap)(
        *(jnp.asarray(a) for a in arrays))
    ot, lt = tdec.paged_decode_attention(
        *_torch(*arrays), return_lse=True, logit_softcap=cap)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_reference_matches_jax(name):
    b, hq, hkv, ps, pps, lengths, cap = CASES[name]
    arrays = _inputs(len(name) + 1, b, hq, hkv, ps, pps, lengths)
    oj = _jit(jdec.paged_reference_attention, logit_softcap=cap)(
        *(jnp.asarray(a) for a in arrays))
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
    """pages_per_block now sets the pages of a key split: the CPU takes the
    plain version split as the kernel would (ops/decode.py key_splits), the
    same attention to fp32 rounding."""
    before = tdec.DECODE_KERNEL.launches
    args = _torch(*_inputs(2, 2, 4, 2, 16, 3, [9, 40]))
    o1 = tdec.paged_decode_attention(*args)
    o2 = tdec.paged_decode_attention(*args, pages_per_block=2)
    o3 = tdec.paged_reference_attention(*args)
    assert torch.equal(o1, o3)
    assert torch.equal(o2, tdec.paged_decode_plain(*args, splits=tdec.key_splits(3, 2)))
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=1e-6, rtol=1e-6)
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
    """ALiBi is ported to every paged mode; a slope count other than Hq is
    refused as in the JAX package (a single slope broadcasts)."""
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 4, 2, 16, 2, [3, 4]))
    slopes = (0.5,) * 3
    with pytest.raises(ValueError, match="per q head"):
        tdec.paged_decode_attention(q, kp, vp, lens, tbl, alibi_slopes=slopes)
    kq, vq = tdec.quantize_kv_pages(kp), tdec.quantize_kv_pages(vp)
    with pytest.raises(ValueError, match="per q head"):
        tdec.paged_decode_attention(q, kq, vq, lens, tbl, alibi_slopes=slopes)
    with pytest.raises(ValueError, match="per q head"):
        tdec.paged_verify_attention(q[:, :, None], kp, vp, lens, tbl,
                                    alibi_slopes=slopes)
    assert torch.equal(
        tdec.paged_decode_attention(q, kp, vp, lens, tbl, alibi_slopes=(0.5,)),
        tdec.paged_decode_attention(q, kp, vp, lens, tbl, alibi_slopes=(0.5,) * 4))


def test_shape_errors():
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 3, 2, 16, 2, [3, 4]))
    with pytest.raises(ValueError, match="divide"):
        tdec.paged_decode_attention(q, kp, vp, lens, tbl)
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 4, 2, 16, 2, [3, 4]))
    # q narrower than the pools is zero-padded to them (the pools' head dim
    # is the kernels'): the same O as a zero-padded q of the true scale
    got = tdec.paged_decode_attention(q[..., :64], kp, vp, lens, tbl)
    want = tdec.paged_decode_attention(
        torch.nn.functional.pad(q[..., :64], (0, q.shape[-1] - 64)), kp, vp, lens, tbl,
        sm_scale=64 ** -0.5)
    assert torch.equal(got, want[..., :64])
    with pytest.raises(ValueError, match="head_dim"):
        tdec.paged_decode_attention(torch.cat([q, q], -1), kp, vp, lens, tbl)
    with pytest.raises(ValueError):
        tdec.paged_decode_attention(q, kp, vp[:, :, :8], lens, tbl)


def test_pool_kinds_are_checked():
    q, kp, vp, lens, tbl = _torch(*_inputs(3, 2, 4, 2, 16, 2, [3, 4]))
    with pytest.raises(ValueError, match="same kind"):
        tdec.paged_decode_attention(q, tdec.quantize_kv_pages(kp, "int4"),
                                    tdec.quantize_kv_pages(vp), lens, tbl)
    with pytest.raises(ValueError):  # raw int8 is a payload, not a value pool
        tdec.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                    lens, tbl)
    kq = tdec.quantize_kv_pages(kp)
    kq.scales = kq.scales[:, :, :8]
    with pytest.raises(ValueError, match="scales"):
        tdec.paged_decode_attention(q, kq, tdec.quantize_kv_pages(vp), lens, tbl)


# ---------------------------------------------------------------------------
# Quantized pools and the multi-token verify mode
# ---------------------------------------------------------------------------

KINDS = {
    "int8": (jnp.int8, torch.int8),
    "int4": ("int4", "int4"),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
}
QUANT_TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=2e-3, rtol=1e-3)  # tests/test_decode.py:82


def _pools(kind, kp, vp):
    """(JAX pools, port pools) of one kind from the same numpy pages."""
    if kind is None:
        return (jnp.asarray(kp), jnp.asarray(vp)), _torch(kp, vp)
    jd, td = KINDS[kind]
    return ((jdec.quantize_kv_pages(jnp.asarray(kp), jd),
             jdec.quantize_kv_pages(jnp.asarray(vp), jd)),
            (tdec.quantize_kv_pages(torch.from_numpy(kp), td),
             tdec.quantize_kv_pages(torch.from_numpy(vp), td)))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_quantized_decode_matches_jax_and_oracle(kind, group):
    """Plain version vs the JAX kernel at 1e-5 (int8/int4: both take the
    integer score route), and both vs the dequantized oracle at the JAX
    package's tolerance.  Softcap on odd groups; lengths include 0, 1 and
    page boundaries.  The JAX kernel takes 4 pages a block (as
    tests/test_decode.py does): its interpret-mode compile unrolls a block's
    pages, and the default 8 doubles that compile for the same function."""
    hkv, ps, pps = 2, 64, 16  # contexts as long as the JAX package's test's
    cap = 30.0 if group % 2 else 0.0
    lengths = [0, 1, ps * pps - 37, ps * pps]
    q, kp, vp, lens, tbl = _inputs(group * 10 + len(kind), 4, group * hkv, hkv,
                                   ps, pps, lengths)
    (kj, vj), (kt, vt) = _pools(kind, kp, vp)
    oj, lj = _jit(jdec.paged_decode_attention, return_lse=True, logit_softcap=cap,
                  pages_per_block=4)(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                                     jnp.asarray(tbl))
    ot, lt = tdec.paged_decode_attention(
        *_torch(q), kt, vt, *_torch(lens, tbl), return_lse=True,
        logit_softcap=cap)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **QUANT_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **QUANT_TOL)
    assert (ot[0] == 0).all() and (lt[0] == DEFAULT_MASK_VALUE).all()
    oracle = tdec.paged_reference_attention(*_torch(q), kt, vt, *_torch(lens, tbl),
                                            logit_softcap=cap).numpy()
    np.testing.assert_allclose(ot.numpy(), oracle, **ORACLE_TOL)
    np.testing.assert_allclose(np.asarray(oj), oracle, **ORACLE_TOL)


def _visible(lengths, t_new):
    """[B, T] mask of the verify rows that see at least one position."""
    lengths = np.asarray(lengths)
    return (lengths[:, None] - (t_new - 1) + np.arange(t_new)[None, :]) > 0


@pytest.mark.parametrize("t_new", [1, 3, 8])
@pytest.mark.parametrize("kind", [None, "int8", "int4", "e5m2"])
def test_paged_verify_matches_jax(kind, t_new):
    """Rows that see nothing (lengths < T) are zeros in the port; the TPU
    kernel leaves them undefined, so they are compared with 0 only.  The
    JAX kernel takes a page a block: its interpret-mode compile unrolls a
    block's pages (the default 2 doubles it for the same function)."""
    b, hq, hkv, ps, pps, d = 3, 4, 2, 16, 4, 128
    lengths = [2, 37, 64]
    _, kp, vp, lens, tbl = _inputs(t_new + 3 * len(str(kind)), b, hq, hkv, ps,
                                   pps, lengths)
    q = np.random.default_rng(t_new).standard_normal((b, hq, t_new, d),
                                                     dtype=np.float32)
    (kj, vj), (kt, vt) = _pools(kind, kp, vp)
    cap = 25.0 if t_new == 3 else 0.0
    oj = np.asarray(_jit(jdec.paged_verify_attention, logit_softcap=cap, pages_per_block=1)(
        jnp.asarray(q), kj, vj, jnp.asarray(lens), jnp.asarray(tbl)))
    ot = tdec.paged_verify_attention(*_torch(q), kt, vt, *_torch(lens, tbl),
                                     logit_softcap=cap).numpy()
    seen = _visible(lengths, t_new)[:, None, :, None]
    np.testing.assert_allclose(np.where(seen, ot, 0), np.where(seen, oj, 0),
                               **QUANT_TOL)
    assert (np.where(seen, 0, ot) == 0).all()


@pytest.mark.parametrize("kind", [None, "int8", "int4", "e4m3"])
def test_paged_verify_rows_match_the_per_token_oracle(kind):
    """Token t of T is single-token attention at length − (T−1−t)."""
    b, hq, hkv, ps, pps, d, t_new = 2, 8, 2, 16, 8, 64, 4
    lengths = [ps * pps, 77]
    _, kp, vp, lens, tbl = _inputs(5, b, hq, hkv, ps, pps, lengths, d=d)
    q = np.random.default_rng(6).standard_normal((b, hq, t_new, d),
                                                 dtype=np.float32)
    _, (kt, vt) = _pools(kind, kp, vp)
    o = tdec.paged_verify_attention(*_torch(q), kt, vt, *_torch(lens, tbl))
    for t in range(t_new):
        lt = torch.from_numpy(lens - (t_new - 1 - t))
        want = tdec.paged_reference_attention(
            torch.from_numpy(q[:, :, t]), kt, vt, lt, torch.from_numpy(tbl))
        np.testing.assert_allclose(o[:, :, t].numpy(), want.numpy(),
                                   atol=2e-4, rtol=1e-4)


def test_verify_of_one_token_is_decode_on_value_pools():
    q, kp, vp, lens, tbl = _torch(*_inputs(8, 2, 4, 2, 16, 4, [40, 64]))
    o_v = tdec.paged_verify_attention(q[:, :, None], kp, vp, lens, tbl)
    o_d = tdec.paged_decode_attention(q, kp, vp, lens, tbl)
    np.testing.assert_allclose(o_v[:, :, 0].numpy(), o_d.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_quantized_cpu_path_takes_the_plain_version():
    before = (tdec.DECODE_KERNEL.launches, tdec.VERIFY_KERNEL.launches)
    q, kp, vp, lens, tbl = _torch(*_inputs(9, 2, 4, 2, 16, 3, [9, 40]))
    kq, vq = tdec.quantize_kv_pages(kp, "int4"), tdec.quantize_kv_pages(vp, "int4")
    o = tdec.paged_decode_attention(q, kq, vq, lens, tbl, pages_per_block=2)
    want = tdec.paged_decode_plain(q, kq, vq, lens, tbl, splits=tdec.key_splits(3, 2))
    assert torch.equal(o, want)
    assert (tdec.DECODE_KERNEL.launches, tdec.VERIFY_KERNEL.launches) == before


def test_bf16_q_rounds_p_times_v_scale_like_jax():
    """bf16 q with int8 pools: q pre-scaled in bf16, P·v_scale rounded to
    bf16 before P V, on both sides (a bf16 output ulp apart at most)."""
    q, kp, vp, lens, tbl = _inputs(10, 2, 4, 2, 16, 4, [30, 64])
    (kj, vj), (kt, vt) = _pools("int8", kp, vp)
    qb = torch.from_numpy(q).bfloat16()
    oj = _jit(jdec.paged_decode_attention)(jnp.asarray(qb.float().numpy(), jnp.bfloat16),
                                           kj, vj, jnp.asarray(lens), jnp.asarray(tbl))
    ot = tdec.paged_decode_attention(qb, kt, vt, *_torch(lens, tbl))
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               atol=2 ** -8, rtol=2 ** -7)
