"""Key splits of the port's paged decode against the JAX package.

The split planner (``decode_splits``: static shapes only, whole pages, the
serving model's batches filling the card), the plain version with splits
(``paged_decode_plain(..., splits=s)``, the arithmetic of the kernel's
split and combine passes) against JAX ``paged_decode_attention`` in
interpret mode on value, int8 and int4 pools with an empty sequence, splits
that see no token and ALiBi, the combine pass against a fold of JAX
``parallel/ring.py`` ``merge_partials``, and ``verify_route`` against the
route table of PERF.md.  Inputs are made by numpy from a seed; fp32, atol
1e-4 / rtol 1e-5 (``tests/test_forward.py:21``).
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu.parallel.ring import merge_partials
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE
from flash_attention_dlrs_tpu_torch.ops.reference import alibi_slopes_for

TOL = dict(atol=1e-4, rtol=1e-5)  # tests/test_forward.py:21
H100_SMS = 132


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

PLANS = [
    # batch, num_kv_heads, pages_per_seq, page_size, num_sms
    (4, 8, 17, 128, H100_SMS),
    (8, 8, 17, 128, H100_SMS),
    (32, 8, 17, 128, H100_SMS),
    (1, 8, 136, 16, H100_SMS),
    (5, 8, 34, 64, H100_SMS),
    (1, 1, 7, 3, H100_SMS),
    (3, 2, 1, 16, H100_SMS),
    (64, 8, 17, 128, H100_SMS),
    (2, 4, 1000, 1, 8),
]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "_".join(map(str, p)))
def test_planner_covers_every_page_once_in_whole_pages(plan):
    batch, hkv, pps, page_size, sms = plan
    splits = tdec.decode_splits(batch, hkv, pps, page_size, sms)
    assert isinstance(splits, int) and 1 <= splits <= pps
    per, n = tdec.split_pages(pps, splits)
    assert n == splits  # the count the planner gives is the kernel's
    runs = [range(i * per, min((i + 1) * per, pps)) for i in range(splits)]
    covered = [p for r in runs for p in r]
    assert covered == list(range(pps)) and all(len(r) > 0 for r in runs)
    # a split covers at least one tile of tokens, unless the table is shorter
    assert per * page_size >= min(tdec.SPLIT_MIN_TOKENS, pps * page_size)


def test_planner_takes_no_tensor():
    params = list(inspect.signature(tdec.decode_splits).parameters)
    assert params == ["batch", "num_kv_heads", "pages_per_seq", "page_size", "num_sms"]
    with pytest.raises(TypeError):
        tdec.decode_splits(torch.tensor(4), 8, 17, 128, H100_SMS)
    with pytest.raises(TypeError):
        tdec.decode_splits(4, 8, torch.tensor([2048, 10]), 128, H100_SMS)
    with pytest.raises(ValueError):
        tdec.decode_splits(4, 8, 0, 128, H100_SMS)


@pytest.mark.parametrize("slots", [4, 8])
def test_planner_fills_the_card_for_the_serving_model(slots):
    """The serving model (16 q / 8 kv heads, page 128, 17 pages a
    sequence): a CTA serves two q heads of a kv head and one split."""
    hq, hkv, pps, page = 16, 8, 17, 128
    splits = tdec.decode_splits(slots, hkv, pps, page, H100_SMS)
    ctas = splits * slots * hkv * -(-(hq // hkv) // 2)
    assert ctas >= H100_SMS
    assert ctas >= 2 * H100_SMS  # two an SM: the table is long enough


# ---------------------------------------------------------------------------
# The split plain version against JAX
# ---------------------------------------------------------------------------

# B, Hq, Hkv, page_size, pages_per_seq, lengths: an empty sequence, one
# shorter than a page (later splits see nothing), a split boundary plus
# one, and the full table.
SHAPE = (4, 4, 2, 16, 8, [0, 5, 49, 128])
KINDS = {None: None, "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def _inputs(seed, d=128):
    b, hq, hkv, ps, pps, lengths = SHAPE
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), tbl


def _pools(kind, kp, vp):
    """(JAX pools, port pools) of one kind from the same numpy pages."""
    if kind is None:
        return (jnp.asarray(kp), jnp.asarray(vp)), (torch.from_numpy(kp), torch.from_numpy(vp))
    jd, td = KINDS[kind]
    return ((jdec.quantize_kv_pages(jnp.asarray(kp), jd),
             jdec.quantize_kv_pages(jnp.asarray(vp), jd)),
            (tdec.quantize_kv_pages(torch.from_numpy(kp), td),
             tdec.quantize_kv_pages(torch.from_numpy(vp), td)))


@functools.lru_cache(maxsize=None)
def _case(kind, alibi):
    """Inputs, port pools and the JAX kernel's (O, lse) of one case."""
    q, kp, vp, lens, tbl = _inputs(7 + 3 * len(str(kind)) + alibi)
    (kj, vj), (kt, vt) = _pools(kind, kp, vp)
    slopes = alibi_slopes_for(SHAPE[1]) if alibi else None
    cap = 0.0 if alibi else 25.0
    oj, lj = jdec.paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(lens), jnp.asarray(tbl), return_lse=True,
        logit_softcap=cap, alibi_slopes=None if slopes is None else jnp.asarray(slopes))
    return q, kt, vt, lens, tbl, slopes, cap, np.asarray(oj), np.asarray(lj)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("kind,alibi", [(None, False), ("int8", False), ("int4", False),
                                        (None, True), ("int8", True)])
def test_split_plain_matches_jax(kind, alibi, splits):
    q, kt, vt, lens, tbl, slopes, cap, oj, lj = _case(kind, alibi)
    ot, lt = tdec.paged_decode_plain(
        torch.from_numpy(q), kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl),
        return_lse=True, logit_softcap=cap, alibi_slopes=slopes, splits=splits)
    np.testing.assert_allclose(ot.numpy(), oj, **TOL)
    np.testing.assert_allclose(lt.numpy(), lj, **TOL)
    assert (ot[0] == 0).all() and (lt[0] == DEFAULT_MASK_VALUE).all()


def test_splits_that_see_nothing_weigh_zero():
    """Splits past a sequence's length get lse −inf and change nothing: the
    split result of a short sequence is its unsplit result."""
    q, kt, vt, lens, tbl, slopes, cap, _, _ = _case(None, False)
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl))
    one = tdec.paged_decode_plain(*args, return_lse=True, logit_softcap=cap)
    many = tdec.paged_decode_plain(*args, return_lse=True, logit_softcap=cap, splits=8)
    _, _, _, ps, pps, lengths = SHAPE
    per, n = tdec.split_pages(pps, 8)
    assert n == 8 and per * ps > lengths[1]  # sequence 1 lies in split 0 alone
    for x, y in zip(one, many):
        np.testing.assert_allclose(y[1].numpy(), x[1].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The combine pass against a fold of JAX merge_partials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits", [2, 5, 9])
def test_combine_matches_a_fold_of_merge_partials(splits):
    rng = np.random.default_rng(splits)
    rows, d = 12, 64
    o = rng.standard_normal((splits, rows, d)).astype(np.float32)
    lse = (3.0 * rng.standard_normal((splits, rows))).astype(np.float32)
    # empty partials: row 0 sees split 0 only, row 1 none but the last,
    # row 2 nothing at all
    lse[1:, 0] = -np.inf
    lse[:-1, 1] = -np.inf
    lse[:, 2] = -np.inf
    o[lse == -np.inf] = np.nan  # an empty partial's O is never read
    ot, lt = tdec.combine_partials(torch.from_numpy(o), torch.from_numpy(lse))
    oj, lj = jnp.asarray(np.nan_to_num(o[0])), jnp.asarray(lse[0])
    for s in range(1, splits):
        oj, lj = merge_partials(oj, lj, jnp.asarray(np.nan_to_num(o[s])), jnp.asarray(lse[s]))
    # the fold is defined where it never merges two empty partials (JAX's
    # exp(-inf - -inf) is NaN): rows whose first split is live
    folded = np.isfinite(lse[0])
    np.testing.assert_allclose(ot.numpy()[folded], np.asarray(oj)[folded], **TOL)
    np.testing.assert_allclose(lt.numpy()[folded], np.asarray(lj)[folded], **TOL)
    for row, s in ((0, 0), (1, splits - 1)):  # one live split: itself
        np.testing.assert_array_equal(ot.numpy()[row], o[s, row])
        assert float(lt[row]) == lse[s, row]
    assert (ot[2] == 0).all() and bool(lt[2] == DEFAULT_MASK_VALUE)


# ---------------------------------------------------------------------------
# verify_route against PERF.md's route table
# ---------------------------------------------------------------------------

# PERF.md §6, the verify routes: q dtype -> pool kinds of each route.
ROUTES = {
    torch.float32: {"fp32": list(tdec.POOL_KINDS)},
    torch.bfloat16: {"wgmma": [torch.bfloat16, torch.int8, "int4", torch.float8_e4m3fn,
                               torch.float8_e5m2]},
    torch.float16: {"wgmma": [torch.float16, torch.int8, "int4", torch.float8_e4m3fn,
                              torch.float8_e5m2]},
}


@pytest.mark.parametrize("q_dtype", list(ROUTES), ids=str)
def test_verify_route_follows_the_route_table(q_dtype):
    for pool in tdec.POOL_KINDS:
        want = [r for r, pools in ROUTES[q_dtype].items() if pool in pools]
        for page, d in ((16, 64), (128, 128), (6, 128), (7, 64)):
            if pool == "int4" and page % 2:
                continue
            if want:
                assert tdec.verify_route(q_dtype, pool, page, d) == want[0]
            else:
                with pytest.raises(ValueError):
                    tdec.verify_route(q_dtype, pool, page, d)


@pytest.mark.parametrize("args", [
    (torch.bfloat16, torch.float16, 128, 128),
    (torch.float16, torch.bfloat16, 128, 128),
    (torch.bfloat16, torch.float32, 128, 128),
    (torch.bfloat16, torch.int8, 128, 96),
    (torch.float32, torch.float32, 128, 256),
    (torch.bfloat16, "int4", 7, 128),
    (torch.bfloat16, torch.int8, 0, 128),
    (torch.int8, torch.int8, 128, 128),
    (torch.bfloat16, torch.int32, 128, 128),
], ids=lambda a: "_".join(str(x).replace("torch.", "") for x in a))
def test_verify_route_refuses_what_no_kernel_takes(args):
    """What no route takes raises.  Head dim 256 takes ALiBi now (its
    route is the one it takes without), so at 256 what is refused is a pool
    head dim past the widest kernel (320)."""
    if args[3] == 256:
        assert tdec.verify_route(*args, alibi=True) == tdec.verify_route(*args) == "fp32"
        with pytest.raises(ValueError):
            tdec.verify_route(*args[:3], 320, alibi=True)
    else:
        with pytest.raises(ValueError):
            tdec.verify_route(*args)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_builds_are_looked_up_at_call_time(monkeypatch, d):
    """Decode and verify have a build for each pool head dim, found by its
    module attribute when a call is made (chip_smoke.py paged_mutants swaps
    one)."""
    suffix = "" if d == 128 else f"_d{d}"
    assert [k.symbol for k in tdec.paged_kernels(d)] == [f"paged_decode{suffix}",
                                                         f"paged_verify{suffix}"]
    stand_in = object()
    monkeypatch.setattr(tdec, f"VERIFY{suffix.upper()}_KERNEL", stand_in)
    assert tdec.paged_kernels(d)[1] is stand_in
