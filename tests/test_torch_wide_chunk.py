"""Head dims above 1024 in the PyTorch port, against the JAX package.

The JAX package pads any head dim to a multiple of 128 lanes and runs all
its kernels there; the port pads alike (``kernel_width``: 1100 to 1152) and
on the card runs the bf16 / fp16 forward, sweeps and paged verify as score
and product passes (route ``wide_scores``, ``csrc/wide_scores.cuh``,
:mod:`.wide_scores`; verify's passes in ``tests/test_torch_verify_scores.py``),
fp32 on the column-chunked kernels of ``csrc/wide.cuh`` (``wide_fp32``) and
decode on ``csrc/paged_decode_chunk.cu``.  Here,
on CPU tensors, the port runs their plain versions; the JAX side runs its
Pallas routes in interpret mode, as its own CPU tests do.  Same seeded numpy
inputs on both sides:

- the op's forward (O, lse) and dQ/dK/dV at d 1100 in fp32: causal GQA, and
  ALiBi with dropout (its mask bit for bit the JAX package's) and segment
  ids together; the passes of route ``wide_scores`` composed (their plain
  versions, wave by wave) on the same inputs, padded to 1152;
- ``paged_decode_attention`` (O, lse) and ``paged_verify_attention`` at pool
  width 1152 from int8 pools;
- the route functions, builds, tiles and shared-memory models above 1024,
  the composed passes against ``attn_fwd_plain`` / ``attn_bwd_plain`` at d
  1152, and a call in several waves bitwise equal to one wave (no JAX).

The 2-layer model at head dim 1100 runs in ``tests/test_torch_wide_heads.py``
(its ``jax_model`` fixture takes the head dim).  Tolerances are that
file's, which says where each comes from.  The two op cases' JAX calls are
compiled once each, forward and gradients under one ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
import test_torch_wide_heads as wh
from flash_attention_dlrs_tpu_torch import geometry as geo
from flash_attention_dlrs_tpu_torch import tuning
from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as tbwd
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.ops import wide_scores as tws

OP_CASES = {
    # name: (B, Hq, Hkv, N, d, kwargs, segment ids)
    "d1100_causal_gqa": (1, 4, 2, 40, 1100, dict(causal=True), False),
    "d1100_alibi_dropout_segments": (2, 4, 2, 32, 1100, dict(
        causal=True, alibi_slopes=fa.alibi_slopes_for(4), dropout_rate=0.1,
        dropout_seed=2 ** 31 - 7), True),
}


@functools.cache
def _case(name):
    """The case's numpy inputs and ids, and the JAX package's (O, lse) and
    (dQ, dK, dV) on them from one compiled call."""
    b, hq, hkv, n, d, kw, seg = OP_CASES[name]
    rng = np.random.default_rng(len(name) + d)
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    ids = wh._packed(rng, b, n) if seg else None
    jkw = dict(kw, segment_ids=None if ids is None else jnp.asarray(ids))

    @jax.jit
    def run(q_, k_, v_, do_):
        o, lse = fa.flash_attention_forward(q_, k_, v_, **jkw)
        grads = jax.vjp(functools.partial(fa.flash_attention, **jkw), q_, k_, v_)[1](do_)
        return o, lse, grads

    o, lse, grads = run(*map(jnp.asarray, (q, k, v, do)))
    return (q, k, v, do), ids, (np.asarray(o), np.asarray(lse)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_and_gradients_match_jax(name):
    (q, k, v, do), ids, (oj, lj), want = _case(name)
    kw = dict(OP_CASES[name][5], segment_ids=None if ids is None else torch.from_numpy(ids))
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    assert ot.shape == q.shape
    np.testing.assert_allclose(ot.numpy(), oj, **wh.FWD)
    np.testing.assert_allclose(lt.numpy(), lj, **wh.FWD)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for gname, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), w, atol=wh.GRAD_ATOL[gname], rtol=wh.RTOL,
                                   err_msg=gname)


def test_paged_decode_and_verify_match_jax_int8_d1152():
    """Decode (O and lse; ragged lengths with an empty one) and a 3-token
    verify from fp32 q on int8 pools of width 1152, GQA 2:1, 16-token pages,
    a shuffled table (test_torch_wide_heads.py's check at 384 and 512)."""
    wh.test_paged_decode_and_verify_match_jax(1152, "int8")


CHUNK_DIMS = (1152, 2048, 8192)


@pytest.mark.parametrize("d", CHUNK_DIMS)
def test_routes_take_the_column_chunked_kernels(d):
    """Above 1024 the bf16 / fp16 forward, sweeps and verify name route
    ``wide_scores`` (code 6) with every mode and pool kind (``wide_chunk``,
    code 5, is retired) and fp32 stays on ``wide_fp32``; the builds the
    wrappers look up are the wide ones for fp32, decode's its
    column-chunked build; the only tile is the passes' (128-key score
    tiles, 64 streamed rows); 1024 stays on the wgmma cuts."""
    for dtype, route, verify in ((torch.float32, "wide_fp32", "wide_fp32"),
                                 (torch.bfloat16, "wide_scores", "wide_scores"),
                                 (torch.float16, "wide_scores", "wide_scores")):
        tfwd.check_kernel_head_dim(d, "chunk")
        for kw in ({}, dict(segments=True), dict(alibi=True, dropout=True)):
            assert tbwd.bwd_route(dtype, d, **kw) == route
            assert tfwd.fwd_route(dtype, d, fp8_v=dtype != torch.float32, **kw) == route
        for pool in (dtype, torch.int8, "int4", torch.float8_e5m2):
            assert tdec.verify_route(dtype, pool, 16, d, alibi=True) == verify
        assert tfwd.ROUTE_CODES[verify] == tdec.VERIFY_ROUTE_CODES[verify]
        assert tfwd.fwd_route(dtype, 1024) == ("wide_fp32" if route == "wide_fp32"
                                               else "wide_wgmma")
    assert tfwd.ROUTE_CODES["wide_scores"] == tdec.VERIFY_ROUTE_CODES["wide_scores"] == 6
    assert "wide_chunk" not in tfwd.ROUTE_CODES and "wide_chunk" not in tdec.VERIFY_ROUTE_CODES
    assert 3 not in tfwd.ROUTE_CODES.values() and 5 not in tfwd.ROUTE_CODES.values()
    assert all("wide_scores" in counts for counts in tbwd.BWD_ROUTE_LAUNCHES.values())
    assert geo.chunked(d) and not geo.chunked(1024) and geo.is_wide(d)
    assert tfwd.fwd_kernel(d, True) is tfwd.FWD_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dkv", d, True) is tbwd.DKV_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dq", d, False) is tbwd.DQ_WIDE_KERNEL
    assert tdec.paged_kernels(d, torch.bfloat16) == (tdec.DECODE_CHUNK_KERNEL,
                                                    tdec.VERIFY_WIDE_KERNEL)
    assert tdec.paged_kernels(1024)[0] is tdec.DECODE_WIDE_KERNEL
    with pytest.raises(ValueError, match="wide_scores"):
        geo.wide_cut(d)
    with pytest.raises(ValueError, match="column-chunked"):
        geo.wide_bwd_cut(d, dkv=True)
    with pytest.raises(ValueError, match="column-chunked"):
        geo.wide_decode_ctas_per_sm(d)
    # the passes' one tile, in every mode; any other refused
    tile = tuning.BlockSizes(block_kv=128, block_kv_bwd=64)
    tile.check(d, alibi=True, dropout=True, segments=True, fp8_v=True)
    assert tuning.default_block_sizes(d) == tile
    for bkv, bkv_bwd in ((32, 32), (64, 64), (64, 32), (128, 32)):
        with pytest.raises(ValueError, match="wide_scores"):
            tuning.BlockSizes(block_kv=bkv, block_kv_bwd=bkv_bwd).check(d)
    assert tuning.candidate_fwd_configs(d, segments=True) == [(128, 128)]
    assert tuning.candidate_bwd_configs(d, dropout=True) == [(128, 64)]
    # verify's CTAs a split: 64-row blocks times the 128-column chunks on
    # wide_fp32; the product pass's 128-row tiles times its 256-column
    # chunks on wide_scores
    assert tdec.verify_ctas_per_split("wide_fp32", 130, d) == 3 * (d // 128)
    assert tdec.verify_ctas_per_split("wide_scores", 130, d) == 2 * -(-d // 256)


def test_no_multiple_of_128_above_256_is_refused():
    """Every multiple of 128 above 256 is a kernel width (the CPU tests and
    the card alike); anything else is padded by the entry points and refused
    by the route functions."""
    for d in range(384, 16385, 128):
        tfwd.check_kernel_head_dim(d, "any")
        assert tfwd.kernel_width(d - 100) == d
    for d in (1100, 2050, 300):
        with pytest.raises(ValueError, match="multiple of 128 above 256"):
            tfwd.fwd_route(torch.bfloat16, d)


def test_chunk_layout_fits_every_mode():
    """The column-chunked kernels' shared memory (geometry's byte model of
    csrc/wide.cuh WideLayout, fp32) is one layout whatever the head dim or
    mode (forward, verify, sweeps, segment ids), and fits the 232,448 bytes
    an H100 CTA may opt into; the chunked decode's (WdcLayout) fits too."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    n = geo.wide_chunk_smem_bytes()
    assert n <= optin and optin == 232448
    # two stages of each streamed operand (64 rows x 144 bytes), the update
    # tile (64 x 128 fp32 columns, rows padded by 16 bytes), each warp's P
    assert n == 4 * 64 * 144 + 64 * (128 * 4 + 16) + 17408 + 6 * 64 * 4 + 64 * 12
    assert geo.wide_chunk_decode_smem_bytes() <= optin


def _padded(x, width=1152):
    """A numpy input as a torch tensor zero-padded to the kernels' width, as
    the op pads it."""
    return torch.nn.functional.pad(torch.from_numpy(x), (0, width - x.shape[-1]))


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_composed_passes_match_jax(name):
    """Route ``wide_scores``' passes composed as the card runs them (a wave's
    score pass, then its product pass; the preprocess, the backward score
    pass, then the dK / dV and dQ products), on their plain versions,
    against the JAX package's forward and gradients of ``_case``: inputs
    padded to 1152, sm_scale from the true head dim."""
    (q, k, v, do), ids, (oj, lj), want = _case(name)
    d, kw = OP_CASES[name][4], dict(OP_CASES[name][5], sm_scale=OP_CASES[name][4] ** -0.5)
    if ids is not None:
        seg = torch.from_numpy(ids.astype(np.int32))
        kw.update(q_seg=seg, kv_seg=seg)
    qt, kt, vt, dot = (_padded(x) for x in (q, k, v, do))
    o, lse = tws.attn_fwd_scores(qt, kt, vt, **kw)
    np.testing.assert_allclose(o[..., :d].numpy(), oj, **wh.FWD)
    np.testing.assert_allclose(lse.numpy(), lj, **wh.FWD)
    grads = tws.attn_bwd_scores(qt, kt, vt, dot, lse, tbwd.attn_bwd_preprocess_plain(o, dot),
                                **kw)
    for gname, w in zip(("dq", "dk", "dv"), want):
        assert not grads[gname][..., d:].any(), gname  # the padding's gradient is 0
        np.testing.assert_allclose(grads[gname][..., :d].numpy(), w, atol=wh.GRAD_ATOL[gname],
                                   rtol=wh.RTOL, err_msg=gname)


SCORE_CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, kwargs, segment ids)
    "causal_gqa": (1, 4, 2, 200, 200, dict(causal=True), False),
    "noncausal_tail_softcap": (1, 2, 1, 130, 200, dict(causal=False, softcap=30.0), False),
    "window_alibi_dropout_segments": (2, 2, 1, 200, 200, dict(
        causal=True, window=100, alibi_slopes=fa.alibi_slopes_for(2), dropout_rate=0.1,
        dropout_seed=-5), True),
    "empty_rows": (1, 2, 1, 200, 130, dict(causal=True), False),
}


def _score_inputs(name, dtype=torch.float32, d=1152):
    b, hq, hkv, nq, nkv, kw, seg = SCORE_CASES[name]
    rng = np.random.default_rng(len(name))
    q, do = (torch.from_numpy(rng.standard_normal((b, hq, nq, d), dtype=np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)).to(dtype)
            for _ in range(2))
    kw = dict(kw, sm_scale=d ** -0.5)
    if seg:
        ids = torch.from_numpy(wh._packed(rng, b, nq).astype(np.int32))
        kw.update(q_seg=ids, kv_seg=ids)
    return q, k, v, do, kw


@pytest.mark.parametrize("name", sorted(SCORE_CASES))
def test_composed_passes_match_the_plain_kernels_d1152(name):
    """The composed passes in fp32 at d 1152 against ``attn_fwd_plain`` and
    ``attn_bwd_plain`` on the same inputs, every mode (GQA, ragged
    non-causal tails, softcap, window, ALiBi, dropout, segment ids, rows
    that see no key): the same function in another order of sums."""
    q, k, v, do, kw = _score_inputs(name)
    o, lse = tws.attn_fwd_scores(q, k, v, **kw)
    o_want, lse_want = tfwd.attn_fwd_plain(q, k, v, **kw)
    np.testing.assert_allclose(o.numpy(), o_want.numpy(), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), rtol=1e-5, atol=2e-5)
    grads = tws.attn_bwd_scores(q, k, v, do, lse_want, tbwd.attn_bwd_preprocess_plain(o_want, do),
                                **kw)
    want = tbwd.attn_bwd_plain(q, k, v, o_want, lse_want, do, **kw)
    for gname, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(grads[gname].numpy(), w.numpy(), rtol=1e-5, atol=5e-5,
                                   err_msg=gname)


@pytest.mark.parametrize("name", ["causal_gqa", "window_alibi_dropout_segments"])
def test_waves_are_bitwise_one_wave(name, monkeypatch):
    """A scratch cap of two q tiles' backward scratch (the forward's a little
    larger) runs the call in waves whose boundaries fall inside kv heads'
    tiles (dK / dV carried across them in fp32); every output is bitwise the
    one-wave call's (bf16 inputs, as on the card)."""
    q, k, v, do, kw = _score_inputs(name, torch.bfloat16)
    one = tws.attn_fwd_scores(q, k, v, **kw)
    delta = tbwd.attn_bwd_preprocess_plain(one[0], do)
    g_one = tws.attn_bwd_scores(q, k, v, do, one[1], delta, **kw)
    assert len(tws.waves(q, k, False)) == len(tws.waves(q, k, True)) == 1
    monkeypatch.setattr(geo, "WIDE_SCORES_SCRATCH_BYTES",
                        2 * geo.wide_scores_tile_bytes(k.shape[2], True))
    assert len(tws.waves(q, k, False)) >= 3 and len(tws.waves(q, k, True)) >= 3
    assert tws.dkv_carry(q, k, tws.waves(q, k, True))[0] is not None
    many = tws.attn_fwd_scores(q, k, v, **kw)
    assert all(torch.equal(x, y) for x, y in zip(one, many))
    g_many = tws.attn_bwd_scores(q, k, v, do, one[1], delta, **kw)
    assert all(torch.equal(g_one[x], g_many[x]) for x in ("dq", "dk", "dv"))


def test_wide_scores_layouts_and_waves():
    """Each pass of route ``wide_scores`` has one layout at every head dim
    and mode (geometry's byte model of csrc/wide_scores.cuh ScoreLayout /
    ProductLayout / VerifyProductLayout; verify's passes every pool kind
    too), inside the 232,448 bytes an H100 CTA may opt into; the
    waves cover a call's tiles in order, each within the cap unless one
    tile is past it, and the d 2048 training shape runs in one wave."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    want = {"fwd_scores": 132672, "bwd_scores": 198192, "fwd_product": 197680,
            "dq_product": 197696, "dkv_product": 197696, "verify_scores": 132672,
            "verify_product": 198448}
    assert {kind: geo.wide_scores_smem_bytes(kind) for kind in geo.WIDE_SCORES_KINDS} == want
    assert max(want.values()) <= optin
    for b, hq, n_q, n_kv, cap in ((8, 2, 2048, 2048, None), (1, 2, 300, 16384, 1 << 24),
                                  (2, 3, 1000, 700, 5 << 20), (1, 1, 130, 1 << 20, 1)):
        for bwd in (False, True):
            plan = geo.wide_scores_waves(b, hq, n_q, n_kv, bwd, cap)
            tiles = b * hq * -(-n_q // 128)
            assert plan[0][0] == 0 and plan[-1][1] == tiles
            assert all(x[1] == y[0] and x[0] < x[1] for x, y in zip(plan, plan[1:]))
            per = geo.wide_scores_tile_bytes(n_kv, bwd)
            limit = geo.WIDE_SCORES_SCRATCH_BYTES if cap is None else cap
            assert all((f1 - f0) * per <= limit or f1 - f0 == 1 for f0, f1 in plan)
    assert len(geo.wide_scores_waves(8, 2, 2048, 2048, False)) == 1
    assert len(geo.wide_scores_waves(8, 2, 2048, 2048, True)) == 1


def test_wrappers_take_the_plain_passes_on_the_cpu():
    """On CPU tensors each pass's wrapper is its plain version (no launch
    counted), and the op on route wide_scores' head dims counts no route."""
    q, k, v, do, kw = _score_inputs("causal_gqa", torch.bfloat16)
    kernels = (tws.FWD_SCORES_KERNEL, tws.FWD_PRODUCT_KERNEL, tws.BWD_SCORES_KERNEL,
               tws.DQ_PRODUCT_KERNEL, tws.DKV_PRODUCT_KERNEL)
    before = [kern.launches for kern in kernels], dict(tfwd.ROUTE_LAUNCHES)
    wave = (0, 2)
    assert all(torch.equal(x, y) for x, y in zip(tws.fwd_scores(q, k, wave, **kw),
                                                  tws.fwd_scores_plain(q, k, wave, **kw)))
    tfwd.attn_fwd(q, k, v, **kw)
    assert ([kern.launches for kern in kernels], dict(tfwd.ROUTE_LAUNCHES)) == before
