"""Head dims above 256 in the PyTorch port, against the JAX package.

The JAX package pads any head dim to a multiple of 128 lanes and runs its
kernels there; the port pads alike (``kernel_width``: 320 to 384, 512 as it
is) and on the card runs the wide builds (``csrc/wide.cuh``: the 16-bit
forward, verify and sweeps on warpgroup products, route ``wide_wgmma``;
decode; ``wide_fp32``).  Here, on CPU
tensors, the port runs their plain versions; the JAX side runs its Pallas
routes in interpret mode, as its own CPU tests do.  Same seeded numpy
inputs on both sides:

- the op's forward (O, lse) and dQ/dK/dV at d 320 and 512, one case for
  each of ALiBi, dropout (its mask bit for bit the JAX package's), segment
  ids, the window and the softcap, and the plain causal case (with
  ``nn.dot_product_attention`` over the same op); fp8 V in the forward;
- ``paged_decode_attention`` (O, lse) and ``paged_verify_attention`` at
  pool widths 384 (bf16, int4 pools) and 512 (int8, e4m3 pools);
- the route functions at 384, 512 and 640 (the wide routes, the wide
  builds), the column-chunked route at 1152 and a refusal of a head dim
  that is no kernel width; the shared-memory
  models of the wide_wgmma forward and of both 16-bit sweeps in every mode
  at every wide head dim, decode's for every pool kind (two CTAs an SM up
  to 512 columns), the counters a split decode call gets at d 512 as at
  d 256, and verify's split planner for its CTAs (no JAX);
- a 2-layer model at head_dim 320 and at 1100 (above the wgmma cuts; the
  ``jax_model`` fixture takes the head dim): ``DecodeEngine`` greedy tokens
  equal to the JAX engine's, and one AdamW train step against JAX's.

Tolerances: forward atol 1e-4 / rtol 1e-5 (tests/test_forward.py:21);
gradients dQ 9e-4 / dK 7e-4 / dV 7e-5, rtol 1e-5 (tests/test_backward.py:25);
bf16 q/k with fp8 V 2e-2 (tests/test_forward.py:530-544); paged fp32 q on
quantized pools atol / rtol 1e-5 (tests/test_torch_decode.py), bf16 q on
bf16 pools a bf16 unit (atol 2^-8, rtol 2^-7); the model's loss 1e-5 and
its trained weights ADAM_ATOL 3e-5 (tests/test_torch_train.py says why)
but for at most one weight in 10^4, none past 2 lr: Adam's first update
moves a weight by about lr·sign(g), so a weight whose gradient is
summation noise lands up to 2 lr apart in two right runs
(tests/test_torch_parallel_models.py, tests/test_torch_optim.py).
The JAX runs are shared in module fixtures, and each JAX op call runs
under one ``jax.jit`` (one compile, where eager dispatch compiles each
operation of its wrapper apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch import geometry as geo
from flash_attention_dlrs_tpu_torch import nn as tnn
from flash_attention_dlrs_tpu_torch import tuning
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import (
    init_params_numpy, make_train_state, make_train_step, params_from_jax, params_to_numpy,
)
from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as tbwd
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

FWD = dict(atol=1e-4, rtol=1e-5)
GRAD_ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5
FP8_TOL = dict(atol=2e-2, rtol=2e-2)
QUANT_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -8, rtol=2 ** -7)
MODEL_ATOL, ADAM_ATOL = 1e-5, 3e-5


def _packed(rng, b, n, max_segs=4):
    """Each row split at max_segs - 1 random boundaries into documents 0, 1,
    ... (tests/test_forward.py:200-210)."""
    ids = np.zeros((b, n), np.int32)
    for row in ids:
        for bound in np.sort(rng.integers(1, n, max_segs - 1)):
            row[bound:] += 1
    return ids


OP_CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, kwargs, segment ids: None or "packed")
    "d320_plain_only": (1, 2, 1, 40, 40, 320, dict(causal=True, logit_softcap=2.0), None),
    "d320_alibi_gqa": (1, 4, 2, 40, 40, 320, dict(
        causal=True, alibi_slopes=fa.alibi_slopes_for(4)), None),
    "d512_dropout_cross": (1, 2, 1, 24, 40, 512, dict(
        causal=True, dropout_rate=0.1, dropout_seed=2 ** 31 - 3), None),
    "d320_segments_packed": (2, 2, 1, 32, 32, 320, dict(causal=True), "packed"),
    "d512_window_gqa": (1, 4, 2, 40, 40, 512, dict(causal=True, window=20), None),
    "d512_softcap_noncausal": (1, 2, 1, 32, 32, 512, dict(causal=False, logit_softcap=5.0),
                               None),
}


@functools.cache
def _case(name):
    """The case's numpy inputs and ids, and the JAX package's (O, lse) and
    (dQ, dK, dV) on them."""
    b, hq, hkv, nq, nkv, d, kw, seg = OP_CASES[name]
    rng = np.random.default_rng(len(name) + d)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    ids = _packed(rng, b, nq) if seg else None
    jkw = dict(kw, segment_ids=None if ids is None else jnp.asarray(ids))

    @jax.jit  # one compile for the forward and the gradients
    def run(q_, k_, v_, do_):
        o, lse = fa.flash_attention_forward(q_, k_, v_, **jkw)
        grads = jax.vjp(functools.partial(fa.flash_attention, **jkw), q_, k_, v_)[1](do_)
        return o, lse, grads

    o, lse, grads = run(*map(jnp.asarray, (q, k, v, do)))
    return (q, k, v, do), ids, (np.asarray(o), np.asarray(lse)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_and_gradients_match_jax(name):
    (q, k, v, do), ids, (oj, lj), want = _case(name)
    kw = dict(OP_CASES[name][6], segment_ids=None if ids is None else torch.from_numpy(ids))
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(ot.numpy(), oj, **FWD)
    np.testing.assert_allclose(lt.numpy(), lj, **FWD)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for gname, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL[gname], rtol=RTOL,
                                   err_msg=gname)
    if name == "d320_plain_only":  # the jax.nn drop-in over the same op, BTNH
        got = tnn.dot_product_attention(
            *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)), is_causal=True)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   tp.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                                      causal=True).numpy(), **FWD)


def test_fp8_v_forward_matches_jax():
    """bf16 q/k with e4m3 V at d 512 (the two packages' fp8 roundings of V
    checked equal), causal, GQA 2:1."""
    rng = np.random.default_rng(82)
    q = rng.standard_normal((1, 4, 64, 512), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, 64, 512), dtype=np.float32) for _ in range(2))
    vj = jnp.asarray(v).astype(jnp.float8_e4m3fn)
    vt = torch.from_numpy(v).to(torch.float8_e4m3fn)
    assert np.array_equal(np.asarray(vj.astype(jnp.float32)), vt.float().numpy())
    oj = fa.flash_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), vj,
                            causal=True)
    ot = tp.flash_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                            vt, causal=True)
    assert ot.dtype == torch.bfloat16 and ot.shape == (1, 4, 64, 512)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32), **FP8_TOL)


# ---------------------------------------------------------------------------
# Paged decode and verify at pool widths 384 and 512
# ---------------------------------------------------------------------------

KINDS = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("d,kind", [(384, "bf16"), (384, "int4"), (512, "int8"),
                                    (512, "e4m3")])
def test_paged_decode_and_verify_match_jax(d, kind):
    """Decode (O and lse; ragged lengths with an empty one, softcap on int4)
    and a 3-token verify (rows that see nothing compared with 0 only), GQA
    2:1, 16-token pages, a shuffled table.  bf16 q pre-scaled in bf16 (the
    JAX kernel) or not (the port's value-pool decode, the oracle's
    arithmetic) moves the lse by about a bf16 unit too."""
    b, hq, hkv, ps, pps, t_new = 2, 4, 2, 16, 2, 3
    lengths = np.asarray([0, 29], np.int32)
    rng = np.random.default_rng(d + len(kind))
    num_pages = b * pps + 2
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    qv = rng.standard_normal((b, hq, t_new, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32) for _ in range(2))
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    cap = 30.0 if kind == "int4" else 0.0
    if kind == "bf16":
        jq, jqv = jnp.asarray(q, jnp.bfloat16), jnp.asarray(qv, jnp.bfloat16)
        tq, tqv = torch.from_numpy(q).bfloat16(), torch.from_numpy(qv).bfloat16()
        jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        tk, tv = torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()
        tol = BF16_TOL
    else:
        jq, jqv = jnp.asarray(q), jnp.asarray(qv)
        tq, tqv = torch.from_numpy(q), torch.from_numpy(qv)
        jd, td = KINDS[kind]
        jk, jv = (jdec.quantize_kv_pages(jnp.asarray(a), jd) for a in (kp, vp))
        tk, tv = (tdec.quantize_kv_pages(torch.from_numpy(a), td) for a in (kp, vp))
        tol = QUANT_TOL
    lens_j, tbl_j = jnp.asarray(lengths), jnp.asarray(tbl)
    lens_t, tbl_t = torch.from_numpy(lengths), torch.from_numpy(tbl)
    oj, lj = jax.jit(functools.partial(jdec.paged_decode_attention, return_lse=True,
                                       logit_softcap=cap))(jq, jk, jv, lens_j, tbl_j)
    ot, lt = tdec.paged_decode_attention(tq, tk, tv, lens_t, tbl_t, return_lse=True,
                                         logit_softcap=cap)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32), **tol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    oj = np.asarray(jax.jit(functools.partial(jdec.paged_verify_attention,
                                              logit_softcap=cap))(jqv, jk, jv, lens_j, tbl_j),
                    np.float32)
    ot = tdec.paged_verify_attention(tqv, tk, tv, lens_t, tbl_t,
                                     logit_softcap=cap).float().numpy()
    seen = ((lengths[:, None] - (t_new - 1) + np.arange(t_new)[None, :]) > 0)[:, None, :, None]
    np.testing.assert_allclose(np.where(seen, ot, 0), np.where(seen, oj, 0), **tol)
    assert (np.where(seen, 0, ot) == 0).all()


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [384, 512, 640])
def test_routes_take_the_wide_builds(d):
    """Every route function names its wide route at d, with every mode, and
    the builds the wrappers look up are the wide ones; CPU calls at d count
    no launch; the tiles a caller may pin at d are the wide build's own."""
    for dtype, fwd, bwd in ((torch.float32, "wide_fp32", "wide_fp32"),
                            (torch.bfloat16, "wide_wgmma", "wide_wgmma"),
                            (torch.float16, "wide_wgmma", "wide_wgmma")):
        tfwd.check_kernel_head_dim(d, "wide")
        for kw in ({}, dict(segments=True), dict(alibi=True, dropout=True)):
            assert tbwd.bwd_route(dtype, d, **kw) == bwd
            assert tfwd.fwd_route(dtype, d, fp8_v=dtype != torch.float32, **kw) == fwd
        for pool in (dtype, torch.int8, "int4", torch.float8_e4m3fn):
            assert tdec.verify_route(dtype, pool, 16, d, alibi=True) == fwd
        assert fwd in tfwd.ROUTE_CODES and fwd in tdec.VERIFY_ROUTE_CODES
        assert bwd in tfwd.ROUTE_CODES
    assert tfwd.fwd_kernel(d, True) is tfwd.FWD_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dkv", d, False) is tbwd.DKV_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dq", d, True) is tbwd.DQ_WIDE_KERNEL
    assert tdec.paged_kernels(d, torch.float16) == (tdec.DECODE_WIDE_KERNEL,
                                                   tdec.VERIFY_WIDE_KERNEL)
    before = (dict(tfwd.ROUTE_LAUNCHES), tfwd.FWD_WIDE_KERNEL.launches)
    q = torch.zeros(1, 2, 8, d)
    tfwd.attn_fwd(q, q, q, causal=True, sm_scale=0.1)
    assert (dict(tfwd.ROUTE_LAUNCHES), tfwd.FWD_WIDE_KERNEL.launches) == before
    assert tfwd.fwd_route(torch.bfloat16, 1152) == "wide_scores"
    with pytest.raises(ValueError, match="multiple of 128 above 256"):
        tfwd.fwd_route(torch.bfloat16, 1100)
    # the wide build's own tile is its only one, in every mode
    tuning.BlockSizes(block_kv=32, block_kv_bwd=32).check(d, alibi=True, segments=True)
    with pytest.raises(ValueError, match="wide build"):
        tuning.BlockSizes().check(d)
    with pytest.raises(ValueError, match="wide build"):
        tuning.BlockSizes(block_kv=32, block_kv_bwd=64).check(d)
    assert tuning.default_block_sizes(d) == tuning.BlockSizes(block_kv=32, block_kv_bwd=32)


WIDE_DIMS = (384, 512, 640, 768, 896, 1024)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_wgmma_layout_fits_every_mode(d):
    """The wide_wgmma kernel's shared memory (geometry's byte model of
    csrc/wide.cuh WgLayout) fits the 232,448 bytes an H100 CTA may opt into
    at every wide head dim, for both 16-bit dtypes (one layout), with and
    without segment ids, with fp8 V (no bytes of its own) and in verify;
    the cut covers the head dim with owners of at most 256 columns and CTAs
    of at most 512, and the ring has at least two stages."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    nc, nw, c = geo.wide_cut(d)
    assert nc * nw * c * 64 == d and c * 64 <= 256 and nw * c * 64 <= 512 and nc <= 8
    stages = geo.wide_fwd_stages(d)
    assert 2 <= stages <= 4
    sizes = {}
    for segments, paged in ((False, False), (True, False), (False, True)):
        n = geo.wide_fwd_smem_bytes(d, segments=segments, paged=paged)
        assert geo.fits_smem(n), (segments, paged, n)
        sizes[segments, paged] = n
    # segment ids take one int a key of each stage, verify two scales a key
    # of each stage (fp8 V none: it is converted from device memory)
    assert sizes[True, False] - sizes[False, False] == stages * 32 * 4
    assert sizes[False, True] - sizes[False, False] == stages * 2 * 32 * 4
    # one more stage would not fit, unless the ring has its four
    assert stages == 4 or geo._wide_fwd_bytes(d, stages + 1, False, True) > optin


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_sweep_layouts_fit_every_mode(d):
    """Each 16-bit wide sweep's shared memory (geometry's byte model of
    csrc/wide.cuh WbLayout) fits the 232,448 bytes an H100 CTA may opt
    into at every wide head dim, with and without segment ids (ALiBi and
    dropout take no bytes), for dK/dV and dQ; each cut covers the head dim
    with owners of 128 columns for dK/dV (dK and dV: 128 fp32 registers a
    thread) and of at most 256 for dQ, at most two a CTA and at most 8 CTAs
    a cluster, and the ring has at least two stages."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    for dkv in (True, False):
        nc, nw, c = geo.wide_bwd_cut(d, dkv)
        assert nc * nw * c * 64 == d and nw <= 2 and nc <= 8
        assert c * 64 == 128 if dkv else c * 64 in (128, 256)
        stages = geo.wide_bwd_stages(d, dkv)
        assert 2 <= stages <= 4
        plain = geo.wide_bwd_smem_bytes(d, dkv=dkv)
        seg = geo.wide_bwd_smem_bytes(d, segments=True, dkv=dkv)
        assert geo.fits_smem(plain) and geo.fits_smem(seg), (dkv, plain, seg)
        # segment ids take one int a streamed row of each stage
        assert seg - plain == stages * 32 * 4
        assert stages == 4 or geo._wide_bwd_bytes(d, stages + 1, True, dkv) > optin
        # the CTA holds every owner's partial S and dP (64 x 32 fp32 each)
        cols = 64 * nw * c
        assert plain == (2 * 64 * cols * 2 + 2 * stages * 32 * cols * 2 + nc * nw * 16384
                         + stages * (2 if dkv else 0) * 32 * 4 + 8 * (3 + 2 * stages) + 1024)


@pytest.mark.parametrize("d", [384, 512, 640, 1024])
@pytest.mark.parametrize("tokens,page_size,pps", [(256, 128, 17), (4, 16, 136), (64, 128, 3),
                                                  (1, 64, 40)])
def test_verify_split_planner_wide_cta_shape(d, tokens, page_size, pps):
    """verify_splits on the wide_wgmma route counts the kernel's CTAs (a
    cluster of wide_cut's CTAs per 64-row block of the T x G rows), stays
    within VERIFY_MAX_SPLITS and cuts the table into whole pages that cover
    it; the fp32 route does not split."""
    b, hq, hkv = 2, 4, 2
    rows = tokens * (hq // hkv)
    ctas = tdec.verify_ctas_per_split("wide_wgmma", rows, d)
    assert ctas == -(-rows // 64) * geo.wide_cut(d)[0]
    assert tdec.verify_ctas_per_split("wide_fp32", rows, d) == -(-rows // 64) * (d // 128)
    for route in ("wide_wgmma", "wide_fp32"):
        splits = tdec.verify_splits(route, b, hq, hkv, tokens, d, pps, page_size, 132)
        assert 1 <= splits <= min(tdec.VERIFY_MAX_SPLITS, pps)
        per, count = tdec.split_pages(pps, splits)
        assert count == splits and per * splits >= pps and per * (splits - 1) < pps
        # the planner's own cut: two CTAs an SM of half the SMs
        want = tdec.decode_splits(b * tdec.verify_ctas_per_split(route, rows, d), hkv, pps,
                                  page_size, 66)
        assert splits == tdec.split_pages(pps, min(want, tdec.VERIFY_MAX_SPLITS))[1]
    assert tdec.verify_splits("fp32", b, hq, hkv, tokens, d, pps, page_size, 132) == 1


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_decode_layout_fits_every_kind(d):
    """The wide decode kernel's shared memory (geometry's byte model of
    csrc/wide.cuh WdLayout) fits the 232,448 bytes an H100 CTA may opt into
    for every pool kind at every wide head dim, and two CTAs share an SM up
    to 512 columns, as the design promises for 16-bit and 1-byte pools (and
    fp32 too); a tile holds 32 bytes a column of K and of V (8 for fp8),
    quantized pools add two fp32 scales a token, the ring has 2-8 stages,
    as many as a budget of 96 KB (two CTAs) or 192 KB (one) takes; the 8
    warps' O of both heads fits over the stages at the end."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    ctas = geo.wide_decode_ctas_per_sm(d)
    assert ctas == (2 if d <= 512 else 1)
    elem = {"fp32": 4, "bf16": 2, "fp16": 2, "int8": 1, "int4": 1, "e4m3": 1, "e5m2": 1}
    for code, kind in enumerate(geo.POOL_KIND_NAMES):
        n = geo.wide_decode_smem_bytes(d, kind)
        assert n == geo.wide_decode_smem_bytes(d, code) <= optin, (kind, n)
        assert geo.fits_ctas_per_sm(n, ctas), (kind, n, ctas)
        rows, stages = geo.wide_decode_tile(kind), geo.wide_decode_stages(d, kind)
        assert rows * elem[kind] == (8 if kind in ("e4m3", "e5m2") else 32)
        assert 2 <= stages <= 8 and rows % 8 == 0  # whole rows for each of 8 warps
        tokens = {"int8": 1, "e4m3": 1, "e5m2": 1, "int4": 2}.get(kind, 0)
        assert n - geo._wide_decode_bytes(d, "bf16", stages) == (
            2 * stages * (rows * elem[kind] - 32) * d + stages * 2 * tokens * rows * 4)
        # stages to the budget: 96 KB each of two CTAs, 192 KB for one
        stage = 2 * rows * elem[kind] * d
        assert stages == 8 or (stages + 1) * stage > 2 ** 10 * 192 // ctas, (kind, stages)
        assert 8 * 2 * d * 4 <= 2 * stages * rows * elem[kind] * d
    with pytest.raises(ValueError):
        geo.wide_decode_smem_bytes(d, "int2")


@pytest.mark.parametrize("d", [256, 512])
def test_wide_decode_gets_counter_groups(d, monkeypatch):
    """Decode merges its key splits inside the launch at every pool head dim:
    the wrapper of a split call (here on meta tensors, its launch cut short
    where it asks for scratch) gets one counter for each (sequence, kv
    head, pair of q heads) at d 512 as at d 256, from decode_groups."""
    b, hq, hkv, ps, pps = 3, 6, 2, 16, 4
    assert tdec.decode_groups(b, hq, hkv) == b * hkv * 2  # GQA 3: a pair, a lone head
    assert tdec.decode_groups(8, 4, 2) == 16  # serving-d512: one pair a kv head
    assert tdec.decode_groups(8, 16, 8) == 64 and tdec.decode_groups(2, 4, 4) == 8
    asked = []

    def scratch(splits, rows, head_dim, groups, device, stream, always=False):
        asked.append((splits, rows, head_dim, groups, always))
        raise InterruptedError

    monkeypatch.setattr(tdec, "_split_scratch", scratch)
    monkeypatch.setattr(tdec, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    meta = dict(device="meta")
    q = torch.empty(b, hq, d, dtype=torch.bfloat16, **meta)
    pool = torch.empty(hkv, b * pps, ps, d, dtype=torch.bfloat16, **meta)
    lengths = torch.empty(b, dtype=torch.int32, **meta)
    table = torch.empty(b, pps, dtype=torch.int32, **meta)
    with pytest.raises(InterruptedError):
        tdec.paged_decode_attention(q, pool, pool, lengths, table, pages_per_block=1)
    assert asked == [(pps, b * hq, d, tdec.decode_groups(b, hq, hkv), False)]


# ---------------------------------------------------------------------------
# A 2-layer model at head_dim 320 and 1100 (padded to 1152, column-chunked
# on the card): serving and one train step
# ---------------------------------------------------------------------------

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_q_heads=2, n_kv_heads=1,
             head_dim=320, d_ff=128)
MODEL_HEAD_DIMS = (320, 1100)
PROMPTS = [[5, 7, 11, 13, 17, 19], [3, 1, 4, 1, 5, 9]]
ENGINE = dict(num_slots=2, num_pages=6, page_size=16, pages_per_seq=2)
NEW_TOKENS = 3
LR = 3e-4


def _tokens(seed, b=2, n=17):
    return np.random.default_rng(seed).integers(0, MODEL["vocab_size"], (b, n)).astype(
        np.int32)


@pytest.fixture(scope="module", params=MODEL_HEAD_DIMS)
def jax_model(request):
    """At each head dim of MODEL_HEAD_DIMS: the model's fields, seeded numpy
    weights, the JAX engine's greedy tokens on them and one JAX AdamW step
    (its loss and the weights after it)."""
    fields = dict(MODEL, head_dim=request.param)
    jcfg = JConfig(**fields, dtype=jnp.float32, remat=False)
    tree = init_params_numpy(TConfig(**fields, dtype=torch.float32), seed=3)
    jparams = jax.tree.map(jnp.asarray, tree)
    greedy = JEngine(jparams, jcfg, kv_dtype=jnp.float32, **ENGINE).generate(
        PROMPTS, max_new_tokens=NEW_TOKENS)
    opt = optax.adamw(LR, weight_decay=0.01)
    params, state, loss = jstep(jcfg, opt)(jparams, opt.init(jparams), jnp.asarray(_tokens(1)))
    return dict(fields=fields, tree=tree, greedy=greedy, loss=float(loss), params=params)


def test_head_dim_320_engine_tokens_match_jax(jax_model):
    tcfg = TConfig(**jax_model["fields"], dtype=torch.float32, remat=False)
    model = params_from_jax(jax_model["tree"], tcfg, device="cpu")
    engine = TEngine(model, tcfg, kv_dtype=torch.float32, device="cpu", **ENGINE)
    assert engine.generate(PROMPTS, max_new_tokens=NEW_TOKENS) == jax_model["greedy"]


def test_head_dim_320_train_step_matches_jax(jax_model):
    tcfg = TConfig(**jax_model["fields"], dtype=torch.float32, remat=True)
    model, opt_state, optimizer = make_train_state(tcfg, params=jax_model["tree"],
                                                   device="cpu")
    loss = make_train_step(tcfg, optimizer)(model, opt_state, torch.from_numpy(_tokens(1)))
    assert abs(float(loss) - jax_model["loss"]) <= MODEL_ATOL
    got, want = params_to_numpy(model), jax_model["params"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel()
                           for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    limit = np.concatenate([(ADAM_ATOL + 1e-5 * np.abs(np.asarray(b))).ravel()
                            for b in jax.tree.leaves(want)])
    assert (diff > limit).sum() <= max(1, diff.size // 10 ** 4)
    assert diff.max() <= 2 * LR
