"""Head dims above 1024 in the PyTorch port, against the JAX package.

The JAX package pads any head dim to a multiple of 128 lanes and runs all
its kernels there; the port pads alike (``kernel_width``: 1100 to 1152) and
on the card runs the column-chunked kernels of ``csrc/wide.cuh`` (route
``wide_chunk`` for bf16 / fp16, ``wide_fp32`` for fp32, decode on
``csrc/paged_decode_chunk.cu``).  Here, on CPU tensors, the port runs their
plain versions; the JAX side runs its Pallas routes in interpret mode, as
its own CPU tests do.  Same seeded numpy inputs on both sides:

- the op's forward (O, lse) and dQ/dK/dV at d 1100 in fp32: causal GQA, and
  ALiBi with dropout (its mask bit for bit the JAX package's) and segment
  ids together;
- ``paged_decode_attention`` (O, lse) and ``paged_verify_attention`` at pool
  width 1152 from int8 pools;
- the route functions, builds, tiles and shared-memory models above 1024
  (no JAX).

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

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
import test_torch_wide_heads as wh
from flash_attention_dlrs_tpu_torch import geometry as geo
from flash_attention_dlrs_tpu_torch import tuning
from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as tbwd
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd

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
    """Above 1024 every route function names the column-chunked route for
    bf16 / fp16 (``wide_chunk``) and keeps fp32 on ``wide_fp32``, with every
    mode; the builds the wrappers look up are the wide ones, decode's its
    column-chunked build; the only tile is the chunked kernels' (64 keys,
    64 streamed rows); 1024 stays on the wgmma cuts."""
    for dtype, route in ((torch.float32, "wide_fp32"), (torch.bfloat16, "wide_chunk"),
                         (torch.float16, "wide_chunk")):
        tfwd.check_kernel_head_dim(d, "chunk")
        for kw in ({}, dict(segments=True), dict(alibi=True, dropout=True)):
            assert tbwd.bwd_route(dtype, d, **kw) == route
            assert tfwd.fwd_route(dtype, d, fp8_v=dtype != torch.float32, **kw) == route
        for pool in (dtype, torch.int8, "int4", torch.float8_e5m2):
            assert tdec.verify_route(dtype, pool, 16, d, alibi=True) == route
        assert tfwd.ROUTE_CODES[route] == tdec.VERIFY_ROUTE_CODES[route]
        assert tfwd.fwd_route(dtype, 1024) == ("wide_fp32" if route == "wide_fp32"
                                               else "wide_wgmma")
    assert tfwd.ROUTE_CODES["wide_chunk"] == 5 and 3 not in tfwd.ROUTE_CODES.values()
    assert geo.chunked(d) and not geo.chunked(1024) and geo.is_wide(d)
    assert tfwd.fwd_kernel(d, True) is tfwd.FWD_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dkv", d, True) is tbwd.DKV_WIDE_KERNEL
    assert tbwd.sweep_kernel("attn_bwd_dq", d, False) is tbwd.DQ_WIDE_KERNEL
    assert tdec.paged_kernels(d, torch.bfloat16) == (tdec.DECODE_CHUNK_KERNEL,
                                                    tdec.VERIFY_WIDE_KERNEL)
    assert tdec.paged_kernels(1024)[0] is tdec.DECODE_WIDE_KERNEL
    with pytest.raises(ValueError, match="column-chunked"):
        geo.wide_cut(d)
    with pytest.raises(ValueError, match="column-chunked"):
        geo.wide_bwd_cut(d, dkv=True)
    with pytest.raises(ValueError, match="column-chunked"):
        geo.wide_decode_ctas_per_sm(d)
    # the chunked kernels' one tile, in every mode; any other refused
    chunk = tuning.BlockSizes(block_kv=64, block_kv_bwd=64)
    chunk.check(d, alibi=True, dropout=True, segments=True, fp8_v=True)
    assert tuning.default_block_sizes(d) == chunk
    for bkv, bkv_bwd in ((32, 32), (128, 64), (64, 32), (32, 64)):
        with pytest.raises(ValueError, match="column-chunked"):
            tuning.BlockSizes(block_kv=bkv, block_kv_bwd=bkv_bwd).check(d)
    assert tuning.candidate_fwd_configs(d, segments=True) == [(128, 64)]
    assert tuning.candidate_bwd_configs(d, dropout=True) == [(128, 64)]
    # verify's CTAs: 64-row blocks times the 128-column chunks, as wide_fp32
    assert tdec.verify_ctas_per_split("wide_chunk", 130, d) == 3 * (d // 128)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_chunk_layout_fits_every_mode(dtype):
    """The column-chunked kernels' shared memory (geometry's byte model of
    csrc/wide.cuh WideLayout<T>) is one layout a dtype, whatever the head
    dim or mode (forward, verify, sweeps, segment ids), and fits the 232,448
    bytes an H100 CTA may opt into, four CTAs an SM in 16 bits; the chunked
    decode's (WdcLayout) fits too."""
    optin = geo.current_geometry("cpu").smem_per_block_optin
    sizes = {geo.wide_chunk_smem_bytes(dtype, paged=p, segments=s)
             for p in (False, True) for s in (False, True)}
    assert len(sizes) == 1
    n = sizes.pop()
    assert n <= optin and optin == 232448
    # two stages of each streamed operand (64 rows x 144 bytes), the update
    # tile (64 x 128 columns of dtype, rows padded by 16 bytes), fp32's P
    item = torch.empty((), dtype=dtype).element_size()
    assert n == (4 * 64 * 144 + 64 * (128 * item + 16) + (17408 if item == 4 else 0)
                 + 6 * 64 * 4 + 64 * 12)
    if item == 2:
        assert geo.fits_ctas_per_sm(n, 4)
    assert geo.wide_chunk_decode_smem_bytes() <= optin
