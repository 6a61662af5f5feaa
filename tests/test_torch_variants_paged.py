"""The decode and verify steps of every model variant against the JAX package's.

The variants of ``test_torch_variants.py`` (the same table and weights) go
through ``make_decode_step`` and ``make_verify_step`` of both packages over
the same random fp32 page pools: the port's at the kernels' head dim
(``kernel_width``: 64 for head_dim 32, 128 for 96, 256), the JAX package's
at its 128-lane width, equal in the true columns.  Logits and the pools the
steps write agree to atol 1e-4 in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from test_torch_variants import ATOL, VARIANTS, make_pair, tokens

PAGE, NUM_PAGES = 16, 6
TABLE = np.asarray([[1, 3], [2, 4]], np.int32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return make_pair(request.param)


def _pools(jcfg, tcfg, seed):
    """(JAX pools, port pools) of random fp32 values, equal in the true
    head-dim columns, zero past them."""
    rng = np.random.default_rng(seed)
    jpools = jdecoding.init_kv_pools(jcfg, num_pages=NUM_PAGES, page_size=PAGE,
                                     dtype=jnp.float32)
    tpools = tdecoding.init_kv_pools(tcfg, num_pages=NUM_PAGES, page_size=PAGE,
                                     dtype=torch.float32, device="cpu")
    d = tcfg.head_dim
    jk, jv = [], []
    for li in range(tcfg.n_layers):
        for jpool, tpool, out in ((jpools.k[li], tpools.k[li], jk), (jpools.v[li], tpools.v[li], jv)):
            x = rng.standard_normal(tpool.shape[:3] + (d,)).astype(np.float32)
            tpool[..., :d] = torch.from_numpy(x)
            out.append(jnp.asarray(np.pad(x, ((0, 0),) * 3 + ((0, jpool.shape[-1] - d),))))
    return jdecoding.KVPools(tuple(jk), tuple(jv), None, None), tpools


def _step_args(lengths, t_new):
    """tokens, positions, page rows and offsets of the last ``t_new`` tokens
    of each sequence (lengths final), the page table and the lengths."""
    lengths = np.asarray(lengths, np.int32)
    pos = lengths[:, None] - t_new + np.arange(t_new)[None]
    rows = np.take_along_axis(TABLE, pos // PAGE, axis=1).astype(np.int32)
    toks = tokens(5, len(lengths), t_new)
    return [toks, pos.astype(np.int32), rows, (pos % PAGE).astype(np.int32), TABLE, lengths]


def _check(tl, tpools, jl, jpools, tcfg):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    d = tcfg.head_dim
    for li in range(tcfg.n_layers):
        for tp, jp in ((tpools.k[li], jpools.k[li]), (tpools.v[li], jpools.v[li])):
            np.testing.assert_allclose(tp[..., :d].numpy(), np.asarray(jp)[..., :d],
                                       atol=ATOL, rtol=0)
            assert (tp[..., d:] == 0).all()


def test_decode_step_matches_jax(pair):
    jparams, jcfg, model, tcfg = pair
    jpools, tpools = _pools(jcfg, tcfg, seed=11)
    args = _step_args([11, 20], 1)
    args[:4] = [a[:, 0] for a in args[:4]]
    jl, jpools = jdecoding.make_decode_step(jcfg)(jparams, jpools,
                                                  *(jnp.asarray(a) for a in args))
    tl, tpools = tdecoding.make_decode_step(tcfg)(model, tpools,
                                                  *(torch.from_numpy(a) for a in args))
    _check(tl, tpools, jl, jpools, tcfg)


def test_verify_step_matches_jax(pair):
    jparams, jcfg, model, tcfg = pair
    jpools, tpools = _pools(jcfg, tcfg, seed=12)
    args = _step_args([12, 24], 4)
    jl, jpools = jdecoding.make_verify_step(jcfg, 4)(jparams, jpools,
                                                     *(jnp.asarray(a) for a in args))
    tl, tpools = tdecoding.make_verify_step(tcfg, 4)(model, tpools,
                                                     *(torch.from_numpy(a) for a in args))
    _check(tl, tpools, jl, jpools, tcfg)
