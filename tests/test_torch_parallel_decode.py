"""The port's head- and context-sharded paged decode against the JAX
package's (``tests/test_parallel.py``'s shapes and tolerance, atol 2e-4 /
rtol 1e-4), from fp32, int8 and int4 pools.

One group of 4 gloo ranks (``parallel/launch.py``, one thread each) runs
every case (``parallel/workloads.py decode_cases``) in the background while
the JAX sharded functions run the same numpy inputs on the first 4 of
conftest's 8 virtual CPU devices, with the same mesh.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from flash_attention_dlrs_tpu.ops.decode import quantize_kv_pages as jquant
from flash_attention_dlrs_tpu.parallel.sharded_decode import (
    context_sharded_paged_decode as jctx_decode,
    head_sharded_paged_decode as jhead_decode,
)
from flash_attention_dlrs_tpu_torch.parallel import launch as tlaunch
from flash_attention_dlrs_tpu_torch.parallel import workloads

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

OUT = dict(atol=2e-4, rtol=1e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _head_decode_inputs():
    rng = np.random.default_rng(7)
    b, hq, hkv, p, ps, d, pps = 4, 8, 4, 32, 128, 64, 4
    q, kp, vp = _arrays(7, (b, hq, d), (hkv, p, ps, d), (hkv, p, ps, d))
    table = rng.permutation(p)[: b * pps].reshape(b, pps).astype(np.int32)
    return [q, kp, vp], np.array([512, 300, 129, 1], np.int32), table


def _ctx_decode_inputs():
    n_dev, hq, hkv, d, ps, b, ppc = 4, 4, 2, 128, 128, 2, 4
    pool = n_dev * b * ppc
    q, kp, vp = _arrays(0, (b, hq, d), (hkv, pool, ps, d), (hkv, pool, ps, d))
    tok = np.zeros((b, n_dev), np.int32)
    tok[0, :] = ppc * ps
    tok[1, 0], tok[1, 1] = ppc * ps, 100  # seq 1 lives on ranks 0-1 only
    tables = np.zeros((b, n_dev, ppc), np.int32)
    for s in range(b):
        tables[s, :] = np.arange(s * ppc, (s + 1) * ppc)
    return [q, kp, vp], tok, tables


_HEAD = _head_decode_inputs()
_CTX = _ctx_decode_inputs()
DECODE_CASES = (
    [dict(name=f"head_{kind}", layout="head", axes=[2, 2], names=("data", "model"),
          kind=kind, inputs=_HEAD[0], lengths=_HEAD[1], tables=_HEAD[2])
     for kind in ("fp32", "int8", "int4")]
    + [dict(name=f"context_{kind}", layout="context", axes=[4], names=("context",),
            kind=kind, inputs=_CTX[0], lengths=_CTX[1], tables=_CTX[2])
       for kind in ("fp32", "int8", "int4")]
)


@pytest.fixture(scope="module")
def group():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(tlaunch.launch, workloads.decode_cases, 4, DECODE_CASES,
                      timeout=240, threads=1)
    pool.shutdown()


def _jmesh(axes, names):
    return JMesh(np.array(jax.devices()[:4]).reshape(axes), names)


def _jax_decode(case):
    mesh = _jmesh(case["axes"], case["names"])
    q, kp, vp = (jnp.asarray(a) for a in case["inputs"])
    kind = case["kind"]
    quantized = {"fp32": False, "int8": True, "int4": "int4"}[kind]
    if kind != "fp32":
        kp, vp = jquant(kp, *(("int4",) if kind == "int4" else ())), \
            jquant(vp, *(("int4",) if kind == "int4" else ()))
    if case["layout"] == "head":
        fn = jhead_decode(mesh, quantized=quantized)
    else:
        fn = jctx_decode(mesh, quantized=quantized)
    return fn(q, kp, vp, jnp.asarray(case["lengths"]), jnp.asarray(case["tables"]))


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c["name"] for c in DECODE_CASES])
def test_sharded_decode_matches_jax(group, case):
    want = np.asarray(_jax_decode(case))
    np.testing.assert_allclose(group.result()[0][case["name"]]["out"][0], want, **OUT)


def test_context_decode_gives_the_identity_partial_on_empty_ranks():
    """Ranks 2 and 3 hold no token of sequence 1: their partial is O = 0 and
    lse DEFAULT_MASK_VALUE, so the merge leaves the others' result alone."""
    from flash_attention_dlrs_tpu_torch.ops.decode import paged_decode_attention
    from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE

    q, kp, vp = (torch.from_numpy(a) for a in _CTX[0])
    o, lse = paged_decode_attention(q, kp, vp, torch.zeros(2, dtype=torch.int32),
                                    torch.from_numpy(_CTX[2][:, 2].copy()), return_lse=True)
    assert torch.all(o == 0) and torch.all(lse == DEFAULT_MASK_VALUE)
