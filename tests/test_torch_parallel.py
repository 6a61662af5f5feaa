"""The port's sharded attention against the JAX package's.

One group of 4 gloo ranks (``parallel/launch.py``, one thread each) runs
every case in a module fixture (``parallel/workloads.py``); the JAX sharded
functions run the same inputs, made with numpy from a seed, on the first 4
of conftest's 8 virtual CPU devices, with the same mesh.  The port's ranks
run the kernels' plain versions.  Tolerances are ``tests/test_parallel.py``'s:
outputs atol 2e-4 / rtol 1e-4; ring gradients 2e-3, 2e-3, 2e-4 (dQ, dK,
dV) / rtol 1e-4; zigzag gradients 5e-4 / 1e-3.  Dropout folds the same
sub-seeds on both sides, so its masks are bit-identical and the dropout
cases are held at the same tolerances.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from jax.sharding import Mesh as JMesh

from flash_attention_dlrs_tpu.parallel import sharded_attention as jsharded
from flash_attention_dlrs_tpu_torch.parallel import launch as tlaunch
from flash_attention_dlrs_tpu_torch.parallel import workloads

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

OUT = dict(atol=2e-4, rtol=1e-4)
RING_GRADS = [dict(atol=2e-3, rtol=1e-4), dict(atol=2e-3, rtol=1e-4), dict(atol=2e-4, rtol=1e-4)]
ZZ_GRADS = [dict(atol=5e-4, rtol=1e-3)] * 3


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _qkvd(seed, b, h, n, d=64, hkv=None):
    hkv = hkv or h
    return _arrays(seed, (b, h, n, d), (b, hkv, n, d), (b, hkv, n, d), (b, h, n, d))


CTX = (None, None, "context", None)
CASES = [
    dict(name="ring_causal", strategy="ring", axes=[1, 4], names=("data", "context"),
         kw=dict(causal=True, sm_scale=1.0, model_axis=None), inputs=_qkvd(2, 2, 2, 512),
         q_spec=CTX, kv_spec=CTX, grads=True),
    dict(name="ring_noncausal", strategy="ring", axes=[1, 4], names=("data", "context"),
         kw=dict(causal=False, sm_scale=1.0, model_axis=None), inputs=_qkvd(6, 2, 2, 512),
         q_spec=CTX, kv_spec=CTX, grads=True),
    dict(name="ring_2d", strategy="ring", axes=[1, 2, 2], names=("data", "model", "context"),
         kw=dict(causal=True, sm_scale=1.0, model_axis="model"), inputs=_qkvd(3, 1, 4, 256)[:3],
         q_spec=("data", "model", "context", None), kv_spec=("data", "model", "context", None)),
    dict(name="zigzag", strategy="zigzag", axes=[1, 4], names=("data", "context"),
         kw=dict(sm_scale=1.0, model_axis=None), inputs=_qkvd(13, 2, 2, 1024),
         q_spec=CTX, kv_spec=CTX, zigzag=True, grads=True),
    dict(name="combine", strategy="combine", axes=[1, 4], names=("data", "context"),
         kw=dict(sm_scale=1.0), inputs=_qkvd(4, 2, 2, 512)[:3],
         q_spec=("data", None, None, None), kv_spec=("data", None, "context", None)),
    dict(name="head", strategy="head", axes=[2, 2], names=("data", "model"),
         kw=dict(causal=True, sm_scale=1.0), inputs=_qkvd(1, 2, 8, 128, hkv=4)[:3],
         q_spec=("data", "model", None, None), kv_spec=("data", "model", None, None)),
    dict(name="data", strategy="data", axes=[4], names=("data",),
         kw=dict(causal=True, sm_scale=1.0), inputs=_qkvd(5, 4, 2, 128)[:3],
         q_spec=("data", None, None, None), kv_spec=("data", None, None, None)),
    dict(name="ring_dropout_causal", strategy="ring", axes=[2, 2], names=("data", "context"),
         kw=dict(causal=True, sm_scale=1.0, model_axis=None, dropout_rate=0.3), seed=11,
         inputs=_qkvd(8, 2, 2, 256), q_spec=("data", None, "context", None),
         kv_spec=("data", None, "context", None), grads=True),
    dict(name="ring_dropout_noncausal", strategy="ring", axes=[2, 2], names=("data", "context"),
         kw=dict(causal=False, sm_scale=1.0, model_axis=None, dropout_rate=0.3), seed=11,
         inputs=_qkvd(8, 2, 2, 256), q_spec=("data", None, "context", None),
         kv_spec=("data", None, "context", None), grads=True),
    dict(name="zigzag_dropout", strategy="zigzag", axes=[2, 2], names=("data", "context"),
         kw=dict(sm_scale=1.0, model_axis=None, dropout_rate=0.2), seed=123,
         inputs=_qkvd(14, 2, 2, 256), q_spec=("data", None, "context", None),
         kv_spec=("data", None, "context", None), zigzag=True, repeat=True),
    dict(name="combine_dropout", strategy="combine", axes=[2, 2], names=("data", "context"),
         kw=dict(sm_scale=1.0, dropout_rate=0.25), seed=5, inputs=_qkvd(9, 2, 2, 256)[:3],
         q_spec=("data", None, None, None), kv_spec=("data", None, "context", None)),
]


@pytest.fixture(scope="module")
def group():
    """The port's group, started in the background so that the JAX side
    computes meanwhile; ``port`` waits for it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(tlaunch.launch, workloads.attention_cases, 4, CASES,
                      timeout=240, threads=1)
    pool.shutdown()


@pytest.fixture
def port(group):
    return group.result()


def _jmesh(axes, names):
    return JMesh(np.array(jax.devices()[:4]).reshape(axes), names)


def _jax_case(case):
    mesh = _jmesh(case["axes"], case["names"])
    kw = dict(case["kw"])
    fn = jsharded(mesh, case["strategy"], **kw)
    q, k, v = (jnp.asarray(a) for a in case["inputs"][:3])
    extra = () if case.get("seed") is None else (jnp.int32(case["seed"]),)
    if not case.get("grads"):
        return [fn(q, k, v, *extra)]
    o, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, *extra), q, k, v)
    return [o, *vjp(jnp.asarray(case["inputs"][3]))]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_attention_matches_jax(group, case):
    want = _jax_case(case)
    got = group.result()[0][case["name"]]["out"]
    grad_tols = ZZ_GRADS if case["strategy"] == "zigzag" else RING_GRADS
    for i, (g, w) in enumerate(zip(got, want)):
        tol = OUT if i == 0 else grad_tols[i - 1]
        np.testing.assert_allclose(g, np.asarray(w), **tol, err_msg=f"{case['name']}[{i}]")
    assert len(got) == len(want)


def test_zigzag_dropout_replays_bitwise(port):
    rec = port[0]["zigzag_dropout"]
    assert rec["bitwise"] and rec["finite"]


def test_every_rank_gathers_the_same_output(port):
    for name in ("ring_causal", "zigzag", "combine"):
        outs = [r[name]["out"][0] for r in port]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
