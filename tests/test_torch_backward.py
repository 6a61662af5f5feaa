"""The PyTorch port's attention backward (dQ, dK, dV) against the JAX package's.

Same seeded numpy inputs through the differentiable ``flash_attention`` of
both packages.  The JAX side runs its Pallas backward routes as its own
tests do on the CPU (interpret mode); the port runs the backward kernels'
plain version, which CPU tensors take.  One case per JAX backward route, so
every TPU backward kernel has its counterpart held:

- N=256 causal GQA: the one-shot ``_small_bwd_kernel`` (fwd_small.py);
- N=640 causal: the pane-resident ``_bwd_mid_kernel`` (bwd_mid.py);
- N=640 non-causal: the single-sweep ``_bwd_fused_kernel`` (bwd_fused.py);
- N=576 non-causal with the fused route ruled out: the two-sweep
  ``_bwd_d_kernel`` + ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``
  (bwd_kernel.py), forced as ``tests/test_backward.py`` forces it;
- window + softcap, Nq < Nkv (bottom-right tail), Nq > Nkv (empty rows).

Each case also asserts which JAX route function its call reached.

Tolerance: the reference's fp32 gradient ladder, dQ 9e-4 / dK 7e-4 /
dV 7e-5, rtol 1e-5 (tests/test_backward.py:25), with sm_scale = 1.0 as the
golden gradient tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.ops import bwd_fused, bwd_kernel, bwd_mid, fwd_small
from flash_attention_dlrs_tpu.ops import flash_attention_backward as jbackward
from flash_attention_dlrs_tpu.ops import flash_attention_forward as jforward
from flash_attention_dlrs_tpu.ops import reference_attention_grads as jref_grads
from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as tbwd

ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5

# The JAX route function each case must reach (module, attribute).
SMALL = (fwd_small, "bwd_small_pallas")
MID = (bwd_mid, "bwd_mid_pallas")
FUSED = (bwd_fused, "bwd_fused_pallas")
TWO_SWEEP = (bwd_kernel, "bwd_dkv_pallas")
ROUTES = (SMALL, MID, FUSED, TWO_SWEEP)

CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, route)
    "small_n256_causal_gqa": (1, 4, 2, 256, 256, 64, True, 0, 0.0, SMALL),
    "mid_n640_causal": (1, 2, 2, 640, 640, 64, True, 0, 0.0, MID),
    "fused_n640_noncausal": (1, 2, 2, 640, 640, 64, False, 0, 0.0, FUSED),
    # a shape of its own: JAX caches the traced dispatch per shape
    "two_sweep_n576_noncausal": (1, 2, 2, 576, 576, 64, False, 0, 0.0, TWO_SWEEP),
    "window_softcap_n512": (1, 2, 1, 512, 512, 64, True, 96, 25.0, MID),
    "bottom_right_tail": (1, 2, 2, 100, 300, 64, True, 0, 0.0, SMALL),
    "empty_rows": (1, 2, 2, 160, 64, 64, True, 0, 0.0, SMALL),
}


def _inputs(seed, b, hq, hkv, nq, nkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    return q, k, v, do


def _assert_ladder(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL[name],
                                   rtol=RTOL, err_msg=name)


def _jax_grads(q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


def _port_grads(q, k, v, do, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tp.flash_attention(qt, kt, vt, **kw).backward(torch.from_numpy(do))
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_route(name, monkeypatch):
    b, hq, hkv, nq, nkv, d, causal, window, cap, route = CASES[name]
    if route is TWO_SWEEP:
        monkeypatch.setattr(bwd_fused, "fused_bwd_fits_vmem", lambda *a, **k: False)
    reached = []
    for module, attr in ROUTES:
        real = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, _r=real, _n=attr, **k:
                            reached.append(_n) or _r(*a, **k))
    q, k, v, do = _inputs(len(name), b, hq, hkv, nq, nkv, d)
    kw = dict(causal=causal, sm_scale=1.0, window=window, logit_softcap=cap)
    want = _jax_grads(q, k, v, do, **kw)
    assert reached == [route[1]]
    got = _port_grads(q, k, v, do, **kw)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    _assert_ladder(got, want)


def test_empty_rows_get_zero_dq():
    q, k, v, do = _inputs(2, 1, 2, 2, 160, 64, 64)
    dq, _, _ = _port_grads(q, k, v, do, causal=True)
    assert (dq[:, :, :160 - 64] == 0).all()


def test_flash_attention_backward_honours_the_passed_lse():
    """Both packages' functional backward from the same JAX (O, lse)."""
    q, k, v, do = _inputs(31, 1, 4, 2, 384, 384, 64)
    kw = dict(causal=True, window=100, sm_scale=1.0)
    o, lse = jforward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    want = jbackward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o,
                     jnp.asarray(do), lse, **kw)
    got = tp.flash_attention_backward(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, do, lse)), **kw)
    _assert_ladder([g.numpy() for g in got], want)


def test_reference_attention_grads_match_jax():
    q, k, v, do = _inputs(5, 1, 4, 2, 96, 128, 32)
    kw = dict(causal=True, sm_scale=0.3, window=40, logit_softcap=20.0)
    want = jref_grads(*(jnp.asarray(a) for a in (q, k, v, do)), **kw)
    got = tp.reference_attention_grads(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                       **kw)
    _assert_ladder([g.numpy() for g in got], want)


def test_cpu_tensors_take_the_plain_version():
    launches = [kern.launches for kern in
                (tbwd.PREPROCESS_KERNEL, tbwd.DKV_KERNEL, tbwd.DQ_KERNEL)]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 1, 50, 70, 64))
    o, lse = tp.flash_attention_forward(q, k, v, causal=True, sm_scale=0.125)
    kw = dict(causal=True, sm_scale=0.125)
    got = tbwd.attn_bwd(q, k, v, o, lse, do, **kw)
    want = tbwd.attn_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launches == [kern.launches for kern in
                        (tbwd.PREPROCESS_KERNEL, tbwd.DKV_KERNEL, tbwd.DQ_KERNEL)]


def test_bf16_grads_keep_the_input_dtype():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(6, 1, 4, 2, 64, 64, 32))
    qt, kt, vt = (t.clone().requires_grad_(True) for t in (q, k, v))
    tp.flash_attention(qt, kt, vt, causal=True).backward(do)
    assert qt.grad.dtype == kt.grad.dtype == vt.grad.dtype == torch.bfloat16
    want = tp.reference_attention_grads(q.float(), k.float(), v.float(), do.float(),
                                        causal=True, sm_scale=32 ** -0.5)
    for a, b in zip((qt.grad, kt.grad, vt.grad), want):
        # bf16 inputs and outputs: one bf16 rounding of each gradient
        torch.testing.assert_close(a.float(), b, atol=2e-2, rtol=1e-2)


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("kwargs", [
    {"alibi_slopes": (0.5, 0.25)},
    {"dropout_rate": 0.1, "dropout_seed": 1},
    {"segment_ids": torch.zeros(1, 8, dtype=torch.int32)},
    {"rederive_stats": True},
    {"v_dtype": torch.float8_e4m3fn},
])
def test_backward_refuses_unported_features(kwargs):
    kwargs = dict(kwargs)
    v = _t((1, 2, 8, 16), kwargs.pop("v_dtype", torch.float32))
    q = k = o = do = _t((1, 2, 8, 16))
    with pytest.raises(NotImplementedError, match="not ported"):
        tp.flash_attention_backward(q, k, v, o, do, _t((1, 2, 8)), causal=True,
                                    **kwargs)


def test_backward_validates_o_do_and_lse_shapes():
    q = _t((1, 2, 8, 16))
    with pytest.raises(ValueError, match="must match q"):
        tp.flash_attention_backward(q, q, q, _t((1, 2, 7, 16)), q, _t((1, 2, 8)))
    with pytest.raises(ValueError, match="lse"):
        tp.flash_attention_backward(q, q, q, q, q, _t((1, 2, 9)))
