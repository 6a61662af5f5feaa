"""The port's ``nn.dot_product_attention`` against ``jax.nn``'s and the JAX
package's adapter.

One case for each case of tests/test_nn.py: the same seeded numpy inputs
through the port's adapter (BTNH torch tensors), through
``jax.nn.dot_product_attention`` and through
``flash_attention_dlrs_tpu.nn.dot_product_attention`` (which runs the JAX
kernels in interpret mode on the CPU).  TOL is tests/test_nn.py's, 2e-5 in
fp32; gradients at 1e-4 as there.  Kernel-routed calls run the forward
kernel's plain version here (CPU tensors); deferred calls run the port's
plain ``jax.nn`` semantics and reach no kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu import nn as jnn_adapter
from flash_attention_dlrs_tpu_torch import nn as tnn

TOL = dict(atol=2e-5, rtol=2e-5)


def _mk(b, t, s, n, k, h, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, n, h), dtype=np.float32),
            rng.standard_normal((b, s, k, h), dtype=np.float32),
            rng.standard_normal((b, s, k, h), dtype=np.float32))


def _all_three(q, k, v, *args, **kw):
    """(port, jax.nn, JAX adapter) outputs as numpy arrays."""
    targs = [None if a is None else torch.from_numpy(np.asarray(a)) for a in args]
    tkw = {key: torch.from_numpy(np.asarray(val)) if key.endswith("lengths") else val
           for key, val in kw.items()}
    ours = tnn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), *targs, **tkw)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jkw = {key: jnp.asarray(val) if key.endswith("lengths") else val
           for key, val in kw.items()}
    ref = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)), *jargs, **jkw)
    adapter = jnn_adapter.dot_product_attention(*map(jnp.asarray, (q, k, v)), *jargs, **jkw)
    return ours.numpy(), np.asarray(ref), np.asarray(adapter)


def _check(q, k, v, *args, **kw):
    ours, ref, adapter = _all_three(q, k, v, *args, **kw)
    assert ours.shape == ref.shape == adapter.shape
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, adapter, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_self_attention(causal):
    _check(*_mk(2, 256, 256, 4, 4, 64), is_causal=causal)


def test_cross_length_non_causal():
    _check(*_mk(2, 128, 256, 4, 4, 64))


@pytest.mark.parametrize("window", [64, (64, 0), (64, 7)])
def test_causal_local_window(window):
    _check(*_mk(1, 256, 256, 4, 4, 64), is_causal=True, local_window_size=window)


def test_gqa_and_scale():
    _check(*_mk(2, 256, 256, 8, 2, 64), is_causal=True, scale=0.25)


def test_seq_lengths_padding_mask():
    q, k, v = _mk(2, 256, 256, 4, 4, 64)
    qlen, kvlen = np.array([200, 256], np.int32), np.array([130, 250], np.int32)
    ours, ref, adapter = _all_three(q, k, v, is_causal=True, query_seq_lengths=qlen,
                                    key_value_seq_lengths=kvlen)
    for i in range(2):
        np.testing.assert_allclose(ours[i, :qlen[i]], ref[i, :qlen[i]], **TOL)
    np.testing.assert_allclose(ours, adapter, **TOL)
    assert (ours[0, qlen[0]:] == 0).all()  # padded query rows are exactly zero


def test_unbatched_tnh():
    q, k, v = (x[0] for x in _mk(1, 256, 256, 4, 4, 64))
    ours, ref, adapter = _all_three(q, k, v, is_causal=True)
    assert ours.shape == ref.shape == adapter.shape == (256, 4, 64)
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, adapter, **TOL)


def test_grads_flow_through_kernel_path():
    q, k, v = _mk(1, 256, 256, 2, 2, 64)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (tnn.dot_product_attention(qt, kt, vt, is_causal=True) ** 2).sum().backward()

    def loss(f):
        return lambda q_, k_, v_: (f(q_, k_, v_, is_causal=True) ** 2).sum()

    args = tuple(map(jnp.asarray, (q, k, v)))
    for f in (jax.nn.dot_product_attention, jnn_adapter.dot_product_attention):
        want = jax.grad(loss(f), argnums=(0, 1, 2))(*args)
        for got, w in zip((qt.grad, kt.grad, vt.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_bias_falls_back_and_matches():
    q, k, v = _mk(1, 128, 128, 2, 2, 64)
    bias = np.random.default_rng(9).standard_normal((1, 2, 128, 128), dtype=np.float32)
    _check(q, k, v, bias)


def test_cross_length_causal_falls_back():
    # jax.nn's causal is top-left for T != S; the adapter must defer, not guess
    _check(*_mk(1, 128, 256, 2, 2, 64), is_causal=True)


def test_implementation_flash_refuses_fallback_args():
    q, k, v = map(torch.from_numpy, _mk(1, 128, 256, 2, 2, 64))
    with pytest.raises(ValueError, match="fallback"):
        tnn.dot_product_attention(q, k, v, is_causal=True, implementation="flash")


def test_negative_window_falls_back():
    # jax.nn defines left=-1 as "mask the row empty"; the kernels' window=0
    # means disabled: the adapter must defer, not silently run full causal
    _check(*_mk(1, 128, 128, 2, 2, 64), is_causal=True, local_window_size=(-1, 0))


def test_implementation_validated():
    q, k, v = map(torch.from_numpy, _mk(1, 128, 128, 2, 2, 64))
    with pytest.raises(ValueError, match="cudnn"):
        tnn.dot_product_attention(q, k, v, implementation="cudnn")


def test_boolean_mask_and_residual_fall_back_and_match():
    """The deferred path's own semantics beside jax.nn's: a boolean mask, a
    padded batch on a non-causal window, and the logsumexp residual."""
    q, k, v = _mk(2, 96, 160, 4, 2, 64, seed=3)
    mask = np.random.default_rng(4).random((2, 1, 96, 160)) < 0.8
    kw = dict(local_window_size=(40, 9), key_value_seq_lengths=np.array([160, 70], np.int32))
    _check(q, k, v, None, mask, **kw)
    ours, res = tnn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                          return_residual=True, is_causal=True)
    want, want_res = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                                  return_residual=True, is_causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), **TOL)
    assert res.shape == (2, 96, 4) and not res.requires_grad


def test_kernel_routed_calls_reach_the_op_and_deferred_ones_do_not(monkeypatch):
    """Which path a call takes depends on its arguments alone: count the
    forward kernel wrapper's calls through the op."""
    ops = importlib.import_module("flash_attention_dlrs_tpu_torch.ops.flash_attention")
    calls = []
    real = ops.attn_fwd
    monkeypatch.setattr(ops, "attn_fwd", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = map(torch.from_numpy, _mk(2, 128, 128, 4, 2, 64))
    tnn.dot_product_attention(q, k, v, is_causal=True, local_window_size=(31, 0),
                              query_seq_lengths=torch.tensor([128, 100]))
    assert len(calls) == 1 and calls[0]["window"] == 32 and calls[0]["q_seg"] is not None
    for kw in (dict(bias=torch.zeros(1, 4, 128, 128)), dict(implementation="xla"),
               dict(return_residual=True), dict(is_causal=True, local_window_size=(-1, 0))):
        tnn.dot_product_attention(q, k, v, **kw)
    tnn.dot_product_attention(q.double(), k.double(), v.double(), is_causal=True)
    assert len(calls) == 1
