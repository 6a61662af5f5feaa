"""Attention dropout in the PyTorch port against the JAX package.

The mask is a pure function of (seed, batch, q head, row, column): the
port's ``dropout_keep_mask`` must give the JAX package's bits exactly, for
seeds that wrap past 2^31 as the per-layer and per-microbatch seeds do.
With the same mask on both sides, the forward (O, lse), the gradients, and
an ALiBi model trained with ``attn_dropout`` (its loss and gradients at a
seed, accumulated steps, bitwise resume) are compared as deterministic
functions.  The JAX side runs Pallas in interpret mode; the port runs its
kernels' plain versions.  Tolerances: forward atol 1e-4 / rtol 1e-5,
gradients the fp32 ladder dQ 9e-4, dK 7e-4, dV 7e-5, the model's loss and
gradients 1e-5, trained weights 3e-5 (tests/test_torch_train.py: AdamW
amplifies summation-order noise in near-zero gradients).
"""

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
from flash_attention_dlrs_tpu.models import init_params, loss_fn as jloss
from flash_attention_dlrs_tpu.models import make_accum_train_step as jaccum
from flash_attention_dlrs_tpu.ops import fwd_kernel as jfwd
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import TrainSpec as TSpec
from flash_attention_dlrs_tpu_torch.models import (
    fit, loss_fn as tloss, make_accum_train_step, make_train_state, make_train_step,
    params_from_jax, params_to_numpy,
)
from flash_attention_dlrs_tpu_torch.models.transformer import layer_seed
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.runtime import data as tdata

FWD = dict(atol=1e-4, rtol=1e-5)
GRAD_ATOL = (9e-4, 7e-4, 7e-5)  # dQ, dK, dV
ATOL, ADAM_ATOL = 1e-5, 3e-5


def _wrap(x):
    return int(np.int64(x).astype(np.int32))


@pytest.mark.parametrize("seed", [0, -1, 2 ** 31 - 1, -2 ** 31,
                                  _wrap(2 ** 31 - 5 + 3 * 1299709),
                                  _wrap(123456 + 7368787 * 300)])
def test_mask_is_bit_identical_to_jax(seed):
    rows = np.arange(0, 4096, 7, dtype=np.int32)[:, None]
    cols = np.arange(4096, dtype=np.int32)[None, :]
    for b, h, rate in ((0, 0, 0.1), (1, 3, 0.5), (7, 31, 0.9), (65535, 2, 0.25)):
        want = np.asarray(jfwd.dropout_keep_mask(
            jnp.int32(seed), jnp.int32(b), jnp.int32(h), jnp.asarray(rows),
            jnp.asarray(cols), rate))
        got = tfwd.dropout_keep_mask(seed, b, h, torch.from_numpy(rows),
                                     torch.from_numpy(cols), rate)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), (seed, b, h, rate)


def test_seeds_wrap_like_int32():
    assert tfwd.int32_seed(2 ** 31) == -2 ** 31
    assert tfwd.int32_seed(-2 ** 31 - 1) == 2 ** 31 - 1
    assert layer_seed(2 ** 31 - 1, 1) == _wrap(2 ** 31 - 1 + 1299709)
    # a seed past int32 drops the same elements as its wrapped value
    rows, cols = torch.arange(64)[:, None], torch.arange(64)[None, :]
    assert torch.equal(tfwd.dropout_keep_mask(2 ** 32 + 5, 0, 1, rows, cols, 0.3),
                       tfwd.dropout_keep_mask(5, 0, 1, rows, cols, 0.3))


CASES = {
    # name: (B, Hq, Hkv, N, d, rate, ALiBi)
    "rate0.1_gqa": (1, 4, 2, 128, 64, 0.1, False),
    "rate0.5_tails": (2, 2, 1, 100, 32, 0.5, False),
    "alibi_rate0.2_gqa": (1, 4, 2, 128, 64, 0.2, True),
}


def _inputs(seed, b, hq, hkv, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, n, d), dtype=np.float32),
            rng.standard_normal((b, hkv, n, d), dtype=np.float32),
            rng.standard_normal((b, hkv, n, d), dtype=np.float32),
            rng.standard_normal((b, hq, n, d), dtype=np.float32))


def _kw(name, seed):
    _, hq, _, _, _, rate, alibi = CASES[name]
    return dict(causal=True, dropout_rate=rate, dropout_seed=seed,
                alibi_slopes=fa.alibi_slopes_for(hq) if alibi else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    q, k, v, _ = _inputs(len(name), *CASES[name][:5])
    kw = _kw(name, 2 ** 31 - 3)
    oj, lj = fa.flash_attention_forward(*map(jnp.asarray, (q, k, v)), **kw)
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FWD)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD)
    # the lse is undropped; O is not the undropped one
    kw_off = dict(kw, dropout_rate=0.0, dropout_seed=None)
    o0, l0 = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw_off)
    assert torch.equal(l0, lt) and not torch.allclose(o0, ot, atol=1e-2)
    # the oracle applies the same mask
    oref = tp.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                  sm_scale=q.shape[-1] ** -0.5, **kw)
    np.testing.assert_allclose(ot.numpy(), oref.numpy(), **FWD)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    q, k, v, do = _inputs(len(name) + 1, *CASES[name][:5])
    kw = _kw(name, 17)

    def loss(q_, k_, v_):
        return jnp.sum(fa.flash_attention(q_, k_, v_, **kw) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for t, w, atol in zip(leaves, want, GRAD_ATOL):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=atol, rtol=1e-5)
    oracle = tp.reference_attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                          sm_scale=q.shape[-1] ** -0.5, **kw)
    for t, w, atol in zip(leaves, oracle, GRAD_ATOL):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=atol, rtol=1e-5)


def test_dropout_validation():
    q, k, v, _ = map(torch.from_numpy, _inputs(3, 1, 2, 2, 64, 32))
    with pytest.raises(ValueError, match="dropout_seed"):
        tp.flash_attention(q, k, v, causal=True, dropout_rate=0.5)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            tp.flash_attention(q, k, v, causal=True, dropout_rate=rate, dropout_seed=1)
    # rate 0 ignores the seed
    assert torch.equal(tp.flash_attention(q, k, v, causal=True, dropout_seed=3),
                       tp.flash_attention(q, k, v, causal=True))


# ---------------------------------------------------------------------------
# Training an ALiBi model with attention dropout
# ---------------------------------------------------------------------------


def _configs(**kw):
    kw = dict(position_encoding="alibi", attn_dropout=0.1, **kw)
    return (JConfig.tiny(dtype=jnp.float32, **kw), TConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs(remat=False)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _assert_trees_close(got, want, atol=ATOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("seed", [5, 2 ** 31 - 1])
def test_loss_and_grads_match_jax(tree, seed):
    """remat on the port's side: the recompute must draw the forward's
    masks.  Seed 2^31 − 1 wraps every layer's seed past int32."""
    jcfg, _ = _configs(remat=False)
    _, tcfg = _configs(remat=True)
    toks = _tokens(seed % 7)
    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                                       jcfg, dropout_seed=jnp.int32(seed))
    model = params_from_jax(tree, tcfg, device="cpu")
    lt = tloss(model, torch.from_numpy(toks), tcfg, dropout_seed=seed)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=0)
    got = params_to_numpy({n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(got, gj)
    # without a seed the model runs undropped
    l0 = tloss(model, torch.from_numpy(toks), tcfg)
    assert abs(l0.item() - lt.item()) > 1e-4


def test_accumulated_steps_match_jax(tree):
    jcfg, tcfg = _configs(remat=False)
    model, state, opt = make_train_state(tcfg, params=tree, device="cpu")
    step = make_accum_train_step(tcfg, opt, accum_steps=2)
    jopt = optax.adamw(3e-4, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jaccum(jcfg, jopt, accum_steps=2)
    for i, seed in enumerate((0, 2 ** 31 - 2)):
        toks = _tokens(30 + i, b=4)
        lt = step(model, state, torch.from_numpy(toks), seed)
        jparams, jstate, lj = jstep(jparams, jstate, jnp.asarray(toks), jnp.int32(seed))
        np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=0)
    _assert_trees_close(params_to_numpy(model), jparams, atol=ADAM_ATOL)


def test_train_step_needs_its_seed(tree):
    _, tcfg = _configs(remat=False)
    model, state, opt = make_train_state(tcfg, params=tree, device="cpu")
    with pytest.raises(ValueError, match="dropout_seed"):
        make_train_step(tcfg, opt)(model, state, torch.from_numpy(_tokens(1)))
    with pytest.raises(ValueError, match="dropout_seed"):
        make_accum_train_step(tcfg, opt, accum_steps=2)(
            model, state, torch.from_numpy(_tokens(1, b=4)))


def test_fit_with_dropout_resumes_bit_for_bit(tmp_path):
    _, tcfg = _configs(remat=True)
    rng = np.random.default_rng(2)
    ds = tdata.TokenDataset(rng.integers(0, 256, 1500).astype(np.int32), seq_len=32)
    spec = TSpec(learning_rate=2e-3, warmup_steps=2, total_steps=5)

    def stream(state):
        return tdata.batches(ds, batch_size=2, seed=3, state=state)

    kw = dict(spec=spec, seed=0, device="cpu")
    full = fit(tcfg, stream, steps=5, checkpoint_dir=str(tmp_path / "a"), **kw)
    fit(tcfg, stream, steps=2, checkpoint_dir=str(tmp_path / "b"), **kw)
    resumed = fit(tcfg, stream, steps=5, checkpoint_dir=str(tmp_path / "b"), **kw)
    for (name, a), b in zip(full["model"].named_parameters(),
                            resumed["model"].parameters()):
        assert torch.equal(a, b), name
    # and dropout was on: a run without it ends elsewhere
    off = fit(TConfig.tiny(dtype=torch.float32, remat=True, position_encoding="alibi"),
              stream, steps=5, **kw)
    assert not torch.equal(off["model"].embed, full["model"].embed)
