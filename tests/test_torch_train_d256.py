"""Training at head dim 256 in the PyTorch port against the JAX package.

The attention backward at d 256 (Gemma's heads; on the card the
``attn_bwd_d256.cu`` sweeps, here their plain version, which CPU tensors
take) against the JAX op in interpret mode, as its own CPU tests run it:
none / softcap / window, causal and not, GQA 2:1, Nq = Nkv and Nq < Nkv, at
the reference's fp32 gradient ladder (dQ 9e-4 / dK 7e-4 / dV 7e-5, rtol
1e-5; tests/test_backward.py:25).  Head dim 192 is zero-padded to 256, forward
(atol 1e-4, tests/test_forward.py:21) and backward (head dims above 256 are
tests/test_torch_wide_heads.py's).  Then a tiny Gemma-2-shaped
model (head dim 256, an even-layer window shorter than the sequence, both
softcaps, GeGLU, sandwich norms, the embedding scale, tied embeddings):
its ``loss_fn`` value and gradients within 1e-5 of JAX's
``value_and_grad``, and three AdamW train steps within ADAM_ATOL of JAX's
(tests/test_torch_train.py says why Adam needs the wider one).  The port
runs it under block remat, as on the card; the JAX package without remat:
its ``jax.checkpoint`` of a layer traces the layer index, which a per-layer
window pattern reads as a Python bool, and raises (ROADMAP.md, queue 3).
Remat changes no value, so the two stay comparable.  The JAX model runs
(interpret-mode compiles) are shared in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import loss_fn as jloss
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import (
    init_params_numpy, loss_fn, make_train_state, make_train_step, params_from_jax,
    params_to_numpy,
)

ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5
FWD_ATOL = 1e-4
MODEL_ATOL = 1e-5
ADAM_ATOL = 3e-5

OP_CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap)
    "d256_causal_gqa": (1, 4, 2, 80, 80, 256, True, 0, 0.0),
    "d256_softcap_noncausal": (1, 2, 1, 64, 64, 256, False, 0, 5.0),
    "d256_window_cross": (1, 4, 2, 40, 97, 256, True, 24, 0.0),
    "d256_window_softcap_causal": (2, 2, 1, 97, 97, 256, True, 30, 3.0),
    "d192_padded_to_256": (1, 2, 1, 50, 50, 192, True, 0, 0.0),
}


def _inputs(seed, b, hq, hkv, nq, nkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_and_gradients_match_jax(name):
    b, hq, hkv, nq, nkv, d, causal, window, cap = OP_CASES[name]
    q, k, v, do = _inputs(len(name) + d, b, hq, hkv, nq, nkv, d)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    def fwd_bwd(q_, k_, v_, do_):  # one jax.jit: one compile of the op's routes
        o_, vjp = jax.vjp(lambda a, b_, c: fa.flash_attention(a, b_, c, **kw), q_, k_, v_)
        return o_, vjp(do_)

    o_j, want = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o_t = tp.flash_attention(qt, kt, vt, **kw)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=FWD_ATOL,
                               rtol=RTOL)
    for grad, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL[grad],
                                   rtol=RTOL, err_msg=grad)


# A tiny Gemma-2: head dim 256, windows of 8 on the even layers of a
# 16-token sequence, both softcaps small enough to bend this model's scores
# and logits, GeGLU, sandwich norms, the embedding scale, tied embeddings.
GEMMA = dict(vocab_size=256, d_model=64, n_layers=2, n_q_heads=2, n_kv_heads=1,
             head_dim=256, d_ff=128, window=8, window_pattern="even", attn_softcap=2.0,
             final_softcap=0.5, mlp_act="gelu_tanh", embed_scale=True,
             sm_scale=256 ** -0.5)
SANDWICH = ("post_attn_norm", "post_mlp_norm")


def _tokens(seed, b=2, n=17):
    return np.random.default_rng(seed).integers(0, GEMMA["vocab_size"], (b, n)).astype(
        np.int32)


@pytest.fixture(scope="module")
def gemma():
    """The numpy tree, both configs, JAX's loss and gradients at tokens(0),
    and its three AdamW steps on tokens(10..12) (losses, final params)."""
    tcfg = TConfig(**GEMMA, dtype=torch.float32, remat=True)
    jcfg = JConfig(**GEMMA, dtype=jnp.float32, remat=False)
    tree = init_params_numpy(tcfg, seed=0, extras=SANDWICH)
    jparams = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(jloss)(jparams, jnp.asarray(_tokens(0)), jcfg)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state, step = opt.init(jparams), jstep(jcfg, opt)
    losses = []
    for i in range(3):
        jparams, state, l = step(jparams, state, jnp.asarray(_tokens(10 + i)))
        losses.append(float(l))
    return dict(tree=tree, tcfg=tcfg, loss=float(loss), grads=grads, losses=losses,
                params=jparams)


def _assert_trees_close(got, want, atol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)


def test_gemma_shaped_loss_and_grads_match_jax(gemma):
    tcfg = gemma["tcfg"]
    model = params_from_jax(gemma["tree"], tcfg, device="cpu")
    assert model.layers[0].extras == frozenset(SANDWICH)
    loss = loss_fn(model, torch.from_numpy(_tokens(0)), tcfg)
    loss.backward()
    assert abs(loss.item() - gemma["loss"]) <= MODEL_ATOL
    grads = params_to_numpy({n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(grads, gemma["grads"], MODEL_ATOL)


def test_gemma_shaped_three_train_steps_match_jax(gemma):
    tcfg = gemma["tcfg"]
    model, opt_state, optimizer = make_train_state(tcfg, params=gemma["tree"], device="cpu")
    step = make_train_step(tcfg, optimizer)
    for i, want in enumerate(gemma["losses"]):
        got = step(model, opt_state, torch.from_numpy(_tokens(10 + i)))
        assert abs(float(got) - want) <= MODEL_ATOL
    _assert_trees_close(params_to_numpy(model), gemma["params"], ADAM_ATOL)
