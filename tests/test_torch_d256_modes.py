"""Every attention mode at head dim 256 in the PyTorch port, against the JAX package.

At d 256 the port's kernels take what they take at 64 and 128 (on the card
the ``attn_fwd_d256*.cu`` / ``attn_bwd_d256*.cu`` builds and
``paged_verify_d256.cu``; here their plain versions, which CPU tensors
take).  Same seeded numpy inputs through both packages; the JAX side runs
its Pallas routes in interpret mode, as its own CPU tests do:

- the op's forward (O, lse) and dQ/dK/dV with dropout (its mask bit for bit
  the JAX package's), ALiBi, segment ids (a packed layout, and
  ``SegmentIds(q, kv)`` of different lengths with rows that see no key),
  and ALiBi with dropout, each with the causal / window / softcap settings
  the JAX package takes beside that mode; fp8 V (e4m3, e5m2), forward only;
- ``nn.dot_product_attention`` on padded batches (per-batch lengths);
- a tiny Gemma-2-shaped model with ``attn_dropout=0.1``: ``loss_fn`` and its
  gradients at a dropout seed, and three AdamW steps (step i seeded);
- paged decode (its published lse shifted by +m·(length − 1)) and verify
  with ALiBi from bf16 and int8 pools.

Tolerances: forward atol 1e-4 / rtol 1e-5 (tests/test_forward.py:21);
gradients dQ 9e-4 / dK 7e-4 / dV 7e-5, rtol 1e-5 (tests/test_backward.py:25);
bf16 q/k with fp8 V 2e-2 (the JAX package's own fp8-V tolerance,
tests/test_forward.py:530-544); ``nn`` 2e-5 (tests/test_nn.py); the
model's loss and gradients 1e-5, trained weights ADAM_ATOL (AdamW amplifies
summation-order noise in near-zero gradients, tests/test_torch_train.py),
and 3 lr where a first gradient is smaller than the gradients' tolerance,
so that its sign is noise (tests/test_torch_optim.py);
paged atol 2e-4 / rtol 1e-4 (tests/test_alibi.py:301).  The JAX package
runs the model without remat (ROADMAP.md, queue 3: its layer checkpoint
cannot trace Gemma-2's per-layer window); remat changes no value.  JAX
runs are shared in module fixtures.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flash_attention_dlrs_tpu as fa
import flash_attention_dlrs_tpu_torch as tp
from flash_attention_dlrs_tpu import nn as jnn_adapter
from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import loss_fn as jloss
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu_torch import nn as tnn
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import (
    init_params_numpy, loss_fn, make_train_state, make_train_step, params_from_jax,
    params_to_numpy,
)
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops.fwd_kernel import DEFAULT_MASK_VALUE

D = 256
FWD = dict(atol=1e-4, rtol=1e-5)
GRAD_ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5
FP8_TOL = dict(atol=2e-2, rtol=2e-2)
NN_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_ATOL, ADAM_ATOL = 1e-5, 3e-5
PAGED = dict(atol=2e-4, rtol=1e-4)


def _packed(rng, b, n, max_segs=4):
    """Each row split at max_segs - 1 random boundaries into documents 0, 1,
    ... (tests/test_forward.py:200-210)."""
    ids = np.zeros((b, n), np.int32)
    for row in ids:
        for bound in np.sort(rng.integers(1, n, max_segs - 1)):
            row[bound:] += 1
    return ids


OP_CASES = {
    # name: (B, Hq, Hkv, Nq, Nkv, kwargs, segments: None, "packed" or "cross")
    "dropout_window_softcap": (1, 2, 1, 96, 96, dict(
        causal=True, window=40, logit_softcap=5.0, dropout_rate=0.1,
        dropout_seed=2 ** 31 - 3), None),
    "alibi_gqa_softcap": (1, 4, 2, 80, 80, dict(
        causal=True, logit_softcap=5.0, alibi_slopes=fa.alibi_slopes_for(4)), None),
    "segments_packed_causal_gqa": (2, 4, 2, 128, 128, dict(causal=True), "packed"),
    # SegmentIds(q, kv) of different lengths; the last 16 q rows carry an id
    # that no key has, so they see nothing
    "segments_cross_pair": (2, 2, 1, 64, 160, dict(causal=False), "cross"),
    "alibi_dropout_gqa": (1, 4, 2, 96, 96, dict(
        causal=True, alibi_slopes=fa.alibi_slopes_for(4), dropout_rate=0.2,
        dropout_seed=-7), None),
}


@functools.cache
def _case(name):
    """The case's numpy inputs and segment ids, and the JAX package's (O,
    lse) and (dQ, dK, dV) on them."""
    b, hq, hkv, nq, nkv, kw, seg = OP_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, hq, nq, D), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, D), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, D), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, D), dtype=np.float32)
    ids = None
    if seg == "packed":
        ids = (_packed(rng, b, nq),)
    elif seg == "cross":
        ids = (_packed(rng, b, nq), _packed(rng, b, nkv))
        ids[0][:, -16:] = 99
    jkw = dict(kw, segment_ids=_seg(ids, fa))
    o, lse = fa.flash_attention_forward(*map(jnp.asarray, (q, k, v)), **jkw)
    _, vjp = jax.vjp(lambda a, b_, c: fa.flash_attention(a, b_, c, **jkw),
                     *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do), ids, (np.asarray(o), np.asarray(lse)), [np.asarray(g) for g in grads]


def _seg(ids, mod):
    """Segment ids as ``mod`` takes them: None, one [B, N] array, or a
    SegmentIds pair."""
    if ids is None:
        return None
    conv = jnp.asarray if mod is fa else torch.from_numpy
    if len(ids) == 1:
        return conv(ids[0])
    return mod.SegmentIds(q=conv(ids[0]), kv=conv(ids[1]))


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_matches_jax(name):
    (q, k, v, _), ids, (oj, lj), _ = _case(name)
    kw = dict(OP_CASES[name][5], segment_ids=_seg(ids, tp))
    ot, lt = tp.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(ot.numpy(), oj, **FWD)
    np.testing.assert_allclose(lt.numpy(), lj, **FWD)
    if OP_CASES[name][6] == "cross":  # rows whose id no key has see nothing
        empty = np.stack([~np.isin(a, b) for a, b in zip(*ids)])
        assert empty.sum() >= 32
        assert (ot.numpy().transpose(0, 2, 1, 3)[empty] == 0).all()
        assert (lt.numpy().transpose(0, 2, 1)[empty] == DEFAULT_MASK_VALUE).all()


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_gradients_match_jax(name):
    (q, k, v, do), ids, _, want = _case(name)
    kw = dict(OP_CASES[name][5], segment_ids=_seg(ids, tp))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tp.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for gname, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL[gname], rtol=RTOL,
                                   err_msg=gname)


FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


@pytest.mark.parametrize("kind", sorted(FP8))
def test_fp8_v_forward_matches_jax(kind):
    """bf16 q/k with fp8 V (the two packages' fp8 roundings of V checked
    equal), causal, GQA 2:1."""
    rng = np.random.default_rng(81)
    q = rng.standard_normal((1, 4, 192, D), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, 192, D), dtype=np.float32) for _ in range(2))
    jdt, tdt = FP8[kind]
    vj, vt = jnp.asarray(v).astype(jdt), torch.from_numpy(v).to(tdt)
    assert np.array_equal(np.asarray(vj.astype(jnp.float32)), vt.float().numpy())
    oj = fa.flash_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), vj,
                            causal=True)
    ot = tp.flash_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                            vt, causal=True)
    assert ot.dtype == torch.bfloat16 and ot.shape == (1, 4, 192, D)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32), **FP8_TOL)


def test_nn_dot_product_attention_padded_batches():
    """Per-batch lengths (the second batch padded past 50), causal, GQA
    2:1: the port against jax.nn and the JAX package's adapter."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 96, 2, D), dtype=np.float32)
    k, v = (rng.standard_normal((2, 96, 1, D), dtype=np.float32) for _ in range(2))
    lens = np.asarray([96, 50], np.int32)
    kw = dict(is_causal=True)
    ours = tnn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                     query_seq_lengths=torch.from_numpy(lens),
                                     key_value_seq_lengths=torch.from_numpy(lens), **kw)
    for fn in (jax.nn.dot_product_attention, jnn_adapter.dot_product_attention):
        want = fn(*map(jnp.asarray, (q, k, v)), query_seq_lengths=jnp.asarray(lens),
                  key_value_seq_lengths=jnp.asarray(lens), **kw)
        np.testing.assert_allclose(ours.numpy()[:, :50], np.asarray(want)[:, :50], **NN_TOL)
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(want)[0], **NN_TOL)


# A tiny Gemma-2 (tests/test_torch_train_d256.py) with attention dropout.
GEMMA = dict(vocab_size=256, d_model=64, n_layers=2, n_q_heads=2, n_kv_heads=1,
             head_dim=256, d_ff=128, window=8, window_pattern="even", attn_softcap=2.0,
             final_softcap=0.5, mlp_act="gelu_tanh", embed_scale=True,
             sm_scale=256 ** -0.5, attn_dropout=0.1)
SANDWICH = ("post_attn_norm", "post_mlp_norm")
MODEL_SEED = 2 ** 31 - 5


def _tokens(seed, b=2, n=17):
    return np.random.default_rng(seed).integers(0, GEMMA["vocab_size"], (b, n)).astype(
        np.int32)


@pytest.fixture(scope="module")
def gemma():
    """The numpy tree, the port's config, JAX's loss and gradients at
    tokens(0) and dropout seed MODEL_SEED, its gradients of the first train
    step (tokens(10), seed 0), and its three AdamW steps on tokens(10..12),
    step i with seed i (losses, final params)."""
    tcfg = TConfig(**GEMMA, dtype=torch.float32, remat=True)
    jcfg = JConfig(**GEMMA, dtype=jnp.float32, remat=False)
    tree = init_params_numpy(tcfg, seed=0, extras=SANDWICH)
    jparams = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(jloss)(jparams, jnp.asarray(_tokens(0)), jcfg,
                                            dropout_seed=jnp.int32(MODEL_SEED))
    first = jax.grad(jloss)(jparams, jnp.asarray(_tokens(10)), jcfg, dropout_seed=jnp.int32(0))
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state, step = opt.init(jparams), jstep(jcfg, opt)
    losses = []
    for i in range(3):
        jparams, state, l = step(jparams, state, jnp.asarray(_tokens(10 + i)), jnp.int32(i))
        losses.append(float(l))
    return dict(tree=tree, tcfg=tcfg, loss=float(loss), grads=grads, first=first,
                losses=losses, params=jparams)


def _assert_trees_close(got, want, atol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)


def test_gemma_shaped_dropout_loss_and_grads_match_jax(gemma):
    tcfg = gemma["tcfg"]
    model = params_from_jax(gemma["tree"], tcfg, device="cpu")
    loss = loss_fn(model, torch.from_numpy(_tokens(0)), tcfg, dropout_seed=MODEL_SEED)
    loss.backward()
    assert abs(loss.item() - gemma["loss"]) <= MODEL_ATOL
    grads = params_to_numpy({n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(grads, gemma["grads"], MODEL_ATOL)
    # the dropout is on: the undropped loss differs
    undropped = loss_fn(model, torch.from_numpy(_tokens(0)), tcfg)
    assert abs(undropped.item() - loss.item()) > 1e-4


def test_gemma_shaped_dropout_three_train_steps_match_jax(gemma):
    """Losses within 1e-5 of JAX's, and the weights within ADAM_ATOL but
    where the first step's gradient is smaller than the gradients'
    tolerance (MODEL_ATOL, within which its sign is summation-order noise:
    the two packages' gradients differ by ~5e-9 here): AdamW's first step
    moves a weight by lr times that sign, so there the weights only stay
    within 3 steps' length, 3 lr, as in tests/test_torch_optim.py."""
    tcfg = gemma["tcfg"]
    model, opt_state, optimizer = make_train_state(tcfg, params=gemma["tree"], device="cpu")
    step = make_train_step(tcfg, optimizer)
    for i, want in enumerate(gemma["losses"]):
        got = step(model, opt_state, torch.from_numpy(_tokens(10 + i)), i)
        assert abs(float(got) - want) <= MODEL_ATOL
    got, want = params_to_numpy(model), gemma["params"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    signless = 0
    for a, b, g in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(gemma["first"])):
        diff, g = np.abs(a - np.asarray(b)), np.abs(np.asarray(g))
        assert (diff[g >= MODEL_ATOL] <= ADAM_ATOL + 1e-5 * np.abs(b)[g >= MODEL_ATOL]).all()
        assert diff.max() <= 3 * 3e-4
        signless += int((diff[g < MODEL_ATOL] > ADAM_ATOL).sum())
    assert signless <= 1e-3 * sum(x.size for x in jax.tree.leaves(got))


# B, Hq, Hkv, page_size, pages_per_seq
PAGED_SHAPE = (3, 4, 2, 16, 4)
POOLS = {"bf16": None, "int8": (jnp.int8, torch.int8)}


def _paged(seed, kind, t_new=0, lengths=(0, 37, 64)):
    b, hq, hkv, ps, pps = PAGED_SHAPE
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, hq, t_new, D) if t_new else (b, hq, D), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, D), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, D), dtype=np.float32)
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    if kind == "bf16":
        pools = ((jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)),
                 (torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()))
    else:
        jd, td = POOLS[kind]
        pools = ((jdec.quantize_kv_pages(jnp.asarray(kp), jd),
                  jdec.quantize_kv_pages(jnp.asarray(vp), jd)),
                 (tdec.quantize_kv_pages(torch.from_numpy(kp), td),
                  tdec.quantize_kv_pages(torch.from_numpy(vp), td)))
    return q, pools, np.asarray(lengths, np.int32), tbl


@pytest.mark.parametrize("kind", list(POOLS))
def test_paged_decode_alibi_matches_jax(kind):
    q, ((kj, vj), (kt, vt)), lens, tbl = _paged(len(kind), kind)
    slopes = fa.alibi_slopes_for(q.shape[1])
    oj, lj = jdec.paged_decode_attention(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                                         jnp.asarray(tbl), return_lse=True,
                                         alibi_slopes=slopes)
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(lens), torch.from_numpy(tbl))
    ot, lt = tdec.paged_decode_attention(*args, return_lse=True, alibi_slopes=slopes)
    assert ot.shape == (3, 4, D)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **PAGED)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PAGED)
    assert (ot[0] == 0).all() and (lt[0] == DEFAULT_MASK_VALUE).all()
    assert float((ot - tdec.paged_decode_attention(*args)).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", list(POOLS))
def test_paged_verify_alibi_matches_jax(kind):
    t_new = 4
    q, ((kj, vj), (kt, vt)), lens, tbl = _paged(len(kind) + 7, kind, t_new,
                                                 lengths=(2, 37, 64))
    slopes = fa.alibi_slopes_for(q.shape[1])
    oj = np.asarray(jdec.paged_verify_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(lens), jnp.asarray(tbl), alibi_slopes=slopes))
    ot = tdec.paged_verify_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
                                     torch.from_numpy(tbl), alibi_slopes=slopes).numpy()
    seen = (lens[:, None] - (t_new - 1) + np.arange(t_new)[None, :] > 0)[:, None, :, None]
    np.testing.assert_allclose(np.where(seen, ot, 0), np.where(seen, oj, 0), **PAGED)
    assert (np.where(seen, 0, ot) == 0).all()
