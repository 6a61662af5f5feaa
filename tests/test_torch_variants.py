"""The model variants of the port against the JAX package's, on the CPU.

One case per variant of ``ModelConfig`` and of the params: each window
pattern, the attention and final softcaps, each RoPE scaling, GeGLU, the
embedding scale, an explicit softmax scale, QKV biases, Gemma-2's sandwich
norms, weight-only int8, and head dims 96 and 256 (zero-padded to the
kernels' 128 and taken as is).  The same numpy tree goes to both packages
(``params_from_jax``) and the same seeded tokens through ``forward``,
``loss_fn`` (plain and chunked) and the prefill; a tiny Gemma-2-shaped model
is served by both engines.  fp32, atol 1e-4 (tests/test_torch_model.py).
The decode and verify steps of every variant are in
``test_torch_variants_paged.py`` (the JAX package compiles each step per
variant: one file would take over a minute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu.models import forward as jforward
from flash_attention_dlrs_tpu.models import loss_fn as jloss
from flash_attention_dlrs_tpu.models import quantize_params as jquantize
from flash_attention_dlrs_tpu.runtime import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from flash_attention_dlrs_tpu_torch.models import (
    forward, init_params_numpy, loss_fn, params_from_jax,
)
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

ATOL = 1e-4
BASE = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4, n_kv_heads=2,
            head_dim=32, d_ff=256, remat=False)
BIASES = ("bq", "bk", "bv")
SANDWICH = ("post_attn_norm", "post_mlp_norm")

# variant: (ModelConfig fields, optional layer keys, int8 projections).
# Windows of 8 and sequences of 16 make the patterns differ; the softcaps
# are small enough to bend this model's scores and logits.
VARIANTS = {
    "window_all": (dict(window=8), (), False),
    "window_even": (dict(window=8, window_pattern="even"), (), False),
    "window_from1": (dict(window=8, window_pattern="from:1"), (), False),
    "attn_softcap": (dict(attn_softcap=2.0), (), False),
    "final_softcap": (dict(final_softcap=0.2), (), False),
    "rope_linear": (dict(rope_scaling=("linear", 4.0)), (), False),
    "rope_yarn": (dict(rope_scaling=("yarn", 4.0, 32.0, 1.0, 16.0, 1.1386)), (), False),
    "rope_llama3": (dict(rope_theta=5e5, rope_scaling=("llama3", 8.0, 1.0, 4.0, 16.0)),
                    (), False),
    "gelu_tanh": (dict(mlp_act="gelu_tanh"), (), False),
    "embed_scale": (dict(embed_scale=True), (), False),
    "sm_scale": (dict(sm_scale=0.3), (), False),
    "biases": ({}, BIASES, False),
    "sandwich_norms": ({}, SANDWICH, False),
    "int8_weights": ({}, (), True),
    "head_dim_96": (dict(head_dim=96), (), False),
    "head_dim_256": (dict(head_dim=256), (), False),
}


def make_pair(variant, seed=0):
    """(JAX params, JAX cfg, port model, port cfg) of ``variant`` from one
    numpy tree (int8: quantized by the JAX package, then carried across)."""
    fields, extras, int8 = VARIANTS[variant]
    tcfg = TConfig(**dict(BASE, **fields), dtype=torch.float32)
    jcfg = JConfig(**dict(BASE, **fields), dtype=jnp.float32)
    tree = init_params_numpy(tcfg, seed=seed, extras=extras)
    jparams = jax.tree.map(jnp.asarray, tree)
    if int8:
        jparams = jquantize(jparams)
        tree = jax.tree.map(np.asarray, jparams)
    return jparams, jcfg, params_from_jax(tree, tcfg, device="cpu"), tcfg


def tokens(seed, b, n):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (b, n)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return (request.param, *make_pair(request.param))


def test_forward_matches_jax(pair):
    _, jparams, jcfg, model, tcfg = pair
    toks = tokens(1, 2, 16)
    want = np.asarray(jforward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = forward(model, torch.from_numpy(toks).long(), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_matches_jax(pair, chunk):
    """loss_fn, plain and chunked (the final softcap inside each chunk)."""
    _, jparams, jcfg, model, tcfg = pair
    toks = tokens(2, 2, 17)
    want = float(jloss(jparams, jnp.asarray(toks), dataclasses.replace(jcfg, loss_chunk=chunk)))
    with torch.no_grad():
        got = float(loss_fn(model, torch.from_numpy(toks), dataclasses.replace(
            tcfg, loss_chunk=chunk)))
    assert abs(got - want) <= ATOL


def test_prefill_matches_jax(pair):
    """Last-token logits and every layer's K/V of a padded batch (lengths
    16 and 11), each layer within its own window."""
    _, jparams, jcfg, model, tcfg = pair
    toks, lens = tokens(3, 2, 16), np.asarray([16, 11], np.int32)
    jl, jkv = jdecoding.make_prefill(jcfg)(jparams, jnp.asarray(toks), jnp.asarray(lens))
    tl, tkv = tdecoding.make_prefill(tcfg)(model, torch.from_numpy(toks).long(),
                                           torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(
    n for n, (fields, extras, int8) in VARIANTS.items()
    if fields and not extras and not int8 and "head_dim" not in fields))
def test_variant_changes_the_function(name):
    """Each config variant's logits differ from the plain model's on the
    same weights: its case tests the variant, not a no-op."""
    _, _, model, tcfg = make_pair(name)
    toks = torch.from_numpy(tokens(1, 2, 16)).long()
    plain = TConfig(**BASE, dtype=torch.float32)
    with torch.no_grad():
        assert not torch.allclose(forward(model, toks, tcfg), forward(model, toks, plain),
                                  atol=ATOL)


# ---------------------------------------------------------------------------
# A tiny Gemma-2-shaped model through both engines
# ---------------------------------------------------------------------------

GEMMA2 = dict(vocab_size=256, d_model=128, n_layers=4, n_q_heads=4, n_kv_heads=2,
              head_dim=256, d_ff=256, remat=False, window=64, window_pattern="even",
              attn_softcap=50.0, final_softcap=30.0, mlp_act="gelu_tanh", embed_scale=True,
              sm_scale=256 ** -0.5, norm_eps=1e-6)


def test_gemma2_engine_greedy_matches_jax():
    """Gemma-2's shape at tiny width (head_dim 256, even-layer window,
    softcaps, GeGLU, sandwich norms, √d_model embeddings) served by both
    engines with a context that fits the window (4 pages of 16): the
    greedy tokens are equal, and equal the dense forward's."""
    tcfg = TConfig(**GEMMA2, dtype=torch.float32)
    jcfg = JConfig(**GEMMA2, dtype=jnp.float32)
    tree = init_params_numpy(tcfg, seed=7, extras=SANDWICH)
    model = params_from_jax(tree, tcfg, device="cpu")
    prompts = [list(tokens(8, 1, 20)[0]), list(tokens(9, 1, 9)[0])]
    kw = dict(num_pages=12, page_size=16, num_slots=2, pages_per_seq=4)
    want = JEngine(jax.tree.map(jnp.asarray, tree), jcfg, kv_dtype=jnp.float32,
                   **kw).generate(prompts, max_new_tokens=6)
    got = TEngine(model, tcfg, kv_dtype=torch.float32, device="cpu",
                  **kw).generate(prompts, max_new_tokens=6)
    assert got == want
    seq = list(prompts[0])
    for _ in range(6):
        with torch.no_grad():
            logits = forward(model, torch.tensor([seq]), tcfg)
        seq.append(int(logits[0, -1].argmax()))
    assert seq[len(prompts[0]):] == got[0]
