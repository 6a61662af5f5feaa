"""The port's encoder (models/encoder.py) against the JAX package's, on the CPU.

Counterpart of tests/test_models.py::test_encoder_bidirectional: the same
``ModelConfig.tiny(dtype=float32)`` weights and tokens through both
packages' ``encode``, ``mlm_logits`` and ``mlm_loss`` (JAX's non-causal
flash attention in interpret mode) at fp32 atol 1e-4, the loss's gradient
with respect to every parameter at 1e-5, with and without block remat; and
the bidirectionality check itself on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import encoder as jenc
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import encoder as tenc
from flash_attention_dlrs_tpu_torch.models import params_from_jax, params_to_numpy

JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)
TCFG = TConfig.tiny(dtype=torch.float32, remat=False)
ATOL = 1e-4
GRAD_ATOL = 1e-5
MASK_ID = 3  # tests/test_models.py's mask token


def _batch(seed, b=2, n=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab_size, (b, n)).astype(np.int32)
    mask = rng.random((b, n)) < 0.15
    mask[0, 5] = mask[0, 30] = True
    masked = np.where(mask, MASK_ID, tokens).astype(np.int32)
    return tokens, masked, mask


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(0), JCFG)
    tree = jax.tree.map(np.asarray, params)
    tokens, masked, mask = _batch(6)
    want = {
        "encode": np.asarray(jenc.encode(params, jnp.asarray(tokens), JCFG)),
        "logits": np.asarray(jenc.mlm_logits(params, jnp.asarray(masked), JCFG)),
    }
    loss, grads = jax.value_and_grad(lambda p: jenc.mlm_loss(
        p, jnp.asarray(tokens), jnp.asarray(masked), jnp.asarray(mask), JCFG))(params)
    want["loss"], want["grads"] = float(loss), jax.tree.map(np.asarray, grads)
    return tree, (tokens, masked, mask), want


def _model(tree, cfg=TCFG):
    return params_from_jax(tree, cfg, device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_encode_matches_jax(setup):
    tree, (tokens, _, _), want = setup
    with torch.no_grad():
        got = tenc.encode(_model(tree), _t(tokens).long(), TCFG)
    assert got.shape == (2, 64, TCFG.d_model)
    np.testing.assert_allclose(got.numpy(), want["encode"], atol=ATOL, rtol=0)


def test_mlm_logits_match_jax(setup):
    tree, (_, masked, _), want = setup
    with torch.no_grad():
        got = tenc.mlm_logits(_model(tree), _t(masked).long(), TCFG)
    assert got.dtype == torch.float32 and got.shape == (2, 64, TCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want["logits"], atol=ATOL, rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("remat", [False, True])
def test_mlm_loss_and_gradients_match_jax(setup, remat):
    tree, (tokens, masked, mask), want = setup
    cfg = dataclasses.replace(TCFG, remat=remat)
    model = _model(tree, cfg)
    loss = tenc.mlm_loss(model, _t(tokens).long(), _t(masked).long(), _t(mask), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], atol=ATOL, rtol=0)
    got = params_to_numpy({n: p.grad for n, p in model.named_parameters()})
    pairs = dict(_leaves(want["grads"]))
    mine = dict(_leaves(got))
    assert set(mine) == set(pairs)
    for name, g in mine.items():
        np.testing.assert_allclose(g, pairs[name], atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_remat_changes_no_value(setup):
    tree, (tokens, masked, mask), _ = setup
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        model = _model(tree, cfg)
        tenc.mlm_loss(model, _t(tokens).long(), _t(masked).long(), _t(mask), cfg).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_encoder_is_bidirectional(setup):
    """tests/test_models.py's check: changing a LATE token changes EARLY
    embeddings; the loss of a masked batch is finite with finite gradients."""
    tree = setup[0]
    model = _model(tree)
    toks = torch.from_numpy(_batch(6, b=1)[0]).long()
    later = toks.clone()
    later[0, 60] = (later[0, 60] + 1) % TCFG.vocab_size
    with torch.no_grad():
        emb, emb_b = (tenc.encode(model, t, TCFG) for t in (toks, later))
    assert not torch.allclose(emb[0, :10], emb_b[0, :10], atol=1e-6)
    mask = torch.zeros_like(toks, dtype=torch.bool)
    mask[0, 5] = mask[0, 30] = True
    loss = tenc.mlm_loss(model, toks, torch.where(mask, MASK_ID, toks), mask, TCFG)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(model.embed.grad.sum())


def test_init_encoder_params_is_the_decoders_structure():
    tree = tenc.init_encoder_params(TCFG, seed=0)
    jtree = init_params(jax.random.PRNGKey(0), JCFG)
    assert {k for k, _ in _leaves(tree)} == {k for k, _ in _leaves(jtree)}
