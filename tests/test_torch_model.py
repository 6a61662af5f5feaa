"""The PyTorch port's model, prefill and decode step against the JAX package's.

The JAX params of ``ModelConfig.tiny(dtype=float32)`` go across with
``params_from_jax``; the same seeded tokens then go through both packages.
fp32, atol 1e-4 (the repo's forward tolerance; the paths differ only in
summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import forward as jforward
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.models import decoding as jdecoding
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import decoding as tdecoding
from flash_attention_dlrs_tpu_torch.models import (
    forward as tforward, init_params_numpy, make_train_state, make_train_step,
    params_from_jax,
)
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine as TEngine

ATOL = 1e-4
JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)
TCFG = TConfig.tiny(dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def jparams():
    return init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tree(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def model(tree):
    return params_from_jax(tree, TCFG, device="cpu")


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (b, t)).astype(np.int32)


def test_params_from_jax_carries_every_weight(tree, model):
    assert torch.equal(model.embed, torch.from_numpy(tree["embed"]))
    assert torch.equal(model.final_norm, torch.from_numpy(tree["final_norm"]))
    assert len(model.layers) == len(tree["layers"])
    for block, layer in zip(model.layers, tree["layers"]):
        for key, value in layer.items():
            assert torch.equal(getattr(block, key), torch.from_numpy(value)), key


def test_params_from_jax_bf16_is_bit_exact():
    jcfg = JConfig.tiny(remat=False)  # bf16 weights
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), jcfg))
    model = params_from_jax(tree, TConfig.tiny(), device="cpu")
    assert model.layers[0].wq.dtype == torch.bfloat16
    got = model.layers[0].wq.view(torch.int16).numpy()
    assert np.array_equal(got, tree["layers"][0]["wq"].view(np.int16))
    assert model.layers[0].attn_norm.dtype == torch.float32


def test_params_from_jax_rejects_unported_keys_and_shapes(tree):
    """QKV biases are ported: a ``bq`` of the config's width is carried.
    What raises is their misuse (a bias of another width, a key no model
    has) and a weight of the wrong shape."""
    biased = dict(tree, layers=[dict(tree["layers"][0], bq=np.ones(128, np.float32))] * 2)
    assert torch.equal(params_from_jax(biased, TCFG, device="cpu").layers[1].bq,
                       torch.ones(128))
    bad = dict(tree, layers=[dict(tree["layers"][0], bq=np.zeros(100))] * 2)
    with pytest.raises(ValueError, match="bq"):
        params_from_jax(bad, TCFG, device="cpu")
    with pytest.raises(ValueError, match="bz"):
        params_from_jax(dict(tree, layers=[dict(tree["layers"][0], bz=np.zeros(8))] * 2),
                        TCFG, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataclasses.replace(TCFG, d_ff=128), device="cpu")


def test_init_params_numpy_has_the_jax_layout(jparams):
    mine = init_params_numpy(TCFG, seed=0)
    jstruct = jax.tree.structure(jparams)
    assert jax.tree.structure(mine) == jstruct
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and a.dtype == np.float32
    again = init_params_numpy(TCFG, seed=0)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(mine), jax.tree.leaves(again)))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(theta):
    from flash_attention_dlrs_tpu.models.transformer import rope as jrope
    from flash_attention_dlrs_tpu_torch.models.transformer import rope as trope

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 3, 64), dtype=np.float32)
    pos = rng.integers(0, 4096, (2, 40)).astype(np.int32)
    want = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = trope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dense_forward_matches_jax(jparams, model):
    toks = _tokens(0, 2, 24)
    lj = jforward(jparams, jnp.asarray(toks), JCFG)
    lt = tforward(model, torch.from_numpy(toks).long(), TCFG)  # differentiable
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=ATOL, rtol=0)


def test_prefill_logits_and_kv_match_jax(jparams, model):
    toks = np.zeros((2, 128), np.int32)
    toks[0, :37] = _tokens(1, 1, 37)
    toks[1, :90] = _tokens(2, 1, 90)
    lens = np.asarray([37, 90], np.int32)
    lj, kvj = jdecoding.make_prefill(JCFG)(jparams, jnp.asarray(toks),
                                           jnp.asarray(lens))
    lt, kvt = tdecoding.make_prefill(TCFG)(model, torch.from_numpy(toks).long(),
                                           torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    assert len(kvt) == TCFG.n_layers
    for (kj, vj), (kt, vt) in zip(kvj, kvt):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL, rtol=0)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL, rtol=0)


def test_decode_step_matches_jax(jparams, model):
    rng = np.random.default_rng(3)
    hkv, ps, num_pages, pps, d = TCFG.n_kv_heads, 16, 8, 3, TCFG.head_dim
    pools_np = [(rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32),
                 rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32))
                for _ in range(TCFG.n_layers)]
    # JAX pools carry head_dim padded to 128 lanes; the port's do not.
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - d))
    jpools = jdecoding.KVPools(
        tuple(jnp.asarray(np.pad(k, pad)) for k, _ in pools_np),
        tuple(jnp.asarray(np.pad(v, pad)) for _, v in pools_np), None, None)
    tpools = tdecoding.KVPools(
        tuple(torch.from_numpy(k.copy()) for k, _ in pools_np),
        tuple(torch.from_numpy(v.copy()) for _, v in pools_np))
    tokens = np.asarray([7, 200, 3], np.int32)
    positions = np.asarray([20, 5, 40], np.int32)
    tbl = np.asarray([[3, 1, 6], [2, 0, 0], [5, 4, 7]], np.int32)
    rows = tbl[np.arange(3), positions // ps].astype(np.int32)
    offs = (positions % ps).astype(np.int32)
    lens = positions + 1
    lj, jpools = jdecoding.make_decode_step(JCFG)(
        jparams, jpools, *(jnp.asarray(a) for a in
                           (tokens, positions, rows, offs, tbl, lens)))
    lt, tpools_out = tdecoding.make_decode_step(TCFG)(
        model, tpools, *(torch.from_numpy(a) for a in
                         (tokens, positions, rows, offs, tbl, lens)))
    assert tpools_out is tpools  # written in place
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    for li in range(TCFG.n_layers):
        np.testing.assert_allclose(
            tpools.k[li].numpy(), np.asarray(jpools.k[li])[..., :d],
            atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            tpools.v[li].numpy(), np.asarray(jpools.v[li])[..., :d],
            atol=ATOL, rtol=0)


def test_write_prompt_kv_all_fills_the_pages(model):
    toks = np.zeros((1, 128), np.int32)
    toks[0, :40] = _tokens(4, 1, 40)
    _, kvs = tdecoding.make_prefill(TCFG)(
        model, torch.from_numpy(toks).long(), torch.tensor([40]))
    pools = tdecoding.init_kv_pools(TCFG, num_pages=6, page_size=16,
                                    dtype=torch.float32, device="cpu")
    pages = torch.tensor([4, 1, 3])
    tdecoding.write_prompt_kv_all(pools, kvs, pages, 16)
    d = TCFG.head_dim  # the pools are zero-padded to the kernels' width, 64
    assert pools.k[0].shape[-1] == 64
    for li, (k, v) in enumerate(kvs):
        got = pools.k[li][:, pages].reshape(TCFG.n_kv_heads, 48, -1)
        assert torch.equal(got[:, :40, :d], k[0, :, :40])
        assert torch.equal(pools.v[li][:, pages].reshape(
            TCFG.n_kv_heads, 48, -1)[:, :40, :d], v[0, :, :40])
        assert (got[..., d:] == 0).all()
    assert (pools.k[0][:, [0, 2, 5]] == 0).all()


@pytest.mark.parametrize("field,value", [
    ("rope_scaling", ("linear", 2.0)),
    ("position_encoding", "alibi"),
    ("window", 64),
    ("attn_dropout", 0.1),
    ("mlp_act", "gelu_tanh"),
    ("embed_scale", True),
    ("attn_softcap", 50.0),
    ("final_softcap", 30.0),
])
def test_model_config_refuses_unported_variants(field, value):
    """Every variant is ported: each config builds.  What raises is the
    misuse the JAX package refuses too: an ALiBi model behind a rolling
    ring (a sliding window or a streaming window, neither ported), a
    dropout model's train step called without its seed, a RoPE scaling of
    an unknown kind, an even-pattern window the context outgrows, an
    unknown MLP activation, a Gemma state dict without its cfg, a negative
    attention softcap, and a softcapped chunked loss whose chunk does not
    divide the sequence."""
    TConfig.tiny(**{field: value})
    if field == "position_encoding":
        cfg = TConfig.tiny(position_encoding=value, window=64, dtype=torch.float32)
        model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ALiBi"):
            TEngine(model, cfg, page_size=16, pages_per_seq=8, device="cpu")
        cfg = TConfig.tiny(position_encoding=value, dtype=torch.float32)
        model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(model, cfg, streaming_window=64, device="cpu")
    elif field == "attn_dropout":
        cfg = TConfig.tiny(attn_dropout=value, dtype=torch.float32)
        model, state, opt = make_train_state(cfg, device="cpu")
        with pytest.raises(ValueError, match="dropout_seed"):
            make_train_step(cfg, opt)(model, state, torch.zeros((1, 9), dtype=torch.long))
    elif field == "rope_scaling":
        from flash_attention_dlrs_tpu.models.transformer import rope as jrope
        from flash_attention_dlrs_tpu_torch.models.transformer import rope as trope

        x, pos = np.zeros((1, 4, 2, 32), np.float32), np.arange(4)[None]
        with pytest.raises(ValueError, match="rope_scaling kind"):
            jrope(jnp.asarray(x), jnp.asarray(pos), 1e4, ("ntk", 2.0))
        with pytest.raises(ValueError, match="rope_scaling kind"):
            trope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, ("ntk", 2.0))
    elif field == "window":
        from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine

        cfg = TConfig.tiny(window=value, window_pattern="even", dtype=torch.float32)
        model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device="cpu")
        jcfg = JConfig.tiny(window=value, window_pattern="even", dtype=jnp.float32)
        for make in (lambda: TEngine(model, cfg, page_size=16, pages_per_seq=8,
                                     device="cpu"),
                     lambda: JEngine(init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                                     page_size=16, pages_per_seq=8)):
            with pytest.raises(NotImplementedError, match="window_pattern"):
                make()
        TEngine(model, cfg, page_size=16, pages_per_seq=4, device="cpu")  # within it
    elif field == "mlp_act":
        with pytest.raises(ValueError, match="mlp_act"):
            TConfig.tiny(mlp_act="gelu")
    elif field == "embed_scale":
        from flash_attention_dlrs_tpu.models import import_hf_gemma as jimport
        from flash_attention_dlrs_tpu_torch.models import import_hf_gemma as timport

        state = {"model.embed_tokens.weight": np.zeros((4, 2), np.float32)}
        with pytest.raises(ValueError, match="cfg is required"):
            jimport(state)
        with pytest.raises(ValueError, match="cfg is required"):
            timport(state, device="cpu")
    elif field == "attn_softcap":
        from flash_attention_dlrs_tpu.ops import flash_attention as jflash
        from flash_attention_dlrs_tpu_torch.ops import flash_attention as tflash

        x = np.zeros((1, 1, 8, 64), np.float32)
        with pytest.raises(ValueError, match="logit_softcap"):
            jflash(*(jnp.asarray(x),) * 3, causal=True, logit_softcap=-value)
        with pytest.raises(ValueError, match="logit_softcap"):
            tflash(*(torch.from_numpy(x),) * 3, causal=True, logit_softcap=-value)
    else:  # final_softcap
        from flash_attention_dlrs_tpu.models.transformer import (
            chunked_cross_entropy as jchunked)
        from flash_attention_dlrs_tpu_torch.models.transformer import (
            chunked_cross_entropy as tchunked)

        x, emb, t = np.zeros((1, 6, 8), np.float32), np.zeros((5, 8), np.float32), np.zeros(
            (1, 6), np.int32)
        with pytest.raises(ValueError, match="divisible"):
            jchunked(jnp.asarray(x), jnp.asarray(emb), jnp.asarray(t), 4, value)
        with pytest.raises(ValueError, match="divisible"):
            tchunked(torch.from_numpy(x), torch.from_numpy(emb), torch.from_numpy(t).long(),
                     4, value)


def test_quantized_pools_are_not_ported_yet():
    """Quantized pools are ported now: int8 / int4 / fp8 pools have the JAX
    package's shapes (without its 128-lane head_dim padding) and scales of
    1, and a value dtype with ``quantized=True`` is refused as it cannot be
    quantized to."""
    for jd, td in ((jnp.int8, torch.int8), ("int4", "int4"),
                   (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
        want = jdecoding.init_kv_pools(JCFG, num_pages=2, page_size=16, dtype=jd,
                                       quantized=True)
        got = tdecoding.init_kv_pools(TCFG, num_pages=2, page_size=16, dtype=td,
                                      quantized=True, device="cpu")
        assert got.quantized and got.int4 == want.int4
        assert got.k[0].shape[:3] == want.k[0].shape[:3]
        assert got.k_scales[0].shape == want.k_scales[0].shape
        assert (got.v_scales[-1] == 1).all() and (got.k[0] == 0).all()
    with pytest.raises(ValueError, match="quantized"):
        tdecoding.init_kv_pools(TCFG, num_pages=2, quantized=True, device="cpu")
