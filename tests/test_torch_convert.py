"""The port's HF checkpoint import against transformers and the JAX converter.

Mirrors ``tests/test_convert.py`` case by case: tiny randomly initialized HF
models built from in-code configs (no downloads) go through the port's
``models/convert.py`` and must reproduce HF's logits on the CPU at the JAX
tests' tolerances (atol 2e-4, 3e-4 for Gemma; rtol 1e-3).  Beside that the
port's converted weights must equal the JAX converter's bit for bit, its
configs field by field, its refusals the JAX converter's, and it must take
a bare state dict with a ``types.SimpleNamespace`` config (what the card,
which has no ``transformers``, imports from).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from flash_attention_dlrs_tpu.models import convert as jconvert
from flash_attention_dlrs_tpu.models import forward as jforward
from flash_attention_dlrs_tpu.models import quantize_params as jquantize
from flash_attention_dlrs_tpu_torch.models import convert as tconvert
from flash_attention_dlrs_tpu_torch.models import (
    forward, loss_fn, params_from_jax, params_to_numpy, quantize_params,
)
from flash_attention_dlrs_tpu_torch.models.transformer import QuantizedWeight
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine

ATOL, GEMMA_ATOL, RTOL = 2e-4, 3e-4, 1e-3


def _tiny_hf(tie: bool, seed: int = 0, eps: float = 1e-5):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=eps,
        rope_theta=10000.0, tie_word_embeddings=tie,
    )
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _tiny_mistral():
    mcfg = transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5,
        sliding_window=8, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(1)
    return transformers.MistralForCausalLM(mcfg).eval()


def _tiny_qwen2(seed=2, **kw):
    qcfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=kw.pop("layers", 2), num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256,
        attn_implementation="eager", **kw,
    )
    torch.manual_seed(seed)
    return transformers.Qwen2ForCausalLM(qcfg).eval()


def _tiny_gemma2(seed=5, sliding_window=8):
    cfg = transformers.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, query_pre_attn_scalar=32, rms_norm_eps=1e-6,
        sliding_window=sliding_window, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, max_position_embeddings=256,
        attn_implementation="eager",
    )
    torch.manual_seed(seed)
    return transformers.Gemma2ForCausalLM(cfg).eval()


def _tiny_gemma1():
    gcfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rms_norm_eps=1e-6, max_position_embeddings=256,
        attn_implementation="eager",
    )
    torch.manual_seed(6)
    return transformers.GemmaForCausalLM(gcfg).eval()


def _tiny_phi3():
    pcfg = transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, sliding_window=None,
        pad_token_id=0, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(9)
    return transformers.Phi3ForCausalLM(pcfg).eval()


def _llama3():
    lcfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64},
        tie_word_embeddings=False, attn_implementation="eager",
    )
    torch.manual_seed(12)
    return transformers.LlamaForCausalLM(lcfg).eval()


def _yarn():
    lcfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rope_theta=10000.0,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 128},
        tie_word_embeddings=True, attn_implementation="eager",
    )
    torch.manual_seed(13)
    return transformers.LlamaForCausalLM(lcfg).eval()


# family: (HF model factory, importer name, config function name), the same
# names in both packages
FAMILIES = {
    "llama_untied": (lambda: _tiny_hf(False), "import_hf_llama", "config_from_hf"),
    "llama_tied": (lambda: _tiny_hf(True), "import_hf_llama", "config_from_hf"),
    "mistral_window": (_tiny_mistral, "import_hf_llama", "config_from_hf"),
    "qwen2_biases": (lambda: _tiny_qwen2(rope_theta=1e6, tie_word_embeddings=False,
                                         use_sliding_window=False, sliding_window=4096),
                     "import_hf_llama", "config_from_hf"),
    "qwen2_max_window_layers": (
        lambda: _tiny_qwen2(14, layers=4, use_sliding_window=True, sliding_window=8,
                            max_window_layers=2, tie_word_embeddings=True),
        "import_hf_llama", "config_from_hf"),
    "gemma2": (_tiny_gemma2, "import_hf_gemma", "config_from_hf_gemma"),
    "gemma1": (_tiny_gemma1, "import_hf_gemma", "config_from_hf_gemma"),
    "phi3": (_tiny_phi3, "import_hf_phi3", "config_from_hf"),
    "llama3_rope": (_llama3, "import_hf_llama", "config_from_hf"),
    "yarn_rope": (_yarn, "import_hf_llama", "config_from_hf"),
}


def _import(hf, family, dtype=torch.float32):
    model, cfg = getattr(tconvert, FAMILIES[family][1])(hf, dtype=dtype, device="cpu")
    return model, dataclasses.replace(cfg, remat=False)


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.from_numpy(ids).long()).logits.numpy()


def _logits(model, cfg, ids):
    with torch.no_grad():
        return forward(model, torch.from_numpy(ids).long(), cfg).numpy()


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("tie", [False, True])
def test_logit_parity_with_hf(tie):
    hf = _tiny_hf(tie)
    model, cfg = _import(hf, "llama_tied" if tie else "llama_untied")
    assert cfg.tie_embeddings == tie
    assert cfg.norm_eps == 1e-5 and cfg.n_kv_heads == 2
    assert hasattr(model, "unembed") == (not tie)
    ids = np.array([[3, 17, 99, 4, 4, 56, 120, 7],
                    [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)


def test_untied_loss_and_grads_flow():
    model, cfg = _import(_tiny_hf(False), "llama_untied")
    cfg = dataclasses.replace(cfg, loss_chunk=4)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 9)))
    loss = loss_fn(model, toks, cfg)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert float(model.unembed.grad.abs().max()) > 0  # the untied head's own gradient


def test_state_dict_import_requires_cfg_and_validates():
    hf = _tiny_hf(False)
    state = hf.state_dict()
    with pytest.raises(ValueError, match="cfg is required"):
        tconvert.import_hf_llama(state, device="cpu")
    cfg = tconvert.config_from_hf(hf.config, dtype=torch.float32)
    model, _ = tconvert.import_hf_llama(state, cfg=cfg, device="cpu")
    assert len(model.layers) == 2
    with pytest.raises(ValueError, match="Llama-family"):
        tconvert.import_hf_llama({"foo": 1}, cfg=cfg, device="cpu")
    short = {k: v for k, v in state.items() if ".layers.1." not in k}
    with pytest.raises(ValueError, match="layer 1"):
        tconvert.import_hf_llama(short, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="Gemma-family"):
        tconvert.import_hf_gemma({"foo": 1}, cfg=cfg, device="cpu")
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    with pytest.raises(ValueError, match="lm_head"):
        tconvert.import_hf_llama({k: v for k, v in state.items() if k != "lm_head.weight"},
                                 cfg=untied, device="cpu")


def _greedy_oracle(model, cfg, prompt, n):
    toks, want = list(prompt), []
    for _ in range(n):
        logits = _logits(model, cfg, np.asarray([toks], np.int32))
        want.append(int(np.argmax(logits[0, len(toks) - 1])))
        toks.append(want[-1])
    return want


def test_untied_model_serves_greedy_parity():
    """Imported untied weights run the paged serving engine; greedy tokens
    match the dense forward."""
    model, cfg = _import(_tiny_hf(False, seed=3), "llama_untied")
    eng = DecodeEngine(model, cfg, num_pages=16, page_size=128, num_slots=1,
                       pages_per_seq=4, kv_dtype=torch.float32, device="cpu")
    prompt = [5, 7, 11, 13, 17]
    assert eng.generate([prompt], max_new_tokens=5)[0] == _greedy_oracle(model, cfg, prompt, 5)


def test_mistral_sliding_window_parity():
    """A window (8) shorter than the sequence (24): the kernels' window
    must match HF's sliding mask."""
    hf = _tiny_mistral()
    model, cfg = _import(hf, "mistral_window")
    assert cfg.window == 8
    ids = np.random.default_rng(2).integers(0, 128, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)


def test_windowed_model_engine_modes():
    """A window the context outgrows on a uniformly sliding model needs the
    rolling KV ring, which is still to port (ROADMAP queue 1 item 3); a
    window covering the context serves with full residency."""
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy

    cfg = ModelConfig.tiny(dtype=torch.float32, remat=False, window=128)
    model = params_from_jax(init_params_numpy(cfg, seed=0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        DecodeEngine(model, cfg, num_pages=16, page_size=128, num_slots=1,
                     pages_per_seq=4, kv_dtype=torch.float32, device="cpu")
    eng = DecodeEngine(model, cfg, num_pages=4, page_size=128, num_slots=1,
                       pages_per_seq=1, kv_dtype=torch.float32, device="cpu")
    assert eng.generate([[1, 2, 3]], max_new_tokens=3)[0] == _greedy_oracle(
        model, cfg, [1, 2, 3], 3)


def test_qwen2_bias_parity():
    hf = FAMILIES["qwen2_biases"][0]()
    model, cfg = _import(hf, "qwen2_biases")
    assert cfg.window == 0  # use_sliding_window=False gates it off
    assert hasattr(model.layers[0], "bq")
    ids = np.random.default_rng(4).integers(0, 128, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)


def test_gemma2_logit_parity():
    """GeGLU, (1+w) norms folded at import, sandwich norms, √d_model
    embedding scale, query_pre_attn_scalar, both softcaps and the EVEN-layer
    window (8 < seq 24)."""
    hf = _tiny_gemma2()
    model, cfg = _import(hf, "gemma2")
    assert cfg.window == 8 and cfg.window_pattern == "even"
    assert cfg.attn_softcap == 50.0 and cfg.final_softcap == 30.0
    assert cfg.sm_scale == 32 ** -0.5 and cfg.embed_scale
    assert hasattr(model.layers[0], "post_attn_norm")
    ids = np.random.default_rng(6).integers(0, 128, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=GEMMA_ATOL, rtol=RTOL)


def test_gemma1_logit_parity():
    hf = _tiny_gemma1()
    model, cfg = _import(hf, "gemma1")
    assert cfg.window == 0 and cfg.attn_softcap == 0.0
    assert not hasattr(model.layers[0], "post_attn_norm")
    ids = np.random.default_rng(7).integers(0, 128, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=GEMMA_ATOL, rtol=RTOL)


def test_gemma2_serves_greedy_parity():
    """Imported Gemma-2 runs the paged engine (softcap in decode, the window
    covering the context): greedy tokens match the dense forward."""
    model, cfg = _import(_tiny_gemma2(seed=8, sliding_window=128), "gemma2")
    eng = DecodeEngine(model, cfg, num_pages=4, page_size=128, num_slots=1,
                       pages_per_seq=1, kv_dtype=torch.float32, device="cpu")
    prompt = [3, 99, 14, 5]
    assert eng.generate([prompt], max_new_tokens=5)[0] == _greedy_oracle(model, cfg, prompt, 5)


def test_phi3_fused_projection_parity():
    hf = _tiny_phi3()
    model, cfg = _import(hf, "phi3")
    assert hasattr(model, "unembed") and cfg.n_kv_heads == 2
    ids = np.random.default_rng(8).integers(0, 128, (2, 10)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="qkv_proj"):
        tconvert.import_hf_phi3(_tiny_hf(False), dtype=torch.float32, device="cpu")


def test_imported_model_weight_quantization():
    """quantize_params on an imported (untied, biased) model: projections go
    int8, biases / unembed / norms stay, the logits track the fp32 model and
    equal the JAX package's int8 logits."""
    hf = _tiny_qwen2(11, tie_word_embeddings=False, use_sliding_window=False)
    model, cfg = _import(hf, "qwen2_biases")
    ids = np.random.default_rng(9).integers(0, 128, (1, 12)).astype(np.int32)
    full = _logits(model, cfg, ids)
    quantize_params(model)
    assert isinstance(model.layers[0].wq, QuantizedWeight)
    assert hasattr(model.layers[0], "bq") and hasattr(model, "unembed")
    quant = _logits(model, cfg, ids)
    assert np.max(np.abs(full - quant)) < 0.15
    assert np.argmax(full[0, -1]) == np.argmax(quant[0, -1])
    jparams, jcfg = jconvert.import_hf_llama(hf, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, remat=False)
    jq = np.asarray(jforward(jquantize(jparams), jnp.asarray(ids), jcfg))
    np.testing.assert_allclose(quant, jq, atol=1e-4, rtol=0)


def test_llama3_rope_scaling_parity():
    hf = _llama3()
    model, cfg = _import(hf, "llama3_rope")
    assert cfg.rope_scaling[0] == "llama3" and cfg.rope_scaling[1] == 8.0
    ids = np.random.default_rng(10).integers(0, 128, (2, 40)).astype(np.int32)
    got = _logits(model, cfg, ids)
    np.testing.assert_allclose(got, _hf_logits(hf, ids), atol=ATOL, rtol=RTOL)
    assert not np.allclose(got, _logits(model, dataclasses.replace(cfg, rope_scaling=None),
                                        ids))
    bad = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=4,
        rope_scaling={"rope_type": "longrope", "factor": 4.0,
                      "short_factor": [1.0] * 8, "long_factor": [1.0] * 8},
    )
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        tconvert.config_from_hf(bad)


def test_yarn_rope_scaling_parity():
    hf = _yarn()
    model, cfg = _import(hf, "yarn_rope")
    assert cfg.rope_scaling[0] == "yarn"
    assert cfg.rope_scaling[5] == pytest.approx(0.1 * np.log(4.0) + 1.0)
    ids = np.random.default_rng(11).integers(0, 128, (2, 48)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)


def test_qwen2_max_window_layers_parity():
    """The FIRST max_window_layers layers attend fully, later ones slide."""
    hf = FAMILIES["qwen2_max_window_layers"][0]()
    model, cfg = _import(hf, "qwen2_max_window_layers")
    assert cfg.window == 8 and cfg.window_pattern == "from:2"
    ids = np.random.default_rng(12).integers(0, 128, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(_logits(model, cfg, ids), _hf_logits(hf, ids),
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Against the JAX converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_hf_matches_jax(family):
    make, _, config_fn = FAMILIES[family]
    hf = make()
    want = getattr(jconvert, config_fn)(hf.config, dtype=jnp.float32)
    got = getattr(tconvert, config_fn)(hf.config, dtype=torch.float32)
    assert _fields(got) == _fields(want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_params_equal_jax(family, dtype):
    """The port's converted weights are the JAX converter's bit for bit
    (bf16 rounded alike from float32)."""
    make, importer, _ = FAMILIES[family]
    hf = make()
    jparams, jcfg = getattr(jconvert, importer)(hf, dtype=getattr(jnp, dtype))
    model, cfg = getattr(tconvert, importer)(hf, dtype=getattr(torch, dtype), device="cpu")
    want = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), jparams)
    got = params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert _fields(cfg) == _fields(jcfg)


def test_quantized_params_equal_jax():
    """quantize_params gives the JAX package's int8 payloads and scales."""
    hf = _tiny_qwen2(11, tie_word_embeddings=False, use_sliding_window=False)
    jparams, _ = jconvert.import_hf_llama(hf, dtype=jnp.float32)
    model, _ = tconvert.import_hf_llama(hf, dtype=torch.float32, device="cpu")
    want = jquantize(jparams)["layers"][1]["w_down"]
    got = quantize_params(model).layers[1].w_down
    assert np.array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


# ---------------------------------------------------------------------------
# Without transformers: a bare state dict and a plain config object
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gemma2", "phi3", "qwen2_biases"])
def test_import_from_state_dict_and_namespace_config(family):
    """What the card does: an HF-named state dict and the published
    config.json's fields in a SimpleNamespace, through the port's config
    and importer functions; the same model as from the HF module."""
    make, importer, config_fn = FAMILIES[family]
    hf = make()
    ns = types.SimpleNamespace(**json.loads(hf.config.to_json_string()))
    cfg = getattr(tconvert, config_fn)(ns, dtype=torch.float32)
    assert _fields(cfg) == _fields(getattr(tconvert, config_fn)(hf.config,
                                                                dtype=torch.float32))
    state = {k: v.clone() for k, v in hf.state_dict().items()}
    model, _ = getattr(tconvert, importer)(state, cfg=cfg, device="cpu")
    ref, _ = getattr(tconvert, importer)(hf, dtype=torch.float32, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), name


def test_load_trained_round_trip(tmp_path):
    """A run directory written as a trainer writes it (model_config.json and
    a params-only checkpoint) loads back into the same model; ``dtype``
    overrides the stored one."""
    from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy
    from flash_attention_dlrs_tpu_torch.utils import checkpoint as ckpt

    cfg = ModelConfig.tiny(dtype=torch.bfloat16, remat=False)
    model = params_from_jax(init_params_numpy(cfg, seed=3), cfg, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "params_only"), {"params": model.state_dict()},
                         step=7)
    rec = {f: getattr(cfg, f) for f in ("vocab_size", "d_model", "n_layers", "n_q_heads",
                                         "n_kv_heads", "head_dim", "d_ff")}
    (tmp_path / "model_config.json").write_text(json.dumps(dict(rec, dtype="bfloat16")))
    got, got_cfg = tconvert.load_trained(str(tmp_path), device="cpu")
    assert got_cfg.dtype == torch.bfloat16 and got_cfg.d_model == cfg.d_model
    for (name, a), (_, b) in zip(got.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), name
    f32, f32_cfg = tconvert.load_trained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert f32_cfg.dtype == torch.float32 and f32.embed.dtype == torch.float32
    assert torch.equal(f32.embed, model.embed.float())
