"""The port's perplexity evaluation (models/eval.py, scripts/eval_ppl_torch.py)
against the JAX package's, on the CPU.

Counterparts of tests/test_eval.py: the same ``ModelConfig.tiny(dtype=
float32)`` weights and tokens through both packages' ``perplexity_dense``
and ``perplexity_paged`` (JAX's paged kernel in interpret mode), from fp32,
int8, int4 and e4m3 pools, within 1e-4 relative; then the gates of
tests/test_eval.py on the port's own numbers, and the script's Markov mode
at a few training steps.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.models import eval as jeval
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import params_from_jax
from flash_attention_dlrs_tpu_torch.models import eval as teval

JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)
TCFG = TConfig.tiny(dtype=torch.float32, remat=False)
KINDS = {  # name -> (JAX keywords, port keywords)
    "fp32": (dict(kv_dtype=jnp.float32), dict(kv_dtype=torch.float32)),
    "int8": (dict(kv_dtype=jnp.int8, quantized=True),
             dict(kv_dtype=torch.int8, quantized=True)),
    "int4": (dict(kv_dtype="int4", quantized=True), dict(kv_dtype="int4", quantized=True)),
    "e4m3": (dict(kv_dtype=jnp.float8_e4m3fn, quantized=True),
             dict(kv_dtype=torch.float8_e4m3fn, quantized=True)),
}
REL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    """tests/test_eval.py's fixture, the JAX numbers computed once."""
    params = init_params(jax.random.PRNGKey(0), JCFG)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 48), 0, JCFG.vocab_size)
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG, device="cpu")
    want = {"dense": jeval.perplexity_dense(params, JCFG, tokens)}
    for name, (jkw, _) in KINDS.items():
        want[name] = jeval.perplexity_paged(params, JCFG, tokens, **jkw)
    return model, np.array(tokens), want


@pytest.fixture(scope="module")
def port(setup):
    """The port's numbers, computed once."""
    model, tokens, _ = setup
    got = {"dense": teval.perplexity_dense(model, TCFG, tokens)}
    for name, (_, tkw) in KINDS.items():
        got[name] = teval.perplexity_paged(model, TCFG, tokens, device="cpu", **tkw)
    return got


def test_dense_matches_jax(setup, port):
    model, tokens, want = setup
    got = port["dense"]
    assert abs(got - want["dense"]) / want["dense"] < REL, (got, want["dense"])
    assert got == teval.perplexity_dense(model, TCFG, torch.from_numpy(tokens))


@pytest.mark.parametrize("kind", list(KINDS))
def test_paged_matches_jax(setup, port, kind):
    want = setup[2]
    assert abs(port[kind] - want[kind]) / want[kind] < REL, (kind, port[kind], want[kind])


def test_gates_of_the_jax_tests_hold_in_the_port(port):
    """tests/test_eval.py's three gates on the port's numbers: paged fp32
    within 1e-3 of dense, int8 within 0.1 ppl and int4 within 5e-3
    relative of paged fp32."""
    dense, fp, q8, q4 = (port[k] for k in ("dense", "fp32", "int8", "int4"))
    assert abs(fp - dense) / dense < 1e-3
    assert abs(q8 - fp) < 0.1
    assert abs(q4 - fp) / fp < 5e-3


def test_paged_defaults_to_the_card(setup):
    model, tokens, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.perplexity_paged(model, TCFG, tokens)


def _script():
    spec = importlib.util.spec_from_file_location(
        "eval_ppl_torch", REPO / "scripts" / "eval_ppl_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def one_thread():
    """PyTorch's CPU ops on one thread for the test, as in the script's
    process below: the tiny model's ops gain nothing from a pool, and a
    pool of every core, beside the suite's other workers, takes ten times
    as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_script_markov_mode_on_the_cpu(tmp_path):
    """The script as a user runs it, in a process of its own (which loads
    no JAX: in this one, JAX's thread pool slows the training tenfold), on
    one CPU thread (``one_thread`` says why)."""
    out = tmp_path / "ppl.json"
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    run = subprocess.run(
        [sys.executable, "-c", code + "; assert 'jax' not in sys.modules",
         str(REPO / "scripts" / "eval_ppl_torch.py"), "--device", "cpu",
         "--train-steps", "30", "--seq", "32", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-2000:]
    results = json.loads(out.read_text())
    assert results["pass"] and results["device"] == "cpu"
    assert results["mode"] == "markov" and results["train_steps"] == 30
    for name in ("dense", "fp32", "int8", "int4", "e4m3", "e5m2"):
        assert np.isfinite(results[name]) and 1 < results[name] < 512, name
    assert results["machinery_gap"] / results["dense"] < 1e-4
    assert results["int8_gap"] < 0.1
    assert json.loads(run.stdout.strip().splitlines()[-1]) == results


def test_script_checkpoint_mode_on_the_cpu(tmp_path, one_thread):
    """A run directory as the trainer writes it, over a val.bin."""
    from flash_attention_dlrs_tpu_torch.models import init_params_numpy
    from flash_attention_dlrs_tpu_torch.utils import checkpoint as ckpt

    cfg = TConfig.tiny(dtype=torch.float32, remat=False)
    model = params_from_jax(init_params_numpy(cfg, seed=1), cfg, device="cpu")
    run = tmp_path / "run"
    ckpt.save_checkpoint(str(run / "params_only"), {"params": model.state_dict()}, step=1)
    rec = {f: getattr(cfg, f) for f in ("vocab_size", "d_model", "n_layers", "n_q_heads",
                                         "n_kv_heads", "head_dim", "d_ff")}
    (run / "model_config.json").write_text(json.dumps(dict(rec, dtype="float32")))
    np.random.default_rng(2).integers(0, 256, 200, dtype=np.uint16).tofile(tmp_path / "val.bin")
    out = tmp_path / "ppl.json"
    rc = _script().main(["--checkpoint", str(run), "--data", str(tmp_path), "--device", "cpu",
                         "--seq", "24", "--out", str(out)])
    results = json.loads(out.read_text())
    assert results["mode"] == "checkpoint" and results["seq"] == 24
    tokens = np.fromfile(tmp_path / "val.bin", np.uint16)[:50].astype(np.int64).reshape(2, 25)
    assert results["dense"] == teval.perplexity_dense(model, cfg, tokens)
    assert results["int8"] == teval.perplexity_paged(model, cfg, tokens, kv_dtype=torch.int8,
                                                     quantized=True, device="cpu")
    assert rc == (0 if results["int8_gap"] < 0.1 else 1)
