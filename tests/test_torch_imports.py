"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
nor ``transformers`` (the card has none: the HF import reads configs by
attribute), its default-device entry points need a card, and
``chip_smoke.py`` refuses to report without one."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "flash_attention_dlrs_tpu_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py"))
SCRIPTS = ["chip_smoke.py", "wide_breakdown_torch.py", "scripts/eval_ppl_torch.py",
           "bench_torch.py",
           "scripts/run_bench_suite_torch.py", "scripts/run_golden_gate_torch.py",
           "examples/01_attention_features_torch.py", "examples/02_train_tiny_torch.py",
           "examples/03_serve_paged_torch.py", "examples/04_multichip_mesh_torch.py"]
# imports transformers (the checkpoint it converts), as tests/test_torch_convert.py does
HF_EXAMPLE = "examples/05_import_hf_torch.py"
MODULES = sorted(
    ".".join(pathlib.Path(f).with_suffix("").parts).removesuffix(".__init__")
    for f in PORT_FILES
)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def _imported_names(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + SCRIPTS + [HF_EXAMPLE])
def test_no_jax_import_in_source(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flash_attention_dlrs_tpu"), (path, name)


@pytest.mark.parametrize("path", PORT_FILES + SCRIPTS)
def test_no_transformers_import_in_source(path):
    for name in _imported_names(path):
        assert name.split(".")[0] != "transformers", (path, name)


def test_importing_the_whole_port_loads_no_transformers():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "assert 'transformers' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flash_attention_dlrs_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default entry points run there")


def test_default_device_entry_points_need_a_card():
    _no_card()
    from flash_attention_dlrs_tpu_torch.models import (
        ModelConfig, Transformer, fit, import_hf_gemma, import_hf_llama, import_hf_phi3,
        init_kv_pools, init_params_numpy, make_train_state, params_from_jax,
        perplexity_paged,
    )
    from flash_attention_dlrs_tpu_torch import current_geometry
    from flash_attention_dlrs_tpu_torch.bench.suite import run_bench
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine
    from flash_attention_dlrs_tpu_torch.runtime.sampling import batch_params
    from flash_attention_dlrs_tpu_torch.parallel.dryrun import dryrun_multichip, dryrun_rank
    from flash_attention_dlrs_tpu_torch.parallel.launch import launch
    from flash_attention_dlrs_tpu_torch.parallel.mesh import rank_device

    cfg = ModelConfig.tiny(dtype=torch.float32)
    alibi_dropout = ModelConfig.tiny(dtype=torch.float32, position_encoding="alibi",
                                     attn_dropout=0.1)
    tree = init_params_numpy(cfg, seed=0)
    for call in (
        lambda: Transformer(cfg),
        lambda: params_from_jax(tree, cfg),
        lambda: init_kv_pools(cfg, num_pages=2),
        lambda: DecodeEngine(params_from_jax(tree, cfg, device="cpu"), cfg),
        lambda: DecodeEngine(params_from_jax(tree, alibi_dropout, device="cpu"),
                             alibi_dropout),
        lambda: batch_params([None]),
        lambda: make_train_state(cfg),
        lambda: make_train_state(alibi_dropout),
        lambda: fit(cfg, iter(()), steps=1),
        lambda: fit(alibi_dropout, iter(()), steps=1),
        lambda: import_hf_llama({}, cfg=cfg),
        lambda: import_hf_gemma({}, cfg=cfg),
        lambda: import_hf_phi3({}, cfg=cfg),
        lambda: perplexity_paged(params_from_jax(tree, cfg, device="cpu"), cfg,
                                 [[1, 2, 3]]),
        lambda: current_geometry(),
        lambda: run_bench(seq_lens=(128,)),
        lambda: dryrun_multichip(2),
        lambda: launch(dryrun_rank, 2, device="cuda"),
        lambda: rank_device().index,
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_launch_without_a_toolchain_raises():
    from flash_attention_dlrs_tpu_torch import _cuda

    if _cuda.shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    kernel = _cuda.CudaKernel("attn_fwd.cu", "attn_fwd", [])
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.launch()
    assert kernel.launches == 0


def test_library_names_follow_the_source_hash():
    from flash_attention_dlrs_tpu_torch import _cuda

    # one source for each kernel, head dim (d 128 unsuffixed) and, for the
    # attention kernels, segment-id flag; one for the other tiles of the
    # forward and of the sweeps; verify at d 256 in two, by q dtype; one
    # wide build of each kernel for the head dims above 256, decode's
    # column-chunked build above 1024, and the forward's and the backward's
    # score and product passes above 1024 (route wide_scores)
    want = sorted([f"{kernel}{d}{seg}.cu" for kernel, segs in (
        ("attn_fwd", ("", "_seg")), ("attn_bwd", ("", "_seg")),
        ("paged_decode", ("",)), ("paged_verify", ("",)))
        for d in ("", "_d64", "_d256") for seg in segs]
        + ["attn_fwd_tiles.cu", "attn_bwd_tiles.cu", "paged_verify_d256_f16.cu"]
        + [f"{kernel}_wide.cu" for kernel in ("attn_fwd", "attn_bwd", "paged_decode",
                                             "paged_verify")]
        + ["paged_decode_chunk.cu", "attn_fwd_scores.cu", "attn_bwd_scores.cu"])
    assert _cuda.all_sources() == want and len(want) == 28
    paths = [_cuda.library_path(s) for s in _cuda.all_sources()]
    assert all(p.parent == _cuda.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert len({p.name for p in paths}) == 28


def test_every_kernel_entry_is_defined_in_its_source():
    """Each wrapper's C entry, and its error string, is an extern "C"
    function of the source it builds (nothing compiles here, so a misnamed
    entry would show first on the card); every source is some wrapper's."""
    import re

    from flash_attention_dlrs_tpu_torch import _cuda
    from flash_attention_dlrs_tpu_torch.ops import bwd_kernel, decode, fwd_kernel  # noqa: F401

    for kernel in _cuda.KERNELS:
        if kernel.library is not None:
            continue
        text = (_cuda.CSRC_DIR / kernel.source).read_text()
        for name in (kernel.symbol, f"{kernel.symbol}_error_string"):
            assert re.search(rf'extern "C" [^(]*\b{name}\(', text), (kernel.source, name)
    built = {k.source for k in _cuda.KERNELS if k.library is None}
    assert built >= set(_cuda.all_sources())


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    from flash_attention_dlrs_tpu_torch import _cuda

    monkeypatch.setattr(_cuda, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    before = _cuda.library_path("k.cu")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _cuda.library_path("k.cu") != before


def test_chip_smoke_refuses_without_a_card():
    _no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_outside_the_repo_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exports_match_the_jax_package():
    """The package exports what the JAX package's __init__ does of the
    ported surface: SegmentIds and the nn adapter among them."""
    import flash_attention_dlrs_tpu_torch as tp
    from flash_attention_dlrs_tpu_torch import ops

    for name in ("SegmentIds", "nn", "flash_attention", "flash_attention_forward",
                 "flash_attention_backward", "reference_attention", "alibi_slopes_for",
                 "BlockSizes", "default_block_sizes", "current_geometry"):
        assert name in tp.__all__ and hasattr(tp, name), name
    assert ops.SegmentIds is tp.SegmentIds
    assert tp.nn.dot_product_attention.__module__ == "flash_attention_dlrs_tpu_torch.nn"
    assert tp.SegmentIds._fields == ("q", "kv")


def test_model_exports_match_the_jax_package():
    """models/ exports what the JAX package's models/__init__.py exports from
    convert and transformer (its init_params draws JAX keys: the port's
    seeded counterpart is init_params_numpy)."""
    from flash_attention_dlrs_tpu import models as jmodels
    from flash_attention_dlrs_tpu.models import convert as jconvert
    from flash_attention_dlrs_tpu.models import transformer as jtransformer
    from flash_attention_dlrs_tpu_torch import models as tmodels

    wanted = [n for n in jmodels.__all__ if n != "init_params"
              and getattr(jmodels, n).__module__ in (jconvert.__name__, jtransformer.__name__)]
    assert len(wanted) == 10
    for name in wanted + ["load_trained", "init_params_numpy"]:
        assert name in tmodels.__all__ and hasattr(tmodels, name), name


def test_parallel_exports_match_the_jax_package():
    """parallel/ exports what the JAX package's parallel/__init__.py does,
    and the package exports parallel."""
    import flash_attention_dlrs_tpu_torch as tp
    from flash_attention_dlrs_tpu import parallel as jparallel
    from flash_attention_dlrs_tpu_torch import parallel as tparallel

    assert tparallel.__all__ == jparallel.__all__
    assert all(hasattr(tparallel, name) for name in tparallel.__all__)
    assert "parallel" in tp.__all__ and tp.parallel is tparallel


def test_resolve_device_takes_the_cpu_only_when_asked():
    from flash_attention_dlrs_tpu_torch._cuda import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
