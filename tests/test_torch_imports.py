"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its default-device entry points need a card, and ``chip_smoke.py`` refuses
to report without one."""

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


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_import_in_source(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flash_attention_dlrs_tpu"), (path, name)


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
        ModelConfig, Transformer, fit, init_kv_pools, init_params_numpy,
        make_train_state, params_from_jax,
    )
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine
    from flash_attention_dlrs_tpu_torch.runtime.sampling import batch_params

    cfg = ModelConfig.tiny(dtype=torch.float32)
    tree = init_params_numpy(cfg, seed=0)
    for call in (
        lambda: Transformer(cfg),
        lambda: params_from_jax(tree, cfg),
        lambda: init_kv_pools(cfg, num_pages=2),
        lambda: DecodeEngine(params_from_jax(tree, cfg, device="cpu"), cfg),
        lambda: batch_params([None]),
        lambda: make_train_state(cfg),
        lambda: fit(cfg, iter(()), steps=1),
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

    assert _cuda.all_sources() == ["attn_bwd.cu", "attn_fwd.cu", "paged_decode.cu"]
    paths = [_cuda.library_path(s) for s in _cuda.all_sources()]
    assert all(p.parent == _cuda.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert len({p.name for p in paths}) == 3


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


def test_resolve_device_takes_the_cpu_only_when_asked():
    from flash_attention_dlrs_tpu_torch._cuda import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
