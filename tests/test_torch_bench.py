"""The port's measuring modules against the JAX package's, on the CPU.

``bench/suite.py`` (``attention_flops`` equal to JAX's on a grid,
``run_bench`` writing JAX's CSV names and header), ``bench/plots.py``,
``utils/config.py`` (the file JAX's ``tests/test_utils.py`` writes, read and
written back), ``utils/profiling.py`` (the H100's peaks, a trace, a range, a
step timer), and the three scripts: the golden gate at ``--small --trials
2``, ``bench_torch.py`` and the suite runner, each on the CPU.
"""

import csv
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.bench.suite import attention_flops as jax_flops
from flash_attention_dlrs_tpu.utils.config import dump_config as jax_dump
from flash_attention_dlrs_tpu.utils.config import load_config as jax_load
from flash_attention_dlrs_tpu_torch.bench import plots, suite
from flash_attention_dlrs_tpu_torch.utils import profiling
from flash_attention_dlrs_tpu_torch.utils.config import dump_config, load_config

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["fwd", "bwd", "fwd+bwd"])
def test_attention_flops_equal_jax(causal, mode):
    for b, h, nq, nkv, d in ((8, 16, 4096, 4096, 128), (1, 2, 128, 384, 64), (3, 5, 7, 9, 256)):
        assert suite.attention_flops(b, h, nq, nkv, d, causal=causal, mode=mode) == jax_flops(
            b, h, nq, nkv, d, causal=causal, mode=mode)


def test_attention_flops_refuse_a_mode_as_jax_does():
    for fn in (suite.attention_flops, jax_flops):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(1, 1, 1, 1, 1, causal=True, mode="both")


def test_run_bench_writes_jax_csv_names(tmp_path):
    results = suite.run_bench(batch=1, heads=2, head_dim=64, seq_lens=(64, 128),
                              modes=("fwd", "bwd"), dtype=torch.float32, out_dir=str(tmp_path),
                              iters=1, device="cpu", max_n={"naive": 64})
    # JAX's names: attn_B{b}_H{h}_d{d}_{mode}[_causal].csv
    assert sorted(os.listdir(tmp_path)) == ["attn_B1_H2_d64_bwd_causal.csv",
                                            "attn_B1_H2_d64_fwd_causal.csv"]
    with open(tmp_path / "attn_B1_H2_d64_fwd_causal.csv") as f:
        assert f.readline() == "provider,mode,N,ms,tflops\n"
    with open(tmp_path / "attn_B1_H2_d64_bwd_causal.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["provider"], int(r["N"])) for r in rows] == [
        (p, n) for n in (64, 128) for p in ("ours", "sdpa", "naive")]
    assert len(results) == 12
    naive_128 = [r for r in results if r.provider == "naive" and r.n == 128]
    assert all(r.ms != r.ms for r in naive_128)  # capped: a NaN row, as a failure is
    assert all(r.ms > 0 and r.tflops > 0 for r in results if r.provider != "naive" or r.n == 64)


def test_time_fn_times_a_call():
    x = torch.randn(64, 64)
    assert 0 < suite.time_fn(torch.matmul, x, x, iters=2, reps=3) < 1.0
    assert 0 < suite.time_fn(torch.matmul, x, x, min_window=0.001) < 1.0


def test_plot_bench_data_writes_its_figure(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "csv"
    out.mkdir()
    (out / "attn_B8_H16_d128_fwd_causal.csv").write_text(
        "provider,mode,N,ms,tflops\nours,fwd,128,0.1,10.0\nours,fwd,256,0.2,20.0\n"
        "sdpa,fwd,128,nan,nan\n")
    pdf = plots.plot_bench_data(out_dir=str(out), plot_dir=str(tmp_path / "plots"),
                                rerun_if_missing=False)
    assert pdf == str(tmp_path / "plots" / "attn_B8_H16_d128_fwd_causal_tflops.pdf")
    assert os.path.getsize(pdf) > 0
    assert plots.plot_bench_data(mode="bwd", out_dir=str(out), rerun_if_missing=False) is None


@dataclasses.dataclass(frozen=True)
class _Cfg:  # tests/test_utils.py
    alpha: float = 1.0
    steps: int = 10
    name: str = "x"
    flag: bool = False


def test_config_round_trips_the_file_jax_writes(tmp_path, monkeypatch):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"alpha": 2.0, "steps": 20}))
    monkeypatch.setenv("FA_TPU_STEPS", "30")
    monkeypatch.setenv("FA_TPU_FLAG", "true")
    jcfg = jax_load(_Cfg, str(p), overrides={"name": "y"})
    jax_dump(jcfg, str(tmp_path / "jax.json"))
    # the port reads what JAX wrote, with its own environment prefix
    monkeypatch.setenv("FA_TORCH_STEPS", "30")
    monkeypatch.setenv("FA_TORCH_FLAG", "true")
    cfg = load_config(_Cfg, str(p), overrides={"name": "y"})
    assert cfg == jcfg == _Cfg(alpha=2.0, steps=30, name="y", flag=True)
    assert load_config(_Cfg, str(tmp_path / "jax.json"), use_env=False) == jcfg
    dump_config(cfg, str(tmp_path / "torch.json"))
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    for fn in (load_config, jax_load):
        with pytest.raises(ValueError, match="unknown _Cfg fields"):
            fn(_Cfg, overrides={"nope": 1})


def test_device_peaks_and_percent_of_sol():
    assert profiling.device_peaks("NVIDIA H100 80GB HBM3") == (989.0, 3350.0)
    assert profiling.device_peaks("an unknown card") is None
    assert profiling.device_peaks("cpu") is None
    assert profiling.percent_of_sol(494.5, "NVIDIA H100 80GB HBM3") == 50.0
    assert profiling.percent_of_sol(10.0, "an unknown card") is None


def test_trace_annotate_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    timer = profiling.StepTimer(skip=1)
    for _ in range(3):
        with timer:
            torch.randn(8, 8).sum()
    assert len(timer.times) == 2 and timer.mean > 0


def _script(*args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": str(REPO)})


def test_golden_gate_runs_small_on_the_cpu():
    out = _script("scripts/run_golden_gate_torch.py", "--device", "cpu", "--small",
                  "--trials", "2")
    assert out.returncode == 0, out.stderr
    assert "forward : 2/2" in out.stdout and "GATE: PASS" in out.stdout


def test_bench_torch_prints_bench_py_line_on_the_cpu():
    out = _script("bench_torch.py", "--device", "cpu", "--small")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    # bench.py's rounding: a loaded CPU at the small shape may read 0.0
    assert line["unit"] == "TFLOP/s" and line["value"] >= 0 and line["vs_baseline"] > 0


def test_bench_suite_runner_on_the_cpu(tmp_path):
    out = _script("scripts/run_bench_suite_torch.py", "--device", "cpu", "--quick",
                  "--max-n", "128", "--no-plots", "--out-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert os.listdir(tmp_path) == ["attn_B8_H16_d128_fwd_causal.csv"]
