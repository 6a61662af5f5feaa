"""Plotting pipeline, the PyTorch port of ``flash_attention_dlrs_tpu/bench/plots.py``.

A rebuild of the reference plotting layer (reference:
src/plot_bench_results.py): reads the suite's CSVs, re-runs the bench when
a CSV is missing (src/plot_bench_results.py:28,60-77), and renders runtime
and TFLOP/s curves on a log2 sequence-length axis
(src/plot_bench_results.py:102-126) into ``plots_torch/``.  matplotlib is
imported only when a figure is drawn.
"""

from __future__ import annotations

import csv
import math
import os
from collections import defaultdict
from typing import Optional


def _load_csv(path: str):
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(
                {
                    "provider": row["provider"],
                    "mode": row["mode"],
                    "N": int(row["N"]),
                    "ms": float(row["ms"]),
                    "tflops": float(row["tflops"]),
                }
            )
    return rows


def plot_bench_data(
    *,
    batch: int = 8,
    heads: int = 16,
    head_dim: int = 128,
    mode: str = "fwd",
    causal: bool = True,
    out_dir: str = "bench_out_torch",
    plot_dir: str = "plots_torch",
    rerun_if_missing: bool = True,
    y: str = "tflops",
    device="cuda",
) -> Optional[str]:
    """Render one figure for (workload, mode); returns the PDF path."""
    name = f"attn_B{batch}_H{heads}_d{head_dim}_{mode}{'_causal' if causal else ''}"
    csv_path = os.path.join(out_dir, name + ".csv")
    if not os.path.exists(csv_path):
        if not rerun_if_missing:
            return None
        from .suite import run_bench

        run_bench(
            batch=batch, heads=heads, head_dim=head_dim, modes=(mode,),
            causal=causal, out_dir=out_dir, device=device,
        )
    rows = _load_csv(csv_path)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = defaultdict(list)
    for r in rows:
        if r["ms"] == r["ms"]:  # drop NaN (OOM) points like the reference
            series[r["provider"]].append((r["N"], r[y]))

    fig, ax = plt.subplots(figsize=(6, 3.6))
    for provider, pts in sorted(series.items()):
        pts.sort()
        ax.plot(
            [p[0] for p in pts], [p[1] for p in pts],
            marker="o", markersize=3, label=provider,
        )
    ax.set_xscale("log", base=2)
    ax.set_xlabel("sequence length N")
    ax.set_ylabel("TFLOP/s" if y == "tflops" else "runtime [ms]")
    if y == "ms":
        ax.set_yscale("log", base=2)
    ax.set_title(f"attention {mode} B={batch} H={heads} d={head_dim}"
                 f"{' causal' if causal else ''}")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    os.makedirs(plot_dir, exist_ok=True)
    pdf = os.path.join(plot_dir, f"{name}_{y}.pdf")
    fig.tight_layout()
    fig.savefig(pdf)
    plt.close(fig)
    return pdf
