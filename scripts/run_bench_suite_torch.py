"""Full benchmark sweep and plots of the PyTorch port (the reference's
protocol: N=2^7..2^15, fwd / bwd / fwd+bwd; providers ours, sdpa, naive).

Run on the card:  python3 scripts/run_bench_suite_torch.py [--quick] [--no-plots]
On the CPU:       python3 scripts/run_bench_suite_torch.py --device cpu --quick --max-n 256
CSVs go to bench_out_torch/, figures to plots_torch/ (matplotlib).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="N up to 2^12, fwd only")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-n", type=int, default=None, help="longest sequence")
    ap.add_argument("--out-dir", default="bench_out_torch")
    args = ap.parse_args()

    from flash_attention_dlrs_tpu_torch.bench.suite import run_bench

    seq_lens = tuple(2**i for i in range(7, 13 if args.quick else 16)
                     if args.max_n is None or 2**i <= args.max_n)
    modes = ("fwd",) if args.quick else ("fwd", "bwd", "fwd+bwd")
    run_bench(seq_lens=seq_lens, modes=modes, device=args.device, out_dir=args.out_dir)

    if not args.no_plots:
        from flash_attention_dlrs_tpu_torch.bench.plots import plot_bench_data

        for mode in modes:
            for y in ("tflops", "ms"):
                path = plot_bench_data(mode=mode, y=y, out_dir=args.out_dir,
                                       rerun_if_missing=False, device=args.device)
                print("plot:", path)


if __name__ == "__main__":
    main()
