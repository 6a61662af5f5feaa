from .suite import BenchResult, attention_flops, run_bench, time_fn

__all__ = ["BenchResult", "attention_flops", "run_bench", "time_fn"]
